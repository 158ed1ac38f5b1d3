from repro_torch.training.steps import (TrainState, loss_and_grads,
                                        make_prefill_step, make_serve_step,
                                        make_train_step, shard_train_state,
                                        train_state_specs,
                                        unshard_train_state)
