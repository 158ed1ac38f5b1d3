from repro_torch.training.steps import (TrainState, loss_and_grads,
                                        make_prefill_step, make_serve_step,
                                        make_train_step)
