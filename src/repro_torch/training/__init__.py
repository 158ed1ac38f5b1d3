from repro_torch.training.steps import (TrainState, make_prefill_step,
                                        make_serve_step, make_train_step)
