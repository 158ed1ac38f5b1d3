from repro_torch.optim.optimizers import (Optimizer, adamw, apply_updates,
                                          clip_by_global_norm,
                                          cosine_schedule, iag, sgd)
