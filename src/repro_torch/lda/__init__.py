"""``repro_torch.lda``: the public estimator API, as ``repro.lda``.

One facade (``LDA``) for train / resume / serve over the single-host
engines (MVI, SVI, IVI, S-IVI) and D-IVI (P workers simulated on one
device), with ``repro``'s checkpoints. ``__all__`` is ``repro.lda``'s.
"""
from repro_torch.lda.api import LDA
from repro_torch.lda.ckpt import (SCHEMA_VERSION, load_lda_checkpoint,
                                  save_lda_checkpoint)
from repro_torch.lda.infer import TopicInferencer, topic_posterior
from repro_torch.lda.trainer import (DIVITrainer, SingleHostTrainer, Trainer,
                                     make_trainer)

__all__ = [
    "LDA",
    "Trainer",
    "SingleHostTrainer",
    "DIVITrainer",
    "make_trainer",
    "TopicInferencer",
    "topic_posterior",
    "save_lda_checkpoint",
    "load_lda_checkpoint",
    "SCHEMA_VERSION",
]
