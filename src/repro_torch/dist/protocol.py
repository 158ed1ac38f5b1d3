"""D-IVI's configuration, a copy of ``repro.dist.protocol.DIVIConfig``.

The master/worker protocol itself (paper §4) is not ported yet: it is
ROADMAP §1 item 6. The facade and the checkpoints read the dataclass, so a
``repro`` D-IVI checkpoint's constructor parses here, and every D-IVI
entry point raises ``not_ported()``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DIVIConfig:
    """Distribution hyper-parameters (``repro``'s fields and defaults)."""

    num_workers: int = 4
    batch_size: int = 64
    delay_prob: float = 0.0   # P(worker drops a sub-round), Fig. 5
    staleness: int = 1        # sub-rounds per global round (parameter lag)
    partitioner: str = "range"
    partition_seed: int = 0


def not_ported(what: str = "distributed D-IVI training") -> NotImplementedError:
    """The error every D-IVI entry point of the port raises."""
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP §1 item 6, "
        "dist/); train single-host (algo mvi | svi | ivi | sivi)")
