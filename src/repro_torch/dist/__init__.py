"""D-IVI (paper §4): P workers simulated on one device, each sub-round one
grouped fixed-point launch and one scatter on the ``cuda`` backend. The
multi-card path (``repro``'s ``shard_map`` round) is ROADMAP §1 item 11."""
from repro_torch.dist.engine import DIVIEngine
from repro_torch.dist.protocol import (DIVIConfig, DIVIState, WorkerIngest,
                                       WorkerShard, divi_round,
                                       master_update, worker_correction)

__all__ = ["DIVIConfig", "DIVIEngine", "DIVIState", "WorkerIngest",
           "WorkerShard", "divi_round", "master_update", "worker_correction"]
