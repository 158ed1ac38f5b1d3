"""D-IVI (paper §4): P workers, each sub-round one grouped fixed-point
launch and one scatter on the ``cuda`` backend.

* ``repro_torch.dist.protocol``: the round's semantics, each worker's
  stream ingest (``WorkerIngest``) and the one-device simulation of the
  P workers (``divi_round``);
* ``repro_torch.dist.divi``: the mesh round (``make_divi_round``), one
  process a position of a ``("data", "model")`` mesh over
  ``torch.distributed``, and its one-process twin;
* ``repro_torch.dist.engine``: the host driver (the shard deal, each
  round's ingest, the drop coins), on one device or as one mesh rank.
"""
from repro_torch.dist.protocol import (DIVIConfig, DIVIState, WorkerIngest,
                                       WorkerShard, divi_round,
                                       master_update, worker_correction)
from repro_torch.dist.divi import make_divi_round
from repro_torch.dist.engine import DIVIEngine

__all__ = ["DIVIConfig", "DIVIEngine", "DIVIState", "WorkerIngest",
           "WorkerShard", "divi_round", "make_divi_round", "master_update",
           "worker_correction"]
