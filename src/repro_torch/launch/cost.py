"""What one rank's step costs, counted as it runs: the port's counterpart
of ``repro.launch.hlo_analysis.analyze`` in its LM uses.

``repro`` reads the compiled HLO of a sharded step: the dots' FLOPs and
output bytes (each computation's count multiplied by its loop's trip
count), the entry computation's parameter bytes and the collectives'
bytes. The port has no HLO; its layers are a Python loop, so every layer
is counted as it runs and no trip count is needed. ``count_step`` runs a
step (on ``meta`` tensors in the dry run) and returns:

* ``dot_flops``: the products' operations by
  ``torch.utils.flop_counter.FlopCounterMode`` (2 a multiply-add), plus
  K9's, which its wrapper adds (``kernels.flash_attention.FLOPS``: a
  ``ctypes`` launch is invisible to the counter);
* ``dot_bytes``: the bytes the products write (their outputs), as
  ``repro`` sums its dots' result shapes;
* ``temp_bytes``: the peak of the bytes the step allocates
  (`launch.dryrun_lda.LiveBytes`);
* the collectives' bytes by kind, from the context's collectives
  (`repro_torch.sharding.comm`).

``tree_bytes`` is the parameters' (or any argument tree's) bytes.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import flash_attention as fa
from repro_torch.launch.dryrun_lda import LiveBytes

_aten = torch.ops.aten
#: the products whose outputs are ``dot_bytes``
DOTS = frozenset({_aten.mm.default, _aten.bmm.default, _aten.addmm.default,
                  _aten.baddbmm.default, _aten.matmul.default})


class DotBytes(TorchDispatchMode):
    """Bytes the products write while the mode is on."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in DOTS:
            self.bytes += sum(t.numel() * t.element_size()
                              for t in tree_leaves(out)
                              if isinstance(t, torch.Tensor))
        return out


def tree_bytes(tree) -> int:
    """Σ bytes of the tensors of a nested tree (dicts, lists, tuples)."""
    from repro_torch.tree import tree_leaves as leaves
    return sum(t.numel() * t.element_size() for t in leaves(tree)
               if isinstance(t, torch.Tensor))


def count_step(step: Callable[[], Any], comm) -> Tuple[Any,
                                                       Dict[str, float]]:
    """Run ``step()`` once under the counters; returns its result and the
    counts. ``comm``: the collectives whose bytes the step's are (reset
    first)."""
    comm.reset()
    fa.reset_launches()
    live, dots = LiveBytes(), DotBytes()
    flops = FlopCounterMode(display=False)
    with flops, live, dots:
        out = step()
    counts = {"dot_flops": float(flops.get_total_flops())
              + fa.FLOPS["flash_attention"],
              "k9_flops": fa.FLOPS["flash_attention"],
              "k9_launches": fa.LAUNCHES["flash_attention"],
              "dot_bytes": float(dots.bytes),
              "temp_bytes": float(live.peak),
              "collective_bytes": comm.received_bytes,
              **{f"coll_{k}": v for k, v in comm.received.items()}}
    return out, counts
