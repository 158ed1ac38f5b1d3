"""Numpy → port state: read the arrays a ``repro`` run writes.

``state_from_numpy`` takes the keys ``repro`` captures for a checkpoint
(``lam``, ``m_vk``, ``init_mass``, ``init_frac``, ``t``; see
``repro/lda/trainer.py``) and ``memo_from_numpy`` the ``{"pi", "visited"}``
that ``repro``'s ``DenseMemoStore.state_dict()`` returns, so a state built
by either package can continue in the port.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.memo import DenseMemoStore
from repro_torch.core.types import GlobalState, resolve_device

STATE_FIELDS = ("lam", "m_vk", "init_mass", "init_frac", "t")


def state_from_numpy(arrays: Mapping[str, np.ndarray],
                     device=None) -> GlobalState:
    """Build a ``GlobalState`` from numpy arrays (float32 leaves, int32 t)."""
    missing = [f for f in STATE_FIELDS if f not in arrays]
    if missing:
        raise KeyError(f"state arrays lack {missing}")
    device = resolve_device(device)

    def leaf(name, dtype):
        return torch.from_numpy(np.array(arrays[name], dtype=dtype)).to(device)

    state = GlobalState(lam=leaf("lam", np.float32),
                        m_vk=leaf("m_vk", np.float32),
                        init_mass=leaf("init_mass", np.float32),
                        init_frac=leaf("init_frac", np.float32),
                        t=leaf("t", np.int32))
    shape = tuple(state.lam.shape)
    for name in ("m_vk", "init_mass"):
        if tuple(getattr(state, name).shape) != shape:
            raise ValueError(f"{name} has shape "
                             f"{tuple(getattr(state, name).shape)}, "
                             f"lam has {shape}")
    if state.init_frac.ndim != 0 or state.t.ndim != 0:
        raise ValueError("init_frac and t must be scalars")
    return state


def memo_from_numpy(arrays: Mapping[str, np.ndarray],
                    device=None) -> DenseMemoStore:
    """Build a ``DenseMemoStore`` from ``{"pi": (D, L, K), "visited": (D,)}``."""
    device = resolve_device(device)
    pi = np.array(arrays["pi"], dtype=np.float32)
    visited = np.array(arrays["visited"], dtype=bool)
    if pi.ndim != 3 or visited.shape != pi.shape[:1]:
        raise ValueError(f"memo arrays: pi {pi.shape}, visited "
                         f"{visited.shape}")
    return DenseMemoStore(pi=torch.from_numpy(pi).to(device),
                          visited=torch.from_numpy(visited).to(device))
