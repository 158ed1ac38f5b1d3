"""Faults planted in the program's timed path, for showing that the check
refuses them: ``unchanged`` (an update or a solve that returns its state
as it was), ``half`` (half of each batch left out) and ``altered`` (one
token's π, or one document's γ, changed where it is produced). One chip:
no exchange between chips to leave out.

``plant(setattr, kind, fault)`` patches the program through ``setattr``
(pytest's ``monkeypatch.setattr``, or ``Patches.setattr`` here, which
undoes its patches on exit).
"""
from __future__ import annotations

from typing import Callable, List, Tuple

import torch

FAULTS = ("unchanged", "half", "altered")


class Patches:
    """Attribute patches undone on leaving the ``with`` block."""

    def __init__(self):
        self._undo: List[Tuple[object, str, object]] = []

    def setattr(self, obj, name: str, value) -> None:
        self._undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def __enter__(self) -> "Patches":
        return self

    def __exit__(self, *exc) -> None:
        for obj, name, value in reversed(self._undo):
            setattr(obj, name, value)
        self._undo.clear()


def plant(set_attr: Callable, kind: str, fault: str) -> None:
    """Break the ``kind`` ("train" or "infer") path with ``fault``."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r} (have {FAULTS})")
    (_train if kind == "train" else _infer)(set_attr, fault)


def _train(set_attr: Callable, fault: str) -> None:
    from repro_torch.core import engines
    from repro_torch.kernels import lda_estep
    orig = engines.LDAEngine._update_batch

    def unchanged(self, rows, ids, cnts):
        self.docs_seen += len(rows)

    def half(self, rows, ids, cnts):
        h = len(rows) // 2
        orig(self, rows[:h], ids[:h], cnts[:h])
        self.docs_seen += len(rows) - h

    fp = lda_estep.estep_fixed_point_pi

    def altered(*a, **k):
        gamma, et, sweeps, pi = fp(*a, **k)
        pi = pi.clone()
        pi[0, 0] = pi[0, 0].roll(1)
        return gamma, et, sweeps, pi

    if fault == "altered":
        set_attr(lda_estep, "estep_fixed_point_pi", altered)
    else:
        set_attr(engines.LDAEngine, "_update_batch",
                 unchanged if fault == "unchanged" else half)


def _infer(set_attr: Callable, fault: str) -> None:
    from repro_torch.kernels import lda_estep
    fp = lda_estep.estep_fixed_point

    def broken(token_ids, counts, eb, gamma0, *a, **k):
        if fault == "unchanged":
            g = gamma0.clone()
            return g, g, torch.zeros(1, dtype=torch.int32,
                                     device=g.device)
        gamma, et, sweeps = fp(token_ids, counts, eb, gamma0, *a, **k)
        gamma = gamma.clone()
        if fault == "half":
            h = gamma.shape[0] // 2
            gamma[:h] = fp(token_ids[:h].contiguous(),
                           counts[:h].contiguous(), eb,
                           gamma0[:h].contiguous(), *a, **k)[0]
            gamma[h:] = gamma0[h:]
        else:
            gamma[0] = gamma[0].roll(1)
        return gamma, et, sweeps

    set_attr(lda_estep, "estep_fixed_point", broken)
