"""Synthetic request-arrival processes, seeded and reproducible.

The port's copy of ``repro.serve.traffic`` (numpy only): the same
schedules from the same seeds, bit for bit. The serving loop
(`repro_torch.serve.service`) consumes requests with scheduled arrival
times; this module generates the schedules:

* ``poisson_arrivals`` — the open-loop load model: exponential
  inter-arrival gaps at a constant ``rate``;
* ``onoff_arrivals`` — bursty traffic as an ON/OFF (interrupted Poisson)
  process: arrivals stream at ``rate`` during ``on_s``-long bursts
  separated by ``off_s``-long silences, the shape that stresses
  timeout-based partial flushes;
* ``replay_arrivals`` — the launcher's fixed-replay mode as a schedule:
  ``n`` arrivals evenly spaced at ``rate``, or all at t = 0.

All generators take an explicit ``seed`` and return absolute arrival
times in seconds from the schedule origin, non-decreasing. Pair a
schedule with documents through ``requests_from_docs``.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.data.stream import as_ragged_doc
from repro_torch.serve.admission import Request


def poisson_arrivals(n: int, rate: float, *, seed: int = 0,
                     t0: float = 0.0) -> np.ndarray:
    """``n`` absolute arrival times of a Poisson process at ``rate``/s."""
    if n < 0:
        raise ValueError("n must be >= 0")
    if rate <= 0:
        raise ValueError("rate must be positive")
    rng = np.random.default_rng(seed)
    return t0 + np.cumsum(rng.exponential(1.0 / rate, size=n))


def onoff_arrivals(n: int, rate: float, *, on_s: float, off_s: float,
                   seed: int = 0, t0: float = 0.0) -> np.ndarray:
    """``n`` arrivals of an ON/OFF (interrupted Poisson) process: a
    rate-``rate`` Poisson process in busy time, mapped onto the wall clock
    by an ``off_s`` silence after every ``on_s`` of busy time."""
    if on_s <= 0 or off_s < 0:
        raise ValueError("need on_s > 0 and off_s >= 0")
    busy = poisson_arrivals(n, rate, seed=seed)        # busy-time stamps
    return t0 + busy + np.floor(busy / on_s) * off_s


def replay_arrivals(n: int, rate: Optional[float] = None, *,
                    t0: float = 0.0) -> np.ndarray:
    """Fixed replay: ``n`` arrivals evenly spaced at ``rate``/s, or all at
    ``t0`` when ``rate`` is None (a burst)."""
    if n < 0:
        raise ValueError("n must be >= 0")
    if rate is None:
        return np.full(n, t0)
    if rate <= 0:
        raise ValueError("rate must be positive")
    return t0 + np.arange(n) / rate


def requests_from_docs(docs: Sequence, arrivals: np.ndarray, *,
                       deadline_s: float = math.inf,
                       start_id: int = 0) -> List[Request]:
    """Zip documents with an arrival schedule into ``Request`` objects.

    ``docs``: ragged documents (anything ``as_ragged_doc`` accepts), cycled
    when shorter than the schedule. ``deadline_s`` is a per-request latency
    budget: each request's absolute deadline is its arrival plus the budget
    (inf = never sheddable).
    """
    if len(docs) == 0 and len(arrivals):
        raise ValueError("no documents to build requests from")
    out = []
    for i, t in enumerate(np.asarray(arrivals, np.float64)):
        ids, cnts = as_ragged_doc(docs[i % len(docs)])
        out.append(Request(rid=start_id + i, ids=ids, cnts=cnts,
                           arrival_s=float(t),
                           deadline_s=float(t) + deadline_s))
    return out
