"""Traffic driver ``train_epochs``: IVI training, a closed loop of
``LDA.partial_fit(steps=1)`` back to back over a corpus made on the device.

Set-up makes the configuration's corpus and λ₀ (from its
``corpus_seed``), renames its words and topics by permutations drawn from
the run's seed (the same run up to names, so every seed does the same
work), binds the facade, hands it
λ₀ (``warm_start``), runs ``setup_epochs`` epochs through the window's own
call (the first epoch's updates are all first visits, so every later update
subtracts an old π and adds a new one), then ``check_steps`` more. The
window runs updates until ``--seconds`` have passed and the card has
finished them.

Checked against the plain reference (``perfbench/reference/lda.py``):

* the first update of the run, from λ₀ and the batch's documents alone;
* the ``check_steps`` updates after set-up's epochs, chained from the
  program's state at the end of them (λ, ⟨m_vk⟩, the memo rows of those
  batches, the unretired share): the reference cannot follow 765 cold
  updates within a run's time, so it starts where the program stands, and
  the first check covers the start.

Numbers: ``pi_max_abs``, the largest gap of a live slot's π written to the
memo; ``dlam_rel``, the worst update's ‖Δλ − Δλ_ref‖ / ‖Δλ_ref‖, each side's
Δλ its own λ after the update less its λ before.

The batches are the engine's seeded epoch order (the engine's seed is the
configuration's ``corpus_seed``), worked out here as the configuration
states it: epoch e visits the e-th permutation of
``numpy.random.default_rng(corpus_seed)``, ``batch_size`` documents a
batch, the remainder last.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from perfbench.harness import corpus as gen_corpus
from perfbench.harness import trace as tr
from perfbench.reference import lda as ref
from perfbench.reference import work as wk


def host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t`` that later in-place updates cannot reach."""
    return t.detach().to("cpu", copy=True)


def make(cell, seed: int, device: torch.device, control: bool):
    return TrainEpochs(cell, seed, device, control)


class TrainEpochs:
    kind = "train"

    def __init__(self, cell, seed: int, device: torch.device,
                 control: bool):
        self.c = cell.config["corpus"]
        self.m = cell.config["model"]
        self.t = cell.traffic
        self.seed = int(seed)
        self.dev = device
        self.control = control
        self.cuda = device.type == "cuda"
        self.k = int(self.m["num_topics"])
        self.v = int(self.c["vocab_size"])
        self.b = int(self.m["batch_size"])
        self.d = int(self.c["num_train"])
        self.nb = -(-self.d // self.b)
        self.engine_seed = int(self.c["corpus_seed"])
        self._orders: List[np.ndarray] = []
        self._rng = np.random.default_rng(self.engine_seed)
        self.steps = 0
        self._notes: List[str] = []

    # -- the epoch order, as the configuration states it -----------------
    def rows(self, step: int) -> np.ndarray:
        """The documents of the run's ``step``-th update (0-based)."""
        e, j = divmod(step, self.nb)
        while len(self._orders) <= e:
            self._orders.append(self._rng.permutation(self.d))
        return self._orders[e][j * self.b:(j + 1) * self.b]

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def _step(self, n: int = 1) -> None:
        self.lda.partial_fit(steps=n)
        self.steps += n

    def _memo_rows(self, rows: np.ndarray):
        pi, vis = self.lda.trainer.eng.memo.gather(rows)
        return host(pi), host(vis)

    # -- set-up ------------------------------------------------------------
    def setup(self, phase) -> None:
        c, m = self.c, self.m
        with phase("generate"):
            fixed = torch.Generator(device=self.dev).manual_seed(
                int(c["corpus_seed"]))
            phi = gen_corpus.topics(self.v, int(c["true_topics"]),
                                    float(c["beta"]), fixed)
            split = gen_corpus.make_split(
                phi, self.d, float(c["mean_len"]), int(c["min_len"]),
                float(c["alpha"]), fixed)
            del phi
            lam0 = torch._standard_gamma(
                torch.full((self.v, self.k), 100.0, device=self.dev),
                generator=fixed) * 0.01
            gen = torch.Generator(device=self.dev).manual_seed(self.seed)
            new_id = torch.randperm(self.v, generator=gen, device=self.dev)
            new_k = torch.randperm(self.k, generator=gen, device=self.dev)
            self.ids, self.cnts = gen_corpus.relabeled(split.ids,
                                                       split.counts, new_id)
            self.lam0 = torch.empty_like(lam0)
            self.lam0[new_id[:, None], new_k[None, :]] = lam0
            del lam0
            self.width = split.width
            self.tokens = int(split.lengths.sum())
            del split
        with phase("program"):
            from repro_torch.core.types import Corpus
            from repro_torch.lda.api import LDA
            self.lda = LDA(
                num_topics=self.k, vocab_size=self.v,
                alpha0=float(m["alpha0"]), beta0=float(m["beta0"]),
                estep_max_iters=int(m["estep_max_iters"]),
                estep_tol=float(m["estep_tol"]),
                estep_stream_dtype=("bfloat16" if self.control
                                    else m["precision"]),
                algo=m["algo"], backend=m["estep_backend"],
                batch_size=self.b, seed=self.engine_seed,
                memo_store=m["memo_store"], layout=m["layout"],
                device=self.dev)
            self.lda.partial_fit(Corpus(self.ids, self.cnts), steps=0)
            self.lda.warm_start(self.lam0)
        with phase("first_epoch"):
            # the run's first update, read back for the check of the start
            self._step()
            self.first = (host(self.lda.lam), self._memo_rows(self.rows(0)))
            self._step(self.nb * int(self.t["setup_epochs"]) - 1)
        with phase("checked_steps"):
            st = self.lda.state
            n = int(self.t["check_steps"])
            self.start = dict(lam=host(st.lam), m_vk=host(st.m_vk),
                              frac=float(st.init_frac), step=self.steps,
                              memo=[self._memo_rows(self.rows(self.steps
                                                              + j))
                                    for j in range(n)])
            self.after = []
            for j in range(n):
                rows = self.rows(self.steps)
                self._step()
                self.after.append((host(self.lda.lam),
                                   self._memo_rows(rows)[0]))
        self._notes.append(
            f"corpus docs={self.d} width={self.width} tokens={self.tokens} "
            f"memo_bytes={self.lda.trainer.eng.memo.footprint_bytes()}")

    # -- the window ----------------------------------------------------------
    def window(self, seconds: float) -> Dict[str, object]:
        d0, n = self.lda.docs_seen, 0
        self._sync()
        t0 = time.perf_counter()
        while True:
            self._step()
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        t1 = time.perf_counter()
        return {"window": {"seconds": t1 - t0,
                           "docs": self.lda.docs_seen - d0,
                           "updates": n},
                "attempted": n, "failed": 0}

    def traced(self) -> Dict[str, object]:
        n_sync = int(self.t["sync_updates"])
        syncs = tr.count_host_syncs(lambda: self._step(n_sync))
        n = int(self.t["trace_updates"])
        st = self.lda.state
        first = self.steps
        self.replay = dict(lam=host(st.lam), m_vk=host(st.m_vk),
                           frac=float(st.init_frac), step=first,
                           memo=[self._memo_rows(self.rows(first + j))
                                 for j in range(n)])
        seg = tr.profile_segment(lambda: self._step(n))
        return {"syncs": {"count": syncs, "updates": n_sync},
                "segment": seg, "trace_updates": n,
                "attempted": n, "failed": 0}

    def release(self) -> None:
        """Free the program's state (the memo first of all)."""
        del self.lda
        if self.cuda:
            torch.cuda.empty_cache()

    # -- the check -----------------------------------------------------------
    def _cfg(self) -> ref.EStepCfg:
        m = self.m
        return ref.EStepCfg(float(m["alpha0"]), float(m["estep_tol"]),
                            int(m["estep_max_iters"]), int(m["stop_tile"]))

    def _batch(self, step: int):
        idx = torch.as_tensor(self.rows(step), device=self.dev)
        return self.ids[idx], self.cnts[idx]

    def _chain(self, snap: dict, pis=None):
        """The reference's updates from a snapshot of the program's state:
        (ids, counts, the state before, the update) for each of its
        batches, each update from the one before; ``pis``, the program's
        π of each update, only choose a tied tile's stop."""
        c, beta0, dev = self._cfg(), float(self.m["beta0"]), self.dev
        total = float(self.cnts.double().sum())
        st = ref.IVIState(snap["lam"].to(dev), snap["m_vk"].to(dev),
                          self.lam0 - beta0, snap["frac"])
        for j, (old_pi, vis) in enumerate(snap["memo"]):
            ids, cnts = self._batch(snap["step"] + j)
            prog = None if pis is None else pis[j].to(dev)
            out = ref.ivi_update(st, ids, cnts, old_pi.to(dev),
                                 vis.to(dev), total, beta0, c, prog)
            yield ids, cnts, st, out
            st = out.state

    def check(self) -> Dict[str, float]:
        ref.strict_fp32()
        dev, lam0 = self.dev, self.lam0
        pi_gap, dlam = 0.0, 0.0

        def judge(pi_prog, pi_ref, cnts, dl_prog, dl_ref):
            nonlocal pi_gap, dlam
            live = (cnts > 0)[:, :, None]
            gap = torch.where(live, (pi_prog.to(dev) - pi_ref).abs(), 0.0)
            pi_gap = max(pi_gap, float(gap.max()))
            num = float(torch.linalg.vector_norm((dl_prog - dl_ref).double()))
            den = float(torch.linalg.vector_norm(dl_ref.double()))
            dlam = max(dlam, num / den if den > 0 else float("inf"))

        # the start: the run's first update from λ₀, nothing visited
        b, l = self._batch(0)[0].shape
        start = dict(lam=lam0, m_vk=torch.zeros_like(lam0), frac=1.0,
                     step=0, memo=[(torch.zeros(b, l, self.k),
                                    torch.zeros(b, dtype=torch.bool))])
        lam1, (pi1, _) = self.first
        for _, cnts, before, out in self._chain(start, [pi1]):
            judge(pi1, out.pi, cnts, lam1.to(dev) - lam0,
                  out.state.lam - lam0)
        # the checked steps, chained from the program's state after set-up
        lam_prev = self.start["lam"].to(dev)
        for (_, cnts, before, out), (lam_j, pi_j) in zip(
                self._chain(self.start, [pi for _, pi in self.after]),
                self.after):
            lam_j = lam_j.to(dev)
            judge(pi_j, out.pi, cnts, lam_j - lam_prev,
                  out.state.lam - before.lam)
            lam_prev = lam_j
        return {"pi_max_abs": pi_gap, "dlam_rel": dlam}

    # -- work counts of the traced updates -----------------------------------
    def work(self) -> Dict[str, object]:
        """Bytes and operations of each traced update's K1 (with its π
        finish) and K3, and the rest of the update's operations; each
        tile's sweeps are the reference's on the same batch, replayed from
        the program's state before the traced window."""
        k1, k3, glue, sweeps_all = [], [], 0.0, []
        for ids, cnts, _, out in self._chain(self.replay):
            b, l = ids.shape
            tile_live, tile_rows, distinct = wk.batch_counts(
                ids.cpu().numpy(), cnts.cpu().numpy(), self._cfg().tile)
            live = sum(tile_live)
            fp = wk.fixed_point_work(b, l, self.k, distinct, tile_live,
                                     tile_rows, out.sweeps)
            fin = wk.pi_finish_work(b * l, self.k, live)
            k1.append((fp[0] + fin[0], fp[1] + fin[1]))
            k3.append(wk.scatter_work(live, self.v, self.k))
            glue += wk.update_glue_ops(b, l, self.v, self.k)
            sweeps_all.extend(out.sweeps)
        self._notes.append(
            "traced updates' reference sweeps a tile: min "
            f"{min(sweeps_all)} median {int(np.median(sweeps_all))} max "
            f"{max(sweeps_all)}; " + wk.bound_split("K1", k1) + "; "
            + wk.bound_split("K3", k3))
        return {"work": {"k1": k1, "k3": k3, "other_ops": glue}}

    def notes(self) -> List[str]:
        return self._notes
