"""Traffic driver ``train_epochs_chunked``: ``train_epochs``' closed loop of
``LDA.partial_fit(steps=1)`` with the π memo in the program's bf16
host-chunked store (``memo_store`` "chunked", ``chunk_docs`` documents a
chunk, as the configuration states them).

What differs from ``train_epochs``:

* the facade is given the configuration's ``chunk_docs``, and the
  store's wire dtype must be the configuration's ``memo_dtype``;
* memo rows are read back as the store holds them, in bf16 (exact), so a
  snapshot of a batch takes half the host bytes;
* the check is against ``perfbench/reference/lda_bf16memo.py``: the new π
  rounded to bf16 before the add side, and that rounded π what the memo
  holds. Numbers: ``pi_ulp_excess``, the largest excess of a live slot's
  stored π over the rounding of the reference's unrounded float32 π, in
  bf16 ulps (``lda_bf16memo.ulp_excess``); ``dlam_rel`` as
  ``train_epochs`` defines it;
* a traced run puts the store's own counters (``link_stats()``: the π
  bytes across the link each way and the chunks touched) over the traced
  updates into the record as ``link``; a program whose store has no such
  counters leaves ``link`` out.
"""
from __future__ import annotations

from typing import Dict

import torch

from perfbench.harness import corpus as gen_corpus
from perfbench.harness import trace as tr
from perfbench.reference import lda_bf16memo as ref
from perfbench.traffic.train_epochs import TrainEpochs, host


def make(cell, seed: int, device: torch.device, control: bool):
    return TrainEpochsChunked(cell, seed, device, control)


class TrainEpochsChunked(TrainEpochs):
    def _memo_rows(self, rows):
        pi, vis = self.lda.trainer.eng.memo.gather(rows)
        return host(pi.to(torch.bfloat16)), host(vis)

    def _link(self):
        stats = getattr(self.lda.trainer.eng.memo, "link_stats", None)
        return None if stats is None else stats()

    # -- set-up: train_epochs' own, the facade given chunk_docs --------------
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
                memo_store=m["memo_store"], chunk_docs=int(m["chunk_docs"]),
                layout=m["layout"], device=self.dev)
            self.lda.partial_fit(Corpus(self.ids, self.cnts), steps=0)
            self.lda.warm_start(self.lam0)
            wire = self.lda.trainer.eng.memo.pi_wire_dtype
            if wire != m["memo_dtype"]:
                raise ValueError(f"the configuration states a "
                                 f"{m['memo_dtype']} memo; the program's "
                                 f"{m['memo_store']} store holds {wire}")
        with phase("first_epoch"):
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
        memo = self.lda.trainer.eng.memo
        self._notes.append(
            f"corpus docs={self.d} width={self.width} tokens={self.tokens} "
            f"memo_bytes={memo.footprint_bytes()} "
            f"memo_store={memo.kind} chunk_docs={memo.chunk_docs}")

    # -- the traced window, with the store's counters ------------------------
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
        before = self._link()
        seg = tr.profile_segment(lambda: self._step(n))
        after = self._link()
        rec = {"syncs": {"count": syncs, "updates": n_sync},
               "segment": seg, "trace_updates": n,
               "attempted": n, "failed": 0}
        if before is not None:
            link = {k: after[k] - before[k] for k in after}
            rec["link"] = dict(link, updates=n)
            self._notes.append("link over the traced updates: " + " ".join(
                f"{k}={v}" for k, v in link.items()))
        return rec

    # -- the check against the bf16-memo reference ----------------------------
    def _chain(self, snap: dict, pis=None):
        """``train_epochs``' chain with the bf16-memo reference; ``pis``,
        the program's stored π of each update, only choose a tied tile's
        stop and an edge element's rounding."""
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
        excess, dlam = 0.0, 0.0

        def judge(pi_prog, pi_ref, cnts, dl_prog, dl_ref):
            nonlocal excess, dlam
            live = (cnts > 0)[:, :, None]
            gap = torch.where(live, ref.ulp_excess(pi_prog.to(dev), pi_ref),
                              0.0)
            excess = max(excess, float(gap.max()))
            num = float(torch.linalg.vector_norm((dl_prog - dl_ref).double()))
            den = float(torch.linalg.vector_norm(dl_ref.double()))
            dlam = max(dlam, num / den if den > 0 else float("inf"))

        # the start: the run's first update from λ₀, nothing visited
        b, l = self._batch(0)[0].shape
        start = dict(lam=lam0, m_vk=torch.zeros_like(lam0), frac=1.0,
                     step=0, memo=[(torch.zeros(b, l, self.k,
                                                dtype=torch.bfloat16),
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
        return {"pi_ulp_excess": excess, "dlam_rel": dlam}
