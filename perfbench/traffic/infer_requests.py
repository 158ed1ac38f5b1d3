"""Traffic driver ``infer_requests``: topic posteriors for held-out
documents, a closed loop of one client calling
``TopicInferencer.posterior`` on requests of ``request_docs`` documents.

Set-up makes the topics φ, the training split's document lengths and θ
(for the tokens a topic), and the test split, on the device from the
configuration's ``corpus_seed``, and renames words and topics by
permutations drawn from the run's seed (the same work for every seed);
the model is λ = β₀ + φᵀ·(expected training tokens a topic), with no
training. The test split is moved to host memory, where a user's request
is: request r holds the test documents (r·R + i) mod N, i < R, as a padded
``Corpus`` of CPU tensors, cut before its clock starts. A request's latency
runs from the call to its γ on the host.

Checked against the plain reference: ``check_requests`` requests drawn from
the seed among the completed requests whose answers the window kept (a
``keep_share`` of them, drawn from the seed), every document of them. The
stop tile couples the documents a batch puts together, so the reference
lays each request out as the inferencer states it does (rows bucketed by
the width ladder rung covering their last live slot, ascending within a
bucket, ``batch_size`` rows a batch, empty rows after the last). Number:
``gamma_rel``, the largest Σ_k |γ − γ_ref| / Σ_k γ_ref of a document.
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from perfbench.harness import corpus as gen_corpus
from perfbench.harness import trace as tr
from perfbench.reference import lda as ref
from perfbench.reference import work as wk

#: The inferencer's width ladder (``repro_torch/data/stream.py``'s
#: ``WIDTH_BOUNDARIES``), as the configuration's serving states it.
WIDTH_BOUNDARIES = (8, 16, 32, 64, 128, 256, 512)


def make(cell, seed: int, device: torch.device, control: bool):
    return InferRequests(cell, seed, device, control)


def width_ladder(max_width: int) -> List[int]:
    l = max(int(max_width), 1)
    return sorted({min(b, l) for b in WIDTH_BOUNDARIES if b < l} | {l})


def request_batches(counts: np.ndarray, batch: int
                    ) -> List[Tuple[np.ndarray, int]]:
    """(rows, width) of each batch of a request, in dispatch order."""
    live = counts > 0
    l = counts.shape[1]
    last = np.where(live.any(1), l - np.argmax(live[:, ::-1], axis=1), 0)
    out, lo = [], -1
    for w in width_ladder(l):
        rows = np.nonzero((last > lo) & (last <= w))[0]
        for i in range(0, len(rows), batch):
            out.append((rows[i:i + batch], int(w)))
        lo = w
    return out


class InferRequests:
    kind = "infer"

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
        self.r = int(self.t["request_docs"])
        self.batch = int(self.t["batch_size"])
        self.next_request = 0
        # the answers kept for the check: a share drawn from the seed, so
        # the window does not hold every request's γ
        self._draw = np.random.default_rng([self.seed, 2]).random(1 << 16) \
            < float(self.t["keep_share"])
        self.answers: Dict[int, np.ndarray] = {}
        self._notes: List[str] = []

    def request(self, r: int):
        from repro_torch.core.types import Corpus
        n = self.ids.shape[0]
        lo = (r * self.r) % n
        if lo + self.r <= n:
            return Corpus(self.ids[lo:lo + self.r], self.cnts[lo:lo + self.r])
        rows = torch.arange(lo, lo + self.r) % n
        return Corpus(self.ids[rows], self.cnts[rows])

    def rows_of(self, r: int) -> np.ndarray:
        n = self.ids.shape[0]
        return (r * self.r + np.arange(self.r)) % n

    def setup(self, phase) -> None:
        c, m = self.c, self.m
        with phase("generate"):
            fixed = torch.Generator(device=self.dev).manual_seed(
                int(c["corpus_seed"]))
            phi = gen_corpus.topics(self.v, int(c["true_topics"]),
                                    float(c["beta"]), fixed)
            n_train = int(c["num_train"])
            lens = gen_corpus.lengths(n_train, float(c["mean_len"]),
                                      int(c["min_len"]), fixed)
            theta = torch.exp(gen_corpus.log_dirichlet(
                (n_train, int(c["true_topics"])), float(c["alpha"]), fixed))
            tokens = gen_corpus.topic_tokens(theta, lens)
            del lens, theta
            test = gen_corpus.make_split(
                phi, int(c["num_test"]), float(c["mean_len"]),
                int(c["min_len"]), float(c["alpha"]), fixed)
            gen = torch.Generator(device=self.dev).manual_seed(self.seed)
            new_id = torch.randperm(self.v, generator=gen, device=self.dev)
            new_k = torch.randperm(self.k, generator=gen, device=self.dev)
            lam = float(m["beta0"]) + (phi * tokens[:, None]).T
            self.lam = torch.empty_like(lam)
            self.lam[new_id[:, None], new_k[None, :]] = lam
            del phi, lam
            ids, cnts = gen_corpus.relabeled(test.ids, test.counts, new_id)
            self.ids, self.cnts = ids.cpu(), cnts.cpu()
            self.width = test.width
            del test
        with phase("program"):
            from repro_torch.core.types import LDAConfig
            from repro_torch.lda.infer import TopicInferencer
            cfg = LDAConfig(
                num_topics=self.k, vocab_size=self.v,
                alpha0=float(m["alpha0"]), beta0=float(m["beta0"]),
                estep_max_iters=int(m["estep_max_iters"]),
                estep_tol=float(m["estep_tol"]),
                estep_backend=m["estep_backend"],
                estep_stream_dtype=("bfloat16" if self.control
                                    else m["precision"]))
            self.inf = TopicInferencer(cfg, self.lam, batch_size=self.batch,
                                       device=self.dev)
        with phase("warm"):
            for _ in range(int(self.t["warm_requests"])):
                self._serve()
        self._notes.append(f"test docs={self.ids.shape[0]} "
                           f"width={self.width}")

    def _serve(self) -> Tuple[int, float, np.ndarray]:
        r = self.next_request
        self.next_request += 1
        req = self.request(r)
        t0 = time.perf_counter()
        gamma = self.inf.posterior(req)
        return r, time.perf_counter() - t0, gamma

    def keep(self, r: int, gamma: np.ndarray) -> None:
        self.answers[r] = gamma

    def window(self, seconds: float) -> Dict[str, object]:
        lat: List[float] = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            r, dt, gamma = self._serve()
            lat.append(dt)
            if self._draw[r % self._draw.size]:
                self.keep(r, gamma)
        t1 = time.perf_counter()
        self._notes.append(
            f"requests={len(lat)} latency_ms median="
            f"{1e3 * float(np.median(lat)):.4f} p95="
            f"{1e3 * float(np.percentile(lat, 95)):.4f} "
            f"max={1e3 * max(lat):.4f}")
        return {"window": {"seconds": t1 - t0, "docs": len(lat) * self.r,
                           "latencies_s": lat},
                "attempted": len(lat), "failed": 0}

    def traced(self) -> Dict[str, object]:
        n = int(self.t["trace_requests"])
        before = self.inf.padding_stats()
        first = self.next_request

        def serve():
            for _ in range(n):
                self.keep(*self._serve()[::2])

        seg = tr.profile_segment(serve)
        after = self.inf.padding_stats()
        self.traced_requests = list(range(first, first + n))
        return {"segment": seg, "trace_requests": n,
                "padding": {k: after[k] - before[k]
                            for k in ("live_slots", "padded_slots")},
                "attempted": n, "failed": 0}

    def release(self) -> None:
        del self.inf
        if self.cuda:
            torch.cuda.empty_cache()

    # -- the check -----------------------------------------------------------
    def _cfg(self) -> ref.EStepCfg:
        m = self.m
        return ref.EStepCfg(float(m["alpha0"]), float(m["estep_tol"]),
                            int(m["estep_max_iters"]), int(m["stop_tile"]))

    def _reference(self, r: int, eb: torch.Tensor, got=None):
        """γ of request ``r`` and, a batch at a time, (ids, counts, the
        reference's sweeps) as it solves them; ``got``, the program's γ of
        the request, only chooses a tied tile's stop."""
        c = self._cfg()
        rows_all = self.rows_of(r)
        ids_all = self.ids.numpy()[rows_all]
        cnts_all = self.cnts.numpy()[rows_all]
        gamma = np.zeros((self.r, self.k), np.float32)
        batches = []
        for rows, w in request_batches(cnts_all, self.batch):
            ids = np.zeros((self.batch, w), np.int32)
            cnts = np.zeros((self.batch, w), np.float32)
            ids[:len(rows)] = ids_all[rows, :w]
            cnts[:len(rows)] = cnts_all[rows, :w]
            prog = None if got is None \
                else torch.from_numpy(got[rows]).to(self.dev)
            g, sweeps = ref.gamma_only(torch.from_numpy(ids).to(self.dev),
                                       torch.from_numpy(cnts).to(self.dev),
                                       eb, c, prog)
            gamma[rows] = g[:len(rows)].cpu().numpy()
            batches.append((ids, cnts, sweeps))
        return gamma, batches

    def check(self) -> Dict[str, float]:
        ref.strict_fp32()
        eb = ref.exp_elog(self.lam, 0)
        done = sorted(self.answers)
        rng = np.random.default_rng([self.seed, 1])
        n = min(int(self.t["check_requests"]), len(done))
        if n == 0:
            return {"gamma_rel": float("inf")}    # nothing to judge
        worst = 0.0
        for r in sorted(rng.choice(done, size=n, replace=False).tolist()):
            got = self.answers[r]
            want, _ = self._reference(r, eb, got)
            rel = ref.doc_gaps(torch.from_numpy(got), torch.from_numpy(want))
            worst = max(worst, float(rel.max()))
        return {"gamma_rel": worst}

    def work(self) -> Dict[str, object]:
        """Bytes and operations of K1's γ-only solve of every traced
        batch, each tile's sweeps the reference's on the same batch."""
        eb = ref.exp_elog(self.lam, 0)
        c = self._cfg()
        k1, sweeps_all = [], []
        for r in self.traced_requests:
            _, batches = self._reference(r, eb)
            for ids, cnts, sweeps in batches:
                b, l = ids.shape
                tile_live, tile_rows, distinct = wk.batch_counts(
                    ids, cnts, c.tile)
                k1.append(wk.fixed_point_work(b, l, self.k, distinct,
                                              tile_live, tile_rows, sweeps))
                sweeps_all.extend(sweeps)
        self._notes.append(
            "traced batches' reference sweeps a tile: min "
            f"{min(sweeps_all)} median {int(np.median(sweeps_all))} max "
            f"{max(sweeps_all)}; batches {len(k1)}; "
            + wk.bound_split("K1", k1))
        return {"work": {"k1": k1, "k3": [], "other_ops": 0.0}}

    def notes(self) -> List[str]:
        return self._notes
