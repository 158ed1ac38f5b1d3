"""Budgeted search over the kernel-policy lattice.

The port's counterpart of ``repro.tune.search``, with its structure: seeded
random sampling over the launch-checked lattice, ±1 neighbourhood
refinement around the incumbent, ``_simplify`` (every knob whose return to
the default costs nothing goes back), then the equality gate on the
cheapest candidates. If nothing both passes the gate and beats the
default, the default wins: a tuned store never regresses.

**The lattice** is ``block_b``, the padded fixed point's stopping tile;
the CSR fixed point stops the batch as one tile, so its lattice is empty
and its tune times the default alone. The kernels' launches are not in
it: warps per document, the cooperative grid and K3's ids a warp were
tried on the card and none both kept the bits and beat the default
outside its spread (ROADMAP, item 8). Nor is ``repro``'s memo
``wire_dtype``: the port's memo store sets the wire, not the policy.

**The objective** is measurement on the card: when the tune's device is
CUDA every candidate runs the real ``memo_correction_cuda(_csr)`` at the
target shape, after a warm call, and scores the minimum over reps of
device-synced ``repro_torch.obs`` spans. On any other device the
kernels' plain twins run, whose time says nothing of the card, so the
objective is the bound model (`repro_torch.tune.model`) and every record
carries ``proxy_regime: true``. A tune asked for CUDA on a machine without
CUDA raises: nothing falls back to the model in its place.

**Eligibility is gated on correctness**: before a candidate may win, its
correction, γ and π are compared with the default policy's on probe
inputs, bit for bit, whatever the candidate: a stored policy changes
speed and never the result. The gate runs on the tune's device. The
probe keeps the target's batch, width and K, so its kernel instance (the
KPL instance, or the wide kernel above 256 topics), its warps per
document and its stopping tiles are the target's;
only V is cut (no kernel's structure depends on it). Its documents start
warm (from a converged memo) and cold in blocks that no two stopping
tiles of the lattice cut alike (``warm_rows``), so a ``block_b`` that
stops other rows at other sweeps fails the gate, as it would change a
training run. The probe shape is recorded in the result.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.types import (DEFAULT_KERNEL_POLICY, KernelPolicy,
                                    LDAConfig)

from . import model as tune_model
from .store import PolicyKey, PolicyStore, current_device_kind

# knob -> ordered lattice values; refinement moves ±1 step here
PADDED_LATTICE: Dict[str, Sequence] = {"block_b": (64, 128, 256)}
CSR_LATTICE: Dict[str, Sequence] = {}
# V of the gate's probe at most (no kernel's structure depends on V)
PROBE_MAX_V = 8192


@dataclasses.dataclass(frozen=True)
class TuneShape:
    """The problem identity one tune run targets (mirrors PolicyKey)."""

    task: str                   # "padded" | "csr"
    b_or_t: int                 # batch size (padded) / token budget (csr)
    v: int
    k: int
    w: Optional[int] = None     # padded token width; None on csr
    num_docs: Optional[int] = None   # csr doc rows (defaults to 64)
    backend: str = "cuda"
    layout: str = "padded"

    def key(self, device_kind: str) -> PolicyKey:
        return PolicyKey(backend=self.backend, layout=self.layout,
                         b_or_t=self.b_or_t, v=self.v, k=self.k, w=self.w,
                         device_kind=device_kind)

    @property
    def docs(self) -> int:
        """Documents of one launch: B, or the CSR batch's rows."""
        return self.b_or_t if self.task == "padded" else self.num_docs or 64

    @property
    def slots_per_doc(self) -> int:
        """What sets the kernels' warps per document: the padded width, or
        ``ceil(T / B)`` on the flat stream."""
        if self.task == "padded":
            return self.w or 32
        return -(-self.b_or_t // self.docs)


def _tune_device(device) -> torch.device:
    """The device the tune is for; CUDA asked on a machine without it
    raises (no fallback to the model)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("tune asked for the card (device 'cuda') but no "
                           "CUDA device is available; pass device='cpu' for "
                           "the modeled (proxy) objective")
    return dev


def measurement_available(device) -> bool:
    """True exactly when the tune's device is CUDA: only there do times
    describe the kernels rather than their plain twins."""
    return torch.device(device).type == "cuda"


def _launch_rows(shape: TuneShape, policy: KernelPolicy):
    """(B, block_b, group) of the shape's fixed-point launch."""
    b = shape.docs
    if shape.task == "padded":
        return b, policy.block_b, b
    return b, b, b


def launch_ok(shape: TuneShape, policy: KernelPolicy, device) -> bool:
    """Whether the card can launch ``policy`` at ``shape`` (the port's
    ``vmem_ok``): on CUDA the fixed point's block within the card's shared
    memory, asked of the built library. On another device no kernel
    launches, so every lattice point is launchable."""
    if not measurement_available(device):
        return True
    from repro_torch.kernels import build
    lib = build.load()
    b, block_b, group = _launch_rows(shape, policy)
    return lib.lda_fixed_point_smem_bytes(b, shape.k, block_b, group) \
        <= lib.lda_max_smem_bytes()


def _lattice(shape: TuneShape) -> Dict[str, Sequence]:
    return PADDED_LATTICE if shape.task == "padded" else CSR_LATTICE


def _sample_candidates(shape: TuneShape, budget: int, seed: int,
                       lattice: Dict[str, Sequence],
                       device) -> List[KernelPolicy]:
    """Seeded random launchable candidates (the default always first)."""
    rng = random.Random(seed)
    out = [DEFAULT_KERNEL_POLICY]
    seen = {DEFAULT_KERNEL_POLICY}
    attempts = 0
    while len(out) < budget + 1 and attempts < budget * 20:
        attempts += 1
        fields = {knob: rng.choice(vals) for knob, vals in lattice.items()}
        cand = dataclasses.replace(DEFAULT_KERNEL_POLICY, **fields)
        if cand in seen or not launch_ok(shape, cand, device):
            continue
        seen.add(cand)
        out.append(cand)
    return out


def _deviations(policy: KernelPolicy) -> int:
    """How many knobs differ from the default policy."""
    return sum(getattr(policy, f.name)
               != getattr(DEFAULT_KERNEL_POLICY, f.name)
               for f in dataclasses.fields(KernelPolicy))


def _simplify(shape: TuneShape, policy: KernelPolicy, cost_fn, scored,
              device) -> KernelPolicy:
    """Revert every knob whose reversion to the default is free: random
    sampling draws all knobs at once, so an incumbent may carry changed
    knobs that add nothing to its cost."""
    cur = policy
    for f in dataclasses.fields(KernelPolicy):
        dv = getattr(DEFAULT_KERNEL_POLICY, f.name)
        if getattr(cur, f.name) == dv:
            continue
        cand = dataclasses.replace(cur, **{f.name: dv})
        if not launch_ok(shape, cand, device):
            continue
        if cand not in scored:
            scored[cand] = cost_fn(cand)
        if scored[cand] <= scored[cur]:
            cur = cand
    return cur


def _neighbors(policy: KernelPolicy,
               lattice: Dict[str, Sequence]) -> List[KernelPolicy]:
    """±1 lattice step per knob around ``policy``."""
    out = []
    for knob, vals in lattice.items():
        vals = list(vals)
        cur = getattr(policy, knob)
        idx = vals.index(cur) if cur in vals else 0
        for j in (idx - 1, idx + 1):
            if 0 <= j < len(vals):
                out.append(dataclasses.replace(policy,
                                               **{knob: vals[j]}))
    return out


# ---------------------------------------------------------------------------
# objective
# ---------------------------------------------------------------------------

def _modeled_cost(shape: TuneShape, policy: KernelPolicy,
                  iters: int) -> float:
    return tune_model.modeled_cost_seconds(
        shape.task, policy=policy, b_or_t=shape.b_or_t, v=shape.v,
        k=shape.k, w=shape.w, iters=iters, num_docs=shape.num_docs)


def _measured_cost(run, policy: KernelPolicy, *, reps: int = 5) -> float:
    """Min-of-reps wall seconds of the real kernel pipeline, timed under
    device-synced ``repro_torch.obs`` spans."""
    from repro_torch.obs import SpanRecorder

    rec = SpanRecorder(device_sync=True)
    run(policy)                                     # build + warm
    for _ in range(reps):
        tok = rec.begin("tune/measure")
        out = run(policy)
        rec.end(tok, sync=out[0])
    return min(r["dur_us"] for r in rec.records
               if r.get("name") == "tune/measure") / 1e6


# ---------------------------------------------------------------------------
# probe inputs + the bit-equality gate
# ---------------------------------------------------------------------------

def probe_shape(shape: TuneShape) -> dict:
    """The gate's shape: the target's batch, width (or token budget and
    documents) and K, so the kernel instance, its warps per document and
    the stopping tiles are the target's; V cut to ``PROBE_MAX_V``."""
    v = min(shape.v, PROBE_MAX_V)
    if shape.task == "padded":
        return {"b": shape.b_or_t, "v": v, "k": shape.k,
                "l": shape.w or 32}
    return {"t": shape.b_or_t, "b": shape.docs, "v": v, "k": shape.k}


def warm_rows(num_docs: int, device) -> torch.Tensor:
    """Which documents the gate's probe starts warm (visited, γ₀ from a
    converged memo) and which cold: 128 warm, 128 cold, then warm and cold
    by turns of 64. Fixed-point tiles of 64, 128 or 256 rows then each
    hold another mix of fast- and slow-stopping documents, so a stopping
    tile other than the default's stops other rows at other sweeps, and
    the bit gate sees it."""
    r = torch.arange(num_docs, device=device)
    return torch.where(r < 256, r < 128, (r // 64) % 2 == 0)


def warm_memo(shape: TuneShape, cfg: LDAConfig, eb, ids, cnts, segs=None):
    """(old π, visited) of a probe: ``warm_rows`` visited, their slots'
    memo the default policy's π of the same batch (its fixed point run to
    convergence from a cold start), the cold rows' zero."""
    b = shape.docs if shape.task == "csr" else ids.shape[0]
    visited = warm_rows(b, ids.device)
    none = torch.zeros(b, dtype=torch.bool, device=ids.device)
    if shape.task == "padded":
        old = torch.zeros(ids.shape + (cfg.num_topics,), device=ids.device)
        run = _gate_runner(shape, cfg, (eb, ids, cnts, old, none))
        pi = run(DEFAULT_KERNEL_POLICY)[2]
        live = visited[:, None, None]
    else:
        old = torch.zeros((ids.numel(), cfg.num_topics), device=ids.device)
        run = _gate_runner(shape, cfg, (eb, ids, cnts, segs, old, none))
        pi = run(DEFAULT_KERNEL_POLICY)[2]
        live = visited[segs.long().clamp(0, b - 1)][:, None]
    return torch.where(live, pi, 0.0).contiguous(), visited


def _probe_inputs(shape: TuneShape, probe: dict, seed: int, iters: int,
                  device):
    """Seeded inputs (numpy draws) and the cfg of the gate and the measured
    runs: sparse topics (λ from a Gamma(0.1, 1), so the fixed point stops
    within the sweep cap) and the ``warm_memo`` of the batch, so tiles stop
    at different sweeps."""
    from repro_torch.core.math import exp_dirichlet_expectation

    rng = np.random.default_rng(seed)
    k, v = probe["k"], probe["v"]
    lam = torch.from_numpy((rng.gamma(0.1, 1.0, (v, k)) + 0.01)
                           .astype(np.float32))
    eb = exp_dirichlet_expectation(lam, axis=0).contiguous().to(device)
    cfg = LDAConfig(num_topics=k, vocab_size=v, estep_max_iters=iters,
                    estep_backend="cuda")

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    if shape.task == "padded":
        b, l = probe["b"], probe["l"]
        # distinct ids in a row (as corpus_from_docs makes them): a
        # random start and stride that cannot wrap past the start
        start = rng.integers(0, v, (b, 1))
        stride = 1 + rng.integers(0, max(1, (v - 1) // max(l - 1, 1)),
                                  (b, 1))
        ids = ((start + stride * np.arange(l)) % v).astype(np.int32)
        cnts = (rng.poisson(1.5, (b, l)) + 1).astype(np.float32)
        # ragged rows: each document's slots past its length are padding
        lens = rng.integers(1, l + 1, b)
        cnts[np.arange(l)[None, :] >= lens[:, None]] = 0.0
        ids[cnts == 0] = 0
        ids, cnts = dev(ids), dev(cnts)
        return cfg, (eb, ids, cnts) + warm_memo(shape, cfg, eb, ids, cnts)
    t, b = probe["t"], probe["b"]
    per = max(1, t // b)
    lens = np.minimum(rng.zipf(1.5, b), per).astype(int)
    segs_l, ids_l, cnts_l = [], [], []
    for d, n in enumerate(lens):
        n = int(min(n, v))
        segs_l += [d] * n
        ids_l += list(rng.choice(v, size=n, replace=False))
        cnts_l += list(1.0 + rng.poisson(1.0, n))
    pad = t - len(ids_l)
    ids = dev(np.asarray(ids_l + [0] * pad, np.int32))
    cnts = dev(np.asarray(cnts_l + [0.0] * pad, np.float32))
    segs = dev(np.asarray(segs_l + [0] * pad, np.int32))
    return cfg, (eb, ids, cnts, segs) + warm_memo(shape, cfg, eb, ids, cnts,
                                                  segs)


def _gate_runner(shape: TuneShape, cfg: LDAConfig, inputs):
    """A ``run(policy) -> (correction, γ, π)`` closure over fixed inputs:
    the IVI update's E-step and correction under the policy."""
    from repro_torch.kernels import ops

    if shape.task == "padded":
        eb, ids, cnts, old_pi, visited = inputs

        def run(policy: KernelPolicy):
            corr, _, res = ops.memo_correction_cuda(
                dataclasses.replace(cfg, kernel_policy=policy), eb, ids,
                cnts, old_pi, visited,
                pi_dtype=policy.wire_dtype or "float32")
            return corr, res.gamma, res.pi
    else:
        eb, ids, cnts, segs, old_pi, visited = inputs

        def run(policy: KernelPolicy):
            corr, _, res = ops.memo_correction_cuda_csr(
                dataclasses.replace(cfg, kernel_policy=policy), eb, ids,
                cnts, segs, old_pi, visited,
                pi_dtype=policy.wire_dtype or "float32")
            return corr, res.gamma, res.pi
    return run


def equality_check(run, default_out, policy: KernelPolicy
                   ) -> Tuple[bool, str, float]:
    """Gate one candidate against the default policy's outputs, bit for
    bit in every case: a policy that sets a bf16 ``wire_dtype`` runs with
    π rounded through bf16 and fails like any other change of result
    (``repro``'s tolerance for a flipped wire has no use here, as the
    port's engines take the wire from the memo store).

    Returns ``(ok, "bitwise", max_abs_err)``.
    """
    got = run(policy)
    max_err = max(float((g.float() - d.float()).abs().max())
                  for g, d in zip(got, default_out))
    ok = all(torch.equal(g, d) for g, d in zip(got, default_out))
    return ok, "bitwise", max_err


# ---------------------------------------------------------------------------
# the search
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TuneResult:
    shape: TuneShape
    policy: KernelPolicy              # the winner (default if nothing won)
    default_cost: float
    tuned_cost: float
    objective: str                    # "measured_seconds"|"modeled_seconds"
    proxy_regime: bool
    equality: dict
    effective: dict
    trials: int
    improvement: float                # default_cost / tuned_cost
    device_kind: str
    # every candidate scored, cheapest first: (policy, cost)
    scored: List[Tuple[KernelPolicy, float]]
    # the gated candidates in gate order: (policy, cost, passed, max_err)
    gated: List[Tuple[KernelPolicy, float, bool, float]]


def effective_record(shape: TuneShape, policy: KernelPolicy,
                     device) -> dict:
    """The launch that actually runs under ``policy``: the stopping tile
    and the wire, and on the card the fixed point's warps per document
    and grid as the library sizes them."""
    b, block_b, group = _launch_rows(shape, policy)
    rec = {"block_b": block_b,
           "wire_dtype": policy.wire_dtype or "float32"}
    if measurement_available(device):
        from repro_torch.kernels import build
        lib = build.load()
        rec["fp_warps"] = lib.lda_fixed_point_warps(shape.slots_per_doc)
        rec["fp_blocks"] = lib.lda_fixed_point_blocks(
            b, shape.slots_per_doc, shape.k, block_b, group)
    return rec


def tune_shape(shape: TuneShape, *, budget: int = 16, seed: int = 0,
               refine_rounds: int = 2, gate_candidates: int = 4,
               iters: int = 20, device="cuda", reps: int = 5,
               verbose: bool = False) -> TuneResult:
    """Search the policy lattice for one problem shape on ``device``.

    ``budget`` random launchable candidates + ``refine_rounds`` of ±1
    neighbourhood refinement are ranked by the objective (measured on a
    card, modeled elsewhere); the best ``gate_candidates`` that beat the
    default are then equality-gated, cheapest first, and the first that
    passes wins. ``iters`` caps the fixed point's sweeps in the gate's and
    the measured runs (and prices the model's).
    """
    dev = _tune_device(device)
    measured = measurement_available(dev)
    lattice = _lattice(shape)
    cands = _sample_candidates(shape, budget, seed, lattice, dev)

    probe = probe_shape(shape)
    cfg, inputs = _probe_inputs(shape, probe, seed, iters, dev)
    run = _gate_runner(shape, cfg, inputs)

    if measured:
        # time the real kernels at the TARGET shape (the gate runs at the
        # probe, which keeps every structural choice of the target)
        if shape.task == "padded":
            target = {"b": shape.b_or_t, "v": shape.v, "k": shape.k,
                      "l": shape.w or 32}
        else:
            target = {"t": shape.b_or_t, "b": shape.docs, "v": shape.v,
                      "k": shape.k}
        cfg_t, inputs_t = _probe_inputs(shape, target, seed, iters, dev)
        meas_run = _gate_runner(shape, cfg_t, inputs_t)

        def cost(p):
            return _measured_cost(meas_run, p, reps=reps)
        objective = "measured_seconds"
    else:
        def cost(p):
            return _modeled_cost(shape, p, iters)
        objective = "modeled_seconds"

    scored = {p: cost(p) for p in cands}
    for _ in range(refine_rounds):
        best = min(scored, key=scored.get)
        fresh = [n for n in _neighbors(best, lattice)
                 if n not in scored and launch_ok(shape, n, dev)]
        for n in fresh:
            scored[n] = cost(n)
        if verbose and fresh:
            print(f"  refine: +{len(fresh)} neighbors around "
                  f"cost={scored[best]:.3e}")

    # canonicalize the incumbent before gating, then rank equal costs
    # toward fewest knob deviations
    _simplify(shape, min(scored, key=scored.get), cost, scored, dev)
    default_cost = scored[DEFAULT_KERNEL_POLICY]
    default_out = run(DEFAULT_KERNEL_POLICY)
    ranked = sorted(scored, key=lambda p: (scored[p], _deviations(p)))
    winner, eq_rec = DEFAULT_KERNEL_POLICY, {
        "checked": True, "mode": "bitwise", "max_abs_err": 0.0,
        "probe_shape": probe}
    gated = []
    for cand in ranked:
        if cand == DEFAULT_KERNEL_POLICY or scored[cand] >= default_cost:
            break                       # nothing cheaper left to gate
        if len(gated) >= gate_candidates:
            break
        ok, mode, err = equality_check(run, default_out, cand)
        gated.append((cand, scored[cand], ok, err))
        if verbose:
            print(f"  gate[{len(gated)}] cost={scored[cand]:.3e} {mode} "
                  f"err={err:.2e} -> {'PASS' if ok else 'reject'}")
        if ok:
            winner = cand
            eq_rec = {"checked": True, "mode": mode, "max_abs_err": err,
                      "probe_shape": probe}
            break

    tuned_cost = scored[winner]
    return TuneResult(
        shape=shape, policy=winner, default_cost=default_cost,
        tuned_cost=tuned_cost, objective=objective,
        proxy_regime=not measured, equality=eq_rec,
        effective=effective_record(shape, winner, dev),
        trials=len(scored),
        improvement=default_cost / tuned_cost if tuned_cost else 1.0,
        device_kind=current_device_kind(dev),
        scored=[(p, scored[p]) for p in ranked], gated=gated)


def tune_and_store(store: PolicyStore, shape: TuneShape,
                   **kwargs) -> TuneResult:
    """``tune_shape`` + persist the winner under the shape's key."""
    res = tune_shape(shape, **kwargs)
    store.put(
        shape.key(res.device_kind), res.policy,
        objective={"kind": res.objective,
                   "default_cost": res.default_cost,
                   "tuned_cost": res.tuned_cost,
                   "improvement": res.improvement,
                   "proxy_regime": res.proxy_regime,
                   "trials": res.trials},
        effective=res.effective,
        equality=res.equality)
    return res
