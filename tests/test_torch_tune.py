"""`repro_torch.tune` against `repro.tune`: the store and its format, the
resolver, the equality gate on the plain twins, the search, the CLI and
the threading of tuned policies through the facade, the engine, the
checkpoints and serving.

One store file serves both packages: the same format, version and key
paths, each package's entries kept by the other's ``put`` and ``clear``,
and neither package served the other's (``cuda`` against ``pallas``).
The gate is bit for bit whatever a candidate changes, the memo wire
included; ``chip_smoke.py``'s ``tune`` phase holds it on the card.
"""
import dataclasses
import json
import os
import threading
import warnings

import numpy as np
import pytest
import torch

from repro.core.types import KernelPolicy as JPolicy
from repro.core.types import LDAConfig as JConfig
from repro.lda import LDA as JLDA
from repro.tune.resolve import PolicyResolver as JResolver
from repro.tune.store import PolicyKey as JKey
from repro.tune.store import PolicyStore as JStore
from repro_torch.core.types import (DEFAULT_KERNEL_POLICY, KernelPolicy,
                                    LDAConfig)
from repro_torch.data.synthetic import PAPER_CORPORA, make_corpus
from repro_torch.lda import LDA, TopicInferencer
from repro_torch.obs import Telemetry
from repro_torch.tune import model as tmodel
from repro_torch.tune import search as tsearch
from repro_torch.tune import store as tstore
from repro_torch.tune.resolve import PolicyResolver
from repro_torch.tune.store import (STORE_FORMAT, STORE_VERSION, PolicyKey,
                                    PolicyStore, TuneStoreWarning,
                                    current_device_kind, policy_from_dict,
                                    policy_to_dict)

CPU = "cpu"
SPEC = PAPER_CORPORA["tiny"]


def _key(**kw) -> PolicyKey:
    base = dict(backend="cuda", layout="padded", b_or_t=8, v=256, k=8,
                w=8, device_kind="cpu:cpu")
    base.update(kw)
    return PolicyKey(**base)


_POL = KernelPolicy(block_b=64, double_buffer_depth=3)
_META = dict(objective={"kind": "modeled_seconds", "proxy_regime": True,
                        "default_cost": 1.0, "tuned_cost": 0.5,
                        "improvement": 2.0},
             effective={}, equality={"mode": "bitwise", "max_abs_err": 0.0,
                                     "probe_shape": {}})


@pytest.fixture(scope="module")
def train():
    return make_corpus(SPEC, seed=0, device=CPU)


def _counts(tel):
    return (tel.metrics.value("tune.cache", result="hit"),
            tel.metrics.value("tune.cache", result="miss"))


# ---------------------------------------------------------------------------
# store robustness (repro's tests, on the port's store)
# ---------------------------------------------------------------------------

def test_store_round_trip(tmp_path):
    store = PolicyStore(tmp_path / "t.json")
    key = _key()
    store.put(key, _POL, **_META)
    assert store.get_policy(key) == _POL
    rec = store.get(key)
    assert rec["objective"]["proxy_regime"] is True
    assert rec["equality"]["mode"] == "bitwise"
    doc = json.loads((tmp_path / "t.json").read_text())
    assert doc["format"] == STORE_FORMAT == "repro.tune"
    assert doc["version"] == STORE_VERSION == 1
    assert key.path() in doc["entries"]


def test_missing_store_is_a_silent_miss(tmp_path):
    store = PolicyStore(tmp_path / "absent.json")
    with warnings.catch_warnings():
        warnings.simplefilter("error")       # a missing file is NOT junk
        assert store.get_policy(_key()) is None
        assert store.entries() == {}


@pytest.mark.parametrize("content", [
    "{not json",
    json.dumps({"format": "something.else", "version": 1, "entries": {}}),
    json.dumps({"format": STORE_FORMAT, "version": 999, "entries": {}}),
    json.dumps({"format": STORE_FORMAT, "version": STORE_VERSION,
                "entries": "not-a-table"}),
])
def test_bad_store_warns_and_is_empty(tmp_path, content):
    p = tmp_path / "bad.json"
    p.write_text(content)
    store = PolicyStore(p)
    with pytest.warns(TuneStoreWarning):
        assert store.entries() == {}
    with pytest.warns(TuneStoreWarning):
        assert store.get_policy(_key()) is None


@pytest.mark.parametrize("field,value", [
    ("block_b", -4), ("block_b", "64"), ("double_buffer_depth", 0),
    ("fp_warps", 2), ("scatter_ids", 16), ("wire_dtype", "float16")])
def test_bad_policy_entry_is_ignored(tmp_path, field, value):
    store = PolicyStore(tmp_path / "t.json")
    key = _key()
    store.put(key, _POL, **_META)
    doc = json.loads(open(store.path).read())
    doc["entries"][key.path()]["policy"][field] = value
    with open(store.path, "w") as f:
        json.dump(doc, f)
    with pytest.warns(TuneStoreWarning, match="bad policy"):
        assert store.get_policy(key) is None


def test_device_kind_mismatch_never_served(tmp_path):
    store = PolicyStore(tmp_path / "t.json")
    here, foreign = _key(), _key(device_kind="gpu:nvidia-h100-80gb-hbm3")
    store.put(foreign, _POL, **_META)
    assert store.get_policy(here) is None
    doc = json.loads(open(store.path).read())
    doc["entries"][here.path()] = doc["entries"].pop(foreign.path())
    with open(store.path, "w") as f:
        json.dump(doc, f)
    with pytest.warns(TuneStoreWarning, match="device_kind"):
        assert store.get_policy(here) is None


def test_concurrent_writers_never_tear_the_file(tmp_path):
    p = tmp_path / "t.json"
    errs = []

    def writer(i):
        try:
            store = PolicyStore(p)
            for j in range(5):
                store.put(_key(b_or_t=8 * (i + 1), v=128 * (j + 1)),
                          _POL, **_META)
        except BaseException as e:          # noqa: BLE001, reported below
            errs.append(e)

    threads = [threading.Thread(target=writer, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errs
    doc = json.loads(p.read_text())
    assert doc["format"] == STORE_FORMAT
    assert doc["entries"]
    for rec in doc["entries"].values():
        policy_from_dict(rec["policy"])


def test_clear_prefix(tmp_path):
    store = PolicyStore(tmp_path / "t.json")
    store.put(_key(), _POL, **_META)
    store.put(_key(layout="csr", w=None), _POL, **_META)
    assert store.clear("cuda/padded/") == 1
    assert len(store.entries()) == 1
    assert store.clear() == 1
    assert store.entries() == {}


def test_policy_dict_round_trip_is_strict():
    assert policy_from_dict(policy_to_dict(_POL)) == _POL
    assert policy_from_dict({}) == DEFAULT_KERNEL_POLICY
    with pytest.raises(ValueError, match="unknown policy fields"):
        policy_from_dict({"block_b": 64, "warp_speed": 9})
    with pytest.raises(ValueError, match="unknown policy fields"):
        policy_from_dict({"block_v": 512})          # repro's TPU tile
    with pytest.raises(ValueError, match="positive int"):
        policy_from_dict({"block_b": 0})
    with pytest.raises(ValueError, match="wire_dtype"):
        policy_from_dict({"wire_dtype": "float16"})
    # launch knobs tried on the card and removed are unknown fields now
    for knob in ("fp_warps", "fp_blocks", "scatter_ids"):
        with pytest.raises(ValueError, match="unknown policy fields"):
            policy_from_dict({knob: 8})


def test_current_device_kind(monkeypatch):
    assert current_device_kind(CPU) == "cpu:cpu"
    names = {0: "NVIDIA H100 80GB HBM3", 1: "NVIDIA H200"}
    monkeypatch.setattr(torch.cuda, "get_device_name", names.__getitem__)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert current_device_kind("cuda") == "gpu:nvidia-h100-80gb-hbm3"
    # the device tuned for, not device 0
    assert current_device_kind("cuda:1") == "gpu:nvidia-h200"
    # no device named and no card: the port's entry-point rule
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        current_device_kind()


# ---------------------------------------------------------------------------
# one store file, both packages
# ---------------------------------------------------------------------------

def test_key_paths_identical_to_repro():
    for kw in (dict(w=163), dict(layout="csr", w=None)):
        fields = dict(backend="cuda", layout="padded", b_or_t=1024,
                      v=141_927, k=100, device_kind="cpu:cpu")
        fields.update(kw)
        assert PolicyKey(**fields).path() == JKey(**fields).path()
        assert PolicyKey(**fields).to_dict() == JKey(**fields).to_dict()


def test_one_store_file_shared_with_repro(tmp_path):
    """Written in turns by both packages: each package's entries survive
    the other's ``put`` and ``clear(prefix=)``, and neither is served the
    other's."""
    p = tmp_path / "shared.json"
    port, jax_side = PolicyStore(p), JStore(p)
    jkey = JKey(backend="pallas", layout="padded", b_or_t=8, v=256, k=8,
                w=8, device_kind="cpu:cpu")
    key = _key()
    jpol = JPolicy(block_b=64, block_v=256)
    jax_side.put(jkey, jpol, **_META)
    port.put(key, _POL, **_META)                       # keeps repro's
    assert jax_side.get_policy(jkey) == jpol
    jax_side.put(JKey(**{**jkey.to_dict(), "b_or_t": 16}), jpol, **_META)
    assert port.get_policy(key) == _POL                # repro kept ours
    port.put(_key(b_or_t=16), _POL, **_META)
    assert len(port.entries()) == len(jax_side.entries()) == 4
    # the port refuses repro's TPU tiles; the port's fields are repro's
    # too, so repro decodes the port's policy when asked for its key
    with pytest.warns(TuneStoreWarning, match="bad policy"):
        assert port.get_policy(PolicyKey(**jkey.to_dict())) is None
    assert jax_side.get_policy(JKey(**key.to_dict())) == JPolicy(
        block_b=64, double_buffer_depth=3)
    assert port.clear("pallas/") == 2                  # port clears repro's
    assert set(jax_side.entries()) == {key.path(), _key(b_or_t=16).path()}
    jax_side.put(jkey, jpol, **_META)
    assert jax_side.clear("pallas/") == 1              # repro clears its own
    assert port.get_policy(key) == _POL
    assert port.get_policy(_key(b_or_t=16)) == _POL


def test_resolver_counts_equal_repro(tmp_path):
    """On one store file, the same lookups (exact hits, the width
    wildcard, misses, repeats) count the same hits and misses in both
    packages."""
    from repro.obs import as_telemetry as j_as_telemetry
    p = tmp_path / "shared.json"
    port, jax_side = PolicyStore(p), JStore(p)
    for w in (8, None):
        port.put(_key(w=w, b_or_t=8 if w else 16), _POL, **_META)
        jax_side.put(JKey(backend="pallas", layout="padded",
                          b_or_t=8 if w else 16, v=256, k=8, w=w,
                          device_kind="cpu:cpu"), JPolicy(block_b=64),
                     **_META)
    shapes = [dict(b_or_t=8, w=8), dict(b_or_t=16, w=32),
              dict(b_or_t=8, w=16), dict(b_or_t=8, w=8),
              dict(b_or_t=32, w=8)]
    tel, jtel = Telemetry(), j_as_telemetry(True)
    r = PolicyResolver(port, telemetry=tel, device=CPU)
    jr = JResolver(jax_side, telemetry=jtel)
    got = [r.resolve(backend="cuda", layout="padded", v=256, k=8, **s)
           is not None for s in shapes]
    want = [jr.resolve(backend="pallas", layout="padded", v=256, k=8, **s)
            is not None for s in shapes]
    assert got == want == [True, True, False, True, False]
    assert _counts(tel) == (jtel.metrics.value("tune.cache", result="hit"),
                            jtel.metrics.value("tune.cache", result="miss"))
    assert _counts(tel) == (2, 2)


# ---------------------------------------------------------------------------
# resolver
# ---------------------------------------------------------------------------

def test_resolver_counters_and_span(tmp_path):
    store = PolicyStore(tmp_path / "t.json")
    store.put(_key(), _POL, **_META)
    tel = Telemetry()
    r = PolicyResolver(store, telemetry=tel, device=CPU)
    hit = r.resolve(backend="cuda", layout="padded", b_or_t=8, v=256, k=8,
                    w=8)
    miss = r.resolve(backend="cuda", layout="padded", b_or_t=9999, v=256,
                     k=8, w=8)
    assert hit == _POL and miss is None
    assert _counts(tel) == (1, 1)
    lookups = [s for s in tel.trace.records if s["name"] == "tune/lookup"]
    assert len(lookups) == 2
    assert all("dur_us" in s for s in lookups)


def test_resolver_width_wildcard_fallback(tmp_path):
    store = PolicyStore(tmp_path / "t.json")
    store.put(_key(w=None), _POL, **_META)
    r = PolicyResolver(store, device=CPU)
    assert r.resolve(backend="cuda", layout="padded", b_or_t=8, v=256,
                     k=8, w=64) == _POL


def test_resolver_memoizes_disk_reads(tmp_path):
    p = tmp_path / "t.json"
    store = PolicyStore(p)
    store.put(_key(), _POL, **_META)
    r = PolicyResolver(store, device=CPU)
    kw = dict(backend="cuda", layout="padded", b_or_t=8, v=256, k=8, w=8)
    assert r.resolve(**kw) == _POL
    p.unlink()                      # a second resolve must not re-read
    assert r.resolve(**kw) == _POL


def test_resolver_without_store_resolves_none():
    assert PolicyResolver(None, device=CPU).resolve(
        backend="cuda", layout="padded", b_or_t=8, v=256, k=8,
        w=8) is None


# ---------------------------------------------------------------------------
# launch checks, the model, the gate and the search (the plain twins)
# ---------------------------------------------------------------------------

def test_launch_ok_static_rules():
    """The lattice is the padded stopping tile alone (the CSR batch is one
    tile); off the card no kernel launches, so every point is
    launchable."""
    assert set(tsearch.PADDED_LATTICE) == {"block_b"}
    assert tsearch.CSR_LATTICE == {}
    shape = tsearch.TuneShape(task="padded", b_or_t=64, v=512, k=8, w=16)
    assert tsearch.launch_ok(shape, DEFAULT_KERNEL_POLICY, CPU)
    for b in tsearch.PADDED_LATTICE["block_b"]:
        assert tsearch.launch_ok(shape, KernelPolicy(block_b=b), CPU)


def test_probe_keeps_instance_and_warps():
    """The gate's probe keeps B, the width (or T and the documents) and K,
    so the kernel instance, the warps per document and the stopping tiles
    are the target's; only V is cut."""
    arxiv = tsearch.TuneShape(task="padded", b_or_t=1024, v=141_927, k=300,
                              w=163)
    p = tsearch.probe_shape(arxiv)
    assert p == {"b": 1024, "v": tsearch.PROBE_MAX_V, "k": 300, "l": 163}
    csr = tsearch.TuneShape(task="csr", b_or_t=131_072, v=141_927, k=100,
                            num_docs=1024, layout="csr")
    pc = tsearch.probe_shape(csr)
    assert pc == {"t": 131_072, "b": 1024, "v": tsearch.PROBE_MAX_V,
                  "k": 100}
    assert csr.slots_per_doc == 128 and arxiv.slots_per_doc == 163


def test_model_bounds_and_launch_knobs():
    """The bound formulas count what the kernels must move and compute;
    the wire and the serving depth leave the modeled work as it is."""
    nbytes, ops = tmodel.scatter_work(live=1000, v=50, k=10)
    assert nbytes == 1000 * 8 + 2 * 1000 * 10 * 4 + 2 * 50 * 10 * 4
    assert ops == 4.0 * 1000 * 10
    ms, by = tmodel.bound_ms(tmodel.HBM_BYTES_PER_S * 1e-3, 0.0)
    assert by == "bytes" and ms == pytest.approx(1.0)
    kw = dict(b_or_t=1024, v=141_927, k=100, w=163, iters=60)
    base = tmodel.modeled_cost_seconds("padded", policy=None, **kw)
    for pol in (KernelPolicy(wire_dtype="bfloat16"),
                KernelPolicy(double_buffer_depth=4)):
        assert tmodel.modeled_cost_seconds("padded", policy=pol,
                                           **kw) == base
    fp, sc = tmodel.modeled_update_work("padded", policy=None, **kw)
    assert tmodel.bound_ms(*fp)[1] == "operations"
    assert tmodel.bound_ms(*sc)[1] == "bytes"


@pytest.fixture(scope="module")
def gate_probe():
    """One small probe: (shape, run, default outputs), on the twins."""
    shape = tsearch.TuneShape(task="padded", b_or_t=16, v=512, k=8, w=16)
    probe = tsearch.probe_shape(shape)
    cfg, inputs = tsearch._probe_inputs(shape, probe, 0, 20, CPU)
    run = tsearch._gate_runner(shape, cfg, inputs)
    return shape, run, run(DEFAULT_KERNEL_POLICY)


def test_policy_none_is_bit_identical_to_default_policy(gate_probe):
    _, run, default_out = gate_probe
    ok, mode, err = tsearch.equality_check(run, default_out,
                                           DEFAULT_KERNEL_POLICY)
    assert ok and mode == "bitwise" and err == 0.0


@pytest.mark.parametrize("pol", [
    KernelPolicy(block_b=64), KernelPolicy(block_b=256),
    KernelPolicy(double_buffer_depth=3)])
def test_twins_ignore_launch_knobs(gate_probe, pol):
    """At B = 16 every lattice tile holds the whole batch, and the depth
    is serving's: each policy passes the gate bit for bit."""
    _, run, default_out = gate_probe
    ok, mode, _ = tsearch.equality_check(run, default_out, pol)
    assert ok and mode == "bitwise"


@pytest.mark.parametrize("pol", [
    KernelPolicy(wire_dtype="bfloat16"),
    KernelPolicy(block_b=64, wire_dtype="bfloat16")])
def test_bf16_wire_refused_bit_for_bit(gate_probe, pol):
    """A candidate that flips the wire is held bit for bit like any other,
    so a knob riding with it cannot pass on a tolerance."""
    _, run, default_out = gate_probe
    ok, mode, err = tsearch.equality_check(run, default_out, pol)
    assert mode == "bitwise" and not ok and err > 0.0


def test_search_never_stores_a_planted_wire_candidate(monkeypatch):
    """Plant a cheaper bf16-wire candidate (with a stopping tile that
    alone keeps the bits) into the lattice: the gate refuses it and the
    default wins."""
    monkeypatch.setitem(tsearch.PADDED_LATTICE, "wire_dtype",
                        (None, "bfloat16"))
    planted = KernelPolicy(block_b=64, wire_dtype="bfloat16")
    monkeypatch.setattr(tsearch, "_modeled_cost",
                        lambda shape, p, iters: 0.5 if p == planted else 1.0)
    shape = tsearch.TuneShape(task="padded", b_or_t=16, v=512, k=8, w=16)
    res = tsearch.tune_shape(shape, budget=8, seed=0, device=CPU)
    assert planted in dict(res.scored)
    assert [(p, ok) for p, _, ok, _ in res.gated][0] == (planted, False)
    assert res.policy == DEFAULT_KERNEL_POLICY and res.improvement == 1.0


@pytest.mark.parametrize("task", ["padded", "csr"])
def test_search_winner_bit_equal_on_fresh_inputs(task):
    """Whatever tune_shape returns reproduces the default on inputs the
    gate never saw; on the CPU the model cannot tell launch knobs apart,
    so the default wins with an improvement of exactly 1."""
    if task == "padded":
        shape = tsearch.TuneShape(task="padded", b_or_t=16, v=512, k=8,
                                  w=16)
    else:
        shape = tsearch.TuneShape(task="csr", b_or_t=256, v=512, k=8,
                                  num_docs=16, layout="csr")
    res = tsearch.tune_shape(shape, budget=4, seed=1, gate_candidates=2,
                             refine_rounds=1, device=CPU)
    assert res.objective == "modeled_seconds" and res.proxy_regime
    assert res.device_kind == "cpu:cpu"
    assert res.tuned_cost <= res.default_cost
    assert res.policy == DEFAULT_KERNEL_POLICY and res.improvement == 1.0
    assert res.equality["checked"] and res.trials == len(res.scored)
    probe = tsearch.probe_shape(shape)
    cfg, inputs = tsearch._probe_inputs(shape, probe, 12345, 20, CPU)
    fresh = tsearch._gate_runner(shape, cfg, inputs)
    ok, mode, _ = tsearch.equality_check(fresh, fresh(DEFAULT_KERNEL_POLICY),
                                         res.policy)
    assert ok, f"search winner {res.policy} diverged on fresh inputs ({mode})"


def test_tune_for_cuda_without_cuda_raises(monkeypatch):
    """No fallback that hides the card: a tune asked for CUDA on a machine
    without it raises, in the search and in the CLI."""
    from repro_torch.tune.__main__ import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    shape = tsearch.TuneShape(task="padded", b_or_t=8, v=256, k=8, w=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsearch.tune_shape(shape, budget=1, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["tune", "--store", "unused.json", "--batch", "8", "--vocab",
              "256", "--topics", "8", "--width", "8"])
    assert not os.path.exists("unused.json")


def test_cli_tune_show_clear(tmp_path, capsys):
    from repro_torch.tune.__main__ import main
    p = str(tmp_path / "t.json")
    rc = main(["tune", "--store", p, "--task", "padded", "--batch", "8",
               "--vocab", "256", "--topics", "8", "--width", "8",
               "--budget", "2", "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "objective" in out and "equality" in out and "cpu:cpu" in out
    assert main(["tune", "--store", p, "--task", "csr", "--batch", "128",
                 "--docs", "8", "--vocab", "256", "--topics", "8",
                 "--budget", "2", "--device", "cpu"]) == 0
    store = PolicyStore(p)
    entries = store.entries()
    assert set(entries) == {"cuda/padded/B8/V256/K8/W8/cpu:cpu",
                            "cuda/csr/B128/V256/K8/W*/cpu:cpu"}
    for rec in entries.values():
        assert rec["objective"]["proxy_regime"] is True
        assert rec["objective"]["kind"] == "modeled_seconds"
    assert main(["show", "--store", p]) == 0
    assert "tuned entr" in capsys.readouterr().out
    assert main(["clear", "--store", p, "--prefix", "cuda/csr/"]) == 0
    assert len(store.entries()) == 1
    assert main(["clear", "--store", p]) == 0
    assert store.entries() == {}


# ---------------------------------------------------------------------------
# facade / engine / checkpoint / serving threading
# ---------------------------------------------------------------------------

def _cfg(**kw):
    kw.setdefault("estep_backend", "cuda")
    return LDAConfig(num_topics=4, vocab_size=SPEC.vocab_size,
                     estep_max_iters=8, **kw)


def _facade(store=None, **kw):
    return LDA(_cfg(), algo="ivi", batch_size=16, seed=3, tune_store=store,
               device=CPU, **kw)


def _put(store, train, pol, b_or_t=16, k=4, **kw):
    fields = dict(backend="cuda", layout="padded", b_or_t=b_or_t,
                  v=SPEC.vocab_size, k=k, w=train.max_unique,
                  device_kind="cpu:cpu")
    fields.update(kw)
    store.put(PolicyKey(**fields), pol, **_META)


def test_facade_no_store_is_bit_identical(train, tmp_path):
    a = _facade().fit(train, epochs=1)
    b = _facade(store=str(tmp_path / "empty.json")).fit(train, epochs=1)
    assert a.cfg.kernel_policy is None and b.cfg.kernel_policy is None
    np.testing.assert_array_equal(a.lam.numpy(), b.lam.numpy())


@pytest.mark.parametrize("layout", ["padded", "csr"])
def test_facade_miss_is_counted_once(train, tmp_path, layout):
    """The trainer looks the store up, not the facade as well: a miss is
    one ``tune.cache`` miss and leaves ``cfg`` without a policy."""
    store = PolicyStore(tmp_path / "t.json")
    _put(store, train, _POL, b_or_t=999)         # another shape only
    tel = Telemetry()
    lda = _facade(store=store, layout=layout, token_budget=512 if
                  layout == "csr" else None,
                  telemetry=tel).partial_fit(train, steps=0)
    assert lda.cfg.kernel_policy is None
    assert _counts(tel) == (0, 1)


@pytest.mark.parametrize("layout", ["padded", "csr"])
def test_facade_store_hit_rides_cfg_and_checkpoint(train, tmp_path, layout):
    store = PolicyStore(tmp_path / "t.json")
    pol = KernelPolicy(block_b=64, double_buffer_depth=3)
    if layout == "csr":
        _put(store, train, pol, b_or_t=512, layout="csr", w=None)
    else:
        _put(store, train, pol)
    tel = Telemetry()
    lda = _facade(store=store, layout=layout, token_budget=512 if
                  layout == "csr" else None,
                  telemetry=tel).partial_fit(train, steps=2)
    assert lda.cfg.kernel_policy == pol
    assert lda.trainer.eng.cfg.kernel_policy == pol
    assert _counts(tel) == (1, 0)        # looked up once, by the engine
    ck = str(tmp_path / "ck")
    lda.save(ck)
    loaded = LDA.load(ck, device=CPU)
    assert loaded.cfg.kernel_policy == pol
    loaded.resume(train)
    loaded.partial_fit(steps=1)
    lda.partial_fit(steps=1)
    np.testing.assert_array_equal(lda.lam.numpy(), loaded.lam.numpy())
    # the training policy does not ride into serving's shapes: the
    # inferencer resolves its own (padded: batch 8, a miss; csr: the same
    # token budget, a hit)
    inf = lda.inferencer(batch_size=8)
    if layout == "csr":
        assert inf.cfg.kernel_policy == pol and _counts(tel) == (2, 0)
    else:
        assert inf._cfg_for_width(train.max_unique).kernel_policy is None
        assert _counts(tel) == (1, 1)


def test_engine_looks_up_once_and_explicit_policy_wins(train, tmp_path):
    from repro_torch.core.engines import LDAEngine
    store = PolicyStore(tmp_path / "t.json")
    pol = KernelPolicy(block_b=64)
    _put(store, train, pol)
    tel = Telemetry()
    eng = LDAEngine(_cfg(), train, algo="ivi", batch_size=16, device=CPU,
                    tune_store=store, telemetry=tel)
    assert eng.cfg.kernel_policy == pol and _counts(tel) == (1, 0)
    mine = KernelPolicy(block_b=32)
    eng = LDAEngine(_cfg(kernel_policy=mine), train, algo="ivi",
                    batch_size=16, device=CPU, tune_store=store)
    assert eng.cfg.kernel_policy == mine
    # another backend is not the port's kernels: no lookup
    eng = LDAEngine(_cfg(estep_backend="gather"), train, algo="ivi",
                    batch_size=16, device=CPU, tune_store=store)
    assert eng.cfg.kernel_policy is None


def test_inferencer_resolves_per_width(tmp_path):
    pol = KernelPolicy(block_b=64)
    store = PolicyStore(tmp_path / "t.json")
    store.put(PolicyKey(backend="cuda", layout="padded", b_or_t=8,
                        v=SPEC.vocab_size, k=4, w=16,
                        device_kind="cpu:cpu"), pol, **_META)
    lam = torch.ones((SPEC.vocab_size, 4))
    tel = Telemetry()
    inf = TopicInferencer(_cfg(), lam, batch_size=8, tune_store=store,
                          telemetry=tel, device=CPU)
    assert inf._cfg_for_width(16).kernel_policy == pol
    assert inf._cfg_for_width(32).kernel_policy is None
    assert inf._cfg_for_width(16).kernel_policy == pol
    assert _counts(tel) == (1, 1)
    # csr serving resolves its one shape at construction
    store.put(PolicyKey(backend="cuda", layout="csr", b_or_t=512,
                        v=SPEC.vocab_size, k=4, w=None,
                        device_kind="cpu:cpu"), pol, **_META)
    tel = Telemetry()
    inf = TopicInferencer(_cfg(), lam, batch_size=8, layout="csr",
                          token_budget=512, tune_store=store, telemetry=tel,
                          device=CPU)
    assert inf.cfg.kernel_policy == pol and _counts(tel) == (1, 0)


def test_inferencer_buffer_depth_from_policy(train):
    lam = torch.ones((SPEC.vocab_size, 4))
    base = _cfg()
    assert TopicInferencer(base, lam, device=CPU)._buffer_depth() == 2
    deep = dataclasses.replace(
        base, kernel_policy=KernelPolicy(double_buffer_depth=4))
    inf = TopicInferencer(deep, lam, batch_size=8, device=CPU)
    assert inf._buffer_depth() == 4
    # the depth changes the staging queue, not the bits
    shallow = TopicInferencer(base, lam, batch_size=8, device=CPU)
    docs = [(train.token_ids[i][train.counts[i] > 0].numpy(),
             train.counts[i][train.counts[i] > 0].numpy())
            for i in range(40)]
    np.testing.assert_array_equal(inf.posterior_docs(docs),
                                  shallow.posterior_docs(docs))


def test_port_checkpoint_with_tuned_policy_loads_in_repro(train, tmp_path):
    """A tuned port run's checkpoint resumes in ``repro``: its policy in
    ``repro``'s nine fields (the port's block_b, wire and depth)."""
    store = PolicyStore(tmp_path / "t.json")
    pol = KernelPolicy(block_b=64, wire_dtype="float32",
                       double_buffer_depth=3)
    _put(store, train, pol)
    lda = _facade(store=store).partial_fit(train, steps=1)
    ck = str(tmp_path / "ck")
    lda.save(ck)
    j = JLDA.load(ck)
    assert j.cfg.kernel_policy == JPolicy(block_b=64, wire_dtype="float32",
                                          double_buffer_depth=3)
    assert isinstance(j.cfg, JConfig)
    from repro.data import PAPER_CORPORA as J_CORPORA
    from repro.data import make_corpus as j_make_corpus
    j.resume(j_make_corpus(J_CORPORA["tiny"], seed=0))
    assert j.docs_seen == lda.docs_seen


def test_launch_train_tune_store(tmp_path, monkeypatch, capsys, train):
    """``launch.train --tune-store``: the run resolves the store's policy
    at its shape and prints it."""
    from repro_torch.launch import train as launcher
    store = PolicyStore(tmp_path / "t.json")
    pol = KernelPolicy(double_buffer_depth=3)
    _put(store, train, pol, b_or_t=16)
    monkeypatch.setattr("sys.argv", [
        "train", "lda", "--corpus", "tiny", "--topics", "4", "--device",
        "cpu", "--epochs", "1", "--batch", "16", "--estep-iters", "8",
        "--tune-store", str(tmp_path / "t.json")])
    launcher.main()
    assert f"kernel_policy={pol}" in capsys.readouterr().out


def test_store_module_imports_no_jax():
    assert "jax" not in tstore.__dict__
