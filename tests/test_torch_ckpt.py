"""Port parity, checkpoints: ``repro``'s manifest format written and read by
the port, in both directions.

* Inside the port, save → load → resume mid-epoch is bit-equal to the run
  that never stopped: dense, chunked and γ-only stores; padded, CSR and a
  stream; buckets; MVI's γ buffer.
* A port checkpoint resumes in ``repro`` (its bf16 chunks tagged as
  ``repro`` tags them, the ``cuda`` backend named ``pallas``, the kernel
  policy with ``repro``'s nine fields), and ``repro``'s bf16 arrays read
  back in the port without ``ml_dtypes``, bit for bit.
* The legacy bare-λ ``.npz`` loads serve-only, and every refusal of
  ``tests/test_lda_api.py`` has its counterpart.

Tolerances: bit-equality inside the port and for every restored array; a
resumed ``repro`` run against the port's continuation at
``tests/test_torch_engine.py``'s λ rtol 1e-3 / atol 1e-3.
"""
import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import load_manifest as j_load_manifest
from repro.checkpoint import save_manifest as j_save_manifest
from repro.core import LDAConfig as JConfig
from repro.core import LDAEngine as JEngine
from repro.data import PAPER_CORPORA as J_CORPORA
from repro.data import make_corpus as j_make_corpus
from repro.lda import LDA as JLDA
from repro_torch.checkpoint import load_manifest, save_manifest
from repro_torch.core.types import KernelPolicy, LDAConfig
from repro_torch.data.stream import CorpusDocStream
from repro_torch.data.synthetic import PAPER_CORPORA, make_corpus
from repro_torch.dist import DIVIConfig
from repro_torch.lda import LDA

CPU = "cpu"
SPEC = PAPER_CORPORA["tiny"]


@pytest.fixture(scope="module")
def corpora():
    return (j_make_corpus(J_CORPORA["tiny"], seed=0),
            make_corpus(SPEC, seed=0, device=CPU),
            make_corpus(SPEC, split="test", seed=0, device=CPU))


@pytest.fixture
def world1_mesh(tmp_path):
    """A (1, 1) CPU mesh over a one-process gloo group in this process."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        yield make_host_mesh(1, 1, device="cpu")
    finally:
        dist.destroy_process_group()


def _cfg(**kw):
    kw.setdefault("estep_max_iters", 20)
    return LDAConfig(num_topics=4, vocab_size=SPEC.vocab_size, **kw)


def _equal_state(a, b):
    for f in ("lam", "m_vk", "init_mass", "init_frac", "t"):
        assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f


# ---------------------------------------------------------------------------
# inside the port: mid-epoch save → load → resume is bit-equal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("store,algo,layout,bucketed,stream", [
    ("dense", "ivi", "padded", False, False),
    ("chunked", "ivi", "padded", False, False),
    ("gamma", "sivi", "padded", False, False),
    ("dense", "ivi", "padded", True, False),
    ("dense", "svi", "padded", False, False),
    ("dense", "ivi", "csr", False, False),
    ("chunked", "ivi", "csr", False, False),
    ("dense", "ivi", "padded", False, True),
    ("chunked", "sivi", "padded", False, True),
])
def test_resume_mid_epoch_bit_equal(tmp_path, corpora, store, algo, layout,
                                    bucketed, stream):
    _, train, _ = corpora
    data = CorpusDocStream(train) if stream else train
    kw = dict(algo=algo, batch_size=16, seed=7, memo_store=store,
              chunk_docs=16, bucket_by_length=bucketed, layout=layout,
              device=CPU)
    if layout == "csr":
        kw["token_budget"] = 256
    path = os.path.join(tmp_path, "ck")
    a = LDA(_cfg(), **kw).partial_fit(data, steps=3)
    if layout == "padded" and not stream:
        assert a.trainer.pending_batches > 0       # genuinely mid-epoch
    else:
        assert a.trainer.stream_cursor > 0
    a.save(path)
    a.partial_fit(steps=4)                         # across the epoch's end
    b = LDA.load(path, device=CPU).resume(data)
    b.partial_fit(steps=4)
    _equal_state(a, b)
    assert a.docs_seen == b.docs_seen
    if a.trainer.eng.memo is not None:
        sa = a.trainer.eng.memo.state_dict()
        sb = b.trainer.eng.memo.state_dict()
        assert sorted(sa) == sorted(sb)
        for key in sa:
            np.testing.assert_array_equal(sa[key], sb[key])


def test_resume_mvi_epoch_bit_equal(tmp_path, corpora):
    """MVI's γ warm-start buffer rides in the checkpoint."""
    _, train, _ = corpora
    path = os.path.join(tmp_path, "ck")
    a = LDA(_cfg(), algo="mvi", batch_size=16, seed=1,
            device=CPU).fit(train, epochs=1)
    a.save(path)
    a.fit(epochs=1)
    b = LDA.load(path, device=CPU).resume(train).fit(epochs=1)
    _equal_state(a, b)


def test_resave_to_same_path(tmp_path, corpora):
    _, train, _ = corpora
    path = os.path.join(tmp_path, "ck")
    a = LDA(_cfg(), algo="ivi", batch_size=16, seed=5, device=CPU)
    a.partial_fit(train, steps=2).save(path)
    a.partial_fit(steps=2).save(path)
    b = LDA.load(path, device=CPU).resume(train)
    _equal_state(a, b)


# ---------------------------------------------------------------------------
# port → repro
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("store,algo,layout", [
    ("dense", "ivi", "padded"),
    ("chunked", "ivi", "padded"),
    ("gamma", "sivi", "padded"),
    ("dense", "ivi", "csr"),
])
def test_port_checkpoint_resumes_in_repro(tmp_path, corpora, store, algo,
                                          layout):
    jtrain, train, _ = corpora
    kw = dict(algo=algo, batch_size=16, seed=7, memo_store=store,
              chunk_docs=16, layout=layout)
    if layout == "csr":
        kw["token_budget"] = 256
    path = os.path.join(tmp_path, "ck")
    a = LDA(_cfg(), device=CPU, **kw).partial_fit(train, steps=3)
    a.save(path)
    j = JLDA.load(path).resume(jtrain)
    np.testing.assert_array_equal(np.asarray(j.lam), a.lam.numpy())
    assert j.docs_seen == a.docs_seen
    sa, sj = a.trainer.eng.memo.state_dict(), j.trainer.eng.memo.state_dict()
    for key, arr in sa.items():
        want = np.asarray(sj[key])
        if want.dtype == ml_dtypes.bfloat16:
            want = want.view(np.uint16)
        np.testing.assert_array_equal(arr, want)
    a.partial_fit(steps=2)
    j.partial_fit(steps=2)
    np.testing.assert_allclose(np.asarray(j.lam), a.lam.numpy(), rtol=1e-3,
                               atol=1e-3)
    assert j.docs_seen == a.docs_seen


def test_port_names_in_repro_vocabulary(tmp_path, corpora):
    """``cuda`` is written as ``pallas`` and the policy with ``repro``'s
    nine fields; ``repro`` rebuilds it, and the port maps both back."""
    _, train, _ = corpora
    cfg = _cfg(estep_backend="cuda", kernel_policy=KernelPolicy(block_b=64))
    path = os.path.join(tmp_path, "ck")
    LDA(cfg, algo="ivi", batch_size=16, device=CPU).partial_fit(
        train, steps=1).save(path)
    with open(os.path.join(path, "manifest.json")) as f:
        ctor = json.load(f)["meta"]["constructor"]["cfg"]
    assert ctor["estep_backend"] == "pallas"
    assert ctor["kernel_policy"] == {
        "block_b": 64, "block_v": 512, "delta_block_b": 32,
        "delta_block_v": None, "pi_block_l": 512, "scatter_block_t": 128,
        "block_t": 512, "wire_dtype": None, "double_buffer_depth": 2}
    j = JLDA.load(path)
    assert j.cfg.estep_backend == "pallas"
    assert j.cfg.kernel_policy.block_b == 64
    back = LDA.load(path, device=CPU)
    assert back.cfg == cfg


def test_repro_policy_loads_with_block_b_only(tmp_path, corpora):
    """A ``repro`` policy whose TPU-only fields differ from the defaults
    loads with its ``block_b`` and the two fields both packages share
    (``wire_dtype``, ``double_buffer_depth``); the TPU tiles are
    dropped."""
    from repro.core.types import KernelPolicy as JPolicy
    jtrain, _, _ = corpora
    jcfg = JConfig(num_topics=4, vocab_size=SPEC.vocab_size,
                   estep_max_iters=20,
                   kernel_policy=JPolicy(block_b=32, block_v=256,
                                         double_buffer_depth=3))
    path = os.path.join(tmp_path, "ck")
    JLDA(jcfg, algo="ivi", batch_size=16).partial_fit(jtrain,
                                                      steps=1).save(path)
    t = LDA.load(path, device=CPU)
    assert t.cfg.kernel_policy == KernelPolicy(block_b=32,
                                               double_buffer_depth=3)


# ---------------------------------------------------------------------------
# the manifest's bf16 tag without ml_dtypes
# ---------------------------------------------------------------------------

def test_manifest_bf16_bits_both_ways(tmp_path):
    rng = np.random.default_rng(0)
    vals = (rng.standard_normal((5, 7)) * 10.0 ** rng.integers(-6, 4, (5, 7)))
    jbf = vals.astype(ml_dtypes.bfloat16)
    bits = jbf.view(np.uint16)
    # repro → port: ml_dtypes bf16 reads as torch.bfloat16, same bits
    j_save_manifest(os.path.join(tmp_path, "j"), {"x": 1},
                    {"g": {"a": jbf, "b": np.arange(3)}})
    meta, arrays = load_manifest(os.path.join(tmp_path, "j"))
    assert meta == {"x": 1}
    got = arrays["g"]["a"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy()
                                  .view(np.uint16), bits)
    np.testing.assert_array_equal(arrays["g"]["b"], np.arange(3))
    # port → repro: a torch.bfloat16 tensor is tagged and read as bf16
    save_manifest(os.path.join(tmp_path, "t"), {"y": 2},
                  {"g": {"a": got, "c": torch.ones(2)}})
    meta, jarrays = j_load_manifest(os.path.join(tmp_path, "t"))
    assert meta == {"y": 2}
    assert jarrays["g"]["a"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(jarrays["g"]["a"].view(np.uint16), bits)
    np.testing.assert_array_equal(jarrays["g"]["c"], np.ones(2, np.float32))


def test_manifest_refuses_other_tags_and_versions(tmp_path):
    j_save_manifest(os.path.join(tmp_path, "f8"), {},
                    {"g": {"a": np.zeros(3, ml_dtypes.float8_e4m3fn)}})
    with pytest.raises(ValueError, match="dtype tag"):
        load_manifest(os.path.join(tmp_path, "f8"))
    path = os.path.join(tmp_path, "v")
    save_manifest(path, {}, {"g": {"a": np.zeros(2)}})
    with open(os.path.join(path, "manifest.json")) as f:
        doc = json.load(f)
    doc["manifest_version"] = 99
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(doc, f)
    with pytest.raises(ValueError, match="manifest version"):
        load_manifest(path)


# ---------------------------------------------------------------------------
# legacy bare-λ checkpoints and the refusals
# ---------------------------------------------------------------------------

def test_legacy_bare_lambda_checkpoint(tmp_path, corpora):
    from repro.checkpoint import save_checkpoint
    jtrain, train, test = corpora
    jcfg = JConfig(num_topics=4, vocab_size=SPEC.vocab_size,
                   estep_max_iters=20)
    eng = JEngine(jcfg, jtrain, algo="ivi", batch_size=16, seed=0)
    eng.run_epoch()
    path = os.path.join(tmp_path, "legacy.npz")
    save_checkpoint(path, eng.state)
    with pytest.warns(DeprecationWarning, match="CANNOT resume"):
        lda = LDA.load(path, device=CPU)
    np.testing.assert_array_equal(lda.lam.numpy(), np.asarray(eng.state.lam))
    assert lda.transform(test).shape == (test.num_docs, 4)
    with pytest.raises(ValueError, match="resume"):
        lda.resume(train)
    with pytest.raises(ValueError, match="serve-only"):
        lda.fit(train, epochs=1)
    with pytest.raises(FileNotFoundError, match="neither"):
        LDA.load(os.path.join(tmp_path, "missing"), device=CPU)


def test_refusals(tmp_path, corpora):
    """The counterparts of ``tests/test_lda_api.py``'s refusals."""
    _, train, test = corpora
    path = os.path.join(tmp_path, "ck")
    LDA(_cfg(), algo="ivi", batch_size=16, device=CPU).partial_fit(
        train, steps=1).save(path)
    loaded = LDA.load(path, device=CPU)
    with pytest.raises(ValueError, match="resume"):
        loaded.fit(train, epochs=1)                 # not resumed yet
    loaded.resume(train).fit(epochs=1)              # the way that works
    with pytest.raises(ValueError, match="nothing to resume"):
        loaded.resume(train)
    with pytest.raises(ValueError, match="checkpoint"):
        LDA.load(path, device=CPU).resume(test)     # another corpus
    chunked = os.path.join(tmp_path, "chunked")
    LDA(_cfg(), algo="ivi", batch_size=16, memo_store="chunked",
        device=CPU).partial_fit(train, steps=1).save(chunked)
    b = LDA.load(chunked, device=CPU)
    b.memo_store = "dense"                          # a mismatched rebuild
    with pytest.raises(ValueError, match="memo store"):
        b.resume(train)
    with pytest.raises(ValueError, match="incompatible"):
        LDA(_cfg(), algo="ivi", distributed=DIVIConfig(), device=CPU)
    with pytest.raises(TypeError, match="not both"):
        LDA(_cfg(), num_topics=8, device=CPU)
    with pytest.raises(ValueError, match="unknown algo"):
        LDA(_cfg(), algo="vb", device=CPU)
    assert LDA(_cfg(), algo="divi", device=CPU).distributed == DIVIConfig()
    with pytest.raises(TypeError, match="DeviceMesh"):
        LDA(_cfg(), algo="divi", mesh=object(), device=CPU)
    with pytest.raises(ValueError, match="single-host training"):
        LDA(_cfg(), mesh=object(), device=CPU)
    # a tune store is accepted: the bound training shape's policy is
    # looked up once (one tune.cache hit) and rides the cfg
    from repro_torch.obs import Telemetry
    from repro_torch.tune import PolicyKey, PolicyStore
    store = PolicyStore(os.path.join(tmp_path, "store.json"))
    pol = KernelPolicy(block_b=64)
    store.put(PolicyKey(backend="cuda", layout="padded", b_or_t=16,
                        v=SPEC.vocab_size, k=4, w=train.max_unique,
                        device_kind="cpu:cpu"), pol)
    tel = Telemetry()
    tuned = LDA(_cfg(estep_backend="cuda"), batch_size=16, tune_store=store,
                telemetry=tel, device=CPU).partial_fit(train, steps=0)
    assert tuned.cfg.kernel_policy == pol
    assert tuned.trainer.eng.cfg.kernel_policy == pol
    assert tel.metrics.value("tune.cache", result="hit") == 1
    assert tel.metrics.value("tune.cache", result="miss") == 0
    with pytest.raises(ValueError, match="already bound"):
        LDA(_cfg(), batch_size=16, device=CPU).partial_fit(
            train, steps=0).partial_fit(test)
    with pytest.raises(ValueError, match="not fitted"):
        LDA(_cfg(), device=CPU).evaluate()


def test_repro_divi_checkpoint_refuses(tmp_path, corpora, world1_mesh):
    """A ``repro`` D-IVI checkpoint loads in the port (its DIVIConfig in
    the constructor), and what the port still refuses is refused: another
    corpus (a foreign shard assignment). It resumes on a mesh as it does
    without one (a (1, 1) mesh here: the same bits)."""
    jtrain, train, test = corpora
    jcfg = JConfig(num_topics=4, vocab_size=SPEC.vocab_size,
                   estep_max_iters=10)
    from repro.dist import DIVIConfig as JDIVIConfig
    path = os.path.join(tmp_path, "ck")
    JLDA(jcfg, algo="divi", distributed=JDIVIConfig(num_workers=2,
                                                    batch_size=8)).fit(
        jtrain, rounds=1).save(path)
    loaded = LDA.load(path, device=CPU)
    assert loaded.distributed == DIVIConfig(num_workers=2, batch_size=8)
    with pytest.raises(ValueError, match="num_docs"):
        loaded.resume(test)
    on_mesh = LDA.load(path, device=CPU).resume(train, mesh=world1_mesh)
    assert on_mesh.trainer.eng.mesh is world1_mesh
    assert loaded.resume(train).docs_seen == 16 == on_mesh.docs_seen
    for lda in (loaded, on_mesh):
        lda.partial_fit(steps=1)
    _equal_state(loaded, on_mesh)
    assert torch.equal(on_mesh.gather_lam(), loaded.lam)


def test_divi_mesh_checkpoint_round_trip(tmp_path, corpora, world1_mesh):
    """``LDA(algo="divi", mesh=...)`` saves the checkpoint a one-device run
    saves (a (1, 1) mesh: the same bits), resumes on the mesh bit-equal to
    the run that never stopped, and loads into the simulation."""
    _, train, _ = corpora
    dcfg = DIVIConfig(num_workers=2, batch_size=8, staleness=2,
                      delay_prob=0.5)
    path = os.path.join(tmp_path, "mesh")
    a = LDA(_cfg(estep_backend="cuda"), algo="divi", distributed=dcfg,
            mesh=world1_mesh, device=CPU).partial_fit(train, steps=2)
    sim = LDA(_cfg(estep_backend="cuda"), algo="divi", distributed=dcfg,
              device=CPU).partial_fit(train, steps=2)
    _equal_state(a, sim)
    a.save(path)
    with pytest.raises(ValueError, match="gather_lam"):
        a.lam
    a.partial_fit(steps=2)
    b = LDA.load(path, device=CPU).resume(train, mesh=world1_mesh)
    b.partial_fit(steps=2)
    _equal_state(a, b)
    assert torch.equal(a.trainer.eng.shard.pi, b.trainer.eng.shard.pi)
    c = LDA.load(path, device=CPU).resume(train)
    c.partial_fit(steps=2)
    _equal_state(a, c)
    assert a.bound() == b.bound() == c.bound()


def test_launcher_ckpt_then_resume_equals_one_run(tmp_path, monkeypatch):
    """``launch.train --ckpt`` after one epoch, then ``--resume`` for one
    more, ends where a two-epoch facade run ends, bit for bit."""
    from repro_torch.launch import train as launcher
    path = os.path.join(tmp_path, "run")
    common = ["train", "lda", "--corpus", "tiny", "--topics", "4",
              "--device", "cpu", "--epochs", "1", "--memo-store", "chunked",
              "--chunk-docs", "32", "--batch", "16", "--estep-iters", "20",
              "--backend", "gather"]
    monkeypatch.setattr("sys.argv", common + ["--ckpt", path])
    launcher.main()
    monkeypatch.setattr("sys.argv", common + ["--resume", path, "--ckpt",
                                              path])
    launcher.main()
    b = LDA.load(path, device=CPU)
    train = make_corpus(SPEC, seed=0, device=CPU)
    a = LDA(_cfg(estep_backend="gather"), algo="ivi", batch_size=16,
            memo_store="chunked", chunk_docs=32, device=CPU)
    a.fit(train, epochs=2)
    np.testing.assert_array_equal(b.lam.numpy(), a.lam.numpy())
    b.resume(train)
    assert b.docs_seen == a.docs_seen == 2 * train.num_docs
