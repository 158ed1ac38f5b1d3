"""Port parity, serving: ``repro_torch.lda.TopicInferencer`` against
``repro.lda.TopicInferencer`` on the same λ, on both layouts; the
double-buffered path bit-equal to the synchronous one; the padded
``posterior``, packed on the device, bit-equal to the host-staged
algorithm it replaced (kept here as a twin); ``swap_model`` under a
concurrent swapper; the bookkeeping.

Tolerances: γ at ``tests/test_torch_estep.py``'s backend bar, rtol 2e-3 /
atol 2e-3 (the fixed points stop at a mean |Δγ| of ``estep_tol``, so two
packages agree to about that); θ̄ likewise; bookkeeping (padding, widths,
versions) exactly.
"""
import dataclasses
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import LDAConfig as JConfig
from repro.data import PAPER_CORPORA as J_CORPORA
from repro.data import make_corpus as j_make_corpus
from repro.data.stream import CorpusDocStream as JStream
from repro.lda import TopicInferencer as JInferencer
from repro_torch.core.estep import BowBatch, get_backend
from repro_torch.core.types import Corpus, LDAConfig
from repro_torch.data.stream import (TOKEN_SLOT_BYTES, BatchPacker,
                                     CorpusDocStream, bucket_rows)
from repro_torch.data.synthetic import PAPER_CORPORA, make_corpus
from repro_torch.lda import TopicInferencer, topic_posterior

CPU = "cpu"
SPEC = PAPER_CORPORA["tiny"]
K = 6


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(3)
    lam = rng.gamma(2.0, 0.5, (SPEC.vocab_size, K)).astype(np.float32)
    lam2 = rng.gamma(2.0, 0.5, (SPEC.vocab_size, K)).astype(np.float32)
    return (lam, lam2, j_make_corpus(J_CORPORA["tiny"], split="test", seed=0),
            make_corpus(SPEC, split="test", seed=0, device=CPU),
            make_corpus(SPEC, seed=0, device=CPU))


def _cfgs(backend="gather", jbackend="gather"):
    kw = dict(num_topics=K, vocab_size=SPEC.vocab_size, estep_max_iters=50)
    return (JConfig(estep_backend=jbackend, **kw),
            LDAConfig(estep_backend=backend, **kw))


def _close(got, want):
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("backend", ["gather", "cuda"])
@pytest.mark.parametrize("layout", ["padded", "csr"])
def test_posterior_matches_repro(setup, backend, layout):
    """``posterior`` and ``posterior_docs`` (both paths) against ``repro``'s
    gather inferencer on the same λ; padding and widths as ``repro``'s."""
    lam, _, jtest, test, _ = setup
    jcfg, cfg = _cfgs(backend)
    kw = dict(batch_size=8, layout=layout)
    if layout == "csr":
        kw["token_budget"] = 128
    jinf = JInferencer(jcfg, jnp.asarray(lam), **kw)
    inf = TopicInferencer(cfg, lam, device=CPU, **kw)
    want = jinf.posterior(jtest)
    _close(inf.posterior(test), want)
    assert inf.padding_stats() == jinf.padding_stats()
    assert (inf.cache_info()["batches_per_width"]
            == jinf.cache_info()["batches_per_width"])
    want_docs = jinf.posterior_docs(JStream(jtest))
    for double_buffer in (True, False):
        got = inf.posterior_docs(CorpusDocStream(test),
                                 double_buffer=double_buffer)
        _close(got, want_docs)
    _close(inf.transform(test), jinf.transform(jtest))


@pytest.mark.parametrize("layout", ["padded", "csr"])
def test_double_buffer_bit_equal_to_synchronous(setup, layout):
    lam, _, _, test, train = setup
    _, cfg = _cfgs("cuda")
    inf = TopicInferencer(cfg, lam, batch_size=16, layout=layout,
                          token_budget=256 if layout == "csr" else None,
                          device=CPU)
    docs = [(ids[c > 0].numpy(), c[c > 0].numpy())
            for ids, c in zip(train.token_ids, train.counts)]
    a = inf.posterior_docs(docs, double_buffer=True)
    b = inf.posterior_docs(docs, double_buffer=False)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (train.num_docs, K)
    np.testing.assert_array_equal(inf.posterior_docs(docs[:0]),
                                  np.zeros((0, K), np.float32))


def _host_staged(inf, corpus):
    """The padded ``posterior`` as the host staged it: ``bucket_rows``,
    ``batch_size``-row numpy batches padded with id 0 and count 0, each
    through the backend's ``solve_gamma`` at its width's cfg, γ placed by
    request position. Returns (γ, ``padding_stats()``, ``cache_info()``) as
    a fresh inferencer would report them."""
    ids_all = corpus.token_ids.numpy()
    cnts_all = corpus.counts.numpy()
    bs = inf.batch_size
    backend = get_backend(inf.cfg.estep_backend)
    gamma = np.zeros((corpus.num_docs, K), np.float32)
    live = padded = 0
    widths = {}
    for rows_all, width in bucket_rows(cnts_all):
        for lo in range(0, len(rows_all), bs):
            rows = rows_all[lo:lo + bs]
            ids = np.zeros((bs, width), np.int32)
            cnts = np.zeros((bs, width), np.float32)
            ids[:len(rows)] = ids_all[rows, :width]
            cnts[:len(rows)] = cnts_all[rows, :width]
            live += int((cnts > 0).sum())
            padded += cnts.size
            widths[width] = widths.get(width, 0) + 1
            g = backend.solve_gamma(inf._cfg_for_width(width),
                                    inf.exp_elog_beta,
                                    BowBatch(torch.from_numpy(ids),
                                             torch.from_numpy(cnts)))
            gamma[rows] = g[:len(rows)].numpy()
    stats = {"live_slots": live, "padded_slots": padded,
             "pad_frac": 1.0 - live / max(padded, 1),
             "wasted_token_bytes": (padded - live) * TOKEN_SLOT_BYTES}
    info = {"batches_per_width": widths, "compiled_widths": sorted(widths),
            "jit_entries": len(widths)}
    return gamma, stats, info


def _edge_request(rows=24, width=20, seed=5):
    """Rows of every shape the cut must get right at ``width`` 20 (ladder
    8, 16, 20): empty documents, a last live slot exactly on the rungs 8
    and 16 and on the full width, one just past a rung, zero-count holes
    (a live id kept under a count 0) before the last live slot, one live
    slot; then random rows."""
    rng = np.random.default_rng(seed)
    ids = np.zeros((rows, width), np.int32)
    cnts = np.zeros((rows, width), np.float32)
    lives = {0: [], 1: list(range(8)), 2: list(range(16)),
             3: [0, 1, 2] + list(range(4, 10)), 4: list(range(20)), 5: [],
             6: list(range(9)), 7: [0], 8: [1, 15], 9: [0, 19]}
    for r in range(rows):
        cols = lives.get(r)
        if cols is None:
            n = int(rng.integers(1, width + 1))
            cols = sorted(rng.choice(n, size=max(1, n - 2), replace=False))
        ids[r] = rng.choice(SPEC.vocab_size, size=width, replace=False)
        cnts[r, cols] = rng.integers(1, 5, size=len(cols))
    ids[5] = 0                                  # an all-padding row
    return Corpus(torch.from_numpy(ids), torch.from_numpy(cnts))


@pytest.mark.parametrize("backend", ["gather", "cuda"])
@pytest.mark.parametrize("request_kind", ["corpus", "edges", "short"])
def test_posterior_bit_equal_to_host_staged(setup, backend, request_kind):
    """The padded ``posterior`` (packed on the device, here CPU tensors on
    the CPU: a request already on the solving device) gives the
    host-staged twin's γ bit for bit, and its padding and width
    bookkeeping; a second request leaves the first one's array as it
    was. ``short``: fewer documents than one batch. A loose tolerance
    stops the batches before the sweep cap, so a padding row with content
    would move the stop, and the bits."""
    lam, _, _, test, _ = setup
    cfg = dataclasses.replace(_cfgs(backend)[1], estep_tol=1e-2)
    request = {"corpus": test, "edges": _edge_request(),
               "short": Corpus(test.token_ids[:3], test.counts[:3])
               }[request_kind]
    inf = TopicInferencer(cfg, lam, batch_size=8, device=CPU)
    want, stats, info = _host_staged(inf, request)
    got = inf.posterior(request)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and got.shape == (request.num_docs, K)
    assert inf.padding_stats() == stats
    assert inf.cache_info() == info
    kept = got.copy()
    other = _edge_request(seed=6)
    np.testing.assert_array_equal(inf.posterior(other),
                                  _host_staged(inf, other)[0])
    np.testing.assert_array_equal(got, kept)


def test_posterior_host_waits_and_spans(setup):
    """With telemetry on, each padded ``posterior`` waits on the device
    twice (``serve.host_waits``) and opens ``serve/bucket`` once,
    ``serve/stage`` once for the copy in and once a batch, ``serve/solve``
    once a batch and ``serve/gather`` once: the names the benchmark's idle
    readers sum under."""
    from repro_torch.obs import Telemetry, spans_by_name
    lam, _, _, test, _ = setup
    _, cfg = _cfgs("cuda")
    tel = Telemetry()
    inf = TopicInferencer(cfg, lam, batch_size=8, telemetry=tel, device=CPU)
    short = Corpus(test.token_ids[:3], test.counts[:3])
    for calls, request in ((1, test), (2, short)):
        n = sum(-(-len(rows) // 8)
                for rows, _ in bucket_rows(request.counts.numpy()))
        before = {k: v["count"]
                  for k, v in spans_by_name(tel.trace.records).items()}
        inf.posterior(request)
        assert tel.metrics.total("serve.host_waits") == 2 * calls
        spans = {k: v["count"] - before.get(k, 0)
                 for k, v in spans_by_name(tel.trace.records).items()}
        assert spans == {"serve/request": 1, "serve/bucket": 1,
                         "serve/stage": 1 + n, "serve/solve": n,
                         "serve/gather": 1}
    inf.posterior_docs(CorpusDocStream(short))
    assert tel.metrics.total("serve.host_waits") == 4


def test_posterior_packed_and_packer_kwargs(setup):
    """A batch packed with ``packer_kwargs`` gives ``posterior_docs``'s bits
    and reports the snapshot's version."""
    lam, _, _, test, _ = setup
    _, cfg = _cfgs("cuda")
    inf = TopicInferencer(cfg, lam, batch_size=8, device=CPU)
    packer = BatchPacker(**inf.packer_kwargs())
    stream = CorpusDocStream(test)
    batches = [b for b in (packer.add(p, i, c) for p, (i, c)
                           in enumerate(stream.iter_from(0))) if b]
    batches += packer.flush()
    want = inf.posterior_docs(CorpusDocStream(test))
    for batch in batches:
        rows, gamma, n, version = inf.posterior_packed(batch)
        assert version == 0
        np.testing.assert_array_equal(gamma[:n].numpy(), want[rows])


def test_swap_model_under_traffic(setup):
    """A swapper thread flips between two snapshots while batches are
    served: each batch's γ is the result of the snapshot whose version it
    reports, and the versions only advance."""
    lam, lam2, _, test, _ = setup
    _, cfg = _cfgs("cuda")
    inf = TopicInferencer(cfg, lam, batch_size=4, device=CPU)
    want = {0: TopicInferencer(cfg, lam, batch_size=4, device=CPU),
            1: TopicInferencer(cfg, lam2, batch_size=4, device=CPU)}
    packer = BatchPacker(**inf.packer_kwargs())
    batches = [b for b in (packer.add(p, i, c) for p, (i, c)
                           in enumerate(CorpusDocStream(test).iter_from(0)))
               if b] + packer.flush()
    stop = threading.Event()

    def swapper():
        n = 0
        while not stop.is_set() and n < 200:
            n += 1
            inf.swap_model(lam2 if n % 2 else lam)

    t = threading.Thread(target=swapper)
    t.start()
    seen = []
    try:
        for _ in range(3):
            for batch in batches:
                rows, gamma, n, version = inf.posterior_packed(batch)
                ref = want[version % 2].posterior_packed(batch)[1]
                assert torch.equal(gamma, ref)
                seen.append(version)
    finally:
        stop.set()
        t.join(timeout=60)
    assert not t.is_alive()
    assert seen == sorted(seen)
    assert inf.model_version >= seen[-1]
    with pytest.raises(ValueError, match="advance"):
        inf.swap_model(lam, version=inf.model_version)
    with pytest.raises(ValueError, match="exactly one"):
        inf.swap_model()
    with pytest.raises(ValueError, match="geometry"):
        inf.swap_model(lam[:, :2])


def test_inferencer_refusals_and_one_shot(setup, tmp_path):
    lam, _, jtest, test, _ = setup
    jcfg, cfg = _cfgs()
    # a tune store is accepted: each bucket width resolves once (a hit for
    # the stored width, a miss for another)
    from repro_torch.core.types import KernelPolicy
    from repro_torch.obs import Telemetry
    from repro_torch.tune import PolicyKey, PolicyStore
    store = PolicyStore(tmp_path / "store.json")
    pol = KernelPolicy(double_buffer_depth=3)
    store.put(PolicyKey(backend="cuda", layout="padded", b_or_t=8,
                        v=SPEC.vocab_size, k=K, w=16,
                        device_kind="cpu:cpu"), pol)
    tel = Telemetry()
    tuned = TopicInferencer(_cfgs("cuda")[1], lam, batch_size=8,
                            tune_store=store, telemetry=tel, device=CPU)
    assert tuned._cfg_for_width(16).kernel_policy == pol
    assert tuned._cfg_for_width(32).kernel_policy is None
    assert tuned._cfg_for_width(16).kernel_policy == pol
    assert tel.metrics.value("tune.cache", result="hit") == 1
    assert tel.metrics.value("tune.cache", result="miss") == 1
    with pytest.raises(ValueError, match="layout"):
        TopicInferencer(cfg, lam, layout="ragged", device=CPU)
    with pytest.raises(ValueError, match="estep backend"):
        TopicInferencer(cfg, lam, backend="pallas", device=CPU)
    gamma, theta = topic_posterior(cfg, lam, test, batch_size=8, device=CPU)
    jinf = JInferencer(jcfg, jnp.asarray(lam), batch_size=8)
    _close(gamma, jinf.posterior(jtest))
    np.testing.assert_allclose(theta.sum(-1), 1.0, atol=1e-5)
