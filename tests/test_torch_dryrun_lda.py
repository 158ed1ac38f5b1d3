"""The meta-device LDA dry run (`repro_torch.launch.dryrun_lda`,
``serve_lda --dryrun``): ``repro``'s three modes at its Arxiv shape, on
``meta`` tensors, without a card or a process group.

* ``divi`` on ``repro``'s (16, 16) and (2, 16, 16) layouts: 2 launches a
  sub-round (K1 with its π finish, K3), the rank's argument bytes equal
  to the layout's arithmetic, the collectives' bytes (λ's V·K floats a
  round, D·(V/M·K + 1) a sub-round), peak ≥ arguments;
* ``ivi``: 2 launches an update, the memo stores' footprints equal to
  ``repro``'s formulas; an op that cannot run on ``meta`` is named;
* ``serve``: one launch a batch at each width, its argument bytes;
* the CLI lines, ``LiveBytes`` itself, and the wrappers' meta path (K1,
  K3 counted; K2 still refuses a meta tensor).
"""
import json

import numpy as np
import pytest
import torch

from repro.core.memo import memo_footprint_bytes as j_memo_footprint_bytes
from repro_torch.core.types import LDAConfig
from repro_torch.dist import DIVIConfig
from repro_torch.kernels import lda_estep
from repro_torch.launch import dryrun_lda
from repro_torch.launch.dryrun_lda import ARXIV, LiveBytes, divi_rank_plan
from repro_torch.launch.mesh import make_abstract_mesh

META = torch.device("meta")
V, K, L = ARXIV["vocab"], ARXIV["topics"], ARXIV["max_unique"]


@pytest.mark.parametrize("mesh_kind,data,model", [("single", 16, 16),
                                                  ("multi", 32, 16)])
def test_divi_mode_on_repros_layouts(mesh_kind, data, model):
    res = dryrun_lda.run(mesh_kind, 1024, 1)
    assert res["ok"], res.get("traceback")
    assert res["chips"] == data * model and res["workers"] == data
    assert res["launches"] == {"fixed_point": 1, "segment_scatter": 1}
    assert res["launches_per_subround"] == 2
    d_w = -(-ARXIV["num_docs"] // data)
    rows = V // model
    n, b = 1, 1024
    want = (3 * rows * K * 4 + 4 + 4                 # λ, m_vk, init_mass
            + d_w * L * K * 4 + d_w                  # one worker's memo
            + n * b * L * (4 + 4) + n * b * 8 + 4)   # ids, counts, rows, W
    assert res["argument_bytes"] == want
    assert res["collective_bytes"] == {
        "lam_gather_per_round": V * K * 4,
        "correction_gather_per_subround": data * (rows * K + 1) * 4}
    assert res["peak_bytes"] >= res["argument_bytes"] > 0
    assert 0 < res["temp_bytes"] < 1e9
    assert res["roofline"]["kernels_s"] > 0
    assert res["roofline"]["collective_s"] == pytest.approx(
        (V * K * 4 + data * (rows * K + 1) * 4) / 900e9)


def test_divi_mode_counts_launches_a_subround():
    res = dryrun_lda.run("single", 256, 2)
    assert res["ok"]
    assert res["launches"] == {"fixed_point": 2, "segment_scatter": 2}
    assert res["launches_per_subround"] == 2


def test_divi_plan_refuses_in_repros_words():
    cfg = LDAConfig(num_topics=8, vocab_size=250)
    with pytest.raises(ValueError, match="pad V"):
        divi_rank_plan(cfg, DIVIConfig(num_workers=4),
                       make_abstract_mesh((1, 4), ("data", "model")),
                       num_docs=96, max_unique=17)
    with pytest.raises(ValueError, match="data-mesh size"):
        divi_rank_plan(cfg, DIVIConfig(num_workers=6),
                       make_abstract_mesh((4, 1), ("data", "model")),
                       num_docs=96, max_unique=17)


def test_ivi_mode_launches_and_memo_footprints():
    res = dryrun_lda.run_ivi(1024)
    assert res["ok"], res.get("traceback")
    assert res["launches"] == {"fixed_point": 1, "segment_scatter": 1}
    assert res["kernels"] == 2
    for kind in ("dense", "chunked", "gamma"):
        assert res["memo_gb"][kind] == j_memo_footprint_bytes(
            kind, ARXIV["num_docs"], L, K, vocab_size=V) / 1e9
    assert res["memo_under_40gb"]
    assert res["memory"]["argument_gb"] > 0


def test_ivi_mode_names_an_op_that_cannot_run_on_meta(monkeypatch):
    """A host read in the update (here one put into the master step) is
    reported with the op it stopped at, and the launches before it."""
    from repro_torch.core import engines

    real = engines.retire_init_frac

    def host_read(init_frac, words, total):
        float(words)                       # a host read: not on meta
        return real(init_frac, words, total)

    monkeypatch.setattr(engines, "retire_init_frac", host_read)
    res = dryrun_lda.run_ivi(64)
    assert not res["ok"]
    assert res["failed_op"] not in ("None", "")
    assert res["launches_before_failure"] == {"fixed_point": 1,
                                              "segment_scatter": 1}


def test_serve_mode_one_launch_a_batch():
    from repro_torch.launch.serve_lda import ARXIV_WIDTHS, run_serve_dryrun
    res = run_serve_dryrun(batch=256)
    assert res["ok"], res.get("traceback")
    assert res["widths"] == list(ARXIV_WIDTHS) == [32, 64, 128]
    assert res["jit_cache_entries"] == 3
    for w, m in res["memory"].items():
        assert m["launches"] == 1
        assert m["argument_gb"] == (V * K * 4 + 256 * w * 8) / 1e9
        assert 0 < m["temp_gb"] < 0.5


def test_cli_prints_repros_summary_lines(capsys, tmp_path):
    out = tmp_path / "lda.jsonl"
    dryrun_lda.main(["--mode", "all", "--out", str(out)])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split("  ")[0] for ln in lines] == [
        "[OK ] lda-divi × single", "[OK ] lda-divi × multi",
        "[OK ] lda-ivi single-host", "[OK ] lda-serve single-host"]
    assert "launches/subround=2" in lines[0]
    recs = [json.loads(x) for x in out.read_text().splitlines()]
    assert [r["arch"] for r in recs] == ["lda-divi-arxiv", "lda-divi-arxiv",
                                        "lda-ivi-arxiv", "lda-serve-arxiv"]
    assert all(r["ok"] for r in recs)


def test_live_bytes_counts_storages_not_views():
    mode = LiveBytes()
    with mode:
        a = torch.empty((256, 4), device=META)       # 4 KiB
        v = a.view(-1)                               # a view: nothing new
        b = torch.empty((512, 4), device=META)       # 8 KiB
        a.add_(1.0)                                  # in place: nothing
        del a, v
        c = b + 1.0                                  # 8 KiB
    assert mode.peak == 4096 + 8192 + 8192 - 4096
    assert mode.live == 8192 + 8192
    del b, c
    assert mode.live == 0


def test_kernel_wrappers_on_meta():
    b, l, k, v = 12, 5, 8, 40
    ids = torch.empty((b, l), dtype=torch.int32, device=META)
    cnts = torch.empty((b, l), device=META)
    eb = torch.empty((v, k), device=META)
    g0 = torch.empty((b, k), device=META)
    lda_estep.reset_launches()
    gamma, et, iters, pi = lda_estep.estep_fixed_point_pi(
        ids, cnts, eb, g0, 0.1, 1e-3, 10, group=4)
    assert gamma.shape == (b, k) and pi.shape == (b, l, k)
    assert iters.shape == (3,) and gamma.device.type == "meta"
    s_new, s_old = lda_estep.segment_scatter(
        ids.reshape(-1), cnts.reshape(-1), pi.reshape(-1, k),
        pi.reshape(-1, k), v)
    assert s_new.shape == s_old.shape == (v, k)
    assert lda_estep.LAUNCHES["fixed_point"] == 1
    assert lda_estep.LAUNCHES["segment_scatter"] == 1
    with pytest.raises(ValueError, match="unsupported device"):
        lda_estep.token_pi(ids, cnts, eb, g0)
    # CPU tensors still take the twins, counting nothing
    cpu = lda_estep.estep_fixed_point(
        torch.zeros((b, l), dtype=torch.int32), torch.ones((b, l)),
        torch.full((v, k), 1.0 / v), torch.ones((b, k)), 0.1, 1e-3, 10)
    assert np.isfinite(cpu[0].numpy()).all()
    assert lda_estep.LAUNCHES["fixed_point"] == 1
