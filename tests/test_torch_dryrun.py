"""Port parity, the LM template's dry run (`repro_torch.launch.dryrun`,
`repro_torch.launch.cost`): one rank of ``repro``'s production meshes on
``meta`` tensors, with no process group and no card.

* Real pairs: ``qwen2.5-3b × decode_32k`` on the single mesh records
  ``ok``, 256 chips, positive roofline terms and products above 1e8 FLOPs
  (``repro``'s own guard, ``tests/test_dryrun_smoke.py``);
  ``deepseek-moe-16b × prefill_32k`` and ``command-r-35b × decode_32k``
  (its KV heads replicated, the cache length over ``model``) record
  ``ok``; further pairs cover every branch of ``cache_specs`` (the heads
  over ``model``; B = 1 with W over the data axes; the recurrent states'
  default leaf) and the MoE's decode.
* Argument bytes: a rank's parameters and caches equal Σ over leaves of
  numel ÷ the sizes of the axes ``repro``'s specs shard it over × the
  dtype's size.
* The FLOP counter: on a reduced config, the counted FLOPs equal the
  analytic count of the products plus K9's, and doubling the layers
  doubles the per-layer part (the counterpart of ``repro``'s trip-count
  tests, ``tests/test_sharding_launch.py``: the port's layers are a Python
  loop, each counted as it runs).
* The items: the ``train_4k`` pairs that item 10.5 made run record
  ``ok`` (argument bytes with the AdamW moments, the backward's
  reduce-scatters, no K9 launch), and so does a ``seq_shard`` pair, whose
  rank keeps smaller activations; ``gemma2-27b × prefill_32k`` runs since
  C1 (K9's window and softcap): 46 launches, its 23 local layers counting
  their band of kept pairs; the CLI's lines.
* The recurrent blocks' head-parallel form: no block runs whole (no ``whole_blocks`` field); the
  recurrent pairs sum their heads' partials over ``model``, a decode step
  restores its replicated states apart (``coll_state_restore``); a rank's
  products at ``prefill_32k`` are at most an eighth (zamba2-1.2b) and a
  third (xlstm-1.3b) of the whole-block figures, and zamba2's decode
  brings in at most a tenth of their all-gather bytes; a (2, 2) rank of
  the reduced recurrent models computes a part of the whole model's
  recurrent products, with and without ``seq_shard``.
"""
import dataclasses
import math

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as j_configs
from repro.launch.mesh import make_abstract_mesh as j_abstract_mesh
from repro.models import transformer as JT
from repro.sharding import rules as JR
from repro_torch import configs as t_configs
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_abstract_mesh
from repro_torch.models import transformer as TT
from repro_torch.sharding import make_ctx

SINGLE = ((16, 16), ("data", "model"))


@pytest.fixture(scope="module")
def qwen_decode():
    return D.run_pair("qwen2.5-3b", "decode_32k", "single")


def test_real_decode_pair(qwen_decode):
    res = qwen_decode
    assert res["ok"], res.get("error")
    assert res["chips"] == 256
    assert res["mesh_shape"] == {"data": 16, "model": 16}
    rf = res["roofline"]
    assert rf["compute_s"] > 0 and rf["memory_s"] > 0 \
        and rf["collective_s"] > 0
    assert res["hlo"]["dot_flops"] > 1e8
    assert res["memory"]["fits_card"]
    assert res["k9_launches"] == 0           # decode: no K9


@pytest.mark.parametrize("arch,shape", [
    ("deepseek-moe-16b", "prefill_32k"),     # MoE, K9 every layer
    ("command-r-35b", "decode_32k"),         # W over model
    ("gemma2-27b", "decode_32k"),            # KV heads over model
    ("qwen2.5-3b", "long_500k"),             # B = 1: W over data too
    ("zamba2-1.2b", "decode_32k"),           # recurrent default leaves
    ("xlstm-1.3b", "long_500k"),             # B = 1 recurrent states
    ("qwen3-moe-30b-a3b", "decode_32k"),     # the MoE's decode
])
def test_pairs_covering_the_branches(arch, shape):
    res = D.run_pair(arch, shape, "single")
    assert res["ok"], res.get("error")
    assert res["hlo"]["collective_bytes"] > 0
    if shape == "prefill_32k":
        cfg = t_configs.get_config(arch)
        assert res["k9_launches"] == cfg.num_layers
        assert res["hlo"]["k9_flops"] > 0
    assert "whole_blocks" not in res
    if arch in ("zamba2-1.2b", "xlstm-1.3b"):
        # the recurrent blocks' partials summed over model, the decode's
        # replicated states restored apart from the weights' gathers
        assert res["hlo"]["coll_all_reduce"] > 0
        assert res["hlo"]["coll_state_restore"] > 0
    if (arch, shape) == ("zamba2-1.2b", "decode_32k"):
        # a tenth of the 1.418e10 bytes the whole blocks gathered (the
        # shared block's KV cache over model), the restore included
        assert res["hlo"]["coll_all_gather"] \
            + res["hlo"]["coll_state_restore"] <= 1.42e9


#: a rank's dot FLOPs at prefill_32k on (16, 16) when every model rank ran
#: the recurrent blocks whole, before their head-parallel form, the factor
#: that form must take off them, and that run's largest roofline term
#: (compute_s)
WHOLE_PREFILL = {"zamba2-1.2b": (2.53e14, 8, 0.255),
                 "xlstm-1.3b": (3.19e14, 3, 0.323)}


@pytest.mark.parametrize("arch", list(WHOLE_PREFILL))
def test_recurrent_prefill_flops_split_over_model(arch):
    res = D.run_pair(arch, "prefill_32k", "single")
    assert res["ok"], res.get("error")
    flops, factor, term = WHOLE_PREFILL[arch]
    assert res["hlo"]["dot_flops"] <= flops / factor
    rf = res["roofline"]
    assert max(rf["compute_s"], rf["memory_s"], rf["collective_s"]) < term


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-1.3b"])
def test_recurrent_rank_computes_a_part(arch):
    """At (2, 2) a rank computes half the batch rows and a part of the
    heads: under half the (1, 1) rank's products (the readout's whole
    rows aside, each rank repeats only the small whole pieces: Mamba2's B
    and C, the mLSTM's xi and gates, the shared block's in_proj); with
    ``seq_shard`` the same products, the exits reduce-scattered."""
    cfg = t_configs.get_config(arch).reduced(
        num_layers=6 if arch == "zamba2-1.2b" else 2)
    shape = InputShape("t", 64, 4, "prefill")
    one = D.rank_step(cfg, shape, make_ctx(make_abstract_mesh(
        (1, 1), ("data", "model"))))
    runs = {seq: D.rank_step(cfg, shape, make_ctx(make_abstract_mesh(
        (2, 2), ("data", "model")), seq_shard=seq)) for seq in (False, True)}
    off, on = runs[False], runs[True]
    assert off["dot_flops"] < one["dot_flops"] / 2
    assert off["coll_all_reduce"] > 0 and off["coll_state_restore"] == 0
    assert on["dot_flops"] == off["dot_flops"]
    assert on["coll_reduce_scatter"] > 0


def _repro_arg_bytes(arch, shape_name, dtypes):
    """Σ numel / (sizes of the axes repro's specs shard a leaf over) ×
    the port's dtype size, over the parameters (and the caches)."""
    jcfg = j_configs.ARCHS[arch]
    shape = j_configs.INPUT_SHAPES[shape_name]
    jcfg, _ = j_configs.base.shape_variant(jcfg, shape)
    jmesh = j_abstract_mesh(*SINGLE)
    sizes = dict(zip(SINGLE[1], SINGLE[0]))

    def local(numel, spec):
        n = numel
        for e in spec:
            for a in ((e,) if isinstance(e, str) else (e or ())):
                n //= sizes[a]
        return n

    shapes = jax.eval_shape(lambda: JT.init_params(jcfg, jax.random.key(0)))
    specs = JR.param_specs(jmesh, shapes)
    flat, _ = jax.tree_util.tree_flatten_with_path(shapes)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    params = sum(local(math.prod(s.shape), sp)
                 * dtypes([getattr(k, "key", None) for k in path])
                 for (path, s), sp in zip(flat, spec_leaves))
    caches = 0
    if shape.kind == "decode":
        cs = jax.eval_shape(lambda: JT.init_caches(
            jcfg, shape.global_batch, shape.seq_len))
        cspecs = JR.cache_specs(jmesh, jcfg, cs)
        caches = sum(local(math.prod(s.shape), sp) * s.dtype.itemsize
                     for s, sp in zip(jax.tree.leaves(cs), jax.tree.leaves(
                         cspecs, is_leaf=lambda x: isinstance(x, P))))
    return params, caches


def test_argument_bytes_are_the_rules_arithmetic(qwen_decode):
    """The serving copy (``cast_params``): the ``KEEP_FP32`` leaves (the
    norms) fp32, every other weight bf16 (``repro``'s leaves are its fp32
    masters, cast at each use); the caches bf16, as ``repro`` makes
    them."""
    params, caches = _repro_arg_bytes(
        "qwen2.5-3b", "decode_32k",
        lambda keys: 4 if set(keys) & TT.KEEP_FP32 else 2)
    got = qwen_decode["memory"]
    assert round(got["param_gb"] * 1e9) == params
    assert round(got["cache_gb"] * 1e9) == caches


def _flops(cfg, b, s, layers):
    cfg = dataclasses.replace(cfg, num_layers=layers, layer_pattern=None)
    ctx = make_ctx(make_abstract_mesh((1, 1), ("data", "model")))
    r = D.rank_step(cfg, InputShape("t", s, b, "prefill"), ctx)
    return r


def test_flop_counter_is_the_products_plus_k9():
    cfg = t_configs.get_config("qwen2.5-3b").reduced(num_layers=2)
    b, s = 2, 256
    d, h, kv, hd, f, v = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                          cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size)
    per_layer = 2 * b * s * (d * h * hd + 2 * d * kv * hd + h * hd * d
                             + 3 * d * f)
    k9 = 4 * hd * b * h * s * (s + 1) // 2
    readout = 2 * b * d * v                  # the last position's logits
    for layers in (2, 4):
        r = _flops(cfg, b, s, layers)
        assert r["k9_launches"] == layers
        assert r["k9_flops"] == layers * k9
        assert r["dot_flops"] == layers * (per_layer + k9) + readout
    two, four = _flops(cfg, b, s, 2), _flops(cfg, b, s, 4)
    assert four["dot_flops"] - two["dot_flops"] == \
        two["dot_flops"] - readout


def test_flops_split_over_a_mesh():
    """At (2, 2) a rank computes its batch rows and its half of the heads
    and FFN columns: a quarter of the per-layer products."""
    cfg = t_configs.get_config("qwen2.5-3b").reduced(num_layers=2)
    b, s = 4, 128
    one = _flops(cfg, b, s, 2)
    ctx = make_ctx(make_abstract_mesh((2, 2), ("data", "model")))
    four = D.rank_step(cfg, InputShape("t", s, b, "prefill"), ctx)
    readout = 2 * b * cfg.d_model * cfg.vocab_size
    assert four["dot_flops"] - readout / 4 == \
        (one["dot_flops"] - readout) / 4
    assert four["collective_bytes"] > 0 and one["collective_bytes"] == 0


@pytest.mark.parametrize("arch,shape,match", [
    ("qwen2.5-3b", "train_4k", "item 10.5"),
    ("deepseek-moe-16b", "train_4k", "item 10.5"),
    ("gemma2-27b", "prefill_32k", "C1"),
])
def test_refusals_name_their_items(arch, shape, match):
    """Each pair under the ROADMAP item that decides it: the ``train_4k``
    pairs run since item 10.5 (training over a mesh), the windowed
    softcapped prefill since C1 (K9's window and softcap): one K9 launch
    a layer, whose operations are the kept pairs of the rank's 2 rows × 2
    heads (B 32 over data 16, 32 heads over model 16): the band of 4,096
    on the 23 local layers, causal on the 23 global ones, 3.122e13 in
    all against 5.058e13 all causal."""
    res = D.run_pair(arch, shape, "single")
    assert res["chips"] == 256
    if match == "C1":
        from repro_torch.kernels import flash_attention as fa
        assert res["ok"], res.get("error")
        assert res["k9_launches"] == 46
        s, hd, bh = 32_768, 128, 2 * 2
        causal = fa.attention_flops(bh, s, hd, s, True)
        band = fa.attention_flops(bh, s, hd, s, True, 4096)
        assert res["hlo"]["k9_flops"] == 23 * (band + causal)
        assert res["hlo"]["k9_flops"] < 46 * causal
        assert abs(res["hlo"]["k9_flops"] / 3.122e13 - 1) < 1e-3
        return
    assert res["ok"], res.get("error")
    mem, hlo = res["memory"], res["hlo"]
    # fp32 masters and two fp32 moments of the same blocks, and a count
    assert abs(mem["opt_gb"] - 2 * mem["param_gb"] - 4e-9) < 1e-12
    assert hlo["coll_reduce_scatter"] > 0 and hlo["coll_all_gather"] > 0
    assert res["k9_launches"] == 0 and hlo["k9_flops"] == 0
    assert res["roofline"]["compute_s"] > 0 and mem["fits_card"]


def test_refusals_of_levers():
    res = D.run_pair("qwen2.5-3b", "prefill_32k", "single", seq_shard=True)
    assert res["ok"], res.get("error")
    base = D.run_pair("qwen2.5-3b", "prefill_32k", "single")
    assert res["memory"]["temp_gb"] < base["memory"]["temp_gb"]
    res = D.run_pair("deepseek-moe-16b", "prefill_32k", "single",
                     profile="fsdp_only")
    assert not res["ok"] and "fsdp_only" in res["error"]


def test_train_pair_seq_shard_keeps_smaller_activations():
    """A train step at (2, 2) on a reduced config: the rank's argument
    bytes are its parameter blocks, their two AdamW moments and its rows
    of the inputs; the products are the forward's, each layer's recompute
    and the backward's (three to five times the loss's forward); with
    ``seq_shard`` the same products and a smaller peak (the remat carries
    hold S / M rows), the model-axis sums turned into reduce-scatters."""
    from repro_torch.launch.cost import count_step
    cfg = dataclasses.replace(
        t_configs.get_config("qwen2.5-3b").reduced(num_layers=2),
        remat=True)
    shape = InputShape("t", 256, 4, "train")
    runs = {}
    for seq in (False, True):
        ctx = make_ctx(make_abstract_mesh((2, 2), ("data", "model")),
                       seq_shard=seq)
        runs[seq] = D.rank_step(cfg, shape, ctx)
    off, on = runs[False], runs[True]
    assert off["opt_bytes"] == 2 * off["param_bytes"] + 4
    assert off["argument_bytes"] == off["param_bytes"] + off["opt_bytes"] \
        + off["input_bytes"]
    assert on["dot_flops"] == off["dot_flops"]
    assert on["temp_bytes"] < off["temp_bytes"]
    assert on["coll_all_reduce"] < off["coll_all_reduce"]
    assert on["coll_reduce_scatter"] > off["coll_reduce_scatter"] > 0
    assert off["k9_launches"] == 0
    ctx = make_ctx(make_abstract_mesh((2, 2), ("data", "model")))
    params = TT.init_params(cfg, device="meta", ctx=ctx)
    _, fwd = count_step(lambda: TT.loss_fn(cfg, params,
                                           D.input_specs(cfg, shape), ctx),
                        ctx.comm)
    assert 3 * fwd["dot_flops"] < off["dot_flops"] < 5 * fwd["dot_flops"]


def test_fsdp_only_profile_runs():
    res = D.run_pair("qwen2.5-3b", "prefill_32k", "single",
                     profile="fsdp_only")
    assert res["ok"], res.get("error")
    assert res["hlo"]["coll_all_reduce"] == 0     # no tensor parallelism
    # a decode batch over (data, model) beside caches over data alone:
    # the rank's rows of its cache block
    cfg = t_configs.get_config("qwen2.5-3b").reduced(num_layers=2)
    ctx = make_ctx(make_abstract_mesh((2, 2), ("data", "model")),
                   profile="fsdp_only", coords={"data": 1, "model": 1})
    r = D.rank_step(cfg, InputShape("t", 16, 4, "decode"), ctx)
    assert r["batch_rows"] == [3, 4]
    assert r["coll_all_reduce"] == 0 and r["coll_all_gather"] > 0


def test_cli_lines(tmp_path, capsys):
    out = tmp_path / "d.jsonl"
    D.main(["--arch", "gemma2-27b", "--shape", "prefill_32k", "--mesh",
            "both", "--out", str(out)])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2
    assert lines[0].startswith("[OK ] gemma2-27b × prefill_32k × single")
    assert lines[1].startswith("[OK ] gemma2-27b × prefill_32k × multi")
    recs = [__import__("json").loads(x) for x in
            out.read_text().splitlines()]
    assert [r["chips"] for r in recs] == [256, 512]
    assert all(r["ok"] and r["k9_launches"] == 46 for r in recs)
    # the multi mesh's data axes hold twice the ranks: half the rows
    assert recs[1]["hlo"]["k9_flops"] * 2 == recs[0]["hlo"]["k9_flops"]
    with pytest.raises(SystemExit):
        D.main(["--arch", "qwen2.5-3b"])


def test_k9_meta_path_counts_without_a_kernel(monkeypatch):
    """K9's wrapper on ``meta`` tensors: the output's shape and dtype, one
    launch and its causal operations counted, no kernel built."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    monkeypatch.setattr(build, "load", lambda *a, **k: pytest.fail(
        "the meta path built the kernel"))
    q = torch.empty((2, 300, 8, 64), dtype=torch.bfloat16, device="meta")
    k = torch.empty((2, 300, 2, 64), dtype=torch.bfloat16, device="meta")
    fa.reset_launches()
    out = ops.flash_mha(q, k, k, causal=True)
    assert out.is_meta and out.shape == q.shape and out.dtype == q.dtype
    assert fa.LAUNCHES["flash_attention"] == 1
    # S = 300 padded to 384: the pairs below kv_len = 300 that it keeps
    assert fa.FLOPS["flash_attention"] == \
        4.0 * 64 * 16 * (300 * 301 // 2 + 84 * 300)
    assert fa.attention_flops(1, 4, 8, 4, False) == 4.0 * 8 * 16
