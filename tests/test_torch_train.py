"""Port parity, the LM template's training path: ``loss_fn`` (the chunked
readout cross entropy, a ragged last chunk), its gradients, remat, the
train step with AdamW (also over microbatches), the training state carried
across by ``convert``, ``launch/train.py lm``, and K9's refusal to enter
an autograd graph.

Held against ``repro`` on the same numpy inputs: ``repro``'s reduced
configs (fp32, 2 layers, d = 256; zamba2 at 6 layers, so that its layer 5
holds the shared block), its parameters carried across by
``lm_params_from_repro``. The bars: the loss, ``ce`` and ``lb_loss`` at
2e-4 relative; each gradient leaf at relative L2 1e-3; the parameters
after two AdamW steps within 5e-3 (``repro``'s own microbatch bar,
``tests/test_optim_checkpoint.py``), the metrics with ``grad_norm`` at
2e-4.
"""
import argparse
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro import optim as j_optim
from repro.checkpoint import restore_checkpoint as j_restore
from repro.models import transformer as JT
from repro.training import TrainState as JTrainState
from repro.training import make_train_step as j_make_train_step
from repro_torch import configs as t_configs
from repro_torch import optim as t_optim
from repro_torch.convert import (lm_params_from_repro, lm_params_to_repro,
                                 lm_train_state_from_repro,
                                 lm_train_state_to_repro)
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.launch import train as t_train
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.training import (TrainState, loss_and_grads,
                                  make_prefill_step, make_train_step)

ARCHS = ["qwen2.5-3b", "yi-9b", "gemma2-27b", "command-r-35b",
         "internvl2-1b", "musicgen-medium", "deepseek-moe-16b",
         "qwen3-moe-30b-a3b", "zamba2-1.2b", "xlstm-1.3b"]
LAYERS = {"zamba2-1.2b": 6}
B, S = 2, 32
LOSS_TOL, GRAD_REL_L2, PARAM_TOL = 2e-4, 1e-3, 5e-3
# the parameters' change against repro's, relative L2 over the whole tree:
# at LR 1e-3 AdamW moves each element by at most ~LR a step, so PARAM_TOL
# alone holds the parameters to little more than finiteness. Not per leaf:
# where a leaf's gradient is at its rounding floor (a key bias on the
# low-frequency rope dimensions at S = 32, ~1e-9), AdamW's step there is
# g / (|g| + eps) of two different roundings
DELTA_REL_L2 = 1e-3
LR = 1e-3
CPU = torch.device("cpu")


def _reduced(arch, seq=S):
    kw = dict(seq_len_hint=seq, num_layers=LAYERS.get(arch, 2))
    return (j_configs.ARCHS[arch].reduced(**kw),
            t_configs.ARCHS[arch].reduced(**kw))


def _batch(cfg, rng, b=B, s=S):
    """Tokens, labels (a VLM's covering its patch prefix, MusicGen's a
    codebook each) and vision embeddings, as numpy."""
    audio = cfg.modality == "audio"
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  (b, s, cfg.num_codebooks) if audio
                                  else (b, s))}
    lab = s + (cfg.num_patches if cfg.modality == "vision" else 0)
    out["labels"] = rng.integers(0, cfg.vocab_size,
                                 (b, lab, cfg.num_codebooks) if audio
                                 else (b, lab))
    if cfg.modality == "vision":
        out["vision_embeds"] = rng.normal(
            0, 1, (b, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return out


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _leaves_np(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _check_params(got, want, before, what=""):
    """The port's parameters (``repro``'s layout) against ``repro``'s
    after the same steps from ``before``: within PARAM_TOL, and their
    change within DELTA_REL_L2 of ``repro``'s change."""
    got, want, before = (_leaves_np(t) for t in (got, want, before))
    assert len(got) == len(want) == len(before)
    assert max(float(np.abs(g - w).max()) for g, w in zip(got, want)) \
        <= PARAM_TOL
    err = _rel(np.concatenate([(g - p).ravel() for g, p in zip(got, before)]),
               np.concatenate([(w - p).ravel() for w, p in zip(want, before)]))
    print(f"{what}: parameter change relative L2 {err:.3g}")
    assert err <= DELTA_REL_L2


@functools.lru_cache(maxsize=None)
def _case(arch):
    """``repro``'s loss, metrics and gradients on one seeded batch, and its
    parameters as numpy (computed once a file)."""
    jcfg, tcfg = _reduced(arch)
    params = JT.init_params(jcfg, jax.random.key(0))
    batch = _batch(jcfg, np.random.default_rng(0))

    def loss(p, b):
        return JT.loss_fn(jcfg, p, b)

    (_, metrics), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params, _jax(batch))
    return dict(jcfg=jcfg, tcfg=tcfg, params=jax.tree.map(np.asarray, params),
                batch=batch, metrics=jax.tree.map(np.asarray, metrics),
                grads=jax.tree.map(np.asarray, grads))


def _port_params(case):
    return lm_params_from_repro(case["params"], case["tcfg"], device=CPU)


def _check_metrics(got, want, keys=("loss", "ce", "lb_loss", "counts",
                                    "dropped")):
    for key in keys:
        np.testing.assert_allclose(np.asarray(got[key]), want[key],
                                   rtol=LOSS_TOL, atol=1e-6, err_msg=key)


# ---------------------------------------------------------------------------
# loss_fn and its gradients, all ten archs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_repro(arch):
    case = _case(arch)
    total, metrics = TT.loss_fn(case["tcfg"], _port_params(case),
                                _torch(case["batch"]))
    assert torch.equal(total, metrics["loss"])
    _check_metrics(metrics, case["metrics"])


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_repro(arch):
    """Every gradient leaf within relative L2 1e-3 of ``jax.grad``'s (the
    worst is printed; ~2e-6 when this was written)."""
    case = _case(arch)
    metrics, grads = loss_and_grads(case["tcfg"], _port_params(case),
                                    _torch(case["batch"]))
    _check_metrics(metrics, case["metrics"])
    got = _leaves_np(lm_params_to_repro(grads, case["tcfg"]))
    want = _leaves_np(case["grads"])
    assert len(got) == len(want)
    errs = [_rel(g, w) for g, w in zip(got, want)]
    print(f"{arch}: worst gradient leaf relative L2 {max(errs):.3g}")
    assert max(errs) <= GRAD_REL_L2


@pytest.mark.parametrize("arch", ARCHS)
def test_two_adamw_steps_match_repro(arch):
    case = _case(arch)
    jcfg, tcfg = case["jcfg"], case["tcfg"]
    rng = np.random.default_rng(1)
    batches = [_batch(jcfg, rng) for _ in range(2)]
    jopt, topt = j_optim.adamw(LR), t_optim.adamw(LR)
    jp = jax.tree.map(jnp.asarray, case["params"])
    jstate = JTrainState(jp, jopt.init(jp), jnp.zeros((), jnp.int32))
    tp = _port_params(case)
    tstate = TrainState(tp, topt.init(tp), 0)
    jstep = jax.jit(j_make_train_step(jcfg, jopt))
    tstep = make_train_step(tcfg, topt)
    for batch in batches:
        jstate, jm = jstep(jstate, _jax(batch))
        tstate, tm = tstep(tstate, _torch(batch))
        _check_metrics(tm, jax.tree.map(np.asarray, jm),
                       ("loss", "ce", "lb_loss", "grad_norm"))
    assert tstate.step == 2 and int(tstate.opt_state["count"]) == 2
    _check_params(lm_params_to_repro(tstate.params, tcfg), jstate.params,
                  case["params"], arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_ragged_loss_chunk_matches_repro(arch):
    """S is no multiple of the loss chunk: the last chunk is padded, its
    labels −1, and the loss is ``repro``'s with the same chunk."""
    case = _case(arch)
    chunk = 10
    assert case["batch"]["labels"].shape[1] % chunk
    want, wm = jax.jit(lambda p, b: JT.loss_fn(case["jcfg"], p, b,
                                               loss_chunk=chunk))(
        jax.tree.map(jnp.asarray, case["params"]), _jax(case["batch"]))
    got, gm = TT.loss_fn(case["tcfg"], _port_params(case),
                         _torch(case["batch"]), loss_chunk=chunk)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_TOL)
    np.testing.assert_allclose(float(gm["ce"]), float(wm["ce"]),
                               rtol=LOSS_TOL)
    # the padded slots count for nothing: the full-width chunk's loss
    full, _ = TT.loss_fn(case["tcfg"], _port_params(case),
                         _torch(case["batch"]))
    np.testing.assert_allclose(float(got), float(full), rtol=1e-5)


# ---------------------------------------------------------------------------
# once: remat, microbatches, the state across, the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-moe-16b",
                                  "zamba2-1.2b", "xlstm-1.3b"])
def test_remat_on_equals_off(arch):
    """Checkpointed layers recompute the same bits: the loss and every
    gradient bit-equal with ``remat`` on and off (the MoE dispatch, the
    shared block and the sLSTM's custom backward among them)."""
    case = _case(arch)
    tcfg = case["tcfg"]
    assert not tcfg.remat
    runs = [loss_and_grads(dataclasses.replace(tcfg, remat=remat),
                           _port_params(case), _torch(case["batch"]))
            for remat in (False, True)]
    (m0, g0), (m1, g1) = runs
    assert torch.equal(m0["loss"], m1["loss"])
    for a, b in zip(tree_leaves(g0), tree_leaves(g1), strict=True):
        assert torch.equal(a, b)


def test_microbatches_match_repro():
    """``microbatches=2`` against ``repro``'s ``microbatches=2``: the mean
    of the microbatches' means, one AdamW step; and the accumulated
    gradients, leaf by leaf, against the mean of ``jax.grad`` on each
    half of the batch."""
    jcfg, tcfg = _reduced("yi-9b")
    params = JT.init_params(jcfg, jax.random.key(0))
    batch = _batch(jcfg, np.random.default_rng(2), b=4)

    def jgrad(half):
        part = {k: v[2 * half:2 * half + 2] for k, v in batch.items()}
        return jax.grad(lambda p: JT.loss_fn(jcfg, p, _jax(part))[0])(params)

    want = jax.tree.map(lambda a, b: (np.asarray(a) + np.asarray(b)) / 2,
                        jgrad(0), jgrad(1))
    _, grads = loss_and_grads(
        tcfg, lm_params_from_repro(jax.tree.map(np.asarray, params), tcfg,
                                   device=CPU), _torch(batch), microbatches=2)
    errs = [_rel(g, w) for g, w in zip(
        _leaves_np(lm_params_to_repro(grads, tcfg)), _leaves_np(want),
        strict=True)]
    assert max(errs) <= GRAD_REL_L2
    jopt, topt = j_optim.adamw(LR), t_optim.adamw(LR)
    jstate = JTrainState(params, jopt.init(params), jnp.zeros((), jnp.int32))
    jstate, jm = jax.jit(j_make_train_step(jcfg, jopt, microbatches=2))(
        jstate, _jax(batch))
    tp = lm_params_from_repro(jax.tree.map(np.asarray, params), tcfg,
                              device=CPU)
    tstate, tm = make_train_step(tcfg, topt, microbatches=2)(
        TrainState(tp, topt.init(tp), 0), _torch(batch))
    _check_metrics(tm, jax.tree.map(np.asarray, jm),
                   ("loss", "ce", "grad_norm"))
    _check_params(lm_params_to_repro(tstate.params, tcfg), jstate.params,
                  params, "microbatches=2")
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(tcfg, topt, microbatches=3)(
            TrainState(tp, topt.init(tp), 0), _torch(batch))


@pytest.mark.parametrize("name", ["adamw", "sgd", "iag"])
def test_train_state_round_trip_and_continue(name):
    """``repro``'s state after one step (AdamW's m/v, SGD's mu, IAG's
    memo with its shard axis, agg and seen) crosses to the port and back
    bit for bit, and one more step from it on each side agrees."""
    jcfg, tcfg = _reduced("deepseek-moe-16b")
    params = JT.init_params(jcfg, jax.random.key(3))
    rng = np.random.default_rng(3)
    b1, b2 = _batch(jcfg, rng), _batch(jcfg, rng)
    jopt = {"adamw": lambda: j_optim.adamw(LR),
            "sgd": lambda: j_optim.sgd(1e-2),
            "iag": lambda: j_optim.iag(1e-2, 3)}[name]()
    topt = {"adamw": lambda: t_optim.adamw(LR),
            "sgd": lambda: t_optim.sgd(1e-2),
            "iag": lambda: t_optim.iag(1e-2, 3)}[name]()

    @jax.jit
    def jstep(state, batch, shard):
        (_, m), g = jax.value_and_grad(
            lambda p: JT.loss_fn(jcfg, p, batch), has_aux=True)(state.params)
        kw = {"shard": shard} if name == "iag" else {}
        upd, os_ = jopt.update(g, state.opt_state, state.params, **kw)
        return JTrainState(j_optim.apply_updates(state.params, upd), os_,
                           state.step + 1), m

    jstate = JTrainState(params, jopt.init(params), jnp.zeros((), jnp.int32))
    jstate, _ = jstep(jstate, _jax(b1), jnp.asarray(1))
    tstate = lm_train_state_from_repro(jstate, tcfg, device=CPU)
    back = lm_train_state_to_repro(tstate, tcfg)
    want = jax.tree.map(np.asarray, jstate)
    back = JTrainState(back.params, back.opt_state, back.step)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    if name == "iag":
        assert tree_leaves(tstate.opt_state["memo"])[0].shape[0] == 3
    # one more step on each side from the one state
    before = want.params
    jstate, _ = jstep(jstate, _jax(b2), jnp.asarray(2))
    metrics, grads = loss_and_grads(tcfg, tstate.params, _torch(b2))
    kw = {"shard": 2} if name == "iag" else {}
    upd, _ = topt.update(grads, tstate.opt_state, tstate.params, **kw)
    t_optim.apply_updates(tstate.params, upd)
    _check_params(lm_params_to_repro(tstate.params, tcfg), jstate.params,
                  before, name)


def _lm_args(**kw):
    args = dict(arch="musicgen-medium", reduced=True, steps=2, batch=2,
                seq=16, lr=3e-4, optimizer="adamw", iag_shards=2,
                log_every=1, seed=0, ckpt=None)
    args.update(kw)
    return args


def _cli(args):
    argv = ["lm", "--arch", args["arch"], "--steps", str(args["steps"]),
            "--batch", str(args["batch"]), "--seq", str(args["seq"]),
            "--lr", str(args["lr"]), "--optimizer", args["optimizer"],
            "--iag-shards", str(args["iag_shards"]), "--log-every",
            str(args["log_every"]), "--seed", str(args["seed"]),
            "--device", "cpu"]
    if args["reduced"]:
        argv.append("--reduced")
    if args["ckpt"]:
        argv += ["--ckpt", args["ckpt"]]
    return argv


def _check_lines(port, ref, steps):
    assert port[0] == ref[0]                       # arch=... params=...M
    assert len(port) == len(ref)
    for line in port[1:1 + steps] + ref[1:1 + steps]:
        head, loss, ce, rate = line.split(" ")
        assert head.startswith("step=") and loss.startswith("loss=")
        assert ce.startswith("ce=") and rate.startswith("steps_per_s=")
        assert len(loss.split(".")[1]) == 4 and len(rate.split(".")[1]) == 2
    assert [x.split(" ")[0] for x in port[1:]] == \
        [x.split(" ")[0] for x in ref[1:]]


class _AsarrayRecorder:
    """``jnp`` for ``repro``'s launcher, recording each array it is handed
    of two or more dimensions: the batches, in the order drawn."""

    def __init__(self):
        self.arrays = []

    def __getattr__(self, name):
        return getattr(jnp, name)

    def asarray(self, x, *args, **kw):
        if np.ndim(x) >= 2:
            self.arrays.append(np.asarray(x))
        return jnp.asarray(x, *args, **kw)


@pytest.mark.parametrize("arch,optimizer", [("musicgen-medium", "adamw"),
                                            ("internvl2-1b", "adamw"),
                                            ("xlstm-1.3b", "iag")])
def test_launcher_lm_prints_repro_lines_on_repro_batches(arch, optimizer,
                                                          capsys,
                                                          monkeypatch):
    """``launch/train.py lm`` on the CPU: ``repro``'s lines, and the same
    batches bit for bit (tokens, labels, the VLM's vision embeddings)."""
    from repro.launch import train as j_train
    args = _lm_args(arch=arch, optimizer=optimizer, steps=3)
    recorder = _AsarrayRecorder()
    monkeypatch.setattr(j_train, "jnp", recorder)
    j_train.main_lm(argparse.Namespace(**args))
    ref = capsys.readouterr().out.splitlines()
    drawn = []
    real_batch = t_train.lm_batch
    monkeypatch.setattr(t_train, "lm_batch", lambda *a: (
        lambda b: drawn.extend(v.numpy() for v in b.values()) or b)(
            real_batch(*a)))
    t_train.main(_cli(args))
    port = capsys.readouterr().out.splitlines()
    _check_lines(port, ref, args["steps"])
    per_step = 3 if arch == "internvl2-1b" else 2
    assert len(drawn) == len(recorder.arrays) == per_step * args["steps"]
    for a, b in zip(recorder.arrays, drawn):
        np.testing.assert_array_equal(a, b)


def test_launcher_lm_ckpt_restores_in_repro(tmp_path, capsys, monkeypatch):
    """``--ckpt`` writes the trained parameters in ``repro``'s layout:
    ``repro``'s ``restore_checkpoint`` gives back the same arrays."""
    import repro_torch.convert as convert
    path = str(tmp_path / "lm.npz")
    saved = []
    real = convert.lm_params_to_repro
    monkeypatch.setattr(convert, "lm_params_to_repro",
                        lambda *a: saved.append(real(*a)) or saved[-1])
    args = _lm_args(arch="qwen2.5-3b", ckpt=path)
    t_train.main(_cli(args))
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == f"saved {path}"
    jcfg, _ = _reduced("qwen2.5-3b", seq=args["seq"])
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        JT.init_params(jcfg, jax.random.key(0)))
    restored = j_restore(path, like)
    assert jax.tree.structure(restored) == jax.tree.structure(like)
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(saved[0])):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert int(np.load(path)["__step__"]) == args["steps"]


# ---------------------------------------------------------------------------
# K9 refuses autograd; training never routes through it
# ---------------------------------------------------------------------------

def _qkv(rng, grad):
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (2, 64, 4, 16))
                                .astype(np.float32)).requires_grad_(grad)
               for _ in range(3))
    return q, k, v


def test_k9_refuses_autograd_on_the_cpu_too(rng):
    q, k, v = _qkv(rng, True)
    flat = [t.detach().permute(0, 2, 1, 3).reshape(8, 64, 16)
            .requires_grad_(True) for t in (q, k, v)]
    with pytest.raises(RuntimeError, match="no backward"):
        FA.flash_attention(*flat, causal=True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_mha(q, k, v, causal=True)
    # the twin stays differentiable: the tests' reference
    out = FA.flash_attention_plain(*flat, causal=True)
    out.sum().backward()
    assert all(t.grad is not None for t in flat)
    # no autograd recording: the wrapper runs, with the twin's bits
    with torch.no_grad():
        got = ops.flash_mha(q, k, v, causal=True)
    with torch.inference_mode():
        again = ops.flash_mha(q, k, v, causal=True)
    assert torch.equal(got, again)
    want = FA.flash_attention_plain(*(t.detach() for t in flat), causal=True)
    assert torch.equal(got, want.reshape(2, 4, 64, 16).permute(0, 2, 1, 3))


def test_prefill_runs_k9_route_on_trainable_params_and_training_never(rng):
    """A prefill under ``inference_mode`` takes the K9 route on parameters
    that require grad, with the bits it has without them; the training
    loss takes the plain route on any device, so it never calls K9."""
    case = _case("qwen2.5-3b")
    tcfg = case["tcfg"]
    params = _port_params(case)
    batch = {"tokens": _torch(case["batch"])["tokens"]}
    want = make_prefill_step(tcfg, attention="flash")(params, batch)
    trainable = tree_map(lambda p: p.detach().requires_grad_(True), params)
    got = make_prefill_step(tcfg, attention="flash")(trainable, batch)
    assert torch.equal(got, want)
    calls = []
    real = ops.flash_attention
    try:
        ops.flash_attention = lambda *a, **kw: calls.append(1) or real(*a,
                                                                       **kw)
        make_prefill_step(tcfg, attention="flash")(trainable, batch)
        assert calls
        calls.clear()
        loss_and_grads(tcfg, params, _torch(case["batch"]))
        assert not calls
        # and a forward that asks K9 for a recorded graph raises
        with pytest.raises(RuntimeError, match="no backward"):
            TT.forward(tcfg, trainable, batch, attention="flash")
    finally:
        ops.flash_attention = real
    assert TA.attention_route(CPU, "plain") == "plain"
