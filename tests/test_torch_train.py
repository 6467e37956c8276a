"""The port's training path against the JAX reference at small sizes: the
gated GEMM's autograd Function (bwd dense | spamm), the chunked loss, the
loss and its gradients for every model family, one train step with AdamW,
the learning-rate schedule, int8 gradient compression, the data stream, the
remat invariants, the weight cache under training, the train loop and its
CLI.

The same numpy inputs (and the reference's weights, carried across by
`params_from_jax`) go through both packages; the reference runs its `jnp`
backend, the port the plain versions of its kernels (CPU tensors).
Structural artifacts (the backward plans' work-lists and step tables, the
token stream) must be exact: the gated-GEMM cases use matrices whose tile
norms are exact in f32 in any summation order, so both packages gate on
the same bits. Float results are held within f32 tolerances stated below.
"""
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ParallelConfig as RParallel
from repro.configs import SpammConfig as RSpamm
from repro.configs import TrainConfig as RTrain
from repro.configs import get_config as rget_config
from repro.core import module as rmodule
from repro.data import pipeline as rpipe
from repro.distributed import compression as rcomp
from repro.launch.mesh import make_ctx, make_host_mesh
from repro.models import layers as rlayers
from repro.models import model as RM
from repro.optim import adamw as radamw
from repro_torch import tree as T
from repro_torch.checkpoint import checkpoint as ck
from repro_torch.configs import (ParallelConfig, SpammConfig, TrainConfig,
                                 get_config)
from repro_torch.core import module as tmodule
from repro_torch.data import pipeline as tpipe
from repro_torch.distributed import compression as tcomp
from repro_torch.launch import train as tlaunch
from repro_torch.models import layers as tlayers
from repro_torch.models import model as M
from repro_torch.optim import adamw as tadamw
from repro_torch.train import loop as tloop

TILE = 16
# f32 products over K ≤ 128 and f32 losses: reassociated sums, relative to
# the largest magnitude
MM_RTOL = 1e-5
# gradients of a two- or three-layer f32 model, each leaf relative to its
# own largest magnitude (the two packages' attention, scans and
# transcendentals round differently)
GRAD_RTOL = 1e-4
# parameters and moments after one AdamW step: the update divides by
# √n̂ + 1e-8, which magnifies a gradient's rounding where n̂ is small
STEP_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    """Reduced models are a few hundred small ops a step: with several test
    workers on one machine, one intra-op thread each runs them fastest."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / (scale if scale > 0 else 1.0))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _exact(rows, cols, seed, zero_frac=0.2):
    """(rows, cols) f32 matrix whose tile norms are exact in any summation
    order: each 16×16 tile is ±2^e (or 0) — sums of equal squares of a
    power of two, whatever the order — so both packages gate on the same
    normmaps; ragged edge tiles stay exact too (the square root of an exact
    sum rounds once, the same way)."""
    rng = np.random.default_rng(seed)
    gr, gc = -(-rows // TILE), -(-cols // TILE)
    scale = 2.0 ** rng.integers(-3, 3, size=(gr, gc))
    scale[rng.random((gr, gc)) < zero_frac] = 0.0
    signs = rng.choice([-1.0, 1.0], size=(gr, TILE, gc, TILE))
    x = (signs * scale[:, None, :, None]).reshape(gr * TILE, gc * TILE)
    return x[:rows, :cols].astype(np.float32)


def _gap_tau(*prods) -> float:
    """A τ in the widest gap between the 30th and 70th percentiles of the
    union of the given norm-product sets."""
    p = np.unique(np.concatenate([np.ravel(x) for x in prods]))
    lo, hi = int(0.3 * p.size), int(0.7 * p.size)
    g = int(np.argmax(p[lo + 1:hi] - p[lo:hi - 1]))
    return float((p[lo + g] + p[lo + g + 1]) / 2)


def _norms(x, tile=TILE, tile_n=None):
    m, n = x.shape
    xp = np.pad(x, ((0, (-m) % tile), (0, (-n) % (tile_n or tile))))
    gm, gn = xp.shape[0] // tile, xp.shape[1] // tile
    return np.sqrt((xp.reshape(gm, tile, gn, tile).astype(np.float64) ** 2)
                   .sum((1, 3))).astype(np.float32)


# ---------------------------------------------------------------------------
# the gated GEMM's autograd Function
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["zero", "gap"])
def test_spamm_linear_dense_grads_match_jax_grad(kind):
    """Twin of tests/test_system.py::test_spamm_linear_grad_flow, at τ = 0
    (the reference's exact-gradient contract) and at a gap τ (a gated
    forward, dense gradients of it)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 32, 64)).astype(np.float32)
    w = (0.05 * rng.standard_normal((64, 96))).astype(np.float32)
    tau = 0.0
    if kind == "gap":
        na, nb = _norms(x.reshape(-1, 64), 32), _norms(w, 32)
        tau = _gap_tau(na[:, None, :] * nb.T[None])

    def f(x_, w_):
        y = rmodule.spamm_linear(x_, w_, jnp.float32(tau), 32, "jnp")
        return jnp.sum(y ** 2)

    want = jax.grad(f, (0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    y = tmodule.spamm_linear(tx, tw, tau, 32, "torch")
    (y ** 2).sum().backward()
    for got, ref in zip((tx.grad, tw.grad), want):
        assert _rel_err(_np(got), ref) <= MM_RTOL
    if kind == "zero":  # τ = 0: the exact dense gradients
        dx = torch.tensor(x, requires_grad=True)
        dw = torch.tensor(w, requires_grad=True)
        ((dx @ dw) ** 2).sum().backward()
        assert _rel_err(_np(tx.grad), _np(dx.grad)) <= MM_RTOL
        assert _rel_err(_np(tw.grad), _np(dw.grad)) <= MM_RTOL


def _recording(monkeypatch, mod):
    """Record every plan `mod._plan.plan` makes."""
    made = []
    orig = mod._plan.plan

    def plan(*a, **kw):
        p = orig(*a, **kw)
        made.append(p)
        return p

    monkeypatch.setattr(mod._plan, "plan", plan)
    return made


def _assert_same_plan(tp, rp):
    for name in rp.work._fields:
        np.testing.assert_array_equal(_np(getattr(tp.work, name)),
                                      np.asarray(getattr(rp.work, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(_np(tp.nvalid), np.asarray(rp.nvalid))
    assert int(tp.valid_tiles) == int(rp.valid_tiles)


@pytest.mark.parametrize("m,k,n,block_n", [(40, 48, 64, 1), (48, 64, 72, 2)])
def test_spamm_bwd_matches_reference(monkeypatch, m, k, n, block_n):
    """bwd="spamm": the forward, then dx and dw, against the reference's
    custom_vjp rules (its work-list kernel in interpret mode, whose plans
    carry the step tables). The port's forward normmaps equal
    the reference's (exact tiles), and the dx and dw plans its backward
    builds equal the reference's work-list for work-list. (48, 64, 72) at
    block_n 2 pads N to 96: g and w pad like the forward's weight."""
    x = _exact(m, k, 1)
    w = _exact(k, n, 2)
    g = _exact(m, n, 3)
    na = _norms(x)
    nb = _norms(w, TILE, TILE * block_n)
    ng = _norms(g, TILE, TILE * block_n)
    tau = _gap_tau(na[:, None, :] * nb.T[None], ng[:, None, :] * nb[None],
                   na.T[:, None, :] * ng.T[None])

    rmade = _recording(monkeypatch, rmodule)
    (ry, rfrac), res = rmodule._spamm_linear_fwd(
        jnp.asarray(x), jnp.asarray(w), jnp.float32(tau), TILE, "interpret",
        "spamm", block_n, None, 0, "float32")
    rdx, rdw, _ = rmodule._spamm_linear_bwd(TILE, "interpret", "spamm",
                                            block_n, None, 0, "float32", res,
                                            (jnp.asarray(g), None))
    tmade = _recording(monkeypatch, tmodule)
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    y, frac = tmodule._SpammLinear.apply(tx, tw, tau, TILE, "torch", "spamm",
                                         block_n, None, 0, "float32")
    y.backward(torch.tensor(g))

    assert len(tmade) == len(rmade) == 3
    np.testing.assert_array_equal(_np(tmade[0].norm_a), np.asarray(res[3]))
    np.testing.assert_array_equal(_np(tmade[0].norm_b), np.asarray(res[4]))
    for tp, rp in zip(tmade, rmade):
        _assert_same_plan(tp, rp)
    assert 0.0 < float(tmade[1].valid_fraction) < 1.0
    assert 0.0 < float(tmade[2].valid_fraction) < 1.0
    assert float(frac) == float(rfrac)
    assert _rel_err(_np(y), ry) <= MM_RTOL
    assert _rel_err(_np(tx.grad), rdx) <= MM_RTOL
    assert _rel_err(_np(tw.grad), rdw) <= MM_RTOL


def test_spamm_bwd_dx_only_skips_the_dw_product(monkeypatch):
    """A weight that needs no gradient: the backward plans dx only."""
    x, w, g = _exact(32, 48, 4), _exact(48, 32, 5), _exact(32, 32, 6)
    made = _recording(monkeypatch, tmodule)
    tx = torch.tensor(x, requires_grad=True)
    y = tmodule.spamm_linear(tx, torch.tensor(w), 0.0, TILE, "torch",
                             "spamm")
    y.backward(torch.tensor(g))
    assert len(made) == 2  # forward, dx
    assert _rel_err(_np(tx.grad), g @ w.T) <= MM_RTOL


def test_spamm_linear_odd_n_block_n_bwd_spamm():
    """Twin of tests/test_worklist.py::test_spamm_linear_odd_n_block_n_
    bwd_spamm: N = 160 at tile 32 and block_n 2 pads to 192; g and w pad
    like the forward's normmaps. Against the reference's gradients."""
    x = rpipe.synthesized_decay(160, seed=24)[:64, :96]
    w = rpipe.synthesized_decay(160, seed=25)[:96, :160]
    tau = 0.02

    def loss(x_, w_):
        y = rmodule.spamm_linear(x_, w_, jnp.float32(tau), 32, "jnp",
                                 "spamm", 2, None, 0)
        return jnp.sum(y * y)

    rdx, rdw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    y = tmodule.spamm_linear(tx, tw, tau, 32, "torch", "spamm", 2)
    (y * y).sum().backward()
    assert tx.grad.shape == tx.shape and tw.grad.shape == tw.shape
    assert torch.isfinite(tx.grad).all() and torch.isfinite(tw.grad).all()
    assert _rel_err(_np(tx.grad), rdx) <= MM_RTOL
    assert _rel_err(_np(tw.grad), rdw) <= MM_RTOL


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

def test_chunked_ce_loss_matches_reference():
    """Three chunks of 8 and a remainder of 5; masked labels."""
    rng = np.random.default_rng(7)
    h = rng.standard_normal((2, 29, 16)).astype(np.float32)
    u = (0.3 * rng.standard_normal((16, 50))).astype(np.float32)
    labels = rng.integers(0, 50, size=(2, 29)).astype(np.int32)
    labels[rng.random((2, 29)) < 0.2] = -1
    rl, (rdh, rdu) = jax.value_and_grad(
        lambda a, b: rlayers.chunked_ce_loss(a, b, jnp.asarray(labels), 8),
        (0, 1))(jnp.asarray(h), jnp.asarray(u))
    th = torch.tensor(h, requires_grad=True)
    tu = torch.tensor(u, requires_grad=True)
    tl = tlayers.chunked_ce_loss(th, tu, torch.tensor(labels), 8)
    tl.backward()
    assert abs(float(tl.detach()) - float(rl)) <= MM_RTOL * abs(float(rl))
    assert _rel_err(_np(th.grad), rdh) <= MM_RTOL
    assert _rel_err(_np(tu.grad), rdu) <= MM_RTOL


# (arch, batch kind, SpAMM bwd) — the dense, MoE, SSM, hybrid and frontend
# families, the dense one gated (at τ = 0) in each backward mode
FAMILIES = [("starcoder2-7b", "tokens", "dense"),
            ("starcoder2-7b", "tokens", "spamm"),
            ("qwen2-moe-a2.7b", "tokens", None),
            ("mamba2-1.3b", "tokens", None),
            ("recurrentgemma-9b", "tokens", None),
            ("musicgen-large", "embeds", None)]
SEQ = 32
RPCFG = RParallel(compute_dtype="float32", param_dtype="float32",
                  remat="none", attn_q_chunk=16, attn_kv_chunk=16,
                  loss_chunk=24, decode_seq_shard=False)
PCFG = ParallelConfig(compute_dtype="float32", attn_q_chunk=16,
                      loss_chunk=24, remat="none")


def _models(arch):
    cfg, rcfg = get_config(arch).reduced(), rget_config(arch).reduced()
    rparams = RM.init_params(rcfg, RPCFG, jax.random.key(0))
    np_tree = jax.tree.map(np.asarray, rparams)
    return cfg, rcfg, rparams, M.params_from_jax(np_tree, cfg, device="cpu")


def _batch(cfg, kind, seed=3, b=2, s=SEQ):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab, size=(b, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[:, :3] = -1
    batch = {"labels": labels}
    if kind == "embeds":
        batch["embeds"] = (0.5 * rng.standard_normal(
            (b, s, cfg.d_model))).astype(np.float32)
    else:
        batch["tokens"] = toks[:, :-1]
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.tensor(v) for k, v in batch.items()})


def _spamm(mode, tau):
    if mode is None:
        return None, None
    return (RSpamm(enable=True, tau=tau, tile=TILE, backend="jnp", bwd=mode),
            SpammConfig(enable=True, tau=tau, tile=TILE, backend="torch",
                        bwd=mode))


def _ref_loss_and_grads(rcfg, rparams, rbatch, rsc):
    """((loss, metrics), grads) of the reference's loss_fn, jitted as its
    train loop runs it."""
    ctx = make_ctx(make_host_mesh())
    return jax.jit(jax.value_and_grad(
        lambda p: RM.loss_fn(rcfg, RPCFG, ctx, p, rbatch, spamm_cfg=rsc),
        has_aux=True))(rparams)


def _grads_as_port(rgrads, cfg) -> dict:
    """The reference's gradient tree in the port's layout."""
    return M.params_from_jax(jax.tree.map(np.asarray, rgrads), cfg,
                             device="cpu")


@pytest.mark.parametrize("arch,kind,mode", FAMILIES,
                         ids=[f"{a}-{m or 'off'}" for a, _, m in FAMILIES])
def test_loss_fn_and_grads_match_reference(arch, kind, mode):
    cfg, rcfg, rparams, params = _models(arch)
    rbatch, batch = _batch(cfg, kind)
    # τ = 0 gates nothing out (every gradient exact in both packages); the
    # gated forward's fraction is the one the stats report
    rsc, sc = _spamm(mode, 0.0)
    (rl, rmet), rgrads = _ref_loss_and_grads(rcfg, rparams, rbatch, rsc)
    for p in T.leaves(params):
        p.requires_grad_(True)
    loss, met = M.loss_fn(cfg, PCFG, params, batch, spamm_cfg=sc)
    loss.backward()
    assert abs(float(loss.detach()) - float(rl)) <= MM_RTOL * abs(float(rl))
    assert abs(float(met["aux"].detach()) - float(rmet["aux"])) <= MM_RTOL * max(
        abs(float(rmet["aux"])), 1.0)
    if cfg.moe is not None:
        assert float(met["aux"].detach()) > 0.0
    want = dict(T.flatten_with_paths(_grads_as_port(rgrads, cfg)))
    got = dict(T.flatten_with_paths(params))
    assert got.keys() == want.keys()
    for path, p in got.items():
        # a frontend arch's embedding takes no gradient (the reference's is
        # zeros)
        grad = p.grad if p.grad is not None else torch.zeros_like(p)
        err = _rel_err(_np(grad), want[path])
        assert err <= GRAD_RTOL, (path, err)
    if mode is not None:
        for name in ("spamm_valid_fraction", "spamm_gated_gemms",
                     "spamm_layer_valid_fraction", "spamm_layer_gated_gemms"):
            np.testing.assert_array_equal(_np(met[name]),
                                          np.asarray(rmet[name]), name)
        assert float(met["spamm_gated_gemms"]) == 6 * cfg.num_layers


def test_gap_tau_loss_and_stats_match_reference():
    """A gated forward at a τ between the norm products (bwd dense): the
    loss, the per-layer stats and the gradients against the reference."""
    cfg, rcfg, rparams, params = _models("starcoder2-7b")
    rbatch, batch = _batch(cfg, "tokens", seed=5)
    tau = 30.0
    rsc, sc = _spamm("dense", tau)
    (rl, rmet), rgrads = _ref_loss_and_grads(rcfg, rparams, rbatch, rsc)
    for p in T.leaves(params):
        p.requires_grad_(True)
    loss, met = M.loss_fn(cfg, PCFG, params, batch, spamm_cfg=sc)
    loss.backward()
    assert abs(float(loss.detach()) - float(rl)) <= MM_RTOL * abs(float(rl))
    lvf = _np(met["spamm_layer_valid_fraction"])
    np.testing.assert_allclose(lvf, np.asarray(
        rmet["spamm_layer_valid_fraction"]), rtol=0, atol=1e-6)
    assert (0.0 < lvf).all() and (lvf < 1.0).all()
    want = dict(T.flatten_with_paths(_grads_as_port(rgrads, cfg)))
    for path, p in T.flatten_with_paths(params):
        assert _rel_err(_np(p.grad), want[path]) <= GRAD_RTOL, path


# ---------------------------------------------------------------------------
# the train step, AdamW, compression, data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", [None, "spamm"])
def test_train_step_matches_reference(mode):
    """One `make_train_step` against the reference's: the loss, the
    gradient norm, the parameters and both moments after the update."""
    cfg, rcfg, rparams, params = _models("starcoder2-7b")
    rbatch, batch = _batch(cfg, "tokens", seed=9)
    rsc, sc = _spamm(mode, 0.0)
    rt = RTrain(lr=1e-2, warmup=2, total_steps=10)
    tt = TrainConfig(lr=1e-2, warmup=2, total_steps=10)
    ropt, opt = radamw.AdamW(rt), tadamw.AdamW(tt)
    rstep = RM.make_train_step(rcfg, RPCFG, make_ctx(make_host_mesh()), ropt,
                               spamm_cfg=rsc)
    rp, rs, rmet = jax.jit(rstep)(rparams, ropt.init(rparams), rbatch,
                                  jnp.int32(1))
    step = M.make_train_step(cfg, PCFG, opt, spamm_cfg=sc)
    state = opt.init(params)
    params, state, met = step(params, state, batch, 1)
    assert abs(float(met["loss"]) - float(rmet["loss"])) <= MM_RTOL * abs(
        float(rmet["loss"]))
    assert abs(float(met["grad_norm"]) - float(rmet["grad_norm"])) <= (
        GRAD_RTOL * float(rmet["grad_norm"]))
    for got, want in ((state["mu"], rs["mu"]), (state["nu"], rs["nu"])):
        want = dict(T.flatten_with_paths(_grads_as_port(want, cfg)))
        for path, t in T.flatten_with_paths(got):
            assert _rel_err(_np(t), want[path]) <= GRAD_RTOL, path
    # the parameters: AdamW divides by √n̂ + 1e-8, so where a gradient is
    # within a few ulps of 0 its sign, hence its step, can differ; there
    # the step is at most 2·lr, elsewhere the parameters agree to STEP_RTOL
    mu = dict(T.flatten_with_paths(_grads_as_port(rs["mu"], cfg)))
    want = dict(T.flatten_with_paths(_grads_as_port(rp, cfg)))
    for path, t in T.flatten_with_paths(params):
        w, m = _np(want[path]), _np(mu[path])
        d = np.abs(_np(t).astype(np.float64) - w)
        off = d > STEP_RTOL * np.abs(w).max()
        small = np.abs(m) < 1e-3 * np.abs(m).max()
        assert small[off].all() and (d <= 2 * tt.lr).all(), path


def test_adamw_update_matches_reference():
    """The update on the same gradients (and after a step, the same
    moments): parameters, moments and the norm, with clipping active."""
    rng = np.random.default_rng(12)
    params = {"a": rng.standard_normal((6, 5)).astype(np.float32),
              "b": [rng.standard_normal(7).astype(np.float32)]}
    grads = [T.map_(lambda p: (3 * rng.standard_normal(p.shape)).astype(
        np.float32), params) for _ in range(2)]
    rt = RTrain(lr=1e-2, warmup=2, total_steps=10, grad_clip=1.0)
    ropt = radamw.AdamW(rt)
    opt = tadamw.AdamW(TrainConfig(lr=1e-2, warmup=2, total_steps=10,
                                   grad_clip=1.0))
    rp, tp = jax.tree.map(jnp.asarray, params), T.map_(torch.tensor, params)
    rs, ts = ropt.init(rp), opt.init(tp)
    for i, g in enumerate(grads):
        rp, rs, rn = ropt.update(rp, jax.tree.map(jnp.asarray, g), rs,
                                 jnp.int32(i))
        tp, ts, tn = opt.update(tp, T.map_(torch.tensor, g), ts, i)
        assert abs(float(tn) - float(rn)) <= 1e-6 * float(rn)
        assert float(rn) > 1.0  # the clip scales the step
        for got, want in ((tp, rp), (ts["mu"], rs["mu"]),
                          (ts["nu"], rs["nu"])):
            for (path, t), w in zip(T.flatten_with_paths(got),
                                    jax.tree.leaves(want)):
                np.testing.assert_allclose(_np(t), np.asarray(w), rtol=1e-5,
                                           atol=1e-7, err_msg=path)


def test_lr_at_matches_reference():
    for warmup, total in ((0, 10), (3, 30), (100, 1000)):
        r = radamw.AdamW(RTrain(lr=3e-4, warmup=warmup, total_steps=total))
        t = tadamw.AdamW(TrainConfig(lr=3e-4, warmup=warmup,
                                     total_steps=total))
        for step in (0.0, 1.0, 2.5, float(warmup), warmup + 1.0,
                     (warmup + total) / 2, total - 1.0, float(total),
                     total + 5.0):
            want = float(r.lr_at(jnp.float32(step)))
            assert abs(float(t.lr_at(step)) - want) <= 1e-6 * 3e-4, (
                warmup, total, step)
    assert TrainConfig() == TrainConfig(**{
        f.name: getattr(RTrain(), f.name)
        for f in dataclasses.fields(RTrain) if f.name != "ckpt_dir"})


def test_int8_ef_matches_reference():
    """Two steps of compression with error feedback: the dequantized
    gradients and the residuals, leaf for leaf."""
    rng = np.random.default_rng(11)
    grads = [{"a": rng.standard_normal((8, 5)).astype(np.float32),
              "b": [(1e-3 * rng.standard_normal(7)).astype(np.float32)]}
             for _ in range(2)]
    zeros = jax.tree.map(np.zeros_like, grads[0])
    rstate, tstate = {"ef": jax.tree.map(jnp.asarray, zeros)}, {
        "ef": T.map_(torch.tensor, zeros)}
    rc, tc = rcomp.Int8EF(), tcomp.Int8EF()
    for g in grads:
        rdeq, rstate = rc.apply(jax.tree.map(jnp.asarray, g), rstate)
        tdeq, tstate = tc.apply(T.map_(torch.tensor, g), tstate)
        for got, want in ((tdeq, rdeq), (tstate["ef"], rstate["ef"])):
            for (path, t), w in zip(T.flatten_with_paths(got),
                                    jax.tree.leaves(want)):
                np.testing.assert_allclose(_np(t), np.asarray(w), rtol=1e-6,
                                           atol=1e-12, err_msg=path)
    assert tc.wire_bytes_saved(T.map_(torch.tensor, grads[0])) == \
        rc.wire_bytes_saved(jax.tree.map(jnp.asarray, grads[0]))


def test_synthetic_lm_tokens_bit_for_bit():
    for arch in ("starcoder2-7b", "musicgen-large"):
        cfg, rcfg = get_config(arch).reduced(), rget_config(arch).reduced()
        r = rpipe.SyntheticLM(rcfg, 3, 20, seed=4)
        t = tpipe.SyntheticLM(cfg, 3, 20, seed=4, device="cpu")
        for step in (0, 1, 17):
            rb, tb = r.batch_at(step), t.batch_at(step)
            assert tb.keys() == rb.keys()
            np.testing.assert_array_equal(_np(tb["labels"]),
                                          np.asarray(rb["labels"]))
            if "tokens" in tb:
                np.testing.assert_array_equal(_np(tb["tokens"]),
                                              np.asarray(rb["tokens"]))
            else:  # torch-drawn embeds: the shape, and the same on a rerun
                assert tb["embeds"].shape == rb["embeds"].shape
                assert torch.equal(tb["embeds"], t.batch_at(step)["embeds"])
    np.testing.assert_array_equal(tpipe.synthesized_decay(64, 3),
                                  rpipe.synthesized_decay(64, 3))
    np.testing.assert_array_equal(tpipe.ergo_like(64), rpipe.ergo_like(64))
    assert tpipe.vgg_im2col_shapes() == rpipe.vgg_im2col_shapes()
    np.testing.assert_array_equal(tpipe.relu_sparse_matrix(8, 9),
                                  rpipe.relu_sparse_matrix(8, 9))


# ---------------------------------------------------------------------------
# remat, taps and the weight cache under training
# ---------------------------------------------------------------------------

def _loss_and_grads(cfg, pcfg, params, batch, sc):
    params = T.map_(lambda p: p.detach().clone().requires_grad_(True),
                    params)
    loss, met = M.loss_fn(cfg, pcfg, params, batch, spamm_cfg=sc)
    loss.backward()
    return loss, met, [p.grad for p in T.leaves(params)]


@pytest.mark.parametrize("arch", ["starcoder2-7b", "qwen2-moe-a2.7b"])
def test_remat_on_equals_off(arch):
    """remat "full" and "dots" recompute each layer's forward inside
    backward: the gradients and the gating stats equal remat "none"'s bit
    for bit, and each gated GEMM is counted once (a MoE block's GEMMs not
    at all, as in the reference)."""
    cfg = get_config(arch).reduced()
    params = M.init_params(cfg, PCFG, 0, device="cpu")
    _, batch = _batch(cfg, "tokens", seed=13)
    sc = tmodule.SpammContext(SpammConfig(enable=True, tau=0.3, tile=TILE,
                                          backend="torch", bwd="spamm"))
    base = _loss_and_grads(cfg, PCFG, params, batch, sc)
    gated = 4 if cfg.moe is not None else 6
    assert float(base[1]["spamm_gated_gemms"]) == gated * cfg.num_layers
    for remat in ("full", "dots"):
        pc = dataclasses.replace(PCFG, remat=remat)
        loss, met, grads = _loss_and_grads(cfg, pc, params, batch, sc)
        assert torch.equal(loss, base[0])
        for name, v in met.items():
            assert torch.equal(v, base[1][name]), (remat, name)
        for g, g0 in zip(grads, base[2]):
            assert torch.equal(g, g0), remat


def test_weight_cache_stays_empty_under_training():
    """Trainable weights bypass the context's WeightPlanCache (the
    reference never caches a traced weight): after three steps it holds no
    entry and counted no lookup; an eager forward without grad still
    caches."""
    cfg = get_config("starcoder2-7b").reduced()
    params = M.init_params(cfg, PCFG, 0, device="cpu")
    _, batch = _batch(cfg, "tokens", seed=14)
    sc = tmodule.SpammContext(SpammConfig(enable=True, tau=0.3, tile=TILE,
                                          backend="torch"))
    opt = tadamw.AdamW(TrainConfig(lr=1e-3, warmup=1, total_steps=5))
    state = opt.init(params)
    step = M.make_train_step(cfg, PCFG, opt, spamm_cfg=sc)
    for i in range(3):
        params, state, _ = step(params, state, batch, i)
    assert len(sc.cache) == 0 and (sc.cache.hits, sc.cache.misses) == (0, 0)
    frozen = T.map_(lambda p: p.detach(), params)
    with torch.no_grad():
        M.loss_fn(cfg, PCFG, frozen, batch, spamm_cfg=sc)
    assert len(sc.cache) == 6 * cfg.num_layers


# ---------------------------------------------------------------------------
# the train loop (twins of tests/test_train_loop.py) and the CLI
# ---------------------------------------------------------------------------

LOOP_PCFG = ParallelConfig(compute_dtype="float32", remat="none",
                           attn_q_chunk=32, loss_chunk=64)


def _loop_cfg():
    return get_config("musicgen-large").reduced()  # small vocab → fast CE


def test_loss_decreases(tmp_path):
    tcfg = TrainConfig(lr=1e-3, total_steps=30, warmup=3, ckpt_every=0,
                       ckpt_dir=str(tmp_path))
    res = tloop.train(_loop_cfg(), LOOP_PCFG, tcfg, global_batch=4,
                      seq_len=64, log_every=0, device="cpu")
    assert np.mean(res.losses[-5:]) < np.mean(res.losses[:5]) - 0.05
    assert res.final_step == 30 and res.spamm_stats == []
    assert res.obs.registry.histogram("train_step_seconds").count() == 30


def test_failure_restart_resumes_bit_for_bit(tmp_path):
    """Crash at step 20 with checkpoints every 10; the resumed run's losses
    and final parameters equal the uninterrupted run's bit for bit."""
    kw = dict(global_batch=4, seq_len=64, log_every=0, device="cpu")
    sc = SpammConfig(enable=True, tau=30.0, tile=TILE, backend="torch",
                     bwd="spamm")
    ref = tloop.train(_loop_cfg(), LOOP_PCFG, TrainConfig(
        lr=1e-3, total_steps=30, warmup=3, ckpt_every=10,
        ckpt_dir=str(tmp_path / "ckpt")), spamm_cfg=sc, **kw)
    tcfg = TrainConfig(lr=1e-3, total_steps=30, warmup=3, ckpt_every=10,
                       ckpt_dir=str(tmp_path / "ckpt2"))
    with pytest.raises(RuntimeError, match="injected failure"):
        tloop.train(_loop_cfg(), LOOP_PCFG, tcfg, fail_at_step=20,
                    spamm_cfg=sc, **kw)
    res = tloop.train(_loop_cfg(), LOOP_PCFG, tcfg, resume=True,
                      spamm_cfg=sc, **kw)
    assert res.final_step == 30 and res.restarts == 1
    assert res.losses == ref.losses[20:]
    assert res.spamm_stats == ref.spamm_stats[20:]
    s = res.spamm_stats[-1]
    assert s["gated_gemms"] == 12 and 0.0 < s["valid_fraction"] < 1.0
    assert sorted(s["per_layer"]) == [0, 1]
    assert ck.all_steps(str(tmp_path / "ckpt2")) == [10, 20, 30]
    with np.load(tmp_path / "ckpt" / "step_30" / "arrays.npz") as a, \
            np.load(tmp_path / "ckpt2" / "step_30" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert any(k.startswith("opt_state/mu/layers/1/") for k in a.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert res.obs.tracer.span_names() >= {"train_step", "checkpoint_save"}


def test_int8_ef_compression_converges(tmp_path):
    pc = dataclasses.replace(LOOP_PCFG, grad_compression="int8_ef")
    tcfg = TrainConfig(lr=1e-3, total_steps=30, warmup=3, ckpt_every=0,
                       ckpt_dir=str(tmp_path))
    res = tloop.train(_loop_cfg(), pc, tcfg, global_batch=4, seq_len=64,
                      log_every=0, device="cpu")
    assert np.mean(res.losses[-5:]) < np.mean(res.losses[:5]) - 0.03


def test_reshard_waits_for_multi_gpu(monkeypatch):
    """Re-sharding in the train loop (this test held the loop's refusal
    before the multi-GPU slice ported it): probing every step never
    touches the computed values — losses and gating stats equal the run
    with re-sharding off, bit for bit — and each step's `imbalance`,
    `resharded` and `offsets` equal the reference loop's controller fed
    the reference's probe body on the same parameters and tokens. The
    embedding gets a seeded id→norm profile, so the probe's V varies
    with the batch."""
    from repro.core import schedule as RS
    from repro_torch.core.schedule import ReshardConfig

    cfg = get_config("starcoder2-7b").reduced()
    params = M.init_params(cfg, LOOP_PCFG, 0, device="cpu")
    scale = np.exp(2.0 * np.random.default_rng(0).standard_normal(cfg.vocab))
    params["embed"]["embedding"].mul_(
        torch.as_tensor(scale, dtype=torch.float32)[:, None])
    monkeypatch.setattr(M, "init_params",
                        lambda *a, **k: T.map_(torch.clone, params))
    probes = []
    orig = M.reshard_probe

    def recording(controller, ctx, p, step, **kw):
        probes.append((step, p["embed"]["embedding"].detach().numpy().copy(),
                       p["unembed"]["kernel"].detach().numpy().copy(),
                       np.asarray(kw["tokens"])))
        return orig(controller, ctx, p, step, **kw)

    monkeypatch.setattr(M, "reshard_probe", recording)
    tau = 32.0
    kw = dict(global_batch=4, seq_len=64, log_every=0, device="cpu",
              spamm_cfg=SpammConfig(enable=True, tau=tau, tile=TILE,
                                    backend="torch"))
    tcfg = TrainConfig(lr=1e-3, total_steps=5, warmup=1, ckpt_every=0)
    on = tloop.train(cfg, LOOP_PCFG, tcfg, reshard_cfg=ReshardConfig(
        num_devices=4, every=1, drift_threshold=1.0), **kw)
    off = tloop.train(cfg, LOOP_PCFG, tcfg, **kw)
    assert on.losses == off.losses
    keys = ("imbalance", "resharded", "offsets", "loads")
    assert [{k: v for k, v in s.items() if k not in keys}
            for s in on.spamm_stats] == off.spamm_stats
    assert "resharded" not in off.spamm_stats[0]
    rc = RS.ReshardController(RS.ReshardConfig(num_devices=4, every=1,
                                               drift_threshold=1.0))
    rctx = rmodule.SpammContext(RSpamm(enable=True, tau=tau, tile=TILE,
                                       backend="jnp"))
    assert [p[0] for p in probes] == list(range(5))
    for (step, emb, unemb, toks), sp in zip(probes, on.spamm_stats):
        RM.reshard_probe(rc, rctx, {"embed": {"embedding": jnp.asarray(emb)},
                                    "unembed": {"kernel": jnp.asarray(unemb)}},
                         step, tokens=toks)
        assert sp["resharded"] == rc.resharded, step
        assert sp["offsets"] == [int(o) for o in rc.offsets], step
        assert sp["imbalance"] == pytest.approx(rc.live_imbalance,
                                                rel=1e-6), step
        np.testing.assert_allclose(sp["loads"], rc.live_loads, rtol=1e-6)
    assert rc.resharded >= 1, rc.history
    assert on.obs.tracer.span_names() >= {"reshard_probe"}
    text = on.obs.registry.render_prometheus()
    assert "spamm_reshard_probes_total 5" in text


def test_train_cli_on_cpu(tmp_path):
    out = io.StringIO()
    argv = ["--arch", "musicgen-large", "--reduced", "--device", "cpu",
            "--steps", "4", "--batch", "2", "--seq", "32", "--spamm",
            "--tau", "0.0", "--spamm-tile", "16", "--ckpt-dir",
            str(tmp_path / "ck"), "--ckpt-every", "2", "--metrics-out",
            str(tmp_path / "m.prom"), "--trace-out", str(tmp_path / "t.json")]
    with contextlib.redirect_stdout(out):
        tlaunch.main(argv)
    text = out.getvalue()
    assert "done: steps=4 " in text
    assert "spamm: mean_valid_fraction=1.000 gated_gemms/step=12" in text
    assert 'spamm_valid_fraction_count{phase="train",layer="1",site=""}' in (
        tmp_path / "m.prom").read_text()
    assert "checkpoint_save" in (tmp_path / "t.json").read_text()
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="device='cuda'"):
            tlaunch.main(argv[:3] + argv[5:])
