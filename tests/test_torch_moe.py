"""The MoE family (qwen2-moe-a2.7b: 60 experts top-4 with a gated shared
expert; mixtral-8x22b: 8 experts top-2, sliding window) against the JAX
reference at `.reduced()` size: the same weights (carried across by
`params_from_jax`), inputs from a numpy seed, the reference's MoE block on
a one-device (data, model) mesh and its SpAMM on the `jnp` backend, the
port on the plain versions of its kernels (CPU tensors).

The routing is compared table for table; the router's top-k margin is
asserted above 1e-6 so that no choice between two experts can flip on the
ulp by which the two packages' router logits differ (their f32 matmuls
sum in different orders).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ParallelConfig as RParallel
from repro.configs import SpammConfig as RSpamm
from repro.configs import get_config as rget_config
from repro.core.module import SpammContext as RContext
from repro.launch.mesh import make_ctx, make_host_mesh, make_mesh
from repro.models import model as RM
from repro.models import moe as rmoe
from repro.plans import precompute as rpre
from repro.serving.engine import Engine as REngine
from repro.serving.engine import Request as RRequest
from repro_torch.configs import (PORTED_ARCHS, MoEConfig, ParallelConfig,
                                 SpammConfig, get_config)
from repro_torch.core import plan as tplan
from repro_torch.core.module import SpammContext
from repro_torch.models import model as M
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tr
from repro_torch.obs import parse_prometheus
from repro_torch.plans import precompute as tpre
from repro_torch.serving.engine import Engine, Request

ARCHS = ("qwen2-moe-a2.7b", "mixtral-8x22b")
TILE = 16
B, PLEN, MAX_NEW, MAX_LEN = 2, 16, 5, 64
MIX = (16, 37, 20, 48)
# the published widths each arch is held to (the configs' own sources)
FULL = {
    "qwen2-moe-a2.7b": dict(num_layers=24, d_model=2048, num_heads=16,
                            num_kv_heads=16, vocab=151936, qkv_bias=True,
                            sliding_window=None),
    "mixtral-8x22b": dict(num_layers=56, d_model=6144, num_heads=48,
                          num_kv_heads=8, vocab=32768, qkv_bias=False,
                          sliding_window=4096),
}
FULL_MOE = {
    "qwen2-moe-a2.7b": dict(num_experts=60, top_k=4, expert_ff=1408,
                            num_shared=4, shared_ff=5632, impl="ep"),
    "mixtral-8x22b": dict(num_experts=8, top_k=2, expert_ff=16384,
                          num_shared=0, shared_ff=0, impl="tp"),
}
# the router's gates: softmax of f32 logits whose matmuls sum in different
# orders in the two packages — a few f32 ulps of 1
GATE_ATOL = 1e-6
# top-k margin the routing inputs keep (see the module docstring)
TOPK_MARGIN = 1e-6
# MoE block and prefill logits after two f32 layers (reassociated sums,
# transcendental ulps), relative to the output's largest magnitude
OUT_RTOL = 1e-5
# relative distance every gate product keeps from the gate τ, far above the
# ~1e-6 relative gap between the two packages' f32 norms
GATE_MARGIN = 1e-3
VF_TOL = 1e-9
RPCFG = RParallel(compute_dtype="float32", remat="none", attn_q_chunk=8,
                  attn_kv_chunk=8, decode_seq_shard=False)
PCFG = ParallelConfig(compute_dtype="float32", attn_q_chunk=8)


def _moe_fields(m):
    return {f.name: getattr(m, f.name) for f in dataclasses.fields(m)}


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal_the_references(arch):
    """(a) Every field of the port's config, full and reduced, equals the
    reference's (the MoE block field by field), and the published widths
    hold; SpammConfig carries the reference's `moe_bmm` switch."""
    assert arch in PORTED_ARCHS
    for ours, ref in ((get_config(arch), rget_config(arch)),
                      (get_config(arch).reduced(),
                       rget_config(arch).reduced())):
        for f in dataclasses.fields(ours):
            if f.name == "moe":
                assert isinstance(ours.moe, MoEConfig)
                assert _moe_fields(ours.moe) == _moe_fields(ref.moe)
            else:
                assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    full = get_config(arch)
    for k, v in FULL[arch].items():
        assert getattr(full, k) == v, k
    for k, v in FULL_MOE[arch].items():
        assert getattr(full.moe, k) == v, k
    assert full.moe.capacity_factor == 1.25
    assert full.moe.router_aux_weight == 0.001
    assert tr.stack_kinds(full) == "attn"
    assert SpammConfig().moe_bmm is RSpamm().moe_bmm is False


# ---------------------------------------------------------------------------
# the block: dispatch, tp/ep, SpAMM
# ---------------------------------------------------------------------------

def _block_setup(arch, impl=None, cf=None, tokens=32, seed=0):
    """The reduced arch's MoE config (impl / capacity factor replaced when
    given), the reference's parameters, the port's copy, and an input
    (1, tokens, d) whose router top-k margin exceeds TOPK_MARGIN."""
    rcfg = rget_config(arch).reduced()
    rm = rcfg.moe
    if impl is not None:
        rm = dataclasses.replace(rm, impl=impl)
    if cf is not None:
        rm = dataclasses.replace(rm, capacity_factor=cf)
    tm = MoEConfig(**_moe_fields(rm))
    rp = rmoe.moe_params(jax.random.key(seed), rm, rcfg.d_model, jnp.float32)
    tp = jax.tree.map(lambda a: torch.tensor(np.asarray(a)), rp)
    x = np.random.default_rng(seed).standard_normal(
        (1, tokens, rcfg.d_model)).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(x[0] @ np.asarray(rp["router"]), -1))
    top = -np.sort(-probs, axis=-1)[:, :rm.top_k + 1]
    assert np.min(top[:, :-1] - top[:, 1:]) > TOPK_MARGIN
    return rcfg, rm, tm, rp, tp, x


def _ref_block(rp, x, rm, act, spamm_cfg=None):
    mesh = make_mesh((1, 1), ("data", "model"))
    with mesh:
        y, aux = jax.jit(lambda p, xx: rmoe.moe_block(
            p, xx, rm, act, mesh=mesh, spamm_cfg=spamm_cfg))(
                rp, jnp.asarray(x))
    return np.asarray(y), float(aux)


def _assert_close(got, want, rtol=OUT_RTOL):
    scale = float(np.abs(want).max())
    assert scale > 0
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rtol * scale, (err, scale)


@pytest.mark.parametrize("cf", [0.5, 1.25], ids=["drops", "default"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_tables_equal_the_references(arch, cf):
    """(b) The sorted expert, token, slot and keep tables exactly, the
    gates and the load-balance loss within GATE_ATOL; at capacity factor
    0.5 some assignments drop, and a dropped assignment's slot is its rank
    within its expert, never a clamped one."""
    _, rm, tm, rp, tp, x = _block_setup(arch, cf=cf)
    xt = x[0]
    cap = tmoe.capacity(xt.shape[0], tm)
    assert cap == max(4, -(-int(math.ceil(
        xt.shape[0] * rm.top_k / rm.num_experts * cf)) // 4) * 4)
    want = rmoe._dispatch(jnp.asarray(xt), rp["router"], rm, cap)
    got = tmoe._dispatch(torch.as_tensor(xt), tp["router"], tm, cap)
    names = ("se", "st", "sg", "pos", "keep", "aux")
    for name, g, w in zip(names, got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if name in ("sg", "aux"):
            np.testing.assert_allclose(g, w, rtol=0, atol=GATE_ATOL,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    if cf < 1.0:
        assert not got[4].numpy().all() and got[3].numpy().max() >= cap


@pytest.mark.parametrize("impl", ["tp", "ep"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_reference(arch, impl):
    """(c) moe_block for impl tp and ep, with (qwen2-moe) and without
    (mixtral) the shared expert, with capacity drops: output within
    OUT_RTOL of its largest magnitude, aux within GATE_ATOL."""
    rcfg, rm, tm, rp, tp, x = _block_setup(arch, impl=impl, cf=0.75)
    want, aux_w = _ref_block(rp, x, rm, rcfg.act)
    got, aux = tmoe.moe_block(tp, torch.as_tensor(x), tm, rcfg.act)
    assert got.shape == want.shape and got.dtype == torch.float32
    _assert_close(got.numpy(), want)
    assert abs(float(aux) - aux_w) <= GATE_ATOL
    assert ("shared" in tp) == (arch == "qwen2-moe-a2.7b")


def test_combine_order_is_fixed_and_spill_row_drops():
    """The combine adds each token's contributions in ascending expert
    order from zero (the reference's sorted scatter-add order), so two
    calls agree bit for bit; a capacity of 4 slots with every token on one
    expert keeps exactly the first 4 tokens' rows."""
    rcfg, rm, tm, rp, tp, x = _block_setup("mixtral-8x22b", cf=0.75)
    a, _ = tmoe.moe_block(tp, torch.as_tensor(x), tm, rcfg.act)
    b, _ = tmoe.moe_block(tp, torch.as_tensor(x), tm, rcfg.act)
    assert torch.equal(a, b)
    one = dataclasses.replace(tm, top_k=1)
    # a router that puts every token's mass on expert 3
    tp1 = dict(tp, router=torch.zeros_like(tp["router"]))
    tp1["router"][0, 3] = 1e4
    xs = torch.as_tensor(x).abs() + 1.0
    se, st, sg, pos, keep, _ = tmoe._dispatch(xs[0], tp1["router"], one, 4)
    assert (se == 3).all() and int(keep.sum()) == 4 and (sg == 1.0).all()
    assert st[keep].tolist() == [0, 1, 2, 3]
    assert tmoe.capacity(xs.shape[1], one) == 4
    y, _ = tmoe.moe_block(tp1, xs, one, rcfg.act)
    buf = xs[0, :4]
    rows = (torch.nn.functional.silu(buf @ tp1["w1"][3])
            * (buf @ tp1["w3"][3])) @ tp1["w2"][3]
    _assert_close(y[0, :4].numpy(), rows.numpy())
    assert (y[0, 4:] == 0).all()


def _gap(p, lo, hi):
    p = np.sort(p)
    a, b = int(lo * p.size), int(hi * p.size)
    g = a + int(np.argmax(p[a + 1:b + 1] / p[a:b]))
    return float(np.sqrt(p[g] * p[g + 1]))


class _Products:
    """Every gate product the port's plans evaluate while active: the flat
    eager gate, the batched spamm_bmm gate and the frozen device gate."""

    def __init__(self, mp):
        self.got = []
        flat, mask, frozen = (tplan._flat_triples_host, tplan.gate_mask,
                              tplan._plan_frozen)

        def rec_flat(na, nb, tau, *a, **kw):
            self.got.append((na[:, None, :] * nb.T[None]).ravel())
            return flat(na, nb, tau, *a, **kw)

        def rec_mask(na, nb, tau, block_n=1):
            self.got.append((na[..., :, None, :]
                             * nb.transpose(-1, -2)[..., None, :, :]
                             ).numpy().ravel())
            return mask(na, nb, tau, block_n)

        def rec_frozen(a, fp, **kw):
            p = frozen(a, fp, **kw)
            prod = p.norm_a[fp.step_i, fp.step_k] * fp.nbmax[fp.step_k,
                                                              fp.step_j]
            self.got.append(prod[fp.step_real].numpy())
            return p

        mp.setattr(tplan, "_flat_triples_host", rec_flat)
        mp.setattr(tplan, "gate_mask", rec_mask)
        mp.setattr(tplan, "_plan_frozen", rec_frozen)

    def all(self):
        p = np.concatenate([np.asarray(x, np.float64) for x in self.got])
        return p[p > 0]


# quantile windows of the gate products a gap τ is searched in, in order
GAP_WINDOWS = ((0.4, 0.6), (0.25, 0.75), (0.1, 0.9))


def _gap_tau(run):
    """A τ inside a gap of every gate product `run(tau)` evaluates, with
    every product at least GATE_MARGIN away (relative): the widest gap in
    a quantile window of the products, re-checked on the run at that τ
    (downstream products move with the gate), window after window."""
    with pytest.MonkeyPatch.context() as mp:
        rec = _Products(mp)
        run(0.0)
        p0 = rec.all()
        for lo, hi in GAP_WINDOWS:
            allp = p0
            for _ in range(3):
                tau = _gap(allp, lo, hi)
                rec.got.clear()
                run(tau)
                allp = rec.all()
                margin = float(np.min(np.abs(allp - tau)) / tau)
                if margin >= GATE_MARGIN:
                    return tau
    raise AssertionError(f"no gap of relative width {GATE_MARGIN}: "
                         f"{tau}, {margin}")


@pytest.mark.parametrize("arch", ARCHS)
def test_gated_moe_block_matches_reference(arch):
    """(d) SpAMM inside the block: at τ = 0 the port equals its dense block
    within OUT_RTOL; at a gap τ, with moe_bmm on and off, the port matches
    the reference's jnp backend within OUT_RTOL, some tiles are skipped,
    the taps match (count, site, fraction), and the expert outputs with
    moe_bmm on equal those with it off bit for bit (dense-grid ≡
    work-list)."""
    rcfg, rm, tm, rp, tp, x = _block_setup(arch, cf=0.75)
    xt = torch.as_tensor(x)
    dense, _ = tmoe.moe_block(tp, xt, tm, rcfg.act)

    def port(tau, bmm):
        ctx = SpammContext(SpammConfig(enable=True, tau=tau, tile=TILE,
                                       moe_bmm=bmm))
        ctx.begin_stats()
        y, _ = tmoe.moe_block(tp, xt, tm, rcfg.act, spamm_cfg=ctx)
        return y, ctx.end_stats()

    y0, _ = port(0.0, True)
    _assert_close(y0.numpy(), dense.numpy())
    tau = _gap_tau(lambda t: port(t, True))
    ys = {}
    for bmm in (True, False):
        y, taps = port(tau, bmm)
        rctx = RContext(RSpamm(enable=True, tau=tau, tile=TILE,
                               backend="jnp", moe_bmm=bmm))
        rctx.begin_stats()
        want, _ = _ref_block(rp, x, rm, rcfg.act, spamm_cfg=rctx)
        rtaps = rctx.end_stats()
        _assert_close(y.numpy(), want)
        # the reference's jitted callbacks are unordered: compare the taps
        # as sorted (site, layer, fraction) lists
        key = lambda t: (t.site or "", t.layer, t.value)
        got_t, want_t = sorted(taps, key=key), sorted(rtaps, key=key)
        assert [key(t)[:2] for t in got_t] == [key(t)[:2] for t in want_t]
        np.testing.assert_allclose([t.value for t in got_t],
                                   [t.value for t in want_t], rtol=0,
                                   atol=VF_TOL)
        n_exp = 1 if bmm else rm.num_experts
        shared = 3 if "shared" in tp else 0
        assert len(taps) == 3 * n_exp + shared
        assert 0.0 < np.mean([t.value for t in taps]) < 1.0
        ys[bmm] = y
    assert torch.equal(ys[True], ys[False])


def test_weight_side_keeps_no_padded_copy_of_aligned_experts():
    """The spamm_bmm weight side of a tile-aligned (E, d, ff) expert
    weight is the parameter itself (no padded copy held by the cache)."""
    _, _, _, _, tp, _ = _block_setup("qwen2-moe-a2.7b")
    cache = tplan.WeightPlanCache()
    for name in ("w1", "w3", "w2"):
        wp, nw = cache.weight_side(tp[name], tile=TILE, backend="auto")
        assert wp is tp[name]
        e, k, n = tp[name].shape
        assert tuple(nw.shape) == (e, k // TILE, n // TILE)


# ---------------------------------------------------------------------------
# the model tree, the frozen plans and the engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    arch = request.param
    rcfg = rget_config(arch).reduced()
    cfg = get_config(arch).reduced()
    rparams = RM.init_params(rcfg, RPCFG, jax.random.key(0))
    np_tree = jax.tree.map(np.asarray, rparams)
    params = M.params_from_jax(np_tree, cfg, device="cpu")
    return arch, rcfg, cfg, rparams, np_tree, params


def test_params_from_jax_carries_the_moe_subtree(setup):
    """Every MoE leaf lands in the port's tree, layer by layer, bit for
    bit: router (d, E) f32, w1/w3 (E, d, ff), w2 (E, ff, d), and the shared
    expert with its (d, 1) f32 gate; the port's own init makes the same
    tree."""
    arch, _, cfg, _, np_tree, params = setup
    moe = params["layers"][0]["moe"]
    want = {"router", "w1", "w3", "w2"} | (
        {"shared"} if cfg.moe.num_shared else set())
    assert set(moe) == want and "mlp" not in params["layers"][0]
    e, d, ff = cfg.moe.num_experts, cfg.d_model, cfg.moe.expert_ff
    assert tuple(moe["router"].shape) == (d, e)
    assert tuple(moe["w1"].shape) == tuple(moe["w3"].shape) == (e, d, ff)
    assert tuple(moe["w2"].shape) == (e, ff, d)
    if cfg.moe.num_shared:
        assert tuple(moe["shared"]["gate"].shape) == (d, 1)
        assert set(moe["shared"]) == {"w1", "w3", "w2", "gate"}
    for l in range(cfg.num_layers):
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                np_tree["layers"]["moe"])[0]:
            keys = [p.key for p in path]
            got = params["layers"][l]["moe"]
            for k in keys:
                got = got[k]
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), leaf[l])
    own = M.init_params(cfg, PCFG, 0, device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), own) == \
        jax.tree.map(lambda t: tuple(t.shape), params)


@pytest.mark.parametrize("autotune", [False, True],
                         ids=["default", "autotune"])
def test_frozen_walk_leaves_the_moe_subtree_unfrozen(setup, autotune,
                                                     tmp_path):
    """The gated weights are the attention projections only — no expert,
    shared-expert or router weight — and every frozen artifact's store
    address (content fingerprint) and blocking (autotuned too) is the
    reference's for the same layer's weight; `populate` files exactly
    those artifacts in a plan store."""
    from repro_torch.plans.store import PlanStore

    _, _, cfg, rparams, _, params = setup
    paths = [p for p, _ in tpre.iter_gated_weights(params)]
    assert paths and all(p[2] == "mix" for p in paths)
    assert len(paths) == 4 * cfg.num_layers
    sc = SpammConfig(enable=True, tau=0.05, tile=TILE, autotune=autotune)
    tree, n = tpre.freeze_tree(params, sc)
    rtree, rn = rpre.freeze_tree(
        rparams, RSpamm(enable=True, tau=0.05, tile=TILE, backend="jnp",
                        autotune=autotune))
    assert n == rn == len(paths)
    assert set(rtree["layers"]) == {"mix"} and all(
        set(t) == {"mix"} for t in tree["layers"])
    for l, layer in enumerate(tree["layers"]):
        for name, fw in layer["mix"].items():
            rfw = rtree["layers"]["mix"][name][l]
            assert fw.weight_hash == rfw.weight_hash
            assert (fw.block_n, fw.num_levels) == (rfw.block_n,
                                                   rfw.num_levels)
    store = PlanStore(str(tmp_path / "store"))
    assert tpre.populate(store, params, sc) == n == len(store)


def _logits(eng, reng, params, rparams, prompts):
    with torch.inference_mode():
        _, logits = eng._prefill(params, {"tokens": torch.as_tensor(prompts)},
                                 eng._frozen_for(prompts.size))
    _, rlogits = reng._prefill(rparams, {"tokens": jnp.asarray(prompts)},
                               reng._frozen_for(prompts.size))
    return logits.numpy(), np.asarray(rlogits)


RUNS = {"dense": None, "bmm": True, "per_expert": False}


def _prompts(cfg, plane):
    rng = np.random.default_rng(3)
    if plane == "wave":
        return list(rng.integers(1, cfg.vocab, size=(B, PLEN)).astype(
            np.int32))
    return [rng.integers(1, cfg.vocab, n).astype(np.int32) for n in MIX]


def _planes(plane):
    return {} if plane == "wave" else {"prefill_chunk": TILE, "max_slots": 2}


def _port_engine(cfg, params, plane, tau, bmm):
    sc = (None if tau is None
          else SpammConfig(enable=True, tau=tau, tile=TILE, moe_bmm=bmm))
    return Engine(cfg, PCFG, params, max_len=MAX_LEN, spamm_cfg=sc,
                  device="cpu", **_planes(plane))


def _generate(eng, cls, prompts):
    reqs = [cls(prompt=p, max_new_tokens=MAX_NEW) for p in prompts]
    return [o.tolist() for o in eng.generate(reqs)], reqs[0].out


@pytest.fixture(scope="module", params=[
    ("wave", "dense"), ("wave", "bmm"), ("wave", "per_expert"),
    ("chunked", "dense"), ("chunked", "bmm"), ("chunked", "per_expert")],
    ids=lambda p: "-".join(p))
def served(request, setup):
    """One wave of a plane through both engines: SpAMM off, or at a gap τ
    with moe_bmm on or off."""
    plane, run = request.param
    arch, rcfg, cfg, rparams, _, params = setup
    prompts = _prompts(cfg, plane)
    bmm = RUNS[run]
    tau = None
    if bmm is not None:
        tau = _gap_tau(lambda t: _generate(
            _port_engine(cfg, params, plane, t, bmm), Request, prompts))
    eng = _port_engine(cfg, params, plane, tau, bmm)
    rsc = (None if tau is None else RSpamm(enable=True, tau=tau, tile=TILE,
                                          backend="jnp", moe_bmm=bmm))
    reng = REngine(rcfg, RPCFG, make_ctx(make_host_mesh()), rparams,
                   max_len=MAX_LEN, spamm_cfg=rsc, **_planes(plane))
    got = _generate(eng, Request, prompts)
    want = _generate(reng, RRequest, prompts)
    return plane, run, tau, eng, reng, got, want


def test_engines_emit_the_same_tokens(served):
    """(e) Tokens equal on both planes; gated runs skip some tiles; the
    wave's prefill logits within OUT_RTOL; the capture decision is
    reported (the CPU captures nothing)."""
    plane, run, tau, eng, reng, (toks, out), (rtoks, rout) = served
    assert toks == rtoks
    assert all(len(t) == MAX_NEW for t in toks)
    assert out["graphs"] == {"decode": False, "chunk": False}
    if tau is not None:
        assert 0.0 < out["spamm"]["valid_fraction"] < 1.0
    if plane == "wave":
        prompts = np.stack(_prompts(eng.cfg, plane))
        got, want = _logits(eng, reng, eng.params, reng.params, prompts)
        _assert_close(got, want)


def _registry_cells(reg):
    """The gated-GEMM counter's (phase, layer, site) samples, and the
    valid-fraction histogram's bucket and count samples (integers) and sum
    samples."""
    fams = parse_prometheus(reg.render_prometheus())
    counts = dict(fams["spamm_gated_gemms_total"]["samples"])
    sums = {}
    for k, v in fams["spamm_valid_fraction"]["samples"].items():
        (sums if k.startswith("spamm_valid_fraction_sum") else counts)[k] = v
    return counts, sums


def test_telemetry_matches_reference(served):
    """(e) per_layer cell for cell (counts and bytes exactly, fractions
    within VF_TOL), the registry's gated-GEMM cells including the MoE
    block's layer -1 cells (site "moe_bmm" for the batched path, "" for
    the per-expert and shared-expert GEMMs), gm_histogram, the aggregate
    stats and each phase's predicted seconds. The plan-cache counts are a
    stated departure: the port's eager MoE GEMMs look their weight side up
    in the cache, the reference's jitted ones never do."""
    plane, run, tau, eng, reng, (_, out), (_, rout) = served
    if tau is None:
        assert out["spamm"] is None and rout["spamm"] is None
        return
    sp, rsp = out["spamm"], rout["spamm"]
    assert sorted(sp) == sorted(rsp)
    got, want = sp["per_layer"], rsp["per_layer"]
    assert sorted(got) == sorted(want) == list(range(eng.cfg.num_layers))
    for layer, sites in want.items():
        assert sorted(got[layer]) == sorted(sites) == sorted(
            ("wq", "wk", "wv", "wo"))
        for site, cell in sites.items():
            g = got[layer][site]
            for k in ("gated_gemms", "decode_gated_gemms",
                      "gemm_bytes_moved"):
                assert g[k] == cell[k], (layer, site, k)
            for k in ("valid_fraction", "decode_valid_fraction"):
                assert g[k] == pytest.approx(cell[k], abs=VF_TOL)
    for k in ("gated_gemms", "decode_gated_gemms", "gemm_bytes_moved",
              "decode_gemm_bytes_moved", "compute_dtype"):
        assert sp[k] == rsp[k], k
    for k in ("valid_fraction", "decode_valid_fraction"):
        assert sp[k] == pytest.approx(rsp[k], abs=VF_TOL)
    (cells, sums), (rcells, rsums) = (_registry_cells(e.obs.registry)
                                      for e in (eng, reng))
    assert cells == rcells
    assert sorted(sums) == sorted(rsums)
    for k, v in rsums.items():
        assert sums[k] == pytest.approx(v, abs=VF_TOL * cells[
            k.replace("_sum", "_count")])
    # the MoE block's taps: layer -1, once per gated block call (each
    # prefill or chunk step; decode runs dense experts)
    minus1 = {k: v for k, v in cells.items()
              if k.startswith("spamm_gated_gemms_total")
              and 'layer="-1"' in k}
    calls = eng.cfg.num_layers * (eng.chunk_steps if plane == "chunked"
                                  else 1)
    n_exp = 1 if run == "bmm" else eng.cfg.moe.num_experts
    shared = 3 if eng.cfg.moe.num_shared else 0
    assert sum(minus1.values()) == calls * (3 * n_exp + shared)
    assert sum(v for k, v in minus1.items() if 'site="moe_bmm"' in k) == (
        3 * calls if run == "bmm" else 0)
    assert eng.gm_histogram == reng.gm_histogram
    for phase, c in rsp["cost_residual"].items():
        assert sp["cost_residual"][phase]["predicted_s"] == pytest.approx(
            c["predicted_s"], rel=1e-6)
    assert rsp["plan_cache_hits"] == rsp["plan_cache_misses"] == 0
    assert sp["plan_cache_hits"] + sp["plan_cache_misses"] > 0


# ---------------------------------------------------------------------------
# step graphs: the capture decision and the static-buffer discipline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gated", [False, True], ids=["dense", "gated"])
def test_chunk_capture_is_decided_from_the_config(setup, monkeypatch, gated):
    """A MoE stack's chunk steps are captured with SpAMM off and run
    eagerly with SpAMM on (their expert and shared-expert GEMMs plan on
    the host); decode steps are captured either way. Read with the
    engine's capture mode forced on, as on the card."""
    _, _, cfg, _, _, params = setup
    eng = _port_engine(cfg, params, "chunked", 0.0 if gated else None, True)
    assert eng.step_graphs == {"decode": False, "chunk": False}
    monkeypatch.setattr(Engine, "_capture", property(lambda self: True))
    assert eng.step_graphs == {"decode": True, "chunk": not gated}
    if gated:
        assert eng._chunk_step(2, TILE).capture is False
    dense = get_config("starcoder2-7b").reduced()
    dparams = M.init_params(dense, PCFG, 0, device="cpu")
    deng = Engine(dense, PCFG, dparams, max_len=MAX_LEN, device="cpu",
                  spamm_cfg=SpammConfig(enable=True, tau=0.0, tile=TILE))
    assert deng.step_graphs == {"decode": True, "chunk": True}


def _clone_cache(cache):
    return {"layers": [{n: c[n].clone() for n in ("k", "v")}
                       for c in cache["layers"]]}


@pytest.mark.parametrize("kind", ["wave_decode", "slot_decode", "chunk"])
def test_captured_callable_reads_its_static_buffers(setup, kind):
    """(f) The exact callable the engine captures for a MoE stack — the
    decode steps at SpAMM on (dense experts, frozen attention gates), the
    chunk step at SpAMM off — called twice with its static buffers updated
    in place between the calls: the second call equals a fresh call of the
    step function at the new inputs, logits and cache bit for bit (no
    position, token, capacity or routing table is baked in)."""
    _, _, cfg, _, _, params = setup
    tau = None if kind == "chunk" else 0.05
    eng = _port_engine(cfg, params, "chunked", tau, True)
    b = 2
    rng = np.random.default_rng(11)
    tok = lambda *shape: rng.integers(1, cfg.vocab, shape).astype(np.int32)
    if kind == "wave_decode":
        step, key = eng._wave_decode_step(b), ("wave", b)
        calls = [dict(tokens=tok(b, 1), pos=np.int32(9)),
                 dict(tokens=tok(b, 1), pos=np.int32(10))]
    elif kind == "slot_decode":
        step, key = eng._slot_decode_step(b), ("slots", b)
        calls = [dict(tokens=tok(b, 1), positions=np.array([9, MAX_LEN])),
                 dict(tokens=tok(b, 1), positions=np.array([10, 3]))]
    else:
        step, key = eng._chunk_step(b, TILE), ("slots", b)
        p0 = np.tile(np.arange(TILE, dtype=np.int32), (b, 1))
        p1 = np.full((b, TILE), MAX_LEN, np.int32)
        p1[0, :7] = TILE + np.arange(7)
        calls = [dict(tokens=tok(b, TILE), positions=p0,
                      last_idx=np.array([TILE - 1, 4])),
                 dict(tokens=tok(b, TILE), positions=p1,
                      last_idx=np.array([6, -1]))]
    cache = eng._caches[key]
    gen = torch.Generator().manual_seed(1)
    for c in cache["layers"]:
        for n in ("k", "v"):
            c[n].copy_(torch.randn(c[n].shape, generator=gen))
    body, inputs = step.body, step.inputs
    with torch.inference_mode():
        for name, v in calls[0].items():
            inputs[name].copy_(torch.as_tensor(np.asarray(v)).reshape(
                inputs[name].shape))
        body()
        fresh = _clone_cache(cache)
        for name, v in calls[1].items():
            inputs[name].copy_(torch.as_tensor(np.asarray(v)).reshape(
                inputs[name].shape))
        got = body()["logits"].clone()
        new = {k: torch.as_tensor(np.asarray(v)) for k, v in calls[1].items()}
        if kind == "chunk":
            _, want = eng._chunk(params, {"tokens": new["tokens"]}, fresh,
                                 new["positions"], new["last_idx"],
                                 eng._frozen_for(b * TILE))
        else:
            pos = new["pos"] if kind == "wave_decode" else new["positions"]
            want, _ = eng._decode(params, new["tokens"], fresh, pos,
                                  eng._frozen_for(b))
    assert torch.equal(got, want)
    for ca, cb in zip(cache["layers"], fresh["layers"]):
        for n in ("k", "v"):
            assert torch.equal(ca[n], cb[n])


def test_serve_and_precompute_clis_take_the_moe_archs(tmp_path, capsys):
    """`--arch qwen2-moe-a2.7b` and `--arch mixtral-8x22b` run through the
    serve CLI (wave at τ = 0 equal to the dense run's tokens; mixed lengths
    through the chunked plane) and the precompute CLI (attention weights
    only)."""
    from repro_torch.launch import precompute_plans, serve

    def tokens(argv):
        serve.main(argv)
        return [ln for ln in capsys.readouterr().out.splitlines()
                if ln.strip().startswith("req")]

    base = ["--arch", "qwen2-moe-a2.7b", "--reduced", "--device", "cpu",
            "--num-requests", "2", "--prompt-len", "16", "--max-new", "3"]
    dense = tokens(base)
    assert dense and dense == tokens(base + ["--spamm-tau", "0.0",
                                             "--spamm-tile", "16"])
    mixed = tokens(["--arch", "mixtral-8x22b", "--reduced", "--device",
                    "cpu", "--num-requests", "3", "--prompt-len", "24",
                    "--max-new", "2", "--mixed-lengths", "--prefill-chunk",
                    "16", "--spamm-tau", "0.0", "--spamm-tile", "16"])
    assert len(mixed) == 3
    precompute_plans.main(["--arch", "qwen2-moe-a2.7b", "--reduced",
                           "--device", "cpu", "--plan-store",
                           str(tmp_path / "store"), "--tau", "0.05",
                           "--spamm-tile", "16"])
    out = capsys.readouterr().out
    assert "precomputed 8 weight plans" in out
