"""The port's model parallelism (`models.parallel`, the placements of
`models.model`, `NetCtx`, the sharded MoE block, `distributed.elastic`) on
4 gloo CPU ranks: one module-scoped spawn runs every job (a few seconds
each) on (data, model) meshes 1×4, 2×2 and 4×1, and the test process
holds the ranks' results against the reference's unsharded functions on
the same weights (`params_from_jax`) and inputs, or against the port on
one device.

Tolerances (f32; relative to the compared array's largest magnitude):
logits, hidden states and MoE outputs within 1e-5 (row-parallel partial
sums are added over the ranks, not in the one-device kernel's k order);
losses within 1e-5 relative; after two train steps the first moments
within 1e-5 (int8_ef 1e-2), the parameters within 2e-4 absolute (see
PARAM_ATOL) and the int8_ef residuals within EF_RTOL; an elastic re-shard
and the frozen plans' tables exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ParallelConfig as RParallel
from repro.configs import get_config as rget_config
from repro.launch.mesh import make_ctx as rmake_ctx
from repro.launch.mesh import make_host_mesh, make_mesh as rmake_mesh
from repro.models import model as RM
from repro.models import moe as rmoe
from repro.serving.engine import Engine as REngine
from repro_torch import tree as T
from repro_torch.configs import (ParallelConfig, SpammConfig, TrainConfig,
                                 get_config)
from repro_torch.core.module import SpammContext
from repro_torch.core.schedule import ReshardConfig
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamW
from repro_torch.distributed.compression import Int8EF
from repro_torch.plans.precompute import freeze_tree

import torch_dist_workers as W

TILE = 16
MOE_TILE = 8
B, PLEN, NDEC, MAX_LEN = 4, 16, 3, 32
MESHES = ((1, 4), (2, 2), (4, 1))
RTOL = 1e-5
# parameters after two steps: a fifth of one AdamW step (lr 1e-3). The
# gradients agree to ~1e-6 of each leaf's scale, but AdamW divides every
# element by its own magnitude, so an element whose gradient sits at the
# rounding level of the reordered sums (and, with int8_ef, one whose
# quantized level flips) moves by up to a step
PARAM_ATOL = 2e-4
# first moments after two steps, relative to each leaf's largest: the
# gradients' agreement; int8_ef: an element whose level flips moves its
# moment by (1 - b1) · max|g| / 127, about 1e-2 of the moment's largest
MU_RTOL = {False: 1e-5, True: 1e-2}
# int8_ef residuals after two steps, ‖Δ‖ / ‖ef‖ over the whole tree: the
# leaves agree to ≈ 1e-4 but for the few elements whose quantized level
# flips, by a whole level (1.7e-2 in all); a scale taken over one shard
# instead of the whole leaf re-grids every residual (≈ 1.2)
EF_RTOL = 0.1
TAU = 0.05             # starcoder2's gate τ at τ > 0 (checked off ties)
RPCFG = RParallel(compute_dtype="float32", remat="none", attn_q_chunk=8,
                  attn_kv_chunk=8, loss_chunk=8, decode_seq_shard=False)
# the sharded runs: SP in prefill and seq-sharded decode
PCFG = ParallelConfig(attn_q_chunk=8, remat="none", loss_chunk=8,
                      decode_seq_shard=True, seq_shard_acts=True)
PCFG_ONE = ParallelConfig(attn_q_chunk=8, remat="none", loss_chunk=8)
TRAIN_PCFG = ParallelConfig(attn_q_chunk=8, remat="full", loss_chunk=8)
TRAIN_PCFG_SP = dataclasses.replace(TRAIN_PCFG, seq_shard_acts=True)
TCFG = TrainConfig(lr=1e-3, warmup=1, total_steps=10, weight_decay=0.1)
SERVE_ARCHS = ("starcoder2-7b", "granite-34b", "mamba2-1.3b",
               "recurrentgemma-9b")
SERVE_MESH = {"granite-34b": (1, 4), "mamba2-1.3b": (2, 2),
              "recurrentgemma-9b": (2, 2)}


def _model(arch, **moe):
    rcfg, cfg = rget_config(arch).reduced(), get_config(arch).reduced()
    if moe:
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(rcfg.moe,
                                                                 **moe))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
    return rcfg, cfg


def _params(rcfg, cfg, model_axis_size=1, seed=0):
    rp = RM.init_params(rcfg, RPCFG, jax.random.key(seed),
                        model_axis_size=model_axis_size)
    return rp, M.params_from_jax(jax.tree.map(np.asarray, rp), cfg,
                                 device="cpu")


def _tokens(cfg, seed, b=B, s=PLEN, n=NDEC):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab, size=(b, s + 1)).astype(np.int64)
    dec = rng.integers(1, cfg.vocab, size=(b, n)).astype(np.int64)
    return toks[:, :-1], toks[:, 1:].copy(), dec


def _spamm(tau):
    return SpammConfig(enable=True, tau=tau, tile=TILE, backend="torch")


SETUP = {}
LOOP_JOB = {}
LOOP_SPAMM = {}
LOOP_TCFG = TrainConfig(lr=1e-3, warmup=1, total_steps=3, ckpt_every=2)
LOOP_DIR = None


def _jobs():
    jobs = []
    rcfg, cfg = _model("starcoder2-7b")
    rp, params = _params(rcfg, cfg)
    tok, lab, dec = _tokens(cfg, 0)
    SETUP["starcoder2-7b"] = (rcfg, cfg, rp, params, tok, lab, dec)
    for shape in MESHES:
        jobs.append(("serve", dict(cfg=cfg, pcfg=PCFG, params=params,
                                   tokens=tok, labels=lab, dec_tokens=dec,
                                   max_len=MAX_LEN, shape=shape, tile=TILE)))
    jobs.append(("serve", dict(cfg=cfg, pcfg=PCFG, params=params, tokens=tok,
                               labels=lab, dec_tokens=dec, max_len=MAX_LEN,
                               shape=(2, 2), tile=TILE, spamm=_spamm(TAU),
                               freeze=True)))
    for arch in SERVE_ARCHS[1:]:
        rc, c = _model(arch)
        r, p = _params(rc, c)
        t, l, d = _tokens(c, 1)
        SETUP[arch] = (rc, c, r, p, t, l, d)
        jobs.append(("serve", dict(cfg=c, pcfg=PCFG, params=p, tokens=t,
                                   labels=l, dec_tokens=d, max_len=MAX_LEN,
                                   shape=SERVE_MESH[arch], tile=TILE)))
    batches = [_tokens(cfg, 10 + i, s=PLEN)[:2] for i in range(2)]
    elastic = _tokens(cfg, 20, b=6, s=PLEN)[:2]
    SETUP["train"] = batches, elastic
    for comp in (False, True):
        jobs.append(("train", dict(
            cfg=cfg, pcfg=TRAIN_PCFG, params=params, batches=batches,
            tcfg=TCFG, shape=(2, 2), tile=TILE, compression=comp,
            elastic_batch=None if comp else elastic)))
    # the train loop over 2×2 with checkpoints, then resumed (appended
    # last: its index is -1)
    LOOP_JOB.update(cfg=cfg, pcfg=TRAIN_PCFG, tcfg=LOOP_TCFG, shape=(2, 2),
                    tile=TILE, batch=4, seq=PLEN)
    LOOP_SPAMM.update(cfg=cfg, pcfg=TRAIN_PCFG, tcfg=LOOP_TCFG,
                      shape=(2, 2), tile=TILE, batch=4, seq=PLEN,
                      spamm=SpammConfig(enable=True, tau=0.0, tile=TILE,
                                        backend="torch", bwd="spamm"),
                      reshard=ReshardConfig(every=1))
    # MoE: 6 experts (EP pads them to 8 over 4 model ranks)
    for impl in ("tp", "ep"):
        rc, c = _model("qwen2-moe-a2.7b", num_experts=6, impl=impl)
        r, p = _params(rc, c, model_axis_size=4)
        x = np.random.default_rng(5).standard_normal(
            (B, PLEN, c.d_model)).astype(np.float32)
        SETUP["moe", impl] = (rc, c, r, p, x)
        for shape in ((1, 4), (2, 2)):
            jobs.append(("moe", dict(cfg=c, pcfg=PCFG_ONE, params=p, x=x,
                                     shape=shape, tile=MOE_TILE)))
        jobs.append(("moe", dict(
            cfg=c, pcfg=PCFG_ONE, params=p, x=x, shape=(1, 4),
            tile=MOE_TILE, spamm=SpammConfig(enable=True, tau=0.02,
                                             tile=MOE_TILE, backend="torch",
                                             moe_bmm=True))))
    # two train steps under Megatron-SP (appended after the MoE jobs)
    SETUP["train_sp"] = len(jobs)
    jobs.append(("train", dict(
        cfg=cfg, pcfg=TRAIN_PCFG_SP, params=params, batches=batches,
        tcfg=TCFG, shape=(2, 2), tile=TILE)))
    SETUP["init"] = len(jobs)
    jobs.append(("init", dict(cfg=cfg, pcfg=TRAIN_PCFG, shape=(2, 2),
                              tile=TILE)))
    jobs.append(("loop", dict(LOOP_SPAMM, ckpt_dir=str(LOOP_DIR / "s"))))
    jobs.append(("loop", dict(LOOP_JOB, ckpt_dir=str(LOOP_DIR))))
    return jobs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """[job results per rank] of the one 4-rank spawn."""
    global LOOP_DIR
    LOOP_DIR = tmp_path_factory.mktemp("tp_loop")
    jobs = _jobs()
    out = spawn_ranks(W.tp_jobs, 4, backend="gloo", args=(jobs,),
                      timeout_s=300)
    kinds = [k for k, _ in jobs]
    return kinds, out


def _job(ranks, i):
    return [r[i] for r in ranks[1]]


def _rows(results, key, shape, i=None):
    """A per-rank array gathered back into the global batch (one model
    rank's copy per data rank)."""
    got = {}
    for r in results:
        if r["mrank"] == 0:
            v = r[key] if i is None else r[key][i]
            got[r["data_index"]] = v
    return np.concatenate([got[d] for d in sorted(got)])


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rtol * max(scale, 1e-30), (err, scale)


def _ref_ctx():
    return rmake_ctx(make_host_mesh())


def _ref_serve(arch):
    rcfg, cfg, rp, _, tok, lab, dec = SETUP[arch]
    ctx = _ref_ctx()
    rb = {"tokens": jnp.asarray(tok, jnp.int32),
          "labels": jnp.asarray(lab, jnp.int32)}
    loss, _ = RM.loss_fn(rcfg, RPCFG, ctx, rp, rb)
    h, _ = RM.forward_hidden(rcfg, RPCFG, ctx, rp, rb)
    rpc, logits = RM.make_prefill_step(rcfg, RPCFG, ctx)(rp, rb)
    reng = REngine(rcfg, RPCFG, ctx, rp, max_len=MAX_LEN)
    cache = reng._pad_cache(rpc)
    step = RM.make_decode_step(rcfg, RPCFG, ctx)
    decs = []
    for i in range(dec.shape[1]):
        lg, cache = step(rp, jnp.asarray(dec[:, i:i + 1], jnp.int32), cache,
                         jnp.int32(PLEN + i))
        decs.append(np.asarray(lg))
    return float(loss), np.asarray(h), np.asarray(logits), decs


@pytest.fixture(scope="module")
def ref_serve():
    return {arch: _ref_serve(arch) for arch in SERVE_ARCHS}


@pytest.mark.parametrize("mi", range(len(MESHES)),
                         ids=[f"{d}x{m}" for d, m in MESHES])
def test_tp_forward_and_loss_match_reference(ranks, ref_serve, mi):
    res = _job(ranks, mi)
    loss, h, _, _ = ref_serve["starcoder2-7b"]
    for r in res:
        assert abs(r["loss"] - loss) <= RTOL * abs(loss)
    _close(_rows(res, "h", MESHES[mi]), h)


@pytest.mark.parametrize("mi", range(len(MESHES)),
                         ids=[f"{d}x{m}" for d, m in MESHES])
def test_sp_prefill_and_seq_sharded_decode_match_reference(ranks, ref_serve,
                                                           mi):
    """Prefill under Megatron-SP, then decode steps on the sequence-sharded
    cache (flash-decoding merge over "model"), against the reference's
    unsharded prefill and decode."""
    res = _job(ranks, mi)
    _, _, logits, decs = ref_serve["starcoder2-7b"]
    _close(_rows(res, "prefill", MESHES[mi]), logits)
    for i, want in enumerate(decs):
        _close(_rows(res, "decode", MESHES[mi], i), want)


@pytest.mark.parametrize("arch", SERVE_ARCHS[1:])
def test_gqa_and_recurrent_families_match_reference(ranks, ref_serve, arch):
    """granite (one kv head over 4 model ranks), mamba2 and
    recurrentgemma (their recurrent blocks gathered whole) under model >
    1: loss, prefill and seq-sharded decode against the reference."""
    i = len(MESHES) + 1 + SERVE_ARCHS[1:].index(arch)
    res = _job(ranks, i)
    loss, h, logits, decs = ref_serve[arch]
    shape = SERVE_MESH[arch]
    for r in res:
        assert abs(r["loss"] - loss) <= RTOL * abs(loss)
    _close(_rows(res, "h", shape), h)
    _close(_rows(res, "prefill", shape), logits)
    for k, want in enumerate(decs):
        _close(_rows(res, "decode", shape, k), want)


def _gated_one_device():
    """The port on one device at τ > 0: prefill taps, frozen decode logits
    and taps, and the whole weights' frozen tables."""
    _, cfg, _, params, tok, lab, dec = SETUP["starcoder2-7b"]
    sc = SpammContext(_spamm(TAU))
    with torch.no_grad():
        out = {}
        fw, _ = freeze_tree(M.compute_params(params, cfg, None), sc.cfg)
        out["tables"] = W._fw_tables(fw)
        # the data ranks' prefills: 2 rows each
        out["prefill_taps"] = []
        for d in range(2):
            sc.begin_stats()
            M.make_prefill_step(cfg, PCFG_ONE, spamm_cfg=sc)(
                params, {"tokens": torch.from_numpy(tok[2 * d:2 * d + 2])})
            out["prefill_taps"].append([t.value for t in sc.end_stats()])
        frozen = W._specialize(fw, 1)
        cache, _ = M.make_prefill_step(cfg, PCFG_ONE)(
            params, {"tokens": torch.from_numpy(tok)})
        cache = M.place_cache(cache, cfg, PCFG_ONE, MAX_LEN)
        step = M.make_decode_step(cfg, PCFG_ONE, spamm_cfg=sc)
        out["decode"] = []
        for i in range(dec.shape[1]):
            lg, cache = step(params, torch.from_numpy(dec[:, i:i + 1]),
                             cache, PLEN + i, frozen)
            out["decode"].append(lg.numpy())
    return out


def test_tp_frozen_plans_are_the_global_plans_slices(ranks):
    """Each rank freezes its own weight slices; every table is the whole
    weight's restricted to the slice: wq/wk/wv/w1 on their column tiles,
    wo/w2 on their row tiles."""
    res = _job(ranks, len(MESHES))
    full = _gated_one_device()["tables"]
    for r in res:
        m = r["mrank"]
        for (li, part, name), (nb, kk, jj) in r["frozen_tables"].items():
            gnb, gkk, gjj = full[li, part, name]
            if name in ("wo", "w2"):
                lo, hi = m * nb.shape[0], (m + 1) * nb.shape[0]
                np.testing.assert_array_equal(nb, gnb[lo:hi])
                sel = (gkk >= lo) & (gkk < hi)
                np.testing.assert_array_equal(kk, gkk[sel] - lo)
                np.testing.assert_array_equal(jj, gjj[sel])
            else:
                lo, hi = m * nb.shape[1], (m + 1) * nb.shape[1]
                np.testing.assert_array_equal(nb, gnb[:, lo:hi])
                sel = (gjj >= lo) & (gjj < hi)
                np.testing.assert_array_equal(jj, gjj[sel] - lo)
                np.testing.assert_array_equal(kk, gkk[sel])


def test_tp_gated_prefill_fraction_is_global_and_decode_matches(ranks):
    """At τ > 0 on 2×2: each split GEMM's tapped fraction is the whole
    GEMM's (the ranks' counts summed before the division), equal to the
    one-device port's on the data rank's rows; frozen decode logits equal
    the one-device port's within tolerance."""
    res = _job(ranks, len(MESHES))
    one = _gated_one_device()
    for r in res:
        assert r["prefill_taps"] == pytest.approx(
            one["prefill_taps"][r["data_index"]], abs=1e-7)
    for i, want in enumerate(one["decode"]):
        _close(_rows(res, "decode", (2, 2), i), want)


def _train_one(compression):
    """Two steps of the one-device port: (losses, params, optimizer
    state)."""
    _, cfg, _, params, *_ = SETUP["starcoder2-7b"]
    batches, _ = SETUP["train"]
    p = T.map_(lambda t: t.clone(), params)
    opt = AdamW(TCFG, compression=Int8EF() if compression else None)
    state = opt.init(p)
    step = M.make_train_step(cfg, TRAIN_PCFG, opt)
    losses = []
    for i, (tok, lab) in enumerate(batches):
        p, state, met = step(p, state, {"tokens": torch.from_numpy(tok),
                                        "labels": torch.from_numpy(lab)}, i)
        losses.append(float(met["loss"]))
    return losses, p, state


@pytest.mark.parametrize("compression", [False, True, "sp"],
                         ids=["adamw", "int8_ef", "adamw_sp"])
def test_tp_fsdp_train_steps_match_one_device(ranks, compression):
    """Two steps on a 2×2 mesh (FSDP over data, TP over model, remat
    full; "sp": under Megatron-SP, whose norms see only the rank's
    sequence chunk): the global loss, the gathered parameters, first
    moments and int8_ef residuals against the one-device port's two
    steps."""
    if compression == "sp":
        i, compression = SETUP["train_sp"], False
    else:
        i = len(MESHES) + len(SERVE_ARCHS) + int(compression)
    res = _job(ranks, i)
    losses, p, state = _train_one(compression)
    for r in res:
        assert r["losses"] == pytest.approx(losses, rel=RTOL)
    for (path, a), (_, b) in zip(T.flatten_with_paths(res[0]["params"]),
                                 T.flatten_with_paths(p)):
        err = float(np.abs(a - b.detach().numpy()).max())
        assert err <= PARAM_ATOL, (path, err)
    for (path, a), (_, b) in zip(T.flatten_with_paths(res[0]["mu"]),
                                 T.flatten_with_paths(state["mu"])):
        _close(a, b.numpy(), MU_RTOL[compression])
    if compression:
        got = np.concatenate([a.ravel() for a in T.leaves(res[0]["ef"])])
        want = np.concatenate([b.numpy().ravel()
                               for b in T.leaves(state["ef"])])
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err <= EF_RTOL, err


def test_sharded_init_is_the_whole_init_cut(ranks):
    """`init_params(ctx=)` on 2×2 (each piece cut as soon as it is made)
    gives every rank `shard_params` of the whole init bit for bit, and a
    checkpoint's gather leaves the whole tree on the writing rank alone."""
    res = _job(ranks, SETUP["init"])
    for r in res:
        assert r["same"] and r["dropped"]
    assert res[0]["whole"]


def test_elastic_reshard_is_bitwise_and_steps(ranks):
    """The 2×2 state moves onto ranks 0-2: best_mesh_shape(3, 2) = (3,
    1); params and both moments re-gathered there equal the state bit for
    bit, and a step on the new mesh gives a finite global loss."""
    i = len(MESHES) + len(SERVE_ARCHS)
    res = _job(ranks, i)
    for r in res[:3]:
        assert r["elastic_shape"] == (3, 1)
        assert r["elastic_bitwise"]
        assert np.isfinite(r["elastic_loss"])
    assert len({r["elastic_loss"] for r in res[:3]}) == 1
    assert "elastic_loss" not in res[3]


def _moe_index(impl, k):
    return len(MESHES) + len(SERVE_ARCHS) + 2 + 3 * ("tp", "ep").index(
        impl) + k


def _ref_moe(impl):
    """The reference's moe_block on a 1×1 mesh applied to each data
    shard's rows: {ndata: y}."""
    rc, c, rp, _, x = SETUP["moe", impl]
    mesh = rmake_mesh((1, 1), ("data", "model"))
    p0 = jax.tree.map(lambda t: t[0], rp["layers"]["moe"])
    out = {}
    for nd in (1, 2):
        w = B // nd
        ys = []
        for d in range(nd):
            with mesh:
                y, _ = jax.jit(lambda p, xx: rmoe.moe_block(
                    p, xx, rc.moe, rc.act, mesh=mesh))(
                        p0, jnp.asarray(x[d * w:(d + 1) * w]))
            ys.append(np.asarray(y))
        out[nd] = np.concatenate(ys)
    return out


@pytest.mark.parametrize("impl", ["tp", "ep"])
def test_moe_split_matches_reference_per_data_shard(ranks, impl):
    """impl tp (ff over "model") and ep (6 experts padded to 8 over 4
    model ranks) on 1×4 and 2×2: each against the reference's block
    applied to each data shard's tokens."""
    want = _ref_moe(impl)
    for k, (nd, _) in enumerate(((1, 4), (2, 2))):
        res = _job(ranks, _moe_index(impl, k))
        got = {}
        for r in res:
            got.setdefault(r["data_index"], r["y"])
        _close(np.concatenate([got[d] for d in sorted(got)]), want[nd])


def test_moe_tp_equals_ep(ranks):
    """tp ≡ ep on the same tokens and experts, dense and gated (τ > 0,
    the batched dense-grid gate `moe_bmm`) on 1×4."""
    for k in range(3):
        a = _job(ranks, _moe_index("tp", k))
        b = _job(ranks, _moe_index("ep", k))
        for ra, rb in zip(a, b):
            _close(ra["y"], rb["y"])
            assert ra["aux"] == pytest.approx(rb["aux"], rel=1e-6)


def test_ep_params_pad_like_the_reference():
    rc, c, rp, p, _ = SETUP["moe", "ep"]
    assert rp["layers"]["moe"]["w1"].shape[1] == 8
    assert p["layers"][0]["moe"]["w1"].shape[0] == 8
    own = M.init_params(c, PCFG_ONE, 0, device="cpu", model_axis_size=4)
    assert T.map_(lambda t: tuple(t.shape), own) == \
        T.map_(lambda t: tuple(t.shape), p)


@pytest.mark.parametrize("which", ["dense", "spamm"])
def test_train_loop_over_the_mesh_resumes_from_its_checkpoint(ranks,
                                                              tmp_path,
                                                              which):
    """`train(ctx=)` on 2×2: each data rank's rows of the global batch, the
    global loss equal to the one-device loop's; the checkpoint (the whole
    tree, written by data 0 / model 0) resumes onto the mesh and the run
    continues as the one-device loop does. "spamm": τ = 0 with
    bwd="spamm" and the re-sharding probe every step (the probe gathers
    the embedding and unembedding): the per-layer gating stats of every
    step are the one-device loop's (a split GEMM reports the whole
    GEMM's fraction)."""
    import dataclasses

    from repro_torch.train.loop import train

    res = _job(ranks, -1 if which == "dense" else -2)
    j = LOOP_JOB if which == "dense" else LOOP_SPAMM
    tcfg = dataclasses.replace(j["tcfg"], ckpt_dir=str(tmp_path))
    kw = dict(global_batch=j["batch"], seq_len=j["seq"], log_every=0,
              device="cpu", spamm_cfg=j.get("spamm"),
              reshard_cfg=j.get("reshard"))
    one = train(j["cfg"], j["pcfg"], tcfg, **kw)
    more = train(j["cfg"], j["pcfg"], dataclasses.replace(
        tcfg, total_steps=tcfg.total_steps + 2), resume=True, **kw)
    for r in res:
        assert r["losses"] == pytest.approx(one.losses, rel=RTOL)
        assert r["restarts"] == more.restarts == 1
        assert r["resumed"] == pytest.approx(more.losses, rel=RTOL)
        assert len(r["spamm_stats"]) == len(one.spamm_stats)
        for got, want in zip(r["spamm_stats"], one.spamm_stats):
            assert got["gated_gemms"] == want["gated_gemms"]
            assert got["per_layer"] == want["per_layer"]
            if which == "spamm":
                assert got["imbalance"] is not None
