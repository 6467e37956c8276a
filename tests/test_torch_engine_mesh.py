"""The port's serving engine over a model axis (`Engine(ctx=)`) and its
legacy path (`Engine(freeze_plans=False)`), against the reference's
`Engine` on its host mesh with the same weights (`params_from_jax`).

One module-scoped spawn of 4 gloo CPU ranks runs every job
(`torch_dist_workers.engine_mesh_jobs`): reduced starcoder2-7b and reduced
qwen2-moe-a2.7b (experts split tp, then ep) at model 2 (a 2×2 mesh whose
"data" rows are replicas: no batch axis) and model 4, on the wave plane
(seq-sharded decode cache) and the chunked plane (kv-head linear cache,
queued admission), at τ = 0 and at a τ in a gap of every gate product.
The reference runs the MoE block at impl "ep" on its one device, where tp
and ep compute the same function.

Compared: tokens equal on every rank; `out["spamm"]`'s per-layer cells
equal the reference's exactly, and every aggregate (the MoE block's
layer -1 taps included) equals the unsharded port engine's exactly;
prefill logits within 1e-5 of the reference's and the wave's last decode
logits within 1e-5 of the unsharded port's (relative to the largest
magnitude: the row-parallel sums over the ranks reassociate). The
unsharded runs' smallest top-2 logit margin over every emitted token is
held above 10× that tolerance, so a token that differs points at a
fault, not at a near-tie."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ParallelConfig as RParallel
from repro.configs import SpammConfig as RSpamm
from repro.configs import get_config as rget_config
from repro.launch.mesh import make_ctx, make_host_mesh
from repro.models import model as RM
from repro.serving.engine import Engine as REngine
from repro.serving.engine import Request as RRequest
from repro_torch.configs import ParallelConfig, SpammConfig, get_config
from repro_torch.core import plan as tplan
from repro_torch.launch.mesh import free_port, spawn_ranks
from repro_torch.models import model as M
from repro_torch.serving.engine import Engine, Request

import torch_dist_workers as W

TILE = 16
B, PLEN, MAX_NEW, MAX_LEN = 4, 16, 4, 64
QUEUE_MIX = (5, 16, 23, 9)           # the chunked plane: 2 slots, queued
CHUNKED = {"prefill_chunk": TILE, "max_slots": 2}
RTOL = 1e-5
# every gate product at least this far from τ (relative): far above the
# ~1e-6 gap between the packages' f32 norms
GATE_MARGIN = 1e-3
MODELS = (2, 4)
PLANES = ("wave", "chunked")
FAMILIES = ("dense", "moe_tp", "moe_ep")
ARCH = {"dense": "starcoder2-7b", "moe_tp": "qwen2-moe-a2.7b",
        "moe_ep": "qwen2-moe-a2.7b"}
RPCFG = RParallel(compute_dtype="float32", remat="none", attn_q_chunk=8,
                  attn_kv_chunk=8, decode_seq_shard=False)
# fsdp off: serving places nothing on "data"; decode_seq_shard on: the
# wave's decode cache is each rank's sequence slice
PCFG = ParallelConfig(compute_dtype="float32", attn_q_chunk=8, fsdp=False,
                      decode_seq_shard=True)


def _prompts(cfg, plane, seed=0):
    rng = np.random.default_rng(seed)
    if plane == "wave":
        return list(rng.integers(1, cfg.vocab, size=(B, PLEN)).astype(
            np.int32))
    return [rng.integers(1, cfg.vocab, n).astype(np.int32)
            for n in QUEUE_MIX]


def _kw(plane):
    return {} if plane == "wave" else dict(CHUNKED)


def _family(fam):
    rcfg, cfg = rget_config(ARCH[fam]).reduced(), get_config(ARCH[fam]
                                                              ).reduced()
    if fam.startswith("moe"):
        impl = fam[4:]
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
            rcfg.moe, impl="ep"))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, impl=impl))
    return rcfg, cfg


class _Products:
    """Every gate product the port's plans evaluate while active: the
    eager flat gate, the batched gate and the frozen device gate."""

    def __init__(self, mp):
        self.got = []
        self.dec = []       # the decode steps' (one row tile's) products
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
            if fp.gm == 1:
                self.dec.append(self.got[-1])
            return p

        mp.setattr(tplan, "_flat_triples_host", rec_flat)
        mp.setattr(tplan, "gate_mask", rec_mask)
        mp.setattr(tplan, "_plan_frozen", rec_frozen)

    def all(self):
        p = np.concatenate([np.asarray(x, np.float64).ravel()
                            for x in self.got])
        return p[p > 0]


def _gap(p, lo, hi):
    p = np.sort(p)
    a, b = int(lo * p.size), int(hi * p.size)
    g = a + int(np.argmax(p[a + 1:b + 1] / p[a:b]))
    return float(np.sqrt(p[g] * p[g + 1]))


def _gap_tau(run):
    """A τ inside a gap of every gate product `run(tau)` evaluates, every
    product at least GATE_MARGIN away, re-checked on the run at that τ
    (downstream products move with the gate). The gap is sought among the
    decode steps' products first (then among every product below most of
    them), so that decode keeps part of its tiles."""
    with pytest.MonkeyPatch.context() as mp:
        rec = _Products(mp)
        run(0.0)
        dec = np.concatenate(rec.dec)
        tau = _gap(dec, 0.35, 0.65)
        for _ in range(6):
            rec.got.clear()
            rec.dec.clear()
            run(tau)
            allp = rec.all()
            margin = float(np.min(np.abs(allp - tau)) / tau)
            if margin >= GATE_MARGIN:
                return tau
            tau = _gap(allp[allp < np.percentile(dec, 80)], 0.3, 0.9)
    raise AssertionError(f"no gap of relative width {GATE_MARGIN}: "
                         f"{tau}, {margin}")


def _spamm(tau):
    return SpammConfig(enable=True, tau=tau, tile=TILE)


def _margins(eng):
    """Wrap the engine's step functions to record, per step, the smallest
    top-2 margin of the rows whose token is emitted, relative to the
    step's largest logit."""
    got = []

    def note(lg, live=None):
        lg = lg.float()
        if live is not None:
            lg = lg[live]
        if lg.shape[0]:
            top = lg.topk(2, dim=-1).values
            got.append(float((top[:, 0] - top[:, 1]).min()
                             / lg.abs().max()))

    pre, dec, chunk = eng._prefill, eng._decode, eng._chunk

    def w_pre(*a):
        cache, lg = pre(*a)
        note(lg)
        return cache, lg

    def w_dec(params, inp, cache, pos, frozen):
        lg, c = dec(params, inp, cache, pos, frozen)
        note(lg, None if not torch.is_tensor(pos) or not pos.dim()
             else pos < eng.max_len)
        return lg, c

    def w_chunk(params, batch, cache, positions, last_idx, frozen):
        c, lg = chunk(params, batch, cache, positions, last_idx, frozen)
        note(lg, last_idx >= 0)
        return c, lg

    # one device: the slot decode is the wave's decode function
    eng._prefill, eng._decode, eng._chunk = w_pre, w_dec, w_chunk
    eng._slot_decode = w_dec
    return got


def _port(cfg, params, plane, tau, margins=False):
    eng = Engine(cfg, PCFG, params, max_len=MAX_LEN, device="cpu",
                 spamm_cfg=None if tau is None else _spamm(tau),
                 **_kw(plane))
    got = _margins(eng) if margins else None
    reqs = [Request(prompt=p, max_new_tokens=MAX_NEW)
            for p in _prompts(cfg, plane)]
    toks = [o.tolist() for o in eng.generate(reqs)]
    return toks, reqs[0].out, eng, got


def _ref(rcfg, rparams, cfg, plane, tau):
    reng = REngine(rcfg, RPCFG, make_ctx(make_host_mesh()), rparams,
                   max_len=MAX_LEN, **_kw(plane),
                   spamm_cfg=RSpamm(enable=True, tau=tau, tile=TILE,
                                    backend="jnp"))
    prompts = _prompts(cfg, plane)
    reqs = [RRequest(prompt=p, max_new_tokens=MAX_NEW) for p in prompts]
    toks = [o.tolist() for o in reng.generate(reqs)]
    logits = None
    if plane == "wave":
        t = np.stack(prompts)
        _, lg = reng._prefill(rparams, {"tokens": jnp.asarray(t)},
                              reng._frozen_for(t.size))
        logits = np.asarray(lg)
    return toks, reqs[0].out, logits


SETUP = {}


def _jobs(store_dir):
    jobs = []
    rp, gaps = {}, {}
    for fam in FAMILIES:
        rcfg, cfg = _family(fam)
        key = ARCH[fam]
        if key not in rp:
            r = RM.init_params(rcfg, RPCFG, jax.random.key(0),
                               model_axis_size=4)
            rp[key] = (r, M.params_from_jax(jax.tree.map(np.asarray, r),
                                            cfg, device="cpu"))
        rparams, params = rp[key]
        for plane in PLANES:
            if (key, plane) not in gaps:
                # tp and ep compute one function on one device
                gaps[key, plane] = _gap_tau(
                    lambda t: _port(cfg, params, plane, t))
            tau = gaps[key, plane]
            for t in (0.0, tau):
                SETUP[fam, plane, t == 0.0] = dict(
                    tau=t, rcfg=rcfg, cfg=cfg, rparams=rparams,
                    params=params, index=len(jobs))
                for m in MODELS:
                    jobs.append(("engine", dict(
                        cfg=cfg, pcfg=PCFG, params=params, model=m,
                        tile=TILE, spamm=_spamm(t),
                        prompts=_prompts(cfg, plane), max_new=MAX_NEW,
                        max_len=MAX_LEN, kw=_kw(plane))))
    cfg, params = SETUP["dense", "wave", False]["cfg"], rp[ARCH["dense"]][1]
    SETUP["store"] = len(jobs)
    jobs.append(("store", dict(
        cfg=cfg, pcfg=PCFG, params=params, model=4, tile=TILE,
        spamm=_spamm(SETUP["dense", "wave", False]["tau"]),
        prompts=_prompts(cfg, "wave"), max_new=2, max_len=MAX_LEN,
        store=store_dir)))
    SETUP["refusals"] = len(jobs)
    jobs.append(("refusals", dict(cfg=cfg, pcfg=PCFG, params=params,
                                  tile=TILE, spamm=_spamm(0.0))))
    return jobs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """[job results] of each rank of the one 4-rank spawn."""
    jobs = _jobs(str(tmp_path_factory.mktemp("store")))
    return spawn_ranks(W.engine_mesh_jobs, 4, backend="gloo", args=(jobs,),
                       timeout_s=300)


SERVED = {}
CELLS = [(fam, plane, tau0) for fam in FAMILIES for plane in PLANES
         for tau0 in (True, False)]


@pytest.fixture(scope="module", params=CELLS,
                ids=[f"{f}-{p}-{'tau0' if t else 'gap'}" for f, p, t in CELLS])
def served(request, ranks):
    """One cell: the ranks' results at model 2 and 4, the unsharded port
    engine's (with its margins) and the reference engine's."""
    hit = SERVED.get(request.param)
    if hit is not None:         # the wave cells' logits test asks again
        return hit
    s = SETUP[request.param]
    plane = request.param[1]
    port = _port(s["cfg"], s["params"], plane, s["tau"], margins=True)
    ref = _ref(s["rcfg"], s["rparams"], s["cfg"], plane, s["tau"])
    by_m = {m: [r[s["index"] + i] for r in ranks]
            for i, m in enumerate(MODELS)}
    SERVED[request.param] = request.param, s, by_m, port, ref
    return SERVED[request.param]


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rtol * float(np.abs(want).max()), err


def test_tokens_match_reference_on_every_rank(served):
    (fam, plane, tau0), s, by_m, (toks, out, _, margins), (rtoks, _, _) = \
        served
    assert toks == rtoks
    assert min(margins) > 10 * RTOL, min(margins)
    assert all(len(t) == MAX_NEW for t in toks)
    for m, res in by_m.items():
        for r in res:
            assert r["tokens"] == rtoks, (m, r["mrank"])
            assert r["shared_out"]


def test_per_layer_fractions_match_reference_exactly(served):
    (fam, plane, tau0), s, by_m, (_, out, _, _), (_, rout, _) = served
    want = rout["spamm"]["per_layer"]
    for m, res in by_m.items():
        for r in res:
            got = r["spamm"]["per_layer"]
            assert sorted(got) == sorted(want) == [0, 1]
            for layer, sites in want.items():
                assert sorted(got[layer]) == sorted(sites)
                for site, cell in sites.items():
                    g = got[layer][site]
                    for k in ("valid_fraction", "decode_valid_fraction",
                              "gated_gemms", "decode_gated_gemms"):
                        assert g[k] == cell[k], (m, layer, site, k)
            if not tau0:
                assert 0.0 < r["spamm"]["decode_valid_fraction"] < 1.0


def test_aggregates_equal_the_unsharded_engine(served):
    """Every gated GEMM's tap is the whole product's, MoE block taps
    (layer -1, per expert under ep) included."""
    _, _, by_m, (_, out, _, _), _ = served
    sp = out["spamm"]
    for res in by_m.values():
        for r in res:
            for k in ("valid_fraction", "gated_gemms",
                      "decode_valid_fraction", "decode_gated_gemms",
                      "compute_dtype"):
                assert r["spamm"][k] == sp[k], k


@pytest.mark.parametrize(
    "served", [c for c in CELLS if c[1] == "wave"], indirect=True,
    ids=[f"{f}-{'tau0' if t else 'gap'}" for f, p, t in CELLS
         if p == "wave"])
def test_wave_logits_within_rounding(served):
    _, _, by_m, (_, _, eng, _), (_, _, rlogits) = served
    step = eng._steps[(("wave", B), False)]
    for res in by_m.values():
        for r in res:
            _close(r["prefill"], rlogits)
            _close(r["decode"], step.outputs["logits"].numpy())


def test_graphs_reported_eager_under_gloo(ranks):
    for res in ranks:
        for r in res[:SETUP["store"]]:
            g = r["graphs"]
            assert g["decode"] is False and g["chunk"] is False
            assert "gloo" in g["eager"] and "eagerly" in g["eager"]


def test_warm_plan_store_hits_every_rank(ranks):
    """Two layers of wq, wk, wv, wo, w1, w2: the cold wave puts each
    rank's shards' plans (the ranks' layer-0 attention shards are
    distinct, so some puts miss), the warm wave loads all of them."""
    for res in ranks:
        (h0, m0, t0), (h1, m1, t1) = res[SETUP["store"]]
        assert h0 + m0 == 12 and m0 > 0 and (h1, m1) == (12, 0), (h0, m0)
        assert t0 == t1


def test_refusals_name_the_alternative(ranks):
    for res in ranks:
        r = res[SETUP["refusals"]]
        assert "mesh_devices" in r["batch"] and "model axis" in r["batch"]
        assert "not both" in r["mesh_devices"]
        assert "shard_params" in r["whole"]


def test_serve_cli_over_a_mesh_matches_one_device(capsys):
    """`launch/serve.py --mesh 1,2 --backend gloo` on two spawned ranks
    (each joins the CLI's own world from torchrun's variables): rank 0
    alone prints, and its tokens equal the one-device CLI's."""
    from repro_torch.launch import serve

    argv = ["--arch", "starcoder2-7b", "--reduced", "--num-requests", "2",
            "--prompt-len", "16", "--max-new", "4", "--device", "cpu",
            "--spamm-tau", "0.0", "--spamm-tile", "16"]
    serve.main(argv)
    one = capsys.readouterr().out
    outs = spawn_ranks(W.serve_cli, 2, backend="gloo",
                       args=(argv + ["--mesh", "1,2", "--backend", "gloo"],
                             free_port()), timeout_s=120)
    assert outs[1] == ""
    lines = outs[0].splitlines()
    assert "tensor-parallel over mesh 1,2 (gloo): 2 model ranks" in lines[1]

    def toks(text):
        return [ln for ln in text.splitlines() if ln.startswith("  req")]

    assert toks(outs[0]) == toks(one) and len(toks(one)) == 2
    assert any(ln.startswith("  eager: the model group runs gloo")
               for ln in lines)


# ---------------------------------------------------------------------------
# the legacy path: freeze_plans=False
# ---------------------------------------------------------------------------

LEGACY_PCFG = ParallelConfig(compute_dtype="float32", attn_q_chunk=16)
LEGACY_RPCFG = RParallel(compute_dtype="float32", param_dtype="float32",
                         remat="none", attn_q_chunk=16, attn_kv_chunk=16,
                         loss_chunk=32, decode_seq_shard=False)


def test_legacy_path_matches_reference_legacy_engine():
    """Reduced musicgen-large at tile 16 and levels 1, as the reference's
    own legacy-vs-frozen test builds it: the legacy engine's tokens equal
    the reference legacy engine's and the frozen engine's; its prefill
    gates (eager plans) with the reference's per-layer counts, its decode
    steps tap nothing (they run dense), and its prefill logits
    equal the frozen engine's bit for bit."""
    rcfg = rget_config("musicgen-large").reduced()
    cfg = get_config("musicgen-large").reduced()
    rparams = RM.init_params(rcfg, LEGACY_RPCFG, jax.random.key(0))
    params = M.params_from_jax(jax.tree.map(np.asarray, rparams), cfg,
                               device="cpu")
    prompts = [np.random.default_rng(0).integers(1, cfg.vocab, size=24)
               .astype(np.int32) for _ in range(2)]
    rsc = RSpamm(enable=True, tau=0.05, tile=16, backend="jnp", levels=1)
    sc = SpammConfig(enable=True, tau=0.05, tile=16, levels=1)

    def run(eng, cls):
        reqs = [cls(prompt=p, max_new_tokens=4) for p in prompts]
        return [o.tolist() for o in eng.generate(reqs)], reqs[0].out

    rtoks, rout = run(REngine(rcfg, LEGACY_RPCFG, make_ctx(make_host_mesh()),
                              rparams, max_len=64, spamm_cfg=rsc,
                              freeze_plans=False), RRequest)
    legacy = Engine(cfg, LEGACY_PCFG, params, max_len=64, spamm_cfg=sc,
                    device="cpu", freeze_plans=False)
    frozen = Engine(cfg, LEGACY_PCFG, params, max_len=64, spamm_cfg=sc,
                    device="cpu")
    toks, out = run(legacy, Request)
    ftoks, _ = run(frozen, Request)
    assert toks == rtoks == ftoks
    sp, rsp = out["spamm"], rout["spamm"]
    assert sp["decode_gated_gemms"] == rsp["decode_gated_gemms"] == 0
    assert sp["gated_gemms"] == rsp["gated_gemms"] > 0
    assert legacy._fw_tree is None
    for layer, sites in rsp["per_layer"].items():
        for site, cell in sites.items():
            assert (sp["per_layer"][layer][site]["gated_gemms"]
                    == cell["gated_gemms"])
    t = torch.as_tensor(np.stack(prompts))
    with torch.inference_mode():
        _, lg = legacy._prefill(params, {"tokens": t},
                                legacy._frozen_for(t.numel()))
        _, flg = frozen._prefill(params, {"tokens": t},
                                 frozen._frozen_for(t.numel()))
    assert torch.equal(lg, flg)
    assert out["graphs"] == {"decode": False, "chunk": False}
