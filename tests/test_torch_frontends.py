"""The stub-frontend configs against the JAX reference at `.reduced()` size:
llava-next-mistral-7b (vision stub; SwiGLU, GQA, rope θ 1e6) and
musicgen-large (audio stub; GELU MLP, MHA). Their frontends are the
reference's stubs: a batch may carry precomputed `embeds` (B, S, d) in
place of `tokens`, and a decode step a (B, 1, d) input; the engine serves
tokens. The same weights (carried across by `params_from_jax`), inputs
from a numpy seed, the reference's SpAMM on its `jnp` backend and the
port on the plain versions of its kernels (CPU tensors). Also the
synthetic workload config (`configs/spamm_synth.py`), field for field.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ParallelConfig as RParallel
from repro.configs import SpammConfig as RSpamm
from repro.configs import get_config as rget_config
from repro.configs import spamm_synth as rsynth
from repro.launch.mesh import make_ctx, make_host_mesh
from repro.models import model as RM
from repro.serving.engine import Engine as REngine
from repro.serving.engine import Request as RRequest
from repro_torch.configs import (ARCH_IDS, PORTED_ARCHS, ParallelConfig,
                                 SpammConfig, get_config)
from repro_torch.configs import spamm_synth as tsynth
from repro_torch.core import plan as tplan
from repro_torch.models import model as M
from repro_torch.serving.engine import Engine, Request

ARCHS = ("llava-next-mistral-7b", "musicgen-large")
TILE = 16
B, PLEN, MAX_NEW, MAX_LEN, CHUNK = 2, 16, 5, 64, 16
# f32 outputs relative to their largest magnitude (two f32 layers:
# reassociated sums, transcendental ulps)
OUT_RTOL = 1e-5
# relative distance every gate product keeps from the gate τ, far above the
# ~1e-6 relative gap between the two packages' f32 norms
GATE_MARGIN = 1e-3
RPCFG = RParallel(compute_dtype="float32", remat="none", attn_q_chunk=8,
                  attn_kv_chunk=8, decode_seq_shard=False)
PCFG = ParallelConfig(compute_dtype="float32", attn_q_chunk=8)
# the published widths each arch is held to (the configs' own sources)
FULL = {
    "llava-next-mistral-7b": dict(family="vlm", num_layers=32, d_model=4096,
                                  num_heads=32, num_kv_heads=8, d_ff=14336,
                                  vocab=32000, act="silu",
                                  rope_theta=1_000_000.0,
                                  frontend="vision_stub"),
    "musicgen-large": dict(family="audio", num_layers=48, d_model=2048,
                           num_heads=32, num_kv_heads=32, d_ff=8192,
                           vocab=2048, act="gelu_mlp",
                           frontend="audio_stub"),
}


@functools.lru_cache(maxsize=None)
def _model(arch):
    rcfg = rget_config(arch).reduced()
    cfg = get_config(arch).reduced()
    rparams = RM.init_params(rcfg, RPCFG, jax.random.key(0))
    params = M.params_from_jax(jax.tree.map(np.asarray, rparams), cfg,
                               device="cpu")
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab, size=(B, PLEN)).astype(np.int32)
    embeds = (rng.standard_normal((B, PLEN, cfg.d_model))
              / np.sqrt(cfg.d_model)).astype(np.float32)
    return dict(arch=arch, cfg=cfg, rcfg=rcfg, rparams=rparams,
                params=params, prompts=prompts, embeds=embeds)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return _model(request.param)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max() / np.abs(want).max())
    assert err <= OUT_RTOL, err


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal_the_references(arch):
    assert arch in PORTED_ARCHS
    for full, rfull in ((get_config(arch), rget_config(arch)),
                        (get_config(arch).reduced(),
                         rget_config(arch).reduced())):
        for f in dataclasses.fields(full):
            assert getattr(full, f.name) == getattr(rfull, f.name), f.name
    full = get_config(arch)
    for k, v in FULL[arch].items():
        assert getattr(full, k) == v, k


def test_every_arch_is_registered():
    assert set(PORTED_ARCHS) == set(ARCH_IDS)
    for arch in ARCH_IDS:
        assert get_config(arch).name == arch == rget_config(arch).name
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("gpt-2")


def test_synth_config_equals_the_references():
    assert dataclasses.asdict(tsynth.CONFIG) == \
        dataclasses.asdict(rsynth.CONFIG)
    assert [f.name for f in dataclasses.fields(tsynth.SynthConfig)] == \
        [f.name for f in dataclasses.fields(rsynth.SynthConfig)]
    custom = dict(n=256, tile=16, decay="exponential", c=0.2, lam=0.5,
                  valid_ratio=0.3)
    assert dataclasses.asdict(tsynth.SynthConfig(**custom)) == \
        dataclasses.asdict(rsynth.SynthConfig(**custom))


def test_embeds_of_the_tokens_equal_the_token_path(model):
    """Prefill fed `embeds = embedding[tokens]` ≡ the token prefill bit for
    bit (logits and caches); a decode step fed the embedded token ≡ the
    token step."""
    cfg, params, prompts = model["cfg"], model["params"], model["prompts"]
    step = M.make_prefill_step(cfg, PCFG)
    emb = params["embed"]["embedding"]
    toks = torch.as_tensor(prompts)
    with torch.inference_mode():
        cache_t, logits_t = step(params, {"tokens": toks})
        cache_e, logits_e = step(params, {"embeds": emb[toks.long()]})
        assert torch.equal(logits_t, logits_e)
        for a, b in zip(cache_t["layers"], cache_e["layers"]):
            assert all(torch.equal(a[k], b[k]) for k in a)
        dec = M.make_decode_step(cfg, PCFG)
        nxt = logits_t.argmax(-1)[:, None]
        caches = [M.init_cache(cfg, PCFG, B, MAX_LEN, device="cpu")
                  for _ in range(2)]
        for c in caches:
            for src, dst in zip(cache_t["layers"], c["layers"]):
                for k in ("k", "v"):
                    dst[k][:, :PLEN].copy_(src[k])
        lt, _ = dec(params, nxt, caches[0], PLEN)
        le, _ = dec(params, emb[nxt], caches[1], PLEN)
    assert torch.equal(lt, le)
    assert all(torch.equal(caches[0]["layers"][l][k],
                           caches[1]["layers"][l][k])
               for l in range(cfg.num_layers) for k in ("k", "v"))


def _steps(model, tau):
    """The port's and the reference's prefill, chunk and decode steps and
    their frozen-plan lookups at `tau` (None: SpAMM off)."""
    cfg, rcfg = model["cfg"], model["rcfg"]
    sc = rsc = None
    if tau is not None:
        sc = SpammConfig(enable=True, tau=tau, tile=TILE)
        rsc = RSpamm(enable=True, tau=tau, tile=TILE, backend="jnp")
    eng = Engine(cfg, PCFG, model["params"], max_len=MAX_LEN, spamm_cfg=sc,
                 device="cpu")
    rctx = make_ctx(make_host_mesh())
    reng = REngine(rcfg, RPCFG, rctx, model["rparams"], max_len=MAX_LEN,
                   spamm_cfg=rsc)
    port = (M.make_prefill_step(cfg, PCFG, spamm_cfg=eng.spamm_ctx),
            M.make_prefill_chunk_step(cfg, PCFG, spamm_cfg=eng.spamm_ctx),
            M.make_decode_step(cfg, PCFG, spamm_cfg=eng.spamm_ctx),
            eng._frozen_for)
    ref = (RM.make_prefill_step(rcfg, RPCFG, rctx, spamm_cfg=reng.spamm_ctx),
           RM.make_prefill_chunk_step(rcfg, RPCFG, rctx,
                                      spamm_cfg=reng.spamm_ctx),
           RM.make_decode_step(rcfg, RPCFG, rctx, spamm_cfg=reng.spamm_ctx),
           reng._frozen_for)
    return port, ref


@pytest.mark.parametrize("tau", [None, 0.0], ids=["dense", "tau0"])
def test_embeds_through_prefill_chunk_and_decode_match_reference(model, tau):
    """Precomputed embeddings (a numpy seed, not the embedding table)
    through the one-shot prefill, two chunks of the chunked prefill and
    two decode steps fed (B, 1, d) embeddings, each step's logits and the
    caches within OUT_RTOL of the reference's, through frozen plans at
    τ = 0."""
    cfg, rcfg = model["cfg"], model["rcfg"]
    params, rparams, embeds = model["params"], model["rparams"], \
        model["embeds"]
    (pre, chunk, dec, fz), (rpre, rchunk, rdec, rfz) = _steps(model, tau)
    n = B * PLEN
    with torch.inference_mode():
        cache, logits = pre(params, {"embeds": torch.as_tensor(embeds)},
                            fz(n))
    rcache, rlogits = rpre(rparams, {"embeds": jnp.asarray(embeds)}, rfz(n))
    _close(logits, rlogits)
    for l, c in enumerate(cache["layers"]):
        for k in ("k", "v"):
            _close(c[k], np.asarray(rcache["layers"][k])[l])
    # the same embeddings in two chunks, into the linear cache
    half = PLEN // 2
    ccache = M.init_cache(cfg, PCFG, B, MAX_LEN, full=True, device="cpu")
    rccache = RM.init_cache(rcfg, RPCFG, B, MAX_LEN)
    for c0 in (0, half):
        pos = np.tile(np.arange(c0, c0 + half, dtype=np.int32), (B, 1))
        last = np.full(B, half - 1, np.int32)
        x = embeds[:, c0:c0 + half]
        with torch.inference_mode():
            ccache, clog = chunk(params, {"embeds": torch.as_tensor(x)},
                                 ccache, torch.as_tensor(pos),
                                 torch.as_tensor(last), fz(B * half))
        rccache, rclog = rchunk(rparams, {"embeds": jnp.asarray(x)}, rccache,
                                jnp.asarray(pos), jnp.asarray(last),
                                rfz(B * half))
        _close(clog, rclog)
    _close(clog, rlogits)
    for l, c in enumerate(ccache["layers"]):
        for k in ("k", "v"):
            _close(c[k], np.asarray(rccache["layers"][k])[l])
    # decode fed embeddings
    rng = np.random.default_rng(1)
    for t in range(2):
        x = (rng.standard_normal((B, 1, cfg.d_model))
             / np.sqrt(cfg.d_model)).astype(np.float32)
        with torch.inference_mode():
            dlog, ccache = dec(params, torch.as_tensor(x), ccache, PLEN + t,
                               fz(B))
        rdlog, rccache = rdec(rparams, jnp.asarray(x), rccache,
                              jnp.int32(PLEN + t), rfz(B))
        _close(dlog, rdlog)
    for l, c in enumerate(ccache["layers"]):
        for k in ("k", "v"):
            _close(c[k], np.asarray(rccache["layers"][k])[l])


def _engines(model, tau):
    sc = rsc = None
    if tau is not None:
        sc = SpammConfig(enable=True, tau=tau, tile=TILE)
        rsc = RSpamm(enable=True, tau=tau, tile=TILE, backend="jnp")
    eng = Engine(model["cfg"], PCFG, model["params"], max_len=MAX_LEN,
                 spamm_cfg=sc, device="cpu")
    reng = REngine(model["rcfg"], RPCFG, make_ctx(make_host_mesh()),
                   model["rparams"], max_len=MAX_LEN, spamm_cfg=rsc)
    return eng, reng


def _serve(model, tau):
    eng, reng = _engines(model, tau)
    reqs = [Request(prompt=p, max_new_tokens=MAX_NEW)
            for p in model["prompts"]]
    rreqs = [RRequest(prompt=p, max_new_tokens=MAX_NEW)
             for p in model["prompts"]]
    return ((np.stack(eng.generate(reqs)), reqs[0].out),
            (np.stack(reng.generate(rreqs)), rreqs[0].out))


def test_engine_tau0_equals_dense_and_the_reference(model):
    (dense, _), (rdense, _) = _serve(model, None)
    (toks, out), (rtoks, _) = _serve(model, 0.0)
    np.testing.assert_array_equal(dense, rdense)
    np.testing.assert_array_equal(toks, dense)
    np.testing.assert_array_equal(toks, rtoks)
    assert out["spamm"]["valid_fraction"] == 1.0


def _gap(p):
    p = np.sort(p[p > 0])
    lo, hi = int(0.35 * p.size), int(0.65 * p.size)
    g = lo + int(np.argmax(p[lo + 1:hi + 1] / p[lo:hi]))
    return float(np.sqrt(p[g] * p[g + 1]))


def _products(model, tau):
    products = []
    orig = tplan._plan_frozen

    def recording(a, fp, **kw):
        p = orig(a, fp, **kw)
        prod = p.norm_a[fp.step_i, fp.step_k] * fp.nbmax[fp.step_k, fp.step_j]
        products.append((prod[fp.step_real].numpy(), fp.gm))
        return p

    eng, _ = _engines(model, tau)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tplan, "_plan_frozen", recording)
        eng.generate([Request(prompt=p, max_new_tokens=MAX_NEW)
                      for p in model["prompts"]])
    return products


def test_engine_gap_tau_matches_reference(model):
    """τ in a gap of the decode steps' gate products, GATE_MARGIN away from
    every product the wave evaluates: the reference's tokens and valid
    fractions; decode keeps part of its tiles."""
    tau = _gap(np.concatenate([p for p, gm in _products(model, 0.0)
                               if gm == 1]))
    for _ in range(5):
        prods = _products(model, tau)
        margin = min(float(np.min(np.abs(p - tau)) / tau) for p, _ in prods)
        if margin >= GATE_MARGIN:
            break
        tau = _gap(np.concatenate([p for p, gm in prods if gm == 1]))
    assert margin >= GATE_MARGIN, (tau, margin)
    (toks, out), (rtoks, rout) = _serve(model, tau)
    sp, rsp = out["spamm"], rout["spamm"]
    assert 0.0 < sp["decode_valid_fraction"] < 1.0
    np.testing.assert_array_equal(toks, rtoks)
    for key in ("valid_fraction", "decode_valid_fraction"):
        assert sp[key] == pytest.approx(rsp[key], abs=1e-12), key
