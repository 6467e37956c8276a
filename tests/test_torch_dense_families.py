"""The dense model family beyond starcoder2-7b (codeqwen1.5-7b: SwiGLU, QKV
bias, MHA; qwen2.5-32b: SwiGLU, QKV bias, GQA, rope_theta 1e6; granite-34b:
SwiGLU, MQA with one kv head) against the JAX reference at `.reduced()`
size: the same weights (`params_from_jax`), the same prompts, the
reference on its `jnp` backend and the port on the plain versions of its
kernels (CPU tensors).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ParallelConfig as RParallel
from repro.configs import SpammConfig as RSpamm
from repro.configs import get_config as rget_config
from repro.kernels import quantize as rquant
from repro.launch.mesh import make_ctx, make_host_mesh
from repro.models import model as RM
from repro.serving.engine import Engine as REngine
from repro.serving.engine import Request as RRequest
from repro_torch.configs import (PORTED_ARCHS, ParallelConfig, SpammConfig,
                                 get_config)
from repro_torch.core import plan as tplan
from repro_torch.models import model as M
from repro_torch.serving.engine import Engine, Request

ARCHS = ("codeqwen1.5-7b", "qwen2.5-32b", "granite-34b")
TILE = 16
B, PLEN, MAX_NEW, MAX_LEN = 2, 16, 5, 64
# prefill logits after two f32 layers (reassociated sums, transcendental
# ulps), relative to the logits' largest magnitude
LOGIT_RTOL = 1e-5
# relative distance every gate product must keep from the gate τ, far above
# the ~1e-6 relative gap between the two packages' f32 norms
GATE_MARGIN = 1e-3
RPCFG = RParallel(compute_dtype="float32", remat="none", attn_q_chunk=8,
                  attn_kv_chunk=8, decode_seq_shard=False)
PCFG = ParallelConfig(compute_dtype="float32", attn_q_chunk=8)
# the published widths each family is held to (the configs' own sources)
FULL = {
    "codeqwen1.5-7b": dict(num_layers=32, d_model=4096, num_heads=32,
                           num_kv_heads=32, d_ff=13440, vocab=92416,
                           act="silu", qkv_bias=True, rope_theta=10_000.0),
    "qwen2.5-32b": dict(num_layers=64, d_model=5120, num_heads=40,
                        num_kv_heads=8, d_ff=27648, vocab=152064, act="silu",
                        qkv_bias=True, rope_theta=1_000_000.0),
    "granite-34b": dict(num_layers=88, d_model=6144, num_heads=48,
                        num_kv_heads=1, d_ff=24576, vocab=49152, act="silu",
                        qkv_bias=False, rope_theta=10_000.0),
}


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    arch = request.param
    rcfg = rget_config(arch).reduced()
    cfg = get_config(arch).reduced()
    rparams = RM.init_params(rcfg, RPCFG, jax.random.key(0))
    np_tree = jax.tree.map(np.asarray, rparams)
    params = M.params_from_jax(np_tree, cfg, device="cpu")
    prompts = np.random.default_rng(0).integers(
        1, cfg.vocab, size=(B, PLEN)).astype(np.int32)
    return arch, rcfg, cfg, rparams, np_tree, params, prompts


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


def test_params_from_jax_carries_w3_and_the_biases(setup):
    """Every reference leaf lands in the port's tree, layer by layer,
    w3 (SwiGLU) and bq/bk/bv (QKV bias) included, bit for bit; the port's
    own init makes the same tree."""
    arch, _, cfg, _, np_tree, params, _ = setup
    mlp = params["layers"][0]["mlp"]
    mix = params["layers"][0]["mix"]
    assert set(mlp) == {"w1", "w2", "w3"}
    want_mix = {"wq", "wk", "wv", "wo"} | (
        {"bq", "bk", "bv"} if cfg.qkv_bias else set())
    assert set(mix) == want_mix
    for l in range(cfg.num_layers):
        for part, names in (("mix", want_mix), ("mlp", ("w1", "w2", "w3"))):
            for n in names:
                got = params["layers"][l][part][n]
                want = np_tree["layers"][part][n][l]
                assert got.dtype == torch.float32
                np.testing.assert_array_equal(got.numpy(), want)
    assert mix["wk"].shape == (cfg.d_model,
                               cfg.num_kv_heads * cfg.resolved_head_dim)
    own = M.init_params(cfg, PCFG, 0, device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), own) == \
        jax.tree.map(lambda t: tuple(t.shape), params)


def _engines(setup, tau, dtype="float32"):
    _, rcfg, cfg, rparams, _, params, _ = setup
    sc = rsc = None
    if tau is not None:
        sc = SpammConfig(enable=True, tau=tau, tile=TILE, dtype=dtype)
        rsc = RSpamm(enable=True, tau=tau, tile=TILE, backend="jnp",
                     dtype=dtype)
    eng = Engine(cfg, PCFG, params, max_len=MAX_LEN, spamm_cfg=sc,
                 device="cpu")
    reng = REngine(rcfg, RPCFG, make_ctx(make_host_mesh()), rparams,
                   max_len=MAX_LEN, spamm_cfg=rsc)
    return eng, reng


def _serve(setup, eng, reng):
    """Greedy tokens of both engines, and both prefill logits through each
    engine's own prefill step and frozen plans."""
    _, _, _, rparams, _, params, prompts = setup
    reqs = [Request(prompt=p, max_new_tokens=MAX_NEW) for p in prompts]
    rreqs = [RRequest(prompt=p, max_new_tokens=MAX_NEW) for p in prompts]
    toks = np.stack(eng.generate(reqs))
    rtoks = np.stack(reng.generate(rreqs))
    with torch.inference_mode():
        _, logits = eng._prefill(params,
                                 {"tokens": torch.as_tensor(prompts)},
                                 eng._frozen_for(prompts.size))
    _, rlogits = reng._prefill(rparams, {"tokens": jnp.asarray(prompts)},
                               reng._frozen_for(prompts.size))
    return (toks, reqs[0].out, logits.numpy()), (rtoks, rreqs[0].out,
                                                 np.asarray(rlogits))


def _assert_logits_close(got, want):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= LOGIT_RTOL * scale, (err, scale)


def test_spamm_off_matches_reference(setup):
    eng, reng = _engines(setup, None)
    (toks, out, logits), (rtoks, _, rlogits) = _serve(setup, eng, reng)
    assert out["spamm"] is None and toks.shape == (B, MAX_NEW)
    np.testing.assert_array_equal(toks, rtoks)
    _assert_logits_close(logits, rlogits)


def _gate_products(setup, tau, dtype):
    """Every gate product a port wave at `tau` evaluates, with its gate τ
    and row grid."""
    products = []
    orig = tplan._plan_frozen

    def recording(a, fp, **kw):
        p = orig(a, fp, **kw)
        prod = p.norm_a[fp.step_i, fp.step_k] * fp.nbmax[fp.step_k, fp.step_j]
        products.append((prod[fp.step_real].numpy(), fp.tau, fp.gm))
        return p

    eng, _ = _engines(setup, tau, dtype)
    *_, prompts = setup
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tplan, "_plan_frozen", recording)
        eng.generate([Request(prompt=p, max_new_tokens=MAX_NEW)
                      for p in prompts])
    return products


def _gap(p):
    p = np.sort(p[p > 0])
    lo, hi = int(0.35 * p.size), int(0.65 * p.size)
    g = lo + int(np.argmax(p[lo + 1:hi + 1] / p[lo:hi]))
    return float(np.sqrt(p[g] * p[g + 1]))


def _gated_tau(setup, dtype):
    """A τ whose gate threshold lies in a gap of the decode steps' gate
    products (so decode keeps part of its tiles) and away from every
    product the run evaluates."""
    factor = (1.0 - rquant.gate_eps(dtype, TILE)) ** 2
    prods = _gate_products(setup, 0.0, dtype)
    gate = _gap(np.concatenate([p for p, _, gm in prods if gm == 1]))
    for _ in range(5):
        prods = _gate_products(setup, gate / factor, dtype)
        margin = min(float(np.min(np.abs(p - t)) / t) for p, t, _ in prods)
        if margin >= GATE_MARGIN:
            return gate / factor
        gate = _gap(np.concatenate([p for p, _, gm in prods if gm == 1]))
    raise AssertionError(f"no τ {GATE_MARGIN} away from every product")


def test_tau0_equals_dense_and_the_reference(setup):
    eng, reng = _engines(setup, 0.0)
    (toks, out, logits), (rtoks, _, rlogits) = _serve(setup, eng, reng)
    dense, _ = _engines(setup, None)
    dtoks = np.stack(dense.generate([Request(prompt=p,
                                             max_new_tokens=MAX_NEW)
                                     for p in setup[-1]]))
    np.testing.assert_array_equal(toks, dtoks)
    np.testing.assert_array_equal(toks, rtoks)
    _assert_logits_close(logits, rlogits)
    assert out["spamm"]["valid_fraction"] == 1.0


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_gated_tokens_and_logits_match_reference(setup, dtype):
    """τ > 0 through frozen plans, at f32 and int8: the reference's greedy
    tokens, prefill logits (f32) and valid fractions; decode keeps part of
    its tiles."""
    tau = _gated_tau(setup, dtype)
    eng, reng = _engines(setup, tau, dtype)
    (toks, out, logits), (rtoks, rout, rlogits) = _serve(setup, eng, reng)
    sp, rsp = out["spamm"], rout["spamm"]
    assert sp["compute_dtype"] == rsp["compute_dtype"] == dtype
    assert 0.0 < sp["decode_valid_fraction"] < 1.0
    np.testing.assert_array_equal(toks, rtoks)
    for key in ("valid_fraction", "decode_valid_fraction"):
        assert sp[key] == pytest.approx(rsp[key], abs=1e-12), key
    if dtype == "float32":
        _assert_logits_close(logits, rlogits)
