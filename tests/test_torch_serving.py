"""The port's serving slice against the JAX reference on reduced
starcoder2-7b: the same weights (carried across by `params_from_jax`), the
same prompts, the reference on its `jnp` backend and the port on the plain
versions of its kernels (CPU tensors).
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
from repro.launch.mesh import make_ctx, make_host_mesh
from repro.models import attention as rattn
from repro.models import model as RM
from repro.serving.engine import Engine as REngine
from repro.serving.engine import Request as RRequest
from repro_torch.configs import ParallelConfig, SpammConfig, get_config
from repro_torch.core import plan as tplan
from repro_torch.models import attention as tattn
from repro_torch.models import model as M
from repro_torch.serving.engine import Engine, Request

ARCH = "starcoder2-7b"
TILE = 16
B, PLEN, MAX_NEW, MAX_LEN = 2, 16, 6, 64
# f32 logits after two layers: reassociated sums, transcendental ulps
LOGIT_TOL = 1e-4
# one f32 softmax-attention (chunked online softmax vs one-shot)
ATTN_TOL = 1e-5
# relative distance every gate product must keep from τ, far above the
# ~1e-6 relative gap between the two packages' f32 norms
GATE_MARGIN = 1e-3

RPCFG = RParallel(compute_dtype="float32", remat="none", attn_q_chunk=8,
                  attn_kv_chunk=8, decode_seq_shard=False)
PCFG = ParallelConfig(compute_dtype="float32", attn_q_chunk=8)


@pytest.fixture(scope="module")
def setup():
    rcfg = rget_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    rparams = RM.init_params(rcfg, RPCFG, jax.random.key(0))
    params = M.params_from_jax(jax.tree.map(np.asarray, rparams), cfg,
                               device="cpu")
    prompts = np.random.default_rng(0).integers(
        1, cfg.vocab, size=(B, PLEN)).astype(np.int32)
    return rcfg, cfg, rparams, params, prompts


def test_configs_agree(setup):
    rcfg, cfg, *_ = setup
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(rcfg, f.name), f.name
    full = get_config(ARCH)
    assert (full.d_model, full.d_ff, full.num_heads, full.num_kv_heads,
            full.num_layers) == (4608, 18432, 36, 4, 32)


def test_prefill_logits_match(setup):
    rcfg, cfg, rparams, params, prompts = setup
    rstep = jax.jit(RM.make_prefill_step(rcfg, RPCFG, make_ctx(make_host_mesh())))
    rcache, rlogits = rstep(rparams, {"tokens": jnp.asarray(prompts)})
    cache, logits = M.make_prefill_step(cfg, PCFG)(
        params, {"tokens": torch.as_tensor(prompts)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    for l, c in enumerate(cache["layers"]):
        for n in ("k", "v"):
            np.testing.assert_allclose(
                c[n].numpy(), np.asarray(rcache["layers"][n][l]),
                rtol=LOGIT_TOL, atol=LOGIT_TOL)


def _qkv(seed, b=2, sq=12, skv=12, hq=4, hk=2, d=8):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for shape in
            ((b, sq, hq, d), (b, skv, hk, d), (b, skv, hk, d))]


@pytest.mark.parametrize("window,q_chunk", [(None, 8), (5, 4), (None, 32)])
def test_flash_attention_matches(window, q_chunk):
    q, k, v = _qkv(1)
    want = rattn.flash_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                                 window=window, q_chunk=q_chunk,
                                 kv_chunk=q_chunk)
    got = tattn.flash_attention(*map(torch.as_tensor, (q, k, v)), causal=True,
                                window=window, q_chunk=q_chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ATTN_TOL,
                               atol=ATTN_TOL)


@pytest.mark.parametrize("length,window,ring,slots", [
    (7, None, False, 12), (9, 5, True, 5), (12, 4, False, 12)])
def test_decode_attention_matches(length, window, ring, slots):
    q, k, v = _qkv(2, sq=1, skv=slots)
    args = (q[:, 0], k, v)
    want = rattn.decode_attention(*map(jnp.asarray, args), length,
                                  window=window, ring=ring)
    got = tattn.decode_attention(*map(torch.as_tensor, args), length,
                                 window=window, ring=ring)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ATTN_TOL,
                               atol=ATTN_TOL)


def test_init_cache_matches(setup):
    rcfg, cfg, *_ = setup
    want = RM.init_cache(rcfg, RPCFG, B, MAX_LEN)["layers"]
    got = M.init_cache(cfg, PCFG, B, MAX_LEN, device="cpu")["layers"]
    assert len(got) == cfg.num_layers
    for n in ("k", "v"):
        assert tuple(got[0][n].shape) == tuple(want[n].shape[1:])
        assert not got[0][n].any()


def _port_generate(setup, tau):
    _, cfg, _, params, prompts = setup
    sc = None if tau is None else SpammConfig(enable=True, tau=tau, tile=TILE)
    eng = Engine(cfg, PCFG, params, max_len=MAX_LEN, spamm_cfg=sc,
                 device="cpu")
    reqs = [Request(prompt=p, max_new_tokens=MAX_NEW) for p in prompts]
    return np.stack(eng.generate(reqs)), reqs[0].out


def _ref_generate(setup, tau):
    rcfg, _, rparams, _, prompts = setup
    sc = RSpamm(enable=True, tau=tau, tile=TILE, backend="jnp")
    eng = REngine(rcfg, RPCFG, make_ctx(make_host_mesh()), rparams,
                  max_len=MAX_LEN, spamm_cfg=sc)
    reqs = [RRequest(prompt=p, max_new_tokens=MAX_NEW) for p in prompts]
    return np.stack(eng.generate(reqs)), reqs[0].out


def test_engine_tau0_matches_dense_and_reference(setup):
    dense, out = _port_generate(setup, None)
    assert out["spamm"] is None and dense.shape == (B, MAX_NEW)
    gated, gout = _port_generate(setup, 0.0)
    np.testing.assert_array_equal(gated, dense)
    sp = gout["spamm"]
    assert sp["valid_fraction"] == 1.0 and sp["decode_valid_fraction"] == 1.0
    assert sp["gated_gemms"] == 6 * 2 and sp["decode_gated_gemms"] > 0
    ref, _ = _ref_generate(setup, 0.0)
    np.testing.assert_array_equal(gated, ref)


def _gap_tau(products, tau):
    """τ in the widest gap of the sorted products near the middle."""
    p = np.sort(products)
    lo, hi = int(0.35 * p.size), int(0.65 * p.size)
    gaps = p[lo + 1:hi + 1] / p[lo:hi]
    g = lo + int(np.argmax(gaps))
    return float(np.sqrt(p[g] * p[g + 1])) if p[g] > 0 else tau


def test_engine_gated_tokens_match_reference(setup, monkeypatch):
    """τ > 0 in a gap of every gate product the run evaluates: the gate
    decisions cannot flip on an ulp, so the reference must emit the same
    tokens and the same valid fractions."""
    products = []
    orig = tplan._plan_frozen

    def recording(a, fp, **kw):
        p = orig(a, fp, **kw)
        prod = p.norm_a[fp.step_i, fp.step_k] * fp.nbmax[fp.step_k, fp.step_j]
        products.append(prod[fp.step_real].numpy())
        return p

    monkeypatch.setattr(tplan, "_plan_frozen", recording)
    _port_generate(setup, 0.0)
    tau = _gap_tau(np.concatenate(products), 0.0)
    for _ in range(5):
        products.clear()
        tokens, out = _port_generate(setup, tau)
        allp = np.concatenate(products)
        margin = float(np.min(np.abs(allp - tau)) / tau)
        if margin >= GATE_MARGIN:
            break
        tau = _gap_tau(allp, tau)
    assert margin >= GATE_MARGIN, (tau, margin)
    sp = out["spamm"]
    assert 0.0 < sp["valid_fraction"] < 1.0
    ref, rout = _ref_generate(setup, tau)
    np.testing.assert_array_equal(tokens, ref)
    assert sp["valid_fraction"] == pytest.approx(
        rout["spamm"]["valid_fraction"], abs=1e-12)
    assert sp["decode_valid_fraction"] == pytest.approx(
        rout["spamm"]["decode_valid_fraction"], abs=1e-12)


def test_engine_rejects_mixed_lengths(setup):
    """Mixed lengths are served by the chunked plane unless chunking is
    switched off (`prefill_chunk=0`): then they raise, as the reference
    does."""
    _, cfg, _, params, _ = setup
    eng = Engine(cfg, PCFG, params, max_len=MAX_LEN, device="cpu",
                 prefill_chunk=0)
    with pytest.raises(ValueError, match="prefill_chunk=0"):
        eng.generate([Request(prompt=np.ones(4, np.int32)),
                      Request(prompt=np.ones(5, np.int32))])


def test_default_device_raises_without_cuda(setup):
    if torch.cuda.is_available():
        pytest.skip("asserts the no-CUDA error; this machine has CUDA")
    _, cfg, _, params, _ = setup
    with pytest.raises(RuntimeError, match="cuda"):
        Engine(cfg, PCFG, params)
    with pytest.raises(RuntimeError, match="cuda"):
        M.init_params(cfg, PCFG)


def test_serve_cli_on_cpu(capsys):
    """The port's serve CLI end to end on CPU: τ = 0 prints the dense
    tokens, and the gated run reports its valid fractions."""
    from repro_torch.launch import serve

    argv = ["--arch", ARCH, "--reduced", "--num-requests", "2",
            "--prompt-len", "16", "--max-new", "3", "--device", "cpu"]
    serve.main(argv)
    dense = capsys.readouterr().out
    serve.main(argv + ["--spamm-tau", "0.0", "--spamm-tile", "16"])
    gated = capsys.readouterr().out
    assert "tok/s" in dense and "spamm: valid_fraction=1.000" in gated
    tokens = [ln for ln in dense.splitlines() if ln.strip().startswith("req")]
    assert len(tokens) == 2
    assert tokens == [ln for ln in gated.splitlines()
                      if ln.strip().startswith("req")]


def test_serve_cli_warm_wave_on_cpu(capsys):
    """`--waves 2` serves the requests twice and reports the second, warm
    wave: the same tokens as one wave, with the gate's plans frozen once."""
    from repro_torch.launch import serve

    argv = ["--arch", ARCH, "--reduced", "--num-requests", "2",
            "--prompt-len", "16", "--max-new", "3", "--device", "cpu",
            "--spamm-tau", "0.05", "--spamm-tile", "16"]
    serve.main(argv)
    one = capsys.readouterr().out
    serve.main(argv + ["--waves", "2"])
    two = capsys.readouterr().out
    assert one.count("served 2 requests") == two.count("served 2 requests") == 1

    def tokens(out):
        return [ln for ln in out.splitlines() if ln.strip().startswith("req")]

    assert len(tokens(one)) == 2 and tokens(one) == tokens(two)
    assert "latency: ttft=" in two
