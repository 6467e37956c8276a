"""The port's low-precision SpAMM (int8 and bf16) against the JAX reference:
the fused int8 get-norm, the int8 work-list GEMM, bf16 operands through the
work-list GEMM, low-precision plans, frozen weights and serving of reduced
starcoder2-7b. Inputs are made with numpy from a seed and handed to both
packages; the port runs the plain versions of its kernels (CPU tensors).

The reference's fused int8 get-norm and bf16 kernel path are an ulp away
from its own unfused results in interpret mode on this jax (ROADMAP queue
C), so norms and bf16 products are held against its `jnp` backend.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ParallelConfig as RParallel
from repro.configs import SpammConfig as RSpamm
from repro.configs import get_config as rget_config
from repro.core import plan as rplan
from repro.kernels import ops as rops
from repro.kernels import quantize as rquant
from repro.kernels import spamm_mm as rmm
from repro.launch.mesh import make_ctx, make_host_mesh
from repro.models import model as RM
from repro.plans.frozen import FrozenWeight as RFrozenWeight
from repro.serving.engine import Engine as REngine
from repro.serving.engine import Request as RRequest
from repro_torch.configs import ParallelConfig, SpammConfig, get_config
from repro_torch.core import plan as tplan
from repro_torch.kernels import getnorm as tgetnorm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quantize as tquant
from repro_torch.kernels import spamm_mm as tmm
from repro_torch.models import model as M
from repro_torch.plans.frozen import FrozenWeight
from repro_torch.serving.engine import Engine, Request

# tile norms: f32 sums of ≤ 1024 squares in two orders (jnp's einsum, the
# port's sum over the tile dims; measured 1.0e-6); at tile 64 the sums run
# over 4096 squares and drift further apart (measured 9e-6)
NORM_RTOL = 2e-6
NORM_RTOL_TILE64 = 1e-5
# XLA:CPU contracts the int8 kernel's `acc + prod·b_scale` into one FMA,
# where the port (and the CUDA kernel) round the product and the sum
# separately: one rounding per ACC step, relative to the output's largest
# magnitude
INT8_REF_RTOL = 1e-6
# bf16 products are exact in f32; the sums run in another order than the
# reference's masked einsum (K ≤ 192), relative to the largest magnitude
BF16_REF_RTOL = 1e-5
# relative distance every gate product must keep from the gate τ, far above
# the ~1e-6 relative gap between the two packages' f32 norms
GATE_MARGIN = 1e-3
DTYPES = ("int8", "bfloat16")


def _decay(m, n, seed, scale=0.4):
    """The reference's mixed-precision test operands: |i−j|^-½ decay times
    Gaussian noise."""
    rng = np.random.default_rng(seed)
    d = np.abs(np.arange(m)[:, None] - np.arange(n)[None, :])
    base = (scale / (d ** 0.5 + 1)).astype(np.float32)
    return base * rng.standard_normal((m, n)).astype(np.float32)


def _gap_tau(products, lo=0.2, hi=0.8):
    """A τ in the widest gap of the sorted positive products between the
    `lo` and `hi` quantiles."""
    p = np.sort(products[products > 0])
    a, b = int(lo * p.size), int(hi * p.size)
    g = a + int(np.argmax(p[a + 1:b + 1] / p[a:b]))
    return float(np.sqrt(p[g] * p[g + 1]))


def _margin(products, tau):
    """Relative distance of the products nearest to τ."""
    return float(np.min(np.abs(products - tau)) / tau)


def _products(na, nb):
    return (np.asarray(na)[:, None, :] * np.asarray(nb).T[None]).ravel()


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tile", [16, 32, 64])
def test_tile_norms_quant_plain_matches_reference(tile):
    x = _decay(4 * tile, 3 * tile, 0)
    x[:tile, :tile] = 0.0                   # an all-zero tile
    norms, scales = tgetnorm.tile_norms_quant_plain(torch.as_tensor(x), tile)
    rn, rs = rops.int8_norms_and_scales(jnp.asarray(x), tile, backend="jnp")
    np.testing.assert_array_equal(scales.numpy(), np.asarray(rs))
    np.testing.assert_allclose(
        norms.numpy(), np.asarray(rn), atol=0,
        rtol=NORM_RTOL if tile <= 32 else NORM_RTOL_TILE64)


@pytest.mark.parametrize("tile", [16, 32])
def test_fused_plain_is_the_unfused_composition(tile):
    """The plain fused get-norm, the `auto`/`torch` registry entries and
    the unfused quantize → dequantize → get-norm agree bit for bit."""
    x = torch.as_tensor(_decay(5 * tile, 2 * tile, 1))
    q, s = tquant.quantize_tiles(x, tile)
    unfused = tgetnorm.tile_norms_plain(tquant.dequantize_tiles(q, s, tile),
                                        tile)
    for backend in ("torch", "auto"):
        n, sc = tops.int8_norms_and_scales(x, tile, backend=backend)
        assert torch.equal(n, unfused) and torch.equal(sc, s)


def _int8_case(tile, block_n, seed):
    a, b = _decay(4 * tile, 6 * tile, seed), _decay(6 * tile, 4 * tile,
                                                     seed + 1)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    tau = float(np.median(_products(tgetnorm.tile_norms_plain(ta, tile),
                                    tgetnorm.tile_norms_plain(tb, tile))))
    w = tplan.plan(ta, tb, tau, tile=tile, block_n=block_n,
                   backend="torch").work
    return a, b, ta, tb, w


@pytest.mark.parametrize("block_n", [1, 2])
@pytest.mark.parametrize("tile", [16, 32])
def test_int8_worklist_plain_matches_reference_kernel(tile, block_n):
    """The port's plain int8 work-list against the reference's Pallas
    kernel in interpret mode on the same codes, scales and step tables."""
    a, b, ta, tb, w = _int8_case(tile, block_n, 2)
    aq, a_s = tquant.quantize_tiles(ta, tile)
    bq, b_s = tquant.quantize_tiles(tb, tile)
    raq, ras = rquant.quantize_tiles(jnp.asarray(a), tile)
    rbq, rbs = rquant.quantize_tiles(jnp.asarray(b), tile)
    for mine, theirs in ((aq, raq), (a_s, ras), (bq, rbq), (b_s, rbs)):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    got = tmm.spamm_mm_worklist_int8_plain(
        aq, bq, a_s, b_s, w.step_i, w.step_j, w.step_k, w.step_flags,
        w.runs, tile=tile, block_n=block_n)
    want = np.asarray(rmm.spamm_mm_worklist_int8(
        raq, rbq, ras, rbs, *(jnp.asarray(t.numpy()) for t in
                              (w.step_i, w.step_j, w.step_k, w.step_flags)),
        tile=tile, block_n=block_n, interpret=True))
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= INT8_REF_RTOL * scale


@pytest.mark.parametrize("block_n", [1, 2])
def test_int8_worklist_plain_against_f32_on_dequantized(block_n):
    """The int8 plain against the f32 plain on the dequantized operands:
    the int32 tile dots are exact where the f32 version rounds, within
    1e-5 of the output's largest magnitude (the reference's bound)."""
    tile = 16
    _, _, ta, tb, w = _int8_case(tile, block_n, 4)
    aq, a_s = tquant.quantize_tiles(ta, tile)
    bq, b_s = tquant.quantize_tiles(tb, tile)
    tables = (w.step_i, w.step_j, w.step_k, w.step_flags, w.runs)
    got = tmm.spamm_mm_worklist_int8(aq, bq, a_s, b_s, *tables, tile=tile,
                                     block_n=block_n)
    f32 = tmm.spamm_mm_worklist(tquant.dequantize_tiles(aq, a_s, tile),
                                tquant.dequantize_tiles(bq, b_s, tile),
                                *tables, tile=tile, block_n=block_n)
    assert float((got - f32).abs().max()) <= 1e-5 * float(f32.abs().max())


@pytest.mark.parametrize("block_n", [1, 2])
def test_bf16_worklist_plain_bitwise_and_against_reference(block_n):
    """bf16 operands: the plain work-list ≡ its f32 run on the bf16-rounded
    operands bit for bit; the reference's jnp bf16 path on the reference's
    normmaps agrees on the gate and, within BF16_REF_RTOL, on the product."""
    tile = 16
    a, b = _decay(4 * tile, 6 * tile, 6), _decay(6 * tile, 4 * tile, 7)
    rna = rops.tile_norms(rquant.quantized_view(jnp.asarray(a), "bf16", tile),
                          tile, backend="jnp")
    rnb = rops.tile_norms(rquant.quantized_view(jnp.asarray(b), "bf16", tile),
                          tile, backend="jnp")
    tau = float(np.median(_products(rna, rnb)))
    rp = rplan.plan(None, None, tau, norm_a=rna, norm_b=rnb, tile=tile,
                    block_n=block_n, backend="jnp", compute_dtype="bfloat16")
    want = np.asarray(rplan.execute(rp, jnp.asarray(a), jnp.asarray(b)))
    p = tplan.plan(None, None, tau, norm_a=torch.as_tensor(np.asarray(rna)),
                   norm_b=torch.as_tensor(np.asarray(rnb)), tile=tile,
                   block_n=block_n, backend="torch", compute_dtype="bf16")
    np.testing.assert_array_equal(p.mask.numpy(), np.asarray(rp.mask))
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    got = tplan.execute(p, ta, tb)
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= BF16_REF_RTOL * scale
    w = p.work
    tables = (w.step_i, w.step_j, w.step_k, w.step_flags, w.runs)
    f32 = tmm.spamm_mm_worklist_plain(ta.bfloat16().float(),
                                      tb.bfloat16().float(), *tables,
                                      tile=tile, block_n=block_n)
    assert torch.equal(got, f32)


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

def _ref_lowp_norms(x, dtype, tile):
    if dtype == "int8":
        return rops.int8_norms_and_scales(jnp.asarray(x), tile,
                                          backend="jnp")[0]
    return rops.tile_norms(rquant.quantized_view(jnp.asarray(x), dtype, tile),
                           tile, backend="jnp")


@pytest.mark.parametrize("levels", [0, 2])
@pytest.mark.parametrize("block_n", [1, 2])
@pytest.mark.parametrize("dtype", DTYPES)
def test_lowp_plan_tables_match_reference(dtype, block_n, levels):
    """On the reference's quantized-view normmaps: the widened τ and the
    step tables, array for array, flat and hierarchical."""
    tile = 16
    a, b = _decay(8 * tile, 8 * tile, 8), _decay(8 * tile, 6 * tile, 9)
    rna, rnb = (_ref_lowp_norms(x, dtype, tile) for x in (a, b))
    tau = float(np.median(_products(rna, rnb)))
    rp = rplan.plan(None, None, tau, norm_a=rna, norm_b=rnb, tile=tile,
                    block_n=block_n, backend="interpret", levels=levels,
                    compute_dtype=dtype)
    p = tplan.plan(None, None, tau, norm_a=torch.as_tensor(np.asarray(rna)),
                   norm_b=torch.as_tensor(np.asarray(rnb)), tile=tile,
                   block_n=block_n, backend="torch", levels=levels,
                   compute_dtype=dtype)
    assert p.tau == float(np.asarray(rp.tau)) < tau
    assert p.tau == float(np.float32(rquant.widen_tau(tau, dtype, tile)))
    assert p.compute_dtype == rp.compute_dtype == dtype
    np.testing.assert_array_equal(p.nvalid.numpy(), np.asarray(rp.nvalid))
    for name in ("step_i", "step_j", "step_k", "step_flags"):
        np.testing.assert_array_equal(getattr(p.work, name).numpy(),
                                      np.asarray(getattr(rp.work, name)),
                                      err_msg=name)
    np.testing.assert_allclose(float(p.bytes_moved()),
                               float(rp.bytes_moved()), rtol=1e-7)


@pytest.mark.parametrize("dtype", DTYPES)
def test_lowp_plan_from_matrices_matches_reference(dtype):
    """plan(a, b, τ, compute_dtype) from the matrices, τ in a gap of the
    products: the same widened τ, scales, gate and bytes as the
    reference's jnp plan."""
    tile = 16
    a, b = _decay(6 * tile, 8 * tile, 10), _decay(8 * tile, 5 * tile, 11)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    probe = tplan.plan(ta, tb, 1.0, tile=tile, compute_dtype=dtype,
                       backend="torch")
    prods = _products(probe.norm_a, probe.norm_b)
    gate = _gap_tau(prods)
    assert _margin(prods, gate) >= GATE_MARGIN
    tau = gate / (1.0 - rquant.gate_eps(dtype, tile)) ** 2
    p = tplan.plan(ta, tb, tau, tile=tile, compute_dtype=dtype,
                   backend="torch")
    rp = rplan.plan(jnp.asarray(a), jnp.asarray(b), tau, tile=tile,
                    compute_dtype=dtype, backend="jnp")
    assert p.tau == float(np.asarray(rp.tau))
    assert 0 < int(p.valid_tiles) == int(rp.valid_tiles) < p.total_tiles
    np.testing.assert_array_equal(p.mask.numpy(), np.asarray(rp.mask))
    np.testing.assert_allclose(p.norm_a.numpy(), np.asarray(rp.norm_a),
                               rtol=NORM_RTOL)
    if dtype == "int8":
        np.testing.assert_array_equal(p.a_scale.numpy(),
                                      np.asarray(rp.a_scale))
        np.testing.assert_array_equal(p.b_scale.numpy(),
                                      np.asarray(rp.b_scale))
    else:
        assert p.a_scale is None and p.b_scale is None
    np.testing.assert_allclose(float(p.bytes_moved()),
                               float(rp.bytes_moved()), rtol=1e-7)
    c = tplan.execute(p, ta, tb)
    rc = np.asarray(rplan.execute(rp, jnp.asarray(a), jnp.asarray(b)))
    tol = (INT8_REF_RTOL if dtype == "int8" else BF16_REF_RTOL) * 10
    assert np.abs(c.numpy() - rc).max() <= tol * np.abs(rc).max()


@pytest.mark.parametrize("dtype", DTYPES)
def test_valid_ratio_search_on_quantized_norms(dtype):
    """valid_ratio plans search on the quantized norms with no widening:
    the reference's τ exactly, on its normmaps."""
    tile = 16
    a, b = _decay(8 * tile, 8 * tile, 12), _decay(8 * tile, 8 * tile, 13)
    rna, rnb = (_ref_lowp_norms(x, dtype, tile) for x in (a, b))
    rp = rplan.plan(None, None, valid_ratio=0.3, norm_a=rna, norm_b=rnb,
                    tile=tile, backend="interpret", compute_dtype=dtype)
    p = tplan.plan(None, None, valid_ratio=0.3,
                   norm_a=torch.as_tensor(np.asarray(rna)),
                   norm_b=torch.as_tensor(np.asarray(rnb)), tile=tile,
                   backend="torch", compute_dtype=dtype)
    assert p.tau == float(np.asarray(rp.tau))
    assert int(p.valid_tiles) == int(rp.valid_tiles)


def test_bytes_moved_shrink_with_the_dtype():
    """The same work-list at f32, bf16 and int8: operand bytes shrink 2×
    and 4× while the output flushes stay f32 (the reference's ≥ 1.5×)."""
    tile = 16
    ta = torch.as_tensor(_decay(16 * tile, 16 * tile, 14))
    tb = torch.as_tensor(_decay(16 * tile, 16 * tile, 15))
    by = {d: float(tplan.plan(ta, tb, 0.0, tile=tile, compute_dtype=d,
                              backend="torch").bytes_moved())
          for d in ("float32", "bfloat16", "int8")}
    assert by["float32"] / by["bfloat16"] >= 1.5
    assert by["float32"] / by["int8"] >= 1.5
    assert by["bfloat16"] > by["int8"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_lowp_gate_keeps_every_f32_tile(dtype):
    """The superset property: at the same τ the low-precision gate keeps
    every tile the f32 gate keeps (widened τ over quantized norms)."""
    tile = 16
    ta = torch.as_tensor(_decay(8 * tile, 12 * tile, 16))
    tb = torch.as_tensor(_decay(12 * tile, 8 * tile, 17))
    p32 = tplan.plan(ta, tb, 0.0, tile=tile, backend="torch")
    for q in (0.3, 0.5, 0.8):
        tau = float(np.quantile(_products(p32.norm_a, p32.norm_b), q))
        f32 = tplan.plan(ta, tb, tau, tile=tile, backend="torch").mask
        low = tplan.plan(ta, tb, tau, tile=tile, backend="torch",
                         compute_dtype=dtype).mask
        assert bool((low | ~f32).all()) and int(low.sum()) >= int(f32.sum())


# ---------------------------------------------------------------------------
# frozen plans
# ---------------------------------------------------------------------------

def test_frozen_int8_weight_matches_reference():
    """FrozenWeight.build(int8): the reference's b_scale, requested τ kept,
    the widened τ baked into for_rows."""
    tile = 32
    w = _decay(128, 128, 11)
    fw = FrozenWeight.build(torch.as_tensor(w), 0.05, tile=tile,
                            backend="torch", compute_dtype="int8")
    rfw = RFrozenWeight.build(jnp.asarray(w), 0.05, tile=tile, backend="jnp",
                              compute_dtype="int8")
    assert fw.compute_dtype == "int8" and tuple(fw.b_scale.shape) == (4, 4)
    np.testing.assert_array_equal(fw.b_scale.numpy(),
                                  np.asarray(rfw.b_scale))
    assert fw.tau == float(np.asarray(rfw.tau)) == pytest.approx(0.05)
    np.testing.assert_allclose(fw.nbmax.numpy(), np.asarray(rfw.nbmax),
                               rtol=NORM_RTOL)
    fp, rfp = fw.for_rows(2), rfw.for_rows(2)
    e = rquant.gate_eps("int8", tile)
    assert fp.tau == float(np.asarray(rfp.tau))
    assert fp.tau == pytest.approx(0.05 * (1 - e) ** 2, rel=1e-6)
    assert fp.compute_dtype == "int8" and fp.b_scale is fw.b_scale
    for name in ("step_i", "step_j", "step_k", "step_real", "seg_first",
                 "seg_last"):
        np.testing.assert_array_equal(getattr(fp, name).numpy(),
                                      np.asarray(getattr(rfp, name)),
                                      err_msg=name)


@pytest.mark.parametrize("block_n", [1, 2])
@pytest.mark.parametrize("dtype", DTYPES)
def test_frozen_lowp_equals_eager_bitwise(dtype, block_n):
    """Frozen ≡ eager at the same low-precision config: same widened τ,
    same active steps, same kernel, bit-identical output and bytes."""
    tile = 16
    x = torch.as_tensor(_decay(3 * tile, 5 * tile, 18))
    w = torch.as_tensor(_decay(5 * tile, 4 * tile, 19))
    p32 = tplan.plan(x, w, 0.0, tile=tile, backend="torch")
    tau = float(np.median(_products(p32.norm_a, p32.norm_b)))
    eager = tplan.plan(x, w, tau, tile=tile, block_n=block_n,
                       backend="torch", compute_dtype=dtype)
    fw = FrozenWeight.build(w, tau, tile=tile, block_n=block_n,
                            backend="torch", compute_dtype=dtype)
    frozen = tplan.plan(x, frozen_weight=fw.for_rows(3))
    assert frozen.compute_dtype == eager.compute_dtype == dtype
    assert frozen.tau == eager.tau < tau
    assert 0 < int(frozen.valid_tiles) == int(eager.valid_tiles)
    assert torch.equal(frozen.mask, eager.mask)
    assert torch.equal(tplan.execute(frozen, x, w),
                       tplan.execute(eager, x, w))
    assert float(frozen.bytes_moved()) == float(eager.bytes_moved())
    if dtype == "int8":
        assert torch.equal(frozen.a_scale, eager.a_scale)
        assert torch.equal(frozen.b_scale, eager.b_scale)


def test_weight_plan_cache_keys_on_dtype():
    tile = 16
    cache = tplan.WeightPlanCache()
    x = torch.as_tensor(_decay(2 * tile, 4 * tile, 20))
    w = torch.as_tensor(_decay(4 * tile, 3 * tile, 21))
    for dtype in ("float32", "int8", "bf16", "bfloat16"):
        p, _ = cache.plan_for(x, w, 0.01, tile=tile, backend="torch",
                              compute_dtype=dtype)
        ref = tplan.plan(x, w, 0.01, tile=tile, backend="torch",
                         compute_dtype=dtype)
        assert torch.equal(p.norm_b, ref.norm_b)
        assert p.tau == ref.tau
    assert (cache.misses, cache.hits) == (3, 1)   # bf16 ≡ bfloat16


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

ARCH = "starcoder2-7b"
TILE = 16
B, PLEN, MAX_NEW, MAX_LEN = 2, 16, 5, 64
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


def _port_generate(setup, tau, dtype):
    _, cfg, _, params, prompts = setup
    sc = SpammConfig(enable=True, tau=tau, tile=TILE, dtype=dtype)
    eng = Engine(cfg, PCFG, params, max_len=MAX_LEN, spamm_cfg=sc,
                 device="cpu")
    reqs = [Request(prompt=p, max_new_tokens=MAX_NEW) for p in prompts]
    return np.stack(eng.generate(reqs)), reqs[0].out


def _ref_generate(setup, tau, dtype):
    rcfg, _, rparams, _, prompts = setup
    sc = RSpamm(enable=True, tau=tau, tile=TILE, backend="jnp", dtype=dtype)
    eng = REngine(rcfg, RPCFG, make_ctx(make_host_mesh()), rparams,
                  max_len=MAX_LEN, spamm_cfg=sc)
    reqs = [RRequest(prompt=p, max_new_tokens=MAX_NEW) for p in prompts]
    return np.stack(eng.generate(reqs)), reqs[0].out


@pytest.mark.parametrize("dtype", DTYPES)
def test_engine_lowp_tokens_and_bytes_match_reference(setup, monkeypatch,
                                                      dtype):
    """Reduced starcoder2-7b served at int8 / bf16 through frozen plans,
    with the gate τ in a gap of the decode steps' gate products (a decode
    tile holds 2 real rows of 16, so its products lie below prefill's) and
    away from every product the run evaluates: the reference's greedy
    tokens, valid fractions and GEMM bytes; the configured dtype reported;
    bytes ≥ 1.5× below the f32 run's."""
    products = []                       # (gate products, gate τ, rows)
    orig = tplan._plan_frozen

    def recording(a, fp, **kw):
        p = orig(a, fp, **kw)
        prod = p.norm_a[fp.step_i, fp.step_k] * fp.nbmax[fp.step_k, fp.step_j]
        products.append((prod[fp.step_real].numpy(), fp.tau, fp.gm))
        return p

    def decode_gap():
        return _gap_tau(np.concatenate([p for p, _, gm in products
                                        if gm == 1]))

    monkeypatch.setattr(tplan, "_plan_frozen", recording)
    factor = (1.0 - rquant.gate_eps(dtype, TILE)) ** 2
    _port_generate(setup, 0.0, dtype)
    gate = decode_gap()
    for _ in range(5):
        products.clear()
        tokens, out = _port_generate(setup, gate / factor, dtype)
        margin = min(_margin(p, t) for p, t, _ in products)
        if margin >= GATE_MARGIN:
            break
        gate = decode_gap()
    assert margin >= GATE_MARGIN, (gate, margin)
    tau = gate / factor
    sp = out["spamm"]
    assert sp["compute_dtype"] == dtype
    assert 0.0 < sp["valid_fraction"] <= 1.0
    assert 0.0 < sp["decode_valid_fraction"] < 1.0
    assert sp["gemm_bytes_moved"] > 0 and sp["decode_gemm_bytes_moved"] > 0
    ref, rout = _ref_generate(setup, tau, dtype)
    rsp = rout["spamm"]
    np.testing.assert_array_equal(tokens, ref)
    assert rsp["compute_dtype"] == dtype
    for key in ("valid_fraction", "decode_valid_fraction"):
        assert sp[key] == pytest.approx(rsp[key], abs=1e-12), key
    for key in ("gemm_bytes_moved", "decode_gemm_bytes_moved"):
        assert sp[key] == pytest.approx(rsp[key], rel=1e-6), key
    monkeypatch.setattr(tplan, "_plan_frozen", orig)
    _, out32 = _port_generate(setup, tau, "float32")
    assert out32["spamm"]["gemm_bytes_moved"] / sp["gemm_bytes_moved"] >= 1.5


def test_serve_cli_int8_on_cpu(capsys):
    """The serve CLI at --spamm-dtype int8: τ = 0 keeps every tile and the
    report names the dtype and the GEMM bytes."""
    from repro_torch.launch import serve

    serve.main(["--arch", ARCH, "--reduced", "--num-requests", "2",
                "--prompt-len", "16", "--max-new", "3", "--device", "cpu",
                "--spamm-tau", "0.0", "--spamm-tile", "16",
                "--spamm-dtype", "int8"])
    out = capsys.readouterr().out
    assert "spamm: valid_fraction=1.000" in out
    assert "spamm dtype=int8: prefill_gemm_bytes=" in out
    assert "n/a" not in out.split("spamm dtype=int8:")[1].splitlines()[0]
