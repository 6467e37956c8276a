"""The port's gated linear and quantization helpers against the JAX reference.

`spamm_linear` (forward), the eager branch of `maybe_spamm_matmul` (no
frozen plan) and `repro_torch.kernels.quantize` take the same numpy inputs
as their twins in `repro.core.module` and `repro.kernels.quantize`. The
reference runs its Pallas work-list kernel in interpret mode; the port runs
the plain version (CPU tensors).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SpammConfig as RSpamm
from repro.core import module as rmodule
from repro.kernels import quantize as rquant
from repro.kernels import ref as rref
from repro_torch.configs import SpammConfig
from repro_torch.core import module as tmodule
from repro_torch.kernels import quantize as tquant
from repro_torch.plans.frozen import FrozenWeight

TILE = 16
# f32 GEMM over K = 48 (three tile products): accumulation-order rounding
MM_TOL = 1e-5
# τ sits in a gap of the norm products at least this wide (relative), so the
# few-ulp differences between the packages' norms cannot flip a tile
GAP_RTOL = 1e-4


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _pad(x, rows, cols):
    m, n = x.shape
    return np.pad(x, ((0, (-m) % rows), (0, (-n) % cols)))


def _gap_tau(x2, w, block_n):
    """A τ in the middle of the widest gap of the (super-column) norm
    products between their 30th and 70th percentiles."""
    na = np.asarray(rref.tile_norms_ref(jnp.asarray(_pad(x2, TILE, TILE)),
                                        TILE))
    nb = np.asarray(rref.tile_norms_ref(
        jnp.asarray(_pad(w, TILE, TILE * block_n)), TILE))
    gk, gn = nb.shape
    nb = nb.reshape(gk, gn // block_n, block_n).max(2)
    prods = np.unique(na[:, None, :] * nb.T[None])
    lo, hi = int(0.3 * prods.size), int(0.7 * prods.size)
    gaps = prods[lo + 1:hi] - prods[lo:hi - 1]
    g = int(np.argmax(gaps))
    a, b = prods[lo + g], prods[lo + g + 1]
    assert (b - a) / b > GAP_RTOL, (a, b)
    return float((a + b) / 2)


CASES = [(kind, block_n) for kind in ("zero", "gap", "all_out")
         for block_n in (1, 2)]


def _case(kind, block_n):
    """x (2, 21, 48): 42 rows pad to 48; w (48, 72): N pads to 80 or 96."""
    x = _rand((2, 21, 48), 0)
    w = _rand((48, 72), 1)
    tau = {"zero": 0.0, "all_out": 1e9}.get(kind)
    if tau is None:
        tau = _gap_tau(x.reshape(-1, 48), w, block_n)
    return x, w, tau


@pytest.mark.parametrize("kind,block_n", CASES)
def test_spamm_linear_matches_reference(kind, block_n):
    x, w, tau = _case(kind, block_n)
    want, rp = rmodule._fwd_impl(jnp.asarray(x), jnp.asarray(w), tau, TILE,
                                 "interpret", block_n, None)
    got = tmodule.spamm_linear(torch.as_tensor(x), torch.as_tensor(w), tau,
                               tile=TILE, backend="torch", block_n=block_n)
    assert got.shape == x.shape[:-1] + (w.shape[1],)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MM_TOL,
                               atol=MM_TOL)
    _, tp = tmodule._fwd_impl(torch.as_tensor(x), torch.as_tensor(w), tau,
                              TILE, "torch", block_n)
    assert int(tp.valid_tiles) == int(rp.valid_tiles)
    if kind == "zero":
        assert float(tp.valid_fraction) == 1.0
    elif kind == "all_out":
        assert int(tp.valid_tiles) == 0 and not got.any()
    else:
        assert 0.0 < float(tp.valid_fraction) < 1.0


@pytest.mark.parametrize("kind,block_n", CASES)
def test_maybe_spamm_matmul_eager_matches_reference(kind, block_n):
    """No frozen plan: the eager plan/execute branch, and its tap."""
    x, w, tau = _case(kind, block_n)
    rcfg = RSpamm(enable=True, tau=tau, tile=TILE, block_n=block_n,
                  backend="interpret")
    want = rmodule.maybe_spamm_matmul(jnp.asarray(x), jnp.asarray(w), rcfg)
    _, rp = rmodule._fwd_impl(jnp.asarray(x), jnp.asarray(w), tau, TILE,
                              "interpret", block_n, None)
    ctx = tmodule.SpammContext(SpammConfig(enable=True, tau=tau, tile=TILE,
                                           block_n=block_n, backend="torch"))
    ctx.begin_stats()
    got = tmodule.maybe_spamm_matmul(torch.as_tensor(x), torch.as_tensor(w),
                                     ctx)
    taps = ctx.end_stats()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MM_TOL,
                               atol=MM_TOL)
    assert [t.phase for t in taps] == ["prefill"]
    assert taps[0].value == pytest.approx(float(rp.valid_fraction), abs=0)


def test_maybe_spamm_matmul_dense_branches():
    """SpAMM off, and the decode contract without a frozen plan, are the
    plain product; spamm_linear is differentiable, while the frozen path
    (inference only, as in the reference) refuses tensors that need
    gradients."""
    x = torch.as_tensor(_rand((4, 48), 2))
    w = torch.as_tensor(_rand((48, 32), 3))
    on = SpammConfig(enable=True, tau=1e9, tile=TILE, backend="torch")
    for cfg, kw in ((None, {}), (SpammConfig(enable=False), {}),
                    (on, {"require_frozen": True})):
        assert torch.equal(tmodule.maybe_spamm_matmul(x, w, cfg, **kw), x @ w)
    xg = x.clone().requires_grad_()
    y = tmodule.spamm_linear(xg, w, 0.0, tile=TILE, backend="torch")
    y.sum().backward()
    torch.testing.assert_close(xg.grad, w.sum(1).expand(4, 48))
    fw = FrozenWeight.build(w, 0.0, tile=TILE, backend="torch")
    with pytest.raises(NotImplementedError):
        tmodule.spamm_linear_frozen(xg, w, fw.for_rows(1))


@pytest.mark.parametrize("spec", ["float32", "f32", "fp32", "bf16",
                                  "bfloat16", "int8", "i8", None])
def test_canonical_dtype_matches_reference(spec):
    assert tquant.canonical_dtype(spec) == rquant.canonical_dtype(spec)
    assert tquant.dtype_itemsize(spec) == rquant.dtype_itemsize(spec)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("tile_n", [None, 32])
def test_quantized_view_matches_reference(dtype, tile_n):
    x = _rand((32, 64), 4) * 3.0
    x[:16, :32] = 0.0  # an all-zero tile: the scale floor
    want = np.asarray(rquant.quantized_view(jnp.asarray(x), dtype, TILE,
                                            tile_n))
    got = tquant.quantized_view(torch.as_tensor(x), dtype, TILE, tile_n)
    np.testing.assert_array_equal(got.numpy(), want)
    if dtype == "int8":
        rq, rs = rquant.quantize_tiles(jnp.asarray(x), TILE, tile_n)
        tq, ts = tquant.quantize_tiles(torch.as_tensor(x), TILE, tile_n)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(rs))
        np.testing.assert_array_equal(
            tquant.tile_absmax(torch.as_tensor(x), TILE, tile_n).numpy(),
            np.asarray(rquant.tile_absmax(jnp.asarray(x), TILE, tile_n)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("tau", [0.0, -1.0, 2.5])
def test_widen_tau_matches_reference(dtype, tau):
    for tile_n in (None, 32):
        assert (tquant.gate_eps(dtype, TILE, tile_n)
                == rquant.gate_eps(dtype, TILE, tile_n))
        want = rquant.widen_tau(tau, dtype, TILE, tile_n)
        assert tquant.widen_tau(tau, dtype, TILE, tile_n) == want
        got_t = tquant.widen_tau(torch.tensor(tau, dtype=torch.float64),
                                 dtype, TILE, tile_n)
        assert float(got_t) == pytest.approx(want, rel=1e-15)
