"""The tensor-core get-norm variant (`use_mxu=True`, paper Eq. 3-4) of the
port against the JAX reference: the fused int8 get-norm's plain version
against the reference's Pallas kernel in interpret mode (its MXU branch of
`_tile_sumsq`) and its jnp backend, and the planners (`plan`, `spamm`) with
`use_mxu_norm=True` against the reference's. The same numpy inputs go
through both packages; the port runs the plain versions of its kernels (CPU
tensors). The CUDA kernels themselves are held against these plain versions
on the card (tests/test_torch_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan as rplan
from repro.core import spamm as rcs
from repro.kernels import getnorm as rgetnorm
from repro.kernels import ops as rops
from repro_torch.core import plan as tplan
from repro_torch.core import spamm as tcs
from repro_torch.kernels import getnorm as tgetnorm
from repro_torch.kernels import ops as tops

# Eq. 3-4 sums ≤ 32·32 squares in row sums, then their total: the port's
# matmuls and the reference's dot_generals (or its einsum) round in another
# order (measured ≤ 6e-7)
NORM_RTOL = 1e-6
# the reference's jnp backend at tiles 48 and 64: its einsum sums up to
# 64·64 squares in XLA's order and lands up to 9.1e-6 from the reference's
# own Pallas kernel at tile 64 (measured); the port stays within NORM_RTOL
# of that kernel at every tile
JNP_WIDE_RTOL = 2e-5
# τ from the search: the mean norm product sums in another order than XLA's
TAU_RTOL = 1e-5
# f32 GEMM over ≤ 16 tile products of depth 32, relative to the output's
# largest magnitude
MM_RTOL = 1e-5
# relative distance every gate product must keep from τ, far above the
# ~1e-6 relative gap between the two packages' f32 norms
GATE_MARGIN = 1e-3


def _decay(m, n, seed, scale=0.4):
    rng = np.random.default_rng(seed)
    d = np.abs(np.arange(m)[:, None] - np.arange(n)[None, :])
    base = (scale / (d ** 0.5 + 1)).astype(np.float32)
    return base * rng.standard_normal((m, n)).astype(np.float32)


def _products(na, nb):
    return (np.asarray(na)[:, None, :] * np.asarray(nb).T[None]).ravel()


def _gap_tau(products, lo=0.3, hi=0.7):
    """A τ in the widest gap of the sorted positive products between the
    `lo` and `hi` quantiles."""
    p = np.sort(products[products > 0])
    a, b = int(lo * p.size), int(hi * p.size)
    g = a + int(np.argmax(p[a + 1:b + 1] / p[a:b]))
    return float(np.sqrt(p[g] * p[g + 1]))


@pytest.mark.parametrize("tile", [16, 32, 48, 64])
def test_tile_norms_quant_plain_mxu_matches_reference(tile):
    """Plain fused int8 get-norm under use_mxu=True against the reference's
    kernel in interpret mode and its jnp backend: norms within NORM_RTOL
    (of the jnp backend at tiles above 32: JNP_WIDE_RTOL), scales bit for
    bit; and the plain fused version is the unfused composition with the
    Eq. 3-4 sum."""
    x = _decay(4 * tile, 3 * tile, 0)
    x[:tile, :tile] = 0.0                   # an all-zero tile
    norms, scales = tgetnorm.tile_norms_quant_plain(torch.as_tensor(x), tile,
                                                    use_mxu=True)
    rn, rs = rgetnorm.tile_norms_quant(jnp.asarray(x), tile, use_mxu=True,
                                       interpret=True)
    jn, js = rops.int8_norms_and_scales(jnp.asarray(x), tile, backend="jnp",
                                        use_mxu=True)
    jnp_rtol = NORM_RTOL if tile <= 32 else JNP_WIDE_RTOL
    for want_n, want_s, rtol in ((rn, rs, NORM_RTOL), (jn, js, jnp_rtol)):
        np.testing.assert_array_equal(scales.numpy(), np.asarray(want_s))
        np.testing.assert_allclose(norms.numpy(), np.asarray(want_n),
                                   rtol=rtol, atol=0)
    n2, s2 = tops.int8_norms_and_scales(torch.as_tensor(x), tile,
                                        backend="auto", use_mxu=True)
    assert torch.equal(n2, norms) and torch.equal(s2, scales)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("block_n", [1, 2])
def test_plan_mxu_norms_match_reference(block_n, dtype):
    """plan(use_mxu_norm=True) from the matrices, τ in a gap of the
    products: the reference's normmaps within NORM_RTOL and its tables
    array for array."""
    tile = 32
    a, b = _decay(96, 128, 1), _decay(128, 256, 2)
    rp0 = rplan.plan(jnp.asarray(a), jnp.asarray(b), 0.0, tile=tile,
                     backend="interpret", use_mxu_norm=True,
                     compute_dtype=dtype)
    tau = _gap_tau(_products(rp0.norm_a, rp0.norm_b))
    kw = dict(tile=tile, block_n=block_n, use_mxu_norm=True,
              compute_dtype=dtype)
    rp = rplan.plan(jnp.asarray(a), jnp.asarray(b), tau, backend="interpret",
                    **kw)
    tp = tplan.plan(torch.as_tensor(a), torch.as_tensor(b), tau,
                    backend="torch", **kw)
    np.testing.assert_allclose(tp.norm_a.numpy(), np.asarray(rp.norm_a),
                               rtol=NORM_RTOL, atol=0)
    np.testing.assert_allclose(tp.norm_b.numpy(), np.asarray(rp.norm_b),
                               rtol=NORM_RTOL, atol=0)
    prods = _products(tp.norm_a, tp.norm_b)
    assert np.min(np.abs(prods - tp.tau)) / tp.tau >= GATE_MARGIN
    assert tp.tau == float(rp.tau)
    assert 0.0 < float(tp.valid_fraction) < 1.0
    for name in rp.work._fields:
        np.testing.assert_array_equal(getattr(tp.work, name).numpy(),
                                      np.asarray(getattr(rp.work, name)),
                                      err_msg=name)


def test_spamm_valid_ratio_with_mxu_norms_matches_reference():
    """spamm(valid_ratio=0.3, use_mxu_norm=True) on the paper's ensemble:
    the reference's τ within TAU_RTOL, the same achieved ratio, and its
    product; plan(valid_ratio) fed the reference's Eq. 3-4 normmaps gives
    its tables array for array."""
    n, tile = 512, 32
    a = rcs.algebraic_decay(n, c=0.1, lam=0.1, seed=0)
    b = rcs.algebraic_decay(n, c=0.1, lam=0.1, seed=1)
    rc, rinfo = rcs.spamm(jnp.asarray(a), jnp.asarray(b), valid_ratio=0.3,
                          tile=tile, backend="interpret", use_mxu_norm=True)
    tc, tinfo = tcs.spamm(torch.as_tensor(a), torch.as_tensor(b),
                          valid_ratio=0.3, tile=tile, backend="torch",
                          use_mxu_norm=True)
    assert tinfo.tau == pytest.approx(float(rinfo.tau), rel=TAU_RTOL)
    assert abs(float(tinfo.valid_fraction) - 0.3) <= 0.01
    assert float(tinfo.valid_fraction) == pytest.approx(
        float(rinfo.valid_fraction), abs=1e-6)
    rc = np.asarray(rc)
    scale = float(np.abs(rc).max())
    np.testing.assert_allclose(tc.numpy(), rc, rtol=0, atol=MM_RTOL * scale)

    na, nb = (np.array(rgetnorm.tile_norms(jnp.asarray(x), tile,
                                           use_mxu=True, interpret=True))
              for x in (a, b))
    rp = rplan.plan(None, None, norm_a=jnp.asarray(na),
                    norm_b=jnp.asarray(nb), valid_ratio=0.3, tile=tile,
                    backend="interpret")
    tp = tplan.plan(None, None, norm_a=torch.as_tensor(na),
                    norm_b=torch.as_tensor(nb), valid_ratio=0.3, tile=tile,
                    backend="torch")
    assert tp.tau == pytest.approx(float(rp.tau), rel=TAU_RTOL)
    for name in rp.work._fields:
        np.testing.assert_array_equal(getattr(tp.work, name).numpy(),
                                      np.asarray(getattr(rp.work, name)),
                                      err_msg=name)


def test_mxu_norms_differ_from_cuda_core_norms_by_ulps():
    """The two get-norm variants compute the same norms up to rounding:
    within NORM_RTOL of each other on the plain versions."""
    x = torch.as_tensor(_decay(128, 96, 3))
    np.testing.assert_allclose(
        tgetnorm.tile_norms_plain(x, 32, use_mxu=True).numpy(),
        tgetnorm.tile_norms_plain(x, 32).numpy(), rtol=NORM_RTOL, atol=0)
