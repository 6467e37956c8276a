"""The port's norm pyramid and hierarchical gating against the JAX reference.

(a) the plain pooling and pyramid against the reference's Pallas pooling in
    interpret mode and its `norm_pyramid`, odd dims included;
(b) the coarse-to-fine descent: surviving triples equal to the reference's
    on shared normmaps;
(c) the exactness invariant: a hierarchical plan's tables equal the flat
    plan's, array for array, across levels, block_n, ragged grids and fully
    pruned or fully dense gates — and equal the reference's hierarchical
    plan on the same normmaps.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan as rplan
from repro.kernels import getnorm as rgetnorm
from repro.kernels import ref as rref
from repro_torch.core import plan as tplan
from repro_torch.kernels import getnorm as tgetnorm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# f32 pooling: the Pallas body pairs columns with a 0/1 dot, the plain
# version with an add; an ulp apart at most
NORM_RTOL = 1e-6


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _decay(m, n, seed, lam=0.6):
    rng = np.random.default_rng(seed)
    d = np.abs(np.arange(m)[:, None] - np.arange(n)[None, :])
    return (lam ** d * rng.uniform(0.5, 1.0, (m, n))
            * rng.choice([-1.0, 1.0], (m, n))).astype(np.float32)


# ---------------------------------------------------------------------------
# (a) pooling and pyramid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(8, 8), (5, 7), (6, 3), (1, 1)])
def test_pool_norms_plain_matches_reference(shape):
    x = np.abs(_rand(shape, 0))
    want = np.asarray(rgetnorm.pool_norms(jnp.asarray(x), interpret=True))
    got = tgetnorm.pool_norms_plain(torch.as_tensor(x))
    assert got.shape == ((shape[0] + 1) // 2, (shape[1] + 1) // 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=NORM_RTOL)
    np.testing.assert_allclose(
        got.numpy(), tref.pool_norms_ref(torch.as_tensor(x)).numpy(),
        rtol=NORM_RTOL)
    # `auto` on a CPU tensor is the plain version
    assert torch.equal(tgetnorm.pool_norms(torch.as_tensor(x)), got)


def test_pool_norms_plain_batched_slices():
    """Leading dims are slices pooled on their own: odd dims never pair
    entries across slices."""
    x = np.abs(_rand((3, 5, 7), 1))
    got = tgetnorm.pool_norms_plain(torch.as_tensor(x))
    want = np.asarray(rref.pool_norms_ref(jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=NORM_RTOL)
    for s in range(3):
        assert torch.equal(got[s], tgetnorm.pool_norms_plain(
            torch.as_tensor(x[s])))
    with pytest.raises(ValueError):
        tgetnorm.pool_norms_cuda(torch.as_tensor(x))  # not a CUDA tensor


@pytest.mark.parametrize("shape,levels", [((64, 96), 2), ((48, 80), 2),
                                          ((128, 128), 3)])
def test_pyramid_norms_match_reference(shape, levels):
    """One get-norm pass plus the poolings against the reference's
    `norm_pyramid` in interpret mode; grids (4, 6), ragged (3, 5) → (2, 3)
    → (1, 2), and (8, 8) down to (1, 1)."""
    tile = 16
    x = _rand(shape, 2)
    want = rgetnorm.norm_pyramid(jnp.asarray(x), tile, levels, interpret=True)
    got = tops.pyramid_norms(torch.as_tensor(x), tile, levels,
                             backend="torch")
    assert len(got) == levels + 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=NORM_RTOL)
    pyr = tplan.NormPyramid.build(torch.as_tensor(x), levels, tile=tile)
    assert pyr.num_levels == levels and pyr.coarse_tile == tile * 2 ** levels
    for g, p in zip(got, pyr.levels):
        assert torch.equal(g, p)


def test_pyramid_levels_are_direct_norms_and_upper_bound_children():
    """levels[l] is the get-norm at tile·2^l (within f32 rounding), and
    every coarse entry bounds each of its children."""
    x = torch.as_tensor(_rand((128, 256), 3))
    pyr = tplan.NormPyramid.build(x, 2, tile=16, backend="torch")
    for l in range(3):
        np.testing.assert_allclose(
            pyr.levels[l].numpy(),
            tref.tile_norms_ref(x, 16 * 2 ** l).numpy(), rtol=1e-5)
    for l in range(1, 3):
        fine, coarse = pyr.levels[l - 1].numpy(), pyr.levels[l].numpy()
        up = np.repeat(np.repeat(coarse, 2, 0), 2, 1)[:fine.shape[0],
                                                     :fine.shape[1]]
        assert (up >= fine * (1 - 1e-6)).all()


def test_extended_and_from_normmap():
    base = torch.as_tensor(np.abs(_rand((6, 5), 4)))
    pyr = tplan.NormPyramid.from_normmap(base, 1, tile=16)
    assert pyr.extended(1) is pyr
    deep = pyr.extended(3)
    assert deep.num_levels == 3 and deep.levels[:2] == pyr.levels
    assert torch.equal(deep.coarse,
                       tplan.NormPyramid.from_normmap(base, 3).coarse)
    assert deep.coarse.shape == (1, 1) and deep.base is base


# ---------------------------------------------------------------------------
# (b) the descent on shared normmaps
# ---------------------------------------------------------------------------

def _shared_levels(gm, gk, gn, levels, seed):
    """Per-level numpy normmaps, pooled by the reference, for both
    packages."""
    rng = np.random.default_rng(seed)
    na = rng.uniform(0, 1, (gm, gk)).astype(np.float32)
    nb = rng.uniform(0, 1, (gk, gn)).astype(np.float32)
    la, lb = [na], [nb]
    for _ in range(levels):
        la.append(np.asarray(rref.pool_norms_ref(jnp.asarray(la[-1]))))
        lb.append(np.asarray(rref.pool_norms_ref(jnp.asarray(lb[-1]))))
    tau = float(np.float32(np.median(na[:, None, :] * nb.T[None])))
    return la, lb, tau


@pytest.mark.parametrize("levels,grid", [(1, (6, 8, 4)), (2, (5, 7, 9)),
                                         (3, (9, 6, 11))])
def test_hier_descend_triples_match_reference(levels, grid):
    la, lb, tau = _shared_levels(*grid, levels, seed=levels)
    want = rplan._hier_descend_host(la, lb, tau)
    got = tplan._hier_descend_host(la, lb, tau)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(tplan._hier_mask_host(la, lb, tau),
                                  rplan._hier_mask_host(la, lb, tau))


@pytest.mark.parametrize("block_n", [1, 2])
def test_hier_gate_mask_equals_flat_and_reference(block_n):
    la, lb, tau = _shared_levels(7, 9, 10, 2, seed=5)
    tpa = tplan.NormPyramid([torch.as_tensor(x) for x in la], tile=16)
    tpb = tplan.NormPyramid([torch.as_tensor(x) for x in lb], tile=16)
    got = tplan.hier_gate_mask(tpa, tpb, tau, block_n)
    np.testing.assert_array_equal(
        got, tplan.gate_mask(tpa.base, tpb.base, tau, block_n).numpy())
    rpa = rplan.NormPyramid([jnp.asarray(x) for x in la], tile=16)
    rpb = rplan.NormPyramid([jnp.asarray(x) for x in lb], tile=16)
    np.testing.assert_array_equal(
        got, np.asarray(rplan.hier_gate_mask(rpa, rpb, tau, block_n)))


# ---------------------------------------------------------------------------
# (c) hierarchical plans ≡ flat plans, and ≡ the reference's
# ---------------------------------------------------------------------------

def _assert_same_plan(p, q):
    for name in p.work._fields:
        x, y = getattr(p.work, name), getattr(q.work, name)
        assert torch.equal(x, y), name
    assert torch.equal(p.nvalid, q.nvalid)
    assert int(p.valid_tiles) == int(q.valid_tiles)


HIER_CASES = [(levels, block_n, shape)
              for levels in (1, 2, 3) for block_n in (1, 2)
              for shape in ((96, 112, 128), (80, 144, 96))]


@pytest.mark.parametrize("levels,block_n,shape", HIER_CASES)
def test_hier_plan_equals_flat(levels, block_n, shape):
    """Ragged grids ((6, 7, 8) and (5, 9, 6) tiles, so coarse levels
    overhang), τ at the median fine product — the boundary case where a
    sloppy coarse test would flip tiles."""
    m, k, n = shape
    a = torch.as_tensor(_decay(m, k, 10))
    b = torch.as_tensor(_decay(k, n, 11))
    na, nb = tops.tile_norms(a, 16), tops.tile_norms(b, 16)
    tau = float((na[:, None, :] * nb.T[None]).flatten().median())
    p0 = tplan.plan(a, b, tau, tile=16, block_n=block_n, backend="torch")
    pl = tplan.plan(a, b, tau, tile=16, block_n=block_n, backend="torch",
                    levels=levels)
    assert 0.0 < float(p0.valid_fraction) < 1.0
    assert (p0.levels, pl.levels) == (0, levels)
    _assert_same_plan(p0, pl)
    assert torch.equal(tplan.execute(p0, a, b), tplan.execute(pl, a, b))


@pytest.mark.parametrize("levels", [1, 3])
@pytest.mark.parametrize("block_n", [1, 2])
def test_hier_plan_matches_reference_on_shared_normmaps(levels, block_n):
    rng = np.random.default_rng(20 + levels)
    na = rng.uniform(0, 1, (9, 7)).astype(np.float32)
    nb = rng.uniform(0, 1, (7, 10)).astype(np.float32)
    tau = float(np.median(na[:, None, :] * nb.T[None]))
    kw = dict(tile=16, block_n=block_n, levels=levels)
    rp = rplan.plan(None, None, tau, norm_a=jnp.asarray(na),
                    norm_b=jnp.asarray(nb), backend="interpret", **kw)
    tp = tplan.plan(None, None, tau, norm_a=torch.as_tensor(na),
                    norm_b=torch.as_tensor(nb), backend="torch", **kw)
    for name in rp.work._fields:
        np.testing.assert_array_equal(getattr(tp.work, name).numpy(),
                                      np.asarray(getattr(rp.work, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(tp.nvalid.numpy(), np.asarray(rp.nvalid))
    assert tp.levels == rp.levels == levels


@pytest.mark.parametrize("levels", [1, 2])
def test_hier_fully_pruned_and_fully_dense(levels):
    a = torch.as_tensor(_decay(96, 128, 12))
    b = torch.as_tensor(_decay(128, 64, 13))
    hi = tplan.plan(a, b, 1e9, tile=32, backend="torch", levels=levels)
    assert int(hi.valid_tiles) == 0 and hi.work.runs.tolist() == [0]
    assert not tplan.execute(hi, a, b).any()
    _assert_same_plan(hi, tplan.plan(a, b, 1e9, tile=32, backend="torch"))
    lo = tplan.plan(a, b, 0.0, tile=32, backend="torch", levels=levels)
    assert int(lo.valid_tiles) == lo.total_tiles
    _assert_same_plan(lo, tplan.plan(a, b, 0.0, tile=32, backend="torch"))


def test_hier_plan_from_pyramid_operands():
    """plan() takes NormPyramid operands (the cached-weight shape) and
    deepens the shallower one instead of failing."""
    a = torch.as_tensor(_decay(128, 128, 14))
    b = torch.as_tensor(_decay(128, 128, 15))
    pa = tplan.NormPyramid.build(a, 2, tile=32, backend="torch")
    pb = tplan.NormPyramid.build(b, 1, tile=32, backend="torch")
    p = tplan.plan(None, None, 0.05, norm_a=pa, norm_b=pb, tile=32,
                   backend="torch")
    assert p.levels == 2
    _assert_same_plan(p, tplan.plan(a, b, 0.05, tile=32, backend="torch"))
    with pytest.raises(ValueError):
        tplan.plan(a, None, 0.05, tile=32, levels=1)
