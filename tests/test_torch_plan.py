"""The port's planner against the reference: structural artifacts are exact.

Work-lists, step tables and flags, nvalid, buckets and frozen-plan tables
must equal the reference's array for array. Where the port computes norms
itself, the inputs are built so every tile norm is exact in f32 (each tile
is ±2^e times a sign pattern, so its sum of squares and square root are
exact in any summation order) and the gate cannot differ by a rounding.
Frozen ≡ eager must be bit-identical inside the port.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cost as rcost
from repro.core import plan as rplan
from repro.plans import frozen as rfrozen
from repro_torch.core import cost as tcost
from repro_torch.core import plan as tplan
from repro_torch.plans import frozen as tfrozen

TILE = 16


def _exact_matrix(gr, gc, seed, zero_frac=0.2):
    """(gr·TILE, gc·TILE) f32 matrix whose tile norms are exact powers of
    two times TILE; about `zero_frac` of the tiles are all zero."""
    rng = np.random.default_rng(seed)
    scale = 2.0 ** rng.integers(-3, 3, size=(gr, gc))
    scale[rng.random((gr, gc)) < zero_frac] = 0.0
    signs = rng.choice([-1.0, 1.0], size=(gr, TILE, gc, TILE))
    x = signs * scale[:, None, :, None]
    return x.reshape(gr * TILE, gc * TILE).astype(np.float32)


def _np(x):
    return None if x is None else np.asarray(x)


def test_bucket_and_ladder_match():
    for n in list(range(0, 70)) + [1000, 4096, 4097, 165888]:
        for minimum in (1, 16, 64):
            assert tcost.bucket(n, minimum) == rcost.bucket(n, minimum)
    for n_max in (1, 5, 16, 17, 300):
        assert tcost.bucket_ladder(n_max, 4) == rcost.bucket_ladder(n_max, 4)


@pytest.mark.parametrize("block_n,assume_sorted,density", [
    (1, False, 0.3), (2, False, 0.3), (1, True, 0.5), (1, False, 0.0)])
def test_compact_from_triples_matches(block_n, assume_sorted, density):
    gm, gn, gk = 3, 8, 5
    mask = np.random.default_rng(0).random((gm, gn, gk)) < density
    ii, jj, kk = np.nonzero(mask)
    if not assume_sorted:
        perm = np.random.default_rng(1).permutation(ii.size)
        ii, jj, kk = ii[perm], jj[perm], kk[perm]
    kw = dict(gm=gm, gn=gn, gk=gk, block_n=block_n,
              assume_sorted=assume_sorted)
    rw, rnv = rplan.compact_from_triples(ii, jj, kk, **kw)
    tw, tnv = tplan.compact_from_triples(ii, jj, kk, **kw)
    np.testing.assert_array_equal(tnv, rnv)
    for name in rw._fields:
        np.testing.assert_array_equal(getattr(tw, name), _np(getattr(rw, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(tw.runs, tw.offsets)


@pytest.mark.parametrize("block_n", [1, 2])
def test_plan_from_reference_normmaps(block_n):
    rng = np.random.default_rng(2)
    na = rng.random((4, 6)).astype(np.float32)
    nb = rng.random((6, 8)).astype(np.float32)
    tau = float(np.median(na[:, None, :] * nb.T[None]))
    rp = rplan.plan(norm_a=jnp.asarray(na), norm_b=jnp.asarray(nb), tau=tau,
                    tile=TILE, block_n=block_n, backend="interpret")
    tp = tplan.plan(norm_a=torch.as_tensor(na), norm_b=torch.as_tensor(nb),
                    tau=tau, tile=TILE, block_n=block_n, backend="torch")
    for name in rp.work._fields:
        np.testing.assert_array_equal(getattr(tp.work, name).numpy(),
                                      _np(getattr(rp.work, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(tp.nvalid.numpy(), _np(rp.nvalid))
    assert int(tp.valid_tiles) == int(rp.valid_tiles)
    np.testing.assert_array_equal(tp.mask.numpy(), _np(rp.mask))
    np.testing.assert_array_equal(
        tplan.gate_mask(torch.as_tensor(na), torch.as_tensor(nb), tau,
                        block_n).numpy(),
        _np(rplan.gate_mask(jnp.asarray(na), jnp.asarray(nb), tau, block_n)))


def _frozen_pair(w, tau, block_n):
    rfw = rfrozen.FrozenWeight.build(jnp.asarray(w), tau, tile=TILE,
                                     block_n=block_n, backend="jnp")
    tfw = tfrozen.FrozenWeight.build(torch.as_tensor(w), tau, tile=TILE,
                                     block_n=block_n, backend="torch")
    return rfw, tfw


@pytest.mark.parametrize("tau", [0.0, 256.0])
@pytest.mark.parametrize("block_n", [1, 2])
def test_frozen_weight_tables_match(tau, block_n):
    w = _exact_matrix(4, 6, seed=3)
    rfw, tfw = _frozen_pair(w, tau, block_n)
    np.testing.assert_array_equal(tfw.kj_k, _np(rfw.kj_k))
    np.testing.assert_array_equal(tfw.kj_j, _np(rfw.kj_j))
    np.testing.assert_array_equal(tfw.nbmax.numpy(), _np(rfw.nbmax))
    for gm in (1, 3):
        rfp, tfp = rfw.for_rows(gm), tfw.for_rows(gm)
        for name in ("step_i", "step_j", "step_k", "step_real", "seg_first",
                     "seg_last"):
            np.testing.assert_array_equal(getattr(tfp, name).numpy(),
                                          _np(getattr(rfp, name)),
                                          err_msg=name)
        assert tfp.tau == float(rfp.tau)
        # runs are the segment boundaries the flag arithmetic already uses,
        # cut at the last real step (bucket padding is never walked)
        runs = tfp.runs.numpy()
        s_real = int(tfp.step_real.sum())
        assert runs[-1] == s_real
        np.testing.assert_array_equal(
            np.repeat(runs[:-1], np.diff(runs)),
            tfp.seg_first.numpy()[:s_real])


@pytest.mark.parametrize("block_n", [1, 2])
def test_frozen_step_flags_match(block_n):
    rfw, tfw = _frozen_pair(_exact_matrix(4, 6, seed=4), 256.0, block_n)
    rfp, tfp = rfw.for_rows(2), tfw.for_rows(2)
    real = np.asarray(rfp.step_real)
    for seed in range(3):
        active = real & (np.random.default_rng(seed).random(real.size) < 0.4)
        want = np.asarray(rplan._frozen_step_flags(rfp, jnp.asarray(active)))
        got = tplan._frozen_step_flags(tfp, torch.as_tensor(active))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("tau,block_n", [(256.0, 1), (64.0, 2), (0.0, 1)])
def test_plan_frozen_matches(tau, block_n):
    w = _exact_matrix(4, 6, seed=5)
    x = _exact_matrix(3, 4, seed=6)
    rfw, tfw = _frozen_pair(w, tau, block_n)
    rp = rplan._plan_frozen(jnp.asarray(x), rfw.for_rows(3))
    tp = tplan._plan_frozen(torch.as_tensor(x), tfw.for_rows(3))
    np.testing.assert_array_equal(tp.work.step_flags.numpy(),
                                  _np(rp.work.step_flags))
    np.testing.assert_array_equal(tp.nvalid.numpy(), _np(rp.nvalid))
    assert tp.nvalid.dtype == torch.int32
    assert int(tp.valid_tiles) == int(rp.valid_tiles)
    assert float(tp.valid_fraction) == float(rp.valid_fraction)
    # the eager flat gate on the same operands keeps the same tiles
    tpe = tplan.plan(torch.as_tensor(x), torch.as_tensor(w), tau, tile=TILE,
                     block_n=block_n, backend="torch")
    np.testing.assert_array_equal(tpe.nvalid.numpy(), tp.nvalid.numpy())


def test_frozen_all_zero_weight_gates_everything_out():
    """τ > 0 on an all-zero weight: no admissible pair, no run, zero output
    (the reference's empty-plan case)."""
    x = torch.as_tensor(_exact_matrix(2, 4, seed=8, zero_frac=0.0))
    w = torch.zeros(4 * TILE, 3 * TILE)
    fw = tfrozen.FrozenWeight.build(w, 1.0, tile=TILE)
    assert fw.num_kj == 0
    p = tplan.plan(x, frozen_weight=fw.for_rows(2))
    assert p.work.runs.tolist() == [0] and float(p.valid_fraction) == 0.0
    assert not tplan.execute(p, x, w).any()


@pytest.mark.parametrize("block_n", [1, 2])
def test_frozen_equals_eager_bitwise(block_n):
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.standard_normal((48, 64)).astype(np.float32))
    w = torch.as_tensor(rng.standard_normal((64, 96)).astype(np.float32))
    na = tplan.kops.tile_norms(x, TILE)
    nb = tplan.kops.tile_norms(w, TILE)
    tau = float(torch.quantile((na[:, None, :] * nb.T[None]).flatten(), 0.5))
    eager = tplan.plan(x, w, tau, tile=TILE, block_n=block_n)
    fw = tfrozen.FrozenWeight.build(w, tau, tile=TILE, block_n=block_n)
    frozen = tplan.plan(x, frozen_weight=fw.for_rows(3))
    assert int(eager.valid_tiles) == int(frozen.valid_tiles)
    assert 0 < float(frozen.valid_fraction) < 1
    c_eager = tplan.execute(eager, x, w)
    c_frozen = tplan.execute(frozen, x, w)
    assert torch.equal(c_eager, c_frozen)
    # τ = 0 keeps every tile: the dense product up to f32 reassociation
    full = tplan.plan(x, frozen_weight=tfrozen.FrozenWeight.build(
        w, 0.0, tile=TILE, block_n=block_n).for_rows(3))
    assert float(full.valid_fraction) == 1.0
    torch.testing.assert_close(tplan.execute(full, x, w), x @ w,
                               rtol=1e-5, atol=1e-5)


def _exact_matrix_at(gr, gc, tile, seed, zero_frac=0.2):
    """`_exact_matrix` at any tile: (gr·tile, gc·tile), every tile ±2^e
    times a sign pattern, so its norm 2^e·tile is exact in f32."""
    rng = np.random.default_rng(seed)
    scale = 2.0 ** rng.integers(-3, 3, size=(gr, gc))
    scale[rng.random((gr, gc)) < zero_frac] = 0.0
    signs = rng.choice([-1.0, 1.0], size=(gr, tile, gc, tile))
    x = signs * scale[:, None, :, None]
    return x.reshape(gr * tile, gc * tile).astype(np.float32)


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("block_n", [1, 2])
def test_freeze_weight_matches_reference(tile, block_n):
    """`freeze_weight`, the twin of the reference's alias of
    `FrozenWeight.build`: its tables equal the reference's `freeze_weight`
    on the same weight (pair lists, nbmax, the step tables for 1 and 3 row
    tiles) and the port's own `FrozenWeight.build`."""
    w = _exact_matrix_at(4, 6, tile, seed=9)
    tau = float(2.0 ** 0 * tile * tile)
    rfw = rfrozen.freeze_weight(jnp.asarray(w), tau, tile=tile,
                                block_n=block_n, backend="jnp")
    tfw = tfrozen.freeze_weight(torch.as_tensor(w), tau, tile=tile,
                                block_n=block_n, backend="torch")
    built = tfrozen.FrozenWeight.build(torch.as_tensor(w), tau, tile=tile,
                                       block_n=block_n, backend="torch")
    assert 0 < tfw.num_kj < 6 * (6 // block_n)
    for mine in (tfw, built):
        np.testing.assert_array_equal(mine.kj_k, _np(rfw.kj_k))
        np.testing.assert_array_equal(mine.kj_j, _np(rfw.kj_j))
        np.testing.assert_array_equal(mine.nbmax.numpy(), _np(rfw.nbmax))
    for gm in (1, 3):
        rfp, tfp = rfw.for_rows(gm), tfw.for_rows(gm)
        assert (tfp.tile, tfp.block_n) == (tile, block_n)
        for name in ("step_i", "step_j", "step_k", "step_real",
                     "seg_first", "seg_last"):
            np.testing.assert_array_equal(getattr(tfp, name).numpy(),
                                          _np(getattr(rfp, name)),
                                          err_msg=name)
