"""The port's library path against the JAX reference: the dense-grid GEMM,
the valid-ratio τ-search, `spamm()`, `spamm_bmm` and the weight cache.

The same numpy inputs go through both packages. The reference runs its
Pallas kernels in interpret mode (or its jnp oracle); the port runs the
plain versions of its kernels (CPU tensors). Where both packages compute
norms themselves, τ sits in a gap of the norm products, so the few-ulp
differences between their reductions cannot flip a tile. The pyramid and
hierarchical gating are in test_torch_pyramid.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan as rplan
from repro.core import spamm as rcs
from repro.core import tau_search as rts
from repro.kernels import ref as rref
from repro.kernels import spamm_mm as rmm
from repro_torch.configs import SpammConfig
from repro_torch.core import module as tmodule
from repro_torch.core import plan as tplan
from repro_torch.core import spamm as tcs
from repro_torch.core import tau_search as tts
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import spamm_mm as tmm

# f32 GEMM over ≤ 4 tile products of depth 16: accumulation-order rounding
MM_TOL = 1e-5
# τ from the search: the mean norm product sums in another order than XLA's
TAU_RTOL = 1e-5
# τ sits in a gap of the norm products at least this wide (relative)
GAP_RTOL = 1e-4


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _decay(m, n, seed, scale=0.4):
    rng = np.random.default_rng(seed)
    d = np.abs(np.arange(m)[:, None] - np.arange(n)[None, :])
    base = (scale / (d ** 0.5 + 1)).astype(np.float32)
    return base * rng.standard_normal((m, n)).astype(np.float32)


def _gap_tau(na, nb):
    """A τ in the middle of the widest gap of the norm products between
    their 30th and 70th percentiles."""
    prods = np.unique(na[..., :, None, :] * np.swapaxes(nb, -1, -2)[..., None,
                                                                     :, :])
    lo, hi = int(0.3 * prods.size), int(0.7 * prods.size)
    gaps = prods[lo + 1:hi] - prods[lo:hi - 1]
    g = int(np.argmax(gaps))
    a, b = prods[lo + g], prods[lo + g + 1]
    assert (b - a) / b > GAP_RTOL, (a, b)
    return float((a + b) / 2)


def _norms(x, tile):
    """Reference normmap of a (..., M, K) numpy matrix (zero-padded)."""
    m, k = x.shape[-2:]
    x = np.pad(x, [(0, 0)] * (x.ndim - 2) + [(0, (-m) % tile),
                                              (0, (-k) % tile)])
    lead = x.shape[:-2]
    x2 = x.reshape(-1, x.shape[-1])
    n = np.array(rref.tile_norms_ref(jnp.asarray(x2), tile))
    return n.reshape(*lead, x.shape[-2] // tile, -1)


# ---------------------------------------------------------------------------
# dense-grid GEMM and the compaction it consumes
# ---------------------------------------------------------------------------

def _mask(kind, shape, seed):
    if kind == "empty":
        return np.zeros(shape, bool)
    if kind == "full":
        return np.ones(shape, bool)
    return np.random.default_rng(seed).random(shape) < 0.5


@pytest.mark.parametrize("block_n", [1, 2])
@pytest.mark.parametrize("kind", ["random", "empty", "full"])
def test_spamm_mm_plain_matches_reference(kind, block_n):
    """Plain dense-grid vs the Pallas kernel in interpret mode on the same
    kidx/nvalid; and plain dense-grid ≡ plain work-list bit for bit on the
    same mask."""
    tile, m, k, n = 16, 32, 64, 64
    gm, gk, gnb = m // tile, k // tile, n // (tile * block_n)
    a, b = _rand((m, k), 1), _rand((k, n), 2)
    mask = _mask(kind, (gm, gnb, gk), 3)
    kidx, nvalid = rref.spamm_compact_ref(jnp.asarray(mask))
    want = np.asarray(rmm.spamm_mm(jnp.asarray(a), jnp.asarray(b), kidx,
                                   nvalid, tile=tile, block_n=block_n,
                                   interpret=True))
    tk, tn = tref.spamm_compact_ref(torch.as_tensor(mask))
    at, bt = torch.as_tensor(a), torch.as_tensor(b)
    got = tmm.spamm_mm_plain(at, bt, tk, tn, tile=tile, block_n=block_n)
    np.testing.assert_allclose(got.numpy(), want, rtol=MM_TOL, atol=MM_TOL)
    assert torch.equal(tops.get_backend("auto").matmul(
        at, bt, None, tk, tn, tile, block_n, torch.float32), got)
    work, _ = tplan.compact_from_triples(*np.nonzero(mask), gm=gm, gn=gnb,
                                         gk=gk)
    tables = [torch.as_tensor(x) for x in (work.step_i, work.step_j,
                                           work.step_k, work.step_flags,
                                           work.runs)]
    assert torch.equal(got, tmm.spamm_mm_worklist_plain(
        at, bt, *tables, tile=tile, block_n=block_n))
    if kind == "empty":
        assert not got.any()


def test_spamm_mm_plain_batch_is_per_slice():
    """A batch of per-slice products in one call ≡ the slices one by one."""
    tile, bsz, m, k, n = 16, 3, 32, 48, 32
    a, b = _rand((bsz, m, k), 4), _rand((bsz, k, n), 5)
    mask = _mask("random", (bsz, m // tile, n // tile, k // tile), 6)
    kidx, nvalid = tref.spamm_compact_ref(torch.as_tensor(mask))
    got = tmm.spamm_mm_plain(torch.as_tensor(a), torch.as_tensor(b), kidx,
                             nvalid, tile=tile)
    assert got.shape == (bsz, m, n)
    for s in range(bsz):
        assert torch.equal(got[s], tmm.spamm_mm_plain(
            torch.as_tensor(a[s]), torch.as_tensor(b[s]), kidx[s], nvalid[s],
            tile=tile))


def test_spamm_mm_rejects_bad_shapes():
    a, b = torch.zeros(32, 32), torch.zeros(32, 32)
    kidx = torch.zeros(2, 2, 2, dtype=torch.int32)
    nvalid = torch.zeros(2, 2, dtype=torch.int32)
    with pytest.raises(ValueError):
        tmm.spamm_mm_plain(a, b, kidx[:1], nvalid, tile=16)
    with pytest.raises(ValueError):
        tmm.spamm_mm_cuda(a, b, kidx, nvalid, tile=16)  # not a CUDA tensor


@pytest.mark.parametrize("shape", [(3, 4, 5), (2, 3, 4, 6), (1, 1, 1)])
def test_spamm_compact_ref_matches_reference(shape):
    """Batched compaction ≡ the reference's compaction mapped over the
    batch (`jax.vmap`, as its `spamm_bmm` does)."""
    mask = _mask("random", shape, 7)
    fn = rref.spamm_compact_ref
    for _ in range(len(shape) - 3):
        fn = jax.vmap(fn)
    want_k, want_n = fn(jnp.asarray(mask))
    got_k, got_n = tops.spamm_compact(torch.as_tensor(mask))
    assert got_k.dtype == got_n.dtype == torch.int32
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))


@pytest.mark.parametrize("trial", range(4))
def test_kidx_from_work_matches_reference(trial):
    rng = np.random.default_rng(10 + trial)
    gm, gn, gk = (int(v) for v in rng.integers(1, 7, 3))
    na = rng.uniform(0, 1, (gm, gk)).astype(np.float32)
    nb = rng.uniform(0, 1, (gk, gn)).astype(np.float32)
    tau = float(rng.uniform(0.05, 0.8))
    rp = rplan.plan(None, None, tau, norm_a=jnp.asarray(na),
                    norm_b=jnp.asarray(nb), tile=16, backend="interpret")
    tp = tplan.plan(None, None, tau, norm_a=torch.as_tensor(na),
                    norm_b=torch.as_tensor(nb), tile=16, backend="torch")
    got = tplan.kidx_from_work(tp.work, gm, gn, gk)
    np.testing.assert_array_equal(got, rplan.kidx_from_work(rp.work, gm, gn,
                                                             gk))
    kidx, nvalid = tref.spamm_compact_ref(tp.mask)
    np.testing.assert_array_equal(got, kidx.numpy())
    np.testing.assert_array_equal(tp.nvalid.numpy(), nvalid.numpy())


def test_spamm_matmul_ref_and_ops_match_reference():
    tile = 16
    a, b = _decay(48, 64, 8), _decay(64, 32, 9)
    tau = _gap_tau(_norms(a, tile), _norms(b, tile))
    want = np.asarray(rref.spamm_matmul_ref(jnp.asarray(a), jnp.asarray(b),
                                            tau, tile))
    got = tref.spamm_matmul_ref(torch.as_tensor(a), torch.as_tensor(b), tau,
                                tile)
    np.testing.assert_allclose(got.numpy(), want, rtol=MM_TOL, atol=MM_TOL)
    c, info = tops.spamm_matmul(torch.as_tensor(a), torch.as_tensor(b), tau,
                                tile=tile, backend="torch")
    np.testing.assert_allclose(c.numpy(), want, rtol=MM_TOL, atol=MM_TOL)
    assert 0.0 < float(info["valid_fraction"]) < 1.0
    assert int(info["nvalid"].sum()) == int(info["valid_tiles"])
    assert float(tops.spamm_effective_flops(48, 64, 32, 0.5)) == 48 * 64 * 32


# ---------------------------------------------------------------------------
# valid-ratio τ-search (paper §3.5.2)
# ---------------------------------------------------------------------------

def _ensemble(n=1024, tile=64):
    """The paper's §4.1 ensemble: a_ij = 0.1/(|i-j|^0.1+1), random signs."""
    na = _norms(rcs.algebraic_decay(n, c=0.1, lam=0.1, seed=0), tile)
    nb = _norms(rcs.algebraic_decay(n, c=0.1, lam=0.1, seed=1), tile)
    return na, nb


@pytest.mark.parametrize("pyramid", [False, True])
@pytest.mark.parametrize("target", [0.30, 0.15, 0.05])
def test_search_tau_matches_reference(target, pyramid):
    na, nb = _ensemble()
    if pyramid:
        ra, rb = (rplan.NormPyramid.from_normmap(jnp.asarray(x), 2, tile=64)
                  for x in (na, nb))
        ta, tb = (tplan.NormPyramid.from_normmap(torch.as_tensor(x), 2,
                                                 tile=64) for x in (na, nb))
        want_tau, want = rts.search_tau_pyramid(ra, rb, target)
        tau, res = tts.search_tau_pyramid(ta, tb, target)
    else:
        want_tau, want = rts.search_tau(jnp.asarray(na), jnp.asarray(nb),
                                        target)
        tau, res = tts.search_tau(torch.as_tensor(na), torch.as_tensor(nb),
                                  target)
    assert tau == pytest.approx(float(want_tau), rel=TAU_RTOL)
    assert abs(res.achieved_ratio - target) <= (0.02 if pyramid else 0.01)
    assert res.achieved_ratio == pytest.approx(float(want.achieved_ratio),
                                               abs=1e-6)
    assert res.iterations <= 40
    # the achieved ratio is the ratio of the returned τ
    got = float(tcs.valid_ratio_of(torch.as_tensor(na), torch.as_tensor(nb),
                                   tau))
    assert got == res.achieved_ratio


def test_search_tau_expands_and_is_monotone():
    na = _norms(rcs.exponential_decay(512, lam=0.5, seed=0), 64)
    tau, res = tts.search_tau(torch.as_tensor(na), torch.as_tensor(na), 0.02,
                              tol=0.005, max_iters=30)
    want_tau, _ = rts.search_tau(jnp.asarray(na), jnp.asarray(na), 0.02,
                                 tol=0.005, max_iters=30)
    assert res.achieved_ratio <= 0.05
    assert tau == pytest.approx(float(want_tau), rel=TAU_RTOL)
    nb = torch.as_tensor(_norms(rcs.algebraic_decay(256, seed=2), 64))
    taus = [tts.search_tau(nb, nb, t)[0] for t in (0.5, 0.2, 0.05)]
    assert taus[0] <= taus[1] <= taus[2]


def test_search_tau_zero_operands():
    """All-zero operands: τ = 0 in a probe or two, flat and coarse-first;
    plan(valid_ratio) on a zero matrix keeps every tile."""
    z = torch.zeros(8, 8)
    tau, res = tts.search_tau(z, z, 0.3)
    assert tau == 0.0 and res.iterations <= 2
    pyr = tplan.NormPyramid.from_normmap(z, 2)
    tau, res = tts.search_tau_pyramid(pyr, pyr, 0.3)
    assert tau == 0.0 and res.iterations <= 4
    p = tplan.plan(torch.zeros(64, 64), torch.zeros(64, 64), valid_ratio=0.5,
                   tile=32, backend="torch")
    assert p.tau == 0.0 and float(p.valid_fraction) == 1.0


@pytest.mark.parametrize("seed", range(3))
def test_count_valid_equals_mask_sum(seed):
    rng = np.random.default_rng(seed)
    na = rng.uniform(0, 1, (7, 5)).astype(np.float32)
    na[2] = 0.0  # a zero-norm row tile
    nb = rng.uniform(0, 1, (5, 9)).astype(np.float32)
    for tau in (0.0, float(rng.uniform(0.05, 0.9)), 3.0):
        want = int(np.asarray(rref.spamm_mask_ref(
            jnp.asarray(na), jnp.asarray(nb), jnp.float32(tau))).sum())
        got = tcs.count_valid(torch.as_tensor(na), torch.as_tensor(nb), tau)
        assert got.dtype == torch.int64 and int(got) == want
        assert int(got) == int(tplan.gate_mask(
            torch.as_tensor(na), torch.as_tensor(nb), tau).sum())
        assert float(tcs.valid_ratio_of(torch.as_tensor(na),
                                        torch.as_tensor(nb), tau)) == float(
            rcs.valid_ratio_of(jnp.asarray(na), jnp.asarray(nb), tau))


@pytest.mark.parametrize("levels", [0, 2])
def test_plan_valid_ratio_matches_reference(levels):
    """plan(valid_ratio=…) flat and coarse-first, from shared normmaps: the
    τ of the reference within TAU_RTOL and the same tables."""
    na, nb = _ensemble(512, 32)
    kw = dict(valid_ratio=0.3, tile=32, levels=levels)
    rp = rplan.plan(None, None, norm_a=jnp.asarray(na),
                    norm_b=jnp.asarray(nb), backend="interpret", **kw)
    tp = tplan.plan(None, None, norm_a=torch.as_tensor(na),
                    norm_b=torch.as_tensor(nb), backend="torch", **kw)
    assert tp.tau == pytest.approx(float(rp.tau), rel=TAU_RTOL)
    assert abs(float(tp.valid_fraction) - 0.3) < 0.03
    assert tp.levels == levels
    for name in rp.work._fields:
        np.testing.assert_array_equal(getattr(tp.work, name).numpy(),
                                      np.asarray(getattr(rp.work, name)),
                                      err_msg=name)


# ---------------------------------------------------------------------------
# spamm(): padding, τ or valid ratio, the recursive oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block_n", [1, 2])
def test_spamm_matches_reference_on_ragged_shapes(block_n):
    tile = 16
    a, b = _decay(70, 45, 11), _decay(45, 90, 12)
    tau = _gap_tau(_norms(a, tile), _norms(b, tile))
    want, rinfo = rcs.spamm(jnp.asarray(a), jnp.asarray(b), tau, tile=tile,
                            block_n=block_n, backend="interpret")
    got, info = tcs.spamm(torch.as_tensor(a), torch.as_tensor(b), tau,
                          tile=tile, block_n=block_n, backend="torch")
    assert got.shape == (70, 90)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MM_TOL,
                               atol=MM_TOL)
    assert float(info.valid_fraction) == float(rinfo.valid_fraction)
    assert 0.0 < float(info.valid_fraction) < 1.0
    assert info.tau == float(rinfo.tau)
    assert float(info.effective_flops) == pytest.approx(
        float(rinfo.effective_flops), rel=1e-6)


def test_spamm_valid_ratio_matches_reference():
    a = rcs.algebraic_decay(300, seed=13)[:, :260]
    b = rcs.algebraic_decay(300, seed=14)[:260, :]
    want, rinfo = rcs.spamm(jnp.asarray(a), jnp.asarray(b), valid_ratio=0.3,
                            tile=32, backend="interpret")
    got, info = tcs.spamm(torch.as_tensor(a), torch.as_tensor(b),
                          valid_ratio=0.3, tile=32, backend="torch")
    assert info.tau == pytest.approx(float(rinfo.tau), rel=TAU_RTOL)
    assert abs(float(info.valid_fraction) - 0.3) < 0.03
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MM_TOL,
                               atol=MM_TOL)


@pytest.mark.parametrize("tau", [0.05, 0.3, 1.2])
def test_spamm_flat_equals_recursive(tau):
    """Paper §3.1: one-level leaf gating ≡ Algorithm 1's recursion (an
    ancestor's norm product dominates its leaves')."""
    n, leaf = 128, 32
    a, b = _decay(n, n, 15, 0.3), _decay(n, n, 16, 0.3)
    flat, info = tcs.spamm(torch.as_tensor(a), torch.as_tensor(b), tau,
                           tile=leaf, backend="torch")
    np.testing.assert_allclose(flat.numpy().astype(np.float64),
                               tcs.recursive_spamm(a, b, tau, leaf=leaf),
                               atol=1e-4)
    np.testing.assert_array_equal(
        tcs.recursive_spamm(a, b, tau, leaf=leaf),
        rcs.recursive_spamm(a, b, tau, leaf=leaf))


def test_decay_generators_match_reference():
    for seed in (None, 3):
        np.testing.assert_array_equal(tcs.algebraic_decay(40, seed=seed),
                                      rcs.algebraic_decay(40, seed=seed))
        np.testing.assert_array_equal(tcs.exponential_decay(40, seed=seed),
                                      rcs.exponential_decay(40, seed=seed))


# ---------------------------------------------------------------------------
# spamm_bmm and the weight cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("levels", [0, 2])
@pytest.mark.parametrize("shared", [True, False])
def test_spamm_bmm_matches_reference(shared, levels):
    tile, bsz, m, k, n = 16, 3, 40, 64, 56
    x = np.stack([_decay(m, k, 20 + i) for i in range(bsz)])
    w = (_decay(k, n, 30) if shared
         else np.stack([_decay(k, n, 31 + i) for i in range(bsz)]))
    wn = _norms(w, tile)
    tau = _gap_tau(_norms(x, tile), wn if not shared else wn[None])
    want, rinfo = rplan.spamm_bmm(jnp.asarray(x), jnp.asarray(w), tau,
                                  tile=tile, backend="interpret",
                                  levels=levels)
    got, info = tplan.spamm_bmm(torch.as_tensor(x), torch.as_tensor(w), tau,
                                tile=tile, backend="torch", levels=levels)
    assert got.shape == (bsz, m, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MM_TOL,
                               atol=MM_TOL)
    assert float(info.valid_fraction) == float(rinfo.valid_fraction)
    assert 0.0 < float(info.valid_fraction) < 1.0
    # each slice ≡ its own one-shot spamm(): the batch neither crosses nor
    # regroups tiles, and the two GEMMs add in the same order
    for s in range(bsz):
        c, _ = tcs.spamm(torch.as_tensor(x[s]),
                         torch.as_tensor(w if shared else w[s]), tau,
                         tile=tile, backend="torch")
        assert torch.equal(got[s], c)


def test_spamm_bmm_valid_ratio_and_errors():
    x = torch.as_tensor(np.stack([_decay(32, 64, 40 + i) for i in range(2)]))
    w = torch.as_tensor(_decay(64, 48, 42))
    c, info = tplan.spamm_bmm(x, w, valid_ratio=0.5, tile=16,
                              backend="torch")
    assert c.shape == (2, 32, 48) and 0.0 < float(info.valid_fraction) < 1.0
    with pytest.raises(ValueError):
        tplan.spamm_bmm(x, torch.stack([w, w]), valid_ratio=0.5, tile=16)
    with pytest.raises(ValueError):
        tplan.spamm_bmm(x, w, tile=16)


def test_weight_cache_hits_misses_and_pyramids():
    w = torch.as_tensor(_decay(96, 80, 50))
    cache = tplan.WeightPlanCache()
    wp1, nw1 = cache.weight_side(w, tile=16, backend="torch", levels=2)
    wp2, nw2 = cache.weight_side(w, tile=16, backend="torch", levels=2)
    assert (cache.hits, cache.misses) == (1, 1)
    assert isinstance(nw1, tplan.NormPyramid) and nw1 is nw2 and wp1 is wp2
    assert nw1.num_levels == 2
    _, nw0 = cache.weight_side(w, tile=16, backend="torch")
    assert cache.misses == 2 and not isinstance(nw0, tplan.NormPyramid)
    assert torch.equal(nw0, nw1.base)
    # block_n pads N to tile·block_n: another entry
    wp3, _ = cache.weight_side(w, tile=16, backend="torch", block_n=2)
    assert wp3.shape == (96, 96) and cache.misses == 3
    # an in-place update of the weight is a miss, not a stale hit
    w.mul_(2.0)
    _, nw4 = cache.weight_side(w, tile=16, backend="torch")
    assert cache.misses == 4 and torch.equal(nw4, 2.0 * nw0)
    # 3-D per-expert weights: one normmap per slice, pyramid levels batched
    w3 = torch.as_tensor(np.stack([_decay(48, 80, 51 + i) for i in range(3)]))
    _, nw3 = cache.weight_side(w3, tile=16, backend="torch", levels=1)
    assert nw3.base.shape == (3, 3, 5) and nw3.coarse.shape == (3, 2, 3)
    for s in range(3):
        assert torch.equal(nw3.base[s], tops.tile_norms(w3[s], 16))
    assert len(cache) == 5
    cache.clear()
    assert (cache.hits, cache.misses, len(cache)) == (0, 0, 0)


@pytest.mark.parametrize("levels", [0, 2])
def test_cached_plan_matches_reference(levels):
    tile = 16
    x, w = _decay(40, 64, 60), _decay(64, 48, 61)
    tau = _gap_tau(_norms(x, tile), _norms(w, tile))
    xp = np.pad(x, ((0, 8), (0, 0)))
    rcache, tcache = rplan.WeightPlanCache(), tplan.WeightPlanCache()
    rp, _ = rcache.plan_for(jnp.asarray(xp), jnp.asarray(w), tau, tile=tile,
                            backend="interpret", levels=levels)
    wt = torch.as_tensor(w)
    for _ in range(2):
        tp, _ = tcache.plan_for(torch.as_tensor(xp), wt, tau, tile=tile,
                                backend="torch", levels=levels)
    assert (tcache.hits, tcache.misses) == (1, 1)
    for name in rp.work._fields:
        np.testing.assert_array_equal(getattr(tp.work, name).numpy(),
                                      np.asarray(getattr(rp.work, name)),
                                      err_msg=name)
    assert tp.levels == levels


# ---------------------------------------------------------------------------
# the gated linear layers with a pyramid
# ---------------------------------------------------------------------------

def test_eager_levels_equal_flat():
    """maybe_spamm_matmul with SpammConfig(levels=2) ≡ levels=0 bit for bit
    (same tables, same kernel), the weight side served from the context's
    cache on the second call."""
    x = torch.as_tensor(_decay(70, 96, 70))
    w = torch.as_tensor(_decay(96, 80, 71))
    tau = _gap_tau(_norms(x.numpy(), 16), _norms(w.numpy(), 16))
    outs = []
    for levels in (0, 2):
        ctx = tmodule.SpammContext(SpammConfig(
            enable=True, tau=tau, tile=16, levels=levels, backend="torch"))
        ctx.begin_stats()
        y = tmodule.maybe_spamm_matmul(x, w, ctx)
        assert torch.equal(tmodule.maybe_spamm_matmul(x, w, ctx), y)
        assert (ctx.cache.hits, ctx.cache.misses) == (1, 1)
        taps = ctx.end_stats()
        assert len(taps) == 2 and 0.0 < taps[0].value < 1.0
        outs.append(y)
    assert torch.equal(outs[0], outs[1])


def test_spamm_bmm_linear_matches_reference():
    from repro.configs import SpammConfig as RSpamm
    from repro.core import module as rmodule

    tile = 16
    x = np.stack([_decay(24, 64, 80 + i) for i in range(2)])
    w = np.stack([_decay(64, 48, 82 + i) for i in range(2)])
    tau = _gap_tau(_norms(x, tile), _norms(w, tile))
    rctx = rmodule.SpammContext(RSpamm(enable=True, tau=tau, tile=tile,
                                       backend="interpret"))
    want = rmodule.spamm_bmm_linear(jnp.asarray(x), jnp.asarray(w), rctx)
    ctx = tmodule.SpammContext(SpammConfig(enable=True, tau=tau, tile=tile,
                                           backend="torch"))
    ctx.begin_stats()
    got = tmodule.spamm_bmm_linear(torch.as_tensor(x), torch.as_tensor(w),
                                   ctx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MM_TOL,
                               atol=MM_TOL)
    (tap,) = ctx.end_stats()
    assert 0.0 < tap.value < 1.0
    with pytest.raises(NotImplementedError):
        tmodule.spamm_bmm_linear(torch.as_tensor(x).requires_grad_(),
                                 torch.as_tensor(w), ctx)
