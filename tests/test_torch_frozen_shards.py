"""Row shards of the port's frozen plans (`FrozenWeight.for_rows(min_steps=)`,
`slice_rows`, `shard_by_offsets`, `stack_plans`, `FrozenPlan.copy_`)
against the reference's `FrozenWeight`, table for table: the same weight
frozen by both packages (τ > 0 keeps the weight-admissible pairs, which
depend only on which tile norms are zero, so both packages' tables are
integer-equal)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.plans import FrozenWeight as RFrozenWeight
from repro.plans.frozen import stack_plans as rstack_plans
from repro_torch.core import plan as tplan
from repro_torch.plans.frozen import FrozenWeight, stack_plans

TILE = 32
TABLES = ("step_i", "step_j", "step_k", "step_real", "seg_first", "seg_last")


def _decay(m, n, seed, zero_cols=False):
    rng = np.random.default_rng(seed)
    i = np.arange(m)[:, None]
    j = np.arange(n)[None, :]
    a = np.exp(-0.05 * np.abs(i - j)) * rng.standard_normal((m, n))
    if zero_cols:
        a[:, 2 * TILE:3 * TILE] = 0.0   # a zero weight super-column
    return a.astype(np.float32)


@pytest.fixture(scope="module", params=[False, True], ids=["dense", "zeros"])
def weights(request):
    w = _decay(128, 160, 3, zero_cols=request.param)
    return (FrozenWeight.build(torch.from_numpy(w), 0.5, tile=TILE),
            RFrozenWeight.build(jnp.asarray(w), 0.5, tile=TILE,
                                backend="jnp"))


def _same_tables(fp, rfp):
    for n in TABLES:
        np.testing.assert_array_equal(getattr(fp, n).numpy(),
                                      np.asarray(getattr(rfp, n)), n)
    assert (fp.gm, fp.gk, fp.gnb) == (rfp.gm, rfp.gk, rfp.gnb)


@pytest.mark.parametrize("gm,min_steps", [(4, 0), (4, 1024), (3, 0),
                                          (5, 4096)])
def test_for_rows_min_steps_equals_reference(weights, gm, min_steps):
    fw, rfw = weights
    fp = fw.for_rows(gm, min_steps=min_steps)
    _same_tables(fp, rfw.for_rows(gm, min_steps=min_steps))
    assert fp.step_i.shape[0] >= max(min_steps, gm * fw.num_kj)
    assert fw.for_rows(gm, min_steps=min_steps) is fp        # cached


@pytest.mark.parametrize("lo,hi,gm", [(1, 3, 4), (0, 4, 4), (2, 3, None),
                                      (0, 1, 6)])
def test_slice_rows_equals_reference(weights, lo, hi, gm):
    fw, rfw = weights
    sl = fw.slice_rows(lo, hi, gm=gm)
    _same_tables(sl, rfw.slice_rows(lo, hi, gm=gm))
    real = sl.step_real.numpy()
    # no step targets a tile beyond the strip: pad rows do zero work
    assert int(sl.step_i.numpy()[real].max()) < hi - lo
    assert int(real.sum()) == (hi - lo) * fw.num_kj
    # the runs cover the strip's real steps, then stand empty up to the
    # local grid's most runs
    runs = sl.runs.numpy()
    assert runs[0] == 0 and np.all(np.diff(runs) >= 0)
    assert runs.shape == fw.for_rows(sl.gm, min_steps=sl.step_i.shape[0]
                                     ).runs.shape
    assert runs[-1] == real.sum()


def test_slice_rows_rejects_bad_strips(weights):
    fw, rfw = weights
    for mod in (fw, rfw):
        with pytest.raises(ValueError):
            mod.slice_rows(2, 1)
        with pytest.raises(ValueError):
            mod.slice_rows(0, 4, gm=2)


@pytest.mark.parametrize("offsets,width", [([0, 2, 5, 6], 3),
                                           ([0, 2, 5, 6], None),
                                           ([0, 1, 2, 3, 8], 6)])
def test_shard_by_offsets_equals_reference(weights, offsets, width):
    fw, rfw = weights
    offs = np.array(offsets)
    shards = fw.shard_by_offsets(offs, width=width)
    rsh = rfw.shard_by_offsets(offs, width=width)
    assert len(shards) == len(offs) - 1
    sigs = {fp.signature() for fp in shards}
    assert len(sigs) == 1, "every shard has one static shape"
    for d, fp in enumerate(shards):
        for n in TABLES:
            np.testing.assert_array_equal(getattr(fp, n).numpy(),
                                          np.asarray(getattr(rsh, n))[d], n)
        assert fp.gm == rsh.gm
    np.testing.assert_array_equal(
        [int(fp.step_real.sum()) for fp in shards],
        np.diff(offs) * fw.num_kj)
    st = stack_plans(shards)
    for n in TABLES:
        np.testing.assert_array_equal(getattr(st, n).numpy(),
                                      np.asarray(getattr(rsh, n)), n)
    assert st.runs.shape[0] == len(shards)


def test_stale_offset_tables_rejected(weights):
    fw, rfw = weights
    for mod in (fw, rfw):
        with pytest.raises(ValueError):
            mod.shard_by_offsets(np.array([0, 2, 5, 6]), width=2)
        with pytest.raises(ValueError):
            mod.shard_by_offsets(np.array([0, 2, 2, 6]))


def test_stack_plans_per_layer_equals_reference():
    ws = [_decay(96, 96, s) for s in range(3)]
    fws = [FrozenWeight.build(torch.from_numpy(w), 0.5, tile=TILE)
           for w in ws]
    rfws = [RFrozenWeight.build(jnp.asarray(w), 0.5, tile=TILE,
                                backend="jnp") for w in ws]
    steps = max(fw.for_rows(4).step_i.shape[0] for fw in fws)
    st = stack_plans([fw.for_rows(4, min_steps=steps) for fw in fws])
    rst = rstack_plans([fw.for_rows(4, min_steps=steps) for fw in rfws])
    for n in TABLES:
        np.testing.assert_array_equal(getattr(st, n).numpy(),
                                      np.asarray(getattr(rst, n)), n)
    with pytest.raises(ValueError):
        stack_plans([fws[0].for_rows(4), fws[0].for_rows(3)])
    with pytest.raises(ValueError):
        stack_plans([])


def test_copy_into_a_clone_swaps_the_cut(weights):
    """A re-cut of one width is written into a clone's buffers in place
    (what a captured step reads), and the plan then gates and multiplies
    as the new cut's own plan does."""
    fw, _ = weights
    a, b = fw.shard_by_offsets(np.array([0, 1, 4]), width=3)
    live = a.clone()
    ptr = live.step_i.data_ptr()
    assert live.nbmax is a.nbmax and live.step_i is not a.step_i
    live.copy_(b)
    assert live.step_i.data_ptr() == ptr
    for n in TABLES + ("runs",):
        assert torch.equal(getattr(live, n), getattr(b, n)), n
    assert torch.equal(a.step_i, fw.shard_by_offsets(
        np.array([0, 1, 4]), width=3)[0].step_i), "the cached plan is intact"
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((3 * TILE, 128)).astype(
        np.float32))
    w = torch.from_numpy(_decay(128, 160, 3))
    wp = tplan.pad_to_tile(w, TILE).contiguous()
    c_live = tplan.execute(tplan.plan(x, frozen_weight=live), x, wp)
    c_own = tplan.execute(tplan.plan(x, frozen_weight=b), x, wp)
    assert torch.equal(c_live, c_own)
    with pytest.raises(ValueError):
        live.copy_(fw.for_rows(2))


@pytest.mark.parametrize("bucket_min", [16, 512, 4096])
def test_plan_bucket_min_equals_reference(bucket_min):
    """`plan(bucket_min=)` floors the work-list's step bucket as the
    reference's does: the same padded step tables as the reference's
    `interpret` backend, whose plans carry them (τ = 0 keeps every
    triple, so both packages gate alike)."""
    from repro.core import plan as rplan

    a = _decay(96, 128, 5)
    b = _decay(128, 64, 6)
    p = tplan.plan(torch.from_numpy(a), torch.from_numpy(b), 0.0, tile=TILE,
                   backend="torch", bucket_min=bucket_min)
    rp = rplan.plan(jnp.asarray(a), jnp.asarray(b), 0.0, tile=TILE,
                    backend="interpret", bucket_min=bucket_min)
    assert p.work.step_i.shape[0] == max(bucket_min, 32)   # 24 triples
    for n in ("step_i", "step_j", "step_k", "step_flags"):
        np.testing.assert_array_equal(getattr(p.work, n).numpy(),
                                      np.asarray(getattr(rp.work, n)), n)
