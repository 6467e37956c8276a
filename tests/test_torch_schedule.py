"""The port's load-balance schedules (`repro_torch.core.schedule`) and the
halo wire format (`repro_torch.distributed.compression`) against the JAX
reference: the same V (the reference's, as numpy) through both packages'
functions. Offsets, permutations and strip tables must equal the
reference's array for array; imbalances agree within f32 ulps; the
re-sharding controller fed one V series makes the same decisions."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan as rplan
from repro.core import schedule as RS
from repro.distributed import compression as RC
from repro.obs import MetricsRegistry as RRegistry
from repro_torch.core import plan as tplan
from repro_torch.core import schedule as S
from repro_torch.distributed import compression as TC
from repro_torch.obs import MetricsRegistry

ULP_RTOL = 1e-6


def _profiles(gm, rng):
    band = np.clip(8 - np.abs(np.arange(gm) - gm / 2) / 2, 1, None)
    skew = np.exp(-np.arange(gm) / max(gm / 3, 1)) * 50 + 1
    unif = np.full(gm, 5.0)
    noisy = rng.integers(0, 40, gm).astype(float)
    return {"banded": band, "skewed": skew, "uniform": unif, "random": noisy}


def _v_of(profile):
    return np.outer(profile, np.ones(4)).astype(np.float32)


def _aliased_v(gm, phase):
    w = np.ones(gm, np.float32)
    w[phase:gm // 2 + phase:4] = 9.0
    return _v_of(w)


def _random_vs(seed, n=40):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        gm = int(rng.integers(2, 40))
        out.append(rng.integers(0, 50, (gm, int(rng.integers(1, 9))))
                   .astype(np.int32))
    return out


# ---------------------------------------------------------------------------
# V itself
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("level", [0, 1, 2])
def test_v_matrix_equals_reference(level):
    """V from the reference's own normmap pyramids (numpy) through both
    packages: the gate counts are integers and equal."""
    rng = np.random.default_rng(level)
    a = (rng.standard_normal((256, 192)) * np.exp(
        -np.arange(256) / 64)[:, None]).astype(np.float32)
    b = rng.standard_normal((192, 128)).astype(np.float32)
    ra = rplan.NormPyramid.build(jnp.asarray(a), level, tile=16,
                                 backend="jnp")
    rb = rplan.NormPyramid.build(jnp.asarray(b), level, tile=16,
                                 backend="jnp")
    ta = tplan.NormPyramid([torch.from_numpy(np.array(x))
                            for x in ra.levels], tile=16)
    tb = tplan.NormPyramid([torch.from_numpy(np.array(x))
                            for x in rb.levels], tile=16)
    tau = float(np.median(np.asarray(ra.levels[0])) ** 2)
    want = np.asarray(RS.v_matrix(ra, rb, tau, level=level))
    got = S.v_matrix(ta, tb, tau, level=level)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # plain normmaps ignore the level
    np.testing.assert_array_equal(
        S.v_matrix(ta.base, tb.base, tau, level=level).numpy(),
        np.asarray(RS.v_matrix(ra.levels[0], rb.levels[0], tau)))


# ---------------------------------------------------------------------------
# row ownership
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["contiguous", "cyclic"])
def test_rows_and_permutations_equal_reference(schedule):
    for gm in (4, 7, 8, 16, 33):
        for ndev in (1, 2, 3, 4):
            for d in range(ndev):
                np.testing.assert_array_equal(
                    S.rows_for_device(d, ndev, gm, schedule),
                    RS.rows_for_device(d, ndev, gm, schedule))
            np.testing.assert_array_equal(
                S.device_permutation(ndev, gm, schedule),
                RS.device_permutation(ndev, gm, schedule))
    offs = np.array([0, 3, 4, 9])
    for d in range(3):
        np.testing.assert_array_equal(S.rows_for_partition(d, offs),
                                      RS.rows_for_partition(d, offs))
    with pytest.raises(ValueError):
        S.rows_for_device(0, 2, 8, "equal_work")
    with pytest.raises(ValueError):
        S.rows_for_device(0, 2, 8, "spiral")


# ---------------------------------------------------------------------------
# equal-work cuts and their diagnostics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ndev", [1, 2, 3, 4])
def test_equal_work_partition_equals_reference(ndev):
    rng = np.random.default_rng(0)
    for gm in (4, 7, 9, 16, 33):
        for name, prof in _profiles(gm, rng).items():
            if gm < ndev:
                continue
            v = _v_of(prof)
            offs = S.equal_work_partition(v, ndev)
            np.testing.assert_array_equal(
                offs, RS.equal_work_partition(jnp.asarray(v), ndev))
            np.testing.assert_array_equal(
                S._equal_cuts(prof.astype(np.float64), ndev),
                RS._equal_cuts(prof.astype(np.float64), ndev))
            np.testing.assert_array_equal(
                S.partition_loads(v, offs),
                RS.partition_loads(jnp.asarray(v), offs))
            assert S.partition_imbalance(v, offs) == \
                RS.partition_imbalance(jnp.asarray(v), offs)
    np.testing.assert_array_equal(S._uniform_offsets(9, ndev),
                                  RS._uniform_offsets(9, ndev))


def test_random_profiles_and_coarse_levels_equal_reference():
    """Seeded random V (the reference's property sweep) at levels 0-2 with
    ragged fine grids: fine work, cuts, loads under every schedule, the
    imbalance diagnostics and the auto pick."""
    for i, v in enumerate(_random_vs(7)):
        level = i % 3
        f = 1 << level
        fine = v.shape[0] * f - (i % f)
        ndev = 1 + i % min(4, fine)
        jv = jnp.asarray(v)
        np.testing.assert_array_equal(
            S._fine_work(v, level=level, fine_rows=fine),
            RS._fine_work(jv, level=level, fine_rows=fine))
        offs = S.equal_work_partition(v, ndev, level=level, fine_rows=fine)
        np.testing.assert_array_equal(offs, RS.equal_work_partition(
            jv, ndev, level=level, fine_rows=fine))
        for sched in ("contiguous", "cyclic", "equal_work"):
            np.testing.assert_array_equal(
                S.device_loads(v, ndev, sched, level=level, fine_rows=fine),
                RS.device_loads(jv, ndev, sched, level=level,
                                fine_rows=fine))
        assert S.auto_schedule(v, ndev, level=level, fine_rows=fine) == \
            RS.auto_schedule(jv, ndev, level=level, fine_rows=fine)
        for sched in ("contiguous", "cyclic", "equal_work"):
            want = float(RS.imbalance(jv, ndev, sched))
            assert S.imbalance(v, ndev, sched) == pytest.approx(
                want, rel=ULP_RTOL)
            if sched != "equal_work" and v.size < ndev:
                continue
            assert S.tile_imbalance(v, ndev, sched) == pytest.approx(
                float(RS.tile_imbalance(jv, ndev, sched)), rel=ULP_RTOL)


def test_auto_schedule_picks_equal_reference():
    gm = 32
    w = np.ones(gm, np.float32)
    w[0:16:4] = 9.0
    skew = np.full(gm, 1e-3, np.float32)
    skew[: gm // 4] = 10.0
    for v, want in ((_v_of(w), "equal_work"), (_v_of(skew), "cyclic"),
                    (np.ones((gm, 4), np.int32), "contiguous")):
        assert S.auto_schedule(v, 4) == want
        assert RS.auto_schedule(jnp.asarray(v), 4) == want
        assert S.auto_schedule(v, 4, allow_equal_work=False) == \
            RS.auto_schedule(jnp.asarray(v), 4, allow_equal_work=False)


def test_straddling_coarse_rows_split_as_reference():
    v = np.zeros((5, 5), np.int64)
    v[2, :] = 4
    for offs in ([0, 9, 18], [0, 10, 18], [0, 9, 11, 18]):
        offs = np.array(offs)
        got = S.device_loads(v, len(offs) - 1, "equal_work", level=2,
                             fine_rows=18, offsets=offs)
        np.testing.assert_array_equal(got, RS.device_loads(
            jnp.asarray(v), len(offs) - 1, "equal_work", level=2,
            fine_rows=18, offsets=offs))
    np.testing.assert_allclose(
        S.device_loads(v, 2, "equal_work", level=2, fine_rows=18,
                       offsets=np.array([0, 9, 18])), [5.0, 15.0])


@pytest.mark.parametrize("call", [
    lambda m: m.equal_work_partition(np.ones((2, 2)), 3),
    lambda m: m.partition_loads(np.ones((8, 2)), np.array([0, 4, 7])),
    lambda m: m.strip_tables(np.array([0, 4, 8]), 8, 4),
    lambda m: m.strip_tables(np.array([0, 4, 8]), 10, 2),
    lambda m: m.strip_tables(np.array([0, 4, 4, 8]), 8, 3),
    lambda m: m.strip_tables(np.array([0, 2, 5, 6]), 6, 3, width=2),
    lambda m: m.rescale_offsets(np.array([0, 0, 0, 6]), 6),
    lambda m: m.rescale_offsets(np.array([0, 1, 4]), 1),
    lambda m: m.rescale_offsets(np.array([0, 1, 4]), 8, max_width=3),
], ids=["too-few-rows", "stale-loads", "strip-count", "grid", "empty-strip",
        "narrow-width", "empty-source", "rows-lt-parts", "infeasible-width"])
def test_stale_and_malformed_tables_raise_as_reference(call):
    with pytest.raises(ValueError):
        call(RS)
    with pytest.raises(ValueError):
        call(S)


def test_strip_tables_and_rescale_equal_reference():
    offsets = np.array([0, 2, 5, 6])
    for width in (None, 3, 4):
        idx, keep = S.strip_tables(offsets, 6, 3, width=width)
        ridx, rkeep = RS.strip_tables(offsets, 6, 3, width=width)
        np.testing.assert_array_equal(idx, ridx)
        np.testing.assert_array_equal(keep, rkeep)
        np.testing.assert_array_equal(idx[keep], np.arange(6))
    rng = np.random.default_rng(11)
    for _ in range(60):
        parts = int(rng.integers(1, 6))
        src = np.concatenate(([0], np.cumsum(rng.integers(1, 9, parts))))
        rows = int(rng.integers(parts, 6 * parts + 1))
        mw = int(rng.integers(-(-rows // parts), rows + 1))
        for max_width in (None, mw):
            np.testing.assert_array_equal(
                S.rescale_offsets(src, rows, max_width=max_width),
                RS.rescale_offsets(src, rows, max_width=max_width))


# ---------------------------------------------------------------------------
# the re-sharding controller
# ---------------------------------------------------------------------------

def _drive(mod, cfg_kw, series):
    rc = mod.ReshardController(mod.ReshardConfig(**cfg_kw))
    offs = []
    for step, v in series:
        vv = jnp.asarray(v) if mod is RS else v
        offs.append(np.asarray(rc.probe(vv, step)).copy())
    return rc, offs


SERIES = {
    "cadence-and-drift": (
        dict(num_devices=4, every=2, drift_threshold=1.05),
        [(0, _aliased_v(32, 0)), (2, _aliased_v(32, 0)),
         (4, _v_of(np.concatenate([np.ones(16, np.float32),
                                   np.full(16, 9.0, np.float32)])))]),
    "grid-change-resets": (
        dict(num_devices=2, every=1, drift_threshold=1.0),
        [(0, np.ones((10, 4), np.float32)), (1, np.ones((4, 4), np.float32))]),
    "sticky": (
        dict(num_devices=4, every=1, drift_threshold=100.0),
        [(s, _aliased_v(32, s)) for s in range(4)]),
    "drifting": (
        dict(num_devices=3, every=1, drift_threshold=1.0),
        [(s, _aliased_v(48, s % 4)) for s in range(8)]),
}


@pytest.mark.parametrize("case", list(SERIES))
def test_controller_decisions_equal_reference(case):
    kw, series = SERIES[case]
    rc, offs = _drive(S, kw, series)
    rr, roffs = _drive(RS, kw, series)
    for a, b in zip(offs, roffs):
        np.testing.assert_array_equal(a, b)
    assert (rc.resharded, rc.probes) == (rr.resharded, rr.probes)
    for h, rh in zip(rc.history, rr.history):
        assert h["step"] == rh["step"] and h["grid"] == rh["grid"]
        assert h["resharded"] == rh["resharded"]
        assert h["live_imbalance"] == pytest.approx(rh["live_imbalance"],
                                                    rel=ULP_RTOL)
        np.testing.assert_allclose(h["loads"], rh["loads"], rtol=ULP_RTOL)
    np.testing.assert_array_equal(rc.live_loads, rr.live_loads)
    assert [rc.due(s) for s in range(6)] == [rr.due(s) for s in range(6)]


def test_controller_publish_renders_as_reference():
    kw, series = SERIES["drifting"]
    rc, _ = _drive(S, kw, series[:5])
    rr, _ = _drive(RS, kw, series[:5])
    reg, rreg = MetricsRegistry(), RRegistry()
    rc.publish(reg)
    rr.publish(rreg)
    rc.publish(reg)          # nothing new: idempotent
    rr.publish(rreg)
    for step, v in series[5:]:
        rc.probe(v, step)
        rr.probe(jnp.asarray(v), step)
    rc.publish(reg)
    rr.publish(rreg)
    assert reg.render_prometheus() == rreg.render_prometheus()


def test_controller_rejects_unresolved_count_and_resolves_a_count():
    with pytest.raises(ValueError):
        S.ReshardController(S.ReshardConfig())
    cfg = S.resolve_reshard_devices(S.ReshardConfig(every=2), 4)
    assert cfg.num_devices == 4 and cfg.every == 2
    kept = S.ReshardConfig(num_devices=3)
    assert S.resolve_reshard_devices(kept, 8) is kept
    assert S.ReshardConfig() == S.ReshardConfig(
        **{f: getattr(RS.ReshardConfig(), f) for f in
           ("num_devices", "every", "drift_threshold", "level",
            "probe_window")})


@pytest.mark.parametrize("level", [0, 1])
def test_probe_estimate_equals_reference(level):
    """The probe's V (fresh activation norms against a cached weight-side
    pyramid) at a τ away from every product's ties."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((96, 64)) * np.repeat(
        rng.choice([0.05, 5.0], 96), 1)[:, None]).astype(np.float32)
    w = rng.standard_normal((64, 48)).astype(np.float32)
    rw = rplan.NormPyramid.build(jnp.asarray(w), level, tile=16,
                                 backend="jnp")
    tw = tplan.NormPyramid([torch.from_numpy(np.array(v))
                            for v in rw.levels], tile=16)
    prods = np.asarray(rplan.NormPyramid.build(
        jnp.asarray(x), 0, tile=16, backend="jnp").levels[0]).max() * \
        np.asarray(rw.levels[0]).max()
    tau = float(prods) * 0.37
    rv, rrows = RS.probe_v_estimate(jnp.asarray(x), rw, tau, tile=16,
                                    backend="jnp", level=level)
    tv, trows = S.probe_v_estimate(torch.from_numpy(x), tw, tau, tile=16,
                                   backend="torch", level=level)
    assert trows == rrows == 6
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))


# ---------------------------------------------------------------------------
# the operand-halo wire format
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_halo_wire_format_equals_reference(dtype):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((64, 96)) * 3).astype(np.float32)
    payload, scales = TC.compress_tiles(torch.from_numpy(x), 32, dtype)
    rpayload, rscales = RC.compress_tiles(jnp.asarray(x), 32, dtype)
    assert (scales is None) == (rscales is None)
    if scales is not None:
        np.testing.assert_array_equal(scales.numpy(), np.asarray(rscales))
    np.testing.assert_array_equal(payload.float().numpy(),
                                  np.asarray(rpayload, np.float32))
    view = TC.decompress_tiles(payload, scales, 32)
    assert view.dtype == torch.float32
    np.testing.assert_array_equal(view.numpy(), np.asarray(
        RC.decompress_tiles(rpayload, rscales, 32)))
    for shape in ((64, 96), (4608, 18432)):
        assert TC.halo_wire_bytes(shape, 32, dtype) == \
            RC.halo_wire_bytes(shape, 32, dtype)
