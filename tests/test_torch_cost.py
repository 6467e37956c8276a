"""The port's analytic counts, roofline autotuner and calibration
(`repro_torch.core.cost`) against the reference's (`repro.core.cost`).

The numpy halves (`_pool_norms_np`, `_descent_gate_ops`, `predict_counts`,
`tune`, `_nnls_refit`) are the reference's float64 arithmetic, so on the
same inputs they give the same numbers, bit for bit. `tune_weight` takes
its normmap through each package's own backend (the port's plain versions
on CPU tensors, the reference's `jnp`), so it is held at a τ away from
ties, where ulp-level norm differences cannot flip a gate decision, with
one set of coefficients under both packages' profile keys. `calibrate` runs
on the CPU with the plain versions (the card's sweep is a card test).
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cost as rcost
from repro_torch.core import cost as tcost
from repro_torch.core import plan as tplan
from repro_torch.kernels import quantize as tquant
from repro_torch.plans.frozen import FrozenWeight

TILE = 32
# relative distance every weight norm keeps from the gate τ: far above the
# ~1e-6 relative gap between the two packages' f32 norms
GATE_MARGIN = 1e-3
COEFFS = (3.0e10, 7.0e10, 2.0e-7, 4.0e-5, 3.0e8)


def _decay(m, n, seed, scale=0.4):
    rng = np.random.default_rng(seed)
    d = np.abs(np.arange(m)[:, None] - np.arange(n)[None, :])
    base = (scale / (d ** 0.5 + 1)).astype(np.float32)
    return base * rng.standard_normal((m, n)).astype(np.float32)


def _normmap(shape, seed, zero_frac=0.0):
    """A synthetic normmap: positive, with a fraction of exact zeros (a
    weight tile of zeros) when asked."""
    rng = np.random.default_rng(seed)
    n = np.abs(rng.standard_normal(shape)).astype(np.float32)
    if zero_frac:
        n[rng.random(shape) < zero_frac] = 0.0
    return n


def _coeffs():
    return (tcost.CostCoeffs(*COEFFS, calibrated=True),
            rcost.CostCoeffs(*COEFFS, calibrated=True))


def _profiles():
    """The same coefficients under the port's key and the reference's."""
    t, r = _coeffs()
    tp, rp = tcost.CostProfile(), rcost.CostProfile()
    tp.put("torch", t, kind="cpu")
    rp.put("jnp", r, kind="cpu")
    return tp, rp


def test_search_space_and_defaults_match_reference():
    assert tcost.DEFAULT_TUNE_GM == rcost.DEFAULT_TUNE_GM
    assert tcost.BLOCK_N_CHOICES == rcost.BLOCK_N_CHOICES
    assert tcost.LEVELS_CHOICES == rcost.LEVELS_CHOICES
    assert tcost.BUCKET_CHOICES == rcost.BUCKET_CHOICES


# ---------------------------------------------------------------------------
# the numpy halves, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(6, 8), (7, 5), (1, 9), (3, 3)])
def test_pool_norms_np_equals_reference(shape):
    n = _normmap(shape, 1)
    got = tcost._pool_norms_np(n)
    want = rcost._pool_norms_np(n)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("levels", [0, 1, 2])
@pytest.mark.parametrize("tau", [0.0, 0.5, 1.5, 9.0])
def test_descent_gate_ops_equals_reference(levels, tau):
    na = _normmap((9, 7), 2).astype(np.float64)
    nb = _normmap((7, 11), 3).astype(np.float64)
    got = tcost._descent_gate_ops(na, nb, tau, levels)
    assert got == rcost._descent_gate_ops(na, nb, tau, levels)


@pytest.mark.parametrize("mode", ["eager", "frozen"])
@pytest.mark.parametrize("block_n", [1, 2, 4])
@pytest.mark.parametrize("levels,dtype,bucket_min", [
    (0, "float32", 16), (1, "int8", 64), (2, "bfloat16", 256)])
@pytest.mark.parametrize("tau", [0.0, 0.8])
def test_predict_counts_equals_reference(mode, block_n, levels, dtype,
                                         bucket_min, tau):
    """Eager and frozen modes, N padding (11 columns at block_n 2 and 4),
    zero weight tiles (frozen admissibility), pyramid bytes."""
    na = _normmap((5, 6), 4)
    nb = _normmap((6, 11), 5, zero_frac=0.2)
    kw = dict(tile=TILE, block_n=block_n, dtype=dtype, levels=levels,
              bucket_min=bucket_min, mode=mode)
    got = tcost.predict_counts(na, nb, tau, **kw)
    want = rcost.predict_counts(na, nb, tau, **kw)
    assert tuple(got) == tuple(want)
    assert got._fields == want._fields


def test_predict_counts_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="mode"):
        tcost.predict_counts(np.ones((1, 1)), np.ones((1, 1)), 0.0, tile=8,
                             mode="graphed")


@pytest.mark.parametrize("block_n", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_predict_counts_equal_the_ports_own_plans(block_n, dtype):
    """On a plan's own normmaps and gate τ, eager counts are the plan's
    `valid_tiles`, active pairs and bytes; frozen counts are the frozen
    plan's grid length and, through the device gate, its kept steps."""
    a = torch.as_tensor(_decay(96, 128, 6))
    b = torch.as_tensor(_decay(128, 128, 7))
    tau = 0.9
    p = tplan.plan(a, b, tau, tile=TILE, block_n=block_n, backend="torch",
                   compute_dtype=dtype)
    na, nb = p.norm_a.numpy(), p.norm_b.numpy()
    c = tcost.predict_counts(na, nb, float(p.tau), tile=TILE,
                             block_n=block_n, dtype=dtype, mode="eager")
    assert c.steps_real == int(p.valid_tiles)
    assert c.pairs == int((p.nvalid > 0).sum())
    assert c.steps_grid == p.work.step_i.shape[0]
    assert c.gemm_bytes == pytest.approx(float(p.bytes_moved()), rel=0,
                                         abs=0.5)
    fw = FrozenWeight.build(b, tau, tile=TILE, block_n=block_n,
                            backend="torch", compute_dtype=dtype)
    fp = fw.for_rows(na.shape[0])
    pf = tplan.plan(a, frozen_weight=fp)
    cf = tcost.predict_counts(na, fw.levels[0].numpy(), fp.tau, tile=TILE,
                              block_n=block_n, dtype=dtype, mode="frozen")
    assert cf.steps_grid == fp.step_i.shape[0]
    assert cf.steps_real == int(pf.valid_tiles) == c.steps_real
    assert cf.pairs == int((pf.nvalid > 0).sum())
    assert cf.gate_ops == float(cf.steps_grid)


def test_nnls_refit_equals_reference_on_a_rank_deficient_design():
    rng = np.random.default_rng(8)
    cols = rng.random((12, 3))
    # column 3 duplicates column 1: rank 3 of 4, and a negative fit
    feats = np.column_stack([cols[:, 0], cols[:, 1], cols[:, 2], cols[:, 1]])
    times = feats @ np.array([1e-5, -4e-7, 3e-9, 1e-7]) + 1e-6
    got = tcost._nnls_refit(feats, times)
    want = rcost._nnls_refit(feats, times)
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).all() and (got == 0).any()
    full = feats[:, :3] @ np.array([1.0, 2.0, 3.0])
    np.testing.assert_array_equal(tcost._nnls_refit(feats[:, :3], full),
                                  rcost._nnls_refit(feats[:, :3], full))


# ---------------------------------------------------------------------------
# the tuner
# ---------------------------------------------------------------------------

def _assert_tuned_equal(got, want, key=None):
    assert got._fields == want._fields
    for f in got._fields:
        if f == "profile_key":
            assert got.profile_key == (want.profile_key if key is None
                                       else key)
        else:
            assert getattr(got, f) == getattr(want, f), f
    assert got.predicted_us <= got.default_predicted_us


@pytest.mark.parametrize("how", ["gm", "gm_hist", "norm_a"])
@pytest.mark.parametrize("defaults", [(1, 0, 16), (2, 1, 64)])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_tune_equals_reference(how, defaults, dtype):
    """Shared normmaps and coefficients: `TunedParams` field for field,
    never predicted slower than the defaults."""
    nb = _normmap((10, 13), 9, zero_frac=0.1)
    kw = {"gm": {"gm": 3},
          "gm_hist": {"gm_hist": {8: 1.0, 1: 15.0, 0: 2.0, 4: 0.0}},
          "norm_a": {"norm_a": _normmap((6, 10), 10)}}[how]
    tc, rc = _coeffs()
    args = dict(tile=TILE, dtype=dtype, profile_key_used="k",
                defaults=defaults, **kw)
    got = tcost.tune(nb, 0.7, coeffs=tc, **args)
    want = rcost.tune(nb, 0.7, coeffs=rc, **args)
    _assert_tuned_equal(got, want)


def test_tune_refuses_an_unusable_histogram():
    tc, rc = _coeffs()
    for mod, c in ((tcost, tc), (rcost, rc)):
        with pytest.raises(ValueError, match="gm_hist"):
            mod.tune(np.ones((2, 2)), 0.5, tile=8, coeffs=c,
                     gm_hist={0: 3.0, 2: 0.0})


def test_tune_keeps_the_defaults_when_they_are_the_argmin():
    nb = _normmap((10, 13), 11)
    tc, _ = _coeffs()
    best = tcost.tune(nb, 0.7, tile=TILE, coeffs=tc)
    tp = tcost.tune(nb, 0.7, tile=TILE, coeffs=tc,
                    defaults=(best.block_n, best.levels, best.bucket))
    assert (tp.block_n, tp.levels, tp.bucket) == (best.block_n, best.levels,
                                                  best.bucket)
    assert tp.predicted_us == tp.default_predicted_us == best.predicted_us


def _gate_tau(nb, dtype, tile):
    """A τ whose widened gate threshold lies in a gap of the weight's
    norms, GATE_MARGIN away from every one of them."""
    vals = np.unique(nb[nb > 0])
    mid = np.sqrt(vals[:-1] * vals[1:])
    gap = np.minimum(vals[1:] / mid, mid / vals[:-1]) - 1.0
    lo, hi = len(mid) // 4, 3 * len(mid) // 4
    g = mid[lo + int(np.argmax(gap[lo:hi]))]
    assert gap[lo:hi].max() >= GATE_MARGIN
    factor = tquant.widen_tau(1.0, dtype, tile)
    return float(g / factor)


@pytest.mark.parametrize("use_mxu", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_tune_weight_equals_reference(dtype, use_mxu):
    """The port's `tune_weight` (plain versions, CPU) against the
    reference's on its jnp backend: the same picks and predicted times,
    each package's own profile key; the weight (100 × 150) pads to whole
    tiles in both."""
    from repro.kernels import ops as rops
    from repro.kernels import quantize as rquant

    w = _decay(100, 150, 12, scale=1.0)
    wp = np.pad(w, ((0, 28), (0, 10)))
    if dtype == "int8":
        nb = np.asarray(rops.int8_norms_and_scales(
            jnp.asarray(wp), TILE, backend="jnp")[0])
    else:
        nb = np.asarray(rops.get_backend("jnp").norms(
            rquant.quantized_view(jnp.asarray(wp), dtype, TILE), TILE))
    tau = _gate_tau(nb, dtype, TILE)
    tp, rp = _profiles()
    for kw in ({}, {"gm": 2, "defaults": (2, 0, 16)},
               {"gm_hist": {8: 1.0, 1: 15.0}}):
        got = tcost.tune_weight(torch.as_tensor(w), tau, tile=TILE,
                                dtype=dtype, backend="auto", profile=tp,
                                use_mxu=use_mxu, **kw)
        want = rcost.tune_weight(jnp.asarray(w), tau, tile=TILE, dtype=dtype,
                                 backend="jnp", profile=rp, use_mxu=use_mxu,
                                 **kw)
        _assert_tuned_equal(got, want, key="torch/cpu")
        assert want.profile_key == "jnp/cpu"


def test_tune_weight_prices_with_the_resolved_backend_and_device():
    w = torch.as_tensor(_decay(64, 64, 13))
    tp, _ = _profiles()
    assert tcost.tune_weight(w, 0.5, tile=TILE, profile=tp).profile_key \
        == "torch/cpu"
    nominal = tcost.tune_weight(w, 0.5, tile=TILE)
    assert nominal.profile_key == "torch/<nominal>"


# ---------------------------------------------------------------------------
# calibration and the profile
# ---------------------------------------------------------------------------

def test_calibrate_on_the_cpu_with_the_plain_versions():
    """The reference's sweep through the plain versions: calibrated,
    finite and positive coefficients, the samples and the fit reported."""
    report = {}
    c = tcost.calibrate("torch", device="cpu", report=report, repeat=1)
    assert isinstance(c, tcost.CostCoeffs) and c.calibrated
    vals = np.asarray(c[:5], np.float64)
    assert np.isfinite(vals).all() and (vals > 0).all()
    assert all(type(v) is float for v in c[:5])
    assert report["backend"] == "torch" and report["device_kind"] == "cpu"
    # 3 get-norm sizes, then 3 τ × block_n 1, 2 work-list executes
    assert len(report["samples"]) == 3 + 3 * 2
    assert [s["kind"] for s in report["samples"]].count("getnorm") == 3
    assert 1 <= report["columns_kept"] <= 4
    assert report["columns_kept"] == sum(x > 0 for x in report["fit"])
    assert report["max_abs_log2"] == max(abs(s["log2_ratio"])
                                         for s in report["samples"])
    assert report["gate"] is None


def test_calibrate_refuses_the_card_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tcost.calibrate("cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        tcost.calibrate()
    with pytest.raises(ValueError, match="device='cuda'"):
        tcost.calibrate("cuda", device="cpu")


def test_profile_round_trip_with_calibrated_coefficients(tmp_path):
    """A calibrated entry saves, loads back equal, resolves by backend and
    kind (and by backend alone for a sibling kind), and the reference
    reads the same file."""
    c = tcost.calibrate("torch", device="cpu", repeat=1)
    prof = tcost.CostProfile(meta={"card": "cpu"})
    prof.put("torch", c, kind="cpu")
    path = prof.save(str(tmp_path / "profile.json"))
    back = tcost.CostProfile.load(path)
    assert back.entries == {"torch/cpu": c}
    assert back.coeffs("torch", "cpu") == c
    assert back.coeffs("torch", "another card") == c
    assert back.key_used("torch", "another card") == "torch/cpu"
    assert back.coeffs("cuda", "cpu") == tcost.DEFAULT_COEFFS["cuda"]
    assert back.meta["card"] == "cpu" and "hostname" in back.meta
    ref = rcost.CostProfile.load(path)
    assert tuple(ref.entries["torch/cpu"]) == tuple(c)
    with open(path) as f:
        payload = json.load(f)
    payload["schema"] = 99
    with open(path, "w") as f:
        json.dump(payload, f)
    with pytest.raises(ValueError, match="schema"):
        tcost.CostProfile.load(path)
    assert tcost.CostProfile.load_or_default(None).entries == {}
