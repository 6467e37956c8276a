"""The port's observability plane (`repro_torch.obs`, the cost model's
predicting half, the engine's labelled telemetry) against the reference's
(`repro.obs`, `repro.core.cost`, `repro.serving.engine`).

Units: the same operations go through both packages' registries, tracers
and residual trackers, and must render the same Prometheus text, the same
snapshots and quantiles, and raise on the same label errors; each package
parses the other's dump and loads the other's cost profile. Engines:
reduced starcoder2-7b with the reference's weights (`params_from_jax`), at
a τ in a gap of every gate product the run evaluates, both planes; the
reference on its `jnp` backend, the port on the plain versions of its
kernels (CPU tensors).
"""
import contextlib
import json
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as robs
from repro.configs import ParallelConfig as RParallel
from repro.configs import SpammConfig as RSpamm
from repro.configs import get_config as rget_config
from repro.core import cost as rcost
from repro.core import plan as rplan
from repro.launch.mesh import make_ctx, make_host_mesh
from repro.models import model as RM
from repro.serving.engine import Engine as REngine
from repro.serving.engine import Request as RRequest
from repro_torch import obs as tobs
from repro_torch.configs import ParallelConfig, SpammConfig, get_config
from repro_torch.core import cost as tcost
from repro_torch.core import module as tmodule
from repro_torch.core import plan as tplan
from repro_torch.kernels import ops as tops
from repro_torch.models import model as M
from repro_torch.serving import engine as E
from repro_torch.serving import graphs as G
from repro_torch.serving.engine import Engine, Request

ARCH = "starcoder2-7b"
TILE = 16
B, PLEN, MAX_NEW, MAX_LEN = 2, 16, 5, 64
QUEUE_MIX = (5, 16, 23, 9, 12, 30)
# a (layer, site) cell's mean valid fraction: f32 fractions averaged in f64,
# the two packages' taps in their own order
VF_TOL = 1e-6
# the cost prediction: the same float64 formula on the same integers
PRED_RTOL = 1e-12
# the engine's summed predictions: per-GEMM f64 values summed in two orders
SUM_RTOL = 1e-9
# the reference's own prediction, evaluated in its plans' f32
F32_RTOL = 1e-6
# relative distance every gate product must keep from τ, far above the
# ~1e-6 relative gap between the two packages' f32 norms
GATE_MARGIN = 1e-3

RPCFG = RParallel(compute_dtype="float32", remat="none", attn_q_chunk=8,
                  attn_kv_chunk=8, decode_seq_shard=False)
PCFG = ParallelConfig(compute_dtype="float32", attn_q_chunk=8)
SPANS = {"freeze", "plan_assembly", "prefill", "decode_step", "wave"}


# ---------------------------------------------------------------------------
# registry: the same operations through both packages
# ---------------------------------------------------------------------------

def _ops_counters(reg):
    c = reg.counter("spamm_widgets_total", "w", labelnames=("phase",))
    c.inc(phase="prefill")
    c.inc(2.5, phase="prefill")
    c.inc(phase="decode")
    c.inc(1e20, phase="huge")
    c.inc(0.1, phase="tenth")
    c.inc(0.2, phase="tenth")
    reg.counter("serve_waves_total", "waves").inc(3)


def _ops_gauges(reg):
    g = reg.gauge("serve_live", "g", labelnames=("slot",))
    g.set(3, slot=0)
    g.set(-1.5, slot=0)
    g.set(float("inf"), slot=1)
    g.set(float("-inf"), slot=2)
    reg.gauge("serve_empty", "never set")


def _ops_histograms(reg):
    h = reg.histogram("serve_ttft_seconds", "ttft",
                      buckets=robs.LATENCY_BUCKETS_S, keep_recent=4)
    for v in (0.0003, 0.001, 0.0015, 0.04, 0.7, 12.0, 99.0, 0.02):
        h.observe(v)
    f = reg.histogram("spamm_valid_fraction", "vf",
                      labelnames=("phase", "layer", "site"),
                      buckets=robs.FRACTION_BUCKETS)
    rng = np.random.default_rng(0)
    for i in range(40):
        f.observe(float(rng.uniform()), phase=("prefill", "decode")[i % 2],
                  layer=i % 3, site=("wq", "w1")[i % 2])
    r = reg.histogram("spamm_cost_time_residual_log2", "r",
                      labelnames=("phase",),
                      buckets=robs.RESIDUAL_LOG2_BUCKETS)
    for v in (-5.0, -0.3, 0.0, 0.25, 4.0, 7.5):
        r.observe(v, phase="decode")
    i = reg.histogram("imbalance", "i", buckets=robs.IMBALANCE_BUCKETS)
    i.observe(1.01)


def _ops_labels(reg):
    c = reg.counter("odd_labels_total", 'help with "quotes"',
                    labelnames=("site", "dtype"))
    c.inc(site='w"1', dtype="a\\b")
    c.inc(2, site="new\nline", dtype="")


REGISTRY_OPS = {"counters": _ops_counters, "gauges": _ops_gauges,
                "histograms": _ops_histograms, "labels": _ops_labels}


def _both(ops):
    rreg, treg = robs.MetricsRegistry(), tobs.MetricsRegistry()
    ops(rreg)
    ops(treg)
    return rreg, treg


@pytest.mark.parametrize("ops", list(REGISTRY_OPS), ids=list(REGISTRY_OPS))
def test_registry_renders_as_the_reference(ops):
    """Prometheus text string for string, snapshots, the summary table,
    every series' quantiles and its raw tail."""
    rreg, treg = _both(REGISTRY_OPS[ops])
    assert treg.render_prometheus() == rreg.render_prometheus()
    assert treg.snapshot() == rreg.snapshot()
    assert treg.summary_table() == rreg.summary_table()
    for rm, tm in zip(rreg.metrics(), treg.metrics()):
        assert (tm.name, tm.kind, tm.labelnames) == (rm.name, rm.kind,
                                                     rm.labelnames)
        if tm.kind != "histogram":
            continue
        for key in rm.series():
            kw = dict(zip(rm.labelnames, key))
            for q in (0.0, 0.1, 0.5, 0.9, 0.95, 0.99, 1.0):
                assert tm.quantile(q, **kw) == rm.quantile(q, **kw)
            assert tm.recent(**kw) == rm.recent(**kw)
            assert (tm.count(**kw), tm.sum(**kw)) == (rm.count(**kw),
                                                      rm.sum(**kw))


def _err_missing_label(reg):
    reg.counter("a_total", labelnames=("phase",)).inc()


def _err_extra_label(reg):
    reg.counter("a_total", labelnames=("phase",)).inc(phase="p", layer=0)


def _err_wrong_label(reg):
    reg.histogram("h", labelnames=("phase",)).observe(1.0, site="w1")


def _err_negative_inc(reg):
    reg.counter("a_total").inc(-1.0)


def _err_bad_name(reg):
    reg.gauge("0bad-name")


def _err_buckets(reg):
    reg.histogram("h", buckets=(1.0, 1.0, 2.0))


def _err_kind_conflict(reg):
    reg.counter("a_total")
    reg.gauge("a_total")


def _err_labelnames_conflict(reg):
    reg.counter("a_total", labelnames=("phase",))
    reg.counter("a_total", labelnames=("site",))


def _err_quantile(reg):
    h = reg.histogram("h")
    h.observe(0.5)
    h.quantile(1.5)


REGISTRY_ERRORS = {f.__name__[5:]: f for f in (
    _err_missing_label, _err_extra_label, _err_wrong_label,
    _err_negative_inc, _err_bad_name, _err_buckets, _err_kind_conflict,
    _err_labelnames_conflict, _err_quantile)}


@pytest.mark.parametrize("case", list(REGISTRY_ERRORS))
def test_registry_raises_as_the_reference(case):
    msgs = []
    for reg in (robs.MetricsRegistry(), tobs.MetricsRegistry()):
        with pytest.raises(ValueError) as err:
            REGISTRY_ERRORS[case](reg)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("direction", ["port_reads_reference",
                                       "reference_reads_port"])
def test_parse_prometheus_reads_the_other_package(direction):
    rreg, treg = robs.MetricsRegistry(), tobs.MetricsRegistry()
    for ops in REGISTRY_OPS.values():
        ops(rreg)
        ops(treg)
    if direction == "port_reads_reference":
        got = tobs.parse_prometheus(rreg.render_prometheus())
    else:
        got = robs.parse_prometheus(treg.render_prometheus())
    assert got == robs.parse_prometheus(rreg.render_prometheus())
    vf = got["spamm_valid_fraction"]
    assert vf["type"] == "histogram" and any(
        k.startswith("spamm_valid_fraction_bucket{") for k in vf["samples"])


def test_empty_registry_renders_as_the_reference():
    rreg, treg = robs.MetricsRegistry(), tobs.MetricsRegistry()
    assert treg.render_prometheus() == rreg.render_prometheus() == "\n"
    assert tobs.parse_prometheus("") == robs.parse_prometheus("") == {}


# ---------------------------------------------------------------------------
# tracer, residual, bundle
# ---------------------------------------------------------------------------

def _trace_ops(mod, max_events=200_000):
    tr = mod.SpanTracer(process_name="repro-engine", max_events=max_events)
    with tr.span("freeze", store=False):
        with tr.span("plan_assembly", gm=3):
            pass
    t0 = 1_000
    tr.add_complete("prefill", t0, t0 + 5_000, step=0)
    tr.add_complete("decode_step", t0 + 5_000, t0 + 6_000, step=1)
    tr.instant("marker", obj=object)
    with mod.maybe_span(tr, "wave", batch=2):
        pass
    with mod.maybe_span(None, "never"):
        pass
    return tr


def _structure(doc):
    """What a trace says apart from its clock and process ids."""
    return [(e["name"], e["ph"], e.get("s"), sorted(e),
             sorted(e.get("args", {}))) for e in doc["traceEvents"]]


@pytest.mark.parametrize("max_events", [200_000, 3])
def test_tracer_matches_reference(max_events, tmp_path):
    rt, tt = _trace_ops(robs, max_events), _trace_ops(tobs, max_events)
    assert tt.span_names() == rt.span_names()
    assert len(tt.events) == len(rt.events) == min(6, max_events)
    rdoc, tdoc = rt.chrome_trace(), tt.chrome_trace()
    assert _structure(tdoc) == _structure(rdoc)
    assert tdoc["displayTimeUnit"] == rdoc["displayTimeUnit"]
    assert tdoc["traceEvents"][0]["args"] == {"name": "repro-engine"}
    ev = {e["name"]: e for e in tdoc["traceEvents"]}
    if max_events > 6:
        assert ev["decode_step"]["dur"] == 1.0       # µs
        assert ev["marker"]["args"]["obj"] == str(object)
    path = tt.export(str(tmp_path / "t.json"))
    assert json.load(open(path)) == json.loads(json.dumps(tdoc))


def test_disabled_tracer_records_nothing():
    for mod in (robs, tobs):
        tr = mod.SpanTracer(enabled=False)
        with tr.span("x"):
            pass
        tr.add_complete("y", 0, 1)
        tr.instant("z")
        with mod.maybe_span(tr, "w"):
            pass
        assert tr.events == []


@pytest.mark.parametrize("predicted,measured", [
    (0.5, 1.0), (1.0, 0.5), (3e-4, 7.25e-2), (0.0, 1.0), (1.0, 0.0),
    (-1.0, 2.0)])
def test_cost_residual_record_matches_reference(predicted, measured):
    rreg, treg = robs.MetricsRegistry(), tobs.MetricsRegistry()
    rt, tt = robs.CostResidualTracker(rreg), tobs.CostResidualTracker(treg)
    want = rt.record("decode", predicted, measured)
    got = tt.record("decode", predicted, measured)
    assert got == want
    if want is not None:
        assert got == math.log2(measured / predicted)
    assert treg.render_prometheus() == rreg.render_prometheus()


@pytest.mark.parametrize("arg", [None, False, "bundle"])
def test_observability_ensure_matches_reference(arg):
    got = [mod.Observability.ensure(
        mod.Observability(enabled=False) if arg == "bundle" else arg)
        for mod in (robs, tobs)]
    assert got[1].enabled == got[0].enabled == (arg is None)
    assert got[1].tracer.enabled == got[0].tracer.enabled
    assert (got[1].registry.render_prometheus()
            == got[0].registry.render_prometheus())
    with got[1].span("x"):
        pass
    assert len(got[1].tracer.events) == int(arg is None)


def test_bundle_writes_parseable_files(tmp_path):
    ob = tobs.Observability(process_name="repro-serve")
    _ops_histograms(ob.registry)
    with ob.span("wave"):
        pass
    m = ob.write_metrics(str(tmp_path / "m.prom"))
    t = ob.write_trace(str(tmp_path / "t.json"))
    assert robs.parse_prometheus(open(m).read()) == tobs.parse_prometheus(
        ob.registry.render_prometheus())
    assert {e["name"] for e in json.load(open(t))["traceEvents"]} == {
        "process_name", "wave"}
    assert ob.summary_table() == ob.registry.summary_table()


# ---------------------------------------------------------------------------
# part 0: decode latency quantiles from the reference's histogram
# ---------------------------------------------------------------------------

LATENCY_CASES = {
    "spread": list(np.random.default_rng(3).lognormal(-3.0, 1.0, 37)),
    "one_step": [0.0487],
    "one_bucket": [0.021, 0.022, 0.023, 0.049],
    "past_the_ladder": [31.0, 45.0, 0.0001],
    "graphed_decode": [0.04877, 0.04881, 0.04902, 0.0486, 0.0495] * 3,
}


@pytest.mark.parametrize("case", list(LATENCY_CASES))
def test_decode_latency_quantiles_follow_the_reference(case):
    """p50/p95 of a wave's decode latencies: the reference interpolates
    them from a wave-local histogram on LATENCY_BUCKETS_S; so must both
    the port's `Histogram.quantile` and the engine's latency helper (the
    port's `np.median`, and no p95, differed)."""
    lat = LATENCY_CASES[case]
    rh = robs.Histogram("h", buckets=robs.LATENCY_BUCKETS_S)
    th = tobs.Histogram("h", buckets=tobs.LATENCY_BUCKETS_S)
    for v in lat:
        rh.observe(v)
        th.observe(v)
    for q in (0.5, 0.95):
        assert th.quantile(q) == rh.quantile(q)
    got = Engine._latency(0.25, lat)
    assert got["decode_p50_s"] == rh.quantile(0.5)
    assert got["decode_p95_s"] == rh.quantile(0.95)
    assert got["decode_mean_s"] == float(np.mean(lat))
    assert got["ttft_s"] == 0.25 and got["decode_steps"] == len(lat)
    assert E.wave_latency(0.25, lat) == got
    assert Engine._latency(None, []) == {
        "ttft_s": None, "decode_steps": 0, "decode_mean_s": None,
        "decode_p50_s": None, "decode_p95_s": None}


# ---------------------------------------------------------------------------
# cost model
# ---------------------------------------------------------------------------

def _decay(m, n, seed, lam=0.85):
    i, j = np.meshgrid(np.arange(m), np.arange(n), indexing="ij")
    rng = np.random.default_rng(seed)
    return (lam ** np.abs(i - j * m / n) * rng.standard_normal((m, n))
            ).astype(np.float32)


def _median_tau(na, nb):
    prod = na[:, None, :] * nb.T[None]
    return float(np.median(prod[prod > 0]))


COST_CASES = [(1, 0, "float32"), (2, 0, "float32"), (1, 2, "float32"),
              (1, 0, "bfloat16"), (2, 1, "int8")]
COST_IDS = [f"bn{bn}-lv{lv}-{dt}" for bn, lv, dt in COST_CASES]


def _plans(block_n, levels, dtype):
    """The reference's plan and the port's, built from the reference's
    normmaps at a median τ."""
    a, b = _decay(96, 128, 0), _decay(128, 160, 1)
    ra, rb = jnp.asarray(a), jnp.asarray(b)
    na = np.asarray(rplan.plan(ra, rb, 0.0, tile=TILE, backend="jnp",
                               compute_dtype=dtype).norm_a)
    nb = np.asarray(rplan.plan(ra, rb, 0.0, tile=TILE, block_n=block_n,
                               backend="jnp", compute_dtype=dtype).norm_b)
    tau = _median_tau(na, nb)
    # the interpret backend's plans carry the work-list step tables
    rp = rplan.plan(None, None, tau, norm_a=jnp.asarray(na),
                    norm_b=jnp.asarray(nb), tile=TILE, block_n=block_n,
                    backend="interpret", levels=levels, compute_dtype=dtype)
    tp = tplan.plan(None, None, tau, norm_a=torch.tensor(na),
                    norm_b=torch.tensor(nb), tile=TILE, block_n=block_n,
                    backend="torch", levels=levels, compute_dtype=dtype)
    return rp, tp


def _host_view(p, dtype):
    """The reference's plan with its kept-step count and bytes as host
    numbers, so its formula evaluates in float64."""
    vt = int(p.valid_tiles)
    pairs = int((np.asarray(p.nvalid) > 0).sum())
    nbytes = rcost.gemm_bytes(float(vt), float(pairs), p.tile, p.block_n,
                              dtype)
    return types.SimpleNamespace(
        norm_a=p.norm_a, work=p.work, tile=p.tile, levels=p.levels,
        block_n=p.block_n, valid_tiles=vt, grid=p.grid,
        bytes_moved=lambda: nbytes)


@pytest.mark.parametrize("block_n,levels,dtype", COST_CASES, ids=COST_IDS)
def test_predict_plan_static_finish_equals_in_plan_prediction(block_n,
                                                              levels, dtype):
    """The split the taps use (static terms at the call or capture, the
    rest from the drained values) is `predict_plan_time_s` on the same
    plan."""
    _, tp = _plans(block_n, levels, dtype)
    coeffs = tcost.DEFAULT_COEFFS["cuda"]
    static = tcost.predict_plan_static(tp, coeffs)
    vt = int(tp.valid_tiles)
    pairs = int((tp.nvalid > 0).sum())
    got = tcost.finish_plan_time_s(
        static, vt / tp.total_tiles,
        tcost.gemm_bytes(float(vt), float(pairs), TILE, block_n, dtype),
        coeffs)
    want = tcost.predict_plan_time_s(tp, coeffs)
    assert torch.is_tensor(want) and want.dtype == torch.float64
    assert got == pytest.approx(float(want), rel=PRED_RTOL)
    assert tcost.predict_plan_static(
        types.SimpleNamespace(work=None), coeffs) is None


@pytest.mark.parametrize("block_n,levels,dtype", COST_CASES, ids=COST_IDS)
def test_predict_plan_time_matches_reference(block_n, levels, dtype):
    """On plans built from the reference's normmaps and the same
    coefficients: the static terms equal the reference's, and the
    prediction equals the reference's formula to 1e-12 (its plan's counts
    as host numbers; in the plan's own f32 to 1e-6)."""
    rp, tp = _plans(block_n, levels, dtype)
    assert int(tp.valid_tiles) == int(rp.valid_tiles)
    assert tp.work.step_i.shape[0] == rp.work.step_i.shape[0]
    rc = rcost.DEFAULT_COEFFS["jnp"]
    coeffs = tcost.CostCoeffs(*rc)
    assert tcost.predict_plan_static(tp, coeffs) == \
        rcost.predict_plan_static(rp, rc)
    got = float(tcost.predict_plan_time_s(tp, coeffs))
    want = float(rcost.predict_plan_time_s(_host_view(rp, dtype), rc))
    assert got == pytest.approx(want, rel=PRED_RTOL)
    assert got == pytest.approx(float(rcost.predict_plan_time_s(rp, rc)),
                                rel=F32_RTOL)
    assert tcost.gemm_flops(7.0, TILE, block_n) == rcost.gemm_flops(
        7.0, TILE, block_n)
    counts = rcost.predict_counts(
        np.asarray(rp.norm_a), np.asarray(rp.norm_b), rp.tau, tile=TILE,
        block_n=block_n, dtype=dtype, levels=levels, mode="frozen")
    assert tcost.predict_time_s(tcost.KernelCounts(*counts), coeffs) == \
        rcost.predict_time_s(counts, rc)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_cost_profile_json_is_shared(writer, tmp_path):
    """A profile one package writes loads in the other, entries of both
    backends side by side."""
    path = str(tmp_path / "profile.json")
    c = rcost.CostCoeffs(1e11, 2e12, 3e-8, 4e-6, 5e9, calibrated=True)
    prof = (tcost if writer == "port" else rcost).CostProfile(
        meta={"by": writer})
    prof.put("torch", tcost.CostCoeffs(*c), kind="cpu")
    prof.put("jnp", c, kind="cpu")
    prof.save(path)
    for mod in (tcost, rcost):
        got = mod.CostProfile.load(path)
        assert set(got.entries) == {"torch/cpu", "jnp/cpu"}
        assert tuple(got.coeffs("torch", "cpu")) == tuple(c)
        assert tuple(got.coeffs("jnp", "cpu")) == tuple(c)
        assert got.meta["by"] == writer
    port = tcost.CostProfile.load_or_default(path)
    assert port.key_used("torch", "NVIDIA H100 80GB HBM3") == "torch/cpu"
    assert port.coeffs("cuda", "x") == tcost.DEFAULT_COEFFS["cuda"]
    assert tcost.CostProfile.load_or_default(None).entries == {}
    with open(path, "w") as f:
        json.dump({"schema": 0, "entries": {}}, f)
    for mod in (tcost, rcost):
        with pytest.raises(ValueError, match="schema"):
            mod.CostProfile.load(path)


def test_default_coeffs_are_nominal_and_keyed_by_card():
    for name in ("cuda", "torch"):
        c = tcost.DEFAULT_COEFFS[name]
        assert c.calibrated is False and min(c[:5]) > 0
    assert tcost.DEFAULT_COEFFS["cuda"].bytes_per_s == 3.35e12
    assert tcost.device_kind("cpu") == "cpu"
    assert tcost.profile_key("torch", "cpu") == "torch/cpu"
    if not torch.cuda.is_available():
        assert tcost.device_kind() == "cpu"


# ---------------------------------------------------------------------------
# labelled taps
# ---------------------------------------------------------------------------

def test_taps_carry_phase_site_layer_and_cost():
    """Eager taps take the labels current at the call; a block takes the
    labels it is given; cost terms finish at the drain."""
    ctx = tmodule.SpammContext(SpammConfig(enable=True, tau=0.0, tile=TILE))
    coeffs = tcost.DEFAULT_COEFFS["torch"]
    ctx.enable_cost_taps(coeffs)
    static = (1e-3, 8.0, TILE, 1)
    ctx.begin_stats()
    ctx.tap(torch.tensor(0.5), site="w1")
    ctx.set_layer(3)
    ctx.tap(torch.tensor(0.25), torch.tensor(64.0), site="wq", cost=static)
    assert ctx.swap_layer(None) == 3
    with ctx.record() as got:
        ctx.set_phase("decode")
        ctx.set_layer(1)
        ctx.tap(torch.tensor(0.75), torch.tensor(32.0), site="wo",
                cost=static)
    assert got[0][0] == tmodule.TapLabel("decode", "wo", 1, static)
    ctx.set_layer(None)
    ctx.set_phase("prefill")
    vals, nb, has, labels = G._stack_taps(got)
    ctx.tap_block(vals, nb, has, labels)
    taps = ctx.end_stats()
    pred = tcost.finish_plan_time_s(static, 0.25, 64.0, coeffs)
    assert taps == [
        tmodule.Tap("prefill", 0.5, None, "w1", -1, None),
        tmodule.Tap("prefill", 0.25, 64.0, "wq", 3, pred),
        tmodule.Tap("decode", 0.75, 32.0, "wo", 1,
                    tcost.finish_plan_time_s(static, 0.75, 32.0, coeffs))]


# ---------------------------------------------------------------------------
# engines against the reference's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    rcfg = rget_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    rparams = RM.init_params(rcfg, RPCFG, jax.random.key(0))
    params = M.params_from_jax(jax.tree.map(np.asarray, rparams), cfg,
                               device="cpu")
    return rcfg, cfg, rparams, params


@pytest.fixture(scope="module")
def profile(tmp_path_factory):
    """One profile file: the same coefficients under the reference's key
    and the port's."""
    path = str(tmp_path_factory.mktemp("cost") / "profile.json")
    c = tcost.CostCoeffs(3e10, 7e10, 2e-7, 4e-5, 3e8, calibrated=True)
    prof = tcost.CostProfile()
    prof.put("torch", c, kind="cpu")
    prof.put("jnp", rcost.CostCoeffs(*c), kind="cpu")
    return prof.save(path)


def _prompts(cfg, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab, n).astype(np.int32) for n in lengths]


PLANES = {
    "wave": dict(lengths=(PLEN,) * B, seed=0, max_new=MAX_NEW, kw={}),
    "chunked": dict(lengths=QUEUE_MIX, seed=6, max_new=4,
                    kw={"prefill_chunk": TILE, "max_slots": 2}),
}


def _port(setup, plane, tau, profile=None, obs=None, engine=None):
    _, cfg, _, params = setup
    pl = PLANES[plane]
    eng = engine or Engine(
        cfg, PCFG, params, max_len=MAX_LEN, device="cpu", obs=obs,
        spamm_cfg=SpammConfig(enable=True, tau=tau, tile=TILE,
                              tune_profile=profile), **pl["kw"])
    reqs = [Request(prompt=p, max_new_tokens=pl["max_new"])
            for p in _prompts(cfg, pl["lengths"], pl["seed"])]
    return [o.tolist() for o in eng.generate(reqs)], reqs[0].out, eng


def _ref(setup, plane, tau, profile):
    rcfg, cfg, rparams, _ = setup
    pl = PLANES[plane]
    eng = REngine(rcfg, RPCFG, make_ctx(make_host_mesh()), rparams,
                  max_len=MAX_LEN, **pl["kw"],
                  spamm_cfg=RSpamm(enable=True, tau=tau, tile=TILE,
                                   backend="jnp", tune_profile=profile))
    reqs = [RRequest(prompt=p, max_new_tokens=pl["max_new"])
            for p in _prompts(cfg, pl["lengths"], pl["seed"])]
    return [o.tolist() for o in eng.generate(reqs)], reqs[0].out, eng


def _gap(p, lo, hi):
    p = np.sort(p)
    a, b = int(lo * p.size), int(hi * p.size)
    g = a + int(np.argmax(p[a + 1:b + 1] / p[a:b]))
    return float(np.sqrt(p[g] * p[g + 1]))


def _gap_tau(setup, plane):
    """A τ in a gap of every gate product the plane's run evaluates, where
    decode keeps part of its tiles: no gate decision can flip on an ulp
    between the packages' norms."""
    products = []
    orig = tplan._plan_frozen

    def recording(a, fp, **kw):
        p = orig(a, fp, **kw)
        prod = p.norm_a[fp.step_i, fp.step_k] * fp.nbmax[fp.step_k, fp.step_j]
        products.append((fp.gm, prod[fp.step_real].numpy()))
        return p

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tplan, "_plan_frozen", recording)
        _port(setup, plane, 0.0)
        dec = np.concatenate([p for gm, p in products if gm == 1])
        tau = _gap(dec, 0.35, 0.65)
        for _ in range(5):
            products.clear()
            _port(setup, plane, tau)
            allp = np.concatenate([p for _, p in products])
            margin = float(np.min(np.abs(allp - tau)) / tau)
            if margin >= GATE_MARGIN:
                break
            tau = _gap(allp[allp < np.percentile(dec, 80)], 0.3, 0.9)
    assert margin >= GATE_MARGIN, (tau, margin)
    return tau


@pytest.fixture(scope="module", params=list(PLANES))
def served(request, setup, profile):
    """One wave of each plane through the port and the reference, obs on,
    both with the shared profile."""
    plane = request.param
    tau = _gap_tau(setup, plane)
    return (plane, tau, _port(setup, plane, tau, profile),
            _ref(setup, plane, tau, profile))


def test_engines_emit_the_same_tokens(served):
    _, _, (toks, out, _), (rtoks, rout, _) = served
    assert toks == rtoks
    sp = out["spamm"]
    assert 0.0 < sp["decode_valid_fraction"] < 1.0


def test_gm_histogram_matches_reference(served):
    """`Engine.gm_histogram` counts the reference engine's row grids, step
    for step, on each plane (the wave's prefill and decode; the chunked
    plane's chunks and decodes), and the tuner prices over it."""
    _, tau, (_, _, eng), (_, _, reng) = served
    hist = eng.gm_histogram
    assert hist == reng.gm_histogram and sum(hist.values()) > 1
    w = eng.params["layers"][0]["mlp"]["w1"]
    tp = tcost.tune_weight(w, tau, tile=TILE, gm_hist=hist)
    nb = tops.tile_norms(tplan.pad_to_tile(w, TILE), TILE).numpy()
    assert tp == tcost.tune(nb, tau, tile=TILE,
                            coeffs=tcost.DEFAULT_COEFFS["torch"],
                            profile_key_used="torch/<nominal>",
                            gm_hist=hist)
    assert tp.predicted_us <= tp.default_predicted_us
    eng.gm_histogram[1] = -1                 # a copy: the engine's stays
    assert eng.gm_histogram == hist


def test_per_layer_matches_reference(served):
    """The same (layer, site) cells as the reference engine's, the same
    counts and bytes, valid fractions within 1e-6."""
    _, _, (_, out, _), (_, rout, _) = served
    got, want = out["spamm"]["per_layer"], rout["spamm"]["per_layer"]
    assert sorted(got) == sorted(want) == [0, 1]
    for layer in want:
        assert sorted(got[layer]) == sorted(want[layer]) == sorted(
            ("wq", "wk", "wv", "wo", "w1", "w2"))
        for site, cell in want[layer].items():
            g = got[layer][site]
            assert sorted(g) == sorted(cell)
            for k in ("gated_gemms", "decode_gated_gemms",
                      "gemm_bytes_moved"):
                assert g[k] == cell[k], (layer, site, k)
            for k in ("valid_fraction", "decode_valid_fraction"):
                assert g[k] == pytest.approx(cell[k], abs=VF_TOL)


def test_per_layer_cells_sum_to_the_aggregates(served):
    _, _, (_, out, _), _ = served
    sp = out["spamm"]
    cells = [c for sites in sp["per_layer"].values() for c in sites.values()]
    assert sum(c["gated_gemms"] for c in cells) == sp["gated_gemms"]
    assert sum(c["decode_gated_gemms"] for c in cells) == \
        sp["decode_gated_gemms"]
    nbytes = sum(c["gemm_bytes_moved"] for c in cells)
    assert nbytes == pytest.approx(sp["gemm_bytes_moved"]
                                   + sp["decode_gemm_bytes_moved"],
                                   rel=SUM_RTOL)


def test_stats_keys_and_cost_residual_match_reference(served):
    """plan_cache_* deltas and the latency block with the reference's keys
    (and values: the cache deltas), and each phase's predicted seconds
    from one profile file equal to the reference's."""
    _, _, (_, out, _), (_, rout, _) = served
    sp, rsp = out["spamm"], rout["spamm"]
    assert sorted(sp) == sorted(rsp)
    for k in ("plan_cache_hits", "plan_cache_misses", "compute_dtype",
              "gated_gemms", "decode_gated_gemms"):
        assert sp[k] == rsp[k], k
    assert sorted(sp["latency"]) == sorted(rsp["latency"])
    assert sp["latency"]["decode_steps"] == rsp["latency"]["decode_steps"]
    got, want = sp["cost_residual"], rsp["cost_residual"]
    assert sorted(got) == sorted(want) == ["decode", "prefill"]
    for phase in want:
        assert sorted(got[phase]) == sorted(want[phase])
        assert got[phase]["predicted_s"] == pytest.approx(
            want[phase]["predicted_s"], rel=SUM_RTOL)
        m = got[phase]["measured_s"]
        assert got[phase]["log2_ratio"] == math.log2(
            m / got[phase]["predicted_s"])


def _series(reg, name):
    return {k: v for k, v in tobs.parse_prometheus(
        reg.render_prometheus())[name]["samples"].items()}


def test_registry_reaggregates_to_the_wave(served):
    """The labelled counters sum to the wave's totals; the wave, token,
    latency and (chunked) admission and chunk counters are the engine's;
    every metric and span name is one the reference engine has."""
    plane, _, (toks, out, eng), (_, _, reng) = served
    sp, reg = out["spamm"], eng.obs.registry
    gemms = _series(reg, "spamm_gated_gemms_total")
    assert sum(gemms.values()) == sp["gated_gemms"] + sp["decode_gated_gemms"]
    assert sum(v for k, v in gemms.items() if 'phase="decode"' in k) == \
        sp["decode_gated_gemms"]
    nbytes = _series(reg, "spamm_gemm_bytes_total")
    assert all('dtype="float32"' in k for k in nbytes)
    assert sum(nbytes.values()) == pytest.approx(
        sp["gemm_bytes_moved"] + sp["decode_gemm_bytes_moved"], rel=SUM_RTOL)
    m = {x.name: x for x in reg.metrics()}
    assert m["serve_waves_total"].value() == 1
    assert m["serve_tokens_total"].value() == sum(len(t) for t in toks)
    assert m["serve_ttft_seconds"].count() == 1
    assert m["serve_decode_step_seconds"].count() == \
        sp["latency"]["decode_steps"]
    assert m["spamm_plan_cache_total"].value(result="hit") == \
        sp["plan_cache_hits"]
    rnames = {x.name for x in reng.obs.registry.metrics()}
    assert set(m) <= rnames
    spans = eng.obs.tracer.span_names()
    assert spans == reng.obs.tracer.span_names()
    assert (SPANS if plane == "wave"
            else SPANS - {"prefill"} | {"prefill_chunk"}) == spans
    rm = {x.name: x for x in reng.obs.registry.metrics()}
    for name in ("serve_admissions_total", "serve_prefill_chunks_total",
                 "serve_tokens_total", "serve_waves_total"):
        assert m[name].value() == rm[name].value(), name
    for name in ("serve_queue_depth", "serve_slot_occupancy"):
        assert m[name].count() == rm[name].count(), name
        assert m[name].sum() == rm[name].sum(), name
    if plane == "chunked":
        assert "prefill_chunk" in spans
        assert m["serve_admissions_total"].value() == eng.admissions == \
            len(QUEUE_MIX)
        assert m["serve_prefill_chunks_total"].value() == eng.chunk_steps > 0
        assert m["serve_queue_depth"].count() > 0


@pytest.mark.parametrize("plane", list(PLANES))
def test_obs_false_is_bit_identical_and_silent(setup, plane):
    """obs=False: the same tokens and gating stats, no span, no latency
    block under `spamm`, no cost channel; the top-level latency stays."""
    on_toks, on, _ = _port(setup, plane, 0.05)
    toks, out, eng = _port(setup, plane, 0.05, obs=False)
    assert toks == on_toks
    sp = out["spamm"]
    assert "latency" not in sp and "cost_residual" not in sp
    assert "latency" in on["spamm"] and "cost_residual" in on["spamm"]
    assert sp == {k: v for k, v in on["spamm"].items()
                  if k not in ("latency", "cost_residual")}
    assert eng.obs.tracer.events == []
    assert eng.spamm_ctx.cost_coeffs is None
    assert tobs.parse_prometheus(eng.obs.registry.render_prometheus()) == {
        n: {"type": t, "samples": {}} for n, t in (
            ("spamm_cost_measured_seconds_total", "counter"),
            ("spamm_cost_predicted_seconds_total", "counter"),
            ("spamm_cost_time_residual_log2", "histogram"))}
    assert out["latency"]["decode_steps"] > 0


# ---------------------------------------------------------------------------
# graphed waves: labels kept from the capture
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _labels_off():
    """While a stand-in replay runs its body: the live labels are wrong
    (no layer, a phase nobody reads), as a real replay has none."""
    cls = tmodule.SpammContext
    orig = cls.set_layer
    cls.set_layer = lambda self, layer: None
    try:
        yield
    finally:
        cls.set_layer = orig


class _Replay:
    """A CPU stand-in for a captured graph: replaying rewrites the
    capture's static buffers in place — the outputs and the stacked tap
    values — by running the exact captured callable, with live labels
    off."""

    def __init__(self, step):
        self.step = step

    def replay(self):
        st = self.step
        ctx = st.spamm_ctx
        phase = ctx._phase
        ctx.set_phase("replay")
        with G._recording(ctx) as taps, _labels_off():
            ctx.set_layer(None)
            out = st.body()
        ctx.set_phase(phase)
        for k, v in out.items():
            st.outputs[k].copy_(v)
        vals, nb, _, _ = st._taps
        new = G._stack_taps(taps)
        vals.copy_(new[0])
        if nb is not None:
            nb.copy_(new[1])


def _cpu_capture(self):
    with G._recording(self.spamm_ctx) as taps:
        self.outputs = self.body()
        self._taps = G._stack_taps(taps)
    self._launches = [0] * len(G.read_counters())
    self._graph = _Replay(self)
    self.capture_s = 0.0


@pytest.mark.parametrize("plane", list(PLANES))
def test_graphed_wave_per_layer_equals_eager(setup, plane, monkeypatch):
    """One engine serves the wave eagerly, then through captured steps
    (the first graphed wave captures, the second only replays): tokens,
    per_layer, the gating aggregates and the predicted seconds are the
    eager wave's — every replayed tap carries its capture's labels."""
    monkeypatch.setattr(Engine, "_capture",
                        property(lambda self: self.cuda_graphs))
    monkeypatch.setattr(G.StepGraph, "_capture", _cpu_capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: ("pool",))
    tau = 0.05
    _, cfg, _, params = setup
    eng = Engine(cfg, PCFG, params, max_len=MAX_LEN, device="cpu",
                 spamm_cfg=SpammConfig(enable=True, tau=tau, tile=TILE),
                 **PLANES[plane]["kw"])
    eng.cuda_graphs = False
    eager = _port(setup, plane, tau, engine=eng)
    eng.cuda_graphs = True
    runs = [_port(setup, plane, tau, engine=eng) for _ in range(2)]
    assert all(isinstance(s._graph, _Replay)
               for (key, cap), s in eng._steps.items() if cap)
    esp = eager[1]["spamm"]
    assert len(esp["per_layer"]) == cfg.num_layers
    for toks, out, _ in runs:
        sp = out["spamm"]
        assert toks == eager[0]
        assert sp["per_layer"] == esp["per_layer"]
        for k in ("valid_fraction", "decode_valid_fraction", "gated_gemms",
                  "decode_gated_gemms", "gemm_bytes_moved",
                  "decode_gemm_bytes_moved"):
            assert sp[k] == esp[k], k
        for phase, c in esp["cost_residual"].items():
            assert sp["cost_residual"][phase]["predicted_s"] == \
                c["predicted_s"]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_serve_cli_writes_metrics_and_trace(tmp_path, capsys):
    from repro_torch.launch import serve

    mpath, tpath = str(tmp_path / "m.prom"), str(tmp_path / "t.json")
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                "--num-requests", "2", "--prompt-len", "16", "--max-new",
                "3", "--spamm-tau", "0.05", "--spamm-tile", "16",
                "--metrics-out", mpath, "--trace-out", tpath])
    out = capsys.readouterr().out
    assert f"metrics -> {mpath}" in out and f"trace -> {tpath}" in out
    assert "spamm_gated_gemms_total" in out       # the summary table
    text = open(mpath).read()
    got = tobs.parse_prometheus(text)
    assert got == robs.parse_prometheus(text)
    assert sum(got["spamm_gated_gemms_total"]["samples"].values()) == 2 * 6 \
        + 2 * 2 * 6
    assert got["serve_tokens_total"]["samples"] == {"serve_tokens_total": 6}
    names = {e["name"] for e in json.load(open(tpath))["traceEvents"]}
    assert SPANS | {"process_name"} == names
