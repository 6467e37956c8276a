"""Cost-residual channel of the port (twin of `repro.obs.residual`):
predicted against measured time of the gated GEMMs.

Each frozen gated GEMM of a wave carries the static part of its predicted
call time (`core.cost.predict_plan_static`, host floats from the plan's
shapes, recorded at the eager call or at the capture of its CUDA graph);
`SpammContext.end_stats` finishes each prediction on the host from the
drained valid fraction and GEMM bytes (`cost.finish_plan_time_s`). The
engine pairs the per-phase sums with the measured host wall-clock of that
phase (TTFT for prefill, the decode steps' sum for decode), and the
log2(measured / predicted) ratio lands in a histogram.

A profile calibrated on its own machine should put the mass near 0 (within
±0.5, ≈ 1.4×); a persistent shift says the coefficients do not describe
this card. Granularity is per phase per wave, as in the reference: a
per-kernel pairing would need a timer around each GEMM, and so a
synchronisation inside the step.
"""
from __future__ import annotations

import math
from typing import Optional

from repro_torch.obs.registry import (MetricsRegistry, RESIDUAL_LOG2_BUCKETS,
                                      Histogram)


class CostResidualTracker:
    """Pairs predicted-vs-measured phase times into registry metrics."""

    def __init__(self, registry: MetricsRegistry):
        self.registry = registry
        self.hist: Histogram = registry.histogram(
            "spamm_cost_time_residual_log2",
            help="log2(measured / predicted) wall-clock of gated-GEMM work "
                 "per phase per wave; 0 = calibrated cost model",
            labelnames=("phase",), buckets=RESIDUAL_LOG2_BUCKETS)
        self.predicted_s = registry.counter(
            "spamm_cost_predicted_seconds_total",
            help="cost-model predicted gated-GEMM seconds",
            labelnames=("phase",))
        self.measured_s = registry.counter(
            "spamm_cost_measured_seconds_total",
            help="measured wall-clock seconds of the paired phase",
            labelnames=("phase",))

    def record(self, phase: str, predicted_s: float,
               measured_s: float) -> Optional[float]:
        """Record one pairing; returns the log2 residual (None if either
        side is non-positive — e.g. no gated GEMM executed in the phase)."""
        if predicted_s <= 0.0 or measured_s <= 0.0:
            return None
        r = math.log2(measured_s / predicted_s)
        self.hist.observe(r, phase=phase)
        self.predicted_s.inc(predicted_s, phase=phase)
        self.measured_s.inc(measured_s, phase=phase)
        return r
