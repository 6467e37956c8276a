"""Observability of the port (twin of `repro.obs`): labelled metrics, host
spans, cost residuals. Pure Python: nothing here touches the device.

`Observability` bundles the three channels one runtime shares:

  * `registry` — `MetricsRegistry` of counters, gauges and histograms with
    label sets (`layer`, `phase`, `site`, `dtype`), fed by the serving
    engine after each wave. Export with `write_metrics(path)` (Prometheus
    text) or `registry.snapshot()` (JSON).
  * `tracer` — `SpanTracer` host spans (freeze, plan assembly, prefill,
    decode steps, prefill chunks, waves); export with `write_trace(path)`
    (Chrome-trace/Perfetto JSON).
  * `residual` — `CostResidualTracker` pairing cost-model predictions with
    measured wall-clock per phase.

Pass `obs=False` to an instrumented component for a hard-off bundle: no
spans, no latency block in the wave's stats and no cost statics recorded
beside the taps. On or off, a step runs the same device ops and a CUDA
graph captures the same nodes: the labels and the cost statics are host
values.
"""
from __future__ import annotations

from typing import Union

from repro_torch.obs.registry import (  # noqa: F401  (re-exported surface)
    Counter, FRACTION_BUCKETS, Gauge, Histogram, IMBALANCE_BUCKETS,
    LATENCY_BUCKETS_S, MetricsRegistry, RESIDUAL_LOG2_BUCKETS,
    parse_prometheus,
)
from repro_torch.obs.residual import CostResidualTracker  # noqa: F401
from repro_torch.obs.tracer import SpanTracer, maybe_span  # noqa: F401


class Observability:
    """One bundle per runtime; share it across components of a run (engine
    and CLI) so the exported dump is the whole story."""

    def __init__(self, enabled: bool = True, process_name: str = "repro"):
        self.enabled = enabled
        self.registry = MetricsRegistry()
        self.tracer = SpanTracer(enabled=enabled, process_name=process_name)
        self.residual = CostResidualTracker(self.registry)

    def span(self, name: str, **args):
        return maybe_span(self.tracer if self.enabled else None, name, **args)

    def write_metrics(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.registry.render_prometheus())
        return path

    def write_trace(self, path: str) -> str:
        return self.tracer.export(path)

    def summary_table(self) -> str:
        return self.registry.summary_table()

    @classmethod
    def ensure(cls, obs: Union["Observability", bool, None],
               process_name: str = "repro") -> "Observability":
        """Normalize the `obs=` argument instrumented components accept:
        None -> fresh enabled bundle, False -> fresh disabled bundle,
        an existing bundle -> itself."""
        if isinstance(obs, cls):
            return obs
        return cls(enabled=(obs is not False), process_name=process_name)
