"""Metrics registry of the port (twin of `repro.obs.registry`): counters,
gauges and explicit-bucket histograms with label sets, Prometheus-text
rendering and JSON-able snapshots.

The serving engine feeds it on the host after each wave: the labelled
gated-GEMM taps (phase, layer, site, dtype), TTFT and per-decode-step
latency, wave and token counts, plan-cache and plan-store hits, and the
chunked plane's admissions, chunks, queue depth and slot occupancy. It is
pure Python (a handful of dicts behind one lock) and holds nothing on the
device, so no update adds a device op or a host synchronisation.

Names follow the Prometheus conventions the dump targets: counters end in
`_total`, histograms expose `<name>_bucket{le=...}` (cumulative),
`<name>_sum`, `<name>_count`. The rendered text is the reference's, string
for string, for the same operations; `parse_prometheus` reads it back (and
reads the reference's), so a `--metrics-out` dump can be checked without a
Prometheus install.
"""
from __future__ import annotations

import math
import threading
from collections import deque
from typing import Dict, Iterable, Optional, Sequence, Tuple

# Default bucket ladders, chosen to straddle what this repo actually measures.
LATENCY_BUCKETS_S: Tuple[float, ...] = (
    0.0005, 0.001, 0.002, 0.005, 0.01, 0.02, 0.05,
    0.1, 0.2, 0.5, 1.0, 2.0, 5.0, 10.0, 30.0,
)
FRACTION_BUCKETS: Tuple[float, ...] = (
    0.01, 0.02, 0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0,
)
# log2(measured / predicted): 0 = perfectly calibrated cost model, +1 = the
# kernel ran 2x slower than predicted, -1 = 2x faster.
RESIDUAL_LOG2_BUCKETS: Tuple[float, ...] = (
    -4.0, -3.0, -2.0, -1.0, -0.5, -0.25, 0.0, 0.25, 0.5, 1.0, 2.0, 3.0, 4.0,
)
IMBALANCE_BUCKETS: Tuple[float, ...] = (
    1.0, 1.02, 1.05, 1.1, 1.2, 1.5, 2.0, 3.0, 5.0, 10.0,
)


def _check_name(name: str) -> str:
    if not name or not all(c.isalnum() or c in "_:" for c in name) \
            or name[0].isdigit():
        raise ValueError(f"invalid metric name {name!r}")
    return name


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(labelnames: Sequence[str], labelvalues: Sequence[str],
                extra: Sequence[Tuple[str, str]] = ()) -> str:
    pairs = [f'{k}="{_escape_label(v)}"'
             for k, v in zip(labelnames, labelvalues)]
    pairs += [f'{k}="{_escape_label(v)}"' for k, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


class _Metric:
    """Shared label-series plumbing; subclasses define the per-series state."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        self.name = _check_name(name)
        self.help = help
        self.labelnames = tuple(labelnames)
        self._series: Dict[Tuple[str, ...], object] = {}
        self._lock = threading.Lock()

    def _key(self, labels: Dict[str, object]) -> Tuple[str, ...]:
        # hot path (one call per telemetry sample): length check + keyed
        # lookup raises on any mismatch without building comparison sets
        if len(labels) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} != declared "
                f"{sorted(self.labelnames)}")
        try:
            return tuple(str(labels[k]) for k in self.labelnames)
        except KeyError:
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} != declared "
                f"{sorted(self.labelnames)}") from None

    def series(self) -> Dict[Tuple[str, ...], object]:
        with self._lock:
            return dict(self._series)


class Counter(_Metric):
    """Monotonically increasing per-series float."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels):
        if amount < 0:
            raise ValueError(f"{self.name}: counter increment must be >= 0")
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + float(amount)

    def value(self, **labels) -> float:
        return float(self._series.get(self._key(labels), 0.0))


class Gauge(_Metric):
    """Last-write-wins per-series float."""

    kind = "gauge"

    def set(self, value: float, **labels):
        with self._lock:
            self._series[self._key(labels)] = float(value)

    def value(self, **labels) -> Optional[float]:
        v = self._series.get(self._key(labels))
        return None if v is None else float(v)


class _HistSeries:
    __slots__ = ("counts", "sum", "count", "recent")

    def __init__(self, nbuckets: int, keep_recent: int):
        self.counts = [0] * (nbuckets + 1)  # +1 for the +Inf bucket
        self.sum = 0.0
        self.count = 0
        self.recent = deque(maxlen=keep_recent) if keep_recent else None


class Histogram(_Metric):
    """Explicit-bucket histogram. `buckets` are ascending upper bounds; a
    +Inf bucket is implicit. `keep_recent=N` additionally retains the last N
    raw samples per series — bounded, so the registry never grows with run
    length."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = LATENCY_BUCKETS_S,
                 keep_recent: int = 0):
        super().__init__(name, help, labelnames)
        b = tuple(float(x) for x in buckets)
        if not b or any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
            raise ValueError(f"{name}: buckets must be ascending: {b}")
        self.buckets = b
        self.keep_recent = int(keep_recent)

    def _get(self, key) -> _HistSeries:
        s = self._series.get(key)
        if s is None:
            s = self._series[key] = _HistSeries(len(self.buckets),
                                               self.keep_recent)
        return s

    def observe(self, value: float, **labels):
        v = float(value)
        key = self._key(labels)
        with self._lock:
            s = self._get(key)
            i = 0
            while i < len(self.buckets) and v > self.buckets[i]:
                i += 1
            s.counts[i] += 1
            s.sum += v
            s.count += 1
            if s.recent is not None:
                s.recent.append(v)

    def count(self, **labels) -> int:
        s = self._series.get(self._key(labels))
        return 0 if s is None else s.count

    def sum(self, **labels) -> float:
        s = self._series.get(self._key(labels))
        return 0.0 if s is None else s.sum

    def recent(self, **labels) -> list:
        s = self._series.get(self._key(labels))
        return [] if s is None or s.recent is None else list(s.recent)

    def quantile(self, q: float, **labels) -> Optional[float]:
        """Bucket-interpolated quantile estimate (Prometheus
        histogram_quantile semantics: linear within the winning bucket,
        clamped to the highest finite bound for the +Inf bucket)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        s = self._series.get(self._key(labels))
        if s is None or s.count == 0:
            return None
        rank = q * s.count
        cum = 0
        for i, c in enumerate(s.counts):
            cum += c
            if cum >= rank and c > 0:
                if i >= len(self.buckets):      # +Inf bucket
                    return self.buckets[-1]
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = self.buckets[i]
                frac = (rank - (cum - c)) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        return self.buckets[-1]


class MetricsRegistry:
    """Get-or-create factory for named metrics plus the export surface.

    One registry per `Observability` bundle; metric objects are cached by
    name so hot paths can hold a direct reference instead of re-resolving.
    """

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name, help, labelnames, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help=help,
                                              labelnames=labelnames, **kw)
                return m
        if type(m) is not cls:
            raise ValueError(f"{name}: registered as {m.kind}, "
                             f"requested {cls.kind}")
        if tuple(labelnames) != m.labelnames:
            raise ValueError(f"{name}: labelnames {tuple(labelnames)} != "
                             f"registered {m.labelnames}")
        return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = LATENCY_BUCKETS_S,
                  keep_recent: int = 0) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets, keep_recent=keep_recent)

    def metrics(self) -> Iterable[_Metric]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    # -- export -------------------------------------------------------------
    def render_prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4)."""
        out = []
        for m in self.metrics():
            if m.help:
                out.append(f"# HELP {m.name} {m.help}")
            out.append(f"# TYPE {m.name} {m.kind}")
            for key, s in sorted(m.series().items()):
                if isinstance(m, Histogram):
                    cum = 0
                    for i, ub in enumerate(m.buckets + (math.inf,)):
                        cum += s.counts[i]
                        lab = _fmt_labels(m.labelnames, key,
                                          extra=(("le", _fmt_value(ub)),))
                        out.append(f"{m.name}_bucket{lab} {cum}")
                    lab = _fmt_labels(m.labelnames, key)
                    out.append(f"{m.name}_sum{lab} {_fmt_value(s.sum)}")
                    out.append(f"{m.name}_count{lab} {s.count}")
                else:
                    lab = _fmt_labels(m.labelnames, key)
                    out.append(f"{m.name}{lab} {_fmt_value(s)}")
        return "\n".join(out) + "\n"

    def snapshot(self) -> dict:
        """JSON-able dump. Label
        series keys are rendered `k=v,k=v` strings so the result nests as
        plain dicts."""
        snap = {}
        for m in self.metrics():
            series = {}
            for key, s in sorted(m.series().items()):
                skey = ",".join(f"{k}={v}"
                                for k, v in zip(m.labelnames, key)) or ""
                if isinstance(m, Histogram):
                    series[skey] = {
                        "buckets": list(m.buckets),
                        "counts": list(s.counts),
                        "sum": s.sum,
                        "count": s.count,
                    }
                else:
                    series[skey] = s
            snap[m.name] = {"type": m.kind, "help": m.help,
                            "labelnames": list(m.labelnames),
                            "series": series}
        return snap

    def summary_table(self) -> str:
        """Human-oriented end-of-run table: one line per series; histograms
        show count/mean/p50/p95."""
        lines = ["metric                                   value"]
        lines.append("-" * 72)
        for m in self.metrics():
            for key, s in sorted(m.series().items()):
                lab = _fmt_labels(m.labelnames, key)
                if isinstance(m, Histogram):
                    if s.count == 0:
                        continue
                    mean = s.sum / s.count
                    kw = dict(zip(m.labelnames, key))
                    p50 = m.quantile(0.5, **kw)
                    p95 = m.quantile(0.95, **kw)
                    lines.append(
                        f"{m.name}{lab:<30} n={s.count} mean={mean:.6g} "
                        f"p50={p50:.6g} p95={p95:.6g}")
                else:
                    lines.append(f"{m.name}{lab:<30} {_fmt_value(s)}")
        return "\n".join(lines)


def parse_prometheus(text: str) -> dict:
    """Parse a Prometheus text dump back into {metric_name: {type, samples}}
    where samples maps the full label string to a float. Enough fidelity for
    a test to validate a `--metrics-out` dump; not a general client."""
    metrics: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(None, 3)
            metrics.setdefault(name, {"type": kind, "samples": {}})
            continue
        if line.startswith("#"):
            continue
        # sample line: name{labels} value  |  name value
        if "}" in line:
            head, _, val = line.rpartition(" ")
            name = head.split("{", 1)[0]
            labels = head[len(name):]
        else:
            name, _, val = line.rpartition(" ")
            labels = ""
        base = name
        for suf in ("_bucket", "_sum", "_count"):
            if name.endswith(suf) and name[: -len(suf)] in metrics:
                base = name[: -len(suf)]
                break
        if base not in metrics:
            metrics.setdefault(name, {"type": "untyped", "samples": {}})
            base = name
        v = float("inf") if val == "+Inf" else float(val)
        metrics[base]["samples"][name + labels] = v
    return metrics
