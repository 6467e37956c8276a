"""The port's cost model (twin of `repro.core.cost`): step-table
bucketing, the GEMM byte and flop counts, machine coefficients and their
JSON profile, and the per-call time prediction the cost-residual channel
pairs with measured wall-clock (`obs/residual.py`).

`predict_plan_time_s` prices one executed work-list call from a plan's own
fields; `predict_plan_static` splits off every term that depends only on
static shapes (host floats, so a CUDA graph capture can record it), and
`finish_plan_time_s` adds the executed-work terms on the host from a tap's
drained valid fraction and bytes. `CostProfile` reads and writes the
reference's JSON (schema 1), so one file can hold entries of both packages
(`torch/cpu` beside `jnp/cpu`).

Not ported yet (ROADMAP queue A): the analytic `predict_counts`, the
autotuner (`tune`, `tune_weight`) and `calibrate`. A plan store written
with tuned artifacts loads here (`TunedParams.from_manifest`), but nothing
in the port tunes.
"""
from __future__ import annotations

import json
import os
import socket
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import quantize as kquant

COST_SCHEMA_VERSION = 1


def bucket(n: int, minimum: int = 16) -> int:
    """Pad a step count to a power-of-two bucket of at least `minimum`, so
    step tables take one of O(log n) lengths."""
    return max(minimum, 1 << max(n - 1, 0).bit_length())


def bucket_ladder(n_max: int, minimum: int = 16) -> list:
    """Every bucket `bucket(n, minimum)` can return for n in [1, n_max]."""
    lo = bucket(1, minimum)
    hi = bucket(max(int(n_max), 1), minimum)
    out = [lo]
    while out[-1] < hi:
        out.append(out[-1] * 2)
    return out


def gemm_bytes(valid_tiles, pairs, tile: int, block_n: int, dtype):
    """GEMM bytes the executed work-list moves: per real step one (tile,
    tile) A block and one (tile, tile·block_n) B block at the compute
    dtype's itemsize, plus one f32 (tile, tile·block_n) output flush per
    active output pair. Python floats or float tensors (pure arithmetic)."""
    isize = kquant.dtype_itemsize(dtype)
    t2 = float(tile * tile)
    return (valid_tiles * (t2 * (1 + block_n) * isize)
            + pairs * (t2 * block_n * 4.0))


def gemm_flops(valid_tiles, tile: int, block_n: int):
    """Flops of the executed work-list: one (tile, tile) @ (tile,
    tile·block_n) product per real step."""
    return valid_tiles * (2.0 * tile * tile * tile * block_n)


# ---------------------------------------------------------------------------
# machine coefficients
# ---------------------------------------------------------------------------

class CostCoeffs(NamedTuple):
    """Per-(backend × device kind) machine coefficients in base SI units
    (bytes/s, flops/s, seconds). `calibrated` is False on the nominal
    table below: predictions are then order-of-magnitude, not fitted."""
    bytes_per_s: float       # sustained memory bandwidth of the kernels
    flops_per_s: float       # sustained throughput of the tile products
    step_overhead_s: float   # per work-list grid step
    base_overhead_s: float   # fixed per-call overhead
    gate_ops_per_s: float    # gate product-compares per second
    calibrated: bool = False


# Nominal coefficients per resolved backend when no profile entry exists.
# None is a TPU number; calibration (not ported, ROADMAP queue A) would
# replace them.
DEFAULT_COEFFS = {
    # NVIDIA H100 80GB HBM3 at a 700.00 W power limit (nvidia-smi
    # --query-gpu=name,power.limit), the card every number of PERF.md was
    # read on, and the H100 SXM data sheet
    "cuda": CostCoeffs(
        # data sheet: HBM3 bandwidth, 3.35 TB/s
        bytes_per_s=3.35e12,
        # data sheet: f32 peak of the CUDA cores (the f32 work-list kernel
        # does not use the tensor cores), 67 TFLOP/s
        flops_per_s=67e12,
        # chip_smoke.py, PR 16 run 4 (PERF.md §6 row 2): the frozen w1
        # decode work-list kernel, 0.359 ms over its 32,768-step grid
        step_overhead_s=0.359e-3 / 32768,
        # chip_smoke.py launch_floor_ms, PR 18 run 9 (PERF.md §6): an empty
        # kernel's device time, 0.00087 ms, once per call
        base_overhead_s=0.00087e-3,
        # chip_smoke.py graph_breakdown, PR 19 run 9 (PERF.md §5): run (c)'s
        # 192 frozen gates replayed, 17.54 ms for one decode step's
        # 2,686,976 gate steps (83,968 per layer × 32)
        gate_ops_per_s=2686976 / 17.54e-3,
    ),
    # the plain PyTorch versions on a host CPU: nominal, not measured
    # (order-of-magnitude memory rate, f32 rate and per-step cost of a
    # host running the kernels' schedules op by op)
    "torch": CostCoeffs(2.0e10, 5.0e10, 5.0e-7, 5.0e-5, 2.0e8),
}


def device_kind(device=None) -> str:
    """Kind string of a device: the card's name
    (`torch.cuda.get_device_name`) for a CUDA device, "cpu" otherwise. No
    device: the card when one is visible, else "cpu"."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev.index or 0)
    return dev.type


def profile_key(backend: str, kind: Optional[str] = None) -> str:
    return f"{backend}/{kind if kind is not None else device_kind()}"


class CostProfile:
    """Coefficients keyed by backend × device kind, persisted as the
    reference's JSON (`{"schema": 1, "entries": {"torch/cpu": {...}},
    "meta": ...}`).

    `coeffs(backend)` falls back to any entry of the same backend when the
    exact key is missing, then to the nominal `DEFAULT_COEFFS` table."""

    def __init__(self, entries: Optional[dict] = None,
                 meta: Optional[dict] = None):
        self.entries: dict = dict(entries or {})
        self.meta = dict(meta or {})

    def put(self, backend: str, coeffs: CostCoeffs,
            kind: Optional[str] = None):
        self.entries[profile_key(backend, kind)] = coeffs

    def coeffs(self, backend: str, kind: Optional[str] = None) -> CostCoeffs:
        key = profile_key(backend, kind)
        hit = self.entries.get(key)
        if hit is not None:
            return hit
        prefix = backend + "/"
        for k in sorted(self.entries):
            if k.startswith(prefix):
                return self.entries[k]
        return DEFAULT_COEFFS.get(backend, DEFAULT_COEFFS["torch"])

    def key_used(self, backend: str, kind: Optional[str] = None) -> str:
        """The profile key `coeffs` resolves (for provenance)."""
        key = profile_key(backend, kind)
        if key in self.entries:
            return key
        prefix = backend + "/"
        for k in sorted(self.entries):
            if k.startswith(prefix):
                return k
        return f"{backend}/<nominal>"

    def save(self, path: str) -> str:
        payload = {
            "schema": COST_SCHEMA_VERSION,
            "entries": {k: v._asdict() for k, v in self.entries.items()},
            "meta": {**self.meta, "hostname": socket.gethostname()},
        }
        with open(path, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
        return path

    @classmethod
    def load(cls, path: str) -> "CostProfile":
        with open(path) as f:
            payload = json.load(f)
        if payload.get("schema") != COST_SCHEMA_VERSION:
            raise ValueError(
                f"cost profile {path!r} has schema "
                f"{payload.get('schema')!r}; this build reads "
                f"{COST_SCHEMA_VERSION}")
        entries = {k: CostCoeffs(**v) for k, v in payload["entries"].items()}
        return cls(entries, payload.get("meta"))

    @classmethod
    def load_or_default(cls, path: Optional[str]) -> "CostProfile":
        """A profile from `path`, or the empty (nominal-fallback) profile
        when path is None or missing."""
        if path and os.path.isfile(path):
            return cls.load(path)
        return cls()


# ---------------------------------------------------------------------------
# predicted call time
# ---------------------------------------------------------------------------

class KernelCounts(NamedTuple):
    """Analytic work of ONE SpAMM call at a given parameterization."""
    steps_real: int          # accumulating work-list steps (Σnvalid)
    steps_grid: int          # grid length the kernel actually runs
    pairs: int               # active output (i, j) pairs (flush writes)
    gemm_bytes: float        # work-list operand reads + output flushes
    flops: float             # tile-product flops over the real steps
    norm_bytes: float        # activation get-norm read (+ pooling reads)
    gate_ops: float          # gate product-compares


def predict_time_s(counts: KernelCounts, coeffs: CostCoeffs) -> float:
    """Additive model: fixed call overhead + per-step overhead + memory
    time + compute time + gate time."""
    return (coeffs.base_overhead_s
            + counts.steps_grid * coeffs.step_overhead_s
            + (counts.gemm_bytes + counts.norm_bytes) / coeffs.bytes_per_s
            + counts.flops / coeffs.flops_per_s
            + counts.gate_ops / coeffs.gate_ops_per_s)


def _pyramid_bytes(gm: int, gk: int, levels: int) -> float:
    lv_bytes, lvl = 0.0, (gm, gk)
    for _ in range(levels):
        lv_bytes += lvl[0] * lvl[1] * 4.0
        lvl = ((lvl[0] + 1) // 2, (lvl[1] + 1) // 2)
    return lv_bytes


def predict_plan_time_s(plan, coeffs: CostCoeffs):
    """Predicted wall-clock of ONE executed work-list call from a
    `SpammPlan`'s own fields: `predict_time_s` with the grid length taken
    from the step table's shape (one gate product-compare per grid step),
    the norm and pyramid reads from the normmap's shape, and the bytes and
    flops of the steps the gate kept. The kept-step count stays on the
    plan's device (a 0-d float64 tensor, no host read); the arithmetic is
    float64 throughout."""
    gm, gk = plan.norm_a.shape
    valid = plan.valid_tiles
    valid = valid.double() if torch.is_tensor(valid) else float(valid)
    if plan.work is not None and plan.work.step_i is not None:
        steps_grid = float(plan.work.step_i.shape[0])
    else:
        steps_grid = valid * 1.0
    gate_ops = steps_grid
    norm_bytes = float(gm * plan.tile) * (gk * plan.tile) * 4.0
    lv_bytes = _pyramid_bytes(gm, gk, plan.levels)
    pairs = (plan.nvalid > 0).sum().double()
    nbytes = gemm_bytes(valid, pairs, plan.tile, plan.block_n,
                        plan.compute_dtype)
    flops = gemm_flops(valid * 1.0, plan.tile, plan.block_n)
    return (coeffs.base_overhead_s
            + steps_grid * coeffs.step_overhead_s
            + (nbytes + norm_bytes + lv_bytes) / coeffs.bytes_per_s
            + flops / coeffs.flops_per_s
            + gate_ops / coeffs.gate_ops_per_s)


def predict_plan_static(plan, coeffs: CostCoeffs):
    """The static part of `predict_plan_time_s`: base and step overheads,
    norm and pyramid reads and gate time, all pure functions of the plan's
    shapes (normmap, step table, levels, grid) and the coefficients, so a
    CUDA graph capture can record them as host floats. Returns
    `(const_s, total_tiles, tile, block_n)`, or None for a plan without a
    step table."""
    if plan.work is None or plan.work.step_i is None:
        return None
    gm, gk = plan.norm_a.shape
    steps_grid = float(plan.work.step_i.shape[0])
    norm_bytes = float(gm * plan.tile) * (gk * plan.tile) * 4.0
    lv_bytes = _pyramid_bytes(gm, gk, plan.levels)
    gmm, gnb, gkk = plan.grid
    const_s = (coeffs.base_overhead_s
               + steps_grid * coeffs.step_overhead_s
               + (norm_bytes + lv_bytes) / coeffs.bytes_per_s
               + steps_grid / coeffs.gate_ops_per_s)
    return (const_s, float(gmm * gnb * gkk), plan.tile, plan.block_n)


def finish_plan_time_s(static, valid_fraction: float, gemm_bytes: float,
                       coeffs: CostCoeffs) -> float:
    """Host-side completion of `predict_plan_static` from a tap's drained
    valid fraction and GEMM bytes: equal to `predict_plan_time_s` on the
    same plan."""
    const_s, total_tiles, tile, block_n = static
    flops = gemm_flops(valid_fraction * total_tiles, tile, block_n)
    return (const_s + gemm_bytes / coeffs.bytes_per_s
            + flops / coeffs.flops_per_s)


# ---------------------------------------------------------------------------
# the autotuner's record
# ---------------------------------------------------------------------------

class TunedParams(NamedTuple):
    """One weight's tuned blocking parameters and their provenance, as the
    reference's autotuner records them in a plan artifact's manifest."""
    block_n: int
    levels: int
    bucket: int              # work-list bucket floor (`bucket(minimum=)`)
    predicted_us: float      # predicted per-call time at the tuned params
    default_predicted_us: float  # same model at the configured defaults
    profile_key: str         # coefficients used ("interpret/cpu", ...)

    def as_manifest(self) -> dict:
        return dict(self._asdict())

    @classmethod
    def from_manifest(cls, d: Optional[dict]) -> Optional["TunedParams"]:
        if d is None:
            return None
        return cls(block_n=int(d["block_n"]), levels=int(d["levels"]),
                   bucket=int(d["bucket"]),
                   predicted_us=float(d["predicted_us"]),
                   default_predicted_us=float(d["default_predicted_us"]),
                   profile_key=str(d["profile_key"]))
