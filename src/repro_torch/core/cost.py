"""The port's cost model and autotuner (twin of `repro.core.cost`):
step-table bucketing, the GEMM byte and flop counts, machine coefficients
and their JSON profile, the per-call time prediction the cost-residual
channel pairs with measured wall-clock (`obs/residual.py`), the analytic
per-call counts, the roofline autotuner and the calibration that fits the
coefficients on a machine.

`predict_plan_time_s` prices one executed work-list call from a plan's own
fields; `predict_plan_static` splits off every term that depends only on
static shapes (host floats, so a CUDA graph capture can record it), and
`finish_plan_time_s` adds the executed-work terms on the host from a tap's
drained valid fraction and bytes. `CostProfile` reads and writes the
reference's JSON (schema 1), so one file can hold entries of both packages
(`torch/cpu` beside `jnp/cpu`).

`predict_counts`, `tune` and `_nnls_refit` are the reference's float64
numpy arithmetic, number for number. `tune_weight` takes the weight's
normmap through the port's backends. `calibrate` fits the coefficients from
timed kernel calls: on the card at the caller's serving shapes
(`CardSweep`: frozen work-lists, get-norms up to ≈ 105 MB), each sample
captured as a CUDA graph and replayed back to back, the gate rate from the
device gate replayed the same way at the decode grid; with the plain
versions at the reference's sizes and host gate rate.
"""
from __future__ import annotations

import json
import os
import socket
import time
from typing import Mapping, NamedTuple, Optional, Sequence

import numpy as np

import torch

from repro_torch.kernels import quantize as kquant

COST_SCHEMA_VERSION = 1

# activation row-tile grid the offline tuner prices a call at when the caller
# has no serving shape in hand (the reference's value; not a fit parameter)
DEFAULT_TUNE_GM = 8


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
# None is a TPU number; `calibrate` fits the machine's own.
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


def _pool_norms_np(n: np.ndarray) -> np.ndarray:
    """Numpy twin of the pooling kernel: sqrt-sumsq 2×2 pooling with zero
    padding at ragged edges, in float64 (host-side, for count simulation)."""
    gm, gk = n.shape
    pm, pk = gm % 2, gk % 2
    if pm or pk:
        n = np.pad(n, ((0, pm), (0, pk)))
    sq = n.astype(np.float64) ** 2
    pooled = (sq[0::2, 0::2] + sq[1::2, 0::2] + sq[0::2, 1::2]
              + sq[1::2, 1::2])
    return np.sqrt(pooled)


def _descent_gate_ops(na: np.ndarray, nb: np.ndarray, tau: float,
                      levels: int) -> float:
    """Gate-product evaluations of hierarchical planning at `levels`
    coarsening steps: the full coarsest grid plus 8× the survivors of every
    refinement level (levels = 0: the flat gate's full fine grid). Counts
    the work of `core.plan._hier_descend_host` instead of collecting."""
    la, lb = [na], [nb]
    for _ in range(levels):
        la.append(_pool_norms_np(la[-1]))
        lb.append(_pool_norms_np(lb[-1]))
    top = levels
    gm_t, gk_t = la[top].shape
    gn_t = lb[top].shape[1]
    ops = float(gm_t) * gk_t * gn_t
    if levels == 0:
        return ops
    cand = (la[top][:, None, :] * np.swapaxes(lb[top], 0, 1)[None]
            >= tau)
    surv = float(cand.sum())
    for l in range(top - 1, -1, -1):
        ops += 8.0 * surv
        if surv == 0:
            break
        # refine the actual candidate set, so per-level survivor counts are
        # exact rather than a geometric guess
        gm_l, gk_l = la[l].shape
        gn_l = lb[l].shape[1]
        cand = np.repeat(np.repeat(np.repeat(cand, 2, 0), 2, 1), 2, 2)
        cand = cand[:gm_l, :gn_l, :gk_l]
        cand = cand & (la[l][:, None, :] * np.swapaxes(lb[l], 0, 1)[None]
                       >= tau)
        surv = float(cand.sum())
    return ops


def predict_counts(
    norm_a: np.ndarray,
    norm_b: np.ndarray,
    tau: float,
    *,
    tile: int,
    block_n: int = 1,
    dtype: str = "float32",
    levels: int = 0,
    bucket_min: int = 16,
    mode: str = "eager",
) -> KernelCounts:
    """Analytic counts of one call on (gm, gk) × (gk, gn) normmaps gated at
    `tau`. The gate is `core.plan.gate_mask`'s (super-column max-norm
    test), so on the plan's own normmaps the predicted steps and pairs are
    the plan's `valid_tiles` and active pairs exactly.

    mode="eager": the grid runs the surviving steps (bucket-padded).
    mode="frozen": the grid enumerates every weight-admissible step (gm ×
    the (k, j) pairs with a nonzero weight norm, `FrozenWeight.for_rows`)
    and the device gate turns accumulation on per step: step overhead and
    gate ops scale with the frozen table, bytes and flops with the
    surviving set. N is zero-padded up to tile·block_n like
    `pad_to_tile`."""
    na = np.asarray(norm_a, np.float64)
    nb = np.asarray(norm_b, np.float64)
    gm, gk = na.shape
    gn = nb.shape[1]
    pad_n = (-gn) % block_n
    if pad_n:
        nb = np.pad(nb, ((0, 0), (0, pad_n)))
        gn += pad_n
    gnb = gn // block_n
    nbmax = nb.reshape(gk, gnb, block_n).max(2) if block_n > 1 else nb
    mask = na[:, None, :] * np.swapaxes(nbmax, 0, 1)[None] >= tau
    v = int(mask.sum())
    pairs = int(mask.any(-1).sum())
    if mode == "frozen":
        if tau > 0.0:
            adm = int((nbmax > 0.0).sum())
        else:
            adm = gk * gnb
        steps_grid = bucket(gm * adm, bucket_min)
    elif mode == "eager":
        steps_grid = bucket(v, bucket_min)
    else:
        raise ValueError(f"mode {mode!r} not in ('eager', 'frozen')")
    norm_bytes = float(gm * tile) * (gk * tile) * 4.0
    lv_bytes, lvl = 0.0, (gm, gk)
    for _ in range(levels):
        lv_bytes += lvl[0] * lvl[1] * 4.0
        lvl = ((lvl[0] + 1) // 2, (lvl[1] + 1) // 2)
    if mode == "frozen":
        # the device gate is one product-compare per grid step
        gate_ops = float(steps_grid)
    else:
        gate_ops = _descent_gate_ops(na, nb, tau, levels)
    return KernelCounts(
        steps_real=v,
        steps_grid=steps_grid,
        pairs=pairs,
        gemm_bytes=float(gemm_bytes(float(v), float(pairs), tile, block_n,
                                    dtype)),
        flops=float(gemm_flops(float(v), tile, block_n)),
        norm_bytes=norm_bytes + lv_bytes,
        gate_ops=gate_ops,
    )


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


# ---------------------------------------------------------------------------
# the autotuner
# ---------------------------------------------------------------------------

BLOCK_N_CHOICES = (1, 2, 4)
LEVELS_CHOICES = (0, 1, 2)
BUCKET_CHOICES = (16, 64, 256)


def tune(
    norm_b: np.ndarray,
    tau: float,
    *,
    tile: int,
    dtype: str = "float32",
    coeffs: CostCoeffs,
    profile_key_used: str = "<nominal>",
    gm: int = DEFAULT_TUNE_GM,
    gm_hist: Optional[Mapping[int, float]] = None,
    norm_a: Optional[np.ndarray] = None,
    mode: str = "frozen",
    defaults: tuple = (1, 0, 16),
    block_n_choices: Sequence[int] = BLOCK_N_CHOICES,
    levels_choices: Sequence[int] = LEVELS_CHOICES,
    bucket_choices: Sequence[int] = BUCKET_CHOICES,
) -> TunedParams:
    """Argmin of predicted call time over block_n × levels × bucket floor.

    norm_b: the weight-side fine normmap of the view the kernel multiplies
    (the quantized view at a low dtype); tau: the gate threshold (already
    widened at a low dtype). norm_a: a representative activation normmap;
    None prices with the all-ones activation (the gate reduces to nb ≥ τ).
    gm_hist: an observed serving row-grid histogram {gm: weight}
    (`Engine.gm_histogram`): candidates are then scored by the weighted sum
    of predicted times over those grids instead of the synthetic `gm` (an
    explicit `norm_a` takes precedence). The defaults are candidate 0, so
    `predicted_us ≤ default_predicted_us`; ties keep the earliest
    candidate, defaults first, then ascending."""
    nb = np.asarray(norm_b, np.float64)
    gk = nb.shape[0]
    if norm_a is not None:
        na = np.asarray(norm_a, np.float64)
        grids = [(na, 1.0)]
    elif gm_hist:
        grids = [(np.ones((int(g), gk), np.float64), float(w))
                 for g, w in sorted(gm_hist.items()) if w > 0 and g > 0]
        if not grids:
            raise ValueError(f"gm_hist has no usable entries: {gm_hist!r}")
    else:
        grids = [(np.ones((gm, gk), np.float64), 1.0)]

    def predicted(bn: int, lv: int, bk_min: int) -> float:
        t = 0.0
        for na_g, w in grids:
            c = predict_counts(na_g, nb, float(tau), tile=tile, block_n=bn,
                               dtype=dtype, levels=lv, bucket_min=bk_min,
                               mode=mode)
            t += w * predict_time_s(c, coeffs)
        return t

    d_bn, d_lv, d_bk = defaults
    cands = [(int(d_bn), int(d_lv), int(d_bk))]
    for bn in block_n_choices:
        for lv in levels_choices:
            for bk_min in bucket_choices:
                c = (int(bn), int(lv), int(bk_min))
                if c not in cands:
                    cands.append(c)
    best, best_t, default_t = None, None, None
    for c in cands:
        t = predicted(*c)
        if default_t is None:
            default_t = t
        if best_t is None or t < best_t:
            best, best_t = c, t
    return TunedParams(block_n=best[0], levels=best[1], bucket=best[2],
                       predicted_us=best_t * 1e6,
                       default_predicted_us=default_t * 1e6,
                       profile_key=profile_key_used)


def tune_weight(
    w: torch.Tensor,
    tau: float,
    *,
    tile: int,
    dtype: str = "float32",
    backend: str = "auto",
    profile: Optional[CostProfile] = None,
    gm: int = DEFAULT_TUNE_GM,
    gm_hist: Optional[Mapping[int, float]] = None,
    norm_a: Optional[np.ndarray] = None,
    mode: str = "frozen",
    defaults: tuple = (1, 0, 16),
    use_mxu: bool = False,
) -> TunedParams:
    """`tune` for a weight tensor: the normmap of the view the kernel
    multiplies, taken on the weight's device through the backend resolved
    there (int8: the fused get-norm `int8_norms_and_scales`; bf16: the
    get-norm of the bf16-rounded view; f32: the get-norm, `use_mxu` passed
    through), τ widened by the quantization bound, priced with the
    profile's coefficients for that backend and device kind."""
    from repro_torch.core.plan import pad_to_tile  # plan imports this module
    from repro_torch.kernels import ops as kops

    name = kops.resolve_backend(backend, w.device)
    bk = kops.get_backend(name)
    profile = profile or CostProfile()
    kind = device_kind(w.device)
    dtype = kquant.canonical_dtype(dtype)
    wp = pad_to_tile(w, tile).contiguous()
    if dtype == "int8":
        nb, _ = kops.int8_norms_and_scales(wp, tile, backend=name,
                                           use_mxu=use_mxu)
    elif dtype != "float32":
        nb = bk.norms(kquant.quantized_view(wp, dtype, tile), tile,
                      use_mxu=use_mxu)
    else:
        nb = bk.norms(wp, tile, use_mxu=use_mxu)
    tau_gate = float(np.asarray(kquant.widen_tau(float(tau), dtype, tile)))
    return tune(nb.detach().cpu().numpy(), tau_gate, tile=tile, dtype=dtype,
                coeffs=profile.coeffs(name, kind),
                profile_key_used=profile.key_used(name, kind), gm=gm,
                gm_hist=gm_hist, norm_a=norm_a, mode=mode, defaults=defaults)


# ---------------------------------------------------------------------------
# calibration: fit coefficients from timed kernel calls
# ---------------------------------------------------------------------------

# the card's sweep: the caller's serving shapes (`CardSweep`) at tile 64,
# get-norms of its activations and of squares up to ≈ 105 MB, the largest
# gated weight's frozen work-list at τ at these quantiles of its gate
# products (0: τ = 0; above 1: that multiple of the largest product, a gate
# that keeps no step, whose sample is the call's base and grid-step cost
# alone: without it NNLS can zero the step column)
CUDA_TILE = 64
CUDA_NORM_SQUARES = (1024, 2048, 3072, 4096, 5120)
CUDA_TAU_QUANTILES = (0.0, 0.25, 0.5, 0.75, 2.0)
# a card sample is this many calls captured in one CUDA graph, replayed
# this many times back to back
GRAPH_CALLS, GRAPH_REPLAYS = 4, 5


class CardSweep(NamedTuple):
    """The serving shapes `calibrate` samples on the card, from its caller:
    one layer's gated weights as {site: (K, N)}, and the activation rows of
    a prefill wave and of a decode step."""
    gemms: Mapping[str, tuple]
    prefill_rows: int
    decode_rows: int


def _timeit_s(fn, device: torch.device, *, warmup: int = 1,
              repeat: int = 3) -> float:
    """Median seconds of one call of fn() after `warmup` calls: CUDA events
    on the card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(repeat):
        if device.type == "cuda":
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            fn()
            t1.record()
            t1.synchronize()
            ts.append(t0.elapsed_time(t1) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _replay_s(fn, device: torch.device, *, calls: int = GRAPH_CALLS,
              replays: int = GRAPH_REPLAYS, repeat: int = 5) -> float:
    """Device-bound seconds of one fn() call: `calls` calls captured in one
    CUDA graph (after a warm-up call on a side stream), the graph replayed
    `replays` times back to back between CUDA events, the median of
    `repeat` such runs over calls × replays. As in a replayed decode step,
    no host launch cost lies between the calls."""
    side = torch.cuda.Stream(device=device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()

    def run():
        for _ in range(replays):
            g.replay()

    return _timeit_s(run, device, repeat=repeat) / (calls * replays)


def _nnls_refit(feats: np.ndarray, times: np.ndarray) -> np.ndarray:
    """Least squares with non-negativity by zero-and-refit: solve, clamp
    negative coefficients to zero, refit the surviving columns (one pass)."""
    x, *_ = np.linalg.lstsq(feats, times, rcond=None)
    keep = x > 0
    if keep.all():
        return x
    out = np.zeros_like(x)
    if keep.any():
        sub, *_ = np.linalg.lstsq(feats[:, keep], times, rcond=None)
        out[keep] = np.maximum(sub, 0.0)
    return out


def _worklist_row(p, tile: int, block_n: int) -> list:
    """[1, grid steps, GEMM bytes, flops] of one executed plan."""
    v = float(p.valid_tiles)
    pairs = float((p.nvalid > 0).sum())
    steps = (float(p.work.step_i.shape[0])
             if p.work is not None and p.work.step_i is not None else v)
    return [1.0, steps, float(gemm_bytes(v, pairs, tile, block_n, "float32")),
            float(gemm_flops(v, tile, block_n))]


def _reference_samples(name: str, dev: torch.device, tile: int,
                       sizes: Sequence[int], taus: Sequence[float],
                       seed: int, repeat: int):
    """The reference's sweep: get-norms of exponential-decay matrices at
    `sizes`, then eager plan + execute at the largest size across τ and
    block_n 1, 2."""
    from repro_torch.core import plan as cplan
    from repro_torch.core.spamm import exponential_decay
    from repro_torch.kernels import ops as kops

    bk = kops.get_backend(name)
    samples = []
    for n in sizes:
        x = torch.as_tensor(exponential_decay(n, lam=0.7, seed=seed),
                            device=dev)
        t = _timeit_s(lambda: bk.norms(x, tile), dev, repeat=repeat)
        samples.append(({"kind": "getnorm", "shape": [n, n]},
                        [1.0, 0.0, float(n * n * 4), 0.0], t))
    n = sizes[-1]
    a = torch.as_tensor(exponential_decay(n, lam=0.7, seed=seed), device=dev)
    b = torch.as_tensor(exponential_decay(n, lam=0.7, seed=seed + 1),
                        device=dev)
    for tau in taus:
        for bn in (1, 2):
            p = cplan.plan(a, b, tau, tile=tile, block_n=bn, backend=name)
            t = _timeit_s(lambda p=p: cplan.execute(p, a, b), dev,
                          repeat=repeat)
            samples.append(({"kind": "worklist", "shape": [n, n, n],
                             "tau": float(tau), "block_n": bn},
                            _worklist_row(p, tile, bn), t))
    return samples


def _host_gate_rate(sizes: Sequence[int], tile: int, seed: int) -> float:
    """Host flat-gate products per second (the reference's measurement)."""
    gm = gk = gn = max(sizes) // tile
    na = np.abs(np.random.default_rng(seed).normal(size=(gm, gk)))
    nb = np.abs(np.random.default_rng(seed + 1).normal(size=(gk, gn)))
    t0 = time.perf_counter()
    reps = 20
    for _ in range(reps):
        (na[:, None, :] * nb.T[None] >= 0.5).sum()
    return reps * gm * gk * gn / max(time.perf_counter() - t0, 1e-9)


def _quantile_taus(na: torch.Tensor, nb: torch.Tensor,
                   quantiles: Sequence[float]) -> list:
    """τ at the given quantiles of the gate products na[i,k]·nb[k,j] (0 for
    quantile 0; q > 1 gives q times the largest product)."""
    prod = (na[:, None, :] * nb.T[None]).flatten().double()
    return [0.0 if q == 0.0
            else float(q * prod.max()) if q > 1.0
            else float(torch.quantile(prod, q)) for q in quantiles]


def _card_samples(dev: torch.device, sweep: CardSweep, tile: int,
                  seed: int, repeat: int):
    """The card's sweep, each sample device-bound (`_replay_s`): get-norms
    of the decode and prefill activations of the largest gated weight and
    of squares up to ≈ 105 MB, then that weight's frozen work-list (the
    serving path's plan and kernel: at the decode grid, its live rows, so
    the decode kernel) at the prefill and decode grids across τ and
    block_n 1, 2."""
    from repro_torch.core import plan as cplan
    from repro_torch.kernels import ops as kops
    from repro_torch.plans.frozen import FrozenWeight

    bk = kops.get_backend("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    k, n = max(sweep.gemms.values(), key=lambda kn: kn[0] * kn[1])
    kp = -(-k // tile) * tile
    grid = {r: -(-r // tile) * tile
            for r in (sweep.prefill_rows, sweep.decode_rows)}
    samples = []
    for m, kk in ((grid[sweep.decode_rows], kp), (grid[sweep.prefill_rows], kp),
                  *((s, s) for s in CUDA_NORM_SQUARES)):
        x = torch.randn(m, kk, generator=gen, device=dev)
        t = _replay_s(lambda: bk.norms(x, tile), dev, repeat=repeat)
        samples.append(({"kind": "getnorm", "shape": [m, kk]},
                        [1.0, 0.0, float(m * kk * 4), 0.0], t))
        del x
    w = torch.randn(k, n, generator=gen, device=dev).mul_(k ** -0.5)
    nb = bk.norms(cplan.pad_to_tile(w, tile), tile)
    for rows in (sweep.prefill_rows, sweep.decode_rows):
        x = torch.zeros(grid[rows], kp, device=dev)
        x[:rows, :k] = torch.randn(rows, k, generator=gen, device=dev)
        taus = _quantile_taus(bk.norms(x, tile), nb, CUDA_TAU_QUANTILES)
        for tau in taus:
            for bn in (1, 2):
                fw = FrozenWeight.build(w, tau, tile=tile, block_n=bn,
                                        backend="cuda")
                wp = cplan.pad_to_tile(w, tile, tile * bn).contiguous()
                p = cplan.plan(x, frozen_weight=fw)
                t = _replay_s(lambda p=p, wp=wp, rows=rows:
                              cplan.execute(p, x, wp, rows=rows),
                              dev, repeat=repeat)
                samples.append(({"kind": "frozen_worklist",
                                 "shape": [grid[rows], k, n], "rows": rows,
                                 "tau": tau, "block_n": bn},
                                _worklist_row(p, tile, bn), t))
                del fw, wp, p
    return samples


def _device_gate_rate(dev: torch.device, sweep: CardSweep, tile: int,
                      seed: int, repeat: int):
    """Gate product-compares per second of the frozen gate on the card
    (`core.plan._plan_frozen` on a given activation normmap: gather,
    compare, flags, counts), replayed as CUDA graphs (`_replay_s`), as a
    decode step replays it: Σ grid steps / Σ seconds per call over the
    sweep's gated shapes at the decode row grid. The gate costs nearly the
    same per call at every grid (its ≈ 45 nodes, not its steps, set the
    time), and only the decode steps replay it on the critical path (an
    eager prefill's gate hides behind the host's launches), so the rate is
    read there; the prefill grid's calls are timed and reported beside it,
    not fitted. Returns (rate, per-shape records)."""
    from repro_torch.core import plan as cplan
    from repro_torch.kernels import ops as kops
    from repro_torch.plans.frozen import FrozenWeight

    bk = kops.get_backend("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    records, steps_sum, s_sum = [], 0.0, 0.0
    for site, (k, n) in sweep.gemms.items():
        w = torch.randn(k, n, generator=gen, device=dev).mul_(k ** -0.5)
        fw = FrozenWeight.build(w, 1.0, tile=tile, backend="cuda")
        del w
        for rows in (sweep.decode_rows, sweep.prefill_rows):
            gm = -(-rows // tile)
            fp = fw.for_rows(gm)
            na = bk.norms(torch.randn(gm * tile, fp.gk * tile,
                                      generator=gen, device=dev), tile)
            s = _replay_s(lambda fp=fp, na=na: cplan._plan_frozen(
                None, fp, norm_a=na), dev, repeat=repeat)
            steps = float(fp.step_i.shape[0])
            records.append({"site": site, "rows": rows, "steps": steps,
                            "s": s})
            if rows == sweep.decode_rows:
                steps_sum += steps
                s_sum += s
    return steps_sum / s_sum, records


def calibrate(backend: str = "auto", *, device="cuda",
              sweep: Optional[CardSweep] = None,
              tile: Optional[int] = None,
              sizes: Optional[Sequence[int]] = None,
              taus: Sequence[float] = (0.0, 0.02, 0.2), seed: int = 0,
              repeat: int = 3, report: Optional[dict] = None) -> CostCoeffs:
    """Fit machine coefficients from timed kernel calls.

    Solves the additive model of `predict_time_s` for [base, step
    overhead, 1/bandwidth, 1/flops] over get-norm and work-list samples by
    non-negative least squares; a column NNLS zeroes keeps the nominal
    value (the reference's rule). The backend resolves on `device` (the
    card unless asked otherwise; no card raises):

    - "cuda": the caller's serving shapes (`sweep`, required; `tile`
      default 64), each sample device-bound: calls captured in a CUDA
      graph and replayed back to back (`_replay_s`), the regime of a
      replayed decode step, with no host launch cost in the sample. Get-
      norms of the activations and up to ≈ 105 MB; the largest gated
      weight's frozen work-list at the prefill and decode grids across τ
      (a gate that keeps no step among them) and block_n 1, 2. Each
      sample's row is weighted by 1/measured (relative error; the samples
      span three decades). The gate rate is the frozen device gate's at
      the decode grid (`_device_gate_rate`). `sizes` and `taus` do not
      apply.
    - "torch": the reference's sweep (get-norms at `sizes`, default 128,
      256, 384; eager plan + execute across `taus` at tile 32) on the host
      clock (CUDA events on the card), and the reference's host gate rate.

    `report`, when given, receives the samples (features, measured and
    predicted seconds), the fit, the number of columns NNLS kept and the
    largest |log2(measured / predicted)|. Persist the result with
    `CostProfile.put` and `save`."""
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops as kops

    dev = resolve_device(device)
    name = kops.resolve_backend(backend, dev)
    if name == "cuda" and dev.type != "cuda":
        raise ValueError("calibrate(backend='cuda') times the card's kernels: "
                         "pass device='cuda'")
    if name == "cuda":
        if sweep is None:
            raise ValueError("calibrate(backend='cuda') samples the served "
                             "shapes: pass sweep=CardSweep(...)")
        tile = tile or CUDA_TILE
        repeat = max(repeat, 5)
        samples = _card_samples(dev, sweep, tile, seed, repeat)
        gate_rate, gate_records = _device_gate_rate(dev, sweep, tile, seed,
                                                    repeat)
    else:
        tile = tile or 32
        sizes = tuple(sizes or (128, 256, 384))
        samples = _reference_samples(name, dev, tile, sizes, taus, seed,
                                     repeat)
        gate_rate, gate_records = _host_gate_rate(sizes, tile, seed), None
    feats = np.asarray([f for _, f, _ in samples], np.float64)
    times = np.asarray([t for *_, t in samples], np.float64)
    if name == "cuda":
        # the card's samples span three decades (µs get-norms, ms
        # work-lists): each row weighted by 1/measured, so the fit bounds
        # the relative error the cost residual reads, not the largest
        # samples' absolute error alone
        wt = 1.0 / times
        x = _nnls_refit(feats * wt[:, None], times * wt)
    else:
        x = _nnls_refit(feats, times)
    base, step, inv_bw, inv_fl = x
    nominal = DEFAULT_COEFFS.get(name, DEFAULT_COEFFS["torch"])
    coeffs = CostCoeffs(
        bytes_per_s=(float(1.0 / inv_bw) if inv_bw > 0
                     else nominal.bytes_per_s),
        flops_per_s=(float(1.0 / inv_fl) if inv_fl > 0
                     else nominal.flops_per_s),
        step_overhead_s=float(step) if step > 0 else nominal.step_overhead_s,
        base_overhead_s=float(base) if base > 0 else nominal.base_overhead_s,
        gate_ops_per_s=float(gate_rate),
        calibrated=True,
    )
    if report is not None:
        rows = []
        for meta, f, t in samples:
            pred = (coeffs.base_overhead_s + f[1] * coeffs.step_overhead_s
                    + f[2] / coeffs.bytes_per_s + f[3] / coeffs.flops_per_s)
            rows.append({**meta, "features": f, "measured_s": t,
                         "predicted_s": pred,
                         "log2_ratio": float(np.log2(t / pred))})
        report.update({
            "backend": name, "device_kind": device_kind(dev),
            "samples": rows, "fit": x.tolist(),
            "columns_kept": int((x > 0).sum()),
            "max_abs_log2": max(abs(r["log2_ratio"]) for r in rows),
            "gate": gate_records})
    return coeffs
