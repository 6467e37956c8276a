"""Load-balance scheduling (paper §3.5.1; twin of `repro.core.schedule`).

For decay matrices the per-output-tile work v[i,j] = Σ_k bitmap[i,j,k]
concentrates near the diagonal (paper Fig. 4). What matters across GPUs is
balance in the distributed row partition (§3.4): contiguous row strips give
the diagonal-heavy strips more work. The paper's fix — each worker takes
`s` tiles at stride BDIM/s — is a cyclic (strided) assignment of C tile
rows to ranks.

Work estimates may be computed at a coarse norm-pyramid level (`v_matrix`
takes NormPyramid operands and a `level`): each coarse V entry aggregates a
2^level × 2^level block of C tiles and costs 8^level fewer gate products,
cheap enough to re-estimate per call and pick the schedule
(`auto_schedule`).

Equal-work partitioning (`equal_work_partition`): variable-width CONTIGUOUS
strips whose predicted work is equal — a prefix-sum split of the per-row
work estimate. The partition is a plain row-offset table, so it can be
kept and re-cut between steps when the estimate drifts
(`ReshardController`).

Everything here except `v_matrix` and `probe_v_estimate` is host numpy; a
work estimate V may be a tensor on any device or a numpy array, so the
reference's own V feeds these functions unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.obs import IMBALANCE_BUCKETS


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def v_matrix(norm_a, norm_b, tau, *, level: int = 0) -> torch.Tensor:
    """V[i,j] = Σ_k bitmap[i,j,k] — the paper's per-tile valid-multiplication
    count (int32), summed from the planner's gate (`core.plan.gate_mask`).

    Operands may be plain normmaps or NormPyramids; `level` selects the
    pyramid level the estimate is computed at (plain normmaps ignore it;
    both sides are read at the same level, clamped to the shallower
    pyramid)."""
    from repro_torch.core.plan import NormPyramid, _f32, gate_mask

    a_pyr = isinstance(norm_a, NormPyramid)
    b_pyr = isinstance(norm_b, NormPyramid)
    if a_pyr and b_pyr:
        level = min(level, norm_a.num_levels, norm_b.num_levels)
    else:
        level = 0
    if a_pyr:
        norm_a = norm_a.levels[level]
    if b_pyr:
        norm_b = norm_b.levels[level]
    return gate_mask(norm_a, norm_b, _f32(tau)).sum(dim=-1,
                                                    dtype=torch.int32)


def rows_for_device(d: int, num_devices: int, gm: int,
                    schedule: str) -> np.ndarray:
    """Tile-row indices rank d owns under a UNIFORM-shape schedule:
    'contiguous' (paper §3.4) or 'cyclic' (§3.5.1). A non-divisible gm
    spreads the remainder over the leading ranks. 'equal_work' strips are
    an explicit offset table instead (`rows_for_partition`)."""
    if schedule == "contiguous":
        return np.array_split(np.arange(gm), num_devices)[d]
    if schedule == "cyclic":
        return np.arange(d, gm, num_devices)
    if schedule == "equal_work":
        raise ValueError(
            "equal_work strips are variable-width: build an offset table "
            "with equal_work_partition(v, ...) and index it with "
            "rows_for_partition(d, offsets)")
    raise ValueError(schedule)


def rows_for_partition(d: int, offsets) -> np.ndarray:
    """Tile-row indices rank d owns under an explicit variable-width
    partition (`offsets` as returned by `equal_work_partition`)."""
    offsets = np.asarray(offsets, np.int64)
    return np.arange(offsets[d], offsets[d + 1])


def device_permutation(num_devices: int, gm: int,
                       schedule: str) -> np.ndarray:
    """Row-tile permutation such that contiguous shards of the permuted
    matrix realize `schedule`: perm[new_pos] = old_row_tile."""
    return np.concatenate(
        [rows_for_device(d, num_devices, gm, schedule)
         for d in range(num_devices)])


def _fine_work(v, *, level: int = 0,
               fine_rows: Optional[int] = None) -> np.ndarray:
    """Per-FINE-tile-row work estimate from a (possibly coarse) V: each
    coarse row's work is spread uniformly over its member fine rows (clipped
    at the ragged edge), so any fine row range sums exactly the work it
    owns, including coarse rows that straddle a strip boundary."""
    work_rows = _np(v).sum(axis=1).astype(np.float64)
    f = 1 << level
    gm = fine_rows if fine_rows is not None else work_rows.shape[0] * f
    assert work_rows.shape[0] == -(-gm // f), (np.shape(v), level, gm)
    counts = np.clip(gm - np.arange(work_rows.shape[0]) * f, 0, f)
    return np.repeat(work_rows / np.maximum(counts, 1), f)[:gm]


def _uniform_offsets(n: int, parts: int) -> np.ndarray:
    """Offset table of the uniform contiguous split (np.array_split's
    strip boundaries)."""
    sizes = np.full(parts, n // parts, np.int64)
    sizes[: n % parts] += 1
    return np.concatenate(([0], np.cumsum(sizes)))


def _equal_cuts(work: np.ndarray, parts: int) -> np.ndarray:
    """Greedy prefix-sum cut of a 1-D work profile into `parts` contiguous
    non-empty segments of total/parts each, clamped so no segment is empty;
    the better (by max/mean) of the cut and the uniform split."""
    n = work.shape[0]
    if n < parts:
        raise ValueError(f"cannot cut {n} rows into {parts} non-empty strips")
    uniform = _uniform_offsets(n, parts)
    total = float(work.sum())
    if not np.isfinite(total) or total <= 0:
        return uniform
    cum = np.cumsum(work, dtype=np.float64)
    targets = total * np.arange(1, parts, dtype=np.float64) / parts
    cuts = np.searchsorted(cum, targets, side="left") + 1
    for i in range(parts - 1):
        c = int(cuts[i])
        if c > 1 and abs(cum[c - 2] - targets[i]) < abs(cum[c - 1]
                                                        - targets[i]):
            cuts[i] = c - 1
    offsets = np.concatenate(([0], cuts, [n])).astype(np.int64)
    for d in range(1, parts):
        offsets[d] = max(offsets[d], offsets[d - 1] + 1)
    for d in range(parts - 1, 0, -1):
        offsets[d] = min(offsets[d], offsets[d + 1] - 1)

    def _imb(offs):
        cs = np.concatenate(([0.0], cum))
        loads = cs[offs[1:]] - cs[offs[:-1]]
        return loads.max() / max(loads.mean(), 1e-9)

    return offsets if _imb(offsets) <= _imb(uniform) else uniform


def equal_work_partition(v, num_devices: int, *, level: int = 0,
                         fine_rows: Optional[int] = None) -> np.ndarray:
    """Variable-width equal-work row strips from a (possibly coarse) work
    estimate V: offsets[d] .. offsets[d+1] are the FINE tile rows rank d
    owns (num_devices + 1 entries from 0 to gm; every strip non-empty,
    which needs gm ≥ num_devices). An all-zero V, or a profile where the
    greedy cut loses to uniform strips, gives the uniform strips."""
    per_fine = _fine_work(v, level=level, fine_rows=fine_rows)
    return _equal_cuts(per_fine, num_devices)


def partition_loads(v, offsets, *, level: int = 0,
                    fine_rows: Optional[int] = None) -> np.ndarray:
    """Per-rank predicted work under an explicit partition (coarse rows
    straddling a boundary split their work across their owners). A table
    that does not cover this grid raises."""
    per_fine = _fine_work(v, level=level, fine_rows=fine_rows)
    gm = per_fine.shape[0]
    offs = np.asarray(offsets, np.int64)
    if offs[0] != 0 or offs[-1] != gm or np.any(np.diff(offs) < 0):
        raise ValueError(
            f"offset table {offs} does not cover row grid {gm}: re-cut the "
            f"partition for this grid (equal_work_partition)")
    cs = np.concatenate(([0.0], np.cumsum(per_fine, dtype=np.float64)))
    return cs[offs[1:]] - cs[offs[:-1]]


def partition_imbalance(v, offsets, *, level: int = 0,
                        fine_rows: Optional[int] = None) -> float:
    """max-rank work / mean-rank work under an explicit partition — the
    drift signal the re-sharding controller compares with a fresh cut."""
    loads = partition_loads(v, offsets, level=level, fine_rows=fine_rows)
    return float(loads.max() / max(loads.mean(), 1e-9))


def strip_tables(offsets, gm: int, num_devices: int, *,
                 width: Optional[int] = None):
    """Gather tables realizing a variable-width row partition on a uniform
    shard grid: each rank's strip is right-padded to a common width by
    CLAMPING to its own last row (pad slots recompute a row the rank
    already owns; gating is row-independent, so real rows are untouched and
    pads are dropped on the way back).

    Returns (perm, keep): perm[d * w + s] = fine row rank d computes in slot
    s; keep marks the non-pad slots, which in (rank, slot) order enumerate
    rows 0..gm-1 once, in order. `width` pins the padded width (≥ the
    widest strip) so every re-cut of one grid has the same shapes; None
    uses the widest strip. Raises on a table cut for another grid or rank
    count."""
    offs = np.asarray(offsets, np.int64)
    if offs.shape != (num_devices + 1,):
        raise ValueError(
            f"offset table has {offs.shape[0] - 1} strips for "
            f"{num_devices} devices — re-cut it for this mesh")
    if offs[0] != 0 or offs[-1] != gm or np.any(np.diff(offs) < 1):
        raise ValueError(
            f"malformed offset table {offs} for row grid {gm}: must rise "
            f"monotonically from 0 to gm with non-empty strips")
    widths = np.diff(offs)
    wmax = int(widths.max())
    if width is not None:
        if width < wmax:
            raise ValueError(
                f"fixed strip width {width} < widest strip {wmax}: clamp "
                f"the cut (rescale_offsets max_width=) before building "
                f"tables")
        wmax = int(width)
    slots = np.arange(wmax)[None, :]
    idx = np.minimum(offs[:-1, None] + slots, offs[1:, None] - 1)
    keep = (slots < widths[:, None]).reshape(-1)
    return idx.reshape(-1), keep


def rescale_offsets(offsets, fine_rows: int, *,
                    max_width: Optional[int] = None) -> np.ndarray:
    """Re-express an offset table cut on one row grid as a cut of another:
    each boundary keeps its fractional position (rounded to the new grid),
    clamped monotone with non-empty strips and, optionally, no strip wider
    than `max_width`. Needs num_strips ≤ fine_rows ≤ num_strips · max_width."""
    offs = np.asarray(offsets, np.int64)
    parts = offs.shape[0] - 1
    src = int(offs[-1])
    if parts < 1 or src < 1 or offs[0] != 0 or np.any(np.diff(offs) < 1):
        raise ValueError(f"malformed offset table {offs}")
    if fine_rows < parts:
        raise ValueError(
            f"cannot cut {fine_rows} rows into {parts} non-empty strips")
    if max_width is not None and fine_rows > parts * max_width:
        raise ValueError(
            f"{fine_rows} rows cannot fit {parts} strips of ≤ {max_width}")
    out = np.rint(offs.astype(np.float64) * (fine_rows / src)).astype(
        np.int64)
    out[0], out[-1] = 0, fine_rows
    for d in range(1, parts):
        out[d] = max(out[d], out[d - 1] + 1)
    for d in range(parts - 1, 0, -1):
        out[d] = min(out[d], out[d + 1] - 1)
    if max_width is not None:
        for d in range(parts - 1, 0, -1):
            out[d] = max(out[d], out[d + 1] - max_width)
        for d in range(1, parts):
            out[d] = min(out[d], out[d - 1] + max_width)
    if not (out[0] == 0 and out[-1] == fine_rows
            and np.all(np.diff(out) >= 1)):
        raise ValueError(f"rescaled table {out} is not a partition")
    return out


def device_loads(v, num_devices: int, schedule: str, *, level: int = 0,
                 fine_rows: Optional[int] = None,
                 offsets=None) -> np.ndarray:
    """Per-rank work under a row-strip assignment, attributed at FINE
    tile-row granularity: 'contiguous'/'cyclic' take `rows_for_device`'s
    uniform shapes; 'equal_work' (or an explicit `offsets` table) sums the
    variable-width strips."""
    if schedule == "equal_work" or offsets is not None:
        if offsets is None:
            offsets = equal_work_partition(v, num_devices, level=level,
                                           fine_rows=fine_rows)
        offsets = np.asarray(offsets, np.int64)
        if offsets.shape != (num_devices + 1,):
            raise ValueError(f"offset table {offsets} is not one of "
                             f"{num_devices} strips")
        return partition_loads(v, offsets, level=level, fine_rows=fine_rows)
    per_fine = _fine_work(v, level=level, fine_rows=fine_rows)
    gm = per_fine.shape[0]
    return np.array([
        per_fine[rows_for_device(d, num_devices, gm, schedule)].sum()
        for d in range(num_devices)])


def _f32_ratio(loads) -> float:
    """max / max(mean, 1e-9) in float32, as the reference computes it."""
    loads = np.asarray(loads, np.float32)
    return float(np.float32(loads.max())
                 / np.maximum(np.float32(loads.mean()), np.float32(1e-9)))


def imbalance(v, num_devices: int, schedule: str, offsets=None) -> float:
    """max-rank work / mean-rank work under a row-strip assignment of V
    (float32); 'equal_work' or explicit `offsets` evaluate the
    variable-width strips."""
    if schedule == "equal_work" or offsets is not None:
        loads = device_loads(v, num_devices, schedule, offsets=offsets)
        return float(np.float32(loads.max() / max(loads.mean(), 1e-9)))
    vn = _np(v)
    gm = vn.shape[0]
    work_rows = vn.sum(axis=1)
    return _f32_ratio([work_rows[rows_for_device(d, num_devices, gm,
                                                 schedule)].sum()
                       for d in range(num_devices)])


def tile_imbalance(v, num_workers: int, schedule: str) -> float:
    """Paper Fig. 4's setting: workers own individual C tiles (row-major).
    'contiguous' gives diagonal-adjacent chunks to one worker, 'cyclic' is
    the §3.5.1 stride-s fix, 'equal_work' cuts variable-length contiguous
    tile runs by prefix sum."""
    flat = _np(v).reshape(-1)
    if schedule == "equal_work":
        work = flat.astype(np.float64)
        offs = _equal_cuts(work, num_workers)
        cs = np.concatenate(([0.0], np.cumsum(work)))
        return _f32_ratio(cs[offs[1:]] - cs[offs[:-1]])
    n = flat.shape[0] - (flat.shape[0] % num_workers)
    flat = flat[:n]
    if schedule == "contiguous":
        loads = flat.reshape(num_workers, -1).sum(axis=1)
    elif schedule == "cyclic":
        loads = flat.reshape(-1, num_workers).sum(axis=0)
    else:
        raise ValueError(schedule)
    return _f32_ratio(loads)


def auto_schedule(v, num_devices: int, *, threshold: float = 1.25,
                  level: int = 0, fine_rows: Optional[int] = None,
                  equal_work_margin: float = 1.1,
                  allow_equal_work: bool = True) -> str:
    """Pick the row-strip schedule from a (possibly coarse) estimate V:
    'cyclic' when contiguous strips are imbalanced beyond `threshold` and
    cyclic improves them, else 'contiguous'; then 'equal_work' when that
    pick is still beyond `threshold` and the equal-work cut beats it by
    `equal_work_margin`. Loads are attributed at the fine row grid."""
    gm = fine_rows if fine_rows is not None else _np(v).shape[0] << level
    if gm < num_devices:
        return "contiguous"
    imbs = {}
    scheds = ("contiguous", "cyclic") + (
        ("equal_work",) if allow_equal_work else ())
    for sched in scheds:
        loads = device_loads(v, num_devices, sched, level=level,
                             fine_rows=gm)
        imbs[sched] = float(loads.max() / max(loads.mean(), 1e-9))
    pick = ("cyclic" if imbs["contiguous"] > threshold
            and imbs["cyclic"] < imbs["contiguous"] else "contiguous")
    if (allow_equal_work and imbs[pick] > threshold
            and imbs[pick] >= equal_work_margin * imbs["equal_work"]):
        pick = "equal_work"
    return pick


# ---------------------------------------------------------------------------
# drift-triggered re-sharding (control plane)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ReshardConfig:
    """Knobs of the drift-triggered re-sharding loop.

    num_devices: strips to cut (0 lets the owner — engine or train loop —
      resolve it from its mesh or device count first).
    every: probe cadence in engine or train steps (0 disables it).
    drift_threshold: re-cut when the live partition's predicted imbalance
      exceeds the fresh equal-work cut's by this factor.
    level: norm-pyramid level of the probe estimate.
    probe_window: serving probes read at most this many of each request's
      most recent tokens (0 = all).
    """
    num_devices: int = 0
    every: int = 16
    drift_threshold: float = 1.2
    level: int = 0
    probe_window: int = 2048


class ReshardController:
    """Owns the live equal-work partition and re-cuts it when the work
    estimate drifts: every `cfg.every` steps a fresh estimate is probed,
    and the partition is replaced only when the live cut's predicted
    imbalance exceeds a fresh cut's by `cfg.drift_threshold`. Pure control
    plane: the products it places are bit-identical under any partition."""

    def __init__(self, cfg: ReshardConfig):
        if cfg.num_devices <= 0:
            raise ValueError(
                "ReshardController needs a positive num_devices — resolve "
                "the 0-means-mesh-default before constructing it "
                "(resolve_reshard_devices)")
        self.cfg = cfg
        self.offsets: Optional[np.ndarray] = None
        self.resharded = 0
        self.probes = 0
        self.history: list = []
        self._published = 0

    @property
    def live_imbalance(self) -> Optional[float]:
        """Predicted imbalance of the live partition at the last probe."""
        return self.history[-1]["live_imbalance"] if self.history else None

    @property
    def live_loads(self) -> Optional[np.ndarray]:
        """Per-strip predicted work of the live partition at the last
        probe."""
        if not self.history:
            return None
        return np.asarray(self.history[-1]["loads"], np.float64)

    def due(self, step: int) -> bool:
        return self.cfg.every > 0 and step % self.cfg.every == 0

    def probe(self, v, step: int, *, level: Optional[int] = None,
              fine_rows: Optional[int] = None) -> np.ndarray:
        """Feed a fresh work estimate; returns the (possibly re-cut) live
        offsets. The first probe, and a probe on another row grid, cut the
        partition afresh (not a re-shard event); later probes replace it
        only beyond the drift threshold."""
        lv = self.cfg.level if level is None else level
        ndev = self.cfg.num_devices
        self.probes += 1
        fresh = equal_work_partition(v, ndev, level=lv, fine_rows=fine_rows)
        fresh_imb = partition_imbalance(v, fresh, level=lv,
                                        fine_rows=fine_rows)
        event = False
        stale = (self.offsets is None or self.offsets.shape != fresh.shape
                 or self.offsets[-1] != fresh[-1])
        if stale:
            self.offsets = fresh
            live_imb = fresh_imb
        else:
            live_imb = partition_imbalance(v, self.offsets, level=lv,
                                           fine_rows=fine_rows)
            event = (live_imb > self.cfg.drift_threshold * fresh_imb
                     and not np.array_equal(fresh, self.offsets))
            if event:
                self.offsets = fresh
                self.resharded += 1
        loads = partition_loads(v, self.offsets, level=lv,
                                fine_rows=fine_rows)
        self.history.append({
            "step": step,
            "grid": int(fresh[-1]),
            "live_imbalance": live_imb,
            "fresh_imbalance": fresh_imb,
            "resharded": event,
            "loads": [float(x) for x in loads],
        })
        return self.offsets

    def publish(self, registry):
        """Feed the probes recorded since the last call into an
        `obs.MetricsRegistry`: probe and re-shard counters, the predicted
        imbalance histogram and the live-imbalance gauge (incremental)."""
        new = self.history[self._published:]
        if not new:
            return
        self._published = len(self.history)
        probes = registry.counter(
            "spamm_reshard_probes_total", "Work-estimate recomputations")
        events = registry.counter(
            "spamm_reshard_events_total",
            "Partition replacements (drift beyond threshold)")
        imb = registry.histogram(
            "spamm_partition_imbalance",
            "Predicted imbalance of the live partition at each probe",
            buckets=IMBALANCE_BUCKETS)
        gauge = registry.gauge(
            "spamm_partition_imbalance_live",
            "Live partition's predicted imbalance at the latest probe")
        probes.inc(len(new))
        events.inc(sum(1 for h in new if h["resharded"]))
        for h in new:
            if h["live_imbalance"] is not None:
                imb.observe(float(h["live_imbalance"]))
        last = new[-1]["live_imbalance"]
        if last is not None:
            gauge.set(float(last))


def resolve_reshard_devices(cfg: ReshardConfig, mesh,
                            batch_axes=("data",)) -> ReshardConfig:
    """Resolve num_devices=0 to the strips a row partition would shard
    over: the product of `mesh`'s `batch_axes` extents for a
    `DeviceMesh`, or `mesh` itself when it is a device count."""
    if cfg.num_devices > 0:
        return cfg
    if isinstance(mesh, int):
        ndev = mesh
    else:
        ndev = 1
        for ax in batch_axes:
            if ax in (mesh.mesh_dim_names or ()):
                ndev *= mesh.size(mesh.mesh_dim_names.index(ax))
    return dataclasses.replace(cfg, num_devices=ndev)


def probe_v_estimate(x, weight_norms, tau, *, tile: int = 64,
                     backend: str = "auto", level: int = 0):
    """Work estimate V for activation rows `x` against a cached weight-side
    normmap or pyramid — the cheap re-sharding probe: only the activation
    get-norm (plus `level` poolings) is fresh. Returns (v, fine_rows),
    fine_rows being x's tile-row count (the grid the partition shards)."""
    from repro_torch.core import plan as _plan
    from repro_torch.kernels import ops as kops

    bk = kops.get_backend(backend)
    xp = _plan.pad_to_tile(x.float(), tile).contiguous()
    nx = bk.norms(xp, tile)
    if level > 0:
        nx = _plan.NormPyramid.from_normmap(nx, level, tile=tile,
                                            backend=backend)
    return v_matrix(nx, weight_norms, tau, level=level), xp.shape[0] // tile
