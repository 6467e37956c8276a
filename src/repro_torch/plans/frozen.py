"""Frozen weight-side SpAMM plans (twin of `repro.plans.frozen`).

The weight half of the gating phase is a pure function of the static weight,
so serving freezes it once:

  * `FrozenWeight` — the shape-independent artifact: the weight-side normmap
    (pyramid), the super-column max-norm table `nbmax`, and the
    weight-admissible (k, j) pair list (with τ > 0 a zero-norm weight tile
    can never pass the gate).
  * `FrozenPlan` — `FrozenWeight.for_rows(gm)`: the artifact specialized to
    an activation row grid: pair-major, ascending-k step tables over every
    weight-admissible (i, j, k), bucket-padded, plus the per-step segment
    tables (`seg_first`/`seg_last`) the device-side flag arithmetic reads
    and the run boundaries (`runs`) the work-list kernel launches one
    thread block per. Built on the host once per row grid and kept as
    device tensors; a serving step only reads them.

Low precision: `FrozenWeight.build(compute_dtype=…)` takes the norms of the
quantized weight (int8: the fused get-norm, whose scales become `b_scale`)
and keeps the REQUESTED τ; `for_rows` bakes the WIDENED τ
(`kernels.quantize.widen_tau`) into the `FrozenPlan`, whose gate then keeps
every tile the f32 gate at τ keeps.

Exactness: the frozen step tables are a superset of every reachable mask;
the per-call activation gate `norm_a[i,k] · nbmax[k,j] ≥ τ` re-applies the
exact flat test per step, so the frozen path is bit-identical to the eager
`plan()` + `execute()` pipeline (same active steps, same kernel, same
ascending-k accumulation).

Store addressing: an artifact carries its weight's content fingerprint
(`weight_hash`), the plan format version and the gating config that made it
(`config_key()`: τ, tile, block_n, levels, the resolved backend, the
get-norm variant `use_mxu` and the compute dtype); `plans.store.PlanStore`
files it under their hash.

Per-layer plans stay a Python list (one FrozenPlan per layer): the port's
layer loop is a Python loop. Row shards (`slice_rows`, `shard_by_offsets`)
are one FrozenPlan per shard, all of one static shape, so the sharded
engine copies a re-cut's tables into a captured step's buffers
(`FrozenPlan.copy_`); `stack_plans` stacks plans of one shape along a
leading dim for a caller that wants one tensor per table.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.cost import TunedParams, bucket
from repro_torch.core.plan import NormPyramid, dtype_norms, pad_to_tile
from repro_torch.kernels import ops as kops
from repro_torch.kernels import quantize as kquant


# Bump when the on-disk encoding changes incompatibly: PlanStore refuses
# artifacts written under another version. The reference's value, so that
# the two packages' stores share one format (v2: compute-dtype keying, int8
# b_scale tables, the widened gate τ).
PLAN_FORMAT_VERSION = 2


class FrozenWeight:
    """Shape-independent frozen gating artifact of ONE gated weight.

    Fields: tau (the requested τ, f32-rounded Python float); levels (tuple
    of normmaps on the weight's device, finest first — of the quantized
    weight on a low-precision artifact); nbmax (gk, gn//block_n) f32 on the
    device; kj_k/kj_j (W,) int32 numpy — the weight-admissible (k, j) pairs
    sorted by (j, k), read on the host only by `for_rows`; b_scale (gk, gnp)
    f32 per-tile int8 scales of the padded weight, or None. Metadata: tile,
    block_n, num_levels, backend (resolved: "cuda" or "torch"), wshape (the
    true (K, N)), padded ((Kp, Np)), use_mxu (which get-norm variant made
    the norms), weight_hash (content fingerprint, "" when unknown),
    version, compute_dtype, and tuned — the autotuner's
    `TunedParams` when the artifact came from it (provenance and the
    work-list bucket floor; not an addressing field)."""

    def __init__(self, tau, levels, nbmax, kj_k, kj_j, b_scale=None, *,
                 tile: int, block_n: int, num_levels: int, backend: str,
                 wshape: Tuple[int, int], padded: Tuple[int, int],
                 use_mxu: bool = False, weight_hash: str = "",
                 version: int = PLAN_FORMAT_VERSION,
                 compute_dtype: str = "float32",
                 tuned: TunedParams | None = None):
        self.tau = tau
        self.levels = tuple(levels)
        self.nbmax = nbmax
        self.kj_k = kj_k
        self.kj_j = kj_j
        self.b_scale = b_scale
        self.tile = tile
        self.block_n = block_n
        self.num_levels = num_levels
        self.backend = backend
        self.wshape = tuple(wshape)
        self.padded = tuple(padded)
        self.use_mxu = use_mxu
        self.weight_hash = weight_hash
        self.version = version
        self.compute_dtype = compute_dtype
        self.tuned = tuned
        self._rows_cache: dict = {}

    @property
    def grid(self) -> Tuple[int, int]:
        """(gk, gn//block_n)."""
        return tuple(self.nbmax.shape)

    @property
    def num_kj(self) -> int:
        return int(self.kj_k.shape[0])

    @property
    def bucket_floor(self) -> int:
        """The work-list bucket floor `for_rows` pads to: the tuned value
        when the artifact carries one, else 16."""
        return self.tuned.bucket if self.tuned is not None else 16

    def config_key(self) -> dict:
        """The config echo that, with the weight hash, addresses this
        artifact in a PlanStore: every field that changes the stored
        normmaps or the gate."""
        return {
            "tau": float(self.tau),
            "tile": self.tile,
            "block_n": self.block_n,
            "levels": self.num_levels,
            "backend": self.backend,
            "use_mxu": self.use_mxu,
            "dtype": self.compute_dtype,
        }

    @classmethod
    def build(cls, w: torch.Tensor, tau, *, tile: int = 64, block_n: int = 1,
              levels: int = 0, backend: str = "auto", use_mxu: bool = False,
              weight_hash: str = "", compute_dtype: str = "float32",
              tuned: TunedParams | None = None) -> "FrozenWeight":
        """Freeze the weight side of `x @ w` gating at threshold `tau`: the
        backend's get-norm runs ONCE on the padded weight (on its device),
        the pyramid pools through the backend's kernel, and the pair list is
        built on the host. compute_dtype freezes for low-precision
        execution: the norms of the quantized weight (int8: the fused
        get-norm, whose scales are stored as `b_scale`). The artifact
        records the backend resolved by the weight's device."""
        resolved = kops.resolve_backend(backend, w.device)
        bk = kops.get_backend(resolved)
        compute_dtype = kquant.canonical_dtype(compute_dtype)
        if w.dim() != 2:
            raise ValueError(f"expected a 2-D weight, got {tuple(w.shape)}")
        wp = pad_to_tile(w, tile, tile * block_n).contiguous()
        base, b_scale = dtype_norms(bk, wp, compute_dtype, tile, use_mxu)
        pyr = NormPyramid.from_normmap(base, levels, tile=tile,
                                       backend=bk.name)
        base_np = base.detach().cpu().numpy().astype(np.float32, copy=False)
        gk, gnp = base_np.shape
        assert gnp % block_n == 0, (gnp, block_n)
        gnb = gnp // block_n
        nbmax = (base_np.reshape(gk, gnb, block_n).max(2)
                 if block_n > 1 else base_np)
        tau_f = float(np.float32(float(tau)))
        if tau_f > 0.0:
            # a zero-norm weight super-column can never pass `na·nb ≥ τ>0`
            kk, jj = np.nonzero(nbmax > 0.0)
        else:
            kk, jj = [x.ravel() for x in
                      np.mgrid[0:gk, 0:gnb].astype(np.int64)]
        order = np.lexsort((kk, jj))  # (j asc, k asc) → pair-major steps
        return cls(
            tau_f, pyr.levels,
            torch.as_tensor(np.ascontiguousarray(nbmax), device=base.device),
            kk[order].astype(np.int32), jj[order].astype(np.int32), b_scale,
            tile=tile, block_n=block_n, num_levels=levels, backend=bk.name,
            wshape=tuple(w.shape), padded=tuple(wp.shape), use_mxu=use_mxu,
            weight_hash=weight_hash, compute_dtype=compute_dtype,
            tuned=tuned,
        )

    def for_rows(self, gm: int, *, min_steps: int = 0) -> "FrozenPlan":
        """Specialize to an activation row grid of `gm` tiles: step tables
        pair-major ((i, j) runs contiguous, k ascending within a run),
        padded to a power-of-two bucket of at least max(`min_steps`,
        `bucket_floor`); padding repeats the last real triple with `real`
        clear. Cached per (gm, bucket)."""
        return self._specialize(gm, gm, min_steps)

    def slice_rows(self, lo: int, hi: int, *, gm: Optional[int] = None,
                   min_steps: int = 0) -> "FrozenPlan":
        """The per-shard plan of row-tile strip [lo, hi) on a LOCAL grid of
        `gm` tiles (≥ the strip width; default the width): the shard's
        rows renumbered from 0, real steps over local tiles [0, hi - lo),
        local tiles beyond untargeted clamp padding that does no gated
        work. The weight-side pair list is activation-row-agnostic, so the
        content depends only on the width; (lo, hi) names the strip and
        validates the cut. Plans of one local grid and bucket share every
        shape (the run table is padded to the grid's most runs with empty
        runs), so one can be copied into another's buffers."""
        if not 0 <= lo <= hi:
            raise ValueError(f"bad row strip [{lo}, {hi})")
        width = hi - lo
        gm = width if gm is None else gm
        if gm < width:
            raise ValueError(
                f"local grid {gm} smaller than strip width {width}")
        return self._specialize(width, gm, min_steps)

    def shard_by_offsets(self, offsets, *, width: Optional[int] = None,
                         min_steps: int = 0) -> list:
        """One `slice_rows` plan per strip of a variable-width partition
        (`offsets` in this weight's row-tile units), all on one local grid
        of `width` tiles (≥ the widest strip; default the widest) and one
        step bucket computed at that width, so every shard — and every
        later cut at this width — has the same shapes. `stack_plans`
        stacks them along a leading dim for a caller that wants one
        tensor per table."""
        offs = np.asarray(offsets, np.int64)
        if offs.ndim != 1 or offs.shape[0] < 2 or offs[0] != 0 \
                or np.any(np.diff(offs) < 1):
            raise ValueError(f"malformed offset table {offs}")
        wmax = int(np.diff(offs).max())
        if width is not None:
            if width < wmax:
                raise ValueError(
                    f"fixed width {width} < widest strip {wmax}")
            wmax = int(width)
        steps = bucket(max(wmax * self.num_kj, min_steps), self.bucket_floor)
        return [self.slice_rows(int(offs[d]), int(offs[d + 1]), gm=wmax,
                                min_steps=steps)
                for d in range(offs.shape[0] - 1)]

    def _specialize(self, width: int, gm: int,
                    min_steps: int) -> "FrozenPlan":
        """Shared body of `for_rows` (width == gm) and `slice_rows` (width ≤
        gm: real steps cover local tiles [0, width), tiles beyond are
        untargeted clamp padding)."""
        gk, gnb = self.grid
        w = self.num_kj
        s_real = width * w
        s = bucket(max(s_real, min_steps), self.bucket_floor)
        key = (width, gm, s)
        hit = self._rows_cache.get(key)
        if hit is not None:
            return hit
        kj_k = np.asarray(self.kj_k, np.int32)
        kj_j = np.asarray(self.kj_j, np.int32)
        if s_real:
            step_i = np.repeat(np.arange(width, dtype=np.int32), w)
            step_j = np.tile(kj_j, width)
            step_k = np.tile(kj_k, width)
            pad = s - s_real
            if pad:
                step_i = np.concatenate([step_i, np.full(pad, step_i[-1])])
                step_j = np.concatenate([step_j, np.full(pad, step_j[-1])])
                step_k = np.concatenate([step_k, np.full(pad, step_k[-1])])
        else:
            step_i = np.zeros(s, np.int32)
            step_j = np.zeros(s, np.int32)
            step_k = np.zeros(s, np.int32)
        step_real = np.zeros(s, bool)
        step_real[:s_real] = True
        # segment (= output pair) runs over the PADDED tables: padding
        # repeats the last real (i, j), so it merges into the final run
        pair = step_i.astype(np.int64) * gnb + step_j
        new = np.ones(s, bool)
        new[1:] = pair[1:] != pair[:-1]
        starts = np.flatnonzero(new)
        counts = np.diff(np.append(starts, s))
        ends = np.append(starts[1:], s) - 1
        seg_first = np.repeat(starts, counts).astype(np.int32)
        seg_last = np.repeat(ends, counts).astype(np.int32)
        # kernel runs stop at the last REAL step: the bucket padding merged
        # into the final segment is never active, and the one flag it can
        # carry (an all-inactive segment's INIT|FLUSH at its last step)
        # writes zeros over the zero-initialised output — walking it would
        # serialise up to half the bucket in one thread block. A strip
        # narrower than its local grid pads the table with empty runs
        # (start == end: a thread block that walks nothing) up to the
        # grid's most runs, so every strip of the grid has one shape.
        runs = np.append(starts[starts < s_real], s_real).astype(np.int32)
        if width < gm:
            most = gm * len(np.unique(kj_j)) + 1
            runs = np.append(runs, np.full(most - runs.shape[0], s_real,
                                           np.int32))
        dev = self.nbmax.device

        def up(x):
            return torch.as_tensor(np.ascontiguousarray(x), device=dev)

        # the plan's τ is the GATE threshold: on a low-precision artifact
        # the widened τ' ≤ τ, so the gate over quantized norms keeps every
        # tile the f32 gate at τ keeps (self.tau stays the requested τ)
        gate_tau = float(np.float32(kquant.widen_tau(
            self.tau, self.compute_dtype, self.tile)))
        fp = FrozenPlan(
            gate_tau, self.levels[0], self.nbmax,
            up(step_i.astype(np.int32)), up(step_j.astype(np.int32)),
            up(step_k.astype(np.int32)), up(step_real), up(seg_first),
            up(seg_last), up(runs), self.b_scale,
            tile=self.tile, block_n=self.block_n, num_levels=self.num_levels,
            backend=self.backend, gm=gm, gk=gk, gnb=gnb,
            compute_dtype=self.compute_dtype,
        )
        self._rows_cache[key] = fp
        return fp


class FrozenPlan:
    """A FrozenWeight specialized to one activation row grid.

    Device tensors: norm_b (gk, gnp), nbmax (gk, gnb), step_i/j/k (S,)
    int32, step_real (S,) bool, seg_first/seg_last (S,) int32, runs (R+1,)
    int32 — boundaries of the same segments up to the last real step, one
    kernel thread block each; b_scale (gk, gnp) f32 int8 weight scales, or
    None. tau is the gate threshold (f32-rounded Python float; widened on a
    low-precision plan). Metadata: tile, block_n, num_levels, backend, gm,
    gk, gnb, compute_dtype."""

    def __init__(self, tau, norm_b, nbmax, step_i, step_j, step_k, step_real,
                 seg_first, seg_last, runs, b_scale=None, *, tile: int,
                 block_n: int, num_levels: int, backend: str, gm: int,
                 gk: int, gnb: int, compute_dtype: str = "float32"):
        self.tau = tau
        self.norm_b = norm_b
        self.nbmax = nbmax
        self.step_i = step_i
        self.step_j = step_j
        self.step_k = step_k
        self.step_real = step_real
        self.seg_first = seg_first
        self.seg_last = seg_last
        self.runs = runs
        self.b_scale = b_scale
        self.compute_dtype = compute_dtype
        self.tile = tile
        self.block_n = block_n
        self.num_levels = num_levels
        self.backend = backend
        self.gm = gm
        self.gk = gk
        self.gnb = gnb

    _TABLES = ("norm_b", "nbmax", "step_i", "step_j", "step_k", "step_real",
               "seg_first", "seg_last", "runs", "b_scale")

    def signature(self) -> tuple:
        """Metadata and table shapes: plans of one signature can take each
        other's tables in place (`copy_`) and stack (`stack_plans`)."""
        return (self.tau, self.tile, self.block_n, self.num_levels,
                self.backend, self.gm, self.gk, self.gnb,
                self.compute_dtype) + tuple(
            None if getattr(self, n) is None else tuple(getattr(self, n).shape)
            for n in self._TABLES)

    def to(self, device) -> "FrozenPlan":
        """This plan with its tables on `device` (itself when already
        there)."""
        device = torch.device(device)
        if self.step_i.device == device:
            return self
        moved = {n: (None if getattr(self, n) is None
                     else getattr(self, n).to(device)) for n in self._TABLES}
        return FrozenPlan(
            self.tau, moved["norm_b"], moved["nbmax"], moved["step_i"],
            moved["step_j"], moved["step_k"], moved["step_real"],
            moved["seg_first"], moved["seg_last"], moved["runs"],
            moved["b_scale"], tile=self.tile, block_n=self.block_n,
            num_levels=self.num_levels, backend=self.backend, gm=self.gm,
            gk=self.gk, gnb=self.gnb, compute_dtype=self.compute_dtype)

    def clone(self) -> "FrozenPlan":
        """A plan with its own copies of the row-grid tables (the step,
        segment and run tables) and the weight-side tables shared."""
        own = {n: getattr(self, n).clone() for n in
               ("step_i", "step_j", "step_k", "step_real", "seg_first",
                "seg_last", "runs")}
        return FrozenPlan(
            self.tau, self.norm_b, self.nbmax, own["step_i"], own["step_j"],
            own["step_k"], own["step_real"], own["seg_first"],
            own["seg_last"], own["runs"], self.b_scale, tile=self.tile,
            block_n=self.block_n, num_levels=self.num_levels,
            backend=self.backend, gm=self.gm, gk=self.gk, gnb=self.gnb,
            compute_dtype=self.compute_dtype)

    def copy_(self, other: "FrozenPlan") -> "FrozenPlan":
        """Write `other`'s tables into this plan's tensors in place (a
        re-cut swapped into a captured step: the graph reads these
        buffers). The two must share a signature."""
        if other.signature() != self.signature():
            raise ValueError(
                f"cannot copy a plan of signature {other.signature()} into "
                f"one of {self.signature()}")
        for n in self._TABLES:
            dst = getattr(self, n)
            if dst is not None and dst is not getattr(other, n):
                dst.copy_(getattr(other, n))
        return self


def freeze_weight(w, tau, *, tile: int = 64, block_n: int = 1,
                  levels: int = 0, backend: str = "auto",
                  use_mxu: bool = False, weight_hash: str = "",
                  compute_dtype: str = "float32",
                  tuned: TunedParams | None = None) -> FrozenWeight:
    """Convenience alias for `FrozenWeight.build` (the reference's
    `freeze_weight`)."""
    return FrozenWeight.build(w, tau, tile=tile, block_n=block_n,
                              levels=levels, backend=backend, use_mxu=use_mxu,
                              weight_hash=weight_hash,
                              compute_dtype=compute_dtype, tuned=tuned)


def stack_plans(fps) -> FrozenPlan:
    """Stack FrozenPlans of one signature (`slice_rows` plans of one local
    grid and bucket, or `for_rows(gm, min_steps=)` with a common bucket)
    into ONE plan whose tables carry a leading dim."""
    fps = list(fps)
    if not fps:
        raise ValueError("stack_plans of nothing")
    sig = fps[0].signature()
    for fp in fps[1:]:
        if fp.signature() != sig:
            raise ValueError(
                "stack_plans needs identical metadata and shapes: "
                f"{fp.signature()} != {sig}")
    st = {n: (None if getattr(fps[0], n) is None
              else torch.stack([getattr(fp, n) for fp in fps]))
          for n in FrozenPlan._TABLES}
    f0 = fps[0]
    return FrozenPlan(
        f0.tau, st["norm_b"], st["nbmax"], st["step_i"], st["step_j"],
        st["step_k"], st["step_real"], st["seg_first"], st["seg_last"],
        st["runs"], st["b_scale"], tile=f0.tile, block_n=f0.block_n,
        num_levels=f0.num_levels, backend=f0.backend, gm=f0.gm, gk=f0.gk,
        gnb=f0.gnb, compute_dtype=f0.compute_dtype)
