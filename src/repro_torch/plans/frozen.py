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
layer loop is a Python loop, so the reference's `stack_plans` (stacking for
`lax.scan`) has no counterpart. `slice_rows`/`shard_by_offsets` wait for the
multi-GPU slice (ROADMAP queue A).
"""
from __future__ import annotations

from typing import Tuple

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

    def for_rows(self, gm: int) -> "FrozenPlan":
        """Specialize to an activation row grid of `gm` tiles: step tables
        pair-major ((i, j) runs contiguous, k ascending within a run),
        padded to a power-of-two bucket of at least `bucket_floor`; padding
        repeats the last real triple with `real` clear. Cached per gm."""
        hit = self._rows_cache.get(gm)
        if hit is not None:
            return hit
        gk, gnb = self.grid
        w = self.num_kj
        s_real = gm * w
        s = bucket(s_real, self.bucket_floor)
        kj_k = np.asarray(self.kj_k, np.int32)
        kj_j = np.asarray(self.kj_j, np.int32)
        if s_real:
            step_i = np.repeat(np.arange(gm, dtype=np.int32), w)
            step_j = np.tile(kj_j, gm)
            step_k = np.tile(kj_k, gm)
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
        # serialise up to half the bucket in one thread block
        runs = np.append(starts[starts < s_real], s_real).astype(np.int32)
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
        self._rows_cache[gm] = fp
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
