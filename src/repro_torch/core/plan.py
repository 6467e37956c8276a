"""Plan/execute split for the SpAMM pipeline (twin of `repro.core.plan`).

The gating phase — get-norm (§3.2) → τ-gate → `map_offset` compaction
(§3.3) — depends only on the operands' normmaps and τ; the multiplication
phase consumes its step tables. This module is the port's one
implementation of the gating phase:

  plan(a, b, tau | valid_ratio=…)  → SpammPlan  concrete gate, host planner;
                                     levels=L gates coarse-to-fine over the
                                     norm pyramid (same tables as flat)
  plan(a, frozen_weight=…)         → SpammPlan  frozen weight side (serving)
  execute(plan, a, b)              → C          the work-list GEMM kernel
  NormPyramid                      — coarse-to-fine normmap stack, pooled
                                     through the backend's kernel
  hier_gate_mask                   — coarse-to-fine bitmap (≡ gate_mask)
  compact_from_triples             — work-list + step tables from triples
  kidx_from_work                   — dense kidx from a work-list
  WeightPlanCache                  — weight-side artifacts per weight, and
                                     the memory tier of frozen artifacts
                                     above a PlanStore
  spamm_bmm(x, w, tau)             — batched SpAMM: a shared weight folds the
                                     batch into rows (work-list kernel);
                                     per-slice weights run the batched mask
                                     through the dense-grid kernel

The host planners stay numpy, so their tables match the reference's array
for array. The frozen path does its per-call work on the device (no host
sync per GEMM): the activation get-norm, an O(S) gather-compare over the
frozen step tables, the flag arithmetic and the nvalid scatter-add.

The port has no tracing, so the reference's traced branches have no
counterpart here: `hier_gate_mask`'s dense traced refinement and `plan()`'s
traced-operand path (dense bitmap → `spamm_compact_ref` kidx) do not exist;
every plan is concrete and carries its work-list. Low-precision plans
(`compute_dtype` "bfloat16" | "int8") gate on the norms of the quantized
operands at the widened τ and execute on bf16 operands or int8 codes (the
int8 work-list kernel), as the reference does.
"""
from __future__ import annotations

import collections
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import cost as kcost
from repro_torch.kernels import ops as kops
from repro_torch.kernels import quantize as kquant
from repro_torch.kernels import ref as kref
from repro_torch.kernels import spamm_mm as kmm


def kernel_operand(x):
    """x as the backends' kernels take it: contiguous and starting on a
    16-byte boundary. A strided view (a transposed weight) or an offset one
    gets a fresh contiguous copy; anything else, None included, is returned
    as it is. The library entry points own this copy; the kernel wrappers
    raise on what they cannot read."""
    if (not isinstance(x, torch.Tensor)
            or (x.is_contiguous() and x.data_ptr() % 16 == 0)):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _fraction(count: torch.Tensor, total: int) -> torch.Tensor:
    """count / total in f32, rounded as the reference's division: a CUDA
    tensor divided by a Python number is multiplied by its reciprocal,
    which can land an ulp off (42240 · fl(1/42240) < 1), so the divisor is
    a device fill (no host copy inside a captured step)."""
    return count.float() / torch.full((), float(total), device=count.device)


def pad_to_tile(x: torch.Tensor, tile: int, tile_n: Optional[int] = None
                ) -> torch.Tensor:
    """Zero-pad the trailing two dims of x up to multiples of `tile`
    (`tile_n` for the last dim: a block_n > 1 weight pads N to
    tile·block_n)."""
    m, n = x.shape[-2:]
    pm, pn = (-m) % tile, (-n) % (tile_n or tile)
    if pm == 0 and pn == 0:
        return x
    return F.pad(x, (0, pn, 0, pm))


# Relative slack applied to τ at coarse levels only: coarse norms are f32
# (sqrt of pooled sums of squares), so a coarse product can round a hair
# below a fine product it dominates. The slack only widens the candidate
# set; the level-0 test, which is exactly the flat gate, decides the final
# triples, so the pooling's rounding never changes them (hierarchical ≡
# flat). 1e-5 covers the f32 rounding of several levels many times over.
_COARSE_SLACK = 1e-5


class NormPyramid:
    """Coarse-to-fine stack of normmaps for one operand side.

    levels[0] is the plain normmap at `tile`; levels[l] ceil-halves each
    grid dim of levels[l-1] by sqrt-sumsq pooling, so levels[l][I, J] is the
    exact Frobenius norm of the (tile·2^l)² block (zero-padded at ragged
    edges) and upper-bounds every descendant tile norm. Leading batch dims
    (per-expert weights) ride along. Pooling goes through the backend's
    `pool_norms`: the kernel for CUDA tensors under "auto"/"cuda"."""

    def __init__(self, levels, *, tile: int):
        self.levels = tuple(levels)
        self.tile = tile

    @property
    def base(self) -> torch.Tensor:
        """The finest normmap — what flat gating and SpammPlan.norm_* hold."""
        return self.levels[0]

    @property
    def coarse(self) -> torch.Tensor:
        return self.levels[-1]

    @property
    def num_levels(self) -> int:
        """Number of coarsening steps (0 ⇒ just the flat normmap)."""
        return len(self.levels) - 1

    @property
    def coarse_tile(self) -> int:
        return self.tile * (2 ** self.num_levels)

    def extended(self, levels: int, *, backend: str = "auto"
                 ) -> "NormPyramid":
        """This pyramid deepened to `levels` coarsening steps (itself if
        already that deep), pooling on from the current coarsest level."""
        if self.num_levels >= levels:
            return self
        pool = kops.get_backend(backend).pool_norms
        lv = list(self.levels)
        for _ in range(levels - self.num_levels):
            lv.append(pool(lv[-1]))
        return NormPyramid(lv, tile=self.tile)

    @classmethod
    def from_normmap(cls, normmap: torch.Tensor, levels: int, *,
                     tile: int = 64, backend: str = "auto") -> "NormPyramid":
        """Pyramid from an existing finest normmap (each coarser level one
        pooling reduction)."""
        return cls([normmap], tile=tile).extended(levels, backend=backend)

    @classmethod
    def build(cls, x: torch.Tensor, levels: int, *, tile: int = 64,
              backend: str = "auto", use_mxu: bool = False) -> "NormPyramid":
        """Pyramid from the matrix: one get-norm pass plus the poolings."""
        return cls(kops.pyramid_norms(x, tile, levels, backend=backend,
                                      use_mxu=use_mxu), tile=tile)


STEP_INIT = kmm.STEP_INIT
STEP_ACC = kmm.STEP_ACC
STEP_FLUSH = kmm.STEP_FLUSH


class SpammWork(NamedTuple):
    """Flattened per-(i, j) work-list of one plan (§3.3 map_offset).

    Pair view (eager plans; None on frozen plans):
      rows / cols (P,) int32, offsets (P+1,) int32, klist (V,) int32
    Step view (what drives the work-list kernel):
      step_i/step_j/step_k (S,) int32, step_flags (S,) int32 — S = V padded
      to a bucket; padding repeats the last real triple with no flag bits
    runs (R+1,) int32 — boundaries of the runs of consecutive steps that
      share one output block: one GPU thread block per run. The pair
      offsets on eager plans, the segment starts on frozen plans.
    """
    rows: Optional[torch.Tensor]
    cols: Optional[torch.Tensor]
    offsets: Optional[torch.Tensor]
    klist: Optional[torch.Tensor]
    step_i: torch.Tensor
    step_j: torch.Tensor
    step_k: torch.Tensor
    step_flags: torch.Tensor
    runs: Optional[torch.Tensor] = None


def compact_from_triples(ii, jj, kk, *, gm: int, gn: int, gk: int,
                         block_n: int = 1, steps: bool = True,
                         assume_sorted: bool = False, bucket_min: int = 16):
    """Work-list straight from surviving (i, j, k) triples, without a dense
    (gm, gn, gk) bitmap: one fused-key sort (skipped when `assume_sorted`),
    super-column folding, then linear passes. Host numpy, array for array
    the reference's `compact_from_triples`; `bucket_min` floors the step
    tables' power-of-two bucket.

    Returns (work: SpammWork of numpy arrays, nvalid (gm, gn//block_n)
    int32); `work.runs` is the pair offsets."""
    assert gn % block_n == 0, (gn, block_n)
    gnb = gn // block_n
    ii = np.asarray(ii, np.int64).ravel()
    kk = np.asarray(kk, np.int64).ravel()
    jb = np.asarray(jj, np.int64).ravel()
    if block_n > 1:
        jb = jb // block_n
    key = (ii * gnb + jb) * gk + kk
    if not assume_sorted:
        key = np.sort(key)
    if block_n > 1 and key.size:
        keep = np.ones(key.size, bool)
        keep[1:] = key[1:] != key[:-1]
        key = key[keep]
    kk = (key % gk).astype(np.int32)
    pair = key // gk
    jb = (pair % gnb).astype(np.int32)
    ii = (pair // gnb).astype(np.int32)
    v = ii.size
    nvalid = np.zeros((gm, gnb), np.int32)
    step_i = step_j = step_k = step_flags = None
    if steps:
        s = kcost.bucket(v, bucket_min)
        step_i = np.zeros(s, np.int32)
        step_j = np.zeros(s, np.int32)
        step_k = np.zeros(s, np.int32)
        step_flags = np.zeros(s, np.int32)
    if v:
        newpair = np.ones(v, bool)
        newpair[1:] = pair[1:] != pair[:-1]
        starts = np.flatnonzero(newpair).astype(np.int32)
        rows, cols = ii[starts], jb[starts]
        offsets = np.append(starts, np.int32(v)).astype(np.int32)
        nvalid[rows, cols] = np.diff(offsets)
        if steps:
            step_i[:v], step_j[:v], step_k[:v] = ii, jb, kk
            step_i[v:], step_j[v:], step_k[v:] = ii[-1], jb[-1], kk[-1]
            flags = np.full(v, STEP_ACC, np.int32)
            flags[starts] |= STEP_INIT
            flags[np.append(starts[1:], v) - 1] |= STEP_FLUSH
            step_flags[:v] = flags
    else:
        rows = cols = np.zeros(0, np.int32)
        offsets = np.zeros(1, np.int32)
        if steps:
            # the reference's empty-plan encoding (step 0 writes explicit
            # zeros to block (0, 0)); no run covers it here, and the
            # zero-initialised output gives the same zeros
            step_flags[0] = STEP_INIT | STEP_FLUSH
    work = SpammWork(rows=rows, cols=cols, offsets=offsets, klist=kk,
                     step_i=step_i, step_j=step_j, step_k=step_k,
                     step_flags=step_flags, runs=offsets)
    return work, nvalid


def _host(x) -> np.ndarray:
    """A tensor (any device) or array as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def kidx_from_work(work: SpammWork, gm: int, gnb: int, gk: int) -> np.ndarray:
    """Dense (gm, gnb, gk) kidx table from a work-list's pair view — the
    layout of `spamm_compact_ref` (ascending valid k's first, padding slots
    repeating the last valid k, all-invalid pairs reading 0), built by O(V)
    scatters instead of a sort over the grid."""
    rows, cols = _host(work.rows), _host(work.cols)
    offsets, klist = _host(work.offsets), _host(work.klist)
    lastk = np.zeros((gm, gnb), np.int32)
    if klist.size:
        lastk[rows, cols] = klist[offsets[1:] - 1]
    kidx = np.broadcast_to(lastk[:, :, None], (gm, gnb, gk)).copy()
    if klist.size:
        counts = np.diff(offsets)
        t = np.arange(klist.size, dtype=np.int32) - np.repeat(
            offsets[:-1], counts)
        kidx[np.repeat(rows, counts), np.repeat(cols, counts), t] = klist
    return kidx


class SpammInfo(NamedTuple):
    tau: float                      # threshold actually used (f32 value)
    valid_fraction: torch.Tensor    # executed-tile fraction (paper's ratio)
    effective_flops: torch.Tensor   # 2·M·K·N · valid_fraction


class SpammPlan:
    """Gating phase of one SpAMM product.

    Tensor fields: norm_a (gm, gk), norm_b (gk, gn), nvalid (gm, gnb) int32,
    valid_tiles (0-d int32), work (SpammWork, device tables), mask (lazy
    (gm, gnb, gk) bool view scattered from the step tables on first read;
    the executor never reads it).
    a_scale (gm, gk) / b_scale (gk, gn) f32 per-tile int8 scales, or None:
    the scales the fused get-norm made on an int8 plan (b_scale per FINE
    tile); `execute` quantizes with them, or recomputes missing ones (the
    quantizer is a pure function of the operand, so either is bit-identical).
    tau is the f32 gate threshold as a Python float (already widened on a
    low-precision plan). Metadata: tile, block_n, backend, levels (pyramid
    coarsening steps the gate descended; 0 = flat — the tables are the same
    either way), compute_dtype ("float32" | "bfloat16" | "int8": what
    `execute` feeds the kernel; the normmaps describe that operand view)."""

    def __init__(self, tau, norm_a, norm_b, nvalid, valid_tiles, work,
                 a_scale=None, b_scale=None, *, tile: int, block_n: int,
                 backend: str, levels: int = 0,
                 compute_dtype: str = "float32"):
        self.tau = tau
        self.norm_a = norm_a
        self.norm_b = norm_b
        self._mask = None
        self.nvalid = nvalid
        self.valid_tiles = valid_tiles
        self.work = work
        self.a_scale = a_scale
        self.b_scale = b_scale
        self.tile = tile
        self.block_n = block_n
        self.backend = backend
        self.levels = levels
        self.compute_dtype = compute_dtype

    @property
    def grid(self):
        gm, gk = self.norm_a.shape
        gn = self.norm_b.shape[-1]
        return gm, gn // self.block_n, gk

    @property
    def mask(self) -> torch.Tensor:
        if self._mask is None:
            gm, gnb, gk = self.grid
            w = self.work
            real = ((w.step_flags & STEP_ACC) != 0).to(torch.int32)
            flat = ((w.step_i.long() * gnb + w.step_j.long()) * gk
                    + w.step_k.long())
            hits = torch.zeros(gm * gnb * gk, dtype=torch.int32,
                               device=real.device)
            hits.index_put_((flat,), real, accumulate=True)
            self._mask = (hits > 0).reshape(gm, gnb, gk)
        return self._mask

    @property
    def total_tiles(self) -> int:
        gm, gnb, gk = self.grid
        return gm * gnb * gk

    @property
    def valid_fraction(self) -> torch.Tensor:
        return _fraction(self.valid_tiles, self.total_tiles)

    def bytes_moved(self) -> torch.Tensor:
        """GEMM bytes the executed work-list moves at this plan's compute
        dtype (`core.cost.gemm_bytes`): A and B blocks per real step, one f32
        output flush per active output pair; a 0-d f32 tensor on the plan's
        device (no host sync)."""
        pairs = (self.nvalid > 0).sum(dtype=torch.int32)
        return kcost.gemm_bytes(self.valid_tiles.float(), pairs.float(),
                                self.tile, self.block_n, self.compute_dtype)

    def info(self) -> dict:
        """The info dict `kernels.ops.spamm_matmul` returns: the normmaps,
        nvalid (the paper's validNum), valid/total tiles and the fraction."""
        return {
            "norm_a": self.norm_a,
            "norm_b": self.norm_b,
            "nvalid": self.nvalid,
            "valid_tiles": self.valid_tiles,
            "total_tiles": self.total_tiles,
            "valid_fraction": self.valid_fraction,
        }


def gate_mask(norm_a: torch.Tensor, norm_b: torch.Tensor, tau,
              block_n: int = 1) -> torch.Tensor:
    """Validity bitmap from normmaps (paper Alg. 2 lines 3–8); block_n > 1
    groups columns into super-columns valid if ANY member is. Leading batch
    dims broadcast (the reference maps it over a batch). Returns (...,
    gm, gn//block_n, gk) bool."""
    if block_n > 1:
        gk, gn = norm_b.shape[-2:]
        assert gn % block_n == 0, (gn, block_n)
        nb_g = norm_b.reshape(*norm_b.shape[:-2], gk, gn // block_n, block_n)
        fine = (norm_a[..., :, None, :, None]
                * nb_g.transpose(-3, -2)[..., None, :, :, :] >= tau)
        return fine.any(dim=-1)
    return kref.spamm_mask_ref(norm_a, norm_b, tau)


# children of one coarse (i, j, k) triple: the 2×2×2 refinement offsets, as
# three separate contiguous columns
_OFF_I = np.array([i for i in (0, 1) for _ in (0, 1) for _ in (0, 1)], np.int32)
_OFF_J = np.array([j for _ in (0, 1) for j in (0, 1) for _ in (0, 1)], np.int32)
_OFF_K = np.array([k for _ in (0, 1) for _ in (0, 1) for k in (0, 1)], np.int32)


def _hier_descend_host(la, lb, tau: float):
    """Sparse coarse-to-fine descent on numpy normmaps (per level, finest
    first): gates the whole coarsest level, then expands only the surviving
    triples into their 2×2×2 children, level by level. Returns the surviving
    fine (ii, jj, kk) triples — exactly the support of `gate_mask`, since the
    level-0 test is the flat gate — in the compacted form
    `compact_from_triples` consumes (not sorted)."""
    top = len(la) - 1
    tau_c = tau - _COARSE_SLACK * abs(tau)
    na, nb = la[top], lb[top]
    cand = na[:, None, :] * np.swapaxes(nb, 0, 1)[None] >= (tau_c if top else tau)
    ii, jj, kk = [x.astype(np.int32) for x in np.nonzero(cand)]
    for l in range(top - 1, -1, -1):
        gm_l, gk_l = la[l].shape
        gn_l = lb[l].shape[1]
        if ii.shape[0] == 0:
            break
        i2 = (ii[:, None] * 2 + _OFF_I[None]).ravel()
        j2 = (jj[:, None] * 2 + _OFF_J[None]).ravel()
        k2 = (kk[:, None] * 2 + _OFF_K[None]).ravel()
        # ceil-pooled coarse grids overhang ragged fine edges — drop phantoms
        keep = (i2 < gm_l) & (j2 < gn_l) & (k2 < gk_l)
        if not keep.all():
            i2, j2, k2 = i2[keep], j2[keep], k2[keep]
        vals = la[l][i2, k2] * lb[l][k2, j2]
        s = vals >= (tau if l == 0 else tau_c)
        ii, jj, kk = i2[s], j2[s], k2[s]
    return ii, jj, kk


def _hier_mask_host(la, lb, tau: float) -> np.ndarray:
    """Dense bitmap view of `_hier_descend_host`."""
    ii, jj, kk = _hier_descend_host(la, lb, tau)
    gm, gk = la[0].shape
    gn = lb[0].shape[1]
    mask = np.zeros(gm * gn * gk, bool)
    if ii.shape[0]:
        mask[(ii.astype(np.int64) * gn + jj) * gk + kk] = True
    return mask.reshape(gm, gn, gk)


def _f32(tau) -> float:
    """τ rounded to float32, as a Python float (the gate compares in f32)."""
    return float(np.float32(float(tau)))


def hier_gate_mask(pyr_a: NormPyramid, pyr_b: NormPyramid, tau,
                   block_n: int = 1) -> np.ndarray:
    """Coarse-to-fine validity bitmap (host numpy), bit-identical to
    `gate_mask` on the finest normmaps: a failing coarse product
    upper-bounds, hence rules out, every fine product inside it. Descends
    to the shallower pyramid's depth."""
    levels = min(pyr_a.num_levels, pyr_b.num_levels)
    mask = _hier_mask_host([_host(x) for x in pyr_a.levels[:levels + 1]],
                           [_host(x) for x in pyr_b.levels[:levels + 1]],
                           _f32(tau))
    if block_n > 1:
        gm, gn, gk = mask.shape
        assert gn % block_n == 0, (gn, block_n)
        mask = mask.reshape(gm, gn // block_n, block_n, gk).any(2)
    return mask


def _flat_triples_host(na: np.ndarray, nb: np.ndarray, tau: float,
                       block_n: int, *, keep_mask: bool):
    """Concrete flat gate on host in row chunks (the f32 products of
    `gate_mask`, never held whole). Returns ((ii, jb, kk) super-column
    triples in row-major order, bitmap or None)."""
    gm, gk = na.shape
    gn = nb.shape[1]
    assert gn % block_n == 0, (gn, block_n)
    gnb = gn // block_n
    nbt = np.ascontiguousarray(nb.T)
    mask = np.zeros((gm, gnb, gk), bool) if keep_mask else None
    step = max(1, (1 << 24) // max(gn * gk, 1))
    parts_i, parts_j, parts_k = [], [], []
    for i0 in range(0, gm, step):
        blk = na[i0:i0 + step, None, :] * nbt[None] >= tau
        if block_n > 1:
            blk = blk.reshape(blk.shape[0], gnb, block_n, gk).any(2)
        if keep_mask:
            mask[i0:i0 + step] = blk
        bi, bj, bk_ = np.nonzero(blk)
        parts_i.append(bi.astype(np.int64) + i0)
        parts_j.append(bj)
        parts_k.append(bk_)
    return (np.concatenate(parts_i), np.concatenate(parts_j),
            np.concatenate(parts_k)), mask


def _frozen_step_flags(fp, active: torch.Tensor) -> torch.Tensor:
    """INIT/ACC/FLUSH flags over a FrozenPlan's static step tables.

    `active` is the per-step activation gate (already AND step_real). INIT
    fires on a segment's first active step, FLUSH on its last; a segment
    with no active step gets one INIT|FLUSH (no ACC) at its final step, so
    its output block is written with explicit zeros. Cumulative sums run in
    int32 (torch's default int64 is cast away) so the flags compare equal
    to the reference's."""
    act = active.to(torch.int32)
    cum = torch.cumsum(act, 0, dtype=torch.int32)
    excl = cum - act
    first_excl = excl[fp.seg_first]
    before = excl - first_excl
    total = cum[fp.seg_last] - first_excl
    init = (active & (before == 0)).to(torch.int32)
    flush = (active & (before + 1 == total)).to(torch.int32)
    idx = torch.arange(act.shape[0], dtype=torch.int32, device=act.device)
    empty_write = ((total == 0) & (idx == fp.seg_last)).to(torch.int32)
    return (init * STEP_INIT + act * STEP_ACC + flush * STEP_FLUSH
            + empty_write * (STEP_INIT | STEP_FLUSH))


def _plan_frozen(a, fp, *, norm_a=None, use_mxu_norm: bool = False
                 ) -> SpammPlan:
    """Plan from a frozen weight side: the activation-side get-norm plus an
    O(S) gather-compare over the frozen step tables, all on the operands'
    device — no weight get-norm, no bitmap, no host sync. A low-precision
    plan gates on the quantized activation's norms (int8: the fused get-norm,
    whose scales the plan keeps for `execute`) at the frozen plan's widened
    τ."""
    from repro_torch.plans.frozen import FrozenPlan, FrozenWeight

    if isinstance(fp, FrozenWeight):
        if a is None:
            raise ValueError("a FrozenWeight needs the activation to pick the "
                             "row grid; pass `a` or use for_rows(gm)")
        fp = fp.for_rows(a.shape[0] // fp.tile)
    if not isinstance(fp, FrozenPlan):
        raise TypeError(f"expected a FrozenPlan, got {type(fp).__name__}")
    bk = kops.get_backend(fp.backend)
    dtype = fp.compute_dtype
    a_scale = None
    if norm_a is None:
        if a is None:
            raise ValueError("need `a` or `norm_a`")
        norm_a, a_scale = dtype_norms(bk, a, dtype, fp.tile, use_mxu_norm)
    gm, gk = norm_a.shape
    if (gm, gk) != (fp.gm, fp.gk):
        raise ValueError(
            f"frozen plan was specialized for a ({fp.gm}, {fp.gk}) activation "
            f"grid, got ({gm}, {gk}) — rebuild with for_rows({gm})")
    # exact flat τ-test per frozen step (the super-column max commutes with
    # the gate: f32 multiplication is monotone in each non-negative factor),
    # restricted to real (non-padding) steps
    pa = norm_a[fp.step_i, fp.step_k]
    pb = fp.nbmax[fp.step_k, fp.step_j]
    active = fp.step_real & (pa * pb >= fp.tau)
    flags = _frozen_step_flags(fp, active)
    work = SpammWork(rows=None, cols=None, offsets=None, klist=None,
                     step_i=fp.step_i, step_j=fp.step_j, step_k=fp.step_k,
                     step_flags=flags, runs=fp.runs)
    # the reference's `.at[i, j].add`: integer adds commute, so index_add_'s
    # atomics give the same counts; index_put_(accumulate=True) takes a
    # sort-based path on CUDA that measured 0.7 ms per GEMM on an H100
    nvalid = torch.zeros(gm * fp.gnb, dtype=torch.int32, device=norm_a.device)
    nvalid.index_add_(0, fp.step_i * fp.gnb + fp.step_j,
                      active.to(torch.int32))
    nvalid = nvalid.view(gm, fp.gnb)
    valid_tiles = active.sum(dtype=torch.int32)
    return SpammPlan(fp.tau, norm_a, fp.norm_b, nvalid, valid_tiles, work,
                     a_scale, fp.b_scale, tile=fp.tile, block_n=fp.block_n,
                     backend=bk.name, levels=fp.num_levels,
                     compute_dtype=dtype)


def dtype_norms(bk, x: torch.Tensor, dtype: str, tile: int,
                use_mxu: bool = False):
    """(normmap, int8 scales or None) of x as a `dtype` kernel will
    multiply it: the fused get-norm at int8 (norms of the per-tile int8
    view, and its scales), the get-norm of the bf16-rounded view at
    bfloat16, the plain get-norm at float32. `dtype` is canonical."""
    if dtype == "int8":
        return bk.norms_quant(x, tile, use_mxu=use_mxu)
    return bk.norms(kquant.quantized_view(x, dtype, tile), tile,
                    use_mxu=use_mxu), None


def _side_pyramid(norm, x, levels: int, tile: int, bk, use_mxu: bool,
                  side: str) -> NormPyramid:
    """Resolve one operand side (matrix / normmap / pyramid) to a pyramid
    with at least `levels` coarsening steps."""
    if isinstance(norm, NormPyramid):
        return norm.extended(levels, backend=bk.name)
    if norm is not None:
        return NormPyramid.from_normmap(norm, levels, tile=tile,
                                        backend=bk.name)
    if x is None:
        raise ValueError(f"need `{side}` or `norm_{side}`")
    return NormPyramid(bk.pyramid_norms(x, tile, levels, use_mxu=use_mxu),
                       tile=tile)


def plan(a: Optional[torch.Tensor] = None, b: Optional[torch.Tensor] = None,
         tau=None, *, valid_ratio=None, norm_a=None, norm_b=None,
         tile: int = 64, block_n: int = 1, backend: str = "auto",
         use_mxu_norm: bool = False, levels: int = 0, frozen_weight=None,
         compute_dtype: str = "float32", bucket_min: int = 16) -> SpammPlan:
    """Gating phase for (M, K) @ (K, N), dims divisible by tile (N by
    tile·block_n). Either side may be the matrix or its precomputed normmap
    or NormPyramid (norm_a= / norm_b=). Exactly one of `tau` / `valid_ratio`
    is given; valid_ratio runs the §3.5.2 τ-search on the normmaps.

    Flat (levels = 0): the normmaps go to the host, the surviving triples of
    the chunked f32 gate feed `compact_from_triples`, and the step tables
    come back to the operands' device. levels > 0 (or a NormPyramid
    operand) gates coarse-to-fine over the norm pyramid (`_hier_descend_host`
    on the host, the pooling on the operands' device); the tables are the
    flat plan's, array for array, and a valid_ratio searches coarse-first
    (`search_tau_pyramid`).

    frozen_weight (a `FrozenPlan`, or a `FrozenWeight` plus `a`) replaces
    the weight side: τ/tile/block_n/backend/compute_dtype come from the
    artifact.

    compute_dtype ("float32" | "bfloat16" | "int8", aliases accepted) plans
    for low-precision execution, as the reference does: the normmaps are
    those of the quantized operands (int8: the fused get-norm, whose scales
    the plan keeps; bf16: the bf16-rounded view), and an explicit τ is
    widened (`kernels.quantize.widen_tau`) so the gate keeps every tile the
    f32 gate at τ keeps. A valid_ratio search runs on the quantized norms
    with no widening (the ratio is the spec). Precomputed norm_a/norm_b
    must already describe the quantized view
    (`WeightPlanCache.weight_side(dtype=…)` makes them so).

    bucket_min floors the work-list step tables' power-of-two bucket
    (`core.cost.bucket`), as the autotuner's `TunedParams.bucket` does.

    Operands of any strides are taken: a non-contiguous or misaligned one
    is copied (`kernel_operand`), with the same plan as its contiguous
    copy."""
    a, b = kernel_operand(a), kernel_operand(b)
    if frozen_weight is not None:
        if tau is not None or valid_ratio is not None:
            raise ValueError("frozen_weight carries its own tau; pass neither "
                             "tau nor valid_ratio")
        return _plan_frozen(a, frozen_weight, norm_a=norm_a,
                            use_mxu_norm=use_mxu_norm)
    if (tau is None) == (valid_ratio is None):
        raise ValueError("give exactly one of tau / valid_ratio")
    bk = kops.get_backend(backend)
    compute_dtype = kquant.canonical_dtype(compute_dtype)
    a_scale = b_scale = None
    if compute_dtype == "int8":
        # the fused get-norm: quantized-view norms and the per-tile scales
        # from one read; the matrix's only further use is execute's
        if a is not None and norm_a is None:
            norm_a, a_scale = bk.norms_quant(a, tile, use_mxu=use_mxu_norm)
            a = None
        if b is not None and norm_b is None:
            norm_b, b_scale = bk.norms_quant(b, tile, use_mxu=use_mxu_norm)
            b = None
    elif compute_dtype == "bfloat16":
        if a is not None:
            a = kquant.quantized_view(a, compute_dtype, tile)
        if b is not None:
            b = kquant.quantized_view(b, compute_dtype, tile)
    if tau is not None:
        tau = kquant.widen_tau(tau, compute_dtype, tile)
    dev = next((x.base.device if isinstance(x, NormPyramid) else x.device
                for x in (a, b, norm_a, norm_b)
                if isinstance(x, (torch.Tensor, NormPyramid))),
               torch.device("cpu"))
    hier = (levels > 0 or isinstance(norm_a, NormPyramid)
            or isinstance(norm_b, NormPyramid))
    want = 0
    if hier:
        want = max([levels] + [x.num_levels for x in (norm_a, norm_b)
                               if isinstance(x, NormPyramid)])
        pyr_a = _side_pyramid(norm_a, a, want, tile, bk, use_mxu_norm, "a")
        pyr_b = _side_pyramid(norm_b, b, want, tile, bk, use_mxu_norm, "b")
        norm_a, norm_b = pyr_a.base, pyr_b.base
        if valid_ratio is not None:
            from repro_torch.core.tau_search import search_tau_pyramid

            tau, _ = search_tau_pyramid(pyr_a, pyr_b, valid_ratio)
        tau_f = _f32(tau)
        lv = min(pyr_a.num_levels, pyr_b.num_levels)
        triples = _hier_descend_host(
            [_host(x) for x in pyr_a.levels[:lv + 1]],
            [_host(x) for x in pyr_b.levels[:lv + 1]], tau_f)
    else:
        if norm_a is None:
            if a is None:
                raise ValueError("need `a` or `norm_a`")
            norm_a = bk.norms(a, tile, use_mxu=use_mxu_norm)
        if norm_b is None:
            if b is None:
                raise ValueError("need `b` or `norm_b`")
            norm_b = bk.norms(b, tile, use_mxu=use_mxu_norm)
        if valid_ratio is not None:
            from repro_torch.core.tau_search import search_tau

            tau, _ = search_tau(norm_a, norm_b, valid_ratio)
        tau_f = _f32(tau)
        triples, _ = _flat_triples_host(
            _host(norm_a).astype(np.float32, copy=False),
            _host(norm_b).astype(np.float32, copy=False),
            tau_f, block_n, keep_mask=False)
    gm, gk = norm_a.shape
    gn = norm_b.shape[-1]
    if hier:
        work_np, nvalid_np = compact_from_triples(
            *triples, gm=gm, gn=gn, gk=gk, block_n=block_n,
            bucket_min=bucket_min)
    else:
        # the chunked scan emits triples in row-major order, grouped
        work_np, nvalid_np = compact_from_triples(
            *triples, gm=gm, gn=gn // block_n, gk=gk, block_n=1,
            assume_sorted=True, bucket_min=bucket_min)
    work = SpammWork(*(torch.as_tensor(x, device=dev) for x in work_np))
    return SpammPlan(tau_f, norm_a, norm_b,
                     torch.as_tensor(nvalid_np, device=dev),
                     torch.tensor(int(work_np.klist.size), dtype=torch.int32,
                                  device=dev),
                     work, a_scale, b_scale, tile=tile, block_n=block_n,
                     backend=bk.name, levels=want,
                     compute_dtype=compute_dtype)


def execute(p: SpammPlan, a: torch.Tensor, b: torch.Tensor, *,
            out_dtype=None, rows: Optional[int] = None) -> torch.Tensor:
    """Multiplication phase of a prebuilt plan on (a, b), which must have
    the tile-padded shapes the plan was built for: the backend's work-list
    GEMM over the plan's step tables.

    Callers pass the ORIGINAL f32 operands whatever the plan's dtype:
    execute owns the cast. bfloat16 casts both operands for the work-list
    kernel (f32 accumulation); int8 quantizes both per tile with the
    plan's scales (recomputing missing ones, bit-identically) and drives
    the int8 work-list kernel. Operands of any strides are taken: a
    non-contiguous or misaligned one is copied first (`kernel_operand`).
    `rows`: None (every row of a), or the rows of a that hold data, the
    others zero (a tile-padded activation's real rows): the backend's
    work-list GEMM receives it, and an f32 call at a few rows runs the
    decode kernel; output rows from `rows` on are zero."""
    gm, gk = p.norm_a.shape
    gn = p.norm_b.shape[1]
    t = p.tile
    if tuple(a.shape) != (gm * t, gk * t) or tuple(b.shape) != (gk * t, gn * t):
        raise ValueError(f"operands {tuple(a.shape)} @ {tuple(b.shape)} do not "
                         f"match the plan's grid ({gm}, {gk}, {gn}) at tile {t}")
    bk = kops.get_backend(p.backend)
    out_dtype = out_dtype or torch.float32
    # contiguous operands give contiguous codes and casts too
    a, b = kernel_operand(a), kernel_operand(b)
    if p.compute_dtype == "int8":
        a_q, a_s = kquant.quantize_tiles(a, t, scales=p.a_scale)
        b_q, b_s = kquant.quantize_tiles(b, t, scales=p.b_scale)
        return bk.matmul_worklist_int8(a_q, b_q, a_s, b_s, p.work, t,
                                       p.block_n, out_dtype, rows=rows)
    if p.compute_dtype == "bfloat16":
        a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    return bk.matmul_worklist(a, b, p.work, t, p.block_n, out_dtype,
                              rows=rows)


class _WeightEntry(NamedTuple):
    weight: Any          # strong ref: anchors the id() key (no stale reuse)
    padded: torch.Tensor
    norms: Any           # normmap (levels=0) or NormPyramid (levels>0)


class WeightPlanCache:
    """Caches the weight-side gating artifacts (tile padding + normmap or
    norm pyramid), keyed on weight identity, version, shape, dtype, device,
    tile, backend, levels, block_n and the compute dtype.

    Eager forward passes call one weight against a stream of activations:
    the weight normmap (the O(K·N) half of get-norm) and the padded copy do
    not depend on the batch, so they are computed once per weight. The
    tensor's in-place version counter is part of the key (torch tensors are
    mutable, jax arrays are not), so an updated weight misses instead of
    serving stale norms. A weight that requires grad is never cached (the
    reference never caches a traced weight): a trainable parameter changes
    in place every optimizer step, so each step would add an entry and
    none would hit. LRU-bounded; `hits`/`misses` count lookups.

    Frozen tier: `frozen_weight` memoizes `plans.frozen.FrozenWeight`
    artifacts by content fingerprint, falling through to the attached
    `PlanStore` (`self.store`) and only then to a fresh build, so a warm
    store makes an engine's start a pure load (no get-norm pass);
    `frozen_hits`/`frozen_misses` count its lookups."""

    def __init__(self, maxsize: int = 256, store=None):
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self.maxsize = maxsize
        self.hits = 0
        self.misses = 0
        self.store = store           # optional plans.store.PlanStore
        self._frozen: dict = {}
        self.frozen_hits = 0
        self.frozen_misses = 0

    def weight_side(self, w: torch.Tensor, *, tile: int, backend: str,
                    use_mxu: bool = False, levels: int = 0,
                    block_n: int = 1, dtype: str = "float32"):
        """(padded_weight, weight_norms) for w, cached on identity.

        w may be 2-D (K, N) → normmap (gk, gn), or 3-D batched (B, K, N) —
        the per-expert MoE shape — → normmap (B, gk, gn) from one reshaped
        get-norm pass (row tiles never cross slices after padding). levels
        > 0 returns a NormPyramid (its levels keep the batch dim). N pads to
        tile·block_n so the super-column grouping divides the column grid.
        dtype (a compute dtype) takes the norms of the QUANTIZED weight view
        (int8: the fused get-norm, its scales dropped — execute recomputes
        them bit-identically); the padded weight stays f32."""
        bk = kops.get_backend(backend)
        dtype = kquant.canonical_dtype(dtype)

        def compute():
            wp = pad_to_tile(w, tile, tile * block_n).contiguous()
            w2 = (wp.reshape(wp.shape[0] * wp.shape[1], wp.shape[2])
                  if wp.dim() == 3 else wp)
            nw, _ = dtype_norms(bk, w2, dtype, tile, use_mxu)
            if wp.dim() == 3:
                nw = nw.reshape(wp.shape[0], wp.shape[1] // tile, -1)
            if levels > 0:
                nw = NormPyramid.from_normmap(nw, levels, tile=tile,
                                              backend=bk.name)
            return wp, nw

        if w.requires_grad:
            with torch.no_grad():
                return compute()
        if w.is_inference():
            # no version counter to key on: a weight made under inference
            # mode (one gathered whole for a step) is planned each time
            return compute()
        key = (id(w), w._version, tuple(w.shape), str(w.dtype),
               str(w.device), tile, bk.name, use_mxu, levels, block_n, dtype)
        ent = self._entries.get(key)
        if ent is not None and ent.weight is w:
            self.hits += 1
            self._entries.move_to_end(key)
            return ent.padded, ent.norms
        self.misses += 1
        wp, nw = compute()
        self._entries[key] = _WeightEntry(w, wp, nw)
        if len(self._entries) > self.maxsize:
            self._entries.popitem(last=False)
        return wp, nw

    def plan_for(self, x_padded, w, tau=None, *, valid_ratio=None,
                 tile: int = 64, block_n: int = 1, backend: str = "auto",
                 use_mxu_norm: bool = False, levels: int = 0,
                 compute_dtype: str = "float32"):
        """Full plan for x @ w with the weight side served from the cache
        (levels > 0: the cached weight pyramid). x_padded must already be
        tile-padded. Returns (plan, padded_weight). compute_dtype plans for
        low-precision execution: the cached weight norms are the quantized
        view's, and plan() handles the activation and the τ widening."""
        compute_dtype = kquant.canonical_dtype(compute_dtype)
        wp, nw = self.weight_side(w, tile=tile, backend=backend,
                                  use_mxu=use_mxu_norm, levels=levels,
                                  block_n=block_n, dtype=compute_dtype)
        p = plan(x_padded, None, tau, valid_ratio=valid_ratio, norm_b=nw,
                 tile=tile, block_n=block_n, backend=backend,
                 use_mxu_norm=use_mxu_norm, levels=levels,
                 compute_dtype=compute_dtype)
        return p, wp

    def frozen_weight(self, w: torch.Tensor, *, tau, tile: int = 64,
                      block_n: int = 1, levels: int = 0,
                      backend: str = "auto", use_mxu: bool = False,
                      store=None, dtype: str = "float32", tuned=None,
                      weight_hash: Optional[str] = None):
        """FrozenWeight for `w` at the given gating config, through the
        memory → store → build tiers. Keyed on the weight's CONTENT
        fingerprint (pass `weight_hash` when the caller has already hashed
        it), the config with the backend resolved by the weight's device,
        and the device the artifact lies on. `tuned` rides a built artifact
        as provenance and bucket floor (re-attached to a store hit without
        one); it is no key field."""
        from repro_torch.plans import frozen as _frozen  # imports this module
        from repro_torch.plans import store as _pstore

        store = store if store is not None else self.store
        h = weight_hash or _pstore.fingerprint(w)
        resolved = kops.resolve_backend(backend, w.device)
        dtype = kquant.canonical_dtype(dtype)
        key = (h, _f32(tau), tile, block_n, levels, resolved, use_mxu, dtype,
               str(w.device))
        hit = self._frozen.get(key)
        if hit is not None:
            self.frozen_hits += 1
            return hit
        self.frozen_misses += 1
        fw = None
        if store is not None:
            fw = store.get(h, tau=tau, tile=tile, block_n=block_n,
                           levels=levels, backend=resolved, use_mxu=use_mxu,
                           dtype=dtype, device=w.device)
            if fw is not None and fw.tuned is None and tuned is not None:
                fw.tuned = tuned
        if fw is None:
            fw = _frozen.FrozenWeight.build(
                w, tau, tile=tile, block_n=block_n, levels=levels,
                backend=resolved, use_mxu=use_mxu, weight_hash=h,
                compute_dtype=dtype, tuned=tuned)
            if store is not None:
                store.put(fw)
        self._frozen[key] = fw
        return fw

    def clear(self):
        self._entries.clear()
        self.hits = self.misses = 0
        self._frozen.clear()
        self.frozen_hits = self.frozen_misses = 0

    def __len__(self):
        return len(self._entries)


def spamm_bmm(x: torch.Tensor, w: torch.Tensor, tau=None, *,
              valid_ratio=None, tile: int = 64, block_n: int = 1,
              backend: str = "auto", use_mxu_norm: bool = False,
              out_dtype=None, cache: Optional[WeightPlanCache] = None,
              levels: int = 0):
    """Batched SpAMM: (B, M, K) @ (K, N) or (B, M, K) @ (B, K, N).

    Shared weight: the batch folds into the row-tile grid — ONE (B·M, K) @
    (K, N) plan (hierarchical with levels > 0) whose row tiles never cross
    slices, so the gating is exactly the per-slice gating, executed by the
    work-list kernel; the weight side (optionally from `cache`) is computed
    once for the batch.

    Per-slice weights: normmaps for every slice from one reshaped get-norm
    call per side, the batched flat gate, its batched compaction
    (`spamm_compact_ref`) and ONE dense-grid kernel launch over all slices.
    `levels` does not apply there (as in the reference) and valid_ratio
    needs a shared weight.

    Arbitrary shapes are zero-padded to tile multiples and un-padded.
    Returns (C (B, M, N), SpammInfo)."""
    if (tau is None) == (valid_ratio is None):
        raise ValueError("give exactly one of tau / valid_ratio")
    bsz, m, k = x.shape
    bk = kops.get_backend(backend)
    out_dtype = out_dtype or torch.float32
    xp = pad_to_tile(x, tile).contiguous()
    mp, kp = xp.shape[1:]
    if w.dim() == 2:  # (B, M, K) @ (K, N): fold batch into the row-tile grid
        k2, n = w.shape
        assert k == k2, (x.shape, w.shape)
        if cache is not None:
            wp, nw = cache.weight_side(w, tile=tile, backend=backend,
                                       use_mxu=use_mxu_norm, levels=levels,
                                       block_n=block_n)
        else:
            wp = pad_to_tile(w, tile, tile * block_n).contiguous()
            nw = bk.norms(wp, tile, use_mxu=use_mxu_norm)
            if levels > 0:
                nw = NormPyramid.from_normmap(nw, levels, tile=tile,
                                              backend=bk.name)
        x2 = xp.reshape(bsz * mp, kp)
        p = plan(x2, None, tau, valid_ratio=valid_ratio, norm_b=nw,
                 tile=tile, block_n=block_n, backend=backend,
                 use_mxu_norm=use_mxu_norm, levels=levels)
        c = execute(p, x2, wp, out_dtype=out_dtype)
        c = c.reshape(bsz, mp, -1)[:, :m, :n]
        frac = p.valid_fraction
        tau_used = p.tau
    else:  # (B, M, K) @ (B, K, N): per-slice gates, one dense-grid launch
        if valid_ratio is not None:
            raise ValueError("valid_ratio needs a shared weight; pass tau for "
                             "per-batch weights")
        assert w.shape[0] == bsz and w.shape[1] == k, (x.shape, w.shape)
        n = w.shape[2]
        gm, gk = mp // tile, kp // tile
        if cache is not None:
            wp, nw = cache.weight_side(w, tile=tile, backend=backend,
                                       use_mxu=use_mxu_norm, block_n=block_n)
        else:
            wp = pad_to_tile(w, tile, tile * block_n).contiguous()
            nw = bk.norms(wp.reshape(bsz * kp, wp.shape[2]), tile,
                          use_mxu=use_mxu_norm).reshape(bsz, gk, -1)
        na = bk.norms(xp.reshape(bsz * mp, kp), tile,
                      use_mxu=use_mxu_norm).reshape(bsz, gm, gk)
        tau_used = _f32(tau)
        mask = gate_mask(na, nw, tau_used, block_n)
        kidx, nvalid = (kops.spamm_compact(mask) if bk.needs_compaction
                        else (None, None))
        c = bk.matmul(xp, wp, mask, kidx, nvalid, tile, block_n, out_dtype)
        c = c[:, :m, :n]
        frac = _fraction(mask.sum(dtype=torch.int32), mask.numel())
    return c, SpammInfo(tau=tau_used, valid_fraction=frac,
                        effective_flops=frac * (2.0 * bsz * m * k * n))
