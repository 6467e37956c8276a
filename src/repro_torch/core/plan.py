"""Plan/execute split for the SpAMM pipeline (twin of `repro.core.plan`).

The gating phase — get-norm (§3.2) → τ-gate → `map_offset` compaction
(§3.3) — depends only on the operands' normmaps and τ; the multiplication
phase consumes its step tables. This module is the port's one
implementation of the gating phase:

  plan(a, b, tau)          → SpammPlan   concrete flat gate, host planner
  plan(a, frozen_weight=…) → SpammPlan   frozen weight side (serving path)
  execute(plan, a, b)      → C           the work-list GEMM kernel
  compact_from_triples     — work-list + step tables from surviving triples
  _frozen_step_flags       — INIT/ACC/FLUSH flags over frozen step tables

The host planners stay numpy, so their tables match the reference's array
for array. The frozen path does its per-call work on the device (no host
sync per GEMM): the activation get-norm, an O(S) gather-compare over the
frozen step tables, the flag arithmetic and the nvalid scatter-add.

Not ported yet (each raises NotImplementedError naming its ROADMAP item):
hierarchical gating over a norm pyramid (needs `pool_norms`), the
valid-ratio τ-search, low-precision (bf16/int8) plans, traced dense-kidx
plans and the `WeightPlanCache`.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import cost as kcost
from repro_torch.kernels import ops as kops
from repro_torch.kernels import quantize as kquant
from repro_torch.kernels import ref as kref
from repro_torch.kernels import spamm_mm as kmm


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


class NormPyramid:
    """Coarse-to-fine stack of normmaps for one operand side: levels[0] is
    the plain normmap at `tile`, levels[l] the sqrt-sumsq 2×2 pooling of
    levels[l-1] (exact norm of the (tile·2^l)² block)."""

    def __init__(self, levels, *, tile: int):
        self.levels = tuple(levels)
        self.tile = tile

    @classmethod
    def from_normmap(cls, normmap: torch.Tensor, levels: int, *,
                     tile: int = 64) -> "NormPyramid":
        """Pyramid from an existing finest normmap (each coarser level one
        pooling reduction)."""
        lv = [normmap]
        for _ in range(levels):
            lv.append(kref.pool_norms_ref(lv[-1]))
        return cls(lv, tile=tile)


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
                         assume_sorted: bool = False):
    """Work-list straight from surviving (i, j, k) triples, without a dense
    (gm, gn, gk) bitmap: one fused-key sort (skipped when `assume_sorted`),
    super-column folding, then linear passes. Host numpy, array for array
    the reference's `compact_from_triples`.

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
        s = kcost.bucket(v)
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


class SpammPlan:
    """Gating phase of one SpAMM product.

    Tensor fields: norm_a (gm, gk), norm_b (gk, gn), nvalid (gm, gnb) int32,
    valid_tiles (0-d int32), work (SpammWork, device tables), mask (lazy
    (gm, gnb, gk) bool view scattered from the step tables on first read;
    the executor never reads it).
    tau is the f32 gate threshold as a Python float. Metadata: tile,
    block_n, backend."""

    def __init__(self, tau, norm_a, norm_b, nvalid, valid_tiles, work, *,
                 tile: int, block_n: int, backend: str):
        self.tau = tau
        self.norm_a = norm_a
        self.norm_b = norm_b
        self._mask = None
        self.nvalid = nvalid
        self.valid_tiles = valid_tiles
        self.work = work
        self.tile = tile
        self.block_n = block_n
        self.backend = backend

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
        return self.valid_tiles.float() / self.total_tiles


def gate_mask(norm_a: torch.Tensor, norm_b: torch.Tensor, tau,
              block_n: int = 1) -> torch.Tensor:
    """Validity bitmap from normmaps (paper Alg. 2 lines 3–8); block_n > 1
    groups columns into super-columns valid if ANY member is. Returns
    (gm, gn//block_n, gk) bool."""
    if block_n > 1:
        gk, gn = norm_b.shape
        assert gn % block_n == 0, (gn, block_n)
        nb_g = norm_b.reshape(gk, gn // block_n, block_n)
        fine = (norm_a[:, None, :, None] * nb_g.transpose(0, 1)[None]
                >= tau)
        return fine.any(dim=-1)
    return kref.spamm_mask_ref(norm_a, norm_b, tau)


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
    device — no weight get-norm, no bitmap, no host sync."""
    from repro_torch.plans.frozen import FrozenPlan, FrozenWeight

    if isinstance(fp, FrozenWeight):
        if a is None:
            raise ValueError("a FrozenWeight needs the activation to pick the "
                             "row grid; pass `a` or use for_rows(gm)")
        fp = fp.for_rows(a.shape[0] // fp.tile)
    if not isinstance(fp, FrozenPlan):
        raise TypeError(f"expected a FrozenPlan, got {type(fp).__name__}")
    bk = kops.get_backend(fp.backend)
    if norm_a is None:
        if a is None:
            raise ValueError("need `a` or `norm_a`")
        norm_a = bk.norms(a, fp.tile, use_mxu=use_mxu_norm)
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
                     tile=fp.tile, block_n=fp.block_n, backend=bk.name)


def plan(a: Optional[torch.Tensor] = None, b: Optional[torch.Tensor] = None,
         tau=None, *, valid_ratio=None, norm_a=None, norm_b=None,
         tile: int = 64, block_n: int = 1, backend: str = "auto",
         use_mxu_norm: bool = False, levels: int = 0, frozen_weight=None,
         compute_dtype: str = "float32") -> SpammPlan:
    """Gating phase for (M, K) @ (K, N), dims divisible by tile (N by
    tile·block_n). Either side may be the matrix or its precomputed normmap
    (norm_a= / norm_b=). The gate is the concrete flat one: normmaps go to
    the host, the surviving triples feed `compact_from_triples`, and the
    step tables come back to the operands' device.

    frozen_weight (a `FrozenPlan`, or a `FrozenWeight` plus `a`) replaces
    the weight side: τ/tile/block_n/backend come from the artifact."""
    if frozen_weight is not None:
        if tau is not None or valid_ratio is not None:
            raise ValueError("frozen_weight carries its own tau; pass neither "
                             "tau nor valid_ratio")
        return _plan_frozen(a, frozen_weight, norm_a=norm_a,
                            use_mxu_norm=use_mxu_norm)
    if (tau is None) == (valid_ratio is None):
        raise ValueError("give exactly one of tau / valid_ratio")
    if valid_ratio is not None:
        raise NotImplementedError(
            "valid_ratio needs the τ-search (core/tau_search.py): ROADMAP "
            "queue A, hierarchical gating + τ-search")
    if kquant.canonical_dtype(compute_dtype) != "float32":
        raise NotImplementedError(
            f"compute_dtype={compute_dtype!r} needs the bf16/int8 kernels "
            f"(ROADMAP queue B items 5, 6, 8)")
    if (levels > 0 or isinstance(norm_a, NormPyramid)
            or isinstance(norm_b, NormPyramid)):
        raise NotImplementedError(
            "hierarchical gating (levels > 0) needs pool_norms and the "
            "pyramid descent: ROADMAP queue A, hierarchical gating + τ-search")
    bk = kops.get_backend(backend)
    dev = next((x.device for x in (a, b, norm_a, norm_b)
                if isinstance(x, torch.Tensor)), torch.device("cpu"))
    if norm_a is None:
        if a is None:
            raise ValueError("need `a` or `norm_a`")
        norm_a = bk.norms(a, tile, use_mxu=use_mxu_norm)
    if norm_b is None:
        if b is None:
            raise ValueError("need `b` or `norm_b`")
        norm_b = bk.norms(b, tile, use_mxu=use_mxu_norm)
    tau_f = float(np.float32(float(tau)))
    triples, _ = _flat_triples_host(
        norm_a.detach().cpu().numpy().astype(np.float32, copy=False),
        norm_b.detach().cpu().numpy().astype(np.float32, copy=False),
        tau_f, block_n, keep_mask=False)
    gm, gk = norm_a.shape
    gnb = norm_b.shape[-1] // block_n
    work_np, nvalid_np = compact_from_triples(
        *triples, gm=gm, gn=gnb, gk=gk, block_n=1, assume_sorted=True)
    work = SpammWork(*(torch.as_tensor(x, device=dev) for x in work_np))
    return SpammPlan(tau_f, norm_a, norm_b,
                     torch.as_tensor(nvalid_np, device=dev),
                     torch.tensor(int(work_np.klist.size), dtype=torch.int32,
                                  device=dev),
                     work, tile=tile, block_n=block_n, backend=bk.name)


def execute(p: SpammPlan, a: torch.Tensor, b: torch.Tensor, *,
            out_dtype=None) -> torch.Tensor:
    """Multiplication phase of a prebuilt plan on (a, b), which must have
    the tile-padded shapes the plan was built for: the backend's work-list
    GEMM over the plan's step tables."""
    gm, gk = p.norm_a.shape
    gn = p.norm_b.shape[1]
    t = p.tile
    if tuple(a.shape) != (gm * t, gk * t) or tuple(b.shape) != (gk * t, gn * t):
        raise ValueError(f"operands {tuple(a.shape)} @ {tuple(b.shape)} do not "
                         f"match the plan's grid ({gm}, {gk}, {gn}) at tile {t}")
    return kops.get_backend(p.backend).matmul_worklist(
        a, b, p.work, t, p.block_n, out_dtype or torch.float32)
