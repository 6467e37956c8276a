"""Backend registry for the port's SpAMM kernels.

Twin of the registry in `repro.kernels.ops` (`Backend`, `BACKENDS`,
`register_backend`, `get_backend`) and of its module functions. Backends:

  "cuda"  — the hand-written Hopper kernels (CUDA tensors only);
  "torch" — their plain PyTorch versions (any device; the oracle);
  "auto"  — per tensor: the kernel for a CUDA tensor, the plain version for
            a CPU tensor. Never a fallback: on a CUDA tensor `auto` launches
            the kernel or raises.

`resolve_backend` names the backend that runs on a given device ("auto"
resolved per device): the name plan artifacts are recorded and stored under.

A `Backend` bundles the kernel entry points the SpAMM pipeline needs: the
§3.2 get-norm, its fused int8 variant and its pyramid pooling, the §3.3
work-list GEMM over a `repro_torch.core.plan.SpammWork` (f32 or bf16
operands) and its int8 twin, and the dense-grid GEMM over compacted valid-k
lists. Every port backend has every entry point, so the reference's
widen-to-f32 fallbacks for backends without the int8 ones have no
counterpart here.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.kernels import getnorm as _getnorm
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import spamm_mm as _spamm_mm


@dataclasses.dataclass(frozen=True)
class Backend:
    """One SpAMM execution backend.

    norms(x, tile, use_mxu=False)                    → (M//tile, K//tile) f32
    norms_quant(x, tile, use_mxu=False)              → (norms, scales), both
      (M//tile, K//tile) f32: the fused int8 get-norm (norms of the
      per-tile int8 view, and its scales)
    pool_norms(normmap)                              → one pyramid level,
      (..., gm, gk) → (..., ⌈gm/2⌉, ⌈gk/2⌉) f32
    matmul_worklist(a, b, work, tile, block_n,
                    out_dtype, rows=None)            → (M, N) out_dtype
      f32 or bf16 operands, f32 accumulation; `rows` (keyword): None, or
      the rows of a that hold data (the others zero; output rows from
      `rows` on zero), which an f32 call at ≤ 16 rows serves with the
      decode kernel
    matmul_worklist_int8(a_q, b_q, a_scale, b_scale, work, tile, block_n,
                         out_dtype, rows=None)       → (M, N) out_dtype
      int8 codes, per-tile f32 scales (b's per fine tile); `rows` is
      received and may be ignored
    matmul(a, b, mask, kidx, nvalid, tile, block_n,
           out_dtype)                                → (..., M, N) out_dtype
      the dense-grid GEMM; `mask` is the (..., gm, gn//block_n, gk) bitmap,
      `kidx`/`nvalid` its compaction (leading batch dims allowed: one call
      runs a batch of per-slice products).
    needs_compaction: whether `matmul` consumes kidx/nvalid (the reference's
      flag; every port backend's dense-grid GEMM does).
    """
    name: str
    norms: Callable[..., torch.Tensor]
    norms_quant: Callable[..., tuple]
    pool_norms: Callable[..., torch.Tensor]
    matmul_worklist: Callable[..., torch.Tensor]
    matmul_worklist_int8: Callable[..., torch.Tensor]
    matmul: Callable[..., torch.Tensor]
    needs_compaction: bool = True

    def pyramid_norms(self, x, tile, levels, use_mxu=False) -> tuple:
        """Norm pyramid of x: one get-norm pass plus `levels` poolings,
        finest first (the reference's `getnorm.norm_pyramid`)."""
        maps = [self.norms(x, tile, use_mxu=use_mxu)]
        for _ in range(levels):
            maps.append(self.pool_norms(maps[-1]))
        return tuple(maps)


# The open `launch.op_analysis.OpAnalysis`, or None. Each entry point of a
# backend reports its launch to it (the kernels launch through ctypes, where
# no dispatch mode sees them); with none open a launch costs this one check,
# and nothing reads the device.
analysis = None


def _acc_steps(flags: torch.Tensor) -> int:
    """The real steps of a step table: those with the ACC bit (a device
    read; only an open analysis asks)."""
    return int(((flags & _spamm_mm.STEP_ACC) != 0).sum())


def _worklist_name(dtype) -> str:
    return {torch.bfloat16: "spamm_mm_worklist_bf16",
            torch.int8: "spamm_mm_worklist_int8"}.get(dtype,
                                                      "spamm_mm_worklist")


def _counted_worklist(call, a, b, work, tile, block_n, operands):
    m, k = a.shape
    return analysis.kernel(
        _worklist_name(a.dtype), call, operands,
        flops=0.0, products=lambda: _acc_steps(work.step_flags),
        product_flops=2.0 * tile * tile * tile * block_n,
        dense_flops=2.0 * m * k * b.shape[1], dtype=a.dtype)


def _tables(work) -> tuple:
    return (work.step_i, work.step_j, work.step_k, work.step_flags,
            work.runs)


def _worklist(fn):
    def matmul_worklist(a, b, work, tile, block_n, out_dtype, rows=None):
        if analysis is None:
            return fn(a, b, work.step_i, work.step_j, work.step_k,
                      work.step_flags, work.runs, tile=tile, block_n=block_n,
                      out_dtype=out_dtype, rows=rows)
        return _counted_worklist(
            lambda: fn(a, b, *_tables(work), tile=tile, block_n=block_n,
                       out_dtype=out_dtype, rows=rows),
            a, b, work, tile, block_n, (a, b) + _tables(work))

    return matmul_worklist


def _worklist_int8(fn):
    def matmul_worklist_int8(a_q, b_q, a_scale, b_scale, work, tile, block_n,
                             out_dtype, rows=None):
        if analysis is None:
            return fn(a_q, b_q, a_scale, b_scale, work.step_i, work.step_j,
                      work.step_k, work.step_flags, work.runs, tile=tile,
                      block_n=block_n, out_dtype=out_dtype, rows=rows)
        return _counted_worklist(
            lambda: fn(a_q, b_q, a_scale, b_scale, *_tables(work), tile=tile,
                       block_n=block_n, out_dtype=out_dtype, rows=rows),
            a_q, b_q, work, tile, block_n,
            (a_q, b_q, a_scale, b_scale) + _tables(work))

    return matmul_worklist_int8


def _dense(fn):
    def matmul(a, b, mask, kidx, nvalid, tile, block_n, out_dtype):
        del mask  # the kernel reads the compaction
        if analysis is None:
            return fn(a, b, kidx, nvalid, tile=tile, block_n=block_n,
                      out_dtype=out_dtype)
        m, k = a.shape[-2:]
        batch = a.shape[0] if a.dim() == 3 else 1
        return analysis.kernel(
            "spamm_mm", lambda: fn(a, b, kidx, nvalid, tile=tile,
                                   block_n=block_n, out_dtype=out_dtype),
            (a, b, kidx, nvalid), flops=0.0,
            products=lambda: int(nvalid.sum()),
            product_flops=2.0 * tile * tile * tile * block_n,
            dense_flops=2.0 * batch * m * k * b.shape[-1], dtype=a.dtype)

    return matmul


def _norms(fn, quant: bool = False):
    """A get-norm entry: one kernel, 2 operations (square, add) an
    element."""
    base = "tile_norms_quant" if quant else "tile_norms"

    def norms(x, tile, use_mxu=False):
        if analysis is None:
            return fn(x, tile, use_mxu=use_mxu)
        return analysis.kernel(base + ("_mxu" if use_mxu else ""),
                               lambda: fn(x, tile, use_mxu=use_mxu), (x,),
                               flops=2.0 * x.numel())

    return norms


def _pool(fn):
    def pool_norms(normmap):
        if analysis is None:
            return fn(normmap)
        return analysis.kernel("pool_norms", lambda: fn(normmap), (normmap,),
                               flops=2.0 * normmap.numel())

    return pool_norms


BACKENDS = {
    "cuda": Backend("cuda", _norms(_getnorm.tile_norms_cuda),
                    _norms(_getnorm.tile_norms_quant_cuda, quant=True),
                    _pool(_getnorm.pool_norms_cuda),
                    _worklist(_spamm_mm.spamm_mm_worklist_cuda),
                    _worklist_int8(_spamm_mm.spamm_mm_worklist_int8_cuda),
                    _dense(_spamm_mm.spamm_mm_cuda)),
    "torch": Backend("torch", _norms(_getnorm.tile_norms_plain),
                     _norms(_getnorm.tile_norms_quant_plain, quant=True),
                     _pool(_getnorm.pool_norms_plain),
                     _worklist(_spamm_mm.spamm_mm_worklist_plain),
                     _worklist_int8(_spamm_mm.spamm_mm_worklist_int8_plain),
                     _dense(_spamm_mm.spamm_mm_plain)),
    "auto": Backend("auto", _norms(_getnorm.tile_norms),
                    _norms(_getnorm.tile_norms_quant, quant=True),
                    _pool(_getnorm.pool_norms),
                    _worklist(_spamm_mm.spamm_mm_worklist),
                    _worklist_int8(_spamm_mm.spamm_mm_worklist_int8),
                    _dense(_spamm_mm.spamm_mm)),
}

VALID_BACKENDS = tuple(BACKENDS)


def register_backend(backend: Backend):
    """Extension hook: make a new backend visible to the whole pipeline
    (`get_backend`, plans, frozen weights) under `backend.name`. Its
    `matmul_worklist` and `matmul_worklist_int8` receive `rows=` as a
    keyword (None or the live rows of a; see `Backend`), which they may
    ignore."""
    BACKENDS[backend.name] = backend


def get_backend(backend: str) -> Backend:
    try:
        return BACKENDS[backend]
    except KeyError:
        raise ValueError(f"backend {backend!r} not in {VALID_BACKENDS}") from None


def resolve_backend(backend: str, device) -> str:
    """The backend that runs on a tensor of `device`: "auto" resolves to
    "cuda" for a CUDA device and "torch" for the CPU, the way it dispatches
    per tensor; a registered name stays itself. Plan artifacts record and
    are addressed by this name, so a CPU-built artifact and a card-built
    one (norms an ulp apart) never share a store key."""
    if backend == "auto":
        return "cuda" if torch.device(device).type == "cuda" else "torch"
    return get_backend(backend).name


def tile_norms(x: torch.Tensor, tile: int = 64, *, backend: str = "auto",
               use_mxu: bool = False) -> torch.Tensor:
    """normmap of x — paper get-norm (§3.2), registry-dispatched."""
    return get_backend(backend).norms(x, tile, use_mxu=use_mxu)


def pyramid_norms(x: torch.Tensor, tile: int = 64, levels: int = 1, *,
                  backend: str = "auto", use_mxu: bool = False) -> tuple:
    """Norm pyramid of x: `levels + 1` normmaps, finest (tile) first, each
    coarser level a sqrt-sumsq 2×2 pooling of the previous (so level l is the
    exact normmap at tile·2^l). Registry-dispatched."""
    return get_backend(backend).pyramid_norms(x, tile, levels,
                                              use_mxu=use_mxu)


def int8_norms_and_scales(x: torch.Tensor, tile: int = 64, *,
                          backend: str = "auto", use_mxu: bool = False):
    """(norms, scales) of the per-tile int8 view of x — the entry point
    every int8 planner goes through (the reference's). On a CUDA tensor the
    fused kernel reads x once; its norms are bit-identical to `tile_norms`
    of the dequantized matrix on the card, and its scales to the
    quantizer's."""
    return get_backend(backend).norms_quant(x, tile, use_mxu=use_mxu)


def spamm_compact(mask: torch.Tensor):
    """Compacted valid-k lists from a bitmap — paper map_offset (§3.3)."""
    return _ref.spamm_compact_ref(mask)


def spamm_matmul(a: torch.Tensor, b: torch.Tensor, tau, *, tile: int = 64,
                 block_n: int = 1, backend: str = "auto",
                 use_mxu_norm: bool = False, out_dtype=None):
    """One-shot SpAMM: `plan` + `execute` (see repro_torch.core.plan), dims
    divisible by tile (N by tile·block_n). Returns (C, info): the normmaps,
    nvalid and the executed-tile fraction (the paper's valid ratio)."""
    from repro_torch.core import plan as _plan  # plan imports this module

    p = _plan.plan(a, b, tau, tile=tile, block_n=block_n, backend=backend,
                   use_mxu_norm=use_mxu_norm)
    c = _plan.execute(p, a, b, out_dtype=out_dtype)
    return c, p.info()


def spamm_effective_flops(m: int, k: int, n: int, valid_fraction):
    """FLOPs actually executed by SpAMM = valid_fraction × dense 2·M·K·N."""
    return valid_fraction * (2.0 * m * k * n)
