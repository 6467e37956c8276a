"""Backend registry for the port's SpAMM kernels.

Twin of the registry in `repro.kernels.ops` (`Backend`, `BACKENDS`,
`get_backend`) and of its module functions. Backends:

  "cuda"  — the hand-written Hopper kernels (CUDA tensors only);
  "torch" — their plain PyTorch versions (any device; the oracle);
  "auto"  — per tensor: the kernel for a CUDA tensor, the plain version for
            a CPU tensor. Never a fallback: on a CUDA tensor `auto` launches
            the kernel or raises.

A `Backend` bundles the kernel entry points the SpAMM pipeline needs: the
§3.2 get-norm and its pyramid pooling, the §3.3 work-list GEMM over a
`repro_torch.core.plan.SpammWork`, and the dense-grid GEMM over compacted
valid-k lists. The int8 entry points of the reference registry are not
ported yet (ROADMAP queue B).
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
    pool_norms(normmap)                              → one pyramid level,
      (..., gm, gk) → (..., ⌈gm/2⌉, ⌈gk/2⌉) f32
    matmul_worklist(a, b, work, tile, block_n,
                    out_dtype)                       → (M, N) out_dtype
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
    pool_norms: Callable[..., torch.Tensor]
    matmul_worklist: Callable[..., torch.Tensor]
    matmul: Callable[..., torch.Tensor]
    needs_compaction: bool = True

    def pyramid_norms(self, x, tile, levels, use_mxu=False) -> tuple:
        """Norm pyramid of x: one get-norm pass plus `levels` poolings,
        finest first (the reference's `getnorm.norm_pyramid`)."""
        maps = [self.norms(x, tile, use_mxu=use_mxu)]
        for _ in range(levels):
            maps.append(self.pool_norms(maps[-1]))
        return tuple(maps)


def _worklist(fn):
    def matmul_worklist(a, b, work, tile, block_n, out_dtype):
        return fn(a, b, work.step_i, work.step_j, work.step_k,
                  work.step_flags, work.runs, tile=tile, block_n=block_n,
                  out_dtype=out_dtype)

    return matmul_worklist


def _dense(fn):
    def matmul(a, b, mask, kidx, nvalid, tile, block_n, out_dtype):
        del mask  # the kernel reads the compaction
        return fn(a, b, kidx, nvalid, tile=tile, block_n=block_n,
                  out_dtype=out_dtype)

    return matmul


BACKENDS = {
    "cuda": Backend("cuda", _getnorm.tile_norms_cuda, _getnorm.pool_norms_cuda,
                    _worklist(_spamm_mm.spamm_mm_worklist_cuda),
                    _dense(_spamm_mm.spamm_mm_cuda)),
    "torch": Backend("torch", _getnorm.tile_norms_plain,
                     _getnorm.pool_norms_plain,
                     _worklist(_spamm_mm.spamm_mm_worklist_plain),
                     _dense(_spamm_mm.spamm_mm_plain)),
    "auto": Backend("auto", _getnorm.tile_norms, _getnorm.pool_norms,
                    _worklist(_spamm_mm.spamm_mm_worklist),
                    _dense(_spamm_mm.spamm_mm)),
}

VALID_BACKENDS = tuple(BACKENDS)


def get_backend(backend: str) -> Backend:
    try:
        return BACKENDS[backend]
    except KeyError:
        raise ValueError(f"backend {backend!r} not in {VALID_BACKENDS}") from None


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
