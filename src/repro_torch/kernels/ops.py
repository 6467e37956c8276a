"""Backend registry for the port's SpAMM kernels.

Twin of the registry in `repro.kernels.ops` (`Backend`, `BACKENDS`,
`get_backend`). Backends:

  "cuda"  — the hand-written Hopper kernels (CUDA tensors only);
  "torch" — their plain PyTorch versions (any device; the oracle);
  "auto"  — per tensor: the kernel for a CUDA tensor, the plain version for
            a CPU tensor. Never a fallback: on a CUDA tensor `auto` launches
            the kernel or raises.

A `Backend` bundles the two entry points the serving path needs:
`norms(x, tile, use_mxu)` (§3.2 get-norm) and `matmul_worklist(a, b, work,
tile, block_n, out_dtype)` (§3.3 work-list GEMM over a
`repro_torch.core.plan.SpammWork`). The dense-grid `spamm_mm`, the pooling
and the int8 entry points of the reference registry are not ported yet
(ROADMAP queue B).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.kernels import getnorm as _getnorm
from repro_torch.kernels import spamm_mm as _spamm_mm


@dataclasses.dataclass(frozen=True)
class Backend:
    """One SpAMM execution backend.

    norms(x, tile, use_mxu=False)                    → (M//tile, K//tile) f32
    matmul_worklist(a, b, work, tile, block_n,
                    out_dtype)                       → (M, N) out_dtype
    """
    name: str
    norms: Callable[..., torch.Tensor]
    matmul_worklist: Callable[..., torch.Tensor]


def _worklist(fn):
    def matmul_worklist(a, b, work, tile, block_n, out_dtype):
        return fn(a, b, work.step_i, work.step_j, work.step_k,
                  work.step_flags, work.runs, tile=tile, block_n=block_n,
                  out_dtype=out_dtype)

    return matmul_worklist


BACKENDS = {
    "cuda": Backend("cuda", _getnorm.tile_norms_cuda,
                    _worklist(_spamm_mm.spamm_mm_worklist_cuda)),
    "torch": Backend("torch", _getnorm.tile_norms_plain,
                     _worklist(_spamm_mm.spamm_mm_worklist_plain)),
    "auto": Backend("auto", _getnorm.tile_norms,
                    _worklist(_spamm_mm.spamm_mm_worklist)),
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
