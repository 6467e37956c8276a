"""Per-tile quantization helpers + quantization-aware gate widening.

Twin of `repro.kernels.quantize` (see its docstring for the gate-widening
derivation). Low-precision plans gate on the norms of what the kernel will
multiply (`quantized_view`, or the fused int8 get-norm) at the widened τ of
`widen_tau`, so their gate keeps every tile the float32 gate keeps.

int8 scheme: symmetric per-(tile × tile_n) scaling,
    scale = max(amax, tiny) · f32(1/127),  q = clip(round(x / scale), ±127)
where the scale is a multiply by the f32 constant, never a division by 127,
so fused and unfused quantizers agree bit for bit. Rounding is
half-to-even (`torch.round`, like `jnp.round`).
"""
from __future__ import annotations

import math

import numpy as np
import torch

_DTYPE_ALIASES = {
    "float32": "float32", "f32": "float32", "fp32": "float32",
    "bfloat16": "bfloat16", "bf16": "bfloat16",
    "int8": "int8", "i8": "int8",
}
COMPUTE_DTYPES = ("float32", "bfloat16", "int8")

_TINY = 1e-30
_INV127 = float(np.float32(1.0) / np.float32(127.0))

_TORCH_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.int8: "int8"}


def canonical_dtype(dtype) -> str:
    """Resolve a user-facing dtype spec to one of COMPUTE_DTYPES."""
    if dtype is None:
        return "float32"
    name = _TORCH_NAMES.get(dtype) if isinstance(dtype, torch.dtype) else dtype
    try:
        return _DTYPE_ALIASES[str(name).lower()]
    except KeyError:
        raise ValueError(
            f"compute dtype {dtype!r} not one of {sorted(set(_DTYPE_ALIASES))}"
        ) from None


def dtype_itemsize(dtype) -> int:
    """Bytes per element moved by the GEMM inputs at this compute dtype."""
    return {"float32": 4, "bfloat16": 2, "int8": 1}[canonical_dtype(dtype)]


def tile_absmax(x: torch.Tensor, tile: int, tile_n: int | None = None):
    """Per-(tile × tile_n)-tile max|x|: (M//tile, N//tile_n) f32."""
    tile_n = tile if tile_n is None else tile_n
    m, n = x.shape
    x4 = x.float().abs().reshape(m // tile, tile, n // tile_n, tile_n)
    return x4.amax(dim=(1, 3))


def quantize_tiles(x: torch.Tensor, tile: int, tile_n: int | None = None, *,
                   scales: torch.Tensor | None = None):
    """Symmetric per-tile int8 quantization. Returns (q (M, N) int8,
    scales (M//tile, N//tile_n) f32)."""
    tile_n = tile if tile_n is None else tile_n
    m, n = x.shape
    gm, gn = m // tile, n // tile_n
    if scales is None:
        scales = (tile_absmax(x, tile, tile_n).clamp(min=_TINY)
                  * torch.tensor(_INV127, dtype=torch.float32))
    x4 = x.float().reshape(gm, tile, gn, tile_n)
    q = torch.clamp(torch.round(x4 / scales[:, None, :, None]), -127.0, 127.0)
    return q.to(torch.int8).reshape(m, n), scales


def dequantize_tiles(q: torch.Tensor, scales: torch.Tensor, tile: int,
                     tile_n: int | None = None) -> torch.Tensor:
    """Inverse of quantize_tiles: (M, N) f32 from int8 codes + scales."""
    tile_n = tile if tile_n is None else tile_n
    m, n = q.shape
    q4 = q.float().reshape(m // tile, tile, n // tile_n, tile_n)
    return (q4 * scales[:, None, :, None]).reshape(m, n)


def quantized_view(x: torch.Tensor, dtype, tile: int,
                   tile_n: int | None = None, *,
                   scales: torch.Tensor | None = None) -> torch.Tensor:
    """The f32 view of what the kernel will multiply at `dtype`: identity
    for float32, a round-trip through bf16 / per-tile int8 otherwise."""
    dtype = canonical_dtype(dtype)
    if dtype == "float32":
        return x
    if dtype == "bfloat16":
        return x.to(torch.bfloat16).float()
    q, s = quantize_tiles(x, tile, tile_n, scales=scales)
    return dequantize_tiles(q, s, tile, tile_n)


def gate_eps(dtype, tile: int, tile_n: int | None = None) -> float:
    """Relative per-tile Frobenius-norm quantization error bound eps with
    ‖Q(x)‖_F ≥ (1 − eps)·‖x‖_F."""
    dtype = canonical_dtype(dtype)
    if dtype == "float32":
        return 0.0
    if dtype == "bfloat16":
        return 2.0 ** -8
    tile_n = tile if tile_n is None else tile_n
    return min(1.0, math.sqrt(tile * tile_n) / 254.0)


def widen_tau(tau, dtype, tile: int, tile_n: int | None = None):
    """τ' = τ·(1−eps)² for τ > 0 (τ ≤ 0 gates nothing out at any precision
    and is left alone); float32 returns τ unchanged."""
    e = gate_eps(dtype, tile, tile_n)
    if e == 0.0:
        return tau
    factor = (1.0 - e) ** 2
    if isinstance(tau, torch.Tensor):
        return torch.where(tau > 0, tau * factor, tau)
    t = float(np.asarray(tau))
    return t * factor if t > 0 else t
