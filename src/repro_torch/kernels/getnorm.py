"""Get-norm kernels of the port (paper §3.2): per-tile Frobenius norms, the
same norms of the per-tile int8 view fused with its quantization scales,
and the 2×2 pooling that builds one level of the norm pyramid.

Twin of `repro.kernels.getnorm.tile_norms`, `tile_norms_quant` and
`pool_norms`. Each has
three entry points; for the tile norms:

  tile_norms_plain — the plain PyTorch version (reshape, square, sum in f32,
                     sqrt): what the CPU runs and what the kernel is held
                     against on the card;
  tile_norms_cuda  — the hand-written CUDA kernel `csrc/getnorm.cu` (see its
                     header note for what bounds it and how it is built);
  tile_norms       — dispatch on where the tensor lies: the plain version
                     for a CPU tensor, the kernel for a CUDA tensor (the
                     kernel launches or raises; nothing falls back).

The fused int8 get-norm has the same three: `tile_norms_quant_plain` (the
unfused composition quantize → dequantize → `tile_norms_plain`),
`tile_norms_quant_cuda` (one launch: scales and norms of the dequantized
tile; on the card bit-identical to `tile_norms_cuda` on the dequantized
matrix) and `tile_norms_quant`. The pooling has the same three:
`pool_norms_plain`, `pool_norms_cuda` and `pool_norms`. The reference's
`norm_pyramid` (one get-norm pass plus `levels` poolings) is
`Backend.pyramid_norms` in `kernels/ops.py`, so that it composes the entry
points of one backend.

`use_mxu=True` selects the reference's tensor-core reduction (paper Eq.
3–4: the tile's sum of squares as products against ones): in the plain
versions as two matmuls against a ones vector, on the card as the
`mma.sync` TF32 kernels of `csrc/getnorm.cu` (tile % 16 == 0), whose f32
accuracy comes from splitting each square into two TF32 terms.

Each kernel has its own launch count, incremented only where the kernel is
launched (`launches` for tile_norms, `quant_launches` for tile_norms_quant,
`mxu_launches`/`quant_mxu_launches` for their tensor-core variants,
`pool_launches` for pool_norms), so a run can show that its main path went
through each kernel.

The launch path is lean, since a decode step calls a get-norm entry once
per gated GEMM and the kernels take a few microseconds on the card: every
check runs before the kernel library is touched, the stream is the raw
handle of the current stream (no `torch.cuda.Stream` object), the current
device is switched only when the tensor lies on another one, and the fused
int8 entry allocates its norms and scales as one tensor.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels import quantize as _quant

launches = 0
quant_launches = 0
mxu_launches = 0
quant_mxu_launches = 0
pool_launches = 0

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("getnorm.cu")
        for name in ("spamm_tile_norms_f32", "spamm_tile_norms_mxu_f32"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for name in ("spamm_tile_norms_quant_f32",
                     "spamm_tile_norms_quant_mxu_f32"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        fn = lib.spamm_pool_norms_f32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _launch(fn, x: torch.Tensor, *args) -> int:
    """Call the C entry `fn(*args, stream)` on x's device and its current
    stream; returns the entry's CUDA error code."""
    dev = x.get_device()
    if dev == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    with torch.cuda.device(dev):
        return fn(*args, torch._C._cuda_getCurrentRawStream(dev))


def _grid(x: torch.Tensor, tile: int):
    if x.dim() != 2:
        raise ValueError(f"tile_norms needs a 2-D matrix, got {tuple(x.shape)}")
    m, k = x.shape
    if tile < 1 or m % tile or k % tile:
        raise ValueError(f"shape {tuple(x.shape)} not divisible by tile {tile}")
    return m // tile, k // tile


def tile_norms_plain(x: torch.Tensor, tile: int = 64, *,
                     use_mxu: bool = False) -> torch.Tensor:
    """(M//tile, K//tile) f32 tile norms with plain tensor ops.

    use_mxu=True keeps the reference's meaning (paper Eq. 3–4): the tile's
    sum of squares is taken as two products against a ones vector (row
    sums, then their total) instead of a direct reduction."""
    gm, gk = _grid(x, tile)
    x4 = x.float().reshape(gm, tile, gk, tile)
    sq = x4 * x4
    if use_mxu:
        ones = torch.ones(tile, 1, dtype=torch.float32, device=x.device)
        rows = sq.permute(0, 2, 1, 3) @ ones          # (gm, gk, t, 1)
        total = ones.transpose(0, 1) @ rows           # (gm, gk, 1, 1)
        return torch.sqrt(total.reshape(gm, gk))
    return torch.sqrt(sq.sum(dim=(1, 3)))


def _check_cuda_input(x: torch.Tensor, tile: int, use_mxu: bool, name: str):
    """Shape and type checks of the CUDA get-norm kernels; returns the
    tile grid (gm, gk). The tensor-core variant (use_mxu) takes tiles of a
    multiple of 16 rows and columns (the mma.sync m16n8k8 shape)."""
    if not x.is_cuda:
        raise ValueError(f"{name} needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} takes float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} needs a contiguous tensor")
    gm, gk = _grid(x, tile)
    if use_mxu and tile % 16:
        raise ValueError(f"{name}(use_mxu=True) needs a tile that is a "
                         f"multiple of 16, got {tile}")
    if gm > 65535:
        raise ValueError(f"{gm} row tiles exceed the kernel's grid.y limit")
    return gm, gk


def tile_norms_cuda(x: torch.Tensor, tile: int = 64, *,
                    use_mxu: bool = False) -> torch.Tensor:
    """(M//tile, K//tile) f32 tile norms from the CUDA get-norm kernel
    (use_mxu=True: the tensor-core kernel, tile % 16 == 0).

    Takes a contiguous 2-D float32 CUDA tensor; raises on anything else."""
    global launches, mxu_launches
    gm, gk = _check_cuda_input(x, tile, use_mxu, "tile_norms_cuda")
    out = x.new_empty((gm, gk))
    if gm * gk == 0:
        return out
    lib = _lib()
    fn = lib.spamm_tile_norms_mxu_f32 if use_mxu else lib.spamm_tile_norms_f32
    rc = _launch(fn, x, x.data_ptr(), out.data_ptr(), gm * tile, gk * tile,
                 tile)
    if rc != 0:
        raise RuntimeError(f"tile_norms kernel launch failed: CUDA error {rc}")
    if use_mxu:
        mxu_launches += 1
    else:
        launches += 1
    return out


def tile_norms(x: torch.Tensor, tile: int = 64, *,
               use_mxu: bool = False) -> torch.Tensor:
    """Per-tile norms: the plain version for a CPU tensor, the CUDA kernel
    for a CUDA tensor."""
    if x.device.type == "cpu":
        return tile_norms_plain(x, tile, use_mxu=use_mxu)
    return tile_norms_cuda(x, tile, use_mxu=use_mxu)


def tile_norms_quant_plain(x: torch.Tensor, tile: int = 64, *,
                           use_mxu: bool = False):
    """(norms, scales), both (M//tile, K//tile) f32: the per-tile int8
    quantizer's scales and the tile norms of the dequantized matrix, as the
    unfused composition quantize → dequantize → `tile_norms_plain` (the
    reference's `int8_norms_and_scales` without a fused kernel)."""
    _grid(x, tile)
    q, s = _quant.quantize_tiles(x, tile)
    dq = _quant.dequantize_tiles(q, s, tile)
    return tile_norms_plain(dq, tile, use_mxu=use_mxu), s


def tile_norms_quant_cuda(x: torch.Tensor, tile: int = 64, *,
                          use_mxu: bool = False):
    """(norms, scales) from the fused CUDA kernel: one launch takes each
    tile's absmax scale and the norm of its dequantized int8 view (use_mxu:
    the tensor-core sum, tile % 16 == 0). Takes a contiguous 2-D float32
    CUDA tensor; raises on anything else."""
    global quant_launches, quant_mxu_launches
    gm, gk = _check_cuda_input(x, tile, use_mxu, "tile_norms_quant_cuda")
    norms, scales = x.new_empty((2, gm, gk)).unbind(0)
    if gm * gk == 0:
        return norms, scales
    lib = _lib()
    fn = (lib.spamm_tile_norms_quant_mxu_f32 if use_mxu
          else lib.spamm_tile_norms_quant_f32)
    rc = _launch(fn, x, x.data_ptr(), norms.data_ptr(), scales.data_ptr(),
                 gm * tile, gk * tile, tile)
    if rc != 0:
        raise RuntimeError(
            f"tile_norms_quant kernel launch failed: CUDA error {rc}")
    if use_mxu:
        quant_mxu_launches += 1
    else:
        quant_launches += 1
    return norms, scales


def tile_norms_quant(x: torch.Tensor, tile: int = 64, *,
                     use_mxu: bool = False):
    """Fused int8 get-norm: the plain composition for a CPU tensor, the
    CUDA kernel for a CUDA tensor."""
    if x.device.type == "cpu":
        return tile_norms_quant_plain(x, tile, use_mxu=use_mxu)
    return tile_norms_quant_cuda(x, tile, use_mxu=use_mxu)


def pool_norms_plain(normmap: torch.Tensor) -> torch.Tensor:
    """One norm-pyramid level with plain tensor ops: (..., gm, gk) f32 →
    (..., ⌈gm/2⌉, ⌈gk/2⌉), odd trailing dims zero-padded. Sums in the TPU
    body's order, the row pair first, then the column pair, as the kernel
    does."""
    if normmap.dim() < 2:
        raise ValueError(f"pool_norms needs a normmap of at least 2 dims, "
                         f"got {tuple(normmap.shape)}")
    gm, gk = normmap.shape[-2:]
    sq = F.pad(normmap.float(), (0, gk % 2, 0, gm % 2))
    sq = sq * sq
    rows = sq[..., 0::2, :] + sq[..., 1::2, :]
    return torch.sqrt(rows[..., 0::2] + rows[..., 1::2])


def pool_norms_cuda(normmap: torch.Tensor) -> torch.Tensor:
    """One norm-pyramid level from the CUDA pooling kernel. Takes a
    contiguous float32 CUDA tensor of shape (..., gm, gk), the leading dims
    being slices pooled independently; raises on anything else."""
    global pool_launches
    if not normmap.is_cuda:
        raise ValueError(f"pool_norms_cuda needs a CUDA tensor, got "
                         f"{normmap.device}")
    if normmap.dtype != torch.float32:
        raise TypeError(f"pool_norms_cuda takes float32, got {normmap.dtype}")
    if not normmap.is_contiguous():
        raise ValueError("pool_norms_cuda needs a contiguous tensor")
    if normmap.dim() < 2:
        raise ValueError(f"pool_norms needs a normmap of at least 2 dims, "
                         f"got {tuple(normmap.shape)}")
    *lead, gm, gk = normmap.shape
    slices = normmap.numel() // max(gm * gk, 1)
    out = normmap.new_empty((*lead, (gm + 1) // 2, (gk + 1) // 2))
    if out.numel() == 0:
        return out
    rc = _launch(_lib().spamm_pool_norms_f32, normmap, normmap.data_ptr(),
                 out.data_ptr(), slices, gm, gk)
    if rc != 0:
        raise RuntimeError(f"pool_norms kernel launch failed: CUDA error {rc}")
    pool_launches += 1
    return out


def pool_norms(normmap: torch.Tensor) -> torch.Tensor:
    """One norm-pyramid level: the plain version for a CPU tensor, the CUDA
    kernel for a CUDA tensor."""
    if normmap.device.type == "cpu":
        return pool_norms_plain(normmap)
    return pool_norms_cuda(normmap)
