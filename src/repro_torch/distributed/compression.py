"""Gradient compression with error feedback (twin of
`repro.distributed.compression`'s `Int8EF`).

Per-leaf symmetric int8 quantization of the gradients with an
error-feedback residual: the quantization error of step t is added back
into the gradient of step t+1. In a data-parallel deployment the int8
payload is what crosses the all-reduce (4× fewer wire bytes); here the
quantize/dequantize pair runs right before the optimizer, so the numerics
and the residual are those of the compressed collective.

The operand-halo wire format pairs with `core.distributed.spamm_rowpart`:
B is replicated to every rank, and with compute_dtype ≠ f32 each rank's
GEMM only sees the per-tile quantized view of B, so the broadcast can
carry the quantized payload and the scale table instead of f32.
`compress_tiles` is that format on the source, `halo_wire_bytes` what one
replica moves, `decompress_tiles` the view each rank computes with —
`kernels.quantize`'s per-tile quantization, so decompressing the halo
gives, bit for bit, the view a rank's plan quantizes from its f32 replica.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch import tree as T


class Int8EF(NamedTuple):
    enabled: bool = True

    def apply(self, grads, state, *, ctx=None):
        """grads and state["ef"]: trees of the same structure (f32).
        Returns (dequantized grads, state with the new residuals). Over a
        mesh (`ctx`, a `transformer.NetCtx` with the leaves' placements;
        each rank passing its shards) a leaf's scale is the max over all
        its shards, as the whole leaf's."""
        def comp(g, e, spec=None):
            g = g + e
            amax = g.abs().max()
            if spec is not None:
                from repro_torch.optim.adamw import split_axes

                for ax in sorted(split_axes(spec)):
                    if ctx.size(ax) > 1:
                        dist.all_reduce(amax, op=dist.ReduceOp.MAX,
                                        group=ctx.group(ax))
            scale = torch.clamp(amax, min=1e-12) / 127.0
            q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
            deq = q.float() * scale
            return deq, g - deq

        if ctx is None:
            pairs = T.map_(comp, grads, state["ef"])
        else:
            pairs = T.map_specs(lambda spec, g, e: comp(g, e, spec),
                                ctx.specs, grads, state["ef"])
        return _pick(pairs, 0), dict(state, ef=_pick(pairs, 1))

    def wire_bytes_saved(self, grads) -> float:
        total = sum(g.numel() for g in T.leaves(grads))
        return total * (4 - 1)  # f32 → int8 payload


def _pick(tree, i):
    """Element i of every (deq, residual) pair at the leaves of `tree`."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]


def compress_tiles(x: torch.Tensor, tile: int, dtype: str = "int8"):
    """Tile-quantized wire format of an operand halo `x` (tile-padded
    2-D): (int8 payload, (gm, gn) f32 scales) for "int8", (bf16 payload,
    None) for "bfloat16", (x, None) for "float32"."""
    from repro_torch.kernels import quantize as kquant

    dtype = kquant.canonical_dtype(dtype)
    if dtype == "int8":
        return kquant.quantize_tiles(x, tile)
    if dtype == "bfloat16":
        return x.to(torch.bfloat16), None
    return x, None


def decompress_tiles(payload: torch.Tensor, scales, tile: int):
    """Inverse of `compress_tiles`: the f32 operand view a rank computes
    with (the quantized view, not the original)."""
    from repro_torch.kernels import quantize as kquant

    if payload.dtype == torch.int8:
        return kquant.dequantize_tiles(payload, scales, tile)
    return payload.float()


def halo_wire_bytes(shape, tile: int, dtype: str = "float32") -> float:
    """Bytes one replica of a (K, N) operand halo moves on the wire in the
    `compress_tiles` format (payload, plus int8's f32 scale table)."""
    from repro_torch.kernels import quantize as kquant

    dtype = kquant.canonical_dtype(dtype)
    k, n = shape
    payload = float(k) * float(n) * kquant.dtype_itemsize(dtype)
    if dtype == "int8":
        payload += (k // tile) * (n // tile) * 4.0
    return payload
