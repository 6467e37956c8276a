"""Gradient compression with error feedback (twin of
`repro.distributed.compression`'s `Int8EF`).

Per-leaf symmetric int8 quantization of the gradients with an
error-feedback residual: the quantization error of step t is added back
into the gradient of step t+1. In a data-parallel deployment the int8
payload is what crosses the all-reduce (4× fewer wire bytes); here the
quantize/dequantize pair runs right before the optimizer, so the numerics
and the residual are those of the compressed collective. The operand-halo
wire format (`compress_tiles`, `decompress_tiles`, `halo_wire_bytes`)
waits for the multi-GPU slice.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import tree as T


class Int8EF(NamedTuple):
    enabled: bool = True

    def apply(self, grads, state):
        """grads and state["ef"]: trees of the same structure (f32).
        Returns (dequantized grads, state with the new residuals)."""
        def comp(g, e):
            g = g + e
            scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
            q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
            deq = q.float() * scale
            return deq, g - deq

        pairs = T.map_(comp, grads, state["ef"])
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
