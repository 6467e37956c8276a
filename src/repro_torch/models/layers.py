"""Shared layer primitives (twin of `repro.models.layers`).

Parameters are plain dicts of tensors in the reference's layouts: GEMM
weights are (K, N) and apply as `x @ w` (not nn.Linear's (N, K)), because
the frozen plans' (k, j) tables are tiled on the (K, N) grid. Every gated
GEMM routes through `core.module.maybe_spamm_matmul`, labelled with its
site ("w1", "w3", "w2") for the telemetry. `chunked_ce_loss` is the
training loss.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.module import maybe_spamm_matmul
from repro_torch.models import parallel as par


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    """RMS norm with the reference's `1 + w` scale (w initialised to 0)."""
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dtype)


def rope_frequencies(head_dim: int, theta: float, device=None
                     ) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S) int."""
    d = x.shape[-1]
    inv = rope_frequencies(d, theta, device=x.device)
    ang = positions[..., None].float() * inv             # (..., S, D/2)
    sin, cos = ang.sin()[..., None, :], ang.cos()[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation; torch's default is erf
    return F.gelu(x, approximate="tanh")


def mlp_weights(params: dict, spec, ctx):
    """(the weights this rank's MLP computes with, its ff cut (lo, hi) or
    None): over more than one model rank the ff columns of w1/w3 and rows
    of w2, when the ff cuts into whole tiles (`ctx.tile`); else every leaf
    whole."""
    if ctx is None or spec is None:
        return params, None
    ff = par.full_shape(params["w1"], spec["w1"], ctx)[1]
    cut = par.ff_split(ff, ctx, ctx.tile)
    if cut is None:
        return {n: par.full_weight(t, spec[n], ctx)
                for n, t in params.items()}, None
    dims = {"w1": 1, "w3": 1, "w2": 0}
    return {n: par.model_slice(t, spec[n], ctx, dims[n], *cut)
            for n, t in params.items()}, cut


def mlp(params: dict, x: torch.Tensor, act: str, spamm_cfg=None, frozen=None,
        require_frozen: bool = False, *, ctx=None, spec=None,
        sp: bool = False) -> torch.Tensor:
    """SwiGLU ('silu'), GeGLU ('gelu'), or classic 4x MLP ('gelu_mlp').
    `frozen` is this layer's dict of per-weight FrozenPlans. Over a mesh
    (`ctx`, the layer's placements `spec`) the ff splits over "model":
    column-parallel w1/w3, row-parallel w2, the partial outputs summed (`sp`:
    x and the output are the rank's sequence chunk)."""
    cdt = x.dtype
    fz = frozen or {}
    params, cut = mlp_weights(params, spec, ctx)
    split = cut is not None
    x = par.block_in(x, ctx, split, sp)
    if split:
        mm = functools.partial(par.split_matmul, ctx=ctx)
    else:
        mm = maybe_spamm_matmul

    def gemm(a, name):
        return mm(a, params[name].to(cdt), spamm_cfg, frozen=fz.get(name),
                  require_frozen=require_frozen, site=name)

    if act in ("silu", "gelu"):
        g, u = gemm(x, "w1"), gemm(x, "w3")
        g = F.silu(g) if act == "silu" else _gelu(g)
        y = gemm(g * u, "w2")
    elif act == "gelu_mlp":
        y = gemm(_gelu(gemm(x, "w1")), "w2")
    else:
        raise ValueError(act)
    return par.block_out(y, ctx, split, sp)


def _normal(gen, shape, scale, dtype, device):
    t = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    return t.mul_(scale)


def mlp_params(gen: torch.Generator, d_model: int, d_ff: int, act: str,
               dtype, device) -> dict:
    s_in = 1.0 / math.sqrt(d_model)
    s_ff = 1.0 / math.sqrt(d_ff)
    p = {
        "w1": _normal(gen, (d_model, d_ff), s_in, dtype, device),
        "w2": _normal(gen, (d_ff, d_model), s_ff, dtype, device),
    }
    if act in ("silu", "gelu"):
        p["w3"] = _normal(gen, (d_model, d_ff), s_in, dtype, device)
    return p


def embed(params: dict, tokens: torch.Tensor, compute_dtype) -> torch.Tensor:
    return params["embedding"].to(compute_dtype)[tokens]


def _chunk_loss(hc: torch.Tensor, unembed: torch.Tensor, lc: torch.Tensor):
    logits = (hc @ unembed).float()                      # (B, c, V)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, lc.clamp(min=0).long()[..., None])[..., 0]
    mask = (lc >= 0).float()
    return ((logz - gold) * mask).sum(), mask.sum()


def chunked_ce_parts(h: torch.Tensor, unembed: torch.Tensor,
                     labels: torch.Tensor, chunk: int):
    """(summed cross-entropy, count of unmasked labels) of h (B, S, d)
    against `labels` (B, S) int, -1 masked, without the whole (B, S, V)
    logits: a loop over sequence chunks plus the remainder, each recomputed
    in backward (`torch.utils.checkpoint`, the reference's
    `jax.checkpoint`). A data-parallel loss sums both over the batch ranks
    before the one division."""
    s = h.shape[1]
    chunk = min(chunk, s)
    tot = cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, s, chunk):
        l, m = checkpoint(_chunk_loss, h[:, c0:c0 + chunk], unembed,
                          labels[:, c0:c0 + chunk], use_reentrant=False)
        tot, cnt = tot + l, cnt + m
    return tot, cnt


def chunked_ce_loss(h: torch.Tensor, unembed: torch.Tensor,
                    labels: torch.Tensor, chunk: int) -> torch.Tensor:
    """Mean cross-entropy of h (B, S, d) final hidden states (already
    normed) against `labels` (B, S) int, -1 masked (`chunked_ce_parts`)."""
    tot, cnt = chunked_ce_parts(h, unembed, labels, chunk)
    return tot / cnt.clamp(min=1.0)
