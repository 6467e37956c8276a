"""Shared layer primitives (twin of `repro.models.layers`).

Parameters are plain dicts of tensors in the reference's layouts: GEMM
weights are (K, N) and apply as `x @ w` (not nn.Linear's (N, K)), because
the frozen plans' (k, j) tables are tiled on the (K, N) grid. Every gated
GEMM routes through `core.module.maybe_spamm_matmul`, labelled with its
site ("w1", "w3", "w2") for the telemetry. `chunked_ce_loss` is the
training loss.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.module import maybe_spamm_matmul


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


def mlp(params: dict, x: torch.Tensor, act: str, spamm_cfg=None, frozen=None,
        require_frozen: bool = False) -> torch.Tensor:
    """SwiGLU ('silu'), GeGLU ('gelu'), or classic 4x MLP ('gelu_mlp').
    `frozen` is this layer's dict of per-weight FrozenPlans."""
    cdt = x.dtype
    fz = frozen or {}
    if act in ("silu", "gelu"):
        g = maybe_spamm_matmul(x, params["w1"].to(cdt), spamm_cfg,
                               frozen=fz.get("w1"),
                               require_frozen=require_frozen, site="w1")
        u = maybe_spamm_matmul(x, params["w3"].to(cdt), spamm_cfg,
                               frozen=fz.get("w3"),
                               require_frozen=require_frozen, site="w3")
        g = F.silu(g) if act == "silu" else _gelu(g)
        return maybe_spamm_matmul(g * u, params["w2"].to(cdt), spamm_cfg,
                                  frozen=fz.get("w2"),
                                  require_frozen=require_frozen, site="w2")
    if act == "gelu_mlp":
        h = _gelu(maybe_spamm_matmul(x, params["w1"].to(cdt), spamm_cfg,
                                     frozen=fz.get("w1"),
                                     require_frozen=require_frozen,
                                     site="w1"))
        return maybe_spamm_matmul(h, params["w2"].to(cdt), spamm_cfg,
                                  frozen=fz.get("w2"),
                                  require_frozen=require_frozen, site="w2")
    raise ValueError(act)


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


def chunked_ce_loss(h: torch.Tensor, unembed: torch.Tensor,
                    labels: torch.Tensor, chunk: int) -> torch.Tensor:
    """Mean cross-entropy of h (B, S, d) final hidden states (already
    normed) against `labels` (B, S) int, -1 masked, without the whole
    (B, S, V) logits: a loop over sequence chunks plus the remainder, each
    recomputed in backward (`torch.utils.checkpoint`, the reference's
    `jax.checkpoint`)."""
    s = h.shape[1]
    chunk = min(chunk, s)
    tot = cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, s, chunk):
        l, m = checkpoint(_chunk_loss, h[:, c0:c0 + chunk], unembed,
                          labels[:, c0:c0 + chunk], use_reentrant=False)
        tot, cnt = tot + l, cnt + m
    return tot / cnt.clamp(min=1.0)
