"""Mamba2 — SSD (state-space duality) sequence mixing, chunked (arXiv
2405.21060); twin of `repro.models.ssm`.

Prefill runs the chunked SSD algorithm as a Python loop over sequence
chunks (the reference's `lax.scan`): an intra-chunk quadratic term plus the
carried inter-chunk state (B, H, P, N) — O(S·Q) compute, and a (B, Q, Q, H)
decay mask per chunk, never one for the whole sequence. A remainder shorter
than the chunk runs as one more chunk from the carried state. Decode is the
O(1)-per-token recurrent update.

All of it is plain PyTorch, as the reference's is plain jnp: `in_proj` and
`out_proj` are plain matmuls, never SpAMM-gated. softplus is
`logaddexp(x, 0)`, as `jax.nn.softplus` is (`F.softplus` returns x itself
above 20).

The decode step writes the new state and the shifted conv history INTO the
cache tensors (`copy_`), so a CUDA graph replayed against static buffers
carries its state from step to step (the reference returns fresh arrays).
The decode conv cache holds the pre-conv xbc of the last conv_dim - 1
positions, recomputed from those positions' inputs as the reference's
`xbc_tail` does (not sliced from the prefill's own projection, which would
equal it only up to the matmul's blocking).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.models.layers import _normal, rms_norm


class SSMDims(NamedTuple):
    d_inner: int
    heads: int
    conv_ch: int     # channels through the causal conv (d_inner + 2*g*state)
    proj_out: int    # in_proj output width


def ssm_dims(cfg: SSMConfig, d_model: int) -> SSMDims:
    d_inner = cfg.expand * d_model
    heads = d_inner // cfg.head_dim
    conv_ch = d_inner + 2 * cfg.n_groups * cfg.state
    proj_out = d_inner + conv_ch + heads  # z, (x,B,C) through conv, dt
    return SSMDims(d_inner, heads, conv_ch, proj_out)


def _uniform(gen, shape, lo, hi, device):
    t = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    return t * (hi - lo) + lo


def ssm_params(gen: torch.Generator, cfg: SSMConfig, d_model: int, dtype,
               device) -> dict:
    """The reference's distributions from `gen` (the numbers differ)."""
    dims = ssm_dims(cfg, d_model)
    f32 = dict(dtype=torch.float32, device=device)
    dt = torch.exp(_uniform(gen, (dims.heads,), math.log(1e-3),
                            math.log(0.1), device))
    return {
        "in_proj": _normal(gen, (d_model, dims.proj_out),
                           1.0 / math.sqrt(d_model), dtype, device),
        "conv": _normal(gen, (cfg.conv_dim, dims.conv_ch), 0.1, dtype,
                        device),
        "conv_bias": torch.zeros(dims.conv_ch, **f32),
        "A_log": torch.log(_uniform(gen, (dims.heads,), 1.0, 16.0, device)),
        "D": torch.ones(dims.heads, **f32),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),  # inverse softplus
        "norm": torch.zeros(dims.d_inner, **f32),
        "out_proj": _normal(gen, (dims.d_inner, d_model),
                            1.0 / math.sqrt(dims.d_inner), dtype, device),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as `jax.nn.softplus` computes it: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv. x: (B, S, C); w: (K, C)."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = sum(xp[:, i:i + s, :] * w[i][None, None, :] for i in range(k))
    return out + b[None, None, :].to(out.dtype)


def _conv_step(hist: torch.Tensor, w: torch.Tensor, b: torch.Tensor
               ) -> torch.Tensor:
    """The causal conv at the newest position of a (B, K, C) history."""
    return torch.einsum("bkc,kc->bc", hist, w) + b.to(hist.dtype)


def _split_proj(cfg: SSMConfig, dims: SSMDims, proj: torch.Tensor):
    return torch.split(proj, [dims.d_inner, dims.conv_ch, dims.heads],
                       dim=-1)


def _split_xbc(cfg: SSMConfig, dims: SSMDims, xbc: torch.Tensor):
    gn = cfg.n_groups * cfg.state
    return torch.split(xbc, [dims.d_inner, gn, xbc.shape[-1] - dims.d_inner
                             - gn], dim=-1)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                bmat: torch.Tensor, cmat: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None):
    """Chunked SSD. x (B, S, H, P) conv'd and silu'd inputs, dt (B, S, H)
    softplus'd step sizes, a (H,) negative decay rates, bmat / cmat
    (B, S, N) input / output projections (n_groups = 1 squeezed),
    init_state (B, H, P, N) or None. Returns (y (B, S, H, P), final state
    (B, H, P, N) f32)."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    q = min(chunk, s)
    assert s % q == 0, (s, q)
    xd = (x * dt[..., None]).float()                 # discretized input
    da = dt * a[None, None, :]                       # (B, S, H) ≤ 0
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    ys = []
    for c0 in range(0, s, q):
        xc, dac = xd[:, c0:c0 + q], da[:, c0:c0 + q]
        bc = bmat[:, c0:c0 + q].float()
        cc = cmat[:, c0:c0 + q].float()
        acs = torch.cumsum(dac, dim=1)               # (B, q, H)
        asum = acs[:, -1]                            # (B, H)
        # intra-chunk: L[b, i, j, h] = exp(acs_i - acs_j) for j <= i else 0
        seg = acs[:, :, None, :] - acs[:, None, :, :]          # (B, q, q, H)
        l_mat = torch.where(tri[None, :, :, None], torch.exp(seg), 0.0)
        scores = torch.einsum("bin,bjn->bij", cc, bc)          # (B, q, q)
        y_diag = torch.einsum("bijh,bjhp->bihp", scores[..., None] * l_mat,
                              xc)
        # inter-chunk: the carried state's contribution
        y_off = (torch.einsum("bin,bhpn->bihp", cc, state)
                 * torch.exp(acs)[..., None])
        decay_out = torch.exp(asum[:, None, :] - acs)          # (B, q, H)
        state = state * torch.exp(asum)[:, :, None, None] + torch.einsum(
            "bjn,bjhp->bhpn", bc, xc * decay_out[..., None])
        ys.append(y_diag + y_off)
    return torch.cat(ys, dim=1).to(x.dtype), state


def ssm_block(params: dict, x: torch.Tensor, cfg: SSMConfig, *,
              norm_eps: float = 1e-5):
    """The Mamba2 block over x (B, S, d) (prefill). Returns (y, cache
    {"state" (B, H, P, N) f32, "conv" (B, K-1, conv_ch)})."""
    bsz, s, d = x.shape
    dims = ssm_dims(cfg, d)
    cdt = x.dtype
    proj = x @ params["in_proj"].to(cdt)
    z, xbc, dt = _split_proj(cfg, dims, proj)
    xbc = F.silu(_causal_conv(xbc, params["conv"].to(cdt),
                              params["conv_bias"]))
    xin, bmat, cmat = _split_xbc(cfg, dims, xbc)
    dt = softplus(dt.float() + params["dt_bias"])
    a = -torch.exp(params["A_log"])
    xh = xin.reshape(bsz, s, dims.heads, cfg.head_dim)
    # chunked main run + remainder (arbitrary sequence lengths)
    q = min(cfg.chunk, s)
    m = (s // q) * q
    y, state = ssd_chunked(xh[:, :m], dt[:, :m], a, bmat[:, :m],
                           cmat[:, :m], q)
    if m < s:
        y2, state = ssd_chunked(xh[:, m:], dt[:, m:], a, bmat[:, m:],
                                cmat[:, m:], s - m, init_state=state)
        y = torch.cat([y, y2], dim=1)
    y = y + params["D"][None, None, :, None] * xh.float()
    y = y.reshape(bsz, s, dims.d_inner).to(cdt)
    y = rms_norm(y * F.silu(z), params["norm"], norm_eps)
    out = y @ params["out_proj"].to(cdt)
    return out, {"state": state, "conv": xbc_tail(x, params, cfg, dims)}


def xbc_tail(x: torch.Tensor, params: dict, cfg: SSMConfig, dims: SSMDims
             ) -> torch.Tensor:
    """Pre-conv xbc of the last (conv_dim - 1) positions → decode cache."""
    cdt = x.dtype
    tail = x[:, -(cfg.conv_dim - 1):, :]
    _, xbc, _ = _split_proj(cfg, dims, tail @ params["in_proj"].to(cdt))
    return xbc


def ssm_decode_step(params: dict, x: torch.Tensor, cache: dict,
                    cfg: SSMConfig, *, norm_eps: float = 1e-5):
    """One token x (B, d) against cache {"state" (B, H, P, N) f32, "conv"
    (B, K-1, conv_ch)}, both updated in place. Returns (y (B, d),
    cache)."""
    bsz, d = x.shape
    dims = ssm_dims(cfg, d)
    cdt = x.dtype
    z, xbc, dt = _split_proj(cfg, dims, x @ params["in_proj"].to(cdt))
    hist = torch.cat([cache["conv"], xbc[:, None, :]], dim=1)   # (B, K, ch)
    xbc_t = F.silu(_conv_step(hist, params["conv"].to(cdt),
                              params["conv_bias"]))
    xin, bmat, cmat = _split_xbc(cfg, dims, xbc_t)
    dt = softplus(dt.float() + params["dt_bias"])               # (B, H)
    a = -torch.exp(params["A_log"])
    xh = xin.reshape(bsz, dims.heads, cfg.head_dim).float()
    decay = torch.exp(dt * a[None, :])                          # (B, H)
    state = cache["state"] * decay[..., None, None] + torch.einsum(
        "bn,bhp->bhpn", bmat.float(), xh * dt[..., None])
    y = torch.einsum("bn,bhpn->bhp", cmat.float(), state)
    y = y + params["D"][None, :, None] * xh
    y = y.reshape(bsz, dims.d_inner).to(cdt)
    y = rms_norm(y * F.silu(z), params["norm"], norm_eps)
    out = y @ params["out_proj"].to(cdt)
    cache["state"].copy_(state)
    cache["conv"].copy_(hist[:, 1:, :])     # the reference's hist[:, 1:, :]
    return out, cache
