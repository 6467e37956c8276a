"""RecurrentGemma / Griffin recurrent block: RG-LRU + causal conv
(arXiv 2402.19427); twin of `repro.models.rglru`.

Block: x → (linear → GELU) ⊙ (linear → conv1d(4) → RG-LRU) → linear.
RG-LRU:  r_t = σ(blockdiag(W_a) x_t + b_a)      (recurrence gate)
         i_t = σ(blockdiag(W_x) x_t + b_x)      (input gate)
         a_t = exp(-c · softplus(Λ) · r_t)
         h_t = a_t ⊙ h_{t-1} + sqrt(1 − a_t²) ⊙ (i_t ⊙ x_t)

The recurrence is linear, so prefill scans it in log-steps over time. The
reference calls `lax.associative_scan`, which PyTorch lacks; here it is a
Hillis–Steele scan (`_linear_scan`): ceil(log2 S) rounds of whole-tensor
ops with the reference's combine, (a1, b1) ∘ (a2, b2) = (a1·a2, a2·b1 +
b2), where a loop over time would launch S rounds of small kernels. The
combine tree differs from the reference's, so h agrees to f32 rounding,
not bit for bit. Decode is the O(1) per-token update, written INTO the
cache tensors (`copy_`: the state h and the shifted conv history), so a
CUDA graph replayed against static buffers carries its state. The GELU is
the tanh form (`jax.nn.gelu`'s default), softplus `logaddexp(x, 0)`.

Plain PyTorch throughout, as the reference's is plain jnp: `in_gelu`,
`in_rec` and `out` are plain matmuls, never SpAMM-gated. Gate matrices are
block-diagonal (16 blocks), as in Griffin.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import RGLRUConfig
from repro_torch.models.layers import _gelu, _normal
from repro_torch.models.ssm import _causal_conv, _conv_step, _uniform, softplus

_NUM_BLOCKS = 16


def rglru_params(gen: torch.Generator, cfg: RGLRUConfig, d_model: int,
                 dtype, device) -> dict:
    """The reference's distributions from `gen` (the numbers differ)."""
    w = cfg.lru_width or d_model
    nb = _NUM_BLOCKS
    f32 = dict(dtype=torch.float32, device=device)
    s_d = 1.0 / math.sqrt(d_model)
    s_b = 1.0 / math.sqrt(w // nb)
    # Λ init so that a^c = exp(-c·softplus(Λ)) ∈ [0.9, 0.999] at r=1
    lo, hi = 0.9, 0.999
    u = _uniform(gen, (w,), lo ** 2, hi ** 2, device)
    lam = torch.log(torch.expm1(-torch.log(u) / (2 * cfg.c_exponent)))
    return {
        "in_gelu": _normal(gen, (d_model, w), s_d, dtype, device),
        "in_rec": _normal(gen, (d_model, w), s_d, dtype, device),
        "conv": _normal(gen, (cfg.conv_dim, w), 0.1, dtype, device),
        "conv_bias": torch.zeros(w, **f32),
        "wa": _normal(gen, (nb, w // nb, w // nb), s_b, torch.float32,
                      device),
        "ba": torch.zeros(w, **f32),
        "wx": _normal(gen, (nb, w // nb, w // nb), s_b, torch.float32,
                      device),
        "bx": torch.zeros(w, **f32),
        "lam": lam,
        "out": _normal(gen, (w, d_model), 1.0 / math.sqrt(w), dtype, device),
    }


def _block_diag(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                ) -> torch.Tensor:
    """x: (..., W); w: (nb, W/nb, W/nb)."""
    nb, bw, _ = w.shape
    xs = x.reshape(*x.shape[:-1], nb, bw)
    out = torch.einsum("...nh,nhk->...nk", xs.float(), w)
    return out.reshape(x.shape) + b


def _gates(params: dict, x: torch.Tensor):
    r = torch.sigmoid(_block_diag(x, params["wa"], params["ba"]))
    i = torch.sigmoid(_block_diag(x, params["wx"], params["bx"]))
    return r, i


def _log_a(params: dict, r: torch.Tensor, c: float) -> torch.Tensor:
    return -c * softplus(params["lam"]) * r  # (..., W) ≤ 0


def _input_scale(log_a: torch.Tensor) -> torch.Tensor:
    """sqrt(1 − a²), floored at 1e-12 under the root."""
    return torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t · h_{t-1} + b_t over dim 1 from h_{-1} = 0: Hillis–Steele,
    each round composing every element with the one `d` steps before it."""
    s, d = a.shape[1], 1
    while d < s:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_scan(params: dict, x: torch.Tensor, cfg: RGLRUConfig,
               init_h=None):
    """x: (B, S, W) post-conv inputs. Returns (y, final h (B, W) f32)."""
    r, i = _gates(params, x)
    log_a = _log_a(params, r, cfg.c_exponent)
    a = torch.exp(log_a)
    gated = _input_scale(log_a) * (i * x.float())
    if init_h is not None:
        # fold the carried state in as a virtual step 0 input
        gated = torch.cat([gated[:, :1] + a[:, :1] * init_h[:, None],
                           gated[:, 1:]], dim=1)
    h = _linear_scan(a, gated)
    return h.to(x.dtype), h[:, -1, :]


def rglru_block(params: dict, x: torch.Tensor, cfg: RGLRUConfig):
    """The recurrent block over x (B, S, d) (prefill) → (y, cache {"h"
    (B, W) f32, "conv" (B, K-1, W)})."""
    cdt = x.dtype
    gate = _gelu(x @ params["in_gelu"].to(cdt))
    rec = x @ params["in_rec"].to(cdt)
    conv_cache = rec[:, -(cfg.conv_dim - 1):, :]
    rec = _causal_conv(rec, params["conv"].to(cdt), params["conv_bias"])
    y, h = rglru_scan(params, rec, cfg)
    out = (gate * y) @ params["out"].to(cdt)
    return out, {"h": h, "conv": conv_cache}


def rglru_decode_step(params: dict, x: torch.Tensor, cache: dict,
                      cfg: RGLRUConfig):
    """One token x (B, d) against cache {"h" (B, W) f32, "conv" (B, K-1,
    W)}, both updated in place. Returns (y (B, d), cache)."""
    cdt = x.dtype
    gate = _gelu(x @ params["in_gelu"].to(cdt))
    rec = x @ params["in_rec"].to(cdt)
    hist = torch.cat([cache["conv"], rec[:, None, :]], dim=1)   # (B, K, W)
    conv_out = _conv_step(hist, params["conv"].to(cdt), params["conv_bias"])
    r, i = _gates(params, conv_out)
    log_a = _log_a(params, r, cfg.c_exponent)
    h = (torch.exp(log_a) * cache["h"]
         + _input_scale(log_a) * (i * conv_out.float()))
    out = (gate * h.to(cdt)) @ params["out"].to(cdt)
    cache["h"].copy_(h)
    cache["conv"].copy_(hist[:, 1:, :])     # the reference's hist[:, 1:, :]
    return out, cache
