"""Mixture-of-Experts block of the port (twin of `repro.models.moe`), on one
device.

The reference runs the block as a shard_map over a (data, model) mesh with
two strategies: `impl="tp"` (every chip holds all experts, ff sharded) and
`impl="ep"` (experts sharded over `model`). On one device both compute the
same function: every expert is owned, the expert axis is not padded past
the experts the parameters hold, and the model-axis psum is the identity.
`moe_block` is that one-device body (the reference's `local`), for either
`impl`; the split across cards waits for the multi-GPU slice.

Dispatch is sort-based, as in the reference: the top-k assignments are
sorted by expert (stable), each assignment's slot within its expert comes
from a searchsorted over the sorted ids, and assignments past the
capacity drop. Every step is a device op with shapes fixed by the token
count, so a decode step that holds the block captures into a CUDA graph:

* the reference's scatter with `mode="drop"` becomes a scatter into an
  (E, C + 1, d) buffer whose extra row takes every dropped assignment, then
  sliced to (E, C, d). A dropped row is never clamped onto a real slot,
  where it would overwrite the token that owns it;
* the reference's combine `y.at[st].add(...)` runs its updates in sorted
  order, so each token gets its k contributions in ascending expert order.
  The port gathers them back per token (T, k, d) in that order and adds
  them in a fixed sequence from zero: no float atomics, so a graphed step
  and an eager one give the same bits.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.core.module import (as_context, maybe_spamm_matmul,
                                     spamm_bmm_linear)
from repro_torch.models.layers import _gelu, _normal


def moe_params(gen: torch.Generator, cfg: MoEConfig, d_model: int, dtype,
               device) -> dict:
    """The reference's `moe_params` tree at one model shard: router (d, E)
    f32, w1/w3 (E, d, ff), w2 (E, ff, d) and, with shared experts,
    shared.{w1, w3 (d, sff), w2 (sff, d), gate (d, 1) f32}."""
    e, ff = cfg.num_experts, cfg.expert_ff
    s_in, s_ff = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(ff)
    p = {
        "router": _normal(gen, (d_model, e), s_in, torch.float32, device),
        "w1": _normal(gen, (e, d_model, ff), s_in, dtype, device),
        "w3": _normal(gen, (e, d_model, ff), s_in, dtype, device),
        "w2": _normal(gen, (e, ff, d_model), s_ff, dtype, device),
    }
    if cfg.num_shared:
        sff = cfg.shared_ff
        p["shared"] = {
            "w1": _normal(gen, (d_model, sff), s_in, dtype, device),
            "w3": _normal(gen, (d_model, sff), s_in, dtype, device),
            "w2": _normal(gen, (sff, d_model), 1.0 / math.sqrt(sff), dtype,
                          device),
            "gate": _normal(gen, (d_model, 1), s_in, torch.float32, device),
        }
    return p


def capacity(tokens: int, cfg: MoEConfig) -> int:
    """Slots per expert for a step of `tokens` tokens: ⌈t·k/E·cf⌉ rounded up
    to a multiple of 4, at least 4 (a Python int per step shape)."""
    c = int(math.ceil(tokens * cfg.top_k / cfg.num_experts
                      * cfg.capacity_factor))
    return max(4, -(-c // 4) * 4)


def _dispatch(x: torch.Tensor, router_w: torch.Tensor, cfg: MoEConfig,
              cap: int):
    """Sort-based dispatch of x (T, d). Returns (se, st, sg, pos, keep,
    aux): the assignments sorted by expert (expert, token, gate), each one's
    slot within its expert, whether that slot is under the capacity, and
    the switch load-balance loss E·Σ_e f_e·P_e."""
    t = x.shape[0]
    k, e = cfg.top_k, cfg.num_experts
    dev = x.device
    logits = x.float() @ router_w                                  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.topk(probs, k, dim=-1, sorted=True)        # (T, k)
    gates = gates / gates.sum(dim=-1, keepdim=True)

    flat_e = eidx.reshape(-1).to(torch.int32)
    flat_t = torch.arange(t * k, dtype=torch.int32, device=dev) // k
    flat_g = gates.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, st, sg = flat_e[order], flat_t[order], flat_g[order]
    starts = torch.searchsorted(
        se, torch.arange(e, dtype=torch.int32, device=dev), side="left")
    pos = (torch.arange(t * k, dtype=torch.int32, device=dev)
           - starts[se.long()].to(torch.int32))
    keep = pos < cap

    # the one-hot mean of the reference as a comparison (F.one_hot checks
    # its input's range on the host)
    first = eidx[:, :1] == torch.arange(e, device=dev)
    f = first.float().mean(dim=0)
    aux = e * (f * probs.mean(dim=0)).sum()
    return se, st, sg, pos, keep, aux


def _act(g: torch.Tensor, act: str) -> torch.Tensor:
    return F.silu(g) if act == "silu" else _gelu(g)


def _grouped_ffn(buf: torch.Tensor, w1, w3, w2, act: str, spamm_cfg):
    """buf (E, C, d) → (E, C, d) through each expert's SwiGLU. With SpAMM
    on and `moe_bmm`, the three GEMMs are batched gated GEMMs
    (`spamm_bmm_linear`: one dense-grid launch over all experts each);
    with SpAMM on otherwise, each expert's GEMMs gate one by one through
    `maybe_spamm_matmul` (the reference's `jax.vmap(one)`, whose taps fire
    once per expert: all experts' w1, then w3, then w2, as here); with
    SpAMM off, batched dense products."""
    cdt = buf.dtype
    ctx = as_context(spamm_cfg)
    w1, w3, w2 = w1.to(cdt), w3.to(cdt), w2.to(cdt)
    if ctx is None or not ctx.enable:
        return torch.bmm(_act(torch.bmm(buf, w1), act) * torch.bmm(buf, w3),
                         w2)
    if ctx.cfg.moe_bmm:
        g = spamm_bmm_linear(buf, w1, ctx)
        u = spamm_bmm_linear(buf, w3, ctx)
        return spamm_bmm_linear(_act(g, act) * u, w2, ctx)
    experts = range(buf.shape[0])
    g = [maybe_spamm_matmul(buf[i], w1[i], ctx) for i in experts]
    u = [maybe_spamm_matmul(buf[i], w3[i], ctx) for i in experts]
    return torch.stack([maybe_spamm_matmul(_act(g[i], act) * u[i], w2[i],
                                           ctx) for i in experts])


def _shared_ffn(params: dict, x: torch.Tensor, act: str, spamm_cfg):
    cdt = x.dtype
    g = maybe_spamm_matmul(x, params["w1"].to(cdt), spamm_cfg)
    u = maybe_spamm_matmul(x, params["w3"].to(cdt), spamm_cfg)
    out = maybe_spamm_matmul(_act(g, act) * u, params["w2"].to(cdt),
                             spamm_cfg)
    gate = torch.sigmoid(x.float() @ params["gate"])
    return out * gate.to(cdt)


def moe_block(params: dict, x: torch.Tensor, cfg: MoEConfig, act: str, *,
              spamm_cfg=None):
    """x (B, S, d) → (y (B, S, d), aux). The reference's `local` body on
    one device, for `impl` "tp" and "ep" alike; the capacity is reckoned
    from the step's B·S tokens."""
    b, s, d = x.shape
    cdt = x.dtype
    xt = x.reshape(b * s, d)
    t, k = xt.shape[0], cfg.top_k
    cap = capacity(t, cfg)
    e_pad = params["w1"].shape[0]
    se, st, sg, pos, keep, aux = _dispatch(xt, params["router"], cfg, cap)
    se_l, st_l = se.long(), st.long()

    # scatter: dropped assignments land in the spill row `cap`
    buf = torch.zeros((e_pad, cap + 1, d), dtype=cdt, device=x.device)
    slot = torch.where(keep, pos, cap).long()
    buf.index_put_((se_l, slot), xt[st_l])
    out = _grouped_ffn(buf[:, :cap], params["w1"], params["w3"],
                       params["w2"], act, spamm_cfg)

    # combine: each sorted assignment's weighted row (0 when dropped), then
    # per token its k rows in sorted (ascending expert) order — a stable
    # sort of the sorted assignments by token — added from 0
    contrib = (out[se_l, torch.clamp(pos, max=cap - 1).long()].float()
               * (sg * keep.float())[:, None])
    per_token = contrib[torch.argsort(st, stable=True).reshape(t, k)]
    y = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    for j in range(k):
        y = y + per_token[:, j]

    if "shared" in params:
        y = y + _shared_ffn(params["shared"], xt, act, spamm_cfg).float()
    return y.reshape(b, s, d).to(cdt), aux
