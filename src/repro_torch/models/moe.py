"""Mixture-of-Experts block of the port (twin of `repro.models.moe`).

The reference runs the block as a shard_map over a (data, model) mesh with
two strategies, and so does the port over a `DeviceMesh` (`ctx`):

* impl="tp": every model rank holds all experts with their ff cut over
  "model" (w1/w3 columns, w2 rows); its partial outputs are summed over
  "model" in f32;
* impl="ep": the experts, padded to a multiple of the model axis
  (`moe_params(model_axis_size=)`), are cut over "model"; a rank computes
  its own experts, an assignment to another rank's expert goes to the
  spill row like a dropped one, and the disjoint contributions are summed
  over "model".

The shared expert is column- and row-parallel in both, its partials summed
apart, as in the reference. Tokens stay on their data rank: the capacity is
reckoned from the rank's own B·S tokens (the reference's global count over
the data shards). On one device (`ctx=None`) both strategies compute the
same function: every expert is owned and the model-axis sum is the
identity. A cut that is not even, or not whole tiles (`ctx.tile`), runs the
block whole on every model rank. Over a model axis the gated GEMMs tap
what the block on one device taps: the split ones the whole product's
fraction (`parallel.split_matmul`, `parallel.split_bmm`), and under EP
each expert's fractions, gathered from its rank, in the global expert
order.

Dispatch is sort-based, as in the reference: the top-k assignments are
sorted by expert (stable), each assignment's slot within its expert comes
from a searchsorted over the sorted ids, and assignments past the
capacity drop. Every step is a device op with shapes fixed by the token
count, so a decode step that holds the block captures into a CUDA graph:

* the reference's scatter with `mode="drop"` becomes a scatter into an
  (E, C + 1, d) buffer whose extra row takes every dropped assignment, then
  sliced to (E, C, d) (under EP an extra expert row takes the other ranks'
  assignments). A dropped row is never clamped onto a real slot, where it
  would overwrite the token that owns it;
* the reference's combine `y.at[st].add(...)` runs its updates in sorted
  order, so each token gets its k contributions in ascending expert order.
  The port gathers them back per token (T, k, d) in that order and adds
  them in a fixed sequence from zero: no float atomics, so a graphed step
  and an eager one give the same bits.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.core.module import (as_context, maybe_spamm_matmul,
                                     spamm_bmm_linear)
from repro_torch.models import parallel as par
from repro_torch.models.layers import _gelu, _normal


def padded_experts(cfg: MoEConfig, model_axis_size: int = 1) -> int:
    """The expert count the parameters hold: EP pads it to a multiple of
    the model axis, as the reference's `moe_params`."""
    e = cfg.num_experts
    if cfg.impl == "ep":
        e = math.ceil(e / model_axis_size) * model_axis_size
    return e


def moe_params(gen: torch.Generator, cfg: MoEConfig, d_model: int, dtype,
               device, model_axis_size: int = 1) -> dict:
    """The reference's `moe_params` tree: router (d, E) f32, w1/w3 (E', d,
    ff), w2 (E', ff, d) with E' the experts padded for EP
    (`padded_experts`), and, with shared experts, shared.{w1, w3 (d, sff),
    w2 (sff, d), gate (d, 1) f32}."""
    e, ff = cfg.num_experts, cfg.expert_ff
    e_pad = padded_experts(cfg, model_axis_size)
    s_in, s_ff = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(ff)
    p = {
        "router": _normal(gen, (d_model, e), s_in, torch.float32, device),
        "w1": _normal(gen, (e_pad, d_model, ff), s_in, dtype, device),
        "w3": _normal(gen, (e_pad, d_model, ff), s_in, dtype, device),
        "w2": _normal(gen, (e_pad, ff, d_model), s_ff, dtype, device),
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


def _grouped_ffn(buf: torch.Tensor, w1, w3, w2, act: str, spamm_cfg,
                 mm=maybe_spamm_matmul, bmm=spamm_bmm_linear):
    """buf (E, C, d) → (E, C, d) through each expert's SwiGLU. With SpAMM
    on and `moe_bmm`, the three GEMMs are batched gated GEMMs
    (`bmm`, `spamm_bmm_linear`: one dense-grid launch over all experts
    each); with SpAMM on otherwise, each expert's GEMMs gate one by one
    through `mm`, `maybe_spamm_matmul` (the reference's `jax.vmap(one)`,
    whose taps fire once per expert: all experts' w1, then w3, then w2, as
    here); with SpAMM off, batched dense products. Over a model axis `mm`
    and `bmm` are the split GEMMs that tap the whole product's fraction
    (`_moe_split`)."""
    cdt = buf.dtype
    ctx = as_context(spamm_cfg)
    w1, w3, w2 = w1.to(cdt), w3.to(cdt), w2.to(cdt)
    if ctx is None or not ctx.enable:
        return torch.bmm(_act(torch.bmm(buf, w1), act) * torch.bmm(buf, w3),
                         w2)
    if ctx.cfg.moe_bmm:
        g = bmm(buf, w1, ctx)
        u = bmm(buf, w3, ctx)
        return bmm(_act(g, act) * u, w2, ctx)
    experts = range(buf.shape[0])
    g = [mm(buf[i], w1[i], ctx) for i in experts]
    u = [mm(buf[i], w3[i], ctx) for i in experts]
    return torch.stack([mm(_act(g[i], act) * u[i], w2[i], ctx)
                        for i in experts])


def _shared_ffn(params: dict, x: torch.Tensor, act: str, spamm_cfg,
                mm=maybe_spamm_matmul):
    cdt = x.dtype
    g = mm(x, params["w1"].to(cdt), spamm_cfg)
    u = mm(x, params["w3"].to(cdt), spamm_cfg)
    out = mm(_act(g, act) * u, params["w2"].to(cdt), spamm_cfg)
    gate = torch.sigmoid(x.float() @ params["gate"])
    return out * gate.to(cdt)


def _combine(out, rows, pos, weight, st, t: int, k: int, cap: int):
    """y (T, d) f32: each sorted assignment's output row out[rows, pos]
    times its weight (0 when dropped), then per token its k rows in sorted
    (ascending expert) order — a stable sort of the sorted assignments by
    token — added from 0."""
    contrib = (out[rows, torch.clamp(pos, max=cap - 1).long()].float()
               * weight[:, None])
    per_token = contrib[torch.argsort(st, stable=True).reshape(t, k)]
    y = torch.zeros((t, out.shape[-1]), dtype=torch.float32,
                    device=out.device)
    for j in range(k):
        y = y + per_token[:, j]
    return y


def _moe_local(params: dict, x: torch.Tensor, cfg: MoEConfig, act: str,
               spamm_cfg):
    """The reference's `local` body with every expert owned."""
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
    y = _combine(out, se_l, pos, sg * keep.float(), st, t, k, cap)
    if "shared" in params:
        y = y + _shared_ffn(params["shared"], xt, act, spamm_cfg).float()
    return y.reshape(b, s, d).to(cdt), aux


def _ep_experts(buf, w, act, sctx, ctx):
    """`_grouped_ffn` of this rank's experts under EP, tapping as the
    whole block does: with `moe_bmm` the batch's fraction over every
    expert; otherwise each expert's three fractions, every rank's
    gathered and tapped in the global expert order (all w1, then w3, then
    w2)."""
    if sctx.cfg.moe_bmm:
        return _grouped_ffn(buf, w["w1"], w["w3"], w["w2"], act, sctx,
                            bmm=functools.partial(par.split_bmm, ctx=ctx))
    with sctx.record() as taps:
        out = _grouped_ffn(buf, w["w1"], w["w3"], w["w2"], act, sctx)
    mine = torch.stack([torch.as_tensor(v).detach().float().reshape(())
                        for _, v, _ in taps])
    every = par._gather_dim(mine[None], ctx.group(ctx.model_axis), 0)
    e_loc = buf.shape[0]
    for v in every.reshape(-1, 3, e_loc).transpose(0, 1).reshape(-1):
        sctx.tap(v)
    return out


def _moe_split(params: dict, spec, x: torch.Tensor, cfg: MoEConfig,
               act: str, spamm_cfg, ctx):
    """The block over a model axis (`moe_block`), or None when its cut does
    not split evenly into whole tiles."""
    m, r = ctx.nmodel, ctx.mrank
    mg = ctx.group(ctx.model_axis)
    if cfg.impl == "ep":
        e_pad = par.full_shape(params["w1"], spec["w1"], ctx)[0]
        if e_pad % m:
            return None
        e_loc = e_pad // m
        cut = (r * e_loc, (r + 1) * e_loc)
        dims = {"w1": 0, "w3": 0, "w2": 0}
    else:
        cut = par.ff_split(cfg.expert_ff, ctx, ctx.tile)
        if cut is None:
            return None
        dims = {"w1": 2, "w3": 2, "w2": 1}
    shared_cut = (par.ff_split(cfg.shared_ff, ctx, ctx.tile)
                  if "shared" in params else None)
    if "shared" in params and shared_cut is None:
        return None
    w = {n: par.model_slice(params[n], spec[n], ctx, dims[n], *cut)
         for n in dims}
    router = par.full_weight(params["router"], spec["router"], ctx)
    # the gated GEMMs tap the fraction of the whole block's product
    sctx = as_context(spamm_cfg)
    gated = sctx is not None and sctx.enable
    mm = functools.partial(par.split_matmul, ctx=ctx)

    b, s, d = x.shape
    cdt = x.dtype
    xt = x.reshape(b * s, d)
    t, k = xt.shape[0], cfg.top_k
    cap = capacity(t, cfg)
    se, st, sg, pos, keep, aux = _dispatch(xt, router, cfg, cap)
    xe = par.enter(xt, mg)            # each rank computes its own part
    sg = par.enter(sg, mg)
    st_l = st.long()
    slot = torch.where(keep, pos, cap).long()
    if cfg.impl == "ep":
        e_loc = cut[1] - cut[0]
        le = se.long() - cut[0]
        owned = (le >= 0) & (le < e_loc)
        # other ranks' experts go to the spill expert row e_loc
        buf = torch.zeros((e_loc + 1, cap + 1, d), dtype=cdt,
                          device=x.device)
        buf.index_put_((torch.where(owned, le, e_loc), slot), xe[st_l])
        out = (_ep_experts(buf[:e_loc, :cap], w, act, sctx, ctx) if gated
               else _grouped_ffn(buf[:e_loc, :cap], w["w1"], w["w3"],
                                 w["w2"], act, spamm_cfg))
        rows = torch.clamp(le, 0, e_loc - 1)
        weight = sg * (owned & keep).float()
    else:
        e_pad = params["w1"].shape[0]
        buf = torch.zeros((e_pad, cap + 1, d), dtype=cdt, device=x.device)
        buf.index_put_((se.long(), slot), xe[st_l])
        out = _grouped_ffn(buf[:, :cap], w["w1"], w["w3"], w["w2"], act,
                           spamm_cfg, mm=mm,
                           bmm=functools.partial(par.split_bmm, ctx=ctx))
        rows = se.long()
        weight = sg * keep.float()
    y = par.leave(_combine(out, rows, pos, weight, st, t, k, cap), mg)
    if "shared" in params:
        sp_ = spec["shared"]
        sdims = {"w1": 1, "w3": 1, "w2": 0}
        ws = {n: par.model_slice(params["shared"][n], sp_[n], ctx, sdims[n],
                                 *shared_cut) for n in sdims}
        # the gate scales each rank's partial: its gradient is the ranks'
        ws["gate"] = par.enter(par.full_weight(params["shared"]["gate"],
                                               sp_["gate"], ctx), mg)
        ysh = _shared_ffn(ws, xe, act, spamm_cfg, mm=mm).float()
        y = y + par.leave(ysh, mg)
    return y.reshape(b, s, d).to(cdt), aux


def moe_block(params: dict, x: torch.Tensor, cfg: MoEConfig, act: str, *,
              spamm_cfg=None, ctx=None, spec=None, sp: bool = False):
    """x (B, S, d) → (y (B, S, d), aux): this rank's tokens through the
    block, the capacity reckoned from its own B·S tokens, aux its switch
    loss (the caller averages it over the data ranks). Over a mesh
    (`ctx`, the block's placements `spec`) the experts (ep) or their ff
    (tp) split over "model"; `sp`: x and y are the rank's sequence
    chunk."""
    if ctx is None or spec is None:
        return _moe_local(params, x, cfg, act, spamm_cfg)
    mg = ctx.group(ctx.model_axis)
    if sp:
        x = par.gather(x, mg, 1, "slice")
    out = (_moe_split(params, spec, x, cfg, act, spamm_cfg, ctx)
           if ctx.nmodel > 1 else None)
    if out is None:
        out = _moe_local(par.full_tree(params, spec, ctx), x, cfg, act,
                         spamm_cfg)
    y, aux = out
    if sp:
        y = par.scatter(y, mg, 1)
    return y, aux
