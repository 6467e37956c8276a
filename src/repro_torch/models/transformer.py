"""Decoder stack of the port (twin of `repro.models.transformer`): one
generic stack for every family.

  dense / vlm / audio : attention + MLP
  moe                 : attention + MoE block (`models/moe.py`)
  ssm                 : Mamba2 block only (`models/ssm.py`)
  hybrid              : n_groups × (rec, rec, local-attn) groups + a rec
                        tail, each sub-layer followed by an MLP (the RG-LRU
                        block is `models/rglru.py`)

Layers are a Python list of per-layer parameter dicts and the stack is a
Python loop (the reference's `lax.scan` over stacked layers). A hybrid
stack is the same flat list in the reference's layer order — group g's
sub-layer i is layer g·3 + i, the tail's layer i is layer n_groups·3 + i —
and each layer's kind comes from the config (`layer_kinds`), not from its
parameters. Frozen plans follow the same structure: `frozen["layers"][l]`
is layer l's {"mix": {...}, "mlp": {...}} dict of FrozenPlans (an SSM layer
has none, a rec layer its MLP's only).

The decode step and the prefill chunk write their K/V into the
preallocated cache IN PLACE (the reference updates a functional copy), and
so do the recurrent layers' decode steps with their state and conv history;
nothing else is mutated. Positions are Python ints or int tensors on the
device, never read on the host, so both steps can be captured in a CUDA
graph (`serving/graphs.py`). Each layer loop labels its gated GEMMs' taps
with the layer index (`SpammContext.set_layer`, a Python int, so a capture
records it as a host value) and each GEMM names its site ("wq", "wk",
"wv", "wo"). A MoE block's taps carry layer -1, as the reference's do
(its label is cleared for the block). Per-row positions at or past the
cache length are sentinels whose writes drop, as the reference's
`.at[].set(mode="drop")` does (`_row_writes`). Chunked prefill takes
attention stacks only, as the reference's does. `stack_fwd` is the
training stack: no caches, each layer under the config's remat, the MoE
aux losses summed and the gating stats collected once per forward.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core.module import SpammContext, maybe_spamm_matmul
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (_normal, apply_rope, mlp, mlp_params,
                                       rms_norm)


def attn_params(gen: torch.Generator, cfg: ModelConfig, dtype,
                device) -> dict:
    d, hq, hk = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    s = 1.0 / math.sqrt(d)
    p = {
        "wq": _normal(gen, (d, hq * hd), s, dtype, device),
        "wk": _normal(gen, (d, hk * hd), s, dtype, device),
        "wv": _normal(gen, (d, hk * hd), s, dtype, device),
        "wo": _normal(gen, (hq * hd, d), 1.0 / math.sqrt(hq * hd), dtype,
                      device),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", hq * hd), ("bk", hk * hd), ("bv", hk * hd)):
            p[name] = torch.zeros(width, dtype=torch.float32, device=device)
    return p


def _qkv(p, x, cfg: ModelConfig, positions, spamm_cfg=None, frozen=None,
         require_frozen: bool = False):
    b, s, _ = x.shape
    hq, hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    cdt = x.dtype
    fz = frozen or {}
    q, k, v = (maybe_spamm_matmul(x, p[name].to(cdt), spamm_cfg,
                                  frozen=fz.get(name),
                                  require_frozen=require_frozen, site=name)
               for name in ("wq", "wk", "wv"))
    if "bq" in p:
        q = q + p["bq"].to(cdt)
        k = k + p["bk"].to(cdt)
        v = v + p["bv"].to(cdt)
    q = apply_rope(q.reshape(b, s, hq, hd), positions, cfg.rope_theta)
    k = apply_rope(k.reshape(b, s, hk, hd), positions, cfg.rope_theta)
    return q, k, v.reshape(b, s, hk, hd)


def attention_layer(p: dict, x: torch.Tensor, cfg: ModelConfig,
                    pcfg: ParallelConfig, positions: torch.Tensor, *,
                    window: Optional[int] = None, spamm_cfg=None,
                    return_kv: bool = False, frozen=None):
    q, k, v = _qkv(p, x, cfg, positions, spamm_cfg, frozen)
    o = attn_mod.flash_attention(q, k, v, causal=True, window=window,
                                 q_chunk=pcfg.attn_q_chunk)
    o = o.reshape(*x.shape[:2], -1)
    out = maybe_spamm_matmul(o, p["wo"].to(x.dtype), spamm_cfg,
                             frozen=(frozen or {}).get("wo"), site="wo")
    if return_kv:
        return out, (k, v)
    return out


def _row_writes(positions: torch.Tensor, cache_len: int):
    """Index plan of a per-row scatter at `positions` (B, C) into a (B, S,
    ...) cache with the drop contract: an entry outside [0, S) writes
    nothing. Returns (rows, slots, src, live): entry (b, c) writes the
    value of entry src[b, c] of its row at slots[b, c]. A dropped entry
    repeats its row's first kept entry (the same value at the same slot),
    and a row with no kept entry rewrites slot 0 with the cache's own value
    (`live` False), so every write lands in range and duplicates carry
    identical bits — no out-of-range index, no host read."""
    b, c = positions.shape
    dev = positions.device
    keep = (positions >= 0) & (positions < cache_len)
    first = keep.to(torch.int32).argmax(dim=1, keepdim=True)
    src = torch.where(keep, torch.arange(c, device=dev)[None], first)
    live = keep.any(dim=1)
    slots = torch.where(live[:, None], positions.long().gather(1, src), 0)
    rows = torch.arange(b, device=dev)[:, None].expand(b, c)
    return rows, slots, src, live


def _scatter_rows(cache: torch.Tensor, plan, vals: torch.Tensor):
    """cache[b, slots[b, c]] = vals[b, src[b, c]] in place (`_row_writes`):
    vals (B, C, Hk, hd)."""
    rows, slots, src, live = plan
    v = vals.to(cache.dtype).gather(
        1, src[:, :, None, None].expand(-1, -1, *vals.shape[2:]))
    v = torch.where(live[:, None, None, None], v, cache[:, :1])
    cache.index_put_((rows, slots), v)


def attention_decode(p: dict, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos, cfg: ModelConfig,
                     pcfg: ParallelConfig, *, window: Optional[int] = None,
                     ring: bool = False, spamm_cfg=None, frozen=None):
    """One decode step for x (B, 1, d). `pos` is the incoming token's
    position: a Python int or a 0-d int tensor (lockstep: every row at one
    position; a ring cache takes it modulo its length), or a (B,) int
    tensor of per-row positions (the chunked plane's slots), whose entries
    ≥ the cache length are idle-slot sentinels: their writes drop and their
    outputs are garbage the caller discards. Per-row positions need a
    LINEAR full-length cache and never take the ring modulo, which would
    wrap a sentinel onto slot 0 and clobber a prefilling lane's K/V. The
    cache is written in place. Decode gates only through frozen plans
    (require_frozen)."""
    del pcfg
    b = x.shape[0]
    hq, hd = cfg.num_heads, cfg.resolved_head_dim
    s = cache_k.shape[1]
    if not isinstance(pos, torch.Tensor):
        pos = torch.full((), pos, dtype=torch.int32, device=x.device)
    posb = pos.reshape(b, 1) if pos.dim() else pos.reshape(1, 1).expand(b, 1)
    q, k, v = _qkv(p, x, cfg, posb, spamm_cfg, frozen, require_frozen=True)
    if pos.dim() == 0:
        slot = (torch.remainder(pos, s) if ring else pos).reshape(1).long()
        cache_k.index_copy_(1, slot, k.to(cache_k.dtype))
        cache_v.index_copy_(1, slot, v.to(cache_v.dtype))
    else:
        plan = _row_writes(posb, s)
        _scatter_rows(cache_k, plan, k)
        _scatter_rows(cache_v, plan, v)
    o = attn_mod.decode_attention(q[:, 0], cache_k, cache_v, pos + 1,
                                  window=window, ring=ring)
    out = maybe_spamm_matmul(o.reshape(b, 1, hq * hd), p["wo"].to(x.dtype),
                             spamm_cfg, frozen=(frozen or {}).get("wo"),
                             require_frozen=True, site="wo")
    return out, (cache_k, cache_v)


def attention_prefill_chunk(p: dict, x: torch.Tensor, cache_k: torch.Tensor,
                            cache_v: torch.Tensor, positions: torch.Tensor,
                            cfg: ModelConfig, pcfg: ParallelConfig, *,
                            window: Optional[int] = None, spamm_cfg=None,
                            frozen=None):
    """One chunk of position-offset prefill for x (B, C, d) at `positions`
    (B, C) int, absolute per-row token indices; entries ≥ the cache length
    are sentinels whose K/V writes drop and whose rows are garbage the
    caller discards. Projects and ropes the chunk at its positions,
    scatters K/V into the LINEAR cache in place, then attends the chunk's
    queries to the whole cache with a per-row causal bias from
    positions[:, 0]. The port attends all keys in one softmax where the
    reference scans KV blocks, so chunked and one-shot prefill agree to f32
    rounding, not bit for bit."""
    b, c, _ = x.shape
    hq, hd = cfg.num_heads, cfg.resolved_head_dim
    q, k, v = _qkv(p, x, cfg, positions, spamm_cfg, frozen)
    plan = _row_writes(positions, cache_k.shape[1])
    _scatter_rows(cache_k, plan, k)
    _scatter_rows(cache_v, plan, v)
    o = attn_mod.flash_attention(q, cache_k, cache_v, causal=True,
                                 window=window, q_chunk=pcfg.attn_q_chunk,
                                 q_offset=positions[:, 0])
    out = maybe_spamm_matmul(o.reshape(b, c, hq * hd), p["wo"].to(x.dtype),
                             spamm_cfg, frozen=(frozen or {}).get("wo"),
                             site="wo")
    return out, (cache_k, cache_v)


def _tap_ctx(spamm_cfg) -> Optional[SpammContext]:
    """The SpammContext behind what the stack threads, for the layer
    labels (`set_layer`); None when taps cannot be labelled (a raw
    SpammConfig builds a throwaway context per GEMM)."""
    return spamm_cfg if isinstance(spamm_cfg, SpammContext) else None


def stack_kinds(cfg: ModelConfig) -> str:
    if cfg.family == "ssm":
        return "ssm"
    if cfg.family == "hybrid":
        return "hybrid"
    return "attn"


def hybrid_pattern(cfg: ModelConfig):
    """(n_groups, group_kinds, tail_kinds) for the hybrid arch."""
    pat = cfg.rglru.block_pattern  # ("rec", "rec", "attn")
    kinds = {"rec": "rec", "attn": "attn"}
    glen = len(pat)
    n_groups = cfg.num_layers // glen
    tail = cfg.num_layers - n_groups * glen
    return n_groups, tuple(kinds[k] for k in pat), ("rec",) * tail


def group_len(cfg: ModelConfig) -> int:
    """Layers per repeated group: a hybrid stack's block pattern, else 1
    (the reference stacks one group per scan step; `n_groups` whole
    groups, then the tail)."""
    if stack_kinds(cfg) != "hybrid":
        return 1
    return len(cfg.rglru.block_pattern)


def layer_kinds(cfg: ModelConfig) -> tuple:
    """Each layer's kind ("attn" | "rec" | "ssm"), in stack order."""
    kind = stack_kinds(cfg)
    if kind != "hybrid":
        return (kind,) * cfg.num_layers
    n_groups, gkinds, tail = hybrid_pattern(cfg)
    return gkinds * n_groups + tail


def layer_params(gen: torch.Generator, cfg: ModelConfig, dtype, device,
                 kind: str) -> dict:
    f32 = dict(dtype=torch.float32, device=device)
    if kind == "ssm":
        return {"ln": torch.zeros(cfg.d_model, **f32),
                "ssm": ssm_mod.ssm_params(gen, cfg.ssm, cfg.d_model, dtype,
                                          device)}
    p = {
        "ln1": torch.zeros(cfg.d_model, **f32),
        "ln2": torch.zeros(cfg.d_model, **f32),
        "mix": (rglru_mod.rglru_params(gen, cfg.rglru, cfg.d_model, dtype,
                                       device) if kind == "rec"
                else attn_params(gen, cfg, dtype, device)),
    }
    if cfg.moe is not None:
        p["moe"] = moe_mod.moe_params(gen, cfg.moe, cfg.d_model, dtype,
                                      device)
    else:
        p["mlp"] = mlp_params(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype,
                              device)
    return p


def _ffn(p: dict, h: torch.Tensor, cfg: ModelConfig, spamm_cfg, frozen=None,
         require_frozen: bool = False):
    """The MLP or MoE sub-layer on the normalized input h → (out, aux).
    A MoE block gates eagerly (its expert buffers depend on the routing;
    frozen plans cover attention and the dense MLP), with no SpAMM under
    the decode contract (`require_frozen`); its taps report layer -1 and
    stay out of the training stack's trace buffer, as in the reference."""
    if cfg.moe is None:
        return mlp(p["mlp"], h, cfg.act, spamm_cfg, frozen,
                   require_frozen), 0.0
    tctx = _tap_ctx(spamm_cfg)
    if tctx is not None:
        prev = tctx.swap_layer(None)
        buf = tctx.suspend_trace_buffer()
    try:
        return moe_mod.moe_block(
            p["moe"], h, cfg.moe, cfg.act,
            spamm_cfg=None if require_frozen else spamm_cfg)
    finally:
        if tctx is not None:
            tctx.swap_layer(prev)
            tctx.resume_trace_buffer(buf)


def layer_fwd(p: dict, x: torch.Tensor, cfg: ModelConfig,
              pcfg: ParallelConfig, positions: torch.Tensor, kind: str, *,
              spamm_cfg=None, collect_cache: bool = False, frozen=None):
    """One residual layer of kind "attn" | "rec" | "ssm". Returns (x, aux,
    cache or None): aux is the MoE block's load-balancing loss (0.0
    without one)."""
    fz = frozen or {}
    if kind == "ssm":
        h, cache = ssm_mod.ssm_block(p["ssm"],
                                     rms_norm(x, p["ln"], cfg.norm_eps),
                                     cfg.ssm, norm_eps=cfg.norm_eps)
        return x + h, 0.0, (cache if collect_cache else None)
    if kind == "attn":
        h, (k, v) = attention_layer(
            p["mix"], rms_norm(x, p["ln1"], cfg.norm_eps), cfg, pcfg,
            positions, window=cfg.sliding_window, spamm_cfg=spamm_cfg,
            return_kv=True, frozen=fz.get("mix"))
        cache = {"k": k, "v": v}
    else:
        h, cache = rglru_mod.rglru_block(
            p["mix"], rms_norm(x, p["ln1"], cfg.norm_eps), cfg.rglru)
    x = x + h
    f, aux = _ffn(p, rms_norm(x, p["ln2"], cfg.norm_eps), cfg, spamm_cfg,
                  fz.get("mlp"))
    return x + f, aux, (cache if collect_cache else None)


def layer_prefill_chunk(p: dict, x: torch.Tensor, cache: dict,
                        positions: torch.Tensor, cfg: ModelConfig,
                        pcfg: ParallelConfig, *, spamm_cfg=None, frozen=None):
    """One residual layer of chunked prefill: attention writes the chunk's
    K/V into the linear cache at its positions; the FFN is the plain
    prefill body (stateless per position)."""
    fz = frozen or {}
    h, (ck, cv) = attention_prefill_chunk(
        p["mix"], rms_norm(x, p["ln1"], cfg.norm_eps), cache["k"],
        cache["v"], positions, cfg, pcfg, window=cfg.sliding_window,
        spamm_cfg=spamm_cfg, frozen=fz.get("mix"))
    x = x + h
    f, _ = _ffn(p, rms_norm(x, p["ln2"], cfg.norm_eps), cfg, spamm_cfg,
                fz.get("mlp"))
    return x + f, dict(cache, k=ck, v=cv)


def layer_decode(p: dict, x: torch.Tensor, cache: dict, pos,
                 cfg: ModelConfig, pcfg: ParallelConfig, kind: str, *,
                 spamm_cfg=None, frozen=None):
    """One residual decode layer; `pos` as in `attention_decode` (unused
    by the recurrent kinds, whose caches carry their state)."""
    fz = frozen or {}
    if kind == "ssm":
        h, new = ssm_mod.ssm_decode_step(
            p["ssm"], rms_norm(x[:, 0], p["ln"], cfg.norm_eps), cache,
            cfg.ssm, norm_eps=cfg.norm_eps)
        return x + h[:, None], new
    if kind == "attn":
        # ring buffer iff the cache is exactly the sliding window
        ring = (cfg.sliding_window is not None
                and cache["k"].shape[1] <= cfg.sliding_window)
        h, (ck, cv) = attention_decode(
            p["mix"], rms_norm(x, p["ln1"], cfg.norm_eps), cache["k"],
            cache["v"], pos, cfg, pcfg, window=cfg.sliding_window,
            ring=ring, spamm_cfg=spamm_cfg, frozen=fz.get("mix"))
        new = dict(cache, k=ck, v=cv)
    else:
        h1, new = rglru_mod.rglru_decode_step(
            p["mix"], rms_norm(x[:, 0], p["ln1"], cfg.norm_eps), cache,
            cfg.rglru)
        h = h1[:, None]
    x = x + h
    f, _ = _ffn(p, rms_norm(x, p["ln2"], cfg.norm_eps), cfg, spamm_cfg,
                fz.get("mlp"), require_frozen=True)
    return x + f, new


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of remat "dots": keep the outputs of
    matrix products without batch dims (`aten.mm`/`addmm`: x @ w, however
    many leading dims x has), recompute the rest."""
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _remat(fn, pcfg: ParallelConfig):
    """fn under the config's remat: "full" recomputes the whole call in
    backward (`torch.utils.checkpoint`), "dots" keeps the plain matrix
    products' outputs (the nearest PyTorch policy to the reference's
    `checkpoint_dots_with_no_batch_dims`: the gated GEMMs' outputs come
    from the autograd Function's kernels, not `aten.mm`, and are
    recomputed), "none" saves everything."""
    if pcfg.remat == "none":
        return fn
    if pcfg.remat == "full":
        kw = {}
    elif pcfg.remat == "dots":
        kw = {"context_fn": functools.partial(
            create_selective_checkpoint_contexts, _save_dots)}
    else:
        raise ValueError(f"remat={pcfg.remat!r} (none | dots | full)")

    def remat(*args):
        return checkpoint(fn, *args, use_reentrant=False, **kw)

    return remat


def stack_fwd(params: dict, x: torch.Tensor, cfg: ModelConfig,
              pcfg: ParallelConfig, positions: torch.Tensor, *,
              spamm_cfg=None, collect_spamm_stats: bool = False):
    """All layers, the training and loss path (no caches). Returns (x,
    aux), or with `collect_spamm_stats` (x, aux, (frac_sum, gemm_count,
    layer_frac_sums, layer_gemm_counts)): f32 device tensors, the last two
    (num_layers,) in stack order. Each layer runs under `pcfg.remat`.

    The stats come from the context's trace buffer, open only while a
    layer's forward runs: a remat recomputation inside backward taps into
    no buffer, so every gated GEMM counts once, as through the reference's
    scan carry. A MoE block's GEMMs stay out (`_ffn`), as in the
    reference."""
    tctx = _tap_ctx(spamm_cfg)
    collect = collect_spamm_stats and tctx is not None and tctx.enable
    zero = torch.zeros((), dtype=torch.float32, device=x.device)

    def body(p, h, kind):
        h, a, _ = layer_fwd(p, h, cfg, pcfg, positions, kind,
                            spamm_cfg=spamm_cfg)
        return h, a

    layer = _remat(body, pcfg)
    aux = vs = vc = zero
    lvs, lvc = [], []
    for p, kind in zip(params["layers"], layer_kinds(cfg)):
        if collect:
            tctx.begin_trace_buffer()
        try:
            x, a = layer(p, x, kind)
        finally:
            fracs = tctx.drain_trace_buffer() if collect else []
        s = zero
        for f in fracs:
            s = s + f
        c = torch.full((), float(len(fracs)), dtype=torch.float32,
                       device=x.device)
        aux, vs, vc = aux + a, vs + s, vc + c
        lvs.append(s)
        lvc.append(c)
    if collect:
        return x, aux, (vs, vc, torch.stack(lvs), torch.stack(lvc))
    return x, aux


def stack_prefill(params: dict, x: torch.Tensor, cfg: ModelConfig,
                  pcfg: ParallelConfig, positions: torch.Tensor,
                  cache_len: int, *, spamm_cfg=None, frozen=None):
    """Forward + collect caches. Returns (x, {"layers": [cache per layer]}).
    Sliding-window caches keep their last `cache_len` tokens as a ring
    (token t at slot t % W)."""
    s = x.shape[1]
    fz_layers = (frozen or {}).get("layers")
    tctx = _tap_ctx(spamm_cfg)
    caches = []
    try:
        for li, (p, kind) in enumerate(zip(params["layers"],
                                           layer_kinds(cfg))):
            if tctx is not None:
                tctx.set_layer(li)
            x, _, c = layer_fwd(p, x, cfg, pcfg, positions, kind,
                                spamm_cfg=spamm_cfg, collect_cache=True,
                                frozen=fz_layers[li] if fz_layers else None)
            if kind == "attn" and c["k"].shape[1] > cache_len:
                shift = s % cache_len
                c = {n: torch.roll(c[n][:, -cache_len:], shift, dims=1)
                     for n in ("k", "v")}
            caches.append(c)
    finally:
        if tctx is not None:
            tctx.set_layer(None)
    return x, {"layers": caches}


def stack_prefill_chunk(params: dict, x: torch.Tensor, cache: dict,
                        positions: torch.Tensor, cfg: ModelConfig,
                        pcfg: ParallelConfig, *, spamm_cfg=None,
                        frozen=None):
    """Chunked prefill over the stack at ONE static (B, C) shape, wherever
    in the prompt the chunk lands: each layer writes the chunk's K/V into
    its linear cache at `positions` (B, C), in place. Attention stacks
    only: recurrent prefill state does not checkpoint at a chunk
    boundary."""
    kind = stack_kinds(cfg)
    if kind != "attn":
        raise NotImplementedError(
            f"chunked prefill covers stateless-FFN attention stacks only "
            f"(got stack kind {kind!r}: recurrent prefill state does not "
            f"checkpoint at a chunk boundary)")
    fz_layers = (frozen or {}).get("layers")
    tctx = _tap_ctx(spamm_cfg)
    caches = []
    try:
        for li, (p, c) in enumerate(zip(params["layers"], cache["layers"])):
            if tctx is not None:
                tctx.set_layer(li)
            x, nc = layer_prefill_chunk(
                p, x, c, positions, cfg, pcfg, spamm_cfg=spamm_cfg,
                frozen=fz_layers[li] if fz_layers else None)
            caches.append(nc)
    finally:
        if tctx is not None:
            tctx.set_layer(None)
    return x, {"layers": caches}


def stack_decode(params: dict, x: torch.Tensor, cache: dict, pos,
                 cfg: ModelConfig, pcfg: ParallelConfig, *, spamm_cfg=None,
                 frozen=None):
    """One decode step over the stack; `pos` as in `attention_decode` (an
    int, a 0-d tensor, or a (B,) tensor of per-row positions). Gated sites
    need a FrozenPlan; sites without one stay dense (require_frozen in
    `layer_decode`)."""
    fz_layers = (frozen or {}).get("layers")
    tctx = _tap_ctx(spamm_cfg)
    caches = []
    try:
        for li, (p, c, kind) in enumerate(zip(params["layers"],
                                              cache["layers"],
                                              layer_kinds(cfg))):
            if tctx is not None:
                tctx.set_layer(li)
            x, nc = layer_decode(p, x, c, pos, cfg, pcfg, kind,
                                 spamm_cfg=spamm_cfg,
                                 frozen=fz_layers[li] if fz_layers else None)
            caches.append(nc)
    finally:
        if tctx is not None:
            tctx.set_layer(None)
    return x, {"layers": caches}
