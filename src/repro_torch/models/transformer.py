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

Over a (data, model) mesh every function takes a `NetCtx` (`ctx=None` is
one device): each rank holds its batch rows and its parameter shards
(`ctx.specs`, from `models.model.placements`). An attention layer splits
its q heads over "model" (column-parallel wq/wk/wv, row-parallel wo) and
an MLP its ff; their partial outputs are all-reduced over "model", or under
`seq_shard_acts` reduce-scattered onto the rank's sequence chunk
(Megatron-SP), and FSDP shards are all-gathered over "data" before use
(`models.parallel`). A layer whose heads or ff do not cut into whole
tiles, and every recurrent block, runs whole on each model rank from
gathered weights. Decode under `decode_seq_shard` keeps each rank's
sequence slice of the cache and merges the slices' softmax partials
(`attention.decode_attention_seqsharded`).
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
from repro_torch.core.distributed import _axis
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import parallel as par
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (_normal, apply_rope, mlp, mlp_params,
                                       rms_norm)


class NetCtx:
    """Where a step runs: a `DeviceMesh` (None: one device), its batch axes
    and model axis, this rank's size, index and process group per axis,
    the placed parameter specs (`models.model.placements`; needed once the
    mesh has more than one rank) and the tile the model cuts align to (the
    SpAMM tile)."""

    def __init__(self, mesh=None, batch_axes=("data",), model_axis="model",
                 specs=None, tile: int = 64):
        self.mesh = mesh
        self.model_axis = model_axis
        self.specs = specs
        self.tile = int(tile)
        self._axes = {}
        if mesh is not None:
            for name in mesh.mesh_dim_names:
                self._axes[name] = _axis(mesh, name)
        self.batch_axes = tuple(a for a in batch_axes if a in self._axes)

    def replace(self, **kw) -> "NetCtx":
        args = dict(mesh=self.mesh, batch_axes=self.batch_axes,
                    model_axis=self.model_axis, specs=self.specs,
                    tile=self.tile)
        args.update(kw)
        return NetCtx(**args)

    def size(self, axis: str) -> int:
        return self._axes[axis][0] if axis in self._axes else 1

    def index(self, axis: str) -> int:
        return self._axes[axis][1] if axis in self._axes else 0

    def group(self, axis: str):
        return self._axes[axis][2] if axis in self._axes else None

    @property
    def nmodel(self) -> int:
        return self.size(self.model_axis)

    @property
    def mrank(self) -> int:
        return self.index(self.model_axis)

    @property
    def ndata(self) -> int:
        n = 1
        for a in self.batch_axes:
            n *= self.size(a)
        return n

    @property
    def data_index(self) -> int:
        """This rank's batch shard: row-major over the batch axes."""
        i = 0
        for a in self.batch_axes:
            i = i * self.size(a) + self.index(a)
        return i

    def layer_spec(self, li: int):
        return None if self.specs is None else self.specs["layers"][li]

    def spec(self, *path):
        node = self.specs
        for k in path:
            if node is None:
                return None
            node = node[k]
        return node


def sharded(ctx) -> bool:
    """Whether `ctx` spans more than one rank."""
    return ctx is not None and ctx.mesh is not None and (
        ctx.nmodel > 1 or ctx.ndata > 1)


def _lspec(ctx, li):
    return ctx.layer_spec(li) if sharded(ctx) else None


def seq_sharded(pcfg: ParallelConfig, ctx, s: int) -> bool:
    """Whether the residual stream of an s-token step is cut on the
    sequence over "model" (Megatron-SP)."""
    if not (pcfg.seq_shard_acts and ctx is not None and ctx.nmodel > 1
            and s > 1):
        return False
    if s % ctx.nmodel:
        raise ValueError(f"seq_shard_acts: {s} tokens do not cut over "
                         f"{ctx.nmodel} model ranks")
    return True


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


def attn_weights(p: dict, spec, cfg: ModelConfig, ctx):
    """(the weights this rank's attention computes with, its
    `parallel.AttnSplit` or None): the q heads' columns of wq (and bq),
    the kv columns of wk/wv, the q heads' rows of wo; or every leaf whole
    when the layer does not split over "model"."""
    split = par.attn_split(cfg, ctx, ctx.tile) if sharded(ctx) else None
    if split is None:
        return {n: par.full_weight(t, spec and spec[n], ctx)
                for n, t in p.items()}, None
    q = (split.q0 * split.hd, (split.q0 + split.qh) * split.hd)
    kv = (split.c0, split.c1)
    cut = {"wq": (1, q), "wk": (1, kv), "wv": (1, kv), "wo": (0, q),
           "bq": (0, q), "bk": (0, kv), "bv": (0, kv)}
    return {n: par.model_slice(t, spec[n], ctx, cut[n][0], *cut[n][1])
            for n, t in p.items()}, split


def _mm(split, ctx):
    """The GEMM of a site: `parallel.split_matmul` for a rank's part of a
    GEMM split over "model", else `maybe_spamm_matmul`."""
    if split:
        return functools.partial(par.split_matmul, ctx=ctx)
    return maybe_spamm_matmul


def _qkv(p, x, cfg: ModelConfig, positions, spamm_cfg=None, frozen=None,
         require_frozen: bool = False, split=None, ctx=None):
    """q, k, v of x (B, S, d) at `positions`, roped. Split over "model", q
    holds the rank's heads and k/v the columns it computes (all heads when
    its kv heads are not whole tiles: `_pick_kv` takes the rank's)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    cdt = x.dtype
    fz = frozen or {}
    kv_split = split is not None and split.kv_pick is None
    mms = {"wq": _mm(split, ctx), "wk": _mm(kv_split, ctx),
           "wv": _mm(kv_split, ctx)}
    q, k, v = (mms[name](x, p[name].to(cdt), spamm_cfg, frozen=fz.get(name),
                         require_frozen=require_frozen, site=name)
               for name in ("wq", "wk", "wv"))
    if "bq" in p:
        q = q + p["bq"].to(cdt)
        k = k + p["bk"].to(cdt)
        v = v + p["bv"].to(cdt)
    q = apply_rope(q.reshape(b, s, -1, hd), positions, cfg.rope_theta)
    k = apply_rope(k.reshape(b, s, -1, hd), positions, cfg.rope_theta)
    return q, k, v.reshape(b, s, -1, hd)


def _pick_kv(t: torch.Tensor, split) -> torch.Tensor:
    """The rank's kv heads of a computed K or V (B, S, H, hd)."""
    if split is None or split.kv_pick is None:
        return t
    h0, n = split.kv_pick
    return t[:, :, h0:h0 + n]


def attention_layer(p: dict, x: torch.Tensor, cfg: ModelConfig,
                    pcfg: ParallelConfig, positions: torch.Tensor, *,
                    window: Optional[int] = None, spamm_cfg=None,
                    return_kv: bool = False, frozen=None, ctx=None,
                    spec=None, sp: bool = False):
    """Causal self-attention of x (B, S, d); with `return_kv` also the
    roped K/V (this rank's kv heads under a model split). `sp`: x is the
    rank's sequence chunk (Megatron-SP), and so is the output."""
    w, split = attn_weights(p, spec, cfg, ctx)
    xin = par.block_in(x, ctx, split is not None, sp)
    q, k, v = _qkv(w, xin, cfg, positions, spamm_cfg, frozen, split=split,
                   ctx=ctx)
    k, v = _pick_kv(k, split), _pick_kv(v, split)
    o = attn_mod.flash_attention(q, k, v, causal=True, window=window,
                                 q_chunk=pcfg.attn_q_chunk)
    o = o.reshape(*xin.shape[:2], -1)
    out = _mm(split, ctx)(o, w["wo"].to(x.dtype), spamm_cfg,
                          frozen=(frozen or {}).get("wo"), site="wo")
    out = par.block_out(out, ctx, split is not None, sp)
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
                     ring: bool = False, spamm_cfg=None, frozen=None,
                     ctx=None, spec=None):
    """One decode step for x (B, 1, d). `pos` is the incoming token's
    position: a Python int or a 0-d int tensor (lockstep: every row at one
    position; a ring cache takes it modulo its length), or a (B,) int
    tensor of per-row positions (the chunked plane's slots), whose entries
    ≥ the cache length are idle-slot sentinels: their writes drop and their
    outputs are garbage the caller discards. Per-row positions need a
    LINEAR full-length cache and never take the ring modulo, which would
    wrap a sentinel onto slot 0 and clobber a prefilling lane's K/V. The
    cache is written in place. Decode gates only through frozen plans
    (require_frozen).

    Over more than one model rank with `decode_seq_shard`, the cache is
    this rank's sequence slice of every kv head
    (`attention.decode_attention_seqsharded`), at a lockstep position only
    (a per-row one raises, as in the reference); otherwise a model split
    keeps the rank's kv heads over the whole sequence."""
    b = x.shape[0]
    s = cache_k.shape[1]
    if not isinstance(pos, torch.Tensor):
        pos = torch.full((), pos, dtype=torch.int32, device=x.device)
    seqshard = (pcfg.decode_seq_shard and sharded(ctx) and ctx.nmodel > 1)
    if seqshard and pos.dim():
        raise NotImplementedError(
            "decode_seq_shard expects a lockstep scalar position; per-row "
            "decode positions (chunked serving) need the unsharded decode "
            "path")
    w, split = attn_weights(p, spec, cfg, ctx)
    xin = par.block_in(x, ctx, split is not None, False)
    posb = pos.reshape(b, 1) if pos.dim() else pos.reshape(1, 1).expand(b, 1)
    q, k, v = _qkv(w, xin, cfg, posb, spamm_cfg, frozen,
                   require_frozen=True, split=split, ctx=ctx)
    if seqshard:
        mg = ctx.group(ctx.model_axis)
        if split is not None:
            q = par.gather(q, mg, 2)
            k = par.all_kv_heads(k, split, cfg, ctx)
            v = par.all_kv_heads(v, split, cfg, ctx)
        o, cache_k, cache_v = attn_mod.decode_attention_seqsharded(
            q[:, 0], k, v, cache_k, cache_v, pos + 1, group=mg,
            window=window, ring=ring)
        if split is not None:
            o = o[:, split.q0:split.q0 + split.qh]
    else:
        k, v = _pick_kv(k, split), _pick_kv(v, split)
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
    out = _mm(split, ctx)(o.reshape(b, 1, -1), w["wo"].to(x.dtype),
                          spamm_cfg, frozen=(frozen or {}).get("wo"),
                          require_frozen=True, site="wo")
    return par.block_out(out, ctx, split is not None, False), (cache_k,
                                                               cache_v)


def attention_prefill_chunk(p: dict, x: torch.Tensor, cache_k: torch.Tensor,
                            cache_v: torch.Tensor, positions: torch.Tensor,
                            cfg: ModelConfig, pcfg: ParallelConfig, *,
                            window: Optional[int] = None, spamm_cfg=None,
                            frozen=None, ctx=None, spec=None):
    """One chunk of position-offset prefill for x (B, C, d) at `positions`
    (B, C) int, absolute per-row token indices; entries ≥ the cache length
    are sentinels whose K/V writes drop and whose rows are garbage the
    caller discards. Projects and ropes the chunk at its positions,
    scatters K/V into the LINEAR cache in place, then attends the chunk's
    queries to the whole cache with a per-row causal bias from
    positions[:, 0]. The port attends all keys in one softmax where the
    reference scans KV blocks, so chunked and one-shot prefill agree to f32
    rounding, not bit for bit. Under a model split the cache holds the
    rank's kv heads (a sequence-sharded cache takes no chunks)."""
    b, c, _ = x.shape
    if pcfg.decode_seq_shard and sharded(ctx) and ctx.nmodel > 1:
        raise NotImplementedError(
            "chunked prefill writes a whole-sequence cache; set "
            "decode_seq_shard=False to chunk over a model axis")
    w, split = attn_weights(p, spec, cfg, ctx)
    xin = par.block_in(x, ctx, split is not None, False)
    q, k, v = _qkv(w, xin, cfg, positions, spamm_cfg, frozen, split=split,
                   ctx=ctx)
    k, v = _pick_kv(k, split), _pick_kv(v, split)
    plan = _row_writes(positions, cache_k.shape[1])
    _scatter_rows(cache_k, plan, k)
    _scatter_rows(cache_v, plan, v)
    o = attn_mod.flash_attention(q, cache_k, cache_v, causal=True,
                                 window=window, q_chunk=pcfg.attn_q_chunk,
                                 q_offset=positions[:, 0])
    out = _mm(split, ctx)(o.reshape(b, c, -1), w["wo"].to(x.dtype),
                          spamm_cfg, frozen=(frozen or {}).get("wo"),
                          site="wo")
    return par.block_out(out, ctx, split is not None, False), (cache_k,
                                                               cache_v)


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
                 kind: str, model_axis_size: int = 1) -> dict:
    """One layer's parameters; `model_axis_size` pads an EP MoE block's
    experts to a multiple of it, as the reference's `layer_params`."""
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
                                      device, model_axis_size)
    else:
        p["mlp"] = mlp_params(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype,
                              device)
    return p


def _ffn(p: dict, h: torch.Tensor, cfg: ModelConfig, spamm_cfg, frozen=None,
         require_frozen: bool = False, ctx=None, spec=None, sp: bool = False):
    """The MLP or MoE sub-layer on the normalized input h → (out, aux).
    A MoE block gates eagerly (its expert buffers depend on the routing;
    frozen plans cover attention and the dense MLP), with no SpAMM under
    the decode contract (`require_frozen`); its taps report layer -1 and
    stay out of the training stack's trace buffer, as in the reference.
    Over a mesh the MLP splits its ff over "model" (`mlp(ctx=)`) and the
    MoE block its experts or their ff (`moe.moe_block(ctx=)`)."""
    on_mesh = sharded(ctx)
    if cfg.moe is None:
        return mlp(p["mlp"], h, cfg.act, spamm_cfg, frozen, require_frozen,
                   ctx=ctx if on_mesh else None,
                   spec=spec["mlp"] if on_mesh else None, sp=sp), 0.0
    tctx = _tap_ctx(spamm_cfg)
    if tctx is not None:
        prev = tctx.swap_layer(None)
        buf = tctx.suspend_trace_buffer()
    try:
        return moe_mod.moe_block(
            p["moe"], h, cfg.moe, cfg.act,
            spamm_cfg=None if require_frozen else spamm_cfg,
            ctx=ctx if on_mesh else None,
            spec=spec["moe"] if on_mesh else None, sp=sp)
    finally:
        if tctx is not None:
            tctx.swap_layer(prev)
            tctx.resume_trace_buffer(buf)


def _whole(p: dict, spec, ctx, sp: bool, fn, x):
    """A recurrent block over a mesh: its weights gathered whole, run alike
    on every model rank (under SP on the gathered sequence, the output cut
    back to the rank's chunk)."""
    if not sharded(ctx):
        return fn(p, x)
    w = par.full_tree(p, spec, ctx)
    out = fn(w, par.block_in(x, ctx, False, sp))
    h, rest = out
    return par.block_out(h, ctx, False, sp), rest


def layer_fwd(p: dict, x: torch.Tensor, cfg: ModelConfig,
              pcfg: ParallelConfig, positions: torch.Tensor, kind: str, *,
              spamm_cfg=None, collect_cache: bool = False, frozen=None,
              ctx=None, spec=None, sp: bool = False):
    """One residual layer of kind "attn" | "rec" | "ssm". Returns (x, aux,
    cache or None): aux is the MoE block's load-balancing loss (0.0
    without one). Over a mesh `spec` is the layer's placements and `sp`
    says x is the rank's sequence chunk (Megatron-SP): the norms then act
    on that chunk alone, so their weights' gradients are summed over
    "model" (`parallel.enter`)."""
    fz = frozen or {}
    sp_ = spec or {}
    if sharded(ctx):
        norms = {n: par.full_weight(p[n], sp_[n], ctx)
                 for n in ("ln", "ln1", "ln2") if n in p}
        if sp:
            g = ctx.group(ctx.model_axis)
            norms = {n: par.enter(w, g) for n, w in norms.items()}
    else:
        norms = p
    if kind == "ssm":
        h, cache = _whole(
            p["ssm"], sp_.get("ssm"), ctx, sp,
            lambda w, xx: ssm_mod.ssm_block(w, xx, cfg.ssm,
                                            norm_eps=cfg.norm_eps),
            rms_norm(x, norms["ln"], cfg.norm_eps))
        return x + h, 0.0, (cache if collect_cache else None)
    if kind == "attn":
        h, (k, v) = attention_layer(
            p["mix"], rms_norm(x, norms["ln1"], cfg.norm_eps), cfg, pcfg,
            positions, window=cfg.sliding_window, spamm_cfg=spamm_cfg,
            return_kv=True, frozen=fz.get("mix"), ctx=ctx,
            spec=sp_.get("mix"), sp=sp)
        cache = {"k": k, "v": v}
    else:
        h, cache = _whole(
            p["mix"], sp_.get("mix"), ctx, sp,
            lambda w, xx: rglru_mod.rglru_block(w, xx, cfg.rglru),
            rms_norm(x, norms["ln1"], cfg.norm_eps))
    x = x + h
    f, aux = _ffn(p, rms_norm(x, norms["ln2"], cfg.norm_eps), cfg, spamm_cfg,
                  fz.get("mlp"), ctx=ctx, spec=spec, sp=sp)
    return x + f, aux, (cache if collect_cache else None)


def layer_prefill_chunk(p: dict, x: torch.Tensor, cache: dict,
                        positions: torch.Tensor, cfg: ModelConfig,
                        pcfg: ParallelConfig, *, spamm_cfg=None, frozen=None,
                        ctx=None, spec=None):
    """One residual layer of chunked prefill: attention writes the chunk's
    K/V into the linear cache at its positions; the FFN is the plain
    prefill body (stateless per position)."""
    fz = frozen or {}
    sp_ = spec or {}
    norms = ({n: par.full_weight(p[n], sp_[n], ctx) for n in ("ln1", "ln2")}
             if sharded(ctx) else p)
    h, (ck, cv) = attention_prefill_chunk(
        p["mix"], rms_norm(x, norms["ln1"], cfg.norm_eps), cache["k"],
        cache["v"], positions, cfg, pcfg, window=cfg.sliding_window,
        spamm_cfg=spamm_cfg, frozen=fz.get("mix"), ctx=ctx,
        spec=sp_.get("mix"))
    x = x + h
    f, _ = _ffn(p, rms_norm(x, norms["ln2"], cfg.norm_eps), cfg, spamm_cfg,
                fz.get("mlp"), ctx=ctx, spec=spec)
    return x + f, dict(cache, k=ck, v=cv)


def layer_decode(p: dict, x: torch.Tensor, cache: dict, pos,
                 cfg: ModelConfig, pcfg: ParallelConfig, kind: str, *,
                 spamm_cfg=None, frozen=None, ctx=None, spec=None):
    """One residual decode layer; `pos` as in `attention_decode` (unused
    by the recurrent kinds, whose caches carry their state)."""
    fz = frozen or {}
    sp_ = spec or {}
    if sharded(ctx):
        norms = {n: par.full_weight(p[n], sp_[n], ctx)
                 for n in ("ln", "ln1", "ln2") if n in p}
    else:
        norms = p
    if kind == "ssm":
        w = par.full_tree(p["ssm"], sp_.get("ssm"), ctx)
        h, new = ssm_mod.ssm_decode_step(
            w, rms_norm(x[:, 0], norms["ln"], cfg.norm_eps), cache,
            cfg.ssm, norm_eps=cfg.norm_eps)
        return x + h[:, None], new
    if kind == "attn":
        # ring buffer iff the cache is exactly the sliding window (a
        # sequence-sharded cache holds 1/model of it)
        slen = cache["k"].shape[1]
        if pcfg.decode_seq_shard and sharded(ctx):
            slen *= ctx.nmodel
        ring = (cfg.sliding_window is not None
                and slen <= cfg.sliding_window)
        h, (ck, cv) = attention_decode(
            p["mix"], rms_norm(x, norms["ln1"], cfg.norm_eps), cache["k"],
            cache["v"], pos, cfg, pcfg, window=cfg.sliding_window,
            ring=ring, spamm_cfg=spamm_cfg, frozen=fz.get("mix"), ctx=ctx,
            spec=sp_.get("mix"))
        new = dict(cache, k=ck, v=cv)
    else:
        w = par.full_tree(p["mix"], sp_.get("mix"), ctx)
        h1, new = rglru_mod.rglru_decode_step(
            w, rms_norm(x[:, 0], norms["ln1"], cfg.norm_eps), cache,
            cfg.rglru)
        h = h1[:, None]
    x = x + h
    f, _ = _ffn(p, rms_norm(x, norms["ln2"], cfg.norm_eps), cfg, spamm_cfg,
                fz.get("mlp"), require_frozen=True, ctx=ctx, spec=spec)
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


def _sp_in(x, pcfg, ctx):
    """The stack's input: under Megatron-SP the rank's sequence chunk."""
    sp = seq_sharded(pcfg, ctx, x.shape[1])
    if sp:
        x = par.scatter(x, ctx.group(ctx.model_axis), 1)
    return x, sp


def _sp_out(x, ctx, sp: bool):
    """The stack's output, whole on every model rank again."""
    if sp:
        x = par.gather(x, ctx.group(ctx.model_axis), 1, "slice")
    return x


def stack_fwd(params: dict, x: torch.Tensor, cfg: ModelConfig,
              pcfg: ParallelConfig, positions: torch.Tensor, *,
              spamm_cfg=None, collect_spamm_stats: bool = False, ctx=None):
    """All layers, the training and loss path (no caches). Returns (x,
    aux), or with `collect_spamm_stats` (x, aux, (frac_sum, gemm_count,
    layer_frac_sums, layer_gemm_counts)): f32 device tensors, the last two
    (num_layers,) in stack order. Each layer runs under `pcfg.remat`.

    The stats come from the context's trace buffer, open only while a
    layer's forward runs: a remat recomputation inside backward taps into
    no buffer, so every gated GEMM counts once, as through the reference's
    scan carry. A MoE block's GEMMs stay out (`_ffn`), as in the
    reference. Over a mesh a split GEMM's fraction is the whole GEMM's
    (`parallel.split_matmul`)."""
    tctx = _tap_ctx(spamm_cfg)
    collect = collect_spamm_stats and tctx is not None and tctx.enable
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    x, sp = _sp_in(x, pcfg, ctx)

    def body(p, h, kind, spec):
        h, a, _ = layer_fwd(p, h, cfg, pcfg, positions, kind,
                            spamm_cfg=spamm_cfg, ctx=ctx, spec=spec, sp=sp)
        return h, a

    layer = _remat(body, pcfg)
    aux = vs = vc = zero
    lvs, lvc = [], []
    for li, (p, kind) in enumerate(zip(params["layers"], layer_kinds(cfg))):
        if collect:
            tctx.begin_trace_buffer()
        try:
            x, a = layer(p, x, kind, _lspec(ctx, li))
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
    x = _sp_out(x, ctx, sp)
    if collect:
        return x, aux, (vs, vc, torch.stack(lvs), torch.stack(lvc))
    return x, aux


def stack_prefill(params: dict, x: torch.Tensor, cfg: ModelConfig,
                  pcfg: ParallelConfig, positions: torch.Tensor,
                  cache_len: int, *, spamm_cfg=None, frozen=None, ctx=None):
    """Forward + collect caches. Returns (x, {"layers": [cache per layer]}).
    Sliding-window caches keep their last `cache_len` tokens as a ring
    (token t at slot t % W)."""
    s = x.shape[1]
    fz_layers = (frozen or {}).get("layers")
    tctx = _tap_ctx(spamm_cfg)
    caches = []
    x, sp = _sp_in(x, pcfg, ctx)
    try:
        for li, (p, kind) in enumerate(zip(params["layers"],
                                           layer_kinds(cfg))):
            if tctx is not None:
                tctx.set_layer(li)
            x, _, c = layer_fwd(p, x, cfg, pcfg, positions, kind,
                                spamm_cfg=spamm_cfg, collect_cache=True,
                                frozen=fz_layers[li] if fz_layers else None,
                                ctx=ctx, spec=_lspec(ctx, li), sp=sp)
            if kind == "attn" and c["k"].shape[1] > cache_len:
                shift = s % cache_len
                c = {n: torch.roll(c[n][:, -cache_len:], shift, dims=1)
                     for n in ("k", "v")}
            caches.append(c)
    finally:
        if tctx is not None:
            tctx.set_layer(None)
    return _sp_out(x, ctx, sp), {"layers": caches}


def stack_prefill_chunk(params: dict, x: torch.Tensor, cache: dict,
                        positions: torch.Tensor, cfg: ModelConfig,
                        pcfg: ParallelConfig, *, spamm_cfg=None,
                        frozen=None, ctx=None):
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
                frozen=fz_layers[li] if fz_layers else None, ctx=ctx,
                spec=_lspec(ctx, li))
            caches.append(nc)
    finally:
        if tctx is not None:
            tctx.set_layer(None)
    return x, {"layers": caches}


def stack_decode(params: dict, x: torch.Tensor, cache: dict, pos,
                 cfg: ModelConfig, pcfg: ParallelConfig, *, spamm_cfg=None,
                 frozen=None, ctx=None):
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
                                 frozen=fz_layers[li] if fz_layers else None,
                                 ctx=ctx, spec=_lspec(ctx, li))
            caches.append(nc)
    finally:
        if tctx is not None:
            tctx.set_layer(None)
    return x, {"layers": caches}
