"""Attention for the port (twin of `repro.models.attention`).

Plain PyTorch: the reference's attention is `lax.scan` code, not a Pallas
kernel. `flash_attention` walks q chunks and attends each chunk to the whole
KV with the reference's additive-bias mask contract (`_mask_bias`: causal,
sliding window, kv_limit; per-row q offsets); `decode_attention` attends one
new token per row against a cache; `decode_attention_seqsharded` does so
over a cache cut on the sequence across a process group (flash-decoding:
per-rank softmax partials merged by all-reduces). Matmuls run in f32 (TF32
off).

Offsets and lengths are a Python int or an int tensor on the operands'
device: the int form builds its positions on the device (`arange`, `full`),
the tensor form reads them there, so neither copies a host value to the
card — a captured step (`serving/graphs.py`) takes the tensor form.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def _mask_bias(qpos, kpos, window: Optional[int], kv_limit=None):
    """(..., q, k) additive bias: causal + optional sliding window +
    optional kv_limit. `qpos` may carry leading batch dims."""
    qp = qpos[..., :, None]
    ok = kpos <= qp
    if window is not None:
        ok &= kpos > (qp - window)
    if kv_limit is not None:
        ok &= kpos < kv_limit
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_chunk: int = 512, q_offset=0,
                    kv_limit=None) -> torch.Tensor:
    """q (B, Sq, Hq, D), k/v (B, Skv, Hk, D) → (B, Sq, Hq, D). GQA groups q
    heads onto kv heads. `q_offset` is q[0]'s absolute position: an int, or
    a 0-d or (B,) int tensor on q's device. Each q chunk attends the whole
    KV at once (the reference also chunks KV with an online softmax; the
    result is the same softmax up to f32 rounding)."""
    b, sq, hq, d = q.shape
    skv, hk = k.shape[1], k.shape[2]
    g = hq // hk
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    q5 = q.float().reshape(b, sq, hk, g, d)
    kf, vf = k.float(), v.float()
    kpos = torch.arange(skv, device=dev)
    outs = []
    for q0 in range(0, sq, q_chunk):
        qc = q5[:, q0:q0 + q_chunk]
        n = qc.shape[1]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qc, kf) * scale
        if causal or kv_limit is not None:
            if isinstance(q_offset, torch.Tensor):
                qpos = q_offset[..., None] + q0 + torch.arange(n, device=dev)
            else:
                qpos = torch.arange(q_offset + q0, q_offset + q0 + n,
                                    device=dev)
            if not causal:
                qpos = torch.full_like(qpos, skv)
            bias = _mask_bias(qpos, kpos, window if causal else None,
                              kv_limit)
            if bias.dim() == 3:                  # per-row → (B,1,1,q,k)
                bias = bias[:, None, None]
            s = s + bias
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        o = torch.einsum("bhgqk,bkhd->bhgqd", p, vf) / l.clamp(min=1e-30)
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(b, n, hq, d))
    return torch.cat(outs, dim=1).to(q.dtype)


def _slot_positions(slots, lb, ring: bool, cache_len: int):
    """Token position held by each cache slot, per batch row → (B, S).
    Linear cache: slot s holds token s. Ring cache (sliding window W): the
    newest token is p = lb-1; slot s holds p - ((p - s) mod W)."""
    if not ring:
        return slots[None, :].expand(lb.shape[0], slots.shape[0])
    p = (lb - 1)[:, None]
    return p - torch.remainder(p - slots[None, :], cache_len)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length, *,
                     window: Optional[int] = None, ring: bool = False
                     ) -> torch.Tensor:
    """q (B, Hq, D) one new token per row; caches (B, S, Hk, D); `length`
    (an int, or a 0-d or (B,) int tensor on q's device) = valid token
    positions after this step's write."""
    b, hq, d = q.shape
    s, hk = k_cache.shape[1], k_cache.shape[2]
    g = hq // hk
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    q4 = q.float().reshape(b, hk, g, d)
    if isinstance(length, torch.Tensor):
        lb = length.reshape(-1).expand(b)
    else:
        lb = torch.full((b,), length, dtype=torch.int64, device=dev)
    kpos = _slot_positions(torch.arange(s, device=dev), lb, ring, s)
    scores = torch.einsum("bhgd,bshd->bhgs", q4, k_cache.float()) * scale
    valid = (kpos < lb[:, None]) & (kpos >= 0)
    if window is not None:
        valid &= kpos >= (lb[:, None] - window)
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    o = o / l.clamp(min=1e-30)[..., None]
    return o.reshape(b, hq, d).to(q.dtype)


def decode_attention_seqsharded(q: torch.Tensor, k_new: torch.Tensor,
                                v_new: torch.Tensor, k_cache: torch.Tensor,
                                v_cache: torch.Tensor, length, *, group,
                                window: Optional[int] = None,
                                ring: bool = False):
    """Flash-decoding over a cache cut on the sequence across the ranks of
    `group` (twin of the reference's shard_map body): q (B, Hq, D) and this
    step's k_new/v_new (B, 1, Hk, D), the same on every rank; k_cache and
    v_cache (B, S/n, Hk, D), rank r's slots [r·S/n, (r+1)·S/n) of an S-slot
    cache. `length` (int or 0-d int tensor) counts the valid positions
    after this step: the token at position length-1 (modulo S for a ring)
    is written, in place, by the rank that owns its slot, and no other.
    Each rank's partial softmax (o, m, l) over its slots merges by an
    all-reduce of the max over the group, then sums of l·corr and o·corr.
    Returns (out (B, Hq, D), k_cache, v_cache)."""
    import torch.distributed as dist

    b, hq, d = q.shape
    s_loc, hk = k_cache.shape[1], k_cache.shape[2]
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    s = s_loc * n
    g = hq // hk
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    if not isinstance(length, torch.Tensor):
        length = torch.full((), length, dtype=torch.int64, device=dev)
    pos = length.reshape(()) - 1
    slot = torch.remainder(pos, s) if ring else pos
    loc = slot - r * s_loc
    mine = (loc >= 0) & (loc < s_loc)
    locc = loc.clamp(0, s_loc - 1).reshape(1).long()
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        old = cache.index_select(1, locc)
        cache.index_copy_(1, locc, torch.where(mine, new.to(cache.dtype),
                                               old))
    lb = length.reshape(1).expand(b)
    slots = r * s_loc + torch.arange(s_loc, device=dev)
    kpos = _slot_positions(slots, lb, ring, s)
    q4 = q.float().reshape(b, hk, g, d)
    scores = torch.einsum("bhgd,bshd->bhgs", q4, k_cache.float()) * scale
    valid = (kpos < lb[:, None]) & (kpos >= 0)
    if window is not None:
        valid &= kpos >= (lb[:, None] - window)
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    m_g = m.clone()
    dist.all_reduce(m_g, op=dist.ReduceOp.MAX, group=group)
    corr = torch.exp(m - m_g)
    l_g = l * corr
    o_g = o * corr[..., None]
    dist.all_reduce(l_g, group=group)
    dist.all_reduce(o_g, group=group)
    out = o_g / l_g.clamp(min=1e-30)[..., None]
    return out.reshape(b, hq, d).to(q.dtype), k_cache, v_cache
