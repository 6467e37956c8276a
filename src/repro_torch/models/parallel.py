"""Tensor, sequence and data parallelism of the model over a (data, model)
`DeviceMesh`: the collectives as autograd Functions, the weight layouts a
layer computes with, and the global valid fraction (twin of what GSPMD does
for the reference's `NetCtx.shard` constraints and `param_pspecs`
placements).

Every rank holds its own shards of the parameters (`models.model.
shard_params`, placed by `models.model.placements`). A layer turns a
stored shard into the weight it computes with:

* `full_weight`: the whole leaf on every rank, for work every model rank
  does alike (norms, embeddings, the router, a recurrent block);
* `model_slice`: a range of one dim, for work each model rank does on its
  own part (column-parallel wq/wk/wv/w1/w3, row-parallel wo/w2, a rank's
  experts).

Both first all-gather an FSDP shard over "data"; its backward is a
reduce-scatter, which sums the data ranks' gradients. Over "model" the
backward depends on the use: work done alike on every model rank already
holds the whole gradient, so the backward of its all-gather keeps the
rank's own chunk; work split over the model ranks holds a part, so the
backward sums the parts (a reduce-scatter, or an all-reduce for a leaf
stored whole). A leaf replicated over a batch axis gets its data-parallel
sum in the train step (`models.model.make_train_step`).

The Megatron pair is `enter` (identity forward, all-reduce backward) at the
input of split work and `leave` (all-reduce forward, identity backward) at
its output. Under Megatron-SP (`seq_shard_acts`) the residual stream is cut
on the sequence over "model": an all-gather over the sequence (reduce-
scatter backward) replaces `enter` and a reduce-scatter (all-gather
backward) replaces `leave` (`block_in` / `block_out`); `scatter` cuts
the stack's input into the rank's chunk (all-gather backward). Over a
model axis that cuts the vocabulary, the embedding, the logits and the
cross-entropy are vocabulary-parallel (`vocab_embed`, `vocab_logits`,
`vocab_ce_parts`). Every collective goes through
`core.distributed._all_gather` / `_reduce_scatter` or
`torch.distributed.all_reduce`, on the operands' own tensors.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core.distributed import _all_gather, _reduce_scatter


# ---------------------------------------------------------------------------
# collectives along a dim
# ---------------------------------------------------------------------------

def _gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's `x` concatenated along `dim` in group-rank order."""
    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0)
    return _all_gather(xt, group).movedim(0, dim) if n > 1 else x


def _reduce_scatter_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum over `group` of every rank's `x`, cut along `dim`; rank r
    keeps chunk r."""
    xt = x.movedim(dim, 0)
    return _reduce_scatter(xt, group).movedim(0, dim).contiguous()


def _chunk(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    w = x.shape[dim] // n
    return x.narrow(dim, r * w, w).contiguous()


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM):
    y = x.contiguous().clone()
    dist.all_reduce(y, op=op, group=group)
    return y


class _Gather(torch.autograd.Function):
    """All-gather along `dim`; backward "sum" reduce-scatters (the ranks'
    parts of the gradient add up), "slice" keeps the rank's chunk (every
    rank holds the whole gradient)."""

    @staticmethod
    def forward(ctx, x, group, dim, bwd):
        ctx.args = (group, dim, bwd)
        return _gather_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        group, dim, bwd = ctx.args
        if bwd == "sum":
            return _reduce_scatter_dim(g, group, dim), None, None, None
        return _chunk(g, group, dim), None, None, None


class _Scatter(torch.autograd.Function):
    """The rank's chunk along `dim`; backward all-gathers."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = (group, dim)
        return _chunk(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        group, dim = ctx.args
        return _gather_dim(g, group, dim), None, None


class _ReduceScatter(torch.autograd.Function):
    """Reduce-scatter along `dim`; backward all-gathers."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = (group, dim)
        return _reduce_scatter_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        group, dim = ctx.args
        return _gather_dim(g.contiguous(), group, dim), None, None


class _Enter(torch.autograd.Function):
    """Identity forward, all-reduce (sum) backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Leave(torch.autograd.Function):
    """All-reduce (sum) forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _one(group) -> bool:
    return group is None or dist.get_world_size(group) == 1


def gather(x, group, dim: int, bwd: str = "sum"):
    return x if _one(group) else _Gather.apply(x, group, dim, bwd)


def scatter(x, group, dim: int):
    return x if _one(group) else _Scatter.apply(x, group, dim)


def reduce_scatter(x, group, dim: int):
    return x if _one(group) else _ReduceScatter.apply(x, group, dim)


def enter(x, group):
    return x if _one(group) else _Enter.apply(x, group)


def leave(x, group):
    return x if _one(group) else _Leave.apply(x, group)


def all_reduce_value(x: torch.Tensor, group, op=dist.ReduceOp.SUM):
    """A forward-only all-reduce (counts, maxima, metrics)."""
    return x if _one(group) else _all_reduce(x.detach(), group, op)


def block_in(x, ctx, split: bool, sp: bool):
    """A block's input: the replicated residual (or, under SP, the rank's
    sequence chunk, gathered) entering split work (`split`) or work every
    model rank does alike."""
    if ctx is None or ctx.nmodel == 1:
        return x
    g = ctx.group(ctx.model_axis)
    if sp:
        return gather(x, g, 1, "sum" if split else "slice")
    return enter(x, g) if split else x


def block_out(y, ctx, split: bool, sp: bool):
    """A block's output back onto the residual: split work's partial sums
    added over "model" (under SP, reduce-scattered on the sequence); work
    done alike kept (under SP, the rank's sequence chunk)."""
    if ctx is None or ctx.nmodel == 1:
        return y
    g = ctx.group(ctx.model_axis)
    if sp:
        return reduce_scatter(y, g, 1) if split else scatter(y, g, 1)
    return leave(y, g) if split else y


# ---------------------------------------------------------------------------
# stored shard → the weight a layer computes with
# ---------------------------------------------------------------------------

def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _gather_batch(w, spec, ctx):
    """All-gather every non-model axis of the stored placement (FSDP's
    "data"); backward reduce-scatters. Returns (w, spec left: the model
    entries only)."""
    left = []
    for dim, entry in enumerate(spec):
        keep = []
        for ax in reversed(_axes(entry)):
            if ax == ctx.model_axis:
                keep.append(ax)
            else:
                w = gather(w, ctx.group(ax), dim, "sum")
        left.append(tuple(reversed(keep)))
    return w, left


def batch_gathered(w: torch.Tensor, spec, ctx) -> torch.Tensor:
    """The leaf with its FSDP shard all-gathered over "data" (backward:
    reduce-scatter) and its model shard kept."""
    if ctx is None or spec is None:
        return w
    return _gather_batch(w, spec, ctx)[0]


def full_weight(w: torch.Tensor, spec, ctx) -> torch.Tensor:
    """The whole leaf from this rank's shard, for work every model rank does
    alike."""
    if ctx is None or spec is None:
        return w
    w, left = _gather_batch(w, spec, ctx)
    for dim, axes in enumerate(left):
        if axes:
            w = gather(w, ctx.group(ctx.model_axis), dim, "slice")
    return w


def model_slice(w: torch.Tensor, spec, ctx, dim: int, lo: int,
                hi: int) -> torch.Tensor:
    """Rows or columns [lo, hi) of the leaf along `dim`, for work that is
    this model rank's own. The stored model shard is used as it is when it
    is exactly that range."""
    if ctx is None or spec is None:
        return w.narrow(dim, lo, hi - lo)
    w, left = _gather_batch(w, spec, ctx)
    r = ctx.mrank
    mdims = [d for d, axes in enumerate(left) if axes]
    if mdims == [dim] and left[dim] == (ctx.model_axis,):
        width = w.shape[dim]
        if (r * width, (r + 1) * width) == (lo, hi):
            return w
    group = ctx.group(ctx.model_axis)
    if mdims:
        for d in mdims:
            w = gather(w, group, d, "sum")
    else:
        w = enter(w, group)
    return w.narrow(dim, lo, hi - lo)


def full_shape(t: torch.Tensor, spec, ctx) -> tuple:
    """The leaf's whole shape from this rank's shard and its placement."""
    if ctx is None or spec is None:
        return tuple(t.shape)
    out = []
    for n, entry in zip(t.shape, spec):
        for ax in _axes(entry):
            n *= ctx.size(ax)
        out.append(n)
    return tuple(out)


def full_tree(tree, spec_tree, ctx):
    """`full_weight` over every leaf of a parameter subtree."""
    if ctx is None or spec_tree is None:
        return tree
    if isinstance(tree, dict):
        return {k: full_tree(v, spec_tree[k], ctx) for k, v in tree.items()}
    return full_weight(tree, spec_tree, ctx)


# ---------------------------------------------------------------------------
# vocabulary-parallel embedding, logits and cross-entropy
# ---------------------------------------------------------------------------

def vocab_cut(spec, ctx, dim: int) -> bool:
    """Whether a vocabulary leaf is cut over "model" on `dim` alone (the
    embedding's rows, the unembedding's columns), so the work on it can be
    vocabulary-parallel."""
    if ctx is None or spec is None or ctx.nmodel == 1:
        return False
    model = [d for d, e in enumerate(spec) if ctx.model_axis in _axes(e)]
    return model == [dim] and _axes(spec[dim]) == (ctx.model_axis,)


def vocab_embed(w_loc: torch.Tensor, tokens: torch.Tensor, cdt,
                ctx) -> torch.Tensor:
    """Embedding rows of `tokens` from this rank's vocabulary rows (V/m,
    d): each rank looks up the tokens it owns (zeros elsewhere) and the
    ranks' rows are summed over "model" — every token's row exactly."""
    v = w_loc.shape[0]
    lo = ctx.mrank * v
    own = (tokens >= lo) & (tokens < lo + v)
    rows = w_loc.to(cdt)[(tokens - lo).clamp(0, v - 1)]
    rows = torch.where(own[..., None], rows, torch.zeros_like(rows))
    return leave(rows, ctx.group(ctx.model_axis))


def vocab_logits(h: torch.Tensor, w_loc: torch.Tensor, ctx) -> torch.Tensor:
    """f32 logits (..., V) of hidden rows h from this rank's unembedding
    columns (d, V/m): each rank's columns, all-gathered over "model"."""
    part = (h @ w_loc.to(h.dtype)).float()
    return gather(part, ctx.group(ctx.model_axis), part.dim() - 1, "slice")


def _vocab_chunk_loss(hc, w_loc, lc, lo: int, group):
    logits = (hc @ w_loc).float()                        # (B, c, V/m)
    m = all_reduce_value(logits.detach().amax(dim=-1, keepdim=True), group,
                         dist.ReduceOp.MAX)
    se = leave(torch.exp(logits - m).sum(dim=-1), group)
    logz = m[..., 0] + torch.log(se)
    v = w_loc.shape[1]
    own = (lc >= lo) & (lc < lo + v)
    gold = logits.gather(-1, (lc - lo).clamp(0, v - 1).long()[..., None])
    gold = leave(torch.where(own, gold[..., 0], torch.zeros_like(logz)),
                 group)
    mask = (lc >= 0).float()
    return ((logz - gold) * mask).sum(), mask.sum()


def vocab_ce_parts(h: torch.Tensor, w_loc: torch.Tensor,
                   labels: torch.Tensor, chunk: int, ctx):
    """`layers.chunked_ce_parts` with the unembedding's columns cut over
    "model" (Megatron's vocabulary-parallel cross-entropy): each rank's
    logits of its columns, the log-sum-exp from an all-reduced max and
    sum, the gold logit from the rank that owns the label. h enters as
    split work (its gradient is the ranks' sum)."""
    from torch.utils.checkpoint import checkpoint

    group = ctx.group(ctx.model_axis)
    lo = ctx.mrank * w_loc.shape[1]
    h = enter(h, group)
    s = h.shape[1]
    chunk = min(chunk, s)
    tot = cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, s, chunk):
        l, m = checkpoint(_vocab_chunk_loss, h[:, c0:c0 + chunk], w_loc,
                          labels[:, c0:c0 + chunk], lo, group,
                          use_reentrant=False)
        tot, cnt = tot + l, cnt + m
    return tot, cnt


# ---------------------------------------------------------------------------
# how a layer splits over "model"
# ---------------------------------------------------------------------------

class AttnSplit:
    """One model rank's part of an attention layer: q heads [q0, q0+qh)
    (wq's columns and wo's rows), the kv heads [k0, k1) they read, and the
    wk/wv columns [c0, c1) it computes (the kv heads' own columns when they
    fall on whole tiles, else every column, the heads picked after)."""

    def __init__(self, q0, qh, k0, k1, c0, c1, hd):
        self.q0, self.qh, self.k0, self.k1 = q0, qh, k0, k1
        self.c0, self.c1, self.hd = c0, c1, hd

    @property
    def kv_pick(self) -> Optional[tuple]:
        """(first head, count) to pick from the computed K/V, or None when
        they are exactly this rank's heads."""
        if self.c0 == self.k0 * self.hd and self.c1 == self.k1 * self.hd:
            return None
        return self.k0 - self.c0 // self.hd, self.k1 - self.k0


def _attn_split(cfg, m: int, r: int, tile: int) -> Optional[AttnSplit]:
    hq, hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    g = hq // hk
    if hq % m or ((hq // m) * hd) % tile:
        return None
    qh = hq // m
    if qh % g and g % qh:
        return None
    q0 = r * qh
    k0, k1 = q0 // g, (q0 + qh - 1) // g + 1
    c0, c1 = k0 * hd, k1 * hd
    if c0 % tile or (c1 - c0) % tile:
        c0, c1 = 0, hk * hd
    return AttnSplit(q0, qh, k0, k1, c0, c1, hd)


def attn_split(cfg, ctx, tile: int) -> Optional[AttnSplit]:
    """The rank's part, or None when the layer runs whole on every model
    rank: one model rank, q heads that do not split evenly, a q cut that is
    not whole tiles, or a GQA group that straddles the cut."""
    if ctx is None or ctx.nmodel == 1:
        return None
    return _attn_split(cfg, ctx.nmodel, ctx.mrank, tile)


def all_kv_heads(k: torch.Tensor, split: AttnSplit, cfg, ctx,
                 dim: int = 2) -> torch.Tensor:
    """Every kv head from the ranks' computed K (or V) along `dim`: the
    computed tensor itself when it holds every column, else the ranks'
    heads all-gathered over "model", each head taken from the first rank
    that holds it."""
    if split.kv_pick is not None:
        return k
    m = ctx.nmodel
    got = gather(k, ctx.group(ctx.model_axis), dim, "sum")
    cnt = split.k1 - split.k0
    where = {}
    for r in range(m):
        sr = _attn_split(cfg, m, r, ctx.tile)
        for h in range(sr.k0, sr.k1):
            where.setdefault(h, r * cnt + h - sr.k0)
    # runs of consecutive heads, narrowed and joined: no index tensor
    # crosses from the host, so a CUDA graph can capture the step
    runs = []
    for h in range(cfg.num_kv_heads):
        if runs and where[h] == runs[-1][0] + runs[-1][1]:
            runs[-1][1] += 1
        else:
            runs.append([where[h], 1])
    parts = [got.narrow(dim, start, n) for start, n in runs]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


def ff_split(width: int, ctx, tile: int) -> Optional[tuple]:
    """(lo, hi) of a hidden width cut over "model" (the MLP's ff, an
    expert's ff, the shared expert's), or None when it runs whole: one model
    rank, or a cut that is not even or not whole tiles."""
    if ctx is None or ctx.nmodel == 1:
        return None
    m, r = ctx.nmodel, ctx.mrank
    if width % m or (width // m) % tile:
        return None
    w = width // m
    return r * w, (r + 1) * w


# ---------------------------------------------------------------------------
# split gated GEMMs and the global valid fraction
# ---------------------------------------------------------------------------

def _count_fraction(group, total: int):
    """frac → the fraction of the whole product that the ranks of `group`
    split in equal `total`-tile shares: each rank's count (exact: a
    correctly rounded count/total times total rounds back to the count
    below 2^23) is summed over the group before the one division, as the
    unsharded plan divides its count."""
    n = dist.get_world_size(group)

    def reduce(frac: torch.Tensor) -> torch.Tensor:
        count = torch.round(frac.float() * total).reshape(1)
        count = _all_reduce(count, group).reshape(())
        return count / torch.full((), float(total * n), device=count.device)

    return reduce


def _tiles(x, w, tile: int, block_n: int) -> int:
    k, n = w.shape[-2], w.shape[-1]
    m = x.numel() // k
    tn = tile * block_n
    return -(-m // tile) * -(-k // tile) * -(-n // tn)


def split_matmul(x, w, spamm_cfg, ctx, *, frozen=None,
                 require_frozen: bool = False, site=None):
    """`maybe_spamm_matmul` of this model rank's part of a GEMM split over
    "model" (a column or row slice of the weight). Its tap reports the
    valid fraction of the whole GEMM: the ranks' counts summed before the
    division. Every model rank must make the same calls."""
    from repro_torch.core.module import SpammContext, maybe_spamm_matmul

    sctx = spamm_cfg if isinstance(spamm_cfg, SpammContext) else None
    gated = (sctx is not None and sctx.enable
             and not (require_frozen and frozen is None))
    if not gated or ctx is None or ctx.nmodel == 1:
        return maybe_spamm_matmul(x, w, spamm_cfg, frozen=frozen,
                                  require_frozen=require_frozen, site=site)
    src = frozen if frozen is not None else sctx.cfg
    total = _tiles(x, w, src.tile, src.block_n)
    prev = sctx.swap_fraction_reduce(
        _count_fraction(ctx.group(ctx.model_axis), total))
    try:
        return maybe_spamm_matmul(x, w, sctx, frozen=frozen,
                                  require_frozen=require_frozen, site=site)
    finally:
        sctx.swap_fraction_reduce(prev)


def split_bmm(x, w, spamm_cfg, ctx):
    """`spamm_bmm_linear` of this model rank's part of a batched GEMM (a
    MoE block's experts, or their ff slices). Its tap reports the valid
    fraction of the whole batch, as `split_matmul`'s does. Every model
    rank must make the same calls."""
    from repro_torch.core.module import spamm_bmm_linear

    t, bn = spamm_cfg.cfg.tile, spamm_cfg.cfg.block_n
    total = (x.shape[0] * -(-x.shape[1] // t) * -(-w.shape[1] // t)
             * -(-w.shape[2] // (t * bn)))
    prev = spamm_cfg.swap_fraction_reduce(
        _count_fraction(ctx.group(ctx.model_axis), total))
    try:
        return spamm_bmm_linear(x, w, spamm_cfg)
    finally:
        spamm_cfg.swap_fraction_reduce(prev)
