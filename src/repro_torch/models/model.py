"""Top-level model API of the port (twin of `repro.models.model`):
`init_params`, `init_cache`, `make_prefill_step`, `make_prefill_chunk_step`,
`make_decode_step`, the training side (`forward_hidden`, `loss_fn`,
`make_train_step`), and `params_from_jax`, which carries a reference
parameter tree (as numpy) across so both packages can run the same
weights.

Parameter tree: {"embed": {"embedding"}, "final_norm", "unembed":
{"kernel"}, "layers": [per-layer dict, ...]} — the reference's tree with its
stacked leading L axis unstacked into a list. An attention layer holds
"ln1", "ln2", "mix" (attention) and "mlp", or for the MoE family "moe":
router (d, E) f32, w1/w3 (E, d, ff), w2 (E, ff, d) and, with shared
experts, "shared" {w1, w3, w2, gate (d, 1) f32}. An SSM layer holds "ln"
and "ssm" (`models/ssm.py`); a hybrid stack's rec layer "ln1", "ln2",
"mix" (the RG-LRU block, `models/rglru.py`) and "mlp". The reference keeps
a hybrid stack as {"groups": {"l0", "l1", "l2"} stacked over the groups,
"tail": {"l0", ...}}; the port keeps one flat list in stack order
(`transformer.layer_kinds`).

The stub frontends (llava-next's vision, musicgen's audio) are the
reference's: a batch may carry `embeds` (B, S, d) in place of `tokens`,
and a decode step a (B, 1, d) input in place of (B, 1) token ids.

Placements (the reference's `param_pspecs`, `sanitize_spec`): `param_specs`
gives each leaf a tuple with one entry per dim — None, "data", "model" or
a tuple of axes — by the reference's `_leaf_spec` rules (FSDP over "data"
when `ParallelConfig.fsdp`, column or row TP over "model", EP's experts
over "model"); a leaf of the reference's stacked `layers`/`groups` loses
the leading L entry. `placements` drops what a mesh's axis sizes do not
divide (`sanitize_spec`) and a model cut of a matrix dim that is not whole
tiles. `shard_params` cuts a whole tree into this rank's shards and
`gather_params` puts them back together. Every step function takes `ctx`,
a `transformer.NetCtx` (None: one device): each rank passes its batch
rows and its shards, and gets its rows' results.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core import module as spmod
from repro_torch.device import resolve_device
from repro_torch.models import parallel as par
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tr
from repro_torch.models.layers import (_normal, chunked_ce_parts, embed,
                                       mlp_weights, rms_norm)
from repro_torch.models.transformer import NetCtx

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def _dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def init_params(cfg: ModelConfig, pcfg: ParallelConfig, seed: int = 0, *,
                device="cuda", model_axis_size: int = 1, ctx=None) -> dict:
    """Random parameters from a `torch.Generator` seeded with `seed`, made
    directly on `device` (the card unless asked otherwise; "meta" gives
    the shapes alone). The distributions are the reference's; the numbers
    differ (another RNG) — use `params_from_jax` to run the reference's
    exact weights. `model_axis_size` pads an EP MoE's experts to a multiple
    of it, as the reference's `init_params`. With `ctx` (a `NetCtx` with
    placements) the result is this rank's shards, `shard_params` of the
    whole tree: the embedding, the unembedding and each layer are cut as
    soon as they are made, so the device holds the shards and one whole
    piece at a time."""
    if torch.device(device).type == "meta":
        dev = torch.device("meta")
        gen = torch.Generator().manual_seed(seed)
    else:
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
    if ctx is not None:
        model_axis_size = ctx.nmodel

    def keep(t, *path):
        return t if ctx is None else shard_params(t, ctx.spec(*path), ctx)

    pdt = _dtype(pcfg.param_dtype)
    s = 1.0 / math.sqrt(cfg.d_model)
    return {
        "embed": keep({"embedding": _normal(gen, (cfg.vocab, cfg.d_model), s,
                                            pdt, dev)}, "embed"),
        "final_norm": keep(torch.zeros(cfg.d_model, dtype=torch.float32,
                                       device=dev), "final_norm"),
        "unembed": keep({"kernel": _normal(gen, (cfg.d_model, cfg.vocab), s,
                                           pdt, dev)}, "unembed"),
        "layers": [keep(tr.layer_params(gen, cfg, pdt, dev, kind,
                                        model_axis_size), "layers", li)
                   for li, kind in enumerate(tr.layer_kinds(cfg))],
    }


def params_from_jax(np_tree: dict, cfg: ModelConfig, *,
                    device="cuda") -> dict:
    """The reference's parameter pytree, as numpy arrays, → the port's tree
    on `device`: layers stacked on a leading L axis become a list of L
    per-layer dicts; a hybrid stack's group g sub-layer `l{i}` becomes layer
    g·len(group) + i, and its tail's `l{i}` the i-th layer after the
    groups. Every leaf is copied, at the shape it has: a tree made with
    `model_axis_size` > 1 keeps its padded EP experts."""
    dev = resolve_device(device)

    def conv(x):
        return torch.tensor(np.asarray(x), device=dev)

    def tmap(fn, node):
        if isinstance(node, dict):
            return {k: tmap(fn, v) for k, v in node.items()}
        return fn(node)

    def unstack(tree, i):
        return tmap(lambda t: conv(np.asarray(t)[i]), tree)

    if tr.stack_kinds(cfg) == "hybrid":
        n_groups, gkinds, tail = tr.hybrid_pattern(cfg)
        groups = np_tree["groups"]
        layers = [unstack(groups[f"l{i}"], g) for g in range(n_groups)
                  for i in range(len(gkinds))]
        layers += [tmap(conv, np_tree["tail"][f"l{i}"])
                   for i in range(len(tail))]
    else:
        layers = [unstack(np_tree["layers"], i)
                  for i in range(cfg.num_layers)]
    return {
        "embed": tmap(conv, np_tree["embed"]),
        "final_norm": conv(np_tree["final_norm"]),
        "unembed": tmap(conv, np_tree["unembed"]),
        "layers": layers,
    }


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------

def _leaf_spec(path: str, shape, cfg: ModelConfig,
               pcfg: ParallelConfig) -> tuple:
    """The reference's `_leaf_spec` rules: the placement of one leaf at the
    reference's `path` ("/layers/mix/wq") and shape (stacked leaves with
    their leading L), one entry per dim."""
    fsdp = "data" if pcfg.fsdp else None
    m = "model"
    if "embedding" in path:
        rules = [m, fsdp]
    elif "unembed" in path:
        rules = [fsdp, m]
    elif "moe" in path:
        ep = cfg.moe is not None and cfg.moe.impl == "ep"
        if "router" in path or "gate" in path:
            rules = [None] * len(shape)
        elif "shared" in path:
            rules = ([fsdp, m] if path.endswith("w1") or path.endswith("w3")
                     else [m, fsdp])
        elif ep:
            rules = [m, None, None]           # experts over model
        elif path.endswith("w2"):
            rules = [None, m, fsdp]           # (E, ff, d)
        else:
            rules = [None, fsdp, m]           # (E, d, ff)
    elif any(k in path for k in ("wq", "wk", "wv", "in_proj", "in_gelu",
                                 "in_rec", "w1", "w3")):
        rules = [fsdp, m]
    elif any(k in path for k in ("wo", "out_proj", "w2")) or path.endswith(
            "out"):
        rules = [m, fsdp]
    elif path.endswith("conv") or "conv" in path.split("/")[-1]:
        rules = [None, m] if len(shape) >= 2 else [None]
    else:
        rules = [None] * len(shape)
    base = len(shape) - len(rules)
    if base < 0:  # a rank-1 leaf matched a 2-D rule
        rules = [None] * len(shape)
        base = 0
    return tuple([None] * base + rules)


def _shape(t) -> tuple:
    return tuple(t.shape) if hasattr(t, "shape") else tuple(t)


def _ref_path(cfg: ModelConfig, li: int) -> tuple:
    """(the reference's path prefix of port layer li, stacked?)."""
    if tr.stack_kinds(cfg) != "hybrid":
        return "/layers", True
    n_groups, gkinds, _ = tr.hybrid_pattern(cfg)
    glen = len(gkinds)
    if li < n_groups * glen:
        return f"/groups/l{li % glen}", True
    return f"/tail/l{li - n_groups * glen}", False


def param_specs(cfg: ModelConfig, pcfg: ParallelConfig, params) -> dict:
    """The reference's `param_pspecs` over the port's tree (leaves may be
    tensors or shapes): each leaf's placement as a tuple; a layer leaf's is
    the reference's stacked leaf's without its leading L entry."""
    def walk(tree, prefix, stacked):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}/{k}", stacked)
                    for k, v in tree.items()}
        shape = _shape(tree)
        if stacked:
            return _leaf_spec(prefix, (1,) + shape, cfg, pcfg)[1:]
        return _leaf_spec(prefix, shape, cfg, pcfg)

    out = {k: walk(v, f"/{k}", False) for k, v in params.items()
           if k != "layers"}
    out["layers"] = []
    for li, layer in enumerate(params["layers"]):
        prefix, stacked = _ref_path(cfg, li)
        out["layers"].append(walk(layer, prefix, stacked))
    return out


def _axis_sizes(mesh) -> dict:
    """{axis: size} of a DeviceMesh, a NetCtx, a mapping, or anything with
    a `shape` mapping (a jax Mesh)."""
    if isinstance(mesh, NetCtx):
        mesh = mesh.mesh
    if isinstance(mesh, dict):
        return mesh
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def sanitize_spec(mesh, spec, shape) -> tuple:
    """The reference's `launch.dryrun.sanitize_spec`: drop the placement of
    a dim whose length the axis sizes do not divide. `mesh` is a
    DeviceMesh, a NetCtx or an {axis: size} mapping."""
    sizes = _axis_sizes(mesh)
    out = []
    for i, entry in enumerate(list(spec) + [None] * (len(shape) - len(spec))):
        if entry is None:
            out.append(None)
            continue
        n = 1
        for a in _entry_axes(entry):
            n *= sizes[a]
        out.append(entry if shape[i] % n == 0 else None)
    return tuple(out)


def place_spec(mesh, spec, shape, *, tile: int = 64,
               model_axis: str = "model") -> tuple:
    """`sanitize_spec`, then the tile rule: a model cut of one of a matrix
    leaf's last two dims stays only when each rank's part is whole tiles,
    so a rank's normmaps are slices of the whole weight's (a leaf cut
    otherwise is placed replicated over "model")."""
    sizes = _axis_sizes(mesh)
    out = list(sanitize_spec(sizes, spec, shape))
    if len(shape) >= 2:
        for i in (len(shape) - 2, len(shape) - 1):
            axes = _entry_axes(out[i])
            if model_axis in axes:
                n = 1
                for a in axes:
                    n *= sizes[a]
                if (shape[i] // n) % tile:
                    out[i] = None
    return tuple(out)


def placements(cfg: ModelConfig, pcfg: ParallelConfig, params, mesh, *,
               tile: int = 64) -> dict:
    """Each leaf's placement on `mesh` (a DeviceMesh, NetCtx or {axis:
    size}): `param_specs` through `place_spec`. `params` is the whole tree
    (tensors, meta tensors or shapes)."""
    model_axis = mesh.model_axis if isinstance(mesh, NetCtx) else "model"
    return T.map_specs(lambda sp, t: place_spec(mesh, sp, _shape(t),
                                                tile=tile,
                                                model_axis=model_axis),
                       param_specs(cfg, pcfg, params), params)


def with_placements(ctx: NetCtx, cfg: ModelConfig,
                    pcfg: ParallelConfig) -> NetCtx:
    """`ctx` with this model's placements (`placements` of the shapes that
    `init_params(model_axis_size=ctx.nmodel)` makes, at `ctx.tile`)."""
    shapes = init_params(cfg, pcfg, device="meta", model_axis_size=ctx.nmodel)
    return ctx.replace(specs=placements(cfg, pcfg, shapes, ctx,
                                        tile=ctx.tile))


def _ctx_of(mesh) -> NetCtx:
    return mesh if isinstance(mesh, NetCtx) else NetCtx(mesh)


def shard_params(tree, specs, mesh, *, device=None) -> dict:
    """This rank's shards of a whole tree (parameters, or moments shaped
    like them): each leaf cut along its placed dims, an entry of several
    axes row-major (the first axis the slowest), copied onto `device` (the
    leaf's own when None)."""
    ctx = _ctx_of(mesh)

    def cut(t, spec):
        for dim, entry in enumerate(spec):
            for ax in _entry_axes(entry):
                n, i = ctx.size(ax), ctx.index(ax)
                w = t.shape[dim] // n
                t = t.narrow(dim, i * w, w)
        t = torch.as_tensor(t)
        return t.to(device if device is not None else t.device,
                    copy=True).contiguous()

    return T.map_specs(lambda spec, t: cut(t, spec), specs, tree)


def gather_params(tree, specs, mesh, *, keep: bool = True,
                  device=None) -> dict:
    """The whole tree from every rank's shards (`shard_params`' inverse):
    each placed dim all-gathered, the fastest axis first, leaf by leaf, and
    each whole leaf moved onto `device` (its own when None) before the
    next is gathered. A rank that passes `keep=False` takes part in the
    collectives and drops every leaf (None at each leaf), so only the
    ranks that keep the tree hold it. Forward only."""
    ctx = _ctx_of(mesh)

    def put(t, spec):
        t = t.detach()
        for dim, entry in enumerate(spec):
            for ax in reversed(_entry_axes(entry)):
                t = par._gather_dim(t, ctx.group(ax), dim)
        if not keep:
            return None
        return t.to(device if device is not None else t.device).contiguous()

    return T.map_specs(lambda spec, t: put(t, spec), specs, tree)


def compute_params(params: dict, cfg: ModelConfig, ctx) -> dict:
    """The gated weights this rank computes with, in the tree `freeze_tree`
    walks ({"layers": [{"mix": {wq, wk, wv, wo}, "mlp": {...}}]}): under a
    model split the rank's column or row slices (`transformer.attn_weights`,
    `layers.mlp_weights`), whole otherwise. Freeze these for a sharded
    decode: each rank's plans are its slices'."""
    kinds = tr.layer_kinds(cfg)
    layers = []
    with torch.no_grad():
        for li, (p, kind) in enumerate(zip(params["layers"], kinds)):
            spec = ctx.layer_spec(li) if tr.sharded(ctx) else None
            out = {}
            if kind == "attn":
                w, _ = tr.attn_weights(p["mix"], spec and spec["mix"], cfg,
                                       ctx)
                out["mix"] = {n: w[n] for n in ("wq", "wk", "wv", "wo")}
            if "mlp" in p:
                out["mlp"], _ = mlp_weights(p["mlp"], spec and spec["mlp"],
                                            ctx if spec else None)
            layers.append(out)
    return {"layers": layers}


def init_cache(cfg: ModelConfig, pcfg: ParallelConfig, batch: int,
               max_len: int, *, full: bool = False, device="cuda",
               ctx=None) -> dict:
    """Zeroed decode caches, one dict per layer in stack order: an attention
    layer's {"k", "v"} (B, S, Hk, hd), S max_len or the sliding window when
    that is smaller (the decode ring) — `full=True` always gives max_len,
    the chunked plane's LINEAR cache, where a window applies as a mask; an
    SSM layer's {"state" (B, H, P, N) f32, "conv" (B, K-1, conv_ch)}; a rec
    layer's {"h" (B, W) f32, "conv" (B, K-1, W)} (the reference's dtypes:
    states f32, conv histories at the compute dtype).

    Over a mesh (`ctx`) `batch` is this rank's rows, and an attention
    cache under more than one model rank holds, with `decode_seq_shard`,
    the rank's S/model slice of every kv head, else the rank's kv heads
    over all S (`transformer.attention_decode`)."""
    dev = resolve_device(device)
    cdt = _dtype(pcfg.compute_dtype)
    f32 = torch.float32

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def attn_cache():
        s = (min(max_len, cfg.sliding_window)
             if cfg.sliding_window and not full else max_len)
        s, heads = _attn_cache_dims(cfg, pcfg, ctx, s)
        shape = (batch, s, heads, cfg.resolved_head_dim)
        return {"k": zeros(shape, cdt), "v": zeros(shape, cdt)}

    def ssm_cache():
        dims = ssm_mod.ssm_dims(cfg.ssm, cfg.d_model)
        return {"state": zeros((batch, dims.heads, cfg.ssm.head_dim,
                                cfg.ssm.state), f32),
                "conv": zeros((batch, cfg.ssm.conv_dim - 1, dims.conv_ch),
                              cdt)}

    def rec_cache():
        w = cfg.rglru.lru_width or cfg.d_model
        return {"h": zeros((batch, w), f32),
                "conv": zeros((batch, cfg.rglru.conv_dim - 1, w), cdt)}

    make = {"attn": attn_cache, "ssm": ssm_cache, "rec": rec_cache}
    return {"layers": [make[kind]() for kind in tr.layer_kinds(cfg)]}


def _attn_cache_dims(cfg, pcfg, ctx, s: int) -> tuple:
    """(rows, kv heads) of this rank's attention cache of length s."""
    if not (tr.sharded(ctx) and ctx.nmodel > 1):
        return s, cfg.num_kv_heads
    if pcfg.decode_seq_shard:
        if s % ctx.nmodel:
            raise ValueError(f"decode_seq_shard: a {s}-slot cache does not "
                             f"cut over {ctx.nmodel} model ranks")
        return s // ctx.nmodel, cfg.num_kv_heads
    split = par.attn_split(cfg, ctx, ctx.tile)
    return s, (cfg.num_kv_heads if split is None else split.k1 - split.k0)


def place_cache(cache: dict, cfg: ModelConfig, pcfg: ParallelConfig,
                max_len: int, *, ctx=None) -> dict:
    """The decode cache (`init_cache(max_len)`'s layout) holding a prefill
    step's caches: each attention cache copied into slots [0, S0) (a
    sliding-window prefill cache is already its ring); over more than one
    model rank with `decode_seq_shard`, every kv head gathered and the
    rank's sequence slice kept. Recurrent caches pass as they are."""
    out = []
    for c, kind in zip(cache["layers"], tr.layer_kinds(cfg)):
        if kind != "attn":
            out.append(c)
            continue
        k0 = c["k"]
        b, s0 = k0.shape[:2]
        s = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
        split = (par.attn_split(cfg, ctx, ctx.tile)
                 if tr.sharded(ctx) else None)
        seq = (pcfg.decode_seq_shard and tr.sharded(ctx)
               and ctx.nmodel > 1)
        new = {}
        for n in ("k", "v"):
            t = c[n]
            if seq and split is not None:
                t = par.all_kv_heads(t, split, cfg, ctx)
            full = t.new_zeros((b, s) + tuple(t.shape[2:]))
            full[:, :s0] = t
            if seq:
                w = s // ctx.nmodel
                full = full[:, ctx.mrank * w:(ctx.mrank + 1) * w].contiguous()
            new[n] = full
        out.append(dict(c, **new))
    return {"layers": out}


def _inputs(params, batch, cdt, ctx=None) -> torch.Tensor:
    """A batch's (B, S, d) stack input: its `embeds` (the stub frontends'
    precomputed embeddings) or its `tokens` through the embedding."""
    if "embeds" in batch:
        return batch["embeds"].to(cdt)
    return _embed(params, batch["tokens"].long(), cdt, ctx)


def _embed(params, tokens, cdt, ctx):
    """Token embeddings; over a model axis that cuts the vocabulary,
    vocabulary-parallel (`parallel.vocab_embed`), else from the whole
    table."""
    if tr.sharded(ctx):
        spec = ctx.spec("embed", "embedding")
        if par.vocab_cut(spec, ctx, 0):
            w = par.batch_gathered(params["embed"]["embedding"], spec, ctx)
            return par.vocab_embed(w, tokens, cdt, ctx)
    emb = _whole(params, ctx, "embed", "embedding")
    return embed({"embedding": emb}, tokens, cdt)


def _whole(params, ctx, *path):
    """A top-level leaf whole on this rank (`parallel.full_weight`)."""
    t = params
    for k in path:
        t = t[k]
    if not tr.sharded(ctx):
        return t
    return par.full_weight(t, ctx.spec(*path), ctx)


def _unembed_cut(params, ctx):
    """This rank's unembedding columns when the model axis cuts the
    vocabulary (FSDP gathered), else None."""
    if not tr.sharded(ctx):
        return None
    spec = ctx.spec("unembed", "kernel")
    if not par.vocab_cut(spec, ctx, 1):
        return None
    return par.batch_gathered(params["unembed"]["kernel"], spec, ctx)


def _head(params, x, cfg, ctx, cdt):
    """Final norm and unembedding of hidden rows x (..., d) → f32 logits
    (vocabulary-parallel over a model axis that cuts the vocabulary)."""
    h = rms_norm(x, _whole(params, ctx, "final_norm"), cfg.norm_eps)
    w = _unembed_cut(params, ctx)
    if w is not None:
        return par.vocab_logits(h, w.to(cdt), ctx)
    return (h @ _whole(params, ctx, "unembed", "kernel").to(cdt)).float()


def _batch_sum(x, ctx, value_only: bool = False):
    """The sum of x over the batch ranks: forward-only (`value_only`), or
    with an identity backward (each rank back-propagates its own term)."""
    if not tr.sharded(ctx):
        return x
    for ax in ctx.batch_axes:
        g = ctx.group(ax)
        x = (par.all_reduce_value(x, g) if value_only
             else par.leave(x, g))
    return x


def forward_hidden(cfg: ModelConfig, pcfg: ParallelConfig, params, batch,
                   *, spamm_cfg=None, collect_spamm_stats: bool = False,
                   ctx=None):
    """tokens or embeds → final-normed hidden states (B, S, d) and the MoE
    aux loss; with `collect_spamm_stats` a third element (frac_sum,
    gemm_count, layer_frac_sums, layer_gemm_counts), see
    `transformer.stack_fwd`. Over a mesh: this rank's rows and shards."""
    spamm_cfg = spmod.as_context(spamm_cfg)
    x = _inputs(params, batch, _dtype(pcfg.compute_dtype), ctx)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None].expand(b, s)
    out = tr.stack_fwd(params, x, cfg, pcfg, positions, spamm_cfg=spamm_cfg,
                       collect_spamm_stats=collect_spamm_stats, ctx=ctx)
    h = rms_norm(out[0], _whole(params, ctx, "final_norm"), cfg.norm_eps)
    return (h,) + tuple(out[1:])


def loss_fn(cfg: ModelConfig, pcfg: ParallelConfig, params, batch, *,
            spamm_cfg=None, ctx=None):
    """(loss, metrics): the chunked cross-entropy of `batch["labels"]`
    plus `router_aux_weight` × the MoE aux loss. With SpAMM on the metrics
    add the mean valid fraction over the step's gated GEMMs
    (`spamm_valid_fraction`), their count (`spamm_gated_gemms`) and both
    per layer (`spamm_layer_*`, stack order), as device tensors.

    Over a mesh the loss is the global one: the summed cross-entropy and
    the label count are each summed over the batch ranks before the one
    division, and the aux loss is the mean of the data ranks'. Each rank
    back-propagates its own term (the sum's backward is the identity), so
    the data ranks' gradients add up to the global loss's. A model axis
    that cuts the vocabulary makes the cross-entropy vocabulary-parallel
    (`parallel.vocab_ce_parts`). The gating metrics are this rank's."""
    spamm_cfg = spmod.as_context(spamm_cfg)
    collect = spamm_cfg is not None and spamm_cfg.enable
    out = forward_hidden(cfg, pcfg, params, batch, spamm_cfg=spamm_cfg,
                         collect_spamm_stats=collect, ctx=ctx)
    h, aux = out[0], out[1]
    w = _unembed_cut(params, ctx)
    if w is not None:
        tot, cnt = par.vocab_ce_parts(h, w.to(h.dtype), batch["labels"],
                                      pcfg.loss_chunk, ctx)
    else:
        unembed = _whole(params, ctx, "unembed", "kernel").to(h.dtype)
        tot, cnt = chunked_ce_parts(h, unembed, batch["labels"],
                                    pcfg.loss_chunk)
    cnt = _batch_sum(cnt, ctx, value_only=True)
    ndata = ctx.ndata if tr.sharded(ctx) else 1
    ce = _batch_sum(tot / cnt.clamp(min=1.0), ctx)
    if ndata > 1:
        aux = _batch_sum(torch.as_tensor(aux, device=h.device) / ndata, ctx)
    aux_w = cfg.moe.router_aux_weight if cfg.moe is not None else 0.0
    met = {"ce": ce, "aux": aux}
    if collect:
        vs, vc, lvs, lvc = out[2]
        met["spamm_valid_fraction"] = vs / vc.clamp(min=1.0)
        met["spamm_gated_gemms"] = vc
        met["spamm_layer_valid_fraction"] = lvs / lvc.clamp(min=1.0)
        met["spamm_layer_gated_gemms"] = lvc
    return ce + aux_w * aux, met


def _sync_grads(grads: dict, ctx) -> None:
    """The data-parallel sum of every leaf not placed on a batch axis
    (FSDP leaves were summed by their all-gathers' backward), in place."""
    if not tr.sharded(ctx):
        return
    for g, spec in T.pairs(grads, ctx.specs):
        placed = {a for e in spec for a in _entry_axes(e)}
        for ax in ctx.batch_axes:
            if ax not in placed and ctx.size(ax) > 1:
                par.dist.all_reduce(g, group=ctx.group(ax))


def make_train_step(cfg: ModelConfig, pcfg: ParallelConfig, optimizer, *,
                    spamm_cfg=None, ctx=None):
    """fn(params, opt_state, batch, step) → (params, opt_state, metrics):
    one eager step — the loss, `loss.backward()`, then
    `optimizer.update`, which writes the parameters and moments in place.
    `metrics` holds the loss, the gradient norm and `loss_fn`'s metrics,
    detached device tensors. Over a mesh each rank passes its shards and
    batch rows; the gradients of leaves replicated over a batch axis are
    summed over it before the update, which clips by the global norm."""
    spamm_cfg = spmod.as_context(spamm_cfg)

    def step(params, opt_state, batch, step_no):
        for p in T.leaves(params):
            p.requires_grad_(True)
            p.grad = None
        loss, met = loss_fn(cfg, pcfg, params, batch, spamm_cfg=spamm_cfg,
                            ctx=ctx)
        loss.backward()
        grads = T.map_(lambda p: (p.grad if p.grad is not None
                                  else torch.zeros_like(p)), params)
        for p in T.leaves(params):
            p.grad = None
        _sync_grads(grads, ctx)
        params, opt_state, gnorm = optimizer.update(
            params, grads, opt_state, step_no,
            ctx=ctx if tr.sharded(ctx) else None)
        metrics = {"loss": loss.detach(), "grad_norm": gnorm,
                   **{k: (v.detach() if isinstance(v, torch.Tensor) else v)
                      for k, v in met.items()}}
        return params, opt_state, metrics

    return step


def make_prefill_step(cfg: ModelConfig, pcfg: ParallelConfig, *,
                      spamm_cfg=None, ctx=None):
    """fn(params, batch, frozen=None) → (cache, last_logits (B, V) f32).
    `batch` holds `tokens` (B, S) int or `embeds` (B, S, d); `frozen` the
    FrozenPlan tree for B·S rows (or None: gated GEMMs plan eagerly). Over
    a mesh: this rank's rows, shards and frozen plans (of
    `compute_params`); its attention caches hold its kv heads over the
    whole prompt (`place_cache` makes the decode layout)."""
    spamm_cfg = spmod.as_context(spamm_cfg)

    def step(params, batch, frozen=None):
        cdt = _dtype(pcfg.compute_dtype)
        x = _inputs(params, batch, cdt, ctx)
        b, s, _ = x.shape
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None].expand(b, s)
        cache_len = min(cfg.sliding_window, s) if cfg.sliding_window else s
        x, cache = tr.stack_prefill(params, x, cfg, pcfg, positions,
                                    cache_len, spamm_cfg=spamm_cfg,
                                    frozen=frozen, ctx=ctx)
        return cache, _head(params, x[:, -1], cfg, ctx, cdt)

    return step


def make_prefill_chunk_step(cfg: ModelConfig, pcfg: ParallelConfig, *,
                            spamm_cfg=None, ctx=None):
    """fn(params, batch, cache, positions, last_idx, frozen=None) →
    (cache, logits (B, V) f32). One chunk of position-offset prefill at ONE
    static (B, C) shape: `batch["tokens"]` (B, C) (or `batch["embeds"]`
    (B, C, d)) runs the stack, writing K/V into the LINEAR decode cache IN
    PLACE at `positions` (B, C) int (absolute per-row indices; entries ≥
    the cache length are idle/pad sentinels whose writes drop). `logits`
    are read at `last_idx` (B,), the in-chunk index of each row's final
    prompt token, clamped to [0, C-1] (rows whose prompt does not end in
    this chunk give values the caller ignores). `frozen` is the
    FrozenPlan tree for B·C rows."""
    spamm_cfg = spmod.as_context(spamm_cfg)

    def step(params, batch, cache, positions, last_idx, frozen=None):
        cdt = _dtype(pcfg.compute_dtype)
        x = _inputs(params, batch, cdt, ctx)
        b, c, _ = x.shape
        x, cache = tr.stack_prefill_chunk(params, x, cache, positions, cfg,
                                          pcfg, spamm_cfg=spamm_cfg,
                                          frozen=frozen, ctx=ctx)
        idx = last_idx.long().clamp(0, c - 1)
        return cache, _head(params, x[torch.arange(b, device=x.device), idx],
                            cfg, ctx, cdt)

    return step


def make_decode_step(cfg: ModelConfig, pcfg: ParallelConfig, *,
                     spamm_cfg=None, ctx=None):
    """fn(params, inp, cache, pos, frozen=None) → (logits (B, V) f32,
    cache). `inp` is (B, 1) token ids or (B, 1, d) embeddings. `pos` is
    an int or a 0-d int tensor (lockstep), or a (B,) int32 tensor of
    per-row positions whose entries ≥ the cache length are sentinels
    (`transformer.attention_decode`); the cache is written in place.
    Decode GEMMs gate only through `frozen` plans; sites without one stay
    dense. Over a mesh: this rank's rows, shards, cache (`init_cache` /
    `place_cache` with the same ctx) and frozen plans."""
    spamm_cfg = spmod.as_context(spamm_cfg)

    def step(params, inp, cache, pos, frozen=None):
        cdt = _dtype(pcfg.compute_dtype)
        x = inp.to(cdt) if inp.dim() == 3 else _embed(params, inp.long(),
                                                       cdt, ctx)
        x, cache = tr.stack_decode(params, x, cache, pos, cfg, pcfg,
                                   spamm_cfg=spamm_cfg, frozen=frozen,
                                   ctx=ctx)
        return _head(params, x[:, 0], cfg, ctx, cdt), cache

    return step


def reshard_probe(controller, spamm_ctx, params, step: int, *,
                  tokens=None, x=None) -> None:
    """The re-sharding probe body the serving engine and the train loop
    share. Activation rows come from `x` (frontend archs feed embeddings)
    or from `tokens` through the embedding table (ids taken modulo the
    vocabulary). Their norms are fresh; the weight side is the cached
    `WeightPlanCache.weight_side` of the unembedding (every arch has one,
    shaped like a gated GEMM's weight side), so a probe costs one
    activation get-norm. Feeds the controller when the row grid has at
    least one row tile per strip."""
    from repro_torch.core import schedule as _schedule

    scfg = spamm_ctx.cfg
    lv = controller.cfg.level
    with torch.no_grad():
        if x is None:
            emb = params["embed"]["embedding"]
            ids = torch.as_tensor(np.asarray(tokens, np.int64) % emb.shape[0],
                                  device=emb.device)
            x = emb[ids]
        _, nw = spamm_ctx.cache.weight_side(
            params["unembed"]["kernel"], tile=scfg.tile, backend=scfg.backend,
            levels=lv)
        v, fine_rows = _schedule.probe_v_estimate(
            x, nw, scfg.tau, tile=scfg.tile, backend=scfg.backend, level=lv)
    if fine_rows >= controller.cfg.num_devices:
        controller.probe(v, step, level=lv, fine_rows=fine_rows)
