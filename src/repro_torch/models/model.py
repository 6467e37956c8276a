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
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core import module as spmod
from repro_torch.device import resolve_device
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tr
from repro_torch.models.layers import _normal, chunked_ce_loss, embed, rms_norm

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def _dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def init_params(cfg: ModelConfig, pcfg: ParallelConfig, seed: int = 0, *,
                device="cuda") -> dict:
    """Random parameters from a `torch.Generator` seeded with `seed`, made
    directly on `device` (the card unless asked otherwise). The
    distributions are the reference's; the numbers differ (another RNG) —
    use `params_from_jax` to run the reference's exact weights."""
    dev = resolve_device(device)
    pdt = _dtype(pcfg.param_dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    s = 1.0 / math.sqrt(cfg.d_model)
    return {
        "embed": {"embedding": _normal(gen, (cfg.vocab, cfg.d_model), s, pdt,
                                       dev)},
        "final_norm": torch.zeros(cfg.d_model, dtype=torch.float32,
                                  device=dev),
        "unembed": {"kernel": _normal(gen, (cfg.d_model, cfg.vocab), s, pdt,
                                      dev)},
        "layers": [tr.layer_params(gen, cfg, pdt, dev, kind)
                   for kind in tr.layer_kinds(cfg)],
    }


def params_from_jax(np_tree: dict, cfg: ModelConfig, *,
                    device="cuda") -> dict:
    """The reference's parameter pytree, as numpy arrays, → the port's tree
    on `device`: layers stacked on a leading L axis become a list of L
    per-layer dicts; a hybrid stack's group g sub-layer `l{i}` becomes layer
    g·len(group) + i, and its tail's `l{i}` the i-th layer after the
    groups. Every leaf is copied."""
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


def init_cache(cfg: ModelConfig, pcfg: ParallelConfig, batch: int,
               max_len: int, *, full: bool = False, device="cuda") -> dict:
    """Zeroed decode caches, one dict per layer in stack order: an attention
    layer's {"k", "v"} (B, S, Hk, hd), S max_len or the sliding window when
    that is smaller (the decode ring) — `full=True` always gives max_len,
    the chunked plane's LINEAR cache, where a window applies as a mask; an
    SSM layer's {"state" (B, H, P, N) f32, "conv" (B, K-1, conv_ch)}; a rec
    layer's {"h" (B, W) f32, "conv" (B, K-1, W)} (the reference's dtypes:
    states f32, conv histories at the compute dtype)."""
    dev = resolve_device(device)
    cdt = _dtype(pcfg.compute_dtype)
    f32 = torch.float32

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def attn_cache():
        s = (min(max_len, cfg.sliding_window)
             if cfg.sliding_window and not full else max_len)
        shape = (batch, s, cfg.num_kv_heads, cfg.resolved_head_dim)
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


def _inputs(params, batch, cdt) -> torch.Tensor:
    """A batch's (B, S, d) stack input: its `embeds` (the stub frontends'
    precomputed embeddings) or its `tokens` through the embedding."""
    if "embeds" in batch:
        return batch["embeds"].to(cdt)
    return embed(params["embed"], batch["tokens"].long(), cdt)


def forward_hidden(cfg: ModelConfig, pcfg: ParallelConfig, params, batch,
                   *, spamm_cfg=None, collect_spamm_stats: bool = False):
    """tokens or embeds → final-normed hidden states (B, S, d) and the MoE
    aux loss; with `collect_spamm_stats` a third element (frac_sum,
    gemm_count, layer_frac_sums, layer_gemm_counts), see
    `transformer.stack_fwd`."""
    spamm_cfg = spmod.as_context(spamm_cfg)
    x = _inputs(params, batch, _dtype(pcfg.compute_dtype))
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None].expand(b, s)
    out = tr.stack_fwd(params, x, cfg, pcfg, positions, spamm_cfg=spamm_cfg,
                       collect_spamm_stats=collect_spamm_stats)
    h = rms_norm(out[0], params["final_norm"], cfg.norm_eps)
    return (h,) + tuple(out[1:])


def loss_fn(cfg: ModelConfig, pcfg: ParallelConfig, params, batch, *,
            spamm_cfg=None):
    """(loss, metrics): the chunked cross-entropy of `batch["labels"]`
    plus `router_aux_weight` × the MoE aux loss. With SpAMM on the metrics
    add the mean valid fraction over the step's gated GEMMs
    (`spamm_valid_fraction`), their count (`spamm_gated_gemms`) and both
    per layer (`spamm_layer_*`, stack order), as device tensors."""
    spamm_cfg = spmod.as_context(spamm_cfg)
    collect = spamm_cfg is not None and spamm_cfg.enable
    out = forward_hidden(cfg, pcfg, params, batch, spamm_cfg=spamm_cfg,
                         collect_spamm_stats=collect)
    h, aux = out[0], out[1]
    unembed = params["unembed"]["kernel"].to(h.dtype)
    ce = chunked_ce_loss(h, unembed, batch["labels"], pcfg.loss_chunk)
    aux_w = cfg.moe.router_aux_weight if cfg.moe is not None else 0.0
    met = {"ce": ce, "aux": aux}
    if collect:
        vs, vc, lvs, lvc = out[2]
        met["spamm_valid_fraction"] = vs / vc.clamp(min=1.0)
        met["spamm_gated_gemms"] = vc
        met["spamm_layer_valid_fraction"] = lvs / lvc.clamp(min=1.0)
        met["spamm_layer_gated_gemms"] = lvc
    return ce + aux_w * aux, met


def make_train_step(cfg: ModelConfig, pcfg: ParallelConfig, optimizer, *,
                    spamm_cfg=None):
    """fn(params, opt_state, batch, step) → (params, opt_state, metrics):
    one eager step — the loss, `loss.backward()`, then
    `optimizer.update`, which writes the parameters and moments in place.
    `metrics` holds the loss, the gradient norm and `loss_fn`'s metrics,
    detached device tensors."""
    spamm_cfg = spmod.as_context(spamm_cfg)

    def step(params, opt_state, batch, step_no):
        for p in T.leaves(params):
            p.requires_grad_(True)
            p.grad = None
        loss, met = loss_fn(cfg, pcfg, params, batch, spamm_cfg=spamm_cfg)
        loss.backward()
        grads = T.map_(lambda p: (p.grad if p.grad is not None
                                  else torch.zeros_like(p)), params)
        for p in T.leaves(params):
            p.grad = None
        params, opt_state, gnorm = optimizer.update(params, grads,
                                                    opt_state, step_no)
        metrics = {"loss": loss.detach(), "grad_norm": gnorm,
                   **{k: (v.detach() if isinstance(v, torch.Tensor) else v)
                      for k, v in met.items()}}
        return params, opt_state, metrics

    return step


def make_prefill_step(cfg: ModelConfig, pcfg: ParallelConfig, *,
                      spamm_cfg=None):
    """fn(params, batch, frozen=None) → (cache, last_logits (B, V) f32).
    `batch` holds `tokens` (B, S) int or `embeds` (B, S, d); `frozen` the
    FrozenPlan tree for B·S rows (or None: gated GEMMs plan eagerly)."""
    spamm_cfg = spmod.as_context(spamm_cfg)

    def step(params, batch, frozen=None):
        cdt = _dtype(pcfg.compute_dtype)
        x = _inputs(params, batch, cdt)
        b, s, _ = x.shape
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None].expand(b, s)
        cache_len = min(cfg.sliding_window, s) if cfg.sliding_window else s
        x, cache = tr.stack_prefill(params, x, cfg, pcfg, positions,
                                    cache_len, spamm_cfg=spamm_cfg,
                                    frozen=frozen)
        h_last = rms_norm(x[:, -1], params["final_norm"], cfg.norm_eps)
        logits = (h_last @ params["unembed"]["kernel"].to(cdt)).float()
        return cache, logits

    return step


def make_prefill_chunk_step(cfg: ModelConfig, pcfg: ParallelConfig, *,
                            spamm_cfg=None):
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
        x = _inputs(params, batch, cdt)
        b, c, _ = x.shape
        x, cache = tr.stack_prefill_chunk(params, x, cache, positions, cfg,
                                          pcfg, spamm_cfg=spamm_cfg,
                                          frozen=frozen)
        idx = last_idx.long().clamp(0, c - 1)
        h_last = rms_norm(x[torch.arange(b, device=x.device), idx],
                          params["final_norm"], cfg.norm_eps)
        logits = (h_last @ params["unembed"]["kernel"].to(cdt)).float()
        return cache, logits

    return step


def make_decode_step(cfg: ModelConfig, pcfg: ParallelConfig, *,
                     spamm_cfg=None):
    """fn(params, inp, cache, pos, frozen=None) → (logits (B, V) f32,
    cache). `inp` is (B, 1) token ids or (B, 1, d) embeddings. `pos` is
    an int or a 0-d int tensor (lockstep), or a (B,) int32 tensor of
    per-row positions whose entries ≥ the cache length are sentinels
    (`transformer.attention_decode`); the cache is written in place.
    Decode GEMMs gate only through `frozen` plans; sites without one stay
    dense."""
    spamm_cfg = spmod.as_context(spamm_cfg)

    def step(params, inp, cache, pos, frozen=None):
        cdt = _dtype(pcfg.compute_dtype)
        x = (inp.to(cdt) if inp.dim() == 3
             else embed(params["embed"], inp.long(), cdt))
        x, cache = tr.stack_decode(params, x, cache, pos, cfg, pcfg,
                                   spamm_cfg=spamm_cfg, frozen=frozen)
        h = rms_norm(x[:, 0], params["final_norm"], cfg.norm_eps)
        logits = (h @ params["unembed"]["kernel"].to(cdt)).float()
        return logits, cache

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
