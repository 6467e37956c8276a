"""Fault-tolerant training loop of the port (twin of `repro.train.loop`).

  * checkpoint/restart: atomic snapshots every `ckpt_every` steps; resume
    from the latest restores the parameters, the moments and the step, and
    the data stream continues at that step;
  * straggler watchdog: a step slower than `straggler_factor` × the median
    of the registry's recent `train_step_seconds` samples is counted;
  * failure injection (`fail_at_step`) to exercise the restart path;
  * optional int8 gradient compression with error feedback.

Each step is eager PyTorch (`models.model.make_train_step`): the loss,
`loss.backward()`, then the AdamW update in place. With SpAMM on, each
step's gating stats (the mean valid fraction and the count of gated GEMMs,
overall and per layer) come back with its loss in one transfer and feed
the `spamm_valid_fraction{phase="train"}` histogram.

Drift-triggered re-sharding (`reshard_cfg`, the serving engine's control
plane): every `reshard_cfg.every` steps, after the step, the shared probe
(`models.model.reshard_probe`: the step's token embeddings, or its
`embeds`, against the cached weight-side norms of the unembedding) feeds a
`ReshardController`, which re-cuts the equal-work partition on drift. It
never touches the computed values; each step's stats gain the live
partition's `imbalance`, the `resharded` count, its `offsets` and per-strip
predicted `loads`. `num_devices=0` resolves to the mesh's batch-axis
extent (1 on one device).

Over a (data, model) mesh (`ctx`, a `transformer.NetCtx`; its placements
are the model's unless it carries some) every rank makes its shards of the
parameters from the seed (`models.model.init_params(ctx=)`: each piece is
cut as soon as it is made), the moments beside them, and trains on its
data rank's rows of each global batch. The loss is the global one. A
checkpoint holds the whole tree: the shards are gathered leaf by leaf and
only the rank at data 0, model 0 keeps them, on the host, and writes
them. A resume reads the whole tree one leaf at a time and keeps the
mesh's shards of it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import ModelConfig, ParallelConfig, TrainConfig
from repro_torch.core import module as spmod
from repro_torch.core import schedule as _schedule
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.distributed.compression import Int8EF
from repro_torch.models import model as M
from repro_torch.obs import FRACTION_BUCKETS, LATENCY_BUCKETS_S, Observability
from repro_torch.optim.adamw import AdamW


@dataclasses.dataclass
class TrainResult:
    losses: list
    restarts: int
    straggler_steps: int
    final_step: int
    # one entry per executed step with SpAMM on: {"step", "valid_fraction",
    # "gated_gemms", "per_layer": {layer: {"valid_fraction",
    # "gated_gemms"}}}, and with re-sharding "imbalance", "resharded",
    # "offsets", "loads"; empty with SpAMM off
    spamm_stats: list = dataclasses.field(default_factory=list)
    # the run's Observability bundle (train_step_seconds, the per-layer
    # spamm_valid_fraction series, train_step and checkpoint_save spans)
    obs: Optional[Observability] = None
    # each executed step's global gradient norm (before the clip)
    grad_norms: list = dataclasses.field(default_factory=list)
    # the parameters and optimizer state after the last step (this rank's
    # shards over a mesh)
    params: Optional[dict] = None
    opt_state: Optional[dict] = None


def train(cfg: ModelConfig, pcfg: ParallelConfig, tcfg: TrainConfig, *,
          global_batch: int = 8, seq_len: int = 128, spamm_cfg=None,
          reshard_cfg=None, fail_at_step: Optional[int] = None,
          resume: bool = False, straggler_factor: float = 3.0,
          log_every: int = 10, obs=None, device="cuda",
          ctx=None) -> TrainResult:
    """Train from `init_params(seed=tcfg.seed)` (or the latest checkpoint
    with `resume`) up to `tcfg.total_steps` on `device` (the card unless
    asked otherwise), over the mesh of `ctx` when given. `reshard_cfg` (a
    `core.schedule.ReshardConfig`) arms the re-sharding probe when SpAMM
    is on."""
    dev = resolve_device(device)
    sharded = ctx is not None and ctx.mesh is not None
    if sharded and ctx.specs is None:
        ctx = M.with_placements(ctx, cfg, pcfg)
    obs = Observability.ensure(obs, process_name="repro-train")
    # keep_recent=50 retains the raw samples the straggler watchdog's
    # rolling median reads
    step_h = obs.registry.histogram(
        "train_step_seconds", "optimizer step wall-clock (dispatch + block)",
        buckets=LATENCY_BUCKETS_S, keep_recent=50)
    compression = Int8EF() if pcfg.grad_compression == "int8_ef" else None
    opt = AdamW(tcfg, compression=compression)
    data = SyntheticLM(cfg, global_batch, seq_len, seed=tcfg.seed,
                       device=str(dev))
    rows = None
    if sharded:
        if global_batch % ctx.ndata:
            raise ValueError(f"global batch {global_batch} does not split "
                             f"over {ctx.ndata} data ranks")
        w = global_batch // ctx.ndata
        rows = slice(ctx.data_index * w, (ctx.data_index + 1) * w)

    params = M.init_params(cfg, pcfg, tcfg.seed, device=dev,
                           ctx=ctx if sharded else None)
    opt_state = opt.init(params)
    start_step = 0
    if resume and (last := ckpt.latest_step(tcfg.ckpt_dir)) is not None:
        state = {"params": params, "opt_state": opt_state}
        cut = _shard_cuts(state, ctx) if sharded else None
        try:
            full = ckpt.restore(tcfg.ckpt_dir, last, state, cut=cut)
            params, opt_state = full["params"], full["opt_state"]
        except KeyError:  # a checkpoint without moments
            params = ckpt.restore(tcfg.ckpt_dir, last, {"params": params},
                                  cut=cut)["params"]
        start_step = last
        del state

    spamm_ctx = spmod.as_context(spamm_cfg)
    collect_spamm = spamm_ctx is not None and spamm_ctx.enable
    if spamm_ctx is not None:
        spamm_ctx.set_phase("train")
    step_fn = M.make_train_step(cfg, pcfg, opt, spamm_cfg=spamm_ctx,
                                ctx=ctx if sharded else None)
    resharder = None
    if reshard_cfg is not None and collect_spamm and reshard_cfg.every > 0:
        resharder = _schedule.ReshardController(
            _schedule.resolve_reshard_devices(
                reshard_cfg, ctx.mesh if sharded else 1,
                ctx.batch_axes if sharded else ("data",)))

    losses, grad_norms, spamm_stats = [], [], []
    stragglers = 0
    restarts = 1 if resume and start_step else 0
    step = start_step
    m_vf = (obs.registry.histogram(
        "spamm_valid_fraction", labelnames=("phase", "layer", "site"),
        buckets=FRACTION_BUCKETS) if obs.enabled and collect_spamm else None)
    while step < tcfg.total_steps:
        if fail_at_step is not None and step == fail_at_step:
            raise RuntimeError(f"injected failure at step {step}")
        batch = data.batch_at(step)
        if rows is not None:
            batch = {k: v[rows] for k, v in batch.items()}
        t0 = time.perf_counter()
        t0_ns = time.perf_counter_ns()
        params, opt_state, metrics = step_fn(params, opt_state, batch, step)
        # the loss and the stats in one device-to-host transfer (the step's
        # sync point)
        host = _to_host(metrics, ("loss", "grad_norm")
                        + (_STATS if collect_spamm else ()))
        loss = host["loss"][0]
        grad_norms.append(host["grad_norm"][0])
        obs.tracer.add_complete("train_step", t0_ns, time.perf_counter_ns(),
                                step=step)
        if resharder is not None and resharder.due(step):
            with obs.span("reshard_probe", step=step):
                probe_params = params
                if sharded:
                    probe_params = {k: M.gather_params(
                        params[k], ctx.specs[k], ctx)
                        for k in ("embed", "unembed")}
                if "tokens" in batch:
                    M.reshard_probe(resharder, spamm_ctx, probe_params, step,
                                    tokens=batch["tokens"].reshape(-1).cpu())
                else:
                    M.reshard_probe(resharder, spamm_ctx, probe_params, step,
                                    x=batch["embeds"].reshape(-1,
                                                              cfg.d_model))
            if obs.enabled:
                resharder.publish(obs.registry)
        sp = None
        if collect_spamm:
            n_gemms = int(host["spamm_gated_gemms"][0])
            lvf = host["spamm_layer_valid_fraction"]
            lvc = host["spamm_layer_gated_gemms"]
            sp = {"step": step,
                  "valid_fraction": (host["spamm_valid_fraction"][0]
                                     if n_gemms else None),
                  "gated_gemms": n_gemms,
                  "per_layer": {
                      i: {"valid_fraction": lvf[i] if lvc[i] else None,
                          "gated_gemms": int(lvc[i])}
                      for i in range(len(lvf))}}
            if resharder is not None:
                offs, loads = resharder.offsets, resharder.live_loads
                sp["imbalance"] = resharder.live_imbalance
                sp["resharded"] = resharder.resharded
                sp["offsets"] = (None if offs is None
                                 else [int(o) for o in offs])
                sp["loads"] = (None if loads is None
                               else [float(x) for x in loads])
            if m_vf is not None:
                for i in range(len(lvf)):
                    if lvc[i]:
                        m_vf.observe(lvf[i], phase="train", layer=i, site="")
            spamm_stats.append(sp)
        dt = time.perf_counter() - t0
        step_h.observe(dt)
        med = float(np.median(step_h.recent()))
        if step_h.count() > 5 and dt > straggler_factor * med:
            stragglers += 1
        losses.append(loss)
        if log_every and step % log_every == 0:
            extra = ""
            if sp is not None and sp["valid_fraction"] is not None:
                extra = (f" spamm_valid {sp['valid_fraction']:.3f} "
                         f"({sp['gated_gemms']} gemms)")
            print(f"step {step:5d} loss {loss:.4f} ({dt*1e3:.0f} ms){extra}",
                  flush=True)
        step += 1
        if tcfg.ckpt_every and step % tcfg.ckpt_every == 0:
            with obs.span("checkpoint_save", step=step):
                state = {"params": params, "opt_state": opt_state}
                writer = not sharded or (ctx.data_index == 0
                                         and ctx.mrank == 0)
                if sharded:
                    state = M.gather_params(
                        state, _state_specs(state, ctx), ctx, keep=writer,
                        device="cpu")
                if writer:
                    ckpt.save(tcfg.ckpt_dir, step, state)
                del state
    return TrainResult(losses, restarts, stragglers, step, spamm_stats,
                       obs=obs, grad_norms=grad_norms, params=params,
                       opt_state=opt_state)


def _state_specs(state: dict, ctx) -> dict:
    """The placements of {"params", "opt_state": {moment: tree}}: every
    moment is placed as the parameters are."""
    return {"params": ctx.specs,
            "opt_state": {k: ctx.specs for k in state["opt_state"]}}


def _shard_cuts(state: dict, ctx) -> dict:
    """{checkpoint path: fn(whole leaf) → this rank's shard} of `state`'s
    leaves (`ckpt.restore(cut=)`)."""
    specs = _state_specs(state, ctx)
    paths = [p for p, _ in T.flatten_with_paths(state)]
    return {p: (lambda t, spec=spec: M.shard_params(t, spec, ctx))
            for p, (_, spec) in zip(paths, T.pairs(state, specs))}


_STATS = ("spamm_valid_fraction", "spamm_gated_gemms",
          "spamm_layer_valid_fraction", "spamm_layer_gated_gemms")


def _to_host(metrics: dict, names) -> dict:
    """{name: list of host floats} of the named metrics, read in one
    transfer."""
    parts = [metrics[n].detach().float().reshape(-1) for n in names]
    vals = torch.cat(parts).cpu().tolist()
    out, i = {}, 0
    for n, p in zip(names, parts):
        out[n] = vals[i:i + p.numel()]
        i += p.numel()
    return out
