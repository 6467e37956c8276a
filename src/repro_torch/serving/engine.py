"""Batched serving engine of the port: the two unsharded data planes of
`repro.serving.engine`.

* WAVE plane (equal-length prompts, unless `prefill_chunk` asks for
  chunks): one-shot prefill of the whole batch, then lockstep greedy
  decode until every sequence finishes.
* CHUNKED plane (`prefill_chunk`, and automatically for mixed-length
  prompts): a power-of-two-bucketed pool of slots. Each iteration admits
  queued requests into idle slots, advances every prefilling slot by one
  tile-aligned chunk at ONE static (slots, C) shape (writing K/V into a
  full-length linear cache at per-slot positions; idle and pad lanes carry
  position sentinels whose writes drop), emits and frees, then runs one
  decode step over the decoding slots at per-slot positions. No prompt is
  trimmed; a slot frees on EOS or its token budget and the next queued
  request takes it.

Frozen plans: with SpAMM on, the engine freezes every gated weight once
(`plans.precompute.freeze_tree`, through the SpAMM context's
`WeightPlanCache`) and specializes the frozen artifacts per activation row
grid (`_frozen_for`, cached in `_fp_cache`), so every step only reads
device-resident step tables. With a plan store (`plan_store=`, populated
offline by `launch.precompute_plans`) the freeze is a pure load.

Step graphs: every decode step (both planes) and every chunk step runs
through a `serving.graphs.StepGraph` with static buffers, keyed like the
reference's jit cache — the wave's decode on its exact batch, the chunked
plane's decode and chunk steps on the slot count. On the card (the
default, `cuda_graphs=True`) each key is captured once as a CUDA graph
and replayed; `cuda_graphs=False` runs the same steps eagerly, for
comparison. `trace_counts` counts the captures (on the CPU, the first use
of each key). The wave's one-shot prefill stays eager: it runs once per
wave at a new shape. A MoE stack's chunk steps with SpAMM on stay eager
too: their expert and shared-expert GEMMs plan eagerly, and `plan()` runs
on the host. The engine decides this at construction from the config
(never by catching a failed capture) and reports it in each request's
`out["graphs"]`; a MoE decode step is dense in its experts and captures.
Recurrent stacks (mamba2's SSM, recurrentgemma's hybrid) serve on the wave
plane only, as the reference's do: their prefill state does not checkpoint
at a chunk boundary, so `prefill_chunk` and mixed-length batches raise.
Their decode steps update the recurrent state and conv histories in the
static cache in place, so they capture like the others.

Drift-triggered re-sharding (`reshard_cfg`, a `core.schedule.ReshardConfig`):
the engine owns a `ReshardController` holding the equal-work row partition
a multi-GPU deployment places by. Every `reshard_cfg.every` engine steps
(a prefill or a chunk step counts one, each decode step one, across waves)
it probes the work estimate (`models.model.reshard_probe`: the live tokens'
embedding norms against the cached weight-side norms of the unembedding)
and re-cuts on drift. Pure control plane: tokens are bit-identical with
re-sharding on, off or at any cadence; `out["spamm"]` reports the wave's
`resharded` events, `reshard_probes` and the live `partition_imbalance`.

Pod-sharded mode (`mesh_devices=N > 1`): single-controller, as the
reference's is — one host drives N devices (`devices`, default cuda:0 …
cuda:N-1; one card shared by N shards is an explicit list). Frozen plans
are required and MoE archs refused. A wave's requests are cut into
contiguous groups of `tile` requests, placed by the live offsets
(`schedule.rescale_offsets` onto the group grid, `schedule.strip_tables`
for the clamp-padded slots), every shard padded to one static width
(`shard_max_width` groups, default 2·ceil(G/N)). Each shard's step tables
are `FrozenWeight.shard_by_offsets` plans sliced on the host at
(re-)shard time; pad rows do no gated work. Each shard's decode and chunk
steps are `StepGraph`s captured on its device; a re-cut copies the new
tables into the captured buffers (`FrozenPlan.copy_`) and moves request
rows between the shards' caches, and never recaptures, so the capture
counts stay fixed. Cuts fall on request groups and prompts must be
tile-aligned, so the tokens equal the unsharded engine's bit for bit.

Tensor-parallel mode (`ctx`, a `transformer.NetCtx` over a (data, model)
mesh with the model's placements): SPMD, one engine per rank. Every rank is
given the same requests and returns every request's tokens (the logits are
whole on every rank: the head all-gathers the vocabulary cut). `params` are
this rank's shards (`init_params(ctx=)` or `shard_params`; a whole tree
raises); the frozen plans are those of the weights the rank computes with
(`models.model.compute_params`), so a warm plan store hits each rank's own
shards; the caches hold the rank's kv heads, or with `decode_seq_shard` its
sequence slice of every kv head (the wave plane only: the chunked plane's
linear cache and per-slot decode always cut kv heads, as a sentinel write
cannot land in another rank's slice). A gated GEMM split over "model" taps
the fraction of the whole GEMM (`parallel.split_matmul`), so `out["spamm"]`
and the registry equal the unsharded engine's. Whether steps run as CUDA
graphs is decided once, from the model group's backend: under nccl the
decode and chunk steps are captured with their collectives inside (a
failed capture raises); under gloo (ranks that share a card, or CPU ranks)
the collectives pass through the host, so the steps run eagerly and
`out["graphs"]["eager"]` says why. The
batch axes must hold one rank: data-parallel serving is the pod-sharded
mode, whose cuts keep decode row tiles whole.

Telemetry (`obs`, a `repro_torch.obs.Observability` bundle), all on the
host: every gated GEMM's tap carries its phase, site and layer, so
`Request.out["spamm"]["per_layer"]` breaks the wave's valid fractions,
counts and GEMM bytes down per (layer, site); the registry gets the
reference's metrics after the wave's one `end_stats()` transfer; the span
tracer records freeze, plan_assembly, prefill, decode_step, prefill_chunk
and wave spans, each closed at the loop's existing blocking point; the
cost-residual channel pairs each phase's predicted seconds (from the
frozen GEMMs' static cost terms, recorded at the call or the capture, and
their drained fractions and bytes) with the measured TTFT and decode
time. Labels and cost terms are host values recorded beside the taps: a
step runs the same device ops, and a CUDA graph captures the same nodes,
with `obs` on or off. `obs=False` is the hard-off A/B baseline: no spans,
no latency block under `out["spamm"]`, no cost terms; tokens are the same.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core import cost as _cost
from repro_torch.core import module as spmod
from repro_torch.core import schedule as _schedule
from repro_torch.core.cost import bucket
from repro_torch.device import f32_numerics, resolve_device
from repro_torch.kernels.ops import resolve_backend
from repro_torch.models import model as M
from repro_torch.models.transformer import group_len, sharded, stack_kinds
from repro_torch.obs import (FRACTION_BUCKETS, LATENCY_BUCKETS_S, Histogram,
                             Observability)
from repro_torch.serving.graphs import StepGraph, pool_bytes

# queue depth and slot occupancy of the chunked plane, per iteration
COUNT_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)


def wave_latency(ttft_s, decode_lat) -> dict:
    """A wave's latency block: TTFT, the decode-step count and, with at
    least one step, the mean and the p50/p95 interpolated from a
    wave-local histogram on the registry's latency ladder (the reference's
    `decode_p50_s`/`decode_p95_s`)."""
    lat = {"ttft_s": ttft_s, "decode_steps": len(decode_lat)}
    if decode_lat:
        h = Histogram("wave_decode_step_seconds", buckets=LATENCY_BUCKETS_S)
        for v in decode_lat:
            h.observe(v)
        lat["decode_mean_s"] = float(np.mean(decode_lat))
        lat["decode_p50_s"] = h.quantile(0.5)
        lat["decode_p95_s"] = h.quantile(0.95)
    return lat


def _floor_pow2(n: int) -> int:
    """Largest power of two <= n (n >= 1): a non-power-of-two `max_slots`
    floors, so the cap on concurrent slots (and their KV memory) holds
    while the pool stays on the power-of-two bucket ladder."""
    return 1 << (int(n).bit_length() - 1)


def _emit_tokens(requests, outs, done, vis) -> None:
    """A lockstep wave's step on the host: each unfinished request takes
    its token from `vis` and finishes at its EOS or max_new_tokens."""
    for i, r in enumerate(requests):
        if not done[i]:
            outs[i].append(int(vis[i]))
            if ((r.eos_id is not None and int(vis[i]) == r.eos_id)
                    or len(outs[i]) >= r.max_new_tokens):
                done[i] = True


@dataclasses.dataclass
class Request:
    prompt: np.ndarray           # (S,) int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    out: Optional[dict] = None   # set by Engine.generate: {"tokens",
                                 # "spamm" (gating stats or None),
                                 # "latency" (host wall-clock of the wave,
                                 # `Engine._latency`), "graphs" (whether
                                 # decode and chunk steps are captured,
                                 # `Engine.step_graphs`)}


class Engine:
    """Greedy serving on `device` (the card unless asked otherwise).
    `spamm_cfg` (SpammConfig or SpammContext) turns on norm-gated GEMMs in
    prefill and decode, both through frozen plans. `plan_store` (a
    `plans.store.PlanStore` or its root directory) is the persistent tier
    the frozen artifacts load from.

    `prefill_chunk`: None chunks only a mixed-length batch (at
    `_default_chunk`); an int C always chunks at C (a multiple of the SpAMM
    tile when gating: gating is per row tile, so a cut inside a tile would
    change the gate); 0 never chunks, and a mixed batch then raises.
    `max_slots` caps the chunked plane's slot pool (floored to a power of
    two); below the batch size, queued requests wait for freed slots.
    `cuda_graphs` (default True; meaningless on the CPU, where nothing is
    captured) runs decode and chunk steps as CUDA graphs on the card;
    False runs the same steps eagerly. It may be switched between waves,
    so one engine (one freeze, the same frozen plans) can serve a wave
    both ways for comparison; each mode keeps its own steps.
    `obs`: an `Observability` bundle to share (the CLI passes one, so its
    dump covers the run), None for a private enabled bundle, False for
    hard-off (see the module docstring). `reshard_cfg` arms the
    re-sharding controller; `mesh_devices`, `shard_max_width` and
    `devices` the pod-sharded mode (see the module docstring).

    `ctx` (a `transformer.NetCtx` with placements) serves tensor-parallel
    over its model axis, one engine per rank (see the module docstring).
    `freeze_plans` (default: on whenever SpAMM is) False is the
    reference's legacy path: the prefill and chunk steps gate through
    eager plans (`WeightPlanCache`), the decode steps stay dense."""

    def __init__(self, cfg: ModelConfig, pcfg: ParallelConfig, params, *,
                 max_len: int = 512, spamm_cfg=None, plan_store=None,
                 prefill_chunk: Optional[int] = None,
                 max_slots: Optional[int] = None, cuda_graphs: bool = True,
                 device="cuda", obs=None,
                 reshard_cfg: Optional[_schedule.ReshardConfig] = None,
                 mesh_devices: int = 0,
                 shard_max_width: Optional[int] = None, devices=None,
                 ctx=None, freeze_plans: Optional[bool] = None):
        self.device = resolve_device(device)
        f32_numerics()
        emb = params["embed"]["embedding"]
        if emb.device.type != self.device.type:
            raise ValueError(f"params lie on {emb.device}, engine device is "
                             f"{self.device}")
        self.cfg, self.pcfg, self.params = cfg, pcfg, params
        self.max_len = max_len
        self.spamm_ctx = spmod.as_context(spamm_cfg)
        self._gated = self.spamm_ctx is not None and self.spamm_ctx.enable
        self._freeze = self._gated if freeze_plans is None else (
            bool(freeze_plans) and self._gated)
        self.ctx = ctx
        self._tp = ctx is not None and sharded(ctx)
        self._eager_reason = None   # why steps run eagerly under a ctx
        if ctx is not None and ctx.mesh is not None:
            self._check_ctx(ctx, mesh_devices, reshard_cfg)
        self._prefill_chunk = prefill_chunk
        self._max_slots = int(max_slots) if max_slots else None
        if self._max_slots is not None and self._max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        if prefill_chunk:
            c = int(prefill_chunk)
            if c < 1:
                raise ValueError(
                    f"prefill_chunk must be >= 1 (or 0/None), got "
                    f"{prefill_chunk}")
            if stack_kinds(cfg) != "attn":
                raise ValueError(
                    f"chunked prefill needs a stateless-FFN attention stack "
                    f"(got {stack_kinds(cfg)!r}: recurrent prefill state "
                    f"does not checkpoint at a chunk boundary)")
            if self._gated and c % self.spamm_ctx.cfg.tile:
                raise ValueError(
                    f"prefill_chunk={c} must be a multiple of the SpAMM "
                    f"tile ({self.spamm_ctx.cfg.tile}): gating is per row "
                    f"tile, so a chunk cut inside a tile would change tile "
                    f"membership and the gate")
        if isinstance(plan_store, str):
            from repro_torch.plans.store import PlanStore

            plan_store = PlanStore(plan_store)
        self.plan_store = plan_store
        if self._gated and plan_store is not None:
            self.spamm_ctx.cache.store = plan_store
        self._fw_tree = None     # params-shaped tree of FrozenWeight
        self._fp_cache: dict = {}  # row-tile grid gm → FrozenPlan tree
        self._gm_hist: dict = {}   # observed row-tile grid gm → step count
        # the legacy path's decode steps are dense, as the reference's
        dec_sc = self.spamm_ctx if self._freeze else None
        self._prefill = M.make_prefill_step(cfg, pcfg,
                                            spamm_cfg=self.spamm_ctx, ctx=ctx)
        self._decode = M.make_decode_step(cfg, pcfg, spamm_cfg=dec_sc,
                                          ctx=ctx)
        # the chunked plane's linear cache cuts kv heads over "model"
        self._slot_pcfg = (dataclasses.replace(pcfg, decode_seq_shard=False)
                           if self._tp and pcfg.decode_seq_shard else pcfg)
        self._slot_decode = (self._decode if self._slot_pcfg is pcfg else
                             M.make_decode_step(cfg, self._slot_pcfg,
                                                spamm_cfg=dec_sc, ctx=ctx))
        self._chunk = M.make_prefill_chunk_step(cfg, self._slot_pcfg,
                                                spamm_cfg=self.spamm_ctx,
                                                ctx=ctx)
        self.cuda_graphs = bool(cuda_graphs)
        # a gated MoE chunk step, and a chunk step on the legacy path, plan
        # on the host (see the module docstring): decided here, from the
        # config
        self._chunk_capturable = not (self._gated and (
            cfg.moe is not None or not self._freeze))
        self._pools: dict = {}    # device → graph memory pool, on capture
        self._steps: dict = {}    # (step key, captured) → StepGraph
        self._caches: dict = {}   # cache key → static KV cache
        self.trace_counts = {"prefill": 0, "decode": 0}
        self.chunk_steps = 0      # chunked-prefill steps, all waves
        self.admissions = 0       # requests admitted into a slot
        self.obs = Observability.ensure(obs, process_name="repro-engine")
        self._ndev = int(mesh_devices) if mesh_devices else 0
        self._sharded = self._ndev > 1
        self._shard_width = shard_max_width
        self._shard = None        # the live wave's sharding tables
        self._wave_full = False   # the live wave's caches are linear
        self._sfp_cache: dict = {}  # (tpg, width, offsets) → shard trees
        self._live: dict = {}     # (kind, shard, tpg, width) → [tree, cut]
        self._shard_caches: dict = {}  # (shard, slots, full) → KV cache
        if self._sharded:
            self._check_shardable(cfg)
            self._devices = self._shard_devices(devices, emb.device)
            self._params_on = {emb.device: params}
            for d in self._devices:
                if d not in self._params_on:
                    self._params_on[d] = T.map_(lambda t: t.to(d), params)
        self._engine_steps = 0    # prefill, chunk and decode steps, all waves
        self._resharder = None
        if reshard_cfg is not None and self._gated and reshard_cfg.every > 0:
            reshard_cfg = _schedule.resolve_reshard_devices(
                reshard_cfg, self._ndev if self._sharded else 1)
            if self._sharded and reshard_cfg.num_devices != self._ndev:
                raise ValueError(
                    f"reshard_cfg cuts {reshard_cfg.num_devices} strips but "
                    f"the engine shards over {self._ndev} devices — they "
                    f"must match (the cut IS the placement)")
            self._resharder = _schedule.ReshardController(reshard_cfg)
        if self._freeze and self.obs.enabled:
            # cost coefficients resolve once, before the first capture,
            # from the tune profile (or the nominal table) for the backend
            # and card the engine runs on
            scfg = self.spamm_ctx.cfg
            prof = _cost.CostProfile.load_or_default(
                getattr(scfg, "tune_profile", None))
            self.spamm_ctx.enable_cost_taps(prof.coeffs(
                resolve_backend(scfg.backend, self.device),
                _cost.device_kind(self.device)))
        if self.obs.enabled:
            self._register_metrics()

    def _register_metrics(self):
        """The reference engine's metrics, names, labels and buckets (the
        re-sharder's own series come from `ReshardController.publish`)."""
        reg = self.obs.registry
        self._m_ttft = reg.histogram(
            "serve_ttft_seconds", labelnames=(),
            help="wave start to first-token available (includes plan "
                 "assembly + prefill dispatch + execution)",
            buckets=LATENCY_BUCKETS_S)
        self._m_decode_s = reg.histogram(
            "serve_decode_step_seconds", labelnames=(),
            help="inter-token latency per decode step",
            buckets=LATENCY_BUCKETS_S)
        self._m_vf = reg.histogram(
            "spamm_valid_fraction", labelnames=("phase", "layer", "site"),
            help="per-execution gated-GEMM valid fraction",
            buckets=FRACTION_BUCKETS)
        self._m_gemms = reg.counter(
            "spamm_gated_gemms_total", labelnames=("phase", "layer", "site"),
            help="gated GEMM executions")
        self._m_bytes = reg.counter(
            "spamm_gemm_bytes_total",
            labelnames=("phase", "layer", "site", "dtype"),
            help="analytic GEMM bytes moved by the executed work-lists")
        self._m_waves = reg.counter(
            "serve_waves_total", help="request waves served")
        self._m_tokens = reg.counter(
            "serve_tokens_total", help="tokens emitted")
        self._m_cache = reg.counter(
            "spamm_plan_cache_total", labelnames=("result",),
            help="WeightPlanCache hits/misses")
        self._m_store = reg.counter(
            "spamm_plan_store_total", labelnames=("result",),
            help="on-disk PlanStore hits/misses")
        self._m_admit = reg.counter(
            "serve_admissions_total",
            help="requests admitted into a slot (chunked scheduler)")
        self._m_chunks = reg.counter(
            "serve_prefill_chunks_total",
            help="chunked-prefill steps executed (each advances every "
                 "prefilling slot by prefill_chunk tokens)")
        self._m_queue = reg.histogram(
            "serve_queue_depth", labelnames=(),
            help="requests waiting for a slot, sampled per scheduler "
                 "iteration (chunked mode)", buckets=COUNT_BUCKETS)
        self._m_occupancy = reg.histogram(
            "serve_slot_occupancy", labelnames=(),
            help="live slots per scheduler iteration (chunked mode)",
            buckets=COUNT_BUCKETS)

    # -- frozen-plan assembly ------------------------------------------------
    def _frozen_for(self, rows: int) -> dict:
        """The FrozenPlan tree for a step whose gated GEMMs see `rows`
        flattened activation rows — built once per row-tile grid."""
        if not self._freeze:
            return {}
        tile = self.spamm_ctx.cfg.tile
        gm = (rows + tile - 1) // tile
        hit = self._fp_cache.get(gm)
        if hit is not None:
            return hit
        self._ensure_fw_tree()
        with self.obs.span("plan_assembly", gm=gm):
            return self._assemble_frozen(gm)

    def _assemble_frozen(self, gm: int) -> dict:
        def specialize(node):
            if isinstance(node, dict):
                return {k: specialize(v) for k, v in node.items()}
            if isinstance(node, list):
                return [specialize(v) for v in node]
            return node.for_rows(gm)

        tree = specialize(self._fw_tree)
        self._fp_cache[gm] = tree
        return tree

    def _ensure_fw_tree(self):
        """Freeze the weight-side gating artifacts once, through the
        context's cache and the plan store (a warm store makes it a load).
        Under a ctx: the weights this rank computes with (a layer that runs
        whole on every model rank freezes its whole weight)."""
        if self._fw_tree is None:
            from repro_torch.plans.precompute import freeze_tree

            weights = (self.params if self.ctx is None else
                       M.compute_params(self.params, self.cfg, self.ctx))
            with self.obs.span("freeze", store=self.plan_store is not None):
                self._fw_tree, _ = freeze_tree(
                    weights, self.spamm_ctx.cfg,
                    cache=self.spamm_ctx.cache, store=self.plan_store,
                    group_len=group_len(self.cfg))

    def _note_gm(self, gm: int, n: int = 1):
        self._gm_hist[gm] = self._gm_hist.get(gm, 0) + n

    @property
    def gm_histogram(self) -> dict:
        """Observed serving row-grid histogram {gm row tiles: executed
        gated step count}, over every wave with SpAMM on (each prefill,
        chunk and decode step notes its grid once). Feed it to
        `core.cost.tune_weight(gm_hist=...)` so the tuner prices the grids
        this engine runs instead of the synthetic `DEFAULT_TUNE_GM`."""
        return dict(self._gm_hist)

    # -- drift-triggered re-sharding (control plane) -------------------------
    @property
    def partition_offsets(self):
        """The live equal-work row-offset table (None until the first
        probe) — what a multi-GPU deployment passes to
        `core.distributed.spamm_rowpart(offsets=)`."""
        return self._resharder.offsets if self._resharder else None

    def _maybe_reshard(self, requests, outs, cur=None):
        """Advance the engine step counter; at the configured cadence,
        probe the work estimate from the live tokens (each request's
        prompt and generated tokens, the most recent `probe_window`) and
        let the controller re-cut on drift. Never touches the computed
        values. In pod-sharded mode a re-cut also moves the live wave's
        requests between shards: the shard caches in place and `cur`, the
        host array of the slots' next tokens, along the slot permutation
        (returned)."""
        step = self._engine_steps
        self._engine_steps += 1
        rs = self._resharder
        if rs is None or not rs.due(step):
            return cur
        win = rs.cfg.probe_window

        def recent(r, o):
            t = np.concatenate([np.asarray(r.prompt, np.int64),
                                np.asarray(o, np.int64)])
            return t[-win:] if win else t

        toks = np.concatenate([recent(r, o) for r, o in zip(requests, outs)])
        with self.obs.span("reshard_probe", step=step):
            M.reshard_probe(rs, self.spamm_ctx, self.params, step,
                            tokens=toks)
        if self._sharded and self._shard is not None:
            src = self._refresh_shard()
            if src is not None and cur is not None:
                with self.obs.span("cache_permute", step=step):
                    self._permute_caches(src)
                    cur = cur[src]
        if self.obs.enabled:
            rs.publish(self.obs.registry)
        return cur

    # -- pod-sharded layout --------------------------------------------------
    def _check_shardable(self, cfg):
        if not self._freeze:
            raise ValueError(
                "mesh_devices > 1 needs frozen plans (per-shard step tables "
                "ARE the sharding mechanism) — enable spamm_cfg and keep "
                "freeze_plans on")
        if cfg.moe is not None:
            # the reference refuses MoE here too: its expert FFNs run their
            # own shard_map over the outer mesh and take no per-expert
            # frozen plans (`repro.serving.engine.Engine.__init__`)
            raise ValueError(
                "pod-sharded serving cannot take MoE archs: the expert FFNs "
                "gate eagerly and take no per-shard frozen plans, as in the "
                "reference")

    # -- tensor-parallel mode -------------------------------------------------
    def _check_ctx(self, ctx, mesh_devices, reshard_cfg):
        """Refuse what the tensor-parallel mode does not serve, check that
        `params` are this rank's shards, and decide the step graphs from
        the model group's backend."""
        if ctx.ndata > 1:
            raise ValueError(
                f"the ctx's batch axes {ctx.batch_axes} hold {ctx.ndata} "
                f"ranks: the engine serves over the model axis only (a data "
                f"split of a decode row tile changes its norm at τ > 0); "
                f"serve data-parallel through mesh_devices=, whose cuts "
                f"keep row tiles whole")
        if mesh_devices and int(mesh_devices) > 1:
            raise ValueError(
                "ctx= and mesh_devices > 1 are two placements of one engine: "
                "serve tensor-parallel over the ctx's model axis, or "
                "pod-sharded over mesh_devices, not both")
        if reshard_cfg is not None and reshard_cfg.every > 0:
            raise ValueError(
                "reshard_cfg re-cuts a data placement, and a ctx serves over "
                "the model axis only; re-shard the pod-sharded engine "
                "(mesh_devices=) instead")
        if self._gated and ctx.tile % self.spamm_ctx.cfg.tile:
            raise ValueError(
                f"the ctx cuts the model at tile {ctx.tile}, not a multiple "
                f"of the SpAMM tile {self.spamm_ctx.cfg.tile}: a rank's part "
                f"of a gated GEMM must be whole gate tiles")
        if self._tp:
            self._check_shards(ctx)
        group = ctx.group(ctx.model_axis)
        backend = dist.get_backend(group) if group is not None else None
        if backend != "nccl":
            self._eager_reason = (
                f"the model group runs {backend}: its collectives pass "
                f"through the host, so steps run eagerly")

    def _check_shards(self, ctx):
        """Every leaf of `params` must have the shape of this rank's shard
        of the model's whole leaf under `ctx.specs`."""
        if ctx.specs is None:
            raise ValueError(
                "the ctx has no placements: make it with models.model."
                "with_placements(ctx, cfg, pcfg)")
        whole = M.init_params(self.cfg, self.pcfg, device="meta",
                              model_axis_size=ctx.nmodel)

        def local(t, spec):
            shape = list(t.shape)
            for dim, entry in enumerate(spec):
                for ax in ((entry,) if isinstance(entry, str)
                           else entry or ()):
                    shape[dim] //= ctx.size(ax)
            return tuple(shape)

        got = T.flatten_with_paths(self.params)
        want = dict(zip((p for p, _ in T.flatten_with_paths(whole)),
                        (local(t, s) for t, s in T.pairs(whole, ctx.specs))))
        bad = [(p, tuple(t.shape), want.get(p)) for p, t in got
               if tuple(t.shape) != want.get(p)]
        if bad or len(got) != len(want):
            raise ValueError(
                f"params are not this rank's shards under the ctx's "
                f"placements (path, shape, shard shape): {bad[:3]} — pass "
                f"init_params(ctx=) or shard_params(params, ctx.specs, ctx)")

    def _shard_devices(self, devices, home) -> list:
        """The shards' devices: `devices` as given (N of them; one card may
        repeat), or cuda:0 … cuda:N-1, which must all be present."""
        if devices is None:
            have = (torch.cuda.device_count() if self.device.type == "cuda"
                    else 0)
            if have < self._ndev:
                raise ValueError(
                    f"mesh_devices={self._ndev} but only {have} CUDA "
                    f"devices visible (pass devices= to share one)")
            devices = [f"cuda:{i}" for i in range(self._ndev)]
        devs = []
        for d in devices:
            d = torch.device(d)
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            if d.type != home.type:
                raise ValueError(f"shard device {d} is not a {home.type} "
                                 f"device like the params'")
            devs.append(d)
        if len(devs) != self._ndev:
            raise ValueError(f"{len(devs)} devices for mesh_devices="
                             f"{self._ndev}")
        return devs

    @property
    def shard_layout(self):
        """The live wave's layout in REQUEST units (None unsharded or before
        the first wave): `offsets` cut the batch into per-shard request
        ranges, `slot_width` is every shard's padded slot count, `real` its
        live request count."""
        if not self._sharded or self._shard is None:
            return None
        tile = self.spamm_ctx.cfg.tile
        offs = self._shard["offs_g"] * tile
        return {"offsets": offs,
                "slot_width": int(self._shard["wmax_g"]) * tile,
                "real": [int(r) for r in np.diff(offs)]}

    def _group_offsets(self, G: int, wmax_g: int) -> np.ndarray:
        """The live cut on the wave's request-group grid, clamped to the
        static shard width (uniform until the first probe)."""
        rs = self._resharder
        src = (np.asarray(rs.offsets, np.int64)
               if rs is not None and rs.offsets is not None
               else np.arange(self._ndev + 1, dtype=np.int64))
        return _schedule.rescale_offsets(src, G, max_width=wmax_g)

    def _shard_tables(self, offs_g: np.ndarray, wmax_g: int, G: int) -> dict:
        """Request-level gather tables of one cut: `perm` names, per padded
        slot in (shard, slot) order, the request that fills it (pad slots
        clamp-replicate their strip's last group, so every slot carries
        live data); `keep` marks real slots; `real_slots[r]` is the one
        kept slot of request r."""
        tile = self.spamm_ctx.cfg.tile
        perm_g, keep_g = _schedule.strip_tables(offs_g, G, self._ndev,
                                                width=wmax_g)
        perm = (perm_g[:, None] * tile + np.arange(tile)).reshape(-1)
        keep = np.repeat(keep_g, tile)
        slots = np.nonzero(keep)[0]
        real = np.empty(G * tile, np.int64)
        real[perm[slots]] = slots
        return {"G": int(G), "wmax_g": int(wmax_g),
                "offs_g": np.asarray(offs_g, np.int64),
                "perm": perm, "keep": keep, "real_slots": real}

    def _begin_wave(self, b: int, plen: int):
        """Lay a wave out on the shards: cut the request groups by the live
        offsets and pin the per-shard width for the whole wave, so a
        mid-wave re-cut never changes a shape."""
        tile = self.spamm_ctx.cfg.tile
        ndev = self._ndev
        if b % tile:
            raise ValueError(
                f"pod-sharded serving needs batch % tile == 0 (got b={b}, "
                f"tile={tile}): gating is per row tile, and a shard cut "
                f"inside a tile would change tile membership and the gate")
        if plen % tile:
            raise ValueError(
                f"pod-sharded serving needs prompt length % tile == 0 (got "
                f"plen={plen}, tile={tile}) so prefill row tiles never "
                f"straddle a request boundary")
        G = b // tile
        if G < ndev:
            raise ValueError(
                f"{G} request group(s) of tile={tile} requests cannot fill "
                f"{ndev} shards — grow the batch to at least tile*ndev="
                f"{tile * ndev}")
        ceil_g = -(-G // ndev)
        cap = int(self._shard_width) if self._shard_width else 2 * ceil_g
        wmax_g = max(ceil_g, min(G, cap))
        self._shard = self._shard_tables(
            self._group_offsets(G, wmax_g), wmax_g, G)

    def _refresh_shard(self):
        """Re-cut the live wave from the controller's offsets. Returns the
        old→new global-slot gather, or None when the cut (at request-group
        granularity) did not move."""
        sh = self._shard
        offs_g = self._group_offsets(sh["G"], sh["wmax_g"])
        if np.array_equal(offs_g, sh["offs_g"]):
            return None
        new = self._shard_tables(offs_g, sh["wmax_g"], sh["G"])
        src = sh["real_slots"][new["perm"]]
        self._shard = new
        return src

    def _cut_key(self, tpg: int) -> tuple:
        sh = self._shard
        return (tpg, sh["wmax_g"], tuple(int(x) for x in sh["offs_g"]))

    def _sharded_frozen_for(self, tpg: int) -> list:
        """One FrozenPlan tree per shard, on its device, for the live cut:
        `tpg` is row tiles per request group (the prompt length for
        prefill, the chunk for a chunk step, 1 for decode). Sliced on the
        host from the frozen weight side, cached per (tpg, width, cut): a
        re-cut to a seen cut is a dict hit, and every cut of one width has
        the same shapes."""
        key = self._cut_key(tpg)
        hit = self._sfp_cache.get(key)
        if hit is not None:
            return hit
        self._ensure_fw_tree()
        with self.obs.span("plan_assembly", tpg=tpg, sharded=True):
            return self._assemble_sharded(tpg, key)

    def _assemble_sharded(self, tpg: int, key) -> list:
        sh = self._shard
        offs = sh["offs_g"] * tpg
        width = sh["wmax_g"] * tpg

        def shard(node):
            if isinstance(node, dict):
                parts = {k: shard(v) for k, v in node.items()}
                return [{k: p[d] for k, p in parts.items()}
                        for d in range(self._ndev)]
            if isinstance(node, list):
                parts = [shard(v) for v in node]
                return [[p[d] for p in parts] for d in range(self._ndev)]
            return [fp.to(dev) for fp, dev in
                    zip(node.shard_by_offsets(offs, width=width),
                        self._devices)]

        trees = shard(self._fw_tree)
        self._sfp_cache[key] = trees
        return trees

    def _live_frozen(self, kind: str, d: int, tpg: int) -> dict:
        """Shard d's frozen tree that its `kind` step reads: a private copy
        made with the step, into which a later cut's tables are copied in
        place (the captured graph reads these buffers)."""
        want = self._sharded_frozen_for(tpg)[d]
        key = self._cut_key(tpg)
        slot = (kind, d, tpg, self._shard["wmax_g"])
        live = self._live.get(slot)
        if live is None:
            live = self._live[slot] = [
                T.map_(lambda fp: fp.clone(), want), key]
        elif live[1] != key:
            T.map_(lambda dst, src: dst.copy_(src), live[0], want)
            live[1] = key
        return live[0]

    def _shard_cache(self, d: int, slots: int, full: bool) -> dict:
        key = (d, slots, full)
        cache = self._shard_caches.get(key)
        if cache is None:
            cache = M.init_cache(self.cfg, self.pcfg, slots, self.max_len,
                                 full=full, device=self._devices[d])
            self._shard_caches[key] = cache
        return cache

    def _permute_caches(self, src: np.ndarray):
        """Move the live wave's request rows between the shards' caches
        along the old→new global-slot gather `src`, in place (the captured
        steps read these tensors): every leaf gathered across shards,
        permuted, and copied back."""
        sh = self._shard
        per = sh["wmax_g"] * self.spamm_ctx.cfg.tile
        caches = [self._shard_cache(d, per, self._wave_full)
                  for d in range(self._ndev)]
        home = self._devices[0]
        idx = torch.as_tensor(src, device=home)
        for li, layer in enumerate(caches[0]["layers"]):
            for name in layer:
                leaves = [c["layers"][li][name] for c in caches]
                whole = torch.cat([t.to(home) for t in leaves])[idx]
                for d, t in enumerate(leaves):
                    t.copy_(whole[d * per:(d + 1) * per])

    def _shard_decode_step(self, d: int, per: int, full: bool) -> StepGraph:
        """Shard d's lockstep decode over its `per` padded slots at one
        position held in a 0-d device buffer, on its static cache, reading
        its live decode tables."""
        dev = self._devices[d]

        def make():
            cache = self._shard_cache(d, per, full)
            frozen = self._live_frozen("decode", d, 1)
            params = self._params_on[dev]
            inp = {"tokens": self._buffer(per, 1, device=dev),
                   "pos": self._buffer(device=dev)}

            def body():
                logits, _ = self._decode(params, inp["tokens"], cache,
                                         inp["pos"], frozen)
                return self._outputs(logits)

            return body, inp

        self._live_frozen("decode", d, 1)
        return self._step(("shard_wave", d, per, full), "decode", make,
                          device=dev)

    def _shard_chunk_step(self, d: int, per: int, chunk: int) -> StepGraph:
        """Shard d's prefill chunk at one static (per, chunk) shape on its
        full-length linear cache, reading its live chunk tables."""
        dev = self._devices[d]

        def make():
            cache = self._shard_cache(d, per, True)
            frozen = self._live_frozen("chunk", d, chunk)
            params = self._params_on[dev]
            inp = {"tokens": self._buffer(per, chunk, device=dev),
                   "positions": self._buffer(per, chunk, device=dev),
                   "last_idx": self._buffer(per, device=dev)}

            def body():
                _, logits = self._chunk(params, {"tokens": inp["tokens"]},
                                        cache, inp["positions"],
                                        inp["last_idx"], frozen)
                return self._outputs(logits)

            return body, inp

        self._live_frozen("chunk", d, chunk)
        return self._step(("shard_chunk", d, per, chunk), "prefill", make,
                          device=dev)

    # -- step graphs ---------------------------------------------------------
    def _static_cache(self, key, batch: int, full: bool) -> dict:
        cache = self._caches.get(key)
        if cache is None:
            cache = M.init_cache(self.cfg,
                                 self._slot_pcfg if full else self.pcfg,
                                 batch, self.max_len, full=full,
                                 device=self.device, ctx=self.ctx)
            self._caches[key] = cache
        return cache

    @property
    def _capture(self) -> bool:
        return (self.cuda_graphs and self.device.type == "cuda"
                and self._eager_reason is None)

    @property
    def step_graphs(self) -> dict:
        """Whether decode steps and chunk steps run as CUDA graphs in the
        current mode: decode whenever the engine captures; chunk steps
        unless a MoE stack gates them or they gate on the legacy path (they
        plan on the host). Under a ctx whose model group runs gloo,
        "eager" gives the reason nothing captures."""
        out = {"decode": self._capture,
               "chunk": self._capture and self._chunk_capturable}
        if self._eager_reason is not None:
            out["eager"] = self._eager_reason
        return out

    def _step(self, key, kind: str, make, device=None):
        """The StepGraph at `key` in the current mode, built by `make()` →
        (body, inputs) on first use; `trace_counts[kind]` counts the keys
        (on the card, each one capture; eager steps count too). `device`
        (a shard's card; None: the engine's) gets the step's graph pool,
        one per device, and its captures."""
        step = self._steps.get((key, self._capture))
        if step is None:
            capture = self.step_graphs["chunk" if kind == "prefill"
                                       else "decode"]
            pool = None
            if capture:
                with (contextlib.nullcontext() if device is None
                      else torch.cuda.device(device)):
                    pool = self._pools.get(device)
                    if pool is None:
                        pool = self._pools[device] = \
                            torch.cuda.graph_pool_handle()
            body, inputs = make()
            step = StepGraph(body, inputs, capture=capture, pool=pool,
                             spamm_ctx=self.spamm_ctx, device=device)
            self._steps[(key, self._capture)] = step
            self.trace_counts[kind] += 1
        return step

    def _buffer(self, *shape, device=None) -> torch.Tensor:
        return torch.zeros(shape, dtype=torch.int32,
                           device=self.device if device is None else device)

    def _outputs(self, logits) -> dict:
        return {"logits": logits,
                "tokens": logits.argmax(dim=-1).to(torch.int32)}

    def _wave_decode_step(self, b: int) -> StepGraph:
        """Lockstep decode over the wave's exact batch `b` (a pad lane
        would enter the decode gate's row tile), at one position held in a
        0-d device buffer, on the wave's static cache."""
        def make():
            cache = self._static_cache(("wave", b), b, full=False)
            frozen = self._frozen_for(b)
            inp = {"tokens": self._buffer(b, 1), "pos": self._buffer()}

            def body():
                logits, _ = self._decode(self.params, inp["tokens"], cache,
                                         inp["pos"], frozen)
                return self._outputs(logits)

            return body, inp

        return self._step(("wave", b), "decode", make)

    def _slot_decode_step(self, nslots: int) -> StepGraph:
        """Decode over the slot pool at per-slot positions (sentinels for
        idle and prefilling slots), on the pool's linear cache."""
        def make():
            cache = self._static_cache(("slots", nslots), nslots, full=True)
            frozen = self._frozen_for(nslots)
            inp = {"tokens": self._buffer(nslots, 1),
                   "positions": self._buffer(nslots)}

            def body():
                logits, _ = self._slot_decode(self.params, inp["tokens"],
                                              cache, inp["positions"], frozen)
                return self._outputs(logits)

            return body, inp

        return self._step(("slots", nslots), "decode", make)

    def _chunk_step(self, nslots: int, chunk: int) -> StepGraph:
        """One prefill chunk over the slot pool at one static (nslots,
        chunk) shape, on the pool's linear cache."""
        def make():
            cache = self._static_cache(("slots", nslots), nslots, full=True)
            frozen = self._frozen_for(nslots * chunk)
            inp = {"tokens": self._buffer(nslots, chunk),
                   "positions": self._buffer(nslots, chunk),
                   "last_idx": self._buffer(nslots)}

            def body():
                _, logits = self._chunk(self.params,
                                        {"tokens": inp["tokens"]}, cache,
                                        inp["positions"], inp["last_idx"],
                                        frozen)
                return self._outputs(logits)

            return body, inp

        return self._step(("chunk", nslots, chunk), "prefill", make)

    def graph_stats(self) -> dict:
        """Captures so far, their host seconds, and the graph pool's bytes
        (None off the card or where the allocator does not report it)."""
        caps = [s.capture_s for s in self._steps.values()
                if s.capture_s is not None]
        return {"captures": len(caps), "capture_s": float(sum(caps)),
                "pool_bytes": (sum(pool_bytes(p) or 0
                                   for p in self._pools.values())
                               if self._pools else None)}

    def _pad_cache(self, cache, into: dict) -> dict:
        """Copy the prefill's caches into the static decode cache `into`:
        an attention layer's K/V (max_len long, or the sliding window when
        that is smaller) with the slots past the prompt zeroed, a recurrent
        layer's state, and its conv history right-aligned (a prompt
        shorter than the history leaves zeros before it, the causal conv's
        own padding)."""
        for src, dst in zip(cache["layers"], into["layers"]):
            for n, t in src.items():
                d = dst[n]
                if n in ("k", "v"):
                    d[:, :t.shape[1]].copy_(t)
                    d[:, t.shape[1]:].zero_()
                elif n == "conv":
                    lead = d.shape[1] - t.shape[1]
                    d[:, lead:].copy_(t)
                    d[:, :lead].zero_()
                else:
                    d.copy_(t)
        return into

    def _counters0(self):
        """(plan-cache, plan-store, re-sharder) counters at a wave's start,
        whose deltas `_spamm_stats` reports."""
        cache = (self.spamm_ctx.cache.hits, self.spamm_ctx.cache.misses)
        store = (None if self.plan_store is None
                 else (self.plan_store.hits, self.plan_store.misses))
        rs = self._resharder
        return cache, store, (None if rs is None
                              else (rs.resharded, rs.probes))

    def _spamm_stats(self, taps, cache0, store0=None, ttft_s=None,
                     decode_lat=(), reshard0=None) -> dict:
        """Per-wave gating stats, as the reference's engine reports them:
        mean valid fraction and gated-GEMM count per phase, the configured
        compute dtype, the GEMM bytes moved per phase (sums over the frozen
        GEMMs' taps), the plan cache's and (with a plan store) the store's
        hits and misses during this wave (deltas from `cache0`/`store0`,
        the counters at the wave's start), and:

        - `resharded`, `reshard_probes` (the wave's deltas from
          `reshard0`) and `partition_imbalance` (the live partition's
          predicted imbalance at the last probe), with re-sharding on.
        - `per_layer`: {layer: {site: cell}} over the same taps — fractions
          average, counts and bytes sum within each (layer, site) cell, so
          the cells' counts sum to the aggregates; taps without a layer
          label (layer < 0) stay in the aggregates only.
        - `latency` (obs on): `wave_latency(ttft_s, decode_lat)`.
        - `cost_residual` (obs on, cost taps armed): per phase, the
          predicted seconds summed over the wave's frozen GEMMs (divided by
          the mesh size when sharded), the
          measured seconds (TTFT for prefill, the decode steps' sum for
          decode) and log2(measured / predicted), where both are positive.

        With obs on, the registry gets the taps (per-(phase, layer, site)
        fraction histogram, GEMM and byte counters) and the cache and store
        deltas."""
        pre = [t.value for t in taps if t.phase != "decode"]
        dec = [t.value for t in taps if t.phase == "decode"]
        pre_b = [t.nbytes for t in taps
                 if t.phase != "decode" and t.nbytes is not None]
        dec_b = [t.nbytes for t in taps
                 if t.phase == "decode" and t.nbytes is not None]
        cache = self.spamm_ctx.cache
        stats = {
            "valid_fraction": float(np.mean(pre)) if pre else None,
            "gated_gemms": len(pre),
            "decode_valid_fraction": float(np.mean(dec)) if dec else None,
            "decode_gated_gemms": len(dec),
            "compute_dtype": self.spamm_ctx.cfg.dtype,
            "gemm_bytes_moved": float(np.sum(pre_b)) if pre_b else None,
            "decode_gemm_bytes_moved": (float(np.sum(dec_b)) if dec_b
                                        else None),
            "plan_cache_hits": cache.hits - cache0[0],
            "plan_cache_misses": cache.misses - cache0[1],
        }
        if store0 is not None:
            stats["plan_store_hits"] = self.plan_store.hits - store0[0]
            stats["plan_store_misses"] = self.plan_store.misses - store0[1]
        if reshard0 is not None:
            rs = self._resharder
            stats["resharded"] = rs.resharded - reshard0[0]
            stats["reshard_probes"] = rs.probes - reshard0[1]
            stats["partition_imbalance"] = rs.live_imbalance
        acc: dict = {}
        for t in taps:
            if t.layer < 0:
                continue
            a = acc.setdefault((t.layer, t.site or ""), [0.0, 0, 0.0, 0, 0.0])
            if t.phase == "decode":
                a[2] += t.value
                a[3] += 1
            else:
                a[0] += t.value
                a[1] += 1
            if t.nbytes is not None:
                a[4] += t.nbytes
        per_layer: dict = {}
        for (layer, site), a in sorted(acc.items()):
            per_layer.setdefault(layer, {})[site] = {
                "valid_fraction": a[0] / a[1] if a[1] else None,
                "gated_gemms": a[1],
                "decode_valid_fraction": a[2] / a[3] if a[3] else None,
                "decode_gated_gemms": a[3],
                "gemm_bytes_moved": a[4] if a[4] else None,
            }
        stats["per_layer"] = per_layer
        if not self.obs.enabled:
            return stats
        decode_lat = list(decode_lat)
        if ttft_s is not None or decode_lat:
            stats["latency"] = wave_latency(ttft_s, decode_lat)
        cost = [t for t in taps if t.predicted_s is not None]
        if cost:
            # sharded: every shard taps its GEMMs, and the shards of a
            # deployment run at once, so the phase takes a shard's share
            ndev = self._ndev if self._sharded else 1
            pred_pre = sum(t.predicted_s for t in cost
                           if t.phase != "decode") / ndev
            pred_dec = sum(t.predicted_s for t in cost
                           if t.phase == "decode") / ndev
            meas_dec = float(np.sum(decode_lat)) if decode_lat else 0.0
            cres = {}
            for phase, pred, meas in (("prefill", pred_pre, ttft_s or 0.0),
                                      ("decode", pred_dec, meas_dec)):
                if pred > 0.0 and meas > 0.0:
                    r = self.obs.residual.record(phase, pred, meas)
                    cres[phase] = {"predicted_s": pred, "measured_s": meas,
                                   "log2_ratio": r}
            if cres:
                stats["cost_residual"] = cres
        # one histogram sample per tap; the counters take each
        # (phase, layer, site) cell's sums, the reference's per-tap values
        # to the bit (counts and bytes are integers)
        cells: dict = {}
        for t in taps:
            site = t.site or ""
            self._m_vf.observe(t.value, phase=t.phase, layer=t.layer,
                               site=site)
            c = cells.setdefault((t.phase, t.layer, site), [0, None])
            c[0] += 1
            if t.nbytes is not None:
                c[1] = (c[1] or 0.0) + t.nbytes
        dtype = stats["compute_dtype"]
        for (phase, layer, site), (n, nbytes) in cells.items():
            self._m_gemms.inc(n, phase=phase, layer=layer, site=site)
            if nbytes is not None:
                self._m_bytes.inc(nbytes, phase=phase, layer=layer, site=site,
                                  dtype=dtype)
        self._m_cache.inc(stats["plan_cache_hits"], result="hit")
        self._m_cache.inc(stats["plan_cache_misses"], result="miss")
        if store0 is not None:
            self._m_store.inc(stats["plan_store_hits"], result="hit")
            self._m_store.inc(stats["plan_store_misses"], result="miss")
        return stats

    @staticmethod
    def _latency(ttft_s, decode_lat) -> dict:
        """`Request.out["latency"]`, with obs on or off: `wave_latency`,
        its decode keys None when no decode step ran."""
        return {"decode_mean_s": None, "decode_p50_s": None,
                "decode_p95_s": None, **wave_latency(ttft_s, decode_lat)}

    # -- dispatch ------------------------------------------------------------
    def _default_chunk(self) -> int:
        """Tile-aligned default chunk size for the auto mixed-length path."""
        tile = self.spamm_ctx.cfg.tile if self._gated else 1
        return -(-16 // tile) * tile

    def _resolve_chunk(self, mixed: bool) -> Optional[int]:
        """The chunk size this batch prefills at, or None for one-shot."""
        pc = self._prefill_chunk
        if pc is not None and not pc:      # 0/False: chunking disabled
            return None
        if pc is None:                     # auto: chunk only when needed
            if not mixed or stack_kinds(self.cfg) != "attn":
                return None
            return self._default_chunk()
        return int(pc)

    def generate(self, requests: List[Request]) -> List[np.ndarray]:
        """Greedy-decode a batch of prompts: equal lengths through the wave
        (unless `prefill_chunk` asks for chunks), mixed lengths through the
        chunked slot scheduler; every prompt token is used. Raises on an
        empty batch or prompt, on prompts longer than max_len - 1, and on
        mixed lengths with `prefill_chunk=0` or on a recurrent (ssm or
        hybrid) stack, which never chunks."""
        if not requests:
            raise ValueError("empty batch")
        plens = [len(r.prompt) for r in requests]
        if min(plens) < 1:
            raise ValueError("empty prompt")
        if max(plens) > self.max_len - 1:
            raise ValueError(
                f"prompt of {max(plens)} tokens does not fit "
                f"max_len={self.max_len} (a sequence needs at least one "
                f"decode slot) — raise max_len instead of losing prompt "
                f"tokens")
        mixed = len(set(plens)) > 1
        chunk = self._resolve_chunk(mixed)
        if self._sharded:
            if mixed:
                raise ValueError(
                    "pod-sharded serving needs equal-length prompts (the "
                    "chunked mixed-length scheduler is unsharded-only); "
                    "pad client-side or serve unsharded")
            return self._generate_sharded(requests, chunk)
        if chunk:
            return self._generate_chunked(requests, chunk)
        if mixed:
            if stack_kinds(self.cfg) != "attn":
                raise ValueError(
                    f"{stack_kinds(self.cfg)!r} stacks cannot chunk "
                    f"mixed-length prompts (recurrent prefill state does "
                    f"not checkpoint at a chunk boundary); pad client-side "
                    f"to one length")
            raise ValueError(
                "mixed-length prompts need chunked prefill, but "
                "prefill_chunk=0 disabled it; drop the override or pad "
                "client-side")
        return self._generate_wave(requests)

    def _generate_wave(self, requests: List[Request]) -> List[np.ndarray]:
        """Lockstep wave: prefill the whole batch, decode until every
        sequence finishes. Latency is read at the loop's own blocking
        point (copying the step's tokens to the host), no extra syncs:
        TTFT from wave start (plan assembly included) to the first token on
        the host, one decode latency per later step. With obs on, the
        prefill and each decode step's span opens at dispatch and closes
        at that blocking point (`SpanTracer.add_complete`)."""
        b = len(requests)
        plen = len(requests[0].prompt)
        toks = np.stack([r.prompt for r in requests]).astype(np.int32)
        obs_on = self.obs.enabled
        tile = self.spamm_ctx.cfg.tile if self._gated else 0
        if self._gated:
            cache0, store0, reshard0 = self._counters0()
        t_wave0 = time.perf_counter_ns()
        frozen_pre = self._frozen_for(b * plen)
        outs = [[] for _ in range(b)]
        ttft_s, decode_lat, taps = None, [], []
        pend = None      # (span name, t0 ns) of a dispatched, unread step
        if self._gated:
            self.spamm_ctx.begin_stats()
            self.spamm_ctx.set_phase("prefill")
        try:
            with torch.inference_mode():
                self._maybe_reshard(requests, outs)
                pend = ("prefill", time.perf_counter_ns())
                cache, logits = self._prefill(
                    self.params,
                    {"tokens": torch.as_tensor(toks, device=self.device)},
                    frozen_pre)
                if self._gated:
                    self._note_gm(-(-(b * plen) // tile))
                if self._tp:
                    # the rank's decode layout (seq-sharded: every kv head
                    # gathered, its sequence slice kept)
                    cache = M.place_cache(cache, self.cfg, self.pcfg,
                                          self.max_len, ctx=self.ctx)
                self._pad_cache(cache, self._static_cache(("wave", b), b,
                                                          full=False))
                del cache
                cur = logits.argmax(dim=-1).to(torch.int32)
                pos = plen
                done = np.zeros(b, bool)
                budget = max(r.max_new_tokens for r in requests)
                if self._gated:
                    self.spamm_ctx.set_phase("decode")
                for t in range(budget):
                    vis = cur.cpu().numpy()   # blocks on the previous step
                    ttft_s = self._close_step(pend, t, t_wave0, ttft_s,
                                              decode_lat)
                    pend = None
                    _emit_tokens(requests, outs, done, vis)
                    if done.all() or pos >= self.max_len - 1:
                        break
                    pend = ("decode_step", time.perf_counter_ns())
                    self._maybe_reshard(requests, outs)
                    cur = self._wave_decode_step(b)(tokens=cur,
                                                    pos=pos)["tokens"]
                    if self._gated:
                        self._note_gm(-(-b // tile))
                    pos += 1
        finally:
            if self._gated:
                taps = self.spamm_ctx.end_stats()
                self.spamm_ctx.set_phase("prefill")
            if pend is not None and obs_on:
                # a step still in flight: its span closes now, unblocked,
                # and stays out of the latency measurements
                self.obs.tracer.add_complete(pend[0], pend[1],
                                             time.perf_counter_ns())
        spamm_meta = (self._spamm_stats(taps, cache0, store0, ttft_s,
                                        decode_lat, reshard0)
                      if self._gated else None)
        return self._finish_wave(requests, outs, spamm_meta, ttft_s,
                                 decode_lat, t_wave0, batch=b,
                                 prompt_len=plen)

    def _close_step(self, pend, step, t_wave0, ttft_s, decode_lat):
        """Close the dispatched step `pend` = (span name, t0 ns) at the
        wave loop's blocking point: the prefill's TTFT from the wave's
        start, or one more decode latency; with obs on, its span and
        histogram. Returns the wave's TTFT so far."""
        t1 = time.perf_counter_ns()
        name, t0 = pend
        if name == "prefill":
            ttft_s = (t1 - t_wave0) / 1e9
        else:
            decode_lat.append((t1 - t0) / 1e9)
        if self.obs.enabled:
            self.obs.tracer.add_complete(name, t0, t1, step=step)
            if name == "prefill":
                self._m_ttft.observe(ttft_s)
            else:
                self._m_decode_s.observe(decode_lat[-1])
        return ttft_s

    def _finish_wave(self, requests, outs, spamm_meta, ttft_s, decode_lat,
                     t_wave0, **span_args) -> List[np.ndarray]:
        """Set each request's `out`; with obs on, close the wave's span and
        count the wave and its tokens."""
        latency = self._latency(ttft_s, decode_lat)
        results = [np.asarray(o, np.int32) for o in outs]
        if self.obs.enabled:
            self.obs.tracer.add_complete("wave", t_wave0,
                                         time.perf_counter_ns(), **span_args)
            self._m_waves.inc()
            self._m_tokens.inc(sum(len(o) for o in results))
        graphs = self.step_graphs
        for r, toks_out in zip(requests, results):
            r.out = {"tokens": toks_out, "spamm": spamm_meta,
                     "latency": latency, "graphs": dict(graphs)}
        return results

    def _generate_sharded(self, requests: List[Request],
                          chunk: Optional[int]) -> List[np.ndarray]:
        """The pod-sharded wave: the requests laid out on the shards by the
        live cut (`_begin_wave`), each shard's prefill (one shot, eager; or
        `chunk`-token chunks through its chunk step) on its device, then
        lockstep decode, each step one captured step per shard. The step-0
        probe may lay the first cut before the prefill; a mid-wave re-cut
        moves requests between the shards' caches before the next decode
        step. The slots' next tokens live on the host between steps (one
        read per shard and step, the loop's blocking point); latency spans
        as in `_generate_wave`."""
        b = len(requests)
        plen = len(requests[0].prompt)
        toks = np.stack([r.prompt for r in requests]).astype(np.int32)
        tile = self.spamm_ctx.cfg.tile
        ndev = self._ndev
        obs_on = self.obs.enabled
        self._begin_wave(b, plen)
        self._wave_full = bool(chunk)
        cache0, store0, reshard0 = self._counters0()
        t_wave0 = time.perf_counter_ns()
        outs = [[] for _ in range(b)]
        ttft_s, decode_lat, taps = None, [], []
        pend = None
        self.spamm_ctx.begin_stats()
        self.spamm_ctx.set_phase("prefill")
        try:
            with torch.inference_mode():
                self._maybe_reshard(requests, outs)
                per = self._shard["wmax_g"] * tile
                toks_in = toks[self._shard["perm"]]
                pend = ("prefill", time.perf_counter_ns())
                if chunk:
                    heads = self._sharded_chunk_prefill(toks_in, plen, chunk)
                else:
                    heads = self._sharded_prefill(toks_in, plen, per)
                self.spamm_ctx.set_phase("decode")
                pos = plen
                done = np.zeros(b, bool)
                budget = max(r.max_new_tokens for r in requests)
                for t in range(budget):
                    cur = np.concatenate([h.cpu().numpy() for h in heads])
                    ttft_s = self._close_step(pend, t, t_wave0, ttft_s,
                                              decode_lat)
                    pend = None
                    # pad slots mirror their strip's last real group; the
                    # kept-slot table reads each request once
                    _emit_tokens(requests, outs, done,
                                 cur[self._shard["real_slots"]])
                    if done.all() or pos >= self.max_len - 1:
                        break
                    pend = ("decode_step", time.perf_counter_ns())
                    cur = self._maybe_reshard(requests, outs, cur)
                    heads = [self._shard_decode_step(d, per, bool(chunk))(
                        tokens=cur[d * per:(d + 1) * per], pos=pos)["tokens"]
                        for d in range(ndev)]
                    self._note_gm(self._shard["wmax_g"], ndev)
                    pos += 1
        finally:
            taps = self.spamm_ctx.end_stats()
            self.spamm_ctx.set_phase("prefill")
            if pend is not None and obs_on:
                self.obs.tracer.add_complete(pend[0], pend[1],
                                             time.perf_counter_ns())
        spamm_meta = self._spamm_stats(taps, cache0, store0, ttft_s,
                                       decode_lat, reshard0)
        return self._finish_wave(requests, outs, spamm_meta, ttft_s,
                                 decode_lat, t_wave0, batch=b,
                                 prompt_len=plen, shards=ndev)

    def _sharded_prefill(self, toks_in: np.ndarray, plen: int,
                         per: int) -> list:
        """One-shot prefill of each shard's `per` padded slots on its
        device (eager: once per wave), its caches copied into the shard's
        static decode cache. Returns each shard's first tokens."""
        frozen = self._sharded_frozen_for(plen)
        heads = []
        for d, dev in enumerate(self._devices):
            tk = torch.as_tensor(toks_in[d * per:(d + 1) * per], device=dev)
            cache, logits = self._prefill(self._params_on[dev],
                                          {"tokens": tk}, frozen[d])
            self._pad_cache(cache, self._shard_cache(d, per, False))
            heads.append(logits.argmax(dim=-1).to(torch.int32))
        self._note_gm(self._shard["wmax_g"] * plen, self._ndev)
        return heads

    def _sharded_chunk_prefill(self, toks_in: np.ndarray, plen: int,
                               chunk: int) -> list:
        """Prefill each shard's padded slots in `chunk`-token chunks at one
        static shape, through its captured chunk step, into its zeroed
        full-length linear cache. Pad slots replicate live rows; a partial
        last chunk clamp-pads its token tail at sentinel positions (≥
        max_len), whose cache writes drop. Returns each shard's first
        tokens (from the last chunk's logits)."""
        per = self._shard["wmax_g"] * self.spamm_ctx.cfg.tile
        for d in range(self._ndev):
            for layer in self._shard_cache(d, per, True)["layers"]:
                for t in layer.values():
                    t.zero_()
        heads = None
        for lo in range(0, plen, chunk):
            n = min(chunk, plen - lo)
            tk = np.empty((toks_in.shape[0], chunk), np.int32)
            tk[:, :n] = toks_in[:, lo:lo + n]
            if n < chunk:
                tk[:, n:] = tk[:, n - 1:n]
            posr = np.full(chunk, self.max_len, np.int32)
            posr[:n] = lo + np.arange(n)
            last = np.full(per, n - 1 if lo + n >= plen else -1, np.int32)
            heads = [self._shard_chunk_step(d, per, chunk)(
                tokens=tk[d * per:(d + 1) * per],
                positions=np.broadcast_to(posr, (per, chunk)),
                last_idx=last)["tokens"].clone()
                for d in range(self._ndev)]
            self.chunk_steps += 1
            self._note_gm(self._shard["wmax_g"] * chunk, self._ndev)
            if self.obs.enabled:
                self._m_chunks.inc()
        return heads

    def _slot_count(self, b: int) -> int:
        """The slot pool for `b` requests: the power-of-two bucket of
        min(b, max_slots), floored under a non-power-of-two cap."""
        cap = min(b, self._max_slots) if self._max_slots else b
        nslots = bucket(cap, 1)
        if self._max_slots and nslots > self._max_slots:
            nslots = _floor_pow2(self._max_slots)
        return nslots

    def _generate_chunked(self, requests: List[Request],
                          chunk: int) -> List[np.ndarray]:
        """Slot scheduler: chunked prefill interleaved with decode over a
        power-of-two-bucketed slot pool. Per iteration: (1) queued requests
        are admitted into idle slots, (2) every prefilling slot advances by
        one `chunk`-token chunk at ONE static (slots, chunk) shape — a
        partial chunk is clamp-padded with its last token at sentinel
        positions, and a slot whose prompt ends in the chunk takes its
        first generated token from that chunk's logits, (3) pending tokens
        are emitted and finished slots freed, (4) one decode step runs over
        the decoding slots at per-slot positions. Idle lanes carry position
        sentinels (max_len): their cache writes drop and their outputs are
        never read. Termination per slot is the wave's (EOS /
        max_new_tokens / pos >= max_len - 1 at emit time). The pool's
        cache is zeroed at the start, as a fresh one would be. TTFT is the
        first finished prefill on the host; one decode latency per decode
        step, dispatch to its tokens on the host. With obs on, each chunk
        and decode step's span closes when its tokens reach the host, and
        the queue depth and slot occupancy are sampled per iteration."""
        b = len(requests)
        nslots = self._slot_count(b)
        obs_on = self.obs.enabled
        tile = self.spamm_ctx.cfg.tile if self._gated else 0
        if self._gated:
            cache0, store0, reshard0 = self._counters0()
        t_wave0 = time.perf_counter_ns()
        outs: List[list] = [[] for _ in range(b)]
        queue = list(range(b))
        slot_req = [-1] * nslots       # request index per slot, -1 when idle
        mode = ["idle"] * nslots       # idle | prefill | decode
        cursor = [0] * nslots          # prompt tokens already fed
        pos = [0] * nslots             # tokens materialized in the cache
        pending: List[Optional[int]] = [None] * nslots
        cur = np.zeros(nslots, np.int32)
        ttft_s, decode_lat, taps = None, [], []
        if self._gated:
            self.spamm_ctx.begin_stats()
        try:
            with torch.inference_mode():
                for layer in self._static_cache(("slots", nslots), nslots,
                                                full=True)["layers"]:
                    layer["k"].zero_()
                    layer["v"].zero_()
                while queue or any(m != "idle" for m in mode):
                    if obs_on:
                        self._m_queue.observe(len(queue))
                    # -- admission: queued requests claim idle slots ------
                    for s in range(nslots):
                        if mode[s] == "idle" and queue:
                            slot_req[s] = queue.pop(0)
                            mode[s] = "prefill"
                            cursor[s] = pos[s] = 0
                            pending[s] = None
                            self.admissions += 1
                            if obs_on:
                                self._m_admit.inc()
                    if obs_on:
                        self._m_occupancy.observe(
                            sum(m != "idle" for m in mode))
                    # -- one chunk of prefill over the prefilling slots ---
                    if any(m == "prefill" for m in mode):
                        tk = np.zeros((nslots, chunk), np.int32)
                        posc = np.full((nslots, chunk), self.max_len,
                                       np.int32)
                        last = np.full(nslots, -1, np.int32)
                        fin = []
                        for s in range(nslots):
                            if mode[s] != "prefill":
                                continue
                            pr = np.asarray(requests[slot_req[s]].prompt,
                                            np.int32)
                            n = min(len(pr) - cursor[s], chunk)
                            tk[s, :n] = pr[cursor[s]:cursor[s] + n]
                            if n < chunk:
                                tk[s, n:] = tk[s, n - 1]
                            posc[s, :n] = cursor[s] + np.arange(n)
                            cursor[s] += n
                            if cursor[s] >= len(pr):
                                last[s] = n - 1
                                fin.append(s)
                        if self._gated:
                            self.spamm_ctx.set_phase("prefill")
                        t0 = time.perf_counter_ns()
                        step_tok = self._chunk_step(nslots, chunk)(
                            tokens=tk, positions=posc,
                            last_idx=last)["tokens"].cpu().numpy()
                        self.chunk_steps += 1
                        if self._gated:
                            self._note_gm(-(-(nslots * chunk) // tile))
                        self._maybe_reshard(requests, outs)
                        if obs_on:
                            self.obs.tracer.add_complete(
                                "prefill_chunk", t0, time.perf_counter_ns())
                            self._m_chunks.inc()
                        for s in fin:
                            mode[s] = "decode"
                            pos[s] = len(requests[slot_req[s]].prompt)
                            pending[s] = int(step_tok[s])
                        if fin and ttft_s is None:
                            ttft_s = (time.perf_counter_ns() - t_wave0) / 1e9
                            if obs_on:
                                self._m_ttft.observe(ttft_s)
                    # -- emit pending tokens; finished slots free ---------
                    for s in range(nslots):
                        if mode[s] != "decode" or pending[s] is None:
                            continue
                        r = requests[slot_req[s]]
                        tok = pending[s]
                        pending[s] = None
                        outs[slot_req[s]].append(tok)
                        if ((r.eos_id is not None and tok == r.eos_id)
                                or len(outs[slot_req[s]]) >= r.max_new_tokens
                                or pos[s] >= self.max_len - 1):
                            mode[s] = "idle"
                            slot_req[s] = -1
                    # -- one decode step over the decoding slots ----------
                    dec = [s for s in range(nslots) if mode[s] == "decode"]
                    if dec:
                        posv = np.full(nslots, self.max_len, np.int32)
                        for s in dec:
                            cur[s] = outs[slot_req[s]][-1]
                            posv[s] = pos[s]
                        if self._gated:
                            self.spamm_ctx.set_phase("decode")
                        t0 = time.perf_counter_ns()
                        step_tok = self._slot_decode_step(nslots)(
                            tokens=cur, positions=posv)["tokens"].cpu().numpy()
                        t1 = time.perf_counter_ns()
                        decode_lat.append((t1 - t0) / 1e9)
                        if self._gated:
                            self._note_gm(-(-nslots // tile))
                        self._maybe_reshard(requests, outs)
                        if obs_on:
                            self.obs.tracer.add_complete("decode_step", t0,
                                                         t1)
                            self._m_decode_s.observe(decode_lat[-1])
                        for s in dec:
                            pending[s] = int(step_tok[s])
                            pos[s] += 1
        finally:
            if self._gated:
                taps = self.spamm_ctx.end_stats()
                self.spamm_ctx.set_phase("prefill")
        spamm_meta = (self._spamm_stats(taps, cache0, store0, ttft_s,
                                        decode_lat, reshard0)
                      if self._gated else None)
        return self._finish_wave(requests, outs, spamm_meta, ttft_s,
                                 decode_lat, t_wave0, batch=b, slots=nslots,
                                 chunk=chunk)
