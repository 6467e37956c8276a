"""Serving CLI of the port: init a model from a seed, serve a batch of
requests with greedy generation — an equal-length wave, or mixed lengths
through the chunked slot scheduler.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-7b \
      --num-requests 4 --prompt-len 128 --max-new 16 \
      --spamm-tau 0.5 --spamm-tile 64 [--spamm-dtype int8] \
      [--mixed-lengths --prefill-chunk 64 --max-slots 4]

Runs on the card by default; `--device cpu` runs the plain PyTorch versions
of the kernels (use `--reduced` there). `--plan-store DIR` warm-starts the
frozen plans from a store that `repro_torch.launch.precompute_plans`
populated with the same arch, seed, device and SpAMM flags. `--waves N`
serves the same requests N times and reports the last wave: the first
freezes the plans, so `--waves 2` times a warm wave. On the card the
decode and chunk steps run as CUDA graphs; the report gives the step
keys, the captures, their seconds, the graph pool's bytes and which
steps run as graphs (a MoE arch's chunk steps do not with SpAMM on).
`--spamm-autotune` freezes each gated site at the block_n, levels and
bucket floor the roofline tuner picks (`--spamm-block-n`/`--spamm-levels`
are its defaults), pricing with `--spamm-tune-profile` (a calibrated
`core.cost.CostProfile` JSON; nominal coefficients without it), which also
prices the cost residual. `--metrics-out FILE` writes the run's metrics
registry as Prometheus text (per-(phase, layer, site) gated-GEMM series,
TTFT and decode-step histograms, plan cache and store counters, the
chunked plane's counters); `--trace-out FILE` writes its host spans as
Chrome-trace JSON (load in Perfetto); either prints the registry's
summary table at the end. `--reshard-every N` (with `--spamm-tau`) probes
the drift-triggered re-sharding controller every N engine steps
(`--reshard-devices`, `--reshard-threshold`, `--reshard-level`) and prints
the live partition; `--spamm-mesh-devices N` serves pod-sharded over
cuda:0 … cuda:N-1 (`--spamm-shard-width` pins the per-shard width in
request groups; batch and prompt length multiples of `--spamm-tile`).
`--no-freeze-plans` is the reference's legacy path (prefill and chunk
steps gate through eager plans, decode stays dense).

Tensor-parallel over a model axis, one process per rank (torchrun sets
RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT and LOCAL_RANK):

  torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
      --arch qwen2.5-32b --mesh 1,4 --backend nccl ...

`--mesh DATA,MODEL` lays a (data, model) mesh over the world (DATA must be
1: data-parallel serving is `--spamm-mesh-devices`); each rank makes its
own shards of the seeded weights and serves every request. `--backend` is
stated, never switched: "nccl" for one rank per card, "gloo" for ranks
that share a card or run on the CPU. Under nccl the decode and chunk steps
are captured as CUDA graphs with their collectives inside; under gloo
they run eagerly (the report's `eager:` line says why). Rank 0 alone
prints and writes `--metrics-out`/`--trace-out`; the report adds each
rank's peak card memory.
"""
from __future__ import annotations

import argparse
import collections
import gc
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import (BACKEND_NAMES, ParallelConfig, SpammConfig,
                                 get_config)
from repro_torch.core.schedule import ReshardConfig
from repro_torch.launch import mesh as MS
from repro_torch.models import model as M
from repro_torch.obs import Observability
from repro_torch.plans.precompute import frozen_leaves
from repro_torch.serving.engine import Engine, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--num-requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--waves", type=int, default=1,
                    help="serve the requests this many times; report the "
                         "last wave")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mixed-lengths", action="store_true",
                    help="draw each request's prompt length uniformly from "
                         "[prompt_len/2, prompt_len] instead of one length "
                         "— served by the chunked slot scheduler")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked prefill: advance prompts C tokens per "
                         "engine step at ONE static shape, interleaved with "
                         "decode (C %% spamm-tile == 0 when gating). "
                         "Default: chunk only mixed-length batches; 0 "
                         "disables chunking (mixed lengths then rejected)")
    ap.add_argument("--max-slots", type=int, default=None,
                    help="cap the chunked scheduler's concurrent slot pool "
                         "(power-of-two bucketed); below --num-requests "
                         "queued requests take freed slots")
    ap.add_argument("--spamm-tau", type=float, default=None,
                    help="enable SpAMM norm-gated GEMMs at this τ — prefill "
                         "AND decode gate (decode through frozen plans)")
    ap.add_argument("--spamm-tile", type=int, default=32)
    ap.add_argument("--spamm-backend", default="auto", choices=BACKEND_NAMES)
    ap.add_argument("--spamm-block-n", type=int, default=1,
                    help="super-column width of the mm kernel; must match "
                         "the value the plan store was precomputed with, or "
                         "every lookup misses and plans are rebuilt")
    ap.add_argument("--spamm-levels", type=int, default=0,
                    help="norm-pyramid coarsening steps for hierarchical "
                         "gating (0 = flat); coarse tile = tile · 2^levels")
    ap.add_argument("--spamm-dtype", default="float32",
                    choices=("float32", "bfloat16", "bf16", "int8"),
                    help="GEMM compute dtype of the gated GEMMs (f32 "
                         "accumulate; the gate stays a superset of the f32 "
                         "gate through the widened τ)")
    ap.add_argument("--spamm-autotune", action="store_true",
                    help="roofline-autotune block_n/levels/bucket per weight "
                         "at freeze time (core.cost); --spamm-block-n/"
                         "--spamm-levels become the tuner's defaults. Must "
                         "match the plan store's precompute setting or "
                         "lookups miss (tuned params address the artifacts)")
    ap.add_argument("--spamm-tune-profile", default=None,
                    help="calibrated cost-profile JSON for --spamm-autotune "
                         "and the cost residual (core.cost.calibrate, then "
                         "CostProfile.save)")
    ap.add_argument("--plan-store", default=None,
                    help="on-disk PlanStore directory of precomputed frozen "
                         "weight plans (populate offline with "
                         "repro_torch.launch.precompute_plans); the engine "
                         "warm-starts from it instead of running a planning "
                         "pass")
    ap.add_argument("--reshard-every", type=int, default=0,
                    help="drift-triggered re-sharding probe cadence in "
                         "engine steps (prefill + decode); 0 = off; needs "
                         "--spamm-tau. The engine keeps the equal-work row "
                         "partition a multi-GPU deployment passes to "
                         "core.distributed.spamm_rowpart(offsets=)")
    ap.add_argument("--reshard-devices", type=int, default=0,
                    help="strips to cut (0 = --spamm-mesh-devices, or 1)")
    ap.add_argument("--reshard-threshold", type=float, default=1.2,
                    help="re-cut when the live partition's predicted "
                         "imbalance exceeds the fresh cut's by this factor")
    ap.add_argument("--reshard-level", type=int, default=0,
                    help="norm-pyramid level of the re-sharding probe "
                         "estimate (coarser = cheaper)")
    ap.add_argument("--spamm-mesh-devices", type=int, default=0,
                    help="pod-sharded serving over cuda:0 … cuda:N-1, the "
                         "batch cut into request groups by the live "
                         "equal-work offsets (needs --spamm-tau; batch and "
                         "prompt length multiples of --spamm-tile)")
    ap.add_argument("--spamm-shard-width", type=int, default=0,
                    help="static per-shard width in request GROUPS (of "
                         "--spamm-tile requests each); 0 = 2·ceil(groups/"
                         "devices)")
    ap.add_argument("--no-freeze-plans", action="store_true",
                    help="legacy path: prefill and chunk steps gate through "
                         "eager plans, decode GEMMs stay dense")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--mesh", default=None,
                    help="DATA,MODEL: serve tensor-parallel over a (data, "
                         "model) mesh of the torchrun world (DATA 1)")
    ap.add_argument("--backend", default="nccl", choices=["nccl", "gloo"],
                    help="process-group backend over a mesh: nccl for one "
                         "rank per card, gloo for ranks sharing a card or "
                         "on the CPU")
    ap.add_argument("--metrics-out", default=None,
                    help="write the run's metrics registry here as a "
                         "Prometheus text dump (TTFT/decode latency "
                         "histograms, per-layer gated-GEMM series, plan "
                         "cache/store and chunked-plane counters)")
    ap.add_argument("--trace-out", default=None,
                    help="write the run's host-side spans here as Chrome-"
                         "trace JSON (freeze, plan assembly, prefill, "
                         "decode steps, prefill chunks, waves; load in "
                         "Perfetto)")
    args = ap.parse_args(argv)
    if args.mesh is None:
        return _serve(args, None, args.device)
    ctx, device = MS.join_mesh(args.device, args.backend, mesh=args.mesh,
                               tile=args.spamm_tile)
    # a failure leaves the group with the process: leaving an nccl group
    # can block behind a step that failed on the card, before the
    # traceback is shown
    _serve(args, ctx, device)
    # the engine's CUDA graphs hold nccl work of the group; its steps close
    # over it, so only the cycle collector frees them, before leaving
    gc.collect()
    MS.destroy_group()


def _serve(args, ctx, device):
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    pcfg = ParallelConfig(compute_dtype="float32", attn_q_chunk=64)
    if ctx is not None:
        ctx = M.with_placements(ctx, cfg, pcfg)
    params = M.init_params(cfg, pcfg, args.seed, device=device, ctx=ctx)
    spamm_cfg = None
    if args.spamm_tau is not None:
        spamm_cfg = SpammConfig(enable=True, tau=args.spamm_tau,
                                tile=args.spamm_tile,
                                block_n=args.spamm_block_n,
                                levels=args.spamm_levels,
                                backend=args.spamm_backend,
                                dtype=args.spamm_dtype,
                                autotune=args.spamm_autotune,
                                tune_profile=args.spamm_tune_profile)
    reshard_cfg = None
    if args.reshard_every > 0:
        if spamm_cfg is None:
            raise SystemExit("--reshard-every needs --spamm-tau (the probe "
                             "gates the live tokens at that τ)")
        reshard_cfg = ReshardConfig(
            num_devices=args.reshard_devices, every=args.reshard_every,
            drift_threshold=args.reshard_threshold, level=args.reshard_level)
    obs = Observability(process_name="repro-serve")
    eng = Engine(cfg, pcfg, params, max_len=args.max_len,
                 spamm_cfg=spamm_cfg, plan_store=args.plan_store,
                 prefill_chunk=args.prefill_chunk, max_slots=args.max_slots,
                 device=device, obs=obs, reshard_cfg=reshard_cfg,
                 mesh_devices=args.spamm_mesh_devices,
                 shard_max_width=args.spamm_shard_width or None,
                 ctx=ctx,
                 freeze_plans=False if args.no_freeze_plans else None)

    rng = np.random.default_rng(args.seed)
    if args.mixed_lengths:
        plens = rng.integers(max(1, args.prompt_len // 2),
                             args.prompt_len + 1, size=args.num_requests)
    else:
        plens = np.full(args.num_requests, args.prompt_len)
    prompts = [rng.integers(1, cfg.vocab, size=int(n)).astype(np.int32)
               for n in plens]
    for _ in range(max(args.waves, 1)):
        chunks0 = eng.chunk_steps
        reqs = [Request(prompt=p, max_new_tokens=args.max_new)
                for p in prompts]
        t0 = time.time()
        outs = eng.generate(reqs)
        dt = time.time() - t0
    peaks = None
    if torch.device(device).type == "cuda":
        # this rank's peak allocated card memory (its shards over a mesh)
        peaks = [torch.cuda.max_memory_allocated(device) / 1e9]
    if ctx is not None:
        got = [None] * dist.get_world_size()
        dist.all_gather_object(got, peaks)
        if dist.get_rank() != 0:
            return
        peaks = None if got[0] is None else [p[0] for p in got]
    total = sum(len(o) for o in outs)
    print(f"served {len(reqs)} requests, {total} tokens in {dt:.2f}s "
          f"({total/dt:.1f} tok/s)")
    if ctx is not None:
        print(f"  tensor-parallel over mesh {args.mesh} ({args.backend}): "
              f"{ctx.nmodel} model ranks")
    if peaks is not None:
        print("  peak_card_gb=" + ",".join(f"{p:.3f}" for p in peaks))
    for i, o in enumerate(outs[:4]):
        print(f"  req{i}: {o[:12].tolist()}")
    out = reqs[0].out
    sp = out.get("spamm")
    if sp is not None:
        vf, dvf = sp["valid_fraction"], sp["decode_valid_fraction"]
        print(f"  spamm: valid_fraction="
              f"{f'{vf:.3f}' if vf is not None else 'n/a'} "
              f"gated_gemms={sp['gated_gemms']} decode_valid_fraction="
              f"{f'{dvf:.3f}' if dvf is not None else 'n/a'} "
              f"decode_gated_gemms={sp['decode_gated_gemms']}")
        gb, dgb = sp["gemm_bytes_moved"], sp["decode_gemm_bytes_moved"]
        print(f"  spamm dtype={sp['compute_dtype']}: prefill_gemm_bytes="
              f"{f'{gb / 1e6:.3f}MB' if gb is not None else 'n/a'} "
              f"decode_gemm_bytes="
              f"{f'{dgb / 1e6:.3f}MB' if dgb is not None else 'n/a'}")
        if args.spamm_autotune:
            picks = collections.Counter(
                (fw.tuned.block_n, fw.tuned.levels, fw.tuned.bucket)
                for fw in frozen_leaves(eng._fw_tree))
            print("  autotune (block_n, levels, bucket): "
                  + " ".join(f"{k}x{n}" for k, n in sorted(picks.items())))
        if "plan_store_hits" in sp:
            print(f"  plan_store: {sp['plan_store_hits']}h/"
                  f"{sp['plan_store_misses']}m")
        if "resharded" in sp:
            imb = sp["partition_imbalance"]
            print(f"  reshard: events={sp['resharded']} "
                  f"probes={sp['reshard_probes']} partition_imbalance="
                  f"{f'{imb:.3f}' if imb is not None else 'n/a'}")
            offs = eng.partition_offsets
            loads = eng._resharder.live_loads
            if offs is not None:
                for d in range(len(offs) - 1):
                    ld = f"{loads[d]:.3f}" if loads is not None else "n/a"
                    print(f"    strip {d}: rows [{offs[d]}, {offs[d + 1]}) "
                          f"predicted_load={ld}")
    lay = eng.shard_layout
    if lay is not None:
        o = lay["offsets"]
        print(f"  pod-sharded over {args.spamm_mesh_devices} devices: "
              f"slot_width={lay['slot_width']} reqs/shard")
        for d, n in enumerate(lay["real"]):
            print(f"    shard {d}: reqs [{o[d]}, {o[d + 1]}) ({n} live, "
                  f"{lay['slot_width'] - n} pad slots)")
    lat = out["latency"]
    line = (f"  latency: ttft={lat['ttft_s'] * 1e3:.1f}ms"
            if lat["ttft_s"] is not None else "  latency: ttft=n/a")
    if lat["decode_steps"]:
        line += (f" decode mean={lat['decode_mean_s'] * 1e3:.1f}ms"
                 f" p50={lat['decode_p50_s'] * 1e3:.1f}ms"
                 f" ({lat['decode_steps']} steps)")
    print(line)
    if eng.chunk_steps > chunks0:
        print(f"  chunked: slots={eng._slot_count(len(reqs))} chunk="
              f"{eng._resolve_chunk(len(set(plens.tolist())) > 1)} "
              f"chunk_steps={eng.chunk_steps - chunks0}")
    g = eng.graph_stats()
    pool = (f"{g['pool_bytes'] / 1e6:.1f}MB" if g["pool_bytes"] is not None
            else "n/a")
    sg = eng.step_graphs
    graphed = ",".join(k for k in ("decode", "chunk") if sg[k])
    print(f"  steps: prefill_keys={eng.trace_counts['prefill']} "
          f"decode_keys={eng.trace_counts['decode']} "
          f"captures={g['captures']} capture_s={g['capture_s']:.2f} "
          f"graph_pool={pool} graphed={graphed or 'none'}")
    if "eager" in sg:
        print(f"  eager: {sg['eager']}")
    if args.metrics_out:
        print(f"metrics -> {obs.write_metrics(args.metrics_out)}")
    if args.trace_out:
        print(f"trace -> {obs.write_trace(args.trace_out)}")
    if args.metrics_out or args.trace_out:
        print(obs.summary_table())


if __name__ == "__main__":
    main()
