"""Training CLI of the port (twin of `repro.launch.train`).

  PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-7b \
      --steps 200 --batch 8 --seq 256 [--spamm --tau 0.0] \
      [--resume auto] [--reduced] [--device cpu]

Trains from `init_params(seed=0)` on the card by default; `--device cpu`
runs the plain PyTorch versions of the kernels (use `--reduced` there).
`--resume auto` restarts from the latest checkpoint in `--ckpt-dir`.
`--metrics-out FILE` writes the run's metrics registry as Prometheus text
(train_step_seconds, the per-layer spamm_valid_fraction series);
`--trace-out FILE` writes its host spans (train_step, checkpoint_save) as
Chrome-trace JSON; either prints the registry's summary table.
`--reshard-every N` (with `--spamm`) probes the drift-triggered
re-sharding controller every N steps (`--reshard-devices` strips,
`--reshard-threshold` drift factor).

Over a mesh, one process per rank (torchrun sets RANK, WORLD_SIZE,
MASTER_ADDR, MASTER_PORT and LOCAL_RANK):

  torchrun --nproc-per-node 8 -m repro_torch.launch.train \
      --arch starcoder2-7b --mesh 2,4 --backend nccl ...

`--mesh DATA,MODEL` lays a (data, model) mesh over the world;
`--production-mesh` the production one (`launch.mesh.production_shape`:
model = the 8 GPUs of a node, data = the nodes) and a bf16 compute dtype,
as the reference's flag. `--backend` is stated, never switched: "nccl"
for one rank per card (rank r on cuda:LOCAL_RANK), "gloo" for ranks that
share a card or run on the CPU.
"""
from __future__ import annotations

import argparse
import os

import torch

from repro_torch.configs import (ParallelConfig, SpammConfig, TrainConfig,
                                 get_config)
from repro_torch.core.schedule import ReshardConfig
from repro_torch.launch import mesh as MS
from repro_torch.obs import Observability
from repro_torch.train.loop import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--spamm", action="store_true",
                    help="enable SpAMM on all eligible GEMMs")
    ap.add_argument("--tau", type=float, default=0.0)
    ap.add_argument("--spamm-tile", type=int, default=64)
    ap.add_argument("--resume", default="no", choices=["no", "auto"])
    ap.add_argument("--ckpt-dir", default=TrainConfig().ckpt_dir)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "int8_ef"])
    ap.add_argument("--reshard-every", type=int, default=0,
                    help="drift-triggered re-sharding probe cadence in "
                         "train steps; 0 = off (needs --spamm)")
    ap.add_argument("--reshard-devices", type=int, default=0,
                    help="strips to cut (0 = the mesh's batch-axis extent; "
                         "1 on one device)")
    ap.add_argument("--reshard-threshold", type=float, default=1.2,
                    help="re-cut when the live partition's predicted "
                         "imbalance exceeds the fresh cut's by this factor")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--mesh", default=None,
                    help="DATA,MODEL: train over a (data, model) mesh of the "
                         "torchrun world")
    ap.add_argument("--production-mesh", action="store_true",
                    help="the production mesh (model = 8 GPUs of a node, "
                         "data = the nodes) and a bf16 compute dtype")
    ap.add_argument("--backend", default="nccl", choices=["nccl", "gloo"],
                    help="process-group backend over a mesh: nccl for one "
                         "rank per card, gloo for ranks sharing a card or "
                         "on the CPU")
    ap.add_argument("--metrics-out", default=None,
                    help="write the run's metrics registry here as a "
                         "Prometheus text dump (train_step_seconds, "
                         "per-layer spamm_valid_fraction)")
    ap.add_argument("--trace-out", default=None,
                    help="write the run's host-side spans here as Chrome-"
                         "trace JSON (load in Perfetto)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    pcfg = ParallelConfig(
        compute_dtype="bfloat16" if args.production_mesh else "float32",
        remat="none" if args.reduced else "full",
        attn_q_chunk=64, loss_chunk=128,
        grad_compression=args.grad_compression,
    )
    tcfg = TrainConfig(
        lr=args.lr, total_steps=args.steps, warmup=min(100, args.steps // 10),
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
    )
    spamm_cfg = (SpammConfig(enable=True, tau=args.tau, tile=args.spamm_tile,
                             backend="auto")
                 if args.spamm else None)
    reshard_cfg = (ReshardConfig(num_devices=args.reshard_devices,
                                 every=args.reshard_every,
                                 drift_threshold=args.reshard_threshold)
                   if args.reshard_every > 0 else None)
    obs = Observability(process_name="repro-train")
    ctx, device = None, args.device
    if args.mesh or args.production_mesh:
        ctx, device = MS.join_mesh(args.device, args.backend,
                                   mesh=args.mesh,
                                   production=args.production_mesh,
                                   tile=args.spamm_tile)
    try:
        res = train(cfg, pcfg, tcfg, global_batch=args.batch,
                    seq_len=args.seq, spamm_cfg=spamm_cfg,
                    reshard_cfg=reshard_cfg, resume=(args.resume == "auto"),
                    obs=obs, device=device, ctx=ctx)
    finally:
        if ctx is not None:
            MS.destroy_group()
    if ctx is not None and int(os.environ.get("RANK", "0")) != 0:
        return
    print(f"done: steps={res.final_step} first_loss={res.losses[0]:.4f} "
          f"last_loss={res.losses[-1]:.4f} stragglers={res.straggler_steps}")
    if torch.device(device).type == "cuda":
        # this rank's peak allocated card memory (its shards over a mesh)
        peak = torch.cuda.max_memory_allocated(device) / 1e9
        print(f"peak_card_gb={peak:.3f}")
    if res.spamm_stats:
        fracs = [s["valid_fraction"] for s in res.spamm_stats
                 if s["valid_fraction"] is not None]
        if fracs:
            print(f"spamm: mean_valid_fraction={sum(fracs)/len(fracs):.3f} "
                  f"gated_gemms/step={res.spamm_stats[-1]['gated_gemms']}")
        last = res.spamm_stats[-1]
        if "resharded" in last:
            imb = last["imbalance"]
            imb_s = f"{imb:.3f}" if imb is not None else "n/a"
            print(f"reshard: events={last['resharded']} "
                  f"partition_imbalance={imb_s}")
    if args.metrics_out:
        print(f"metrics -> {obs.write_metrics(args.metrics_out)}")
    if args.trace_out:
        print(f"trace -> {obs.write_trace(args.trace_out)}")
    if args.metrics_out or args.trace_out:
        print(obs.summary_table())


if __name__ == "__main__":
    main()
