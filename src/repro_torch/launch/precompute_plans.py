"""Offline plan precomputation: populate a PlanStore for a model.

  PYTHONPATH=src python -m repro_torch.launch.precompute_plans \
      --arch starcoder2-7b --plan-store plan_store/ --tau 0.05 \
      --spamm-tile 64

Walks every gated GEMM weight of the model (attention wq/wk/wv/wo and the
MLP weights, all layers) and freezes its weight-side SpAMM plan into the
content-addressed store; a server started with the same params, device and
SpAMM flags (`repro_torch.launch.serve --plan-store ...`) then warm-starts
with store hits only: no planning pass, no get-norm on the weights.

Params come from the same seeded init the serve CLI uses, so the content
fingerprints match. Runs on the card by default; `--device cpu` freezes
with the plain PyTorch versions of the kernels (use `--reduced` there). The
artifacts record the backend that ran ("cuda" or "torch"), so a store made
on one device serves only that device. `--autotune` tunes block_n, levels
and the bucket floor per gated site (once, from the first layer of the
site; a hybrid stack's tail layers each on their own) against the cost
model with the coefficients of `--tune-profile` (a `core.cost.CostProfile`
JSON; the nominal ones without it); the flags become the tuner's defaults,
and a server finds the artifacts only with the same `--spamm-autotune
--spamm-tune-profile`.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.configs import (BACKEND_NAMES, ParallelConfig, SpammConfig,
                                 get_config)
from repro_torch.models import model as M
from repro_torch.models.transformer import group_len
from repro_torch.plans.precompute import populate
from repro_torch.plans.store import PlanStore


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--plan-store", required=True,
                    help="store directory (created if missing)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tau", type=float, required=True)
    ap.add_argument("--spamm-tile", type=int, default=32)
    ap.add_argument("--spamm-backend", default="auto", choices=BACKEND_NAMES)
    ap.add_argument("--spamm-levels", type=int, default=0)
    ap.add_argument("--spamm-dtype", default="float32",
                    choices=("float32", "bfloat16", "bf16", "int8"),
                    help="GEMM compute dtype the plans are frozen for "
                         "(quantized norms + widened gate τ; int8 also "
                         "stores the per-tile weight scale tables)")
    ap.add_argument("--block-n", type=int, default=1)
    ap.add_argument("--autotune", action="store_true",
                    help="roofline-autotune block_n/levels/bucket per weight "
                         "(core.cost.tune_weight); --block-n/--spamm-levels "
                         "become the tuner's defaults, always in its search "
                         "space")
    ap.add_argument("--tune-profile", default=None,
                    help="calibrated cost-profile JSON for --autotune "
                         "(core.cost.calibrate, then CostProfile.save)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    pcfg = ParallelConfig(compute_dtype="float32", attn_q_chunk=64)
    scfg = SpammConfig(enable=True, tau=args.tau, tile=args.spamm_tile,
                       backend=args.spamm_backend, levels=args.spamm_levels,
                       block_n=args.block_n, dtype=args.spamm_dtype,
                       autotune=args.autotune, tune_profile=args.tune_profile)
    params = M.init_params(cfg, pcfg, args.seed, device=args.device)
    store = PlanStore(args.plan_store)
    t0 = time.time()
    n = populate(store, params, scfg, group_len=group_len(cfg))
    dt = time.time() - t0
    tuned_note = " (autotuned block_n/levels/bucket)" if args.autotune else ""
    print(f"precomputed {n} weight plans into {args.plan_store} "
          f"({store.hits} already present, {store.misses} built) "
          f"in {dt:.2f}s — {len(store)} artifacts total{tuned_note}")


if __name__ == "__main__":
    main()
