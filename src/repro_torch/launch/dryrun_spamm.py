"""SpAMM-at-scale dry run (twin of `repro.launch.dryrun_spamm`): the
paper's own technique on the production mesh, run as rank 0.

The reference lowers the distributed SpAMM variants for 256 fake XLA
devices on an N = 32768 algebraic-decay workload (paper §4.1's largest
size) and reads the jnp lowering, which computes the dense masked
product: its compute term is dense, scaled by the calibrated ratio. Here
this process is rank 0 of a fake process group of the production world
(`launch.mesh.fake_world`: 256 ranks as (data 32, model 8); `--multi-pod`
512 as (pod 2, data 32, model 8)) and runs its own share on the card
through the hand-written kernels (the "auto" backend: the kernels for
CUDA tensors, never a fallback), under `op_analysis.OpAnalysis`:

  * rowpart_contiguous — paper §3.4 multi-GPU scheme (rows over "data",
    B replicated), rank 0's strip of contiguous tile rows;
  * rowpart_cyclic     — + §3.5.1 load balance (strided tile rows);
  * 2d_psum_scatter    — beyond-paper SUMMA-style (rows over "data", K
    over "model", partials reduce-scattered);
  * 2d_bf16            — the same on bf16 operands (the bf16 work-list
    kernel on the tensor cores, f32 accumulation);
  * 2d_multipod        — (`--multi-pod`) rows over ("pod", "data").

The collectives are counted, not performed. Stated departures from the
reference: `compute_effective_s` is rank 0's counted tile products (the
kernels' real steps) over the peak, not dense × ratio — the jnp lowering
cannot count them, and rank 0's own fraction differs under contiguous and
cyclic cuts (§3.5.1's point); `memory_effective_s` scales by that counted
fraction; `argument_bytes` counts the whole A and B, because the port's
`spamm_rowpart` / `spamm_2d` take whole operands; the collective term
uses each axis's link rate (`dryrun.LINK_BW`). The default tile is the
reference's, 128 (the kernels take every multiple of 16 up to 512). A = B
is the unsigned decay matrix (its tile norms are the signed one's
exactly, so the gate and the work-lists are the same).

  PYTHONPATH=src python -m repro_torch.launch.dryrun_spamm [--n 32768] [--ratio 0.1] [--multi-pod]
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import time

import numpy as np
import torch

from repro_torch.core import distributed
from repro_torch.core import spamm as cs
from repro_torch.core.tau_search import search_tau
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.launch import op_analysis
from repro_torch.launch.dryrun import (HBM_BW, PEAK_FLOPS, WORLD, link_bw,
                                       mesh_name)
from repro_torch.launch.mesh import fake_world

WORKLISTS = ("spamm_mm_worklist", "spamm_mm_worklist_bf16")

# name → (kind, rowpart schedule, operand dtype, multi-pod)
VARIANTS = {
    "rowpart_contiguous": ("rowpart", "contiguous", "float32", False),
    "rowpart_cyclic": ("rowpart", "cyclic", "float32", False),
    "2d_psum_scatter": ("2d", "contiguous", "float32", False),
    "2d_bf16": ("2d", "contiguous", "bfloat16", False),
    "2d_multipod": ("2d", "contiguous", "float32", True),
}


def calibrate_tau(n_small: int, tile: int, target_ratio: float, *,
                  device="cuda", norms=None):
    """τ→ratio is ~size-stable for the §4.1 decay law (paper Table 1 shows a
    slow drift of τ with N); calibrate on a host-feasible size: the
    get-norm of `algebraic_decay(n_small, seed=0)` on `device`, or the
    given `norms`, then the τ-search. Returns (τ, achieved ratio)."""
    if norms is None:
        a = torch.as_tensor(cs.algebraic_decay(n_small, seed=0),
                            device=resolve_device(device))
        norms = ops.tile_norms(a, tile)
    tau, res = search_tau(norms, norms, target_ratio)
    return float(tau), float(res.achieved_ratio)


def decay_operand(n: int, *, device="cuda", c: float = 0.1,
                  lam: float = 0.1, rows: int = 2048) -> torch.Tensor:
    """`core.spamm.algebraic_decay(n)` (unsigned), made on `device`: the
    n values c / (d^lam + 1) of d = |i - j| in f64 by numpy's own formula,
    cast to f32, then gathered at |i - j| a block of `rows` rows at a
    time, so each element equals numpy's bit for bit."""
    dev = resolve_device(device)
    d = np.arange(n, dtype=np.float64)
    v = torch.as_tensor((c / (d ** lam + 1.0)).astype(np.float32),
                        device=dev)
    out = torch.empty((n, n), dtype=torch.float32, device=dev)
    j = torch.arange(n, device=dev)
    for r0 in range(0, n, rows):
        i = torch.arange(r0, min(r0 + rows, n), device=dev)
        out[r0:r0 + i.numel()] = v[(i[:, None] - j[None, :]).abs()]
    return out


def run_variant(name: str, a: torch.Tensor, tau: float, ratio: float, *,
                tile: int = 128, mesh_shape=None, out_dir=None,
                verbose: bool = True):
    """One variant as rank 0 of the production world (`mesh_shape`, (shape,
    axis names), overrides it) on A = B = `a`. Returns (the reference's
    JSON, local): `local` is rank 0's own product before its first
    collective (rowpart: its strip of C; 2d: its k-slice partial, before
    the reduce-scatter) and the operands that give it —
    {"product", "a", "b", "compute_dtype"}."""
    kind, schedule, dtype, multi_pod = VARIANTS[name]
    dev = a.device
    base = 0
    if dev.type == "cuda":
        # the peak counts `a` and what the variant allocates, not what else
        # the process holds (collected first: garbage freed during the run
        # would lower the base)
        gc.collect()
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev) - a.numel() * a.element_size()
    x = a.to(torch.bfloat16) if dtype == "bfloat16" else a
    n = a.shape[0]
    world = WORLD * (2 if multi_pod else 1)
    kw = {}
    if mesh_shape is not None:
        kw = {"shape": mesh_shape[0], "axis_names": mesh_shape[1]}
        world = int(np.prod(mesh_shape[0]))
    with fake_world(world, multi_pod=multi_pod, device_type=dev.type,
                    **kw) as mesh:
        names = mesh.mesh_dim_names
        row_axis = ("pod", "data") if "pod" in names else "data"
        nrow, r, _ = distributed._axis(mesh, row_axis)
        axes = {}
        if isinstance(row_axis, tuple):
            axes[mesh[row_axis]._flatten().get_group(0).group_name] = \
                "_".join(row_axis)
        t0 = time.perf_counter()
        with op_analysis.OpAnalysis(mesh, axes=axes) as an:
            if kind == "rowpart":
                distributed.spamm_rowpart(
                    x, x, tau, mesh, axis=row_axis, tile=tile,
                    schedule=schedule, compute_dtype=dtype)
            else:
                distributed.spamm_2d(
                    x, x, tau, mesh, row_axis=row_axis, col_axis="model",
                    tile=tile, compute_dtype=dtype)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated(dev) - base
                if dev.type == "cuda" else None)
        mname = mesh_name(mesh)
        ncol, q, _ = distributed._axis(mesh, "model") if kind == "2d" \
            else (1, 0, None)
        rows, _, _ = distributed._row_layout(
            x, x, tau, nrow, r, tile=tile, backend="auto", sched_levels=3,
            schedule=schedule, offsets=None)
    # rank 0's operands and its product before the first collective
    a_loc = x.reshape(n // tile, tile, n)[torch.as_tensor(rows, device=dev)]
    a_loc = a_loc.reshape(-1, n)
    kw_ = n // ncol
    a_loc = a_loc[:, q * kw_:(q + 1) * kw_].contiguous()
    b_loc = x[q * kw_:(q + 1) * kw_]
    kind0, prod = an.first_collective
    if kind0 == "reduce-scatter":
        m_loc = a_loc.shape[0]
        prod = prod.reshape(ncol, m_loc, n // ncol).transpose(0, 1)
        prod = prod.reshape(m_loc, n)
    local = {"product": prod, "a": a_loc, "b": b_loc, "compute_dtype": dtype}

    t = an.totals()
    ks = {k: v for k, v in t["kernels"].items() if k in WORKLISTS}
    dense = sum(v["dense_flops"] for v in ks.values())
    eff = sum(v["flops"] for v in ks.values())
    frac = eff / dense if dense else 0.0
    peak_flops = PEAK_FLOPS[dtype]
    coll = {str(ax): w / link_bw(ax)
            for ax, w in an.wire_bytes_by_axis().items()}
    mem_s = t["hbm_bytes_per_device"] / HBM_BW
    terms = {
        "compute_dense_s": dense / peak_flops,
        "compute_effective_s": eff / peak_flops,
        "memory_s": mem_s,
        "memory_effective_s": mem_s * frac,
        "collective_s": sum(coll.values()),
    }
    out = {
        "variant": name,
        "n": n,
        "tile": tile,
        "mesh": mname,
        "devices": world,
        "tau": tau,
        "valid_ratio": ratio,
        "rank_valid_fraction": frac,
        "tile_products": sum(v["tile_products"] for v in ks.values()),
        "roofline": {**terms, "collective_s_by_axis": coll},
        "collectives": t["collectives"],
        "kernels": t["kernels"],
        "flops_per_device": t["flops_per_device"],
        "hbm_bytes_per_device": t["hbm_bytes_per_device"],
        "memory": {
            "argument_bytes": 2 * x.numel() * x.element_size(),
            "peak_bytes": peak,
        },
        "seconds": seconds,
        "rates": {"peak_flops": peak_flops, "hbm_bw": HBM_BW,
                  "source": "H100 SXM data sheet"},
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(f"{out_dir}/{name}.json", "w") as f:
            json.dump(out, f, indent=1)
    if verbose:
        cb = {k: f"{v['wire_bytes'] / 1e9:.2f}GB"
              for k, v in t["collectives"].items()}
        print(f"[OK] spamm/{name} ({mname}): "
              f"dense_c={terms['compute_dense_s'] * 1e3:.2f}ms "
              f"eff_c={terms['compute_effective_s'] * 1e3:.2f}ms "
              f"mem={terms['memory_s'] * 1e3:.1f}ms "
              f"coll={terms['collective_s'] * 1e3:.2f}ms {cb} "
              f"rank0_frac={frac:.4f} step={seconds:.2f}s", flush=True)
    return out, local


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=32768)
    ap.add_argument("--tile", type=int, default=128,
                    help="the SpAMM tile, the reference's 128 by default "
                         "(the kernels take multiples of 16 up to 512)")
    ap.add_argument("--ratio", type=float, default=0.10)
    ap.add_argument("--out", default="experiments/dryrun_spamm")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--multi-pod", action="store_true",
                    help="2×32×8: the pod axis joins data as the row "
                         "partition (the paper's 'distributed GPUs' future "
                         "work)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    tau, ratio = calibrate_tau(4096, args.tile, args.ratio, device=dev)
    print(f"calibrated tau={tau:.4f} → ratio≈{ratio:.3f} (N=4096 proxy)")
    a = decay_operand(args.n, device=dev)
    names = (["2d_multipod"] if args.multi_pod else
             ["rowpart_contiguous", "rowpart_cyclic", "2d_psum_scatter",
              "2d_bf16"])
    for name in names:
        run_variant(name, a, tau, ratio, tile=args.tile, out_dir=args.out)


if __name__ == "__main__":
    main()
