"""Production-mesh dry run (twin of `repro.launch.dryrun`): one (arch ×
shape) cell's rank-0 step, counted.

The reference lowers and compiles each cell for 256 (or 512) fake XLA
devices and reads the compiled program: `memory_analysis()`,
`cost_analysis()` and its HLO walker. torch compiles nothing, but this
process can be rank 0 of a fake process group of the production world
(`launch.mesh.fake_world`; `production_shape`: 256 ranks are a (32, 8)
(data, model) mesh, "model" the 8 GPUs of an NVLink node; `--multi-pod`
512 as (2, 32, 8)) and run its real share of the step on the card: its
placed parameter shards, the AdamW moments (train), its input batch and
its placed cache (decode), through `make_train_step` /
`make_prefill_step` / `make_decode_step`, under `op_analysis.OpAnalysis`.
The collectives are counted, not performed (the fake group moves no
data), so no value of the step means anything: the parameters are zeros.

The reference's `sds` and `shard_tree` have no counterpart: rank 0's
placed shards are real tensors (`models.model.placements`, whose
`place_spec` holds `sanitize_spec`), allocated at their local shapes.
A `global_batch` that does not divide over the data ranks runs replicated
over them, as the reference's `build_cell` does.

  memory: `argument_bytes` the rank's shards, moments, inputs and cache;
    `peak_bytes` the high-water mark of `torch.cuda.max_memory_allocated`
    over the cell (its arguments and its step) above what was allocated
    before it (None on the CPU); `output_bytes` and `temp_bytes` peak −
    arguments (the counterpart of `compiled.memory_analysis()`).
  roofline: each dtype's FLOPs over its own peak (the analysis records
    them by operand dtype: the port's attention computes in f32, at a
    fifteenth of the bf16 rate), HBM bytes over the HBM rate, and each
    mesh axis's wire bytes over that axis's link rate (the reference has
    one ICI rate; a GPU cluster has NVLink inside a node and a NIC between
    nodes). The rates are the H100 SXM data sheet's, not measurements.

Usage (on the card; `--device cpu` runs the plain versions here):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-32b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import time
import traceback

import torch

from repro_torch import tree as T
from repro_torch.configs import (SHAPES, ParallelConfig, TrainConfig, cells,
                                 get_config)
from repro_torch.device import resolve_device
from repro_torch.launch import op_analysis
from repro_torch.launch.mesh import fake_world, make_ctx
from repro_torch.models import model as M
from repro_torch.models import ssm as S
from repro_torch.optim.adamw import AdamW

# H100 SXM data sheet (per GPU, dense), not measurements
PEAK_FLOPS = {           # FLOP/s by operand dtype
    "float32": 67e12,    # on the CUDA cores (the port keeps TF32 off)
    "bfloat16": 989e12,  # on the tensor cores
    "float16": 989e12,
    "int8": 1979e12,
}
HBM_BW = 3.35e12         # bytes/s, HBM3
LINK_BW = {              # bytes/s per direction of the axis's link
    "model": 450e9,      # NVLink 4 inside an 8-GPU node
    "data": 50e9,        # one 400 Gb/s NDR NIC per GPU between nodes
    "pod": 50e9,
}
WORLD = 256


def compute_seconds(flops_by_dtype: dict) -> float:
    """Each dtype's FLOPs over its peak (a dtype with none listed at the
    f32 rate)."""
    return sum(f / PEAK_FLOPS.get(dt, PEAK_FLOPS["float32"])
               for dt, f in flops_by_dtype.items())


def link_bw(axis) -> float:
    """The link rate of a mesh axis (a group of no axis: the slowest)."""
    return LINK_BW.get(axis, min(LINK_BW.values()))


def mesh_name(mesh) -> str:
    return "x".join(str(s) for s in mesh.shape)


def batch_specs(cfg, shape, ctx) -> dict:
    """Rank-local input shapes and dtypes: {"tokens": ((b, s), int32)} or,
    behind a stub frontend, {"embeds": ((b, s, d), bf16)}; b is the
    global batch over the data ranks of `ctx` (a `NetCtx`; its
    `batch_axes` empty when the batch is replicated)."""
    b = shape.global_batch // ctx.ndata
    s = shape.seq_len
    if cfg.frontend:
        return {"embeds": ((b, s, cfg.d_model), torch.bfloat16)}
    return {"tokens": ((b, s), torch.int32)}


def model_flops_estimate(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6·N·D train, 2·N·D per generated/prefilled token
    (N = active params, excluding embed table; attention ignored — this is
    the standard 6ND yardstick the task prescribes)."""
    d, l = cfg.d_model, cfg.num_layers
    if cfg.family == "ssm":
        dims = S.ssm_dims(cfg.ssm, d)
        per_layer = d * dims.proj_out + dims.d_inner * d
    elif cfg.family == "hybrid":
        w = cfg.rglru.lru_width or d
        hd, hq, hk = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
        attn = d * hd * (hq + 2 * hk) + hq * hd * d
        rec = 3 * d * w + 2 * (w // 16) * w  # in×2 + out + blockdiag gates
        mlp = 3 * d * cfg.d_ff
        n_attn = cfg.num_layers // 3
        n_rec = cfg.num_layers - n_attn
        per_layer = 0.0
        total = n_attn * (attn + mlp) + n_rec * (rec + mlp)
        n_active = total + cfg.vocab * d  # + unembed
        toks = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
        mult = 6.0 if shape.kind == "train" else 2.0
        return mult * n_active * toks
    else:
        hd, hq, hk = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
        attn = d * hd * (hq + 2 * hk) + hq * hd * d
        if cfg.moe is not None:
            mcfg = cfg.moe
            ffn = 3 * d * mcfg.expert_ff * mcfg.top_k
            if mcfg.num_shared:
                ffn += 3 * d * mcfg.shared_ff
            ffn += d * mcfg.num_experts  # router
        else:
            n_mats = 3 if cfg.act in ("silu", "gelu") else 2
            ffn = n_mats * d * cfg.d_ff
        per_layer = attn + ffn
    n_active = l * per_layer + cfg.vocab * d  # + unembed (embed lookup ~free)
    toks = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * toks


def _local_shape(shape, spec, ctx) -> tuple:
    """A leaf's shape on this rank: each placed dim over its axes."""
    out = list(shape)
    for dim, entry in enumerate(spec):
        for ax in M._entry_axes(entry):
            out[dim] //= ctx.size(ax)
    return tuple(out)


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in T.leaves(tree))


def cell_ctx(mesh, shape, *, tile: int = 64):
    """The `NetCtx` a cell runs under: batch over the mesh's data axes, or
    replicated over them when the global batch does not divide (the
    reference's `build_cell`)."""
    ctx = make_ctx(mesh, tile=tile)
    if shape.global_batch % ctx.ndata:
        ctx = make_ctx(mesh, tile=tile, batch_axes=())
    return ctx


def build_cell(cfg, shape, mesh, pcfg: ParallelConfig, *, device="cuda",
               tile: int = 64):
    """Rank 0's tensors and step for one cell on `mesh` (a fake world's):
    (run, meta), `run()` one step; meta holds the ctx, the local batch and
    the argument bytes."""
    dev = resolve_device(device)
    ctx = M.with_placements(cell_ctx(mesh, shape, tile=tile), cfg, pcfg)
    whole = M.init_params(cfg, pcfg, device="meta",
                          model_axis_size=ctx.nmodel)
    params = T.map_specs(
        lambda spec, t: torch.zeros(_local_shape(t.shape, spec, ctx),
                                    dtype=t.dtype, device=dev),
        ctx.specs, whole)
    inp = {k: torch.zeros(s, dtype=dt, device=dev)
           for k, (s, dt) in batch_specs(cfg, shape, ctx).items()}
    args = [params, inp]
    b_loc = next(iter(inp.values())).shape[0]
    if shape.kind == "train":
        opt = AdamW(TrainConfig())
        state = opt.init(params)
        inp["labels"] = torch.zeros((b_loc, shape.seq_len), dtype=torch.int32,
                                    device=dev)
        args.append(state)
        step = M.make_train_step(cfg, pcfg, opt, ctx=ctx)

        def run():
            return step(params, state, inp, 0)
    elif shape.kind == "prefill":
        step = M.make_prefill_step(cfg, pcfg, ctx=ctx)

        def run():
            with torch.no_grad():
                return step(params, inp)
    else:
        cache = M.init_cache(cfg, pcfg, b_loc, shape.seq_len, device=dev,
                             ctx=ctx)
        args.append(cache)
        tok = ({"embeds": torch.zeros((b_loc, 1, cfg.d_model),
                                      dtype=torch.bfloat16, device=dev)}
               if cfg.frontend else
               {"tokens": torch.zeros((b_loc, 1), dtype=torch.int32,
                                      device=dev)})
        inp.clear()
        inp.update(tok)
        step = M.make_decode_step(cfg, pcfg, ctx=ctx)
        x = next(iter(inp.values()))

        def run():
            with torch.no_grad():
                return step(params, x, cache, shape.seq_len - 1)
    return run, {"ctx": ctx, "batch": b_loc,
                 "argument_bytes": sum(_bytes(a) for a in args)}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_cell(arch, shape_name, multi_pod=False, pcfg=None, out_dir=None, *,
             device="cuda", cfg=None, shape=None, mesh_shape=None,
             tile: int = 64, verbose: bool = True) -> dict:
    """One cell as rank 0 of the production world (`mesh_shape`, (shape,
    axis names), overrides it): the reference's JSON, written to
    `out_dir/<mesh>/<arch>__<shape>.json` when `out_dir` is given."""
    pcfg = pcfg or ParallelConfig(compute_dtype="bfloat16")
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    dev = resolve_device(device)
    world = WORLD * (2 if multi_pod else 1)
    kw = {}
    if mesh_shape is not None:
        kw = {"shape": mesh_shape[0], "axis_names": mesh_shape[1]}
        world = math.prod(mesh_shape[0])
    with fake_world(world, multi_pod=multi_pod, device_type=dev.type,
                    **kw) as mesh:
        ndev = world
        base = 0
        if dev.type == "cuda":
            # garbage collected during the step would lower the base
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        run, meta = build_cell(cfg, shape, mesh, pcfg, device=dev, tile=tile)
        _sync(dev)
        t_lower = time.perf_counter() - t0
        t0 = time.perf_counter()
        with op_analysis.OpAnalysis(mesh) as an:
            run()
            _sync(dev)
        t_step = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated(dev) - base
                if dev.type == "cuda" else None)
        name = mesh_name(mesh)
        del run
    totals = an.totals()
    args_b = meta["argument_bytes"]
    mf = model_flops_estimate(cfg, shape)
    flops_dev = totals["flops_per_device"]
    by_axis = an.wire_bytes_by_axis()
    coll = {str(a): w / link_bw(a) for a, w in by_axis.items()}
    terms = {
        "compute_s": compute_seconds(totals["flops_by_dtype"]),
        "memory_s": totals["hbm_bytes_per_device"] / HBM_BW,
        "collective_s": sum(coll.values()),
    }
    dom = max(terms, key=terms.get)
    out = {
        "arch": arch,
        "shape": shape.name,
        "mesh": name,
        "devices": ndev,
        "lower_s": t_lower,      # allocating the rank's tensors
        "compile_s": t_step,     # the counted step (nothing compiles)
        "memory": {
            "argument_bytes": args_b,
            "output_bytes": None if peak is None else peak - args_b,
            "temp_bytes": None if peak is None else peak - args_b,
            "peak_bytes": peak,
        },
        "xla_cost_analysis_flops": None,
        "hlo": totals,           # the op analysis's totals, same keys
        "top_bytes": an.top_bytes(8),
        "roofline": {
            **terms,
            "collective_s_by_axis": coll,
            "dominant": dom,
            "model_flops_global": mf,
            "model_flops_per_device": mf / ndev,
            "useful_flops_ratio": (mf / ndev) / flops_dev if flops_dev else None,
            "step_time_bound_s": max(terms.values()),
        },
        "rates": {"peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW,
                  "link_bw": LINK_BW, "source": "H100 SXM data sheet"},
        "batch_per_rank": meta["batch"],
        "batch_replicated": not meta["ctx"].batch_axes,
    }
    if out_dir:
        fn = f"{out_dir}/{name}/{arch}__{shape.name}.json"
        os.makedirs(os.path.dirname(fn), exist_ok=True)
        with open(fn, "w") as f:
            json.dump(out, f, indent=1)
    if verbose:
        pk = "n/a" if peak is None else f"{peak / 1e9:.2f}GB"
        print(f"[OK] {arch} × {shape.name} ({name}): step={t_step:.1f}s "
              f"peak={pk}/rank "
              f"terms(c/m/coll)={terms['compute_s']:.3e}/"
              f"{terms['memory_s']:.3e}/{terms['collective_s']:.3e}s "
              f"dom={dom}", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--param-dtype", default="float32")
    ap.add_argument("--compute-dtype", default="bfloat16",
                    help="the reference's production default (the port's "
                         "own default is float32)")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--q-chunk", type=int, default=512)
    ap.add_argument("--loss-chunk", type=int, default=1024)
    ap.add_argument("--seq-shard-acts", action="store_true")
    ap.add_argument("--tile", type=int, default=64,
                    help="the tile model cuts align to (the SpAMM tile)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tag", default="", help="suffix for the output dir")
    args = ap.parse_args(argv)

    pcfg = ParallelConfig(remat=args.remat, param_dtype=args.param_dtype,
                          compute_dtype=args.compute_dtype,
                          fsdp=not args.no_fsdp,
                          attn_q_chunk=args.q_chunk,
                          loss_chunk=args.loss_chunk,
                          seq_shard_acts=args.seq_shard_acts)
    if args.tag:
        args.out = args.out.rstrip("/") + "_" + args.tag
    if args.all:
        todo = [(a, s) for a, s, skip in cells() if not skip]
    else:
        todo = [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = []
    for arch, shape in todo:
        for mp in meshes:
            try:
                run_cell(arch, shape, mp, pcfg, args.out, device=args.device,
                         tile=args.tile)
            except Exception as e:
                failures.append((arch, shape, mp, repr(e)))
                print(f"[FAIL] {arch} × {shape} mp={mp}: {e}", flush=True)
                traceback.print_exc()
    if failures:
        raise SystemExit(f"{len(failures)} cells failed")


if __name__ == "__main__":
    main()
