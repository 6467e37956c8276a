#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from src/repro_torch/kernels/csrc, holds each
kernel against its plain PyTorch version at the serving path's shapes,
prefill and decode (and frozen ≡ eager bit for bit), then serves
starcoder2-7b at full width (d=4608, ff=18432, 36/4 heads, 32 layers,
random weights from a seed) through `Engine.generate` three ways: dense,
τ = 0 and a τ > 0 derived from the first gated GEMM of a decode step, so
that both prefill and decode keep part of their tiles. Every result line is
a JSON object;
the line before the last lists the kernels with their launches on the main
path (the τ > 0 run), errors, times and bounds; the last line is
{"ok": true, "device": {...}}. Any failed check exits non-zero. Without
CUDA, or without the repository's src/ beside it, it exits 2 and prints no
result.
"""
import json
import os
import subprocess
import sys
import time

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")

# H100 SXM data sheet: HBM3 bandwidth and f32 (non-tensor-core) peak
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12

DEV = "cuda"
ARCH = "starcoder2-7b"
TILE = 64
BATCH, PROMPT_LEN, MAX_NEW = 4, 128, 16
DECAY_N, DECAY_LAM = 4096, 0.999
MAX_LEN = PROMPT_LEN + MAX_NEW + 16
PROFILE_NEW = 4  # tokens of the profiled wave: prefill + 3 decode steps
SEED = 0
# tile norms: f32 sums of 4096 squares in two orders
NORM_RTOL = 1e-5
# work-list GEMM vs plain: FMA vs multiply-add over K ≤ 18432, relative to
# the output's largest magnitude
MM_RTOL = 1e-4
# τ = 0 vs dense prefill logits after 32 f32 layers (reassociated sums),
# relative to the logits' largest magnitude
LOGIT_RTOL = 1e-3


class SmokeFailure(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps=10, warmup=2):
    """Median of `reps` CUDA-event timings of fn(), after `warmup` calls."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    times.sort()
    return times[len(times) // 2]


def bound_ms(nbytes, flops):
    """Least time for the work on an H100: the larger of bytes over HBM
    bandwidth and f32 operations over the CUDA-core peak."""
    tb, tf = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_F32_FLOP_S * 1e3
    return max(tb, tf), ("bytes" if tb >= tf else "operations")


def errors(got, want):
    d = (got.double() - want.double()).abs()
    scale = want.double().abs().max().clamp(min=1e-30)
    return float(d.max()), float(d.max() / scale)


def check_tile_norms(x, label):
    import torch

    from repro_torch.kernels import getnorm

    t = TILE
    m, k = x.shape
    got = getnorm.tile_norms_cuda(x, t)
    want = getnorm.tile_norms_plain(x, t)
    torch.cuda.synchronize()
    rel = float(((got - want).abs() / want.abs().clamp(min=1e-30)).max())
    abs_err = float((got - want).abs().max())
    check(rel <= NORM_RTOL, f"tile_norms {label}: max rel err {rel}")
    x4 = x.view(m // t, t, k // t, t)
    bms, by = bound_ms(m * k * 4 + (m // t) * (k // t) * 4, 2 * m * k)
    res = {
        "name": "tile_norms", "shape": label, "max_abs_err": abs_err,
        "max_rel_err": rel,
        "ms": time_ms(lambda: getnorm.tile_norms_cuda(x, t)),
        "plain_ms": time_ms(lambda: getnorm.tile_norms_plain(x, t), reps=5),
        "library_ms": time_ms(
            lambda: torch.linalg.vector_norm(x4, dim=(1, 3))),
        "bound_ms": bms, "bound_by": by,
    }
    emit({"kernel_check": res})
    return res


def worklist_work(work, tile, block_n):
    """(flops, bytes) the work-list needs: 2·t³ per ACC step; each A and B
    tile the ACC steps touch read once, the output written once, the step
    tables read once."""
    import torch

    acc = (work.step_flags & 2) != 0
    si, sj, sk = (t[acc].long() for t in (work.step_i, work.step_j,
                                          work.step_k))
    n_acc = int(acc.sum())
    a_tiles = int(torch.unique(si * 1_000_003 + sk).numel())
    b_tiles = int(torch.unique(sk * 1_000_003 + sj).numel())
    flops = 2 * tile ** 3 * block_n * n_acc
    tables = 4 * work.step_i.numel() * 4 + work.runs.numel() * 4
    return flops, n_acc, (a_tiles * tile * tile * 4
                          + b_tiles * tile * tile * block_n * 4 + tables)


def check_worklist(a, b, p, label):
    import torch

    from repro_torch.kernels import spamm_mm

    w = p.work
    args = (a, b, w.step_i, w.step_j, w.step_k, w.step_flags, w.runs)
    got = spamm_mm.spamm_mm_worklist_cuda(*args, tile=TILE)
    want = spamm_mm.spamm_mm_worklist_plain(*args, tile=TILE)
    torch.cuda.synchronize()
    abs_err, rel = errors(got, want)
    check(rel <= MM_RTOL, f"spamm_mm_worklist {label}: max rel err {rel}")
    flops, n_acc, nbytes = worklist_work(w, TILE, 1)
    nbytes += a.shape[0] * b.shape[1] * 4
    bms, by = bound_ms(nbytes, flops)
    res = {
        "name": "spamm_mm_worklist", "shape": label,
        "valid_fraction": float(p.valid_fraction), "acc_steps": n_acc,
        "steps": int(w.step_i.numel()), "runs": int(w.runs.numel() - 1),
        "max_abs_err": abs_err, "max_rel_err": rel,
        "ms": time_ms(lambda: spamm_mm.spamm_mm_worklist_cuda(*args,
                                                              tile=TILE)),
        "plain_ms": time_ms(
            lambda: spamm_mm.spamm_mm_worklist_plain(*args, tile=TILE),
            reps=3, warmup=1),
        "library_ms": time_ms(lambda: torch.matmul(a, b)),
        "bound_ms": bms, "bound_by": by,
    }
    emit({"kernel_check": res})
    return res


def median_product_tau(na, nb):
    """The (lower) median of the norm products na[i,k]·nb[k,j] over all
    (i, j, k): a τ that keeps about half of the tile products."""
    return float((na[:, None, :] * nb.T[None]).flatten().median())


def check_frozen(x, w, label):
    """The frozen plan of `w` for x's row grid at τ = the median norm
    product: the work-list kernel against its plain version, and frozen ≡
    eager bit for bit (same active steps, same kernel, same k order)."""
    import torch

    from repro_torch.core import plan as P
    from repro_torch.kernels import getnorm
    from repro_torch.plans.frozen import FrozenWeight

    tau = median_product_tau(getnorm.tile_norms_cuda(x, TILE),
                             getnorm.tile_norms_cuda(w, TILE))
    fw = FrozenWeight.build(w, tau, tile=TILE, backend="cuda")
    frozen = P.plan(x, frozen_weight=fw.for_rows(x.shape[0] // TILE))
    vf = float(frozen.valid_fraction)
    check(0.0 < vf < 1.0, f"{label}: frozen plan keeps all or nothing ({vf})")
    res = check_worklist(x, w, frozen, label)
    eager = P.plan(x, w, tau, tile=TILE, backend="cuda")
    same = torch.equal(P.execute(frozen, x, w), P.execute(eager, x, w))
    emit({"frozen_equals_eager": {"shape": label, "bit_identical": same,
                                  "tau": tau, "valid_fraction": vf,
                                  "eager_valid_tiles": int(eager.valid_tiles),
                                  "frozen_valid_tiles":
                                      int(frozen.valid_tiles)}})
    check(same, f"{label}: frozen and eager plans differ")
    return res


def decode_rows(n_cols, gen):
    """A decode step's activation as the gated GEMMs see it: BATCH real
    rows, zero-padded to one row tile."""
    import torch

    x = torch.zeros(TILE, n_cols, device=DEV)
    x[:BATCH] = torch.randn(BATCH, n_cols, generator=gen, device=DEV)
    return x


def phase_kernels():
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import plan as P
    from repro_torch.kernels import getnorm

    cfg = get_config(ARCH)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    d, ff = cfg.d_model, cfg.d_ff
    w1 = torch.randn(d, ff, generator=gen, device=DEV).mul_(d ** -0.5)
    w2 = torch.randn(ff, d, generator=gen, device=DEV).mul_(ff ** -0.5)
    x = torch.randn(BATCH * PROMPT_LEN, d, generator=gen, device=DEV)
    check_tile_norms(w1, f"w1 {d}x{ff}")
    norms_act = check_tile_norms(x, f"activation {BATCH * PROMPT_LEN}x{d}")

    # (a) frozen plans of the MLP weights at the serving shapes: w1 for a
    # 512-row prefill, then w1 and w2 for a decode step (one row tile, 8 and
    # 72 runs of 72 and 288 steps)
    mm_w1 = check_frozen(x, w1, f"frozen w1 {x.shape[0]}x{d}x{ff}")
    check_frozen(decode_rows(d, gen), w1,
                 f"frozen w1 decode {TILE}({BATCH})x{d}x{ff}")
    check_frozen(decode_rows(ff, gen), w2,
                 f"frozen w2 decode {TILE}({BATCH})x{ff}x{d}")

    # (b) the paper's synthetic: exponential-decay matrices,
    # |a_ij| = lam^|i-j| · U(0.5, 1), random signs
    n, lam = DECAY_N, DECAY_LAM
    idx = torch.arange(n, device=DEV, dtype=torch.float32)
    dist = (idx[:, None] - idx[None, :]).abs()

    def decay():
        mag = lam ** dist * (0.5 + 0.5 * torch.rand(n, n, generator=gen,
                                                    device=DEV))
        sign = torch.randint(0, 2, (n, n), generator=gen, device=DEV) * 2 - 1
        return (mag * sign).contiguous()

    a, b = decay(), decay()
    tau_d = median_product_tau(getnorm.tile_norms_cuda(a, TILE),
                               getnorm.tile_norms_cuda(b, TILE))
    pd = P.plan(a, b, tau_d, tile=TILE, backend="cuda")
    vfd = float(pd.valid_fraction)
    check(0.2 < vfd < 0.8, f"exp-decay valid fraction {vfd} outside (0.2, 0.8)")
    check_worklist(a, b, pd, f"exp-decay {n}x{n}x{n} lam={lam}")
    del w1, w2, x, a, b, pd
    torch.cuda.empty_cache()
    return norms_act, mm_w1


def run_engine(cfg, pcfg, params, prompts, spamm_cfg, label):
    """Warm wave (freezes plans, first kernel calls), then the measured
    wave with every launch counter set to 0 just before it. Returns
    (engine, tokens, measured request metadata, launch counts)."""
    import numpy as np

    from repro_torch.kernels import getnorm, spamm_mm
    from repro_torch.serving.engine import Engine, Request

    eng = Engine(cfg, pcfg, params, max_len=MAX_LEN, spamm_cfg=spamm_cfg)

    def wave():
        reqs = [Request(prompt=p, max_new_tokens=MAX_NEW) for p in prompts]
        t0 = time.perf_counter()
        toks = np.stack(eng.generate(reqs))
        return toks, reqs[0].out, time.perf_counter() - t0

    _, cold, cold_s = wave()
    getnorm.launches = 0
    spamm_mm.launches = 0
    toks, out, dt = wave()
    counts = {"tile_norms": getnorm.launches,
              "spamm_mm_worklist": spamm_mm.launches}
    lat, sp = out["latency"], out["spamm"] or {}
    emit({"serve": label, "tok_per_s": toks.size / dt, "wave_s": dt,
          "ttft_ms": lat["ttft_s"] * 1e3,
          "decode_ms_per_step": (lat["decode_mean_s"] or 0.0) * 1e3,
          "decode_steps": lat["decode_steps"],
          "cold_wave_s": cold_s, "cold_ttft_ms": cold["latency"]["ttft_s"] * 1e3,
          "prefill_valid_fraction": sp.get("valid_fraction"),
          "decode_valid_fraction": sp.get("decode_valid_fraction"),
          "gated_gemms": sp.get("gated_gemms"),
          "decode_gated_gemms": sp.get("decode_gated_gemms"),
          "launches": counts, "tokens_req0": toks[0].tolist()})
    profile_wave(label, eng, prompts)
    return eng, toks, out, counts


def profile_wave(label, eng, prompts):
    """A short wave (prefill + PROFILE_NEW - 1 decode steps) under
    torch.profiler: device time by CUDA kernel, the two port kernels'
    share, and the device's busy share of the wave's wall clock (one
    stream, so kernel times do not overlap; the profiler's own host cost
    inflates the wall clock, so the share is a lower bound)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.engine import Request

    reqs = [Request(prompt=p, max_new_tokens=PROFILE_NEW) for p in prompts]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.generate(reqs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    device_ms = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])

    def share(tag):
        return sum(r[1] for r in rows if tag in r[0])

    emit({"profile": label, "decode_steps": PROFILE_NEW - 1,
          "wall_ms": wall_ms,
          "device_ms": device_ms if rows else "not measured",
          "device_busy_share": device_ms / wall_ms if rows else None,
          "tile_norms_ms": share("tile_norms_f32_kernel"),
          "spamm_mm_worklist_ms": share("spamm_worklist_f32_kernel"),
          "top": [{"kernel": k[:80], "ms": ms, "count": n}
                  for k, ms, n in rows[:8]]})


def prefill_logits(cfg, pcfg, params, prompts, eng=None):
    import torch

    from repro_torch.models import model as M

    step = M.make_prefill_step(
        cfg, pcfg, spamm_cfg=None if eng is None else eng.spamm_ctx)
    frozen = None if eng is None else eng._frozen_for(prompts.size)
    with torch.inference_mode():
        _, logits = step(params, {"tokens": torch.as_tensor(
            prompts, device=DEV)}, frozen)
    return logits


def derive_tau(cfg, params, prompts, first_tokens):
    """τ for run (c): the median of the norm products of a decode step's
    first gated GEMM (layer 0 wq on the normalised embeddings of the dense
    run's first generated tokens, zero-padded to one row tile, as the
    engine pads them). A decode tile holds BATCH real rows of 64, so its
    norm products lie far below a prefill tile's: a τ taken from prefill
    gates every decode tile out, this one keeps part of both. The prefill
    median of the same GEMM is printed beside it."""
    import torch

    from repro_torch.core.plan import pad_to_tile
    from repro_torch.kernels import getnorm
    from repro_torch.models.layers import embed, rms_norm

    wq = params["layers"][0]["mix"]["wq"]
    nb = getnorm.tile_norms_cuda(wq, TILE)

    def first_gemm_norms(tokens):
        x = embed(params["embed"], torch.as_tensor(tokens, device=DEV)
                  .long(), torch.float32)
        x = rms_norm(x, params["layers"][0]["ln1"], cfg.norm_eps)
        x = pad_to_tile(x.reshape(-1, cfg.d_model), TILE).contiguous()
        return getnorm.tile_norms_cuda(x, TILE), list(x.shape)

    with torch.inference_mode():
        na_dec, dec_shape = first_gemm_norms(first_tokens)
        na_pre, pre_shape = first_gemm_norms(prompts)
        tau = median_product_tau(na_dec, nb)
        tau_prefill = median_product_tau(na_pre, nb)
    emit({"tau_derivation": {
        "gemm": "layer 0 wq, first decode step", "activation": dec_shape,
        "weight": list(wq.shape),
        "rule": "median of norm_a[i,k]*norm_b[k,j] over all (i,j,k)",
        "tau": tau, "prefill_activation": pre_shape,
        "prefill_median": tau_prefill}})
    return tau


def phase_serve():
    import numpy as np
    import torch

    from repro_torch.configs import ParallelConfig, SpammConfig, get_config
    from repro_torch.models import model as M

    cfg = get_config(ARCH)
    pcfg = ParallelConfig(compute_dtype="float32", attn_q_chunk=PROMPT_LEN)
    t0 = time.perf_counter()
    params = M.init_params(cfg, pcfg, SEED, device=DEV)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    emit({"model": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
          "d_ff": cfg.d_ff, "heads": cfg.num_heads,
          "kv_heads": cfg.num_kv_heads, "vocab": cfg.vocab,
          "params": n_params, "init_s": time.perf_counter() - t0,
          "depth_cut": None})
    prompts = np.random.default_rng(SEED).integers(
        1, cfg.vocab, size=(BATCH, PROMPT_LEN)).astype(np.int32)

    eng, dense_toks, _, _ = run_engine(cfg, pcfg, params, prompts, None,
                                       "a: dense")
    dense_logits = prefill_logits(cfg, pcfg, params, prompts)
    del eng

    sc0 = SpammConfig(enable=True, tau=0.0, tile=TILE, block_n=1, levels=0)
    eng, toks0, out0, counts0 = run_engine(cfg, pcfg, params, prompts, sc0,
                                           "b: tau=0")
    logits0 = prefill_logits(cfg, pcfg, params, prompts, eng)
    abs_err, rel = errors(logits0, dense_logits)
    same = bool((toks0 == dense_toks).all())
    emit({"tau0_vs_dense": {"prefill_logits_max_abs_err": abs_err,
                            "prefill_logits_max_rel_err": rel,
                            "tolerance_rel": LOGIT_RTOL,
                            "tokens_equal": same}})
    check(rel <= LOGIT_RTOL, f"τ=0 prefill logits differ from dense ({rel})")
    check(same, "τ=0 greedy tokens differ from the dense run")
    check(out0["spamm"]["valid_fraction"] == 1.0, "τ=0 dropped tiles")
    check(all(v > 0 for v in counts0.values()), f"τ=0 launches {counts0}")
    del eng
    torch.cuda.empty_cache()

    tau = derive_tau(cfg, params, prompts, dense_toks[:, 0])
    sct = SpammConfig(enable=True, tau=tau, tile=TILE, block_n=1, levels=0)
    eng, _, out, counts = run_engine(cfg, pcfg, params, prompts, sct,
                                     f"c: tau={tau:.6g}")
    for phase in ("valid_fraction", "decode_valid_fraction"):
        vf = out["spamm"][phase]
        check(vf is not None and 0.0 < vf < 1.0,
              f"τ>0 {phase} {vf} not strictly inside (0, 1)")
    check(all(v > 0 for v in counts.values()), f"τ>0 launches {counts}")
    return counts


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found — run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.device import f32_numerics
    from repro_torch.kernels import build

    f32_numerics()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    t0 = time.perf_counter()
    report = build.build_all()
    emit({"build": {"seconds": time.perf_counter() - t0,
                    "sources": {s: {"seconds": r["seconds"],
                                    "cached": r["cached"],
                                    "ptxas": [ln.strip() for ln in
                                              r["ptxas"].splitlines()
                                              if "Used" in ln or "spill" in ln]}
                                for s, r in report.items()}}})

    norms_act, mm_w1 = phase_kernels()
    counts = phase_serve()

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "shape")
    kernels = [
        {"name": "tile_norms", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/getnorm.cu",
         "replaces": "src/repro/kernels/getnorm.py:147",
         "launches": counts["tile_norms"],
         **{k: norms_act[k] for k in keys}},
        {"name": "spamm_mm_worklist", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/spamm_mm.cu",
         "replaces": "src/repro/kernels/spamm_mm.py:203",
         "launches": counts["spamm_mm_worklist"],
         **{k: mm_w1[k] for k in keys}},
    ]
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
