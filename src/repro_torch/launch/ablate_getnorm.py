"""Timed variants of the get-norm kernels on one NVIDIA GPU, and the
get-norm lines of whichever port is on the path.

    PYTHONPATH=src python -m repro_torch.launch.ablate_getnorm [--variants a,b]
    PYTHONPATH=src python -m repro_torch.launch.ablate_getnorm --lines

Variants: builds copies of `kernels/csrc/getnorm.cu` that differ from the
source in one place each, points the get-norm wrappers at each in turn, and
times the pair it changes — the CUDA-core `tile_norms_cuda` and
`tile_norms_quant_cuda`, or their tensor-core (`use_mxu=True`) variants —
at starcoder2-7b's shapes (w1 4608×18432, the prefill activation 512×4608
and the decode activation 64(4)×4608 at tile 64; the prefill activation at
tiles 16 and 32), each variant twice, in turns (forward, then backward
order): back to back by CUDA events, and the device time of one launch
from the profiler. Variants of the CUDA-core pair:

  baseline   the source as it is (both pairs timed)
  runtime    every tile through the runtime-tile kernels (one 256-thread
             block per tile, a loop over a run-time count, the int8 variant
             reading its tile twice)
  two_reads  the templated int8 kernel reads its tile again for the
             dequantizing pass (through a pointer the compiler cannot
             prove equal to the first) instead of keeping it in registers
  ldcs       the templated kernels' loads marked evict-first (`__ldcs`)
  blocks8    `__launch_bounds__(256, 8)` on the templated kernels
  div_as_mul the int8 kernels' division by the scale as a multiply by its
             reciprocal
  local_max  the int8 kernels' scale from each thread's own max, with no
             barrier

and of the tensor-core pair:

  mxu_runtime    every tile through the runtime-tile kernels
                 (`*_mxu_any_*`: one 128-thread block per tile, units walked
                 in a loop over a run-time count, the int8 one reading its
                 tile twice)
  mxu_two_reads  the templated int8 kernel reads its tile again for the
                 dequantizing pass
  mxu_unpacked   one tile per block at tiles 16 and 32 (a 32- or 64-thread
                 block) instead of four or two tiles per 128 threads
  mxu_one_chain  Eq. 3 in one serial accumulator instead of two chains
  mxu_four_chains  Eq. 3 in four chains
  mxu_w8         eight warps per tile-64 tile (half a strip each) instead
                 of four
  cvt_rna        each value split into its TF32 halves by cvt.rna.tf32.f32
                 (hi rounded, lo = the rounded rest) instead of the bit
                 operations (hi truncated, lo rounded)

and of both int8 kernels:

  div_zeros      zeros divided by the scale too (the exact division's slow
                 path) instead of dividing the scale in their place

Variants held "bits" compute the kernels' function in the source's order
and must give its output bit for bit; "rtol" ones sum in another order and
must stay within NORM_RTOL of it; the last two of the CUDA-core list
compute something else, and only their times mean anything.

Each variant's line also counts, in the SASS of the tile-64 kernels on
16-byte loads (cuobjdump), the loads from memory (`LDG`, and the generic
`LD` the two_reads reloads compile to) and, for the tensor-core kernels,
the `HMMA` instructions. Builds go under `kernels/_build/ablate_getnorm/`.

Lines: times the five get-norm entries (tile_norms, tile_norms_quant,
their use_mxu variants and pool_norms on the tile-64 normmap) at the three
tile-64 shapes, and the two pairs at tiles 16 and 32 of the prefill
activation: one call by CUDA events around it (host cost inside), back
to back, the device time of one launch from the profiler, and the host
cost per call; beside them the same single-call time of the yardsticks
(`vector_norm` over the tile dims; the unfused torch composition quantize,
dequantize, `vector_norm`) and of each kernel's plain version, and each
kernel's max relative error against its plain version. It imports only names every port since the
tensor-core get-norm has, so another checkout's wrappers are timed by
running this file by path with that checkout's `src` first on PYTHONPATH:

    PYTHONPATH=/path/to/other/src python src/repro_torch/launch/ablate_getnorm.py --lines

Host: `--host` splits the host cost of one `tile_norms_cuda` and one
`tile_norms_quant_cuda` call at the decode activation into its parts
(checks, allocation, stream and device, the C entry with its launch),
each timed on the host clock over many calls of that part alone.

Prints one JSON object per line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import time

import torch

from repro_torch.configs import get_config
from repro_torch.device import f32_numerics
from repro_torch.kernels import build, getnorm

TILE = 64
ROWS, REAL_ROWS = 512, 4
# the tensor-core kernels against the source when they sum in another
# order: f32 sums of ≤ 4096 squares, each within about 2^-22
NORM_RTOL = 1e-5

_LOAD4 = "const float4 q = *reinterpret_cast<const float4*>(p);"
_LOAD1 = "v[j] = *p;"
_BOUNDS = "template <class S>\n__global__ void __launch_bounds__(kThreads)\n"
_SCALE = ("      __fmul_rn(fmaxf(tile_max<S::kTileThreads>(m), kTiny), "
          "kInv127);\n")
_RELOAD = """  {
    const float* x2;
    asm volatile("mov.b64 %0, %1;" : "=l"(x2) : "l"(x));
    load_block_tile<S>(x2, k, gk, tiles, t, v);
  }
"""
_DIV = "rintf(__fdiv_rn(v == 0.f ? scale : v, scale))"
_MAX = "tile_max<S::kTileThreads>(m)"
_TEMPLATED = "templated_tile<{}>(tile, vec,"
_MXU_SUM = "  const float s = tile_sumsq<S>(\n"
_MXU_RELOAD = _RELOAD.replace("load_block_tile<S>(x2, k, gk, tiles, t, v)",
                              "load_unit<S>(x2, k, gk, tiles, u, v)")
_CHAINS = "constexpr int kChains = 2;"
_BLOCK = "kTileThreads > kMxuThreads ? kTileThreads : kMxuThreads;"
_SEGS64 = "constexpr int kSegs64 = 4;"
_SPLIT = """  const uint32_t hi = __float_as_uint(v) & 0xffffe000u;
  const float lo = __fsub_rn(v, __uint_as_float(hi));
  return {hi, (__float_as_uint(lo) + 0x1000u) & 0xffffe000u};
"""
_CVT_SPLIT = """  uint32_t hi, lo;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(v));
  const float rest = __fsub_rn(v, __uint_as_float(hi));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));
  return {hi, lo};
"""


def _sub(src: str, old: str, new: str, count: int = 1) -> str:
    if src.count(old) != count:
        raise RuntimeError(f"ablation anchor not found {count}× in "
                           f"getnorm.cu: {old.strip().splitlines()[0]!r}")
    return src.replace(old, new)


def variants(src: str) -> dict:
    """{name: (source, check, pair)}: check "bits" (the source's output bit
    for bit), "rtol" (within NORM_RTOL of it) or None (another function);
    pair "cuda_core", "mxu" or "both" (the pair the variant changes)."""
    sum0 = "  float s = 0.f;\n"

    def runtime(shape):  # templated_tile<shape> sees no templated tile
        return _sub(src, _TEMPLATED.format(shape),
                    _TEMPLATED.format(shape).replace("tile,", "0,"), 2)

    return {
        "baseline": (src, "bits", "both"),
        "runtime": (runtime("TileShape"), "bits", "cuda_core"),
        "two_reads": (_sub(src, _SCALE + sum0, _SCALE + _RELOAD + sum0),
                      "bits", "cuda_core"),
        "ldcs": (_sub(_sub(src, _LOAD4, "const float4 q = __ldcs("
                           "reinterpret_cast<const float4*>(p));"),
                      _LOAD1, "v[j] = __ldcs(p);"), "bits", "cuda_core"),
        "blocks8": (_sub(src, _BOUNDS, _BOUNDS.replace(
            "(kThreads)", "(kThreads, 8)"), 2), "bits", "cuda_core"),
        "div_as_mul": (_sub(src, _DIV, "rintf(__fmul_rn(v, 1.0f / scale))"),
                       None, "both"),
        "local_max": (_sub(src, _MAX, "m", 2), None, "both"),
        "mxu_runtime": (runtime("MxuShape"), "bits", "mxu"),
        "mxu_two_reads": (_sub(src, _SCALE + _MXU_SUM,
                               _SCALE + _MXU_RELOAD + _MXU_SUM), "bits", "mxu"),
        "mxu_unpacked": (_sub(src, _BLOCK, "kTileThreads;"), "bits", "mxu"),
        "mxu_one_chain": (_sub(src, _CHAINS, _CHAINS.replace("2", "1")),
                          "rtol", "mxu"),
        "mxu_four_chains": (_sub(src, _CHAINS, _CHAINS.replace("2", "4")),
                            "rtol", "mxu"),
        "mxu_w8": (_sub(src, _SEGS64, _SEGS64.replace("= 4", "= 2")),
                   "rtol", "mxu"),
        "cvt_rna": (_sub(src, _SPLIT, _CVT_SPLIT), "rtol", "mxu"),
        "div_zeros": (_sub(src, _DIV, "rintf(__fdiv_rn(v, scale))"), "bits",
                      "both"),
    }


def build_variants(names, table) -> dict:
    """One nvcc per variant, all started together. Returns {name: path}."""
    root = build.BUILD_DIR / "ablate_getnorm"
    procs = {}
    for name in names:
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "getnorm.cu").write_text(table[name][0])
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-o", str(d / "lib.so"),
               str(d / "getnorm.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
    return {name: root / name / "lib.so" for name in names}


SASS_KERNELS = ("tile_norms_f32_kernel", "tile_norms_quant_f32_kernel",
                "tile_norms_mxu_f32_kernel", "tile_norms_quant_mxu_f32_kernel")


def sass_counts(path) -> dict:
    """Load instructions (LDG, generic LD) and tensor-core products (HMMA)
    in the SASS of the tile-64 kernels on 16-byte loads (TileShape<64,
    true>, MxuShape<64, true>) of the library at `path`, by kernel."""
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    counts = {k: {"loads": 0, "HMMA": 0} for k in SASS_KERNELS}
    fn = None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1]
            fn = next((k for k in counts if k in name and "ILi64ELb1E" in name),
                      None)
        elif fn and re.search(r"\s(LDG|LD)\.", line):
            counts[fn]["loads"] += 1
        elif fn and re.search(r"\sHMMA\.", line):
            counts[fn]["HMMA"] += 1
    return counts


def shapes(seed: int = 0) -> list:
    """(label, matrix, tile) at starcoder2-7b's get-norm shapes."""
    cfg = get_config("starcoder2-7b")
    d, ff = cfg.d_model, cfg.d_ff
    gen = torch.Generator(device="cuda").manual_seed(seed)
    w1 = torch.randn(d, ff, generator=gen, device="cuda").mul_(d ** -0.5)
    x = torch.randn(ROWS, d, generator=gen, device="cuda")
    xd = torch.zeros(TILE, d, device="cuda")
    xd[:REAL_ROWS] = torch.randn(REAL_ROWS, d, generator=gen, device="cuda")
    return [(f"w1 {d}x{ff}", w1, TILE),
            (f"activation {ROWS}x{d}", x, TILE),
            (f"decode activation {TILE}({REAL_ROWS})x{d}", xd, TILE),
            (f"activation {ROWS}x{d} tile 16", x, 16),
            (f"activation {ROWS}x{d} tile 32", x, 32)]


def back_to_back_ms(fn, calls=20, reps=5) -> float:
    """Median over `reps` of the CUDA-event time of `calls` calls, per call."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(calls):
            fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) / calls)
    times.sort()
    return times[len(times) // 2]


def single_call_ms(fn, reps=10) -> float:
    """Median CUDA-event time of one call, the host's launch path inside."""
    for _ in range(2):
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


def device_ms(fn, calls=50):
    """Device time of one call from the profiler (every kernel fn launches;
    each entry launches one), the mean over the launches it recorded (it
    can drop records of a long run), or "not measured" when it records
    none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    us = sum(e.self_device_time_total for e in rows)
    n = sum(e.count for e in rows)
    return us / n / 1e3 if us > 0 else "not measured"


def host_ms_per_call(fn, calls=100) -> float:
    """Host clock over `calls` calls, before the closing sync, per call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return host


def use_library(path) -> None:
    """Point the get-norm wrappers at a variant's library."""
    real = build.load
    build.load = lambda source: ctypes.CDLL(str(path))
    try:
        getnorm._LIB = None
        getnorm._lib()
    finally:
        build.load = real


def _pair(x, tile, use_mxu=False):
    suffix = "_mxu" if use_mxu else ""
    return {f"tile_norms{suffix}": lambda: getnorm.tile_norms_cuda(
                x, tile, use_mxu=use_mxu),
            f"tile_norms_quant{suffix}": lambda: getnorm.tile_norms_quant_cuda(
                x, tile, use_mxu=use_mxu)}


def _outputs(x, tile, use_mxu):
    return (getnorm.tile_norms_cuda(x, tile, use_mxu=use_mxu),
            *getnorm.tile_norms_quant_cuda(x, tile, use_mxu=use_mxu))


def _agrees(check, got, want) -> bool:
    """The variant's (norms, norms, scales) against the source's: bit for
    bit, or (check "rtol") within NORM_RTOL with the scales bit for bit."""
    if check == "bits":
        return all(torch.equal(g, w) for g, w in zip(got, want))
    rel = max(float(((g - w).abs() / w.abs().clamp(min=1e-30)).max())
              for g, w in zip(got[:2], want[:2]))
    return rel <= NORM_RTOL and torch.equal(got[2], want[2])


def run_variants(names) -> dict:
    table = variants((build.CSRC / "getnorm.cu").read_text())
    names = names or list(table)
    libs = build_variants(set(names) | {"baseline"}, table)
    cases = shapes()
    want = {}
    use_library(libs["baseline"])
    for label, x, tile in cases:
        want[label] = {m: _outputs(x, tile, m) for m in (False, True)}
    res: dict = {}
    for name in names + names[::-1]:
        use_library(libs[name])
        _, check, pair = table[name]
        mxus = {"cuda_core": (False,), "mxu": (True,),
                "both": (False, True)}[pair]
        line = {"variant": name, "sass": sass_counts(libs[name])}
        for label, x, tile in cases:
            same = True
            for use_mxu in mxus:
                got = _outputs(x, tile, use_mxu)
                torch.cuda.synchronize()
                bits = all(torch.equal(g, w)
                           for g, w in zip(got, want[label][use_mxu]))
                same = same and bits
                if check and not _agrees(check, got, want[label][use_mxu]):
                    raise RuntimeError(f"variant {name} differs from the "
                                       f"source at {label} (use_mxu="
                                       f"{use_mxu}, check {check})")
            fns = {k: v for use_mxu in mxus
                   for k, v in _pair(x, tile, use_mxu).items()}
            for kernel, fn in fns.items():
                ms = {"b2b_ms": back_to_back_ms(fn), "device_ms": device_ms(fn)}
                line.setdefault(label, {"bit_identical": same})[kernel] = ms
                res.setdefault(name, {}).setdefault(label, {}).setdefault(
                    kernel, []).append(ms)
        print(json.dumps(line), flush=True)
    getnorm._LIB = None
    return res


def yardsticks(x, tile):
    """One PyTorch computation of each function of the pair: the tile norms
    by `vector_norm`, the fused int8 pair by the unfused composition."""
    from repro_torch.kernels import quantize as Q

    m, k = x.shape
    x4 = x.view(m // tile, tile, k // tile, tile)

    def unfused():
        dq = Q.dequantize_tiles(*Q.quantize_tiles(x, tile), tile)
        return torch.linalg.vector_norm(
            dq.view(m // tile, tile, k // tile, tile), dim=(1, 3))

    return {"vector_norm": lambda: torch.linalg.vector_norm(x4, dim=(1, 3)),
            "unfused_quant": unfused}


def host_part_ms(fn, calls=2000, reps=5) -> float:
    """Median over `reps` of the host clock over `calls` calls of fn, per
    call (the device queue is drained between repetitions)."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / calls)
    torch.cuda.synchronize()
    times.sort()
    return times[len(times) // 2]


def run_host() -> dict:
    """The host cost of the pair's calls at the decode activation, part by
    part, on this tree's launch path."""
    label, x, tile = shapes()[2]
    gm, gk = x.shape[0] // tile, x.shape[1] // tile
    lib = getnorm._lib()
    out = x.new_empty((gm, gk))
    pair = x.new_empty((2, gm, gk))
    norms, scales = pair.unbind(0)
    dev = x.get_device()
    stream = torch._C._cuda_getCurrentRawStream(dev)
    xp, op, np_, sp = (x.data_ptr(), out.data_ptr(), norms.data_ptr(),
                       scales.data_ptr())
    m, k = x.shape

    def device_context():
        with torch.cuda.device(x.device):
            pass

    parts = {
        "tile_norms_cuda": lambda: getnorm.tile_norms_cuda(x, tile),
        "tile_norms_quant_cuda": lambda: getnorm.tile_norms_quant_cuda(
            x, tile),
        "checks": lambda: getnorm._check_cuda_input(x, tile, False, "t"),
        "new_empty": lambda: x.new_empty((gm, gk)),
        "new_empty_pair_unbind": lambda: x.new_empty((2, gm, gk)).unbind(0),
        "torch_empty_twice": lambda: (
            torch.empty((gm, gk), dtype=torch.float32, device=x.device),
            torch.empty((gm, gk), dtype=torch.float32, device=x.device)),
        "data_ptr_x3": lambda: (x.data_ptr(), norms.data_ptr(),
                                scales.data_ptr()),
        "device_and_stream": lambda: (
            x.get_device() == torch.cuda.current_device(),
            torch._C._cuda_getCurrentRawStream(dev)),
        "stream_object": lambda: torch.cuda.current_stream(x.device)
        .cuda_stream,
        "device_context": device_context,
        "c_entry_norms": lambda: lib.spamm_tile_norms_f32(
            xp, op, m, k, tile, stream),
        "c_entry_quant": lambda: lib.spamm_tile_norms_quant_f32(
            xp, np_, sp, m, k, tile, stream),
    }
    res = {name: host_part_ms(fn) for name, fn in parts.items()}
    print(json.dumps({"host": label, "ms_per_call": res}), flush=True)
    return res


def plains(x, tile) -> dict:
    """The plain versions of the two pairs' kernels on x."""
    out = {}
    for sfx, m in (("", False), ("_mxu", True)):
        out["tile_norms" + sfx] = lambda m=m: getnorm.tile_norms_plain(
            x, tile, use_mxu=m)
        out["tile_norms_quant" + sfx] = (
            lambda m=m: getnorm.tile_norms_quant_plain(x, tile, use_mxu=m))
    return out


def max_rel_errs(x, tile) -> dict:
    """Max relative error of each kernel of the two pairs on x against its
    plain version (the fused int8 ones: their norms)."""
    def rel(a, b):
        return float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())

    out = {}
    for use_mxu in (False, True):
        sfx = "_mxu" if use_mxu else ""
        out["tile_norms" + sfx] = rel(
            getnorm.tile_norms_cuda(x, tile, use_mxu=use_mxu),
            getnorm.tile_norms_plain(x, tile, use_mxu=use_mxu))
        out["tile_norms_quant" + sfx] = rel(
            getnorm.tile_norms_quant_cuda(x, tile, use_mxu=use_mxu)[0],
            getnorm.tile_norms_quant_plain(x, tile, use_mxu=use_mxu)[0])
    return out


def run_lines() -> dict:
    out = {}
    for label, x, tile in shapes():
        nm = getnorm.tile_norms_cuda(x, tile)
        fns = {**_pair(x, tile), **_pair(x, tile, use_mxu=True)}
        if tile == TILE:
            fns["pool_norms"] = lambda: getnorm.pool_norms_cuda(nm)
        line = {name: {"single_call_ms": single_call_ms(fn),
                       "b2b_ms": back_to_back_ms(fn),
                       "device_ms": device_ms(fn, calls=100),
                       "host_ms_per_call": host_ms_per_call(fn)}
                for name, fn in fns.items()}
        line["library_single_call_ms"] = {
            name: single_call_ms(fn) for name, fn in yardsticks(x, tile).items()}
        line["plain_single_call_ms"] = {
            name: single_call_ms(fn) for name, fn in plains(x, tile).items()}
        line["max_rel_err_vs_plain"] = max_rel_errs(x, tile)
        print(json.dumps({"lines": label, **line}), flush=True)
        out[label] = line
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default=None,
                    help="comma-separated subset (default: all)")
    ap.add_argument("--lines", action="store_true",
                    help="time the get-norm entries of the port on the path")
    ap.add_argument("--host", action="store_true",
                    help="split the host cost of a get-norm call into parts")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ablate_getnorm needs an NVIDIA GPU")
    f32_numerics()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"device": smi, "getnorm": getnorm.__file__}),
          flush=True)
    if args.lines:
        run_lines()
        return 0
    if args.host:
        run_host()
        return 0
    res = run_variants(args.variants.split(",") if args.variants else None)
    print(json.dumps({"ablation": res}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
