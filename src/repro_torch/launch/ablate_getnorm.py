"""Timed variants of the CUDA-core get-norm pair on one NVIDIA GPU, and the
get-norm lines of whichever port is on the path.

    PYTHONPATH=src python -m repro_torch.launch.ablate_getnorm [--variants a,b]
    PYTHONPATH=src python -m repro_torch.launch.ablate_getnorm --lines

Variants: builds copies of `kernels/csrc/getnorm.cu` that differ from the
source in one place each, points the get-norm wrappers at each in turn, and
times `tile_norms_cuda` and `tile_norms_quant_cuda` at starcoder2-7b's
shapes (w1 4608×18432, the prefill activation 512×4608 and the decode
activation 64(4)×4608 at tile 64; the prefill activation at tile 16), each
variant twice, in turns (forward, then backward order): back to back by
CUDA events, and the device time of one launch from the profiler. Variants:

  baseline   the source as it is
  runtime    every tile through the runtime-tile kernels (one 256-thread
             block per tile, a loop over a run-time count, the int8 variant
             reading its tile twice)
  two_reads  the templated int8 kernel reads its tile again for the
             dequantizing pass (through a pointer the compiler cannot
             prove equal to the first) instead of keeping it in registers
  ldcs       the templated kernels' loads marked evict-first (`__ldcs`)
  blocks8    `__launch_bounds__(256, 8)` on the templated kernels
  div_as_mul the int8 kernel's division by the scale as a multiply by its
             reciprocal
  local_max  the int8 kernel's scale from each thread's own max, with no
             barrier

The first five compute the kernels' function and are held bit for bit
against the source's output; the last two compute something else, and
only their times mean anything.

Each variant's line also counts the loads from memory (`LDG`, and the
generic `LD` the two_reads reload compiles to) in the SASS of the tile-64
kernels on 16-byte loads (cuobjdump). Builds go under
`kernels/_build/ablate_getnorm/`.

Lines: times the five get-norm entries (tile_norms, tile_norms_quant,
their use_mxu variants and pool_norms on the tile-64 normmap) at the three
tile-64 shapes: one call by CUDA events around it (host cost inside), back
to back, the device time of one launch from the profiler, and the host
cost per call; beside them the same single-call time of the yardsticks
(`vector_norm` over the tile dims; the unfused torch composition quantize,
dequantize, `vector_norm`). It imports only names every port since the get-norm
kernels has, so another checkout's wrappers are timed by running this file
by path with that checkout's `src` first on PYTHONPATH:

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
_DIV = "rintf(__fdiv_rn(v, scale))"
_MAX = "tile_max<S::kTileThreads>(m)"


def _sub(src: str, old: str, new: str, count: int = 1) -> str:
    if src.count(old) != count:
        raise RuntimeError(f"ablation anchor not found {count}× in "
                           f"getnorm.cu: {old.strip().splitlines()[0]!r}")
    return src.replace(old, new)


def variants(src: str) -> dict:
    """{name: (source, computes the kernels' function)}."""
    return {
        "baseline": (src, True),
        "runtime": (_sub(src, "  switch (tile) {", "  switch (0) {"), True),
        "two_reads": (_sub(src, _SCALE, _SCALE + _RELOAD), True),
        "ldcs": (_sub(_sub(src, _LOAD4, "const float4 q = __ldcs("
                           "reinterpret_cast<const float4*>(p));"),
                      _LOAD1, "v[j] = __ldcs(p);"), True),
        "blocks8": (_sub(src, _BOUNDS, _BOUNDS.replace(
            "(kThreads)", "(kThreads, 8)"), 2), True),
        "div_as_mul": (_sub(src, _DIV, "rintf(__fmul_rn(v, 1.0f / scale))"),
                       False),
        "local_max": (_sub(src, _MAX, "m"), False),
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


def global_loads(path) -> dict:
    """Load instructions (LDG, generic LD) in the SASS of the tile-64
    kernels on 16-byte loads (TileShape<64, true>) of the library at
    `path`, by kernel."""
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {"tile_norms_f32_kernel": 0,
                  "tile_norms_quant_f32_kernel": 0}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1]
            fn = next((k for k in counts if k in name and "ILi64ELb1E" in name),
                      None)
        elif fn and re.search(r"\s(LDG|LD)\.", line):
            counts[fn] += 1
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
            (f"activation {ROWS}x{d} tile 16", x, 16)]


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
    each entry launches one), or "not measured" when it records none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / calls / 1e3 if us > 0 else "not measured"


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


def _pair(x, tile):
    return {"tile_norms": lambda: getnorm.tile_norms_cuda(x, tile),
            "tile_norms_quant": lambda: getnorm.tile_norms_quant_cuda(x, tile)}


def run_variants(names) -> dict:
    table = variants((build.CSRC / "getnorm.cu").read_text())
    names = names or list(table)
    libs = build_variants(set(names) | {"baseline"}, table)
    cases = shapes()
    want = {}
    use_library(libs["baseline"])
    for label, x, tile in cases:
        n = getnorm.tile_norms_cuda(x, tile)
        want[label] = (n, *getnorm.tile_norms_quant_cuda(x, tile))
    res: dict = {}
    for name in names + names[::-1]:
        use_library(libs[name])
        line = {"variant": name, "loads": global_loads(libs[name])}
        for label, x, tile in cases:
            got = (getnorm.tile_norms_cuda(x, tile),
                   *getnorm.tile_norms_quant_cuda(x, tile))
            torch.cuda.synchronize()
            same = all(torch.equal(g, w) for g, w in zip(got, want[label]))
            if table[name][1] and not same:
                raise RuntimeError(f"variant {name} differs from the source "
                                   f"at {label}")
            for kernel, fn in _pair(x, tile).items():
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


def run_lines() -> dict:
    out = {}
    for label, x, tile in shapes()[:3]:
        nm = getnorm.tile_norms_cuda(x, tile)
        fns = {**_pair(x, tile),
               "tile_norms_mxu": lambda: getnorm.tile_norms_cuda(
                   x, tile, use_mxu=True),
               "tile_norms_quant_mxu": lambda: getnorm.tile_norms_quant_cuda(
                   x, tile, use_mxu=True),
               "pool_norms": lambda: getnorm.pool_norms_cuda(nm)}
        line = {name: {"single_call_ms": single_call_ms(fn),
                       "b2b_ms": back_to_back_ms(fn),
                       "device_ms": device_ms(fn, calls=100),
                       "host_ms_per_call": host_ms_per_call(fn)}
                for name, fn in fns.items()}
        line["library_single_call_ms"] = {
            name: single_call_ms(fn) for name, fn in yardsticks(x, tile).items()}
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
