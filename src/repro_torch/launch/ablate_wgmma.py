"""Ablation of the `wgmma` work-list kernels (bf16 and int8) on one NVIDIA
GPU.

    PYTHONPATH=src python -m repro_torch.launch.ablate_wgmma [--variants a,b]

Builds variants of `kernels/csrc/spamm_wgmma.cu` that differ from the
source in one place each, and times each at starcoder2-7b's serving shapes
(frozen w1 prefill 512×4608×18432 at block_n 1 and, int8, 2; decode w1
64(4)×4608×18432; decode w2 64(4)×18432×4608, 4 column slices of 16) and
at the reference's large tiles 128, 256 and 512 (frozen w1 at half its
tile products), at both operand types, each variant twice, in turns
(forward, then backward order). A time is the device time of one call:
CUDA-event time of a CUDA graph of `CALLS` captured calls, per call, the
median of 5 replays (no host cost inside). Variants:

  baseline        the source as it is
  stages3/6       a ring of 3 or 6 stages in place of 4
  no_raster       blocks launched in run order, not column by column
  more_blocks     registers budgeted for one more block an SM (bf16 3 at
                  width ≤ 64, 2 above; int8 4)
  wide            int8 blocks of 128 columns at T > 64 (the kernel built
                  at that width too, registers budgeted for 2 blocks an
                  SM there), in place of 64
  narrow          (no rebuild) bf16 blocks of 64 columns at T > 64 (the
                  K-chunked 64-tile cut), in place of up to 256
  int8_w32        (no rebuild) int8 blocks of at most 32 columns at every
                  tile (a 64-column block split in two: half the chain a
                  block, more blocks an SM)
  test_wait       the barrier waits spin on mbarrier.test_wait, not on the
                  suspending try_wait
  drop_transpose  int8: no shared-to-shared B transpose
  drop_wgmma      no tensor-core products
  drop_fold       int8: one add per output in place of the scaled fold
                  (f32(dot) still taken)
  drop_fence      int8: no proxy fence between the transpose's stores and
                  the tensor cores' reads
  drop_loads      no TMA copies (the producer arrives on the full barrier
                  with no bytes)

The first ten compute the kernels' function and are held against the
plain versions (int8 bit for bit, bf16 within 1e-4 of the output's largest
magnitude); the drop_* variants compute something else, and only their
times mean anything. A variant whose ring does not fit a block's shared
memory at some width (stages6 at bf16 width 256) records "not launched"
there. Builds go under `kernels/_build/ablate_wgmma/`.
Prints one JSON object per variant and pass, then a summary line
{"ablation": {variant: {case: [ms, ...]}}}.

    PYTHONPATH=other/src python src/repro_torch/launch/ablate_wgmma.py --lines

times the bf16 and int8 work-list kernels of whichever tree is on the path
(by path, so another checkout's package is imported, e.g. the parent's)
at the same cases and at the tiles that are not multiples of 64 (frozen w1
prefill at ODD_TILES, the activation zero-padded to the tile, and at
CUT_TILES on w1 cut to CUT_SHAPE; w2 decode at ODD_DECODE_TILES), and
the f32 work-list at the four serving shapes and
the wq and wk decode shapes (the decode shapes with `rows=REAL_ROWS`
where the tree's wrapper takes it: the f32 decode kernel; a tree without
it runs its 64-row kernel):
device ms (graphed), one call and CALLS back to back (host cost inside),
the host's own ms a call (CALLS calls issued with no sync, the least of
21 passes), the library call's device ms (f32 decode: also at the live
rows), the bound (`bound_ms`: the card's least time for the call's bytes
or operations), the geometry.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import inspect
import json
import subprocess
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core import plan as P
from repro_torch.device import f32_numerics
from repro_torch.kernels import build, getnorm, spamm_mm
from repro_torch.kernels import quantize as Q
from repro_torch.plans.frozen import FrozenWeight

ROWS, REAL_ROWS = 512, 4
LARGE_TILES = (128, 256, 512)
# the tiles that are not multiples of 64: frozen w1 prefill at ODD_TILES
# (the activation zero-padded to the tile) and at CUT_TILES on w1 cut to
# CUT_SHAPE (4608 and 18432 take no 80 or 112), w2 decode at
# ODD_DECODE_TILES (REAL_ROWS live rows of one row tile)
ODD_TILES = (16, 32, 48, 96, 144)
CUT_TILES = (80, 112)
CUT_SHAPE = (4480, 17920)
ODD_DECODE_TILES = (32, 48, 96)
CALLS = 20
MM_RTOL = 1e-4
# an H100 SXM's HBM rate and peak rates (bytes/s, operations/s by type)
PEAK_BYTES_S = 3.35e12
PEAK_OP_S = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}

_STAGES = "constexpr int kStagesWgmma = 4;"
_INT8_WIDEST = "constexpr int kMaxWidthInt8 = 64;"
_INT8_AT = "  SPAMM_INT8_AT(64)\n"
_TRY_WAIT = "mbarrier.try_wait.parity.shared::cta.b64"
_TMA_INCLUDE = '#include "tma.cuh"\n'
_RASTER = "runs, out, n, block_n, tile, m / tile);"
_RASTER8 = "runs, out, k, n, block_n, tile, m / tile);"
_BLOCKS_BF16 = "static constexpr int MIN_BLOCKS = W <= 64 ? 2 : 1;"
_BLOCKS_INT8 = "static constexpr int MIN_BLOCKS = 3;"
_TRANSPOSE_START = ("#pragma unroll\n    for (int it = 0; it < (ITEMS + kConsumers - 1)"
                    " / kConsumers; ++it) {")
_TRANSPOSE_END = "    // the generic-proxy stores, visible to the tensor cores' reads"
_WGMMA_BF16 = ("    for (int q = 0; q < 4; ++q) wgmma_bf16<W>(acc.c, da[q], "
               "db[q]);\n")
_WGMMA_S8 = """    wgmma_s8<W>(acc.d, da, db);
    wgmma_s8<W>(acc.d, da1, db + 2);
"""
_FOLD = """      acc.c[r] = __fadd_rn(acc.c[r], __fmul_rn(__fmul_rn(dot, s.x), s.y));"""
_NO_FOLD = "      acc.c[r] += dot;"
_LOAD = """            mbar_expect_tx(&full[stage], P::bytes(lay, d, live));
            P::load(ring + stage * lay.stage, lay, a_map,
                    d == kBand ? mb : mb_tail, en.x * tile + kc * kBand,
                    en.y * tile + row0, en.z * jstride + col0,
                    en.x * tile + kc * kBand, &full[stage]);"""
_NO_LOAD = "            mbar_arrive(&full[stage]);"
_FENCE = '  asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");\n'


def _sub(src: str, old: str, new: str, count: int = 1) -> str:
    if src.count(old) != count:
        raise RuntimeError(f"ablation anchor not found {count}× in "
                           f"spamm_wgmma.cu: {old.strip().splitlines()[0]!r}")
    return src.replace(old, new)


def _cut(src: str, start: str, end: str) -> str:
    i, j = src.index(start), src.index(end)
    return src[:i] + src[j:]


def _inline_tma(src: str) -> str:
    """`src` with csrc/tma.cuh (the barrier waits, TMA copies, tensor maps)
    pasted in place of its include, for a variant that changes them."""
    header = (build.CSRC / "tma.cuh").read_text()
    return _sub(src, _TMA_INCLUDE, header.replace("#pragma once\n", ""))


def variants(src: str) -> dict:
    """{name: (source, computes the kernels' function)}; wide, narrow and
    int8_w32 launch at other widths (`widths`), narrow and int8_w32 on
    the baseline's library."""
    no_raster = _sub(_sub(src, _RASTER, _RASTER.replace("m / tile", "1")),
                     _RASTER8, _RASTER8.replace("m / tile", "1"))
    no_wgmma = _sub(_sub(src, _WGMMA_BF16, ""), _WGMMA_S8, "")
    no_loads = _sub(src, _LOAD, _NO_LOAD)
    more_blocks = _sub(_sub(src, _BLOCKS_INT8, _BLOCKS_INT8.replace(
        "3", "4")), _BLOCKS_BF16, _BLOCKS_BF16.replace("2 : 1", "3 : 2"))
    wide = _sub(_sub(_sub(src, _INT8_WIDEST, _INT8_WIDEST.replace(
        "64", "128")), _INT8_AT, _INT8_AT + "  SPAMM_INT8_AT(128)\n"),
        _BLOCKS_INT8, _BLOCKS_INT8.replace("3", "W <= 64 ? 3 : 2"))
    test_wait = _sub(_inline_tma(src), _TRY_WAIT,
                     _TRY_WAIT.replace("try_wait", "test_wait"))
    return {
        "baseline": (src, True),
        "stages3": (_sub(src, _STAGES, _STAGES.replace("4", "3")), True),
        "stages6": (_sub(src, _STAGES, _STAGES.replace("4", "6")), True),
        "no_raster": (no_raster, True),
        "more_blocks": (more_blocks, True),
        "wide": (wide, True),
        "narrow": (src, True),
        "int8_w32": (src, True),
        "test_wait": (test_wait, True),
        "drop_transpose": (_cut(src, _TRANSPOSE_START, _TRANSPOSE_END),
                           False),
        "drop_wgmma": (no_wgmma, False),
        "drop_fold": (_sub(src, _FOLD, _NO_FOLD), False),
        "drop_fence": (_sub(src, _FENCE, ""), False),
        "drop_loads": (no_loads, False),
    }


def widths() -> dict:
    """The launch widths of the variants that reuse the baseline's library:
    {name: ({dtype: widest}, whether tile 64 is timed too)}."""
    return {"wide": ({torch.int8: 128}, False),
            "narrow": ({torch.bfloat16: 64}, False),
            "int8_w32": ({torch.int8: 32}, True)}


def build_variants(names, table) -> dict:
    """One nvcc per variant source, all started together. Returns {name:
    library path}."""
    root = build.BUILD_DIR / "ablate_wgmma"
    procs, paths = {}, {}
    for name in names:
        src = table[name][0]
        key = next(n for n in table if table[n][0] == src)  # narrow → baseline
        d = root / key
        paths[name] = d / "lib.so"
        if key in procs:
            continue
        d.mkdir(parents=True, exist_ok=True)
        (d / "spamm_wgmma.cu").write_text(src)
        procs[key] = subprocess.Popen(
            build.nvcc_command(d / "spamm_wgmma.cu", d / "lib.so"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
    return paths


def _median_tau(x, w, dtype, tile):
    """τ whose widened gate sits at the median norm product of the
    (quantized or rounded) operands: about half the tile products kept."""
    if dtype == "int8":
        na, nb = (getnorm.tile_norms_quant_cuda(t, tile)[0] for t in (x, w))
    elif dtype == "float32":
        na, nb = (getnorm.tile_norms_cuda(t, tile) for t in (x, w))
    else:
        na, nb = (getnorm.tile_norms_cuda(t.bfloat16().float(), tile)
                  for t in (x, w))
    med = float((na[:, None, :] * nb.T[None]).flatten().median())
    eps = Q.gate_eps(dtype, tile)
    return med / ((1.0 - eps) ** 2 if eps < 1 else 1)


def _launch(fn, args, kw, max_width=None):
    """fn(*args, **kw), its `wgmma` blocks capped at `max_width` columns
    when one is given (so a tree whose wrappers predate the argument is
    timed with none)."""
    if max_width is not None:
        kw = {**kw, "max_width": max_width}
    return fn(*args, **kw)


def cases(seed: int = 0, f32: bool = False, odd: bool = False) -> list:
    """(dtype, label, call, tile, plain output, library call, library call
    at the live rows or None, `bound_ms`) at the serving shapes and the
    large tiles
    (`odd`: also at ODD_TILES, CUT_TILES and ODD_DECODE_TILES);
    int8 at tiles ≥ 254 on a valid_ratio 0.5 plan (the widened int8 gate
    keeps every tile there). The library call is the dense product of the
    same operands: `torch._int_mm` on the codes (B column-major),
    `torch.matmul` at bf16 and f32. `f32` adds the f32 work-list at the
    four serving shapes (tile 64) and at the wq and wk decode shapes, the
    decode ones at REAL_ROWS live rows where the wrapper takes `rows`,
    with `torch.matmul` at those rows."""
    takes_rows = "rows" in inspect.signature(
        spamm_mm.spamm_mm_worklist_cuda).parameters
    cfg = get_config("starcoder2-7b")
    d, ff = cfg.d_model, cfg.d_ff
    gen = torch.Generator(device="cuda").manual_seed(seed)
    w1 = torch.randn(d, ff, generator=gen, device="cuda").mul_(d ** -0.5)
    w2 = torch.randn(ff, d, generator=gen, device="cuda").mul_(ff ** -0.5)
    x = torch.randn(ROWS, d, generator=gen, device="cuda")

    def decode(n):
        xd = torch.zeros(64, n, device="cuda")
        xd[:REAL_ROWS] = torch.randn(REAL_ROWS, n, generator=gen,
                                     device="cuda")
        return xd

    shapes = [(f"frozen w1 {ROWS}x{d}x{ff}", x, w1, 64, 1),
              (f"frozen w1 {ROWS}x{d}x{ff} block_n 2", x, w1, 64, 2),
              (f"frozen w1 decode 64({REAL_ROWS})x{d}x{ff}", decode(d), w1,
               64, 1),
              (f"frozen w2 decode 64({REAL_ROWS})x{ff}x{d}", decode(ff), w2,
               64, 1)]
    shapes += [(f"frozen w1 {ROWS}x{d}x{ff} tile {t}", x, w1, t, 1)
               for t in LARGE_TILES]
    if f32:
        # the attention projections' decode shapes: wq (= wo) and wk (= wv)
        kv = cfg.num_kv_heads * (d // cfg.num_heads)
        for name, n in (("wq", d), ("wk", kv)):
            w = torch.randn(d, n, generator=gen, device="cuda").mul_(
                d ** -0.5)
            shapes.append((f"frozen {name} decode 64({REAL_ROWS})x{d}x{n}",
                           decode(d), w, 64, 1))
    if odd:
        for t in ODD_TILES:
            xp = P.pad_to_tile(x, t).contiguous()
            shapes.append((f"frozen w1 {xp.shape[0]}({ROWS})x{d}x{ff} tile "
                           f"{t}", xp, w1, t, 1))
        dc, fc = CUT_SHAPE
        wc = w1[:dc, :fc].contiguous()
        for t in CUT_TILES:
            xp = P.pad_to_tile(x[:, :dc], t).contiguous()
            shapes.append((f"frozen w1 {xp.shape[0]}({ROWS})x{dc}x{fc} tile "
                           f"{t}", xp, wc, t, 1))
        xd = torch.zeros(max(ODD_DECODE_TILES), ff, device="cuda")
        xd[:REAL_ROWS] = torch.randn(REAL_ROWS, ff, generator=gen,
                                     device="cuda")
        for t in ODD_DECODE_TILES:
            shapes.append((f"frozen w2 decode {t}({REAL_ROWS})x{ff}x{d} "
                           f"tile {t}", xd[:t], w2, t, 1))
    out = []
    for dtype in ("int8", "bfloat16") + (("float32",) if f32 else ()):
        for label, a, w, tile, block_n in shapes:
            if dtype == "bfloat16" and block_n > 1:
                continue
            if dtype == "float32" and tile != 64:
                continue
            if dtype != "float32" and label.split()[1] in ("wq", "wk"):
                continue
            if dtype == "int8" and Q.gate_eps("int8", tile) >= 1:
                p = P.plan(a, w, valid_ratio=0.5, tile=tile,
                           compute_dtype="int8")
            else:
                fw = FrozenWeight.build(w, _median_tau(a, w, dtype, tile),
                                        tile=tile, block_n=block_n,
                                        backend="cuda", compute_dtype=dtype)
                p = P.plan(a, frozen_weight=fw.for_rows(a.shape[0] // tile))
            wk = p.work
            tabs = (wk.step_i, wk.step_j, wk.step_k, wk.step_flags, wk.runs)
            kw = {"tile": tile, "block_n": block_n}
            live = None
            if dtype == "int8":
                a_q, a_s = Q.quantize_tiles(a, tile, scales=p.a_scale)
                b_q, b_s = Q.quantize_tiles(w, tile, scales=p.b_scale)
                args = (a_q, b_q, a_s, b_s, *tabs)
                call = functools.partial(
                    _launch, spamm_mm.spamm_mm_worklist_int8_cuda, args, kw)
                want = spamm_mm.spamm_mm_worklist_int8_plain(*args, **kw)
                b_cm = b_q.t().contiguous().t()
                library = (lambda a_q=a_q, b_cm=b_cm:
                           torch._int_mm(a_q, b_cm))
            else:
                cast = torch.bfloat16 if dtype == "bfloat16" else a.dtype
                args = (a.to(cast), w.to(cast), *tabs)
                if dtype == "float32" and "decode" in label:
                    if takes_rows:
                        kw = {**kw, "rows": REAL_ROWS}
                    ar = a[:REAL_ROWS].contiguous()
                    live = lambda ar=ar, w=w: torch.matmul(ar, w)  # noqa
                call = functools.partial(
                    _launch, spamm_mm.spamm_mm_worklist_cuda, args, kw)
                plain_kw = {k: v for k, v in kw.items() if k != "rows"}
                want = spamm_mm.spamm_mm_worklist_plain(*args, **plain_kw)
                library = (lambda ab=args[0], wb=args[1]:
                           torch.matmul(ab, wb))
            out.append((dtype, f"{dtype} {label}", call, tile, want,
                        library, live,
                        bound_ms(wk, tile, block_n, dtype, want.numel())))
    return out


def bound_ms(work, tile, block_n, dtype, out_numel) -> float:
    """Least device ms of a work-list call on an H100: the larger of its
    bytes over the HBM rate (each A and B tile the ACC steps touch read
    once, the step tables once, int8's scales once, the f32 output written
    once) and its operations (2·t³ an ACC step and column group) over the
    peak rate of `dtype`; counted on this call's tables."""
    acc = (work.step_flags & 2) != 0
    si, sj, sk = (t[acc].long() for t in (work.step_i, work.step_j,
                                          work.step_k))
    a_tiles = int(torch.unique(si * 1_000_003 + sk).numel())
    b_tiles = int(torch.unique(sk * 1_000_003 + sj).numel())
    item = {"float32": 4, "bfloat16": 2, "int8": 1}[dtype]
    nbytes = ((a_tiles + b_tiles * block_n) * tile * tile * item
              + 4 * work.step_i.numel() * 4 + work.runs.numel() * 4
              + out_numel * 4)
    if dtype == "int8":
        nbytes += (a_tiles + b_tiles * block_n) * 4
    ops = 2 * tile ** 3 * block_n * int(acc.sum())
    return max(nbytes / PEAK_BYTES_S, ops / PEAK_OP_S[dtype]) * 1e3


def graph_ms(fn, calls=CALLS, reps=5) -> float:
    """Device time of one call: `calls` calls captured as a CUDA graph,
    CUDA-event time of its replays, per call (median of `reps`)."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        g.replay()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) / calls)
    del g
    times.sort()
    return times[len(times) // 2]


def use_library(path) -> None:
    """Point the wgmma wrappers at a variant's library."""
    real = build.load
    build.load = lambda source: ctypes.CDLL(str(path))
    try:
        spamm_mm._WGMMA_LIB = None
        spamm_mm._wgmma_lib()
    finally:
        build.load = real


def _agrees(dtype, got, want) -> bool:
    if dtype == "int8":
        return bool(torch.equal(got, want))
    err = (got.double() - want.double()).abs().max()
    return bool(err <= MM_RTOL * want.double().abs().max())


def event_ms(fn, calls=1, reps=7) -> float:
    """CUDA-event time of `calls` back-to-back calls of fn(), host cost
    inside, per call (median of `reps`)."""
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


def host_ms(fn, calls=CALLS, reps=21) -> float:
    """Host time of one call: `calls` calls issued back to back with no
    sync inside (the device keeps up or queues), per call, the least of
    `reps` passes (the host's jitter only adds)."""
    fn()
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t0) / calls)
    torch.cuda.synchronize()
    return best * 1e3


def run_lines() -> None:
    """One line per case for the tree on the path (the f32 and odd-tile
    lines too): device ms (graphed), one call, CALLS back to back, host ms
    a call, the library call's device ms (f32 decode: also at the live
    rows), the bound (`bound_ms`), the launch geometry."""
    for dtype, label, call, tile, want, library, live, bound in cases(
            f32=True, odd=True):
        got = call()
        geo = dict(spamm_mm.last_geometry)
        torch.cuda.synchronize()
        line = {"line": label, "tile": tile,
                "agrees_with_plain": _agrees(dtype, got, want),
                "device_ms": graph_ms(call), "ms": event_ms(call),
                "ms_back_to_back": event_ms(call, calls=CALLS),
                "host_ms": host_ms(call),
                "library_device_ms": graph_ms(library), "bound_ms": bound,
                "geometry": geo}
        if live is not None:
            line["library_live_rows_device_ms"] = graph_ms(live)
        print(json.dumps(line), flush=True)


def run_variants(names) -> dict:
    table = variants((build.CSRC / "spamm_wgmma.cu").read_text())
    libs = build_variants(names, table)
    shapes, over = cases(), widths()
    res: dict = {}
    for name in names + names[::-1]:
        use_library(libs[name])
        rule, at64 = over.get(name, ({}, True))
        line = {}
        for dtype, label, call, tile, want, _, _, _ in shapes:
            width = rule.get(torch.int8 if dtype == "int8"
                             else torch.bfloat16)
            if name in over and ((tile == 64 and not at64) or width is None):
                continue
            fn = functools.partial(call, max_width=width)
            try:
                got = fn()
            except RuntimeError as exc:
                if name == "baseline":
                    raise
                line[label] = {"ms": "not launched", "error": str(exc)}
                continue
            torch.cuda.synchronize()
            same = _agrees(dtype, got, want)
            if table[name][1] and not same:
                raise RuntimeError(f"variant {name} differs from the plain "
                                   f"version at {label}")
            ms = graph_ms(fn)
            res.setdefault(name, {}).setdefault(label, []).append(ms)
            line[label] = {"ms": ms, "agrees_with_plain": same,
                           "width": spamm_mm.last_geometry["width"]}
        print(json.dumps({"variant": name, **line}), flush=True)
    spamm_mm._WGMMA_LIB = None
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default=None,
                    help="comma-separated subset (default: all)")
    ap.add_argument("--lines", action="store_true",
                    help="time the kernels of the tree on the path, no "
                         "variants (run by path to time another checkout)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ablate_wgmma needs an NVIDIA GPU")
    f32_numerics()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(json.dumps({"card": smi.stdout.strip()}), flush=True)
    if args.lines:
        run_lines()
        return 0
    names = (args.variants.split(",") if args.variants
             else list(variants((build.CSRC / "spamm_wgmma.cu").read_text())))
    print(json.dumps({"ablation": run_variants(names)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
