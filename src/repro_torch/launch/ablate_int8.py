"""Ablation of the int8 work-list kernel on one NVIDIA GPU.

    PYTHONPATH=src python -m repro_torch.launch.ablate_int8 [--variants a,b]

Builds variants of `kernels/csrc/spamm_mm.cu` that differ from the source in
one place each, and times each with CUDA events over back-to-back launches
of `spamm_mm_worklist_int8_cuda` at starcoder2-7b's int8 serving shapes
(frozen w1 prefill 512×4608×18432 at block_n 1 and 2, decode w1
64(4)×4608×18432, decode w2 64(4)×18432×4608), each variant twice, in
turns (forward, then backward order). Variants:

  baseline        the source as it is
  stages2/3       a ring of 2 or 3 stages in place of 4
  bias_convert    f32(dot) read off an s32 fragment started at the bits of
                  1.5·2²³, in place of the int → float conversion
  gather_b        no transpose: each lane gathers its B bytes from the
                  landed (k, n) tile with byte loads (tile 64 only)
  drop_loads      no tile copies (the scales still land)
  drop_transpose  no shared-to-shared B transpose
  drop_mma        no tensor-core products (the fragments are still loaded)
  drop_epilogue   one add per output in place of the scaled fold
  skeleton        all four dropped: the step list, ring, barriers and
                  fragment loads alone

The first four compute the kernel's function and are held bit for bit
against the plain version; the drop_* variants and skeleton compute
something else, and only their times mean anything. Builds go under
`kernels/_build/ablate/`. Prints one JSON object per variant and pass, then
a summary line {"ablation": {variant: {shape: [ms, ...]}}}.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from repro_torch.configs import get_config
from repro_torch.core import plan as P
from repro_torch.device import f32_numerics
from repro_torch.kernels import build, getnorm, spamm_mm
from repro_torch.kernels import quantize as Q
from repro_torch.plans.frozen import FrozenWeight

TILE = 64
ROWS, REAL_ROWS = 512, 4

_A_LOAD = """    for (int e = threadIdx.x; e < TILE * TILE / 16; e += NT) {
      const int r = e / (TILE / 16);
      const int c = 16 * (e % (TILE / 16));
      cp_async16(as + r * LDA + c, ag + static_cast<size_t>(r) * lda + c);
    }
    for (int e = threadIdx.x; e < TILE * W / 16; e += NT) {
      const int r = e / (W / 16);
      const int c = 16 * (e % (W / 16));
      cp_async16(bs + b_slot(r) * W + c, bg + static_cast<size_t>(r) * ldb + c);
    }
"""
_TRANSPOSE_START = "    for (int e = threadIdx.x; e < KB * CW; e += NT) {"
_TRANSPOSE_END = "    __syncthreads();\n    // 2. the exact s32 tile dots"
_B_FRAGMENTS = """          const int mi = ln / 8;
          const int n = nb * 8 + (mi / 2) * 8 + ln % 8;
          unsigned b0, b1, b2, b3;
          asm volatile(
              "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, "
              "[%4];\\n"
              : "=r"(b0), "=r"(b1), "=r"(b2), "=r"(b3)
              : "r"(smem_addr(bt + bt_row(n) * LDA + kk + (mi % 2) * 16)));
"""
_GATHER_B = """          auto gather = [&](int n, int k0) {
            unsigned v = 0;
#pragma unroll
            for (int q = 0; q < 4; ++q)
              v |= static_cast<unsigned>(bs[b_slot(k0 + q) * W + n])
                   << (8 * q);
            return v;
          };
          const int n = nb * 8 + ln / 4;
          const int k0 = kk + 4 * (ln % 4);
          const unsigned b0 = gather(n, k0), b1 = gather(n, k0 + 16),
                         b2 = gather(n + 8, k0), b3 = gather(n + 8, k0 + 16);
"""
_MMA = """          mma(d[nb], a0, a1, a2, a3, b0, b1);
          mma(d[nb + 1], a0, a1, a2, a3, b2, b3);"""
_NO_MMA = """          d[nb][0] += a0 ^ a1 ^ b0 ^ b1;
          d[nb + 1][0] += a2 ^ a3 ^ b2 ^ b3;"""
_FOLD = """        acc.c[nb][r] = __fadd_rn(
            acc.c[nb][r], __fmul_rn(__fmul_rn(__int2float_rn(d[nb][r]), sa),
                                    sb));"""
_NO_FOLD = "        acc.c[nb][r] += __int_as_float(d[nb][r]);"


def _sub(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"ablation anchor not found once in spamm_mm.cu: "
                           f"{old.strip().splitlines()[0]!r}")
    return src.replace(old, new)


def _cut(src: str, start: str, end: str) -> str:
    i, j = src.index(start), src.index(end)
    return src[:i] + src[j:]


def variants(src: str) -> dict:
    """{name: (source, computes the kernel's function)}."""
    stages = "constexpr int kStagesInt8 = 4;"
    bias = _sub(_sub(src, "for (int r = 0; r < 4; ++r) d[nb][r] = 0;",
                     "for (int r = 0; r < 4; ++r) d[nb][r] = 0x4B400000;"),
                "__int2float_rn(d[nb][r])",
                "__fsub_rn(__int_as_float(d[nb][r]), 12582912.f)")
    no_transpose = _cut(src, _TRANSPOSE_START, _TRANSPOSE_END)
    skeleton = _cut(_sub(_sub(_sub(src, _A_LOAD, ""), _MMA, _NO_MMA),
                         _FOLD, _NO_FOLD), _TRANSPOSE_START, _TRANSPOSE_END)
    return {
        "baseline": (src, True),
        "stages2": (_sub(src, stages, stages.replace("4", "2")), True),
        "stages3": (_sub(src, stages, stages.replace("4", "3")), True),
        "bias_convert": (bias, True),
        "gather_b": (_sub(no_transpose, _B_FRAGMENTS, _GATHER_B), True),
        "drop_loads": (_sub(src, _A_LOAD, ""), False),
        "drop_transpose": (no_transpose, False),
        "drop_mma": (_sub(src, _MMA, _NO_MMA), False),
        "drop_epilogue": (_sub(src, _FOLD, _NO_FOLD), False),
        "skeleton": (skeleton, False),
    }


def build_variants(names, table) -> dict:
    """One nvcc per variant, all started together. Returns {name: path}."""
    root = build.BUILD_DIR / "ablate"
    procs = {}
    for name in names:
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "spamm_mm.cu").write_text(table[name][0])
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-o", str(d / "lib.so"),
               str(d / "spamm_mm.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
    return {name: root / name / "lib.so" for name in names}


def _median_tau(x, w):
    """τ whose widened int8 gate sits at the median quantized norm product,
    so the plan keeps about half of its tile products."""
    na = getnorm.tile_norms_quant_cuda(x, TILE)[0]
    nb = getnorm.tile_norms_quant_cuda(w, TILE)[0]
    med = float((na[:, None, :] * nb.T[None]).flatten().median())
    return med / (1.0 - Q.gate_eps("int8", TILE)) ** 2


def cases(seed: int = 0) -> list:
    """(label, kernel args, block_n, plain output) at the serving shapes."""
    cfg = get_config("starcoder2-7b")
    d, ff = cfg.d_model, cfg.d_ff
    gen = torch.Generator(device="cuda").manual_seed(seed)
    w1 = torch.randn(d, ff, generator=gen, device="cuda").mul_(d ** -0.5)
    w2 = torch.randn(ff, d, generator=gen, device="cuda").mul_(ff ** -0.5)
    x = torch.randn(ROWS, d, generator=gen, device="cuda")

    def decode(n):
        xd = torch.zeros(TILE, n, device="cuda")
        xd[:REAL_ROWS] = torch.randn(REAL_ROWS, n, generator=gen,
                                     device="cuda")
        return xd

    out = []
    for label, a, w, block_n in (
            (f"frozen w1 {ROWS}x{d}x{ff}", x, w1, 1),
            (f"frozen w1 {ROWS}x{d}x{ff} block_n 2", x, w1, 2),
            (f"frozen w1 decode {TILE}({REAL_ROWS})x{d}x{ff}", decode(d), w1,
             1),
            (f"frozen w2 decode {TILE}({REAL_ROWS})x{ff}x{d}", decode(ff), w2,
             1)):
        fw = FrozenWeight.build(w, _median_tau(a, w), tile=TILE,
                                block_n=block_n, backend="cuda",
                                compute_dtype="int8")
        fp = P.plan(a, frozen_weight=fw.for_rows(a.shape[0] // TILE))
        wk = fp.work
        a_q, a_s = Q.quantize_tiles(a, TILE, scales=fp.a_scale)
        b_q, b_s = Q.quantize_tiles(w, TILE, scales=fp.b_scale)
        args = (a_q, b_q, a_s, b_s, wk.step_i, wk.step_j, wk.step_k,
                wk.step_flags, wk.runs)
        want = spamm_mm.spamm_mm_worklist_int8_plain(*args, tile=TILE,
                                                     block_n=block_n)
        out.append((label, args, block_n, want))
    return out


def back_to_back_ms(fn, calls=20, reps=7) -> float:
    for _ in range(3):
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


def use_library(path) -> None:
    """Point the int8 wrapper at a variant's library."""
    real = build.load
    build.load = lambda source: ctypes.CDLL(str(path))
    try:
        spamm_mm._LIB = None
        spamm_mm._lib()
    finally:
        build.load = real


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default=None,
                    help="comma-separated subset (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ablate_int8 needs an NVIDIA GPU")
    f32_numerics()
    table = variants((build.CSRC / "spamm_mm.cu").read_text())
    names = args.variants.split(",") if args.variants else list(table)
    libs = build_variants(names, table)
    shapes = cases()
    res: dict = {}
    for name in names + names[::-1]:
        use_library(libs[name])
        line = {}
        for label, kargs, block_n, want in shapes:
            def fn():
                return spamm_mm.spamm_mm_worklist_int8_cuda(
                    *kargs, tile=TILE, block_n=block_n)
            got = fn()
            torch.cuda.synchronize()
            same = bool(torch.equal(got, want))
            if table[name][1] and not same:
                raise RuntimeError(f"variant {name} differs from the plain "
                                   f"version at {label}")
            ms = back_to_back_ms(fn)
            res.setdefault(name, {}).setdefault(label, []).append(ms)
            line[label] = {"ms": ms, "bit_identical_to_plain": same}
        print(json.dumps({"variant": name, **line}), flush=True)
    spamm_mm._LIB = None
    print(json.dumps({"ablation": res}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
