"""SpAMM GEMMs of the port (paper §3.3, Alg. 2): work-list and dense-grid.

Work-list: twin of `repro.kernels.spamm_mm.spamm_mm_worklist`. C[i, j] is
the f32 sum of A[i, k] @ B[k, j-block] over the steps of the work-list,
driven by the step tables `repro_torch.core.plan.compact_from_triples`
(eager plans) or `FrozenPlan` (frozen plans) build:

  step_i / step_j / step_k / step_flags  (S,) int32 — one entry per step;
      step_j is a super-column id when block_n > 1; STEP_INIT zeroes the
      accumulator, STEP_ACC adds the step's tile product, STEP_FLUSH writes
      the accumulator to the output block; steps without bits do nothing;
  runs  (P + 1,) int32 — run boundaries: steps [runs[p], runs[p+1]) share
      one output block (i, j). The TPU kernel carries its accumulator along
      one sequential grid; on a GPU each run is one thread block, so the
      caller hands over where runs start. Both planners know it on the host
      (the work-list's pair offsets; the frozen plan's segment starts), so
      no launch needs a host sync.

Output blocks never flushed stay exactly zero. Entry points as in
`getnorm`: `spamm_mm_worklist_plain`, `spamm_mm_worklist_cuda` (the kernels
of `csrc/spamm_mm.cu`: two f32 operands on the CUDA cores, or two bf16
operands on the tensor cores; f32 out, any tile `sub_tile` takes) and
`spamm_mm_worklist` (dispatch on the operands' device). The f32 kernel adds
every element's products with one FMA each, in table order and ascending
inner index. The bf16 kernel's tensor-core MMA adds a 16-deep slice of
products in its own order: it agrees with the f32 kernel on the
bf16-rounded operands, and with its plain version, within 1e-4 of the
output's largest magnitude (the products are exact in f32 in all three;
only the order of the additions differs), and is deterministic.

Tensor-core families (`mma_family`): bf16 and int8 at every tile from
WGMMA_LOWEST_TILE (48) run the Hopper kernels of `csrc/spamm_wgmma.cu`
("wgmma": `wgmma` fed by TMA copies into an mbarrier ring, one producer
warp, one consumer warpgroup per block, a block owning one 64-row band of
a tile's rows, T % 64 live ones in the last band of a tile that is not a
multiple of 64, and a column piece, the last one possibly reaching past
the tile; a step walked as ⌈T/64⌉ K-chunks, the last T % 64 deep:
`wgmma_geometry`); at tiles 16 and 32, where those measured slower, the
`mma.sync` kernels of `csrc/spamm_mm.cu`. f32 always runs on the
CUDA cores: "fma", or "fma_decode" when a call at a multiple of 64 says
that at most DECODE_MAX_ROWS rows of A hold data (`rows=`, the rest zero,
a decode step's padding): the kernel of `csrc/spamm_decode.cu` computes
those rows only, streaming the weight through a TMA ring (`decode_route`,
`decode_geometry`), bit for bit the 64-row kernel on them. A CUDA call
launches its family's kernel or raises.

Int8 work-list: twin of `repro.kernels.spamm_mm.spamm_mm_worklist_int8`.
Per-tile int8 codes a_q (M, K) and b_q (K, N), f32 scales a_scale (gm, gk)
and b_scale (gk, gn) per FINE tile (block_n > 1 reads one scale per column
group), the same step tables: an ACC step adds (f32(int32 tile dot) ·
a_scale[i, k]) · b_scale[k, fine j]. Entry points
`spamm_mm_worklist_int8_plain`, `_cuda` (the tensor-core kernels: `wgmma`
or `mma.sync` s8 × s8 → s32, by `mma_family`) and
`spamm_mm_worklist_int8`; the kernel ≡ the plain version bit for bit (the
integer tile dot is exact in both).

Dense-grid: twin of `repro.kernels.spamm_mm.spamm_mm`, driven by the
compacted valid-k lists of `repro_torch.kernels.ref.spamm_compact_ref`:

  kidx  (gm, gnb, gk) int32 — the first nvalid[i, j] entries are output
      block (i, j)'s valid k's in ascending order (gnb = N // (tile·block_n));
  nvalid (gm, gnb) int32 — how many.

It also takes a batch of per-slice products in one call: a (B, M, K),
b (B, K, N), kidx (B, gm, gnb, gk), nvalid (B, gm, gnb). Every output block
is written, with zeros where nvalid is 0. Entry points `spamm_mm_plain`,
`spamm_mm_cuda` and `spamm_mm`. Both GEMMs add a tile product in the same
order (kernel: one shared device function; plain: the same rank-1 updates),
so with the same valid k's dense-grid ≡ work-list bit for bit, whatever
the column slices of either.

Tiles: the kernels take every multiple of 16 from 16 to MAX_CUDA_TILE
(512), as the reference's kernels take any tile that divides the operands;
`sub_tile` is the rule, and the wrappers raise on any other tile. The tile
products are built for a sub-tile of 16, 32 or 64, the largest that
divides the tile T. At T = 16, 32, 64 a thread block owns a whole output
block. Above, the step tables stay the planner's T-level ones (so every
table, flag and int8 scale is the reference's) and each T × T·block_n
output block is cut into R = T/sub row bands and R column sub-blocks, one
thread block each; every ACC step is walked as R K-chunks of the sub-tile,
in ascending order, so each f32 output is still summed over ascending q
from 0 to T − 1 (the plain version's order) and the int8 kernel carries
its exact s32 dot over the chunks and scales it once a step (≡ the plain
version bit for bit).

Launch geometry (every work-list kernel and dense-grid): one thread block per
run (dense-grid: per output block) × R row bands × block_n column groups ×
R column sub-blocks × `slices` column slices. `column_slices` is the rule:
a decode step's few runs are split into up to 4 slices of at least 16
columns until the launch has two blocks per SM; each slice walks the same
steps over its columns, so the per-element order does not change. The
`wgmma` kernels: ⌈T/64⌉ row bands × block_n column groups × ⌈T/width⌉
column pieces (`wgmma_geometry`; at a multiple of 64 the pieces of the
widest power of two dividing T up to WGMMA_MAX_WIDTH, or the wrapper's
`max_width`, cut into slices). Every operand pointer the kernels read
with 16-byte copies or TMA must be 16-byte aligned (the wrappers raise
otherwise). `last_geometry` holds the geometry of the latest launch, its
family under "mma".

Launch counts: `launches` (f32 work-list, 64-row kernels),
`decode_launches` (f32 work-list, the decode kernel), `bf16_launches` (bf16
work-list, any family), `int8_launches` (int8 work-list, any family),
`dense_launches` (dense-grid); of these, the `mma.sync` kernels' own
launches in `bf16_mma_sync_launches` and `int8_mma_sync_launches`.
"""
from __future__ import annotations

import ctypes
import types

import torch

from repro_torch.kernels import build

# step_flags bits — the planner encodes them, the kernel decodes them
STEP_INIT, STEP_ACC, STEP_FLUSH = 1, 2, 4

# the largest tile the kernels take (the kernel's kMaxTile)
MAX_CUDA_TILE = 512
# the sub-tiles the tile products are built for (TILE of the templates)
SUB_TILES = (64, 32, 16)
# column slices per output block: a slice is at least 16 columns wide
MAX_COLUMN_SLICES = 4
# gridDim.y of a launch: block_n × column sub-blocks × column slices
MAX_GRID_Y = 65535
# ring depth of the pipelined kernels, as `spamm_mm_stages` reports it
PIPELINE_STAGES = {torch.float32: 2, torch.bfloat16: 3, torch.int8: 4}
# threads of an f32 block that holds at least this many float4 outputs (the
# kernel's kThreadsF32)
F32_THREADS = 128
# the wgmma kernels (csrc/spamm_wgmma.cu, kStagesWgmma, kThreads,
# kMaxWidthBf16 / kMaxWidthInt8, kMaxWidthOddBf16 / kMaxWidthOddInt8,
# kMinTile, SPAMM_BF16_AT / SPAMM_INT8_AT): ring depth, threads of a block
# (one consumer warpgroup and one producer warp), the widest column range
# of a block at a tile that is a multiple of 64 and at the other tiles,
# the rows of a band (wgmma's M, the depth of a K-chunk), the smallest
# tile they take (at 16 and 32 the `mma.sync` kernels of csrc/spamm_mm.cu
# serve bf16 and int8, faster there), and the widths they are built for
WGMMA_STAGES = 4
WGMMA_THREADS = 160
WGMMA_MAX_WIDTH = types.MappingProxyType({torch.bfloat16: 256,
                                          torch.int8: 64})
WGMMA_MAX_WIDTH_ODD = types.MappingProxyType({torch.bfloat16: 128,
                                              torch.int8: 96})
WGMMA_BAND = 64
WGMMA_LOWEST_TILE = 48
WGMMA_WIDTHS = types.MappingProxyType({
    torch.bfloat16: (16, 32, 64, 128, 256), torch.int8: (16, 32, 48, 64, 96)})
# the f32 decode kernel (csrc/spamm_decode.cu: the RB of its template, its
# widths, kStagesDecode, kMaxRows, kMaxConsumers): live rows rounded up to
# a row block, the columns of a block, ring depth, the route's cut, and the
# most consumer threads of a block
DECODE_ROW_BLOCKS = (1, 2, 4, 8, 16)
DECODE_WIDTHS = (16, 32)
DECODE_STAGES = 4
DECODE_MAX_ROWS = 16
DECODE_MAX_CONSUMERS = 128

launches = 0
decode_launches = 0
bf16_launches = 0
int8_launches = 0
dense_launches = 0
bf16_mma_sync_launches = 0
int8_mma_sync_launches = 0
last_geometry: dict = {}

_LIB = None
_WGMMA_LIB = None
_DECODE_LIB = None
_SMS: dict = {}


def _lib():
    global _LIB
    if _LIB is None:
        lib = build.load("spamm_mm.cu")
        for fn in (lib.spamm_mm_worklist_f32, lib.spamm_mm_worklist_bf16):
            fn.argtypes = ([ctypes.c_void_p] * 7
                           + [ctypes.c_int, ctypes.c_void_p]
                           + [ctypes.c_int] * 6 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        fn = lib.spamm_mm_worklist_int8
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_void_p]
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fn = lib.spamm_mm_dense_f32
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.spamm_mm_stages.argtypes = [ctypes.c_int]
        lib.spamm_mm_stages.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _wgmma_lib():
    global _WGMMA_LIB
    if _WGMMA_LIB is None:
        lib = build.load("spamm_wgmma.cu")
        lib.spamm_wgmma_worklist_bf16.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p]
            + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.spamm_wgmma_worklist_int8.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_void_p]
            + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        for fn in (lib.spamm_wgmma_worklist_bf16,
                   lib.spamm_wgmma_worklist_int8):
            fn.restype = ctypes.c_int
        _WGMMA_LIB = lib
    return _WGMMA_LIB


def _decode_lib():
    global _DECODE_LIB
    if _DECODE_LIB is None:
        lib = build.load("spamm_decode.cu")
        fn = lib.spamm_decode_worklist_f32
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p]
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _DECODE_LIB = lib
    return _DECODE_LIB


def sub_tile(tile: int) -> int:
    """The sub-tile the kernels walk a tile with: 64, 32 or 16, the largest
    that divides it. Raises ValueError for a tile the kernels do not take:
    one that is not a multiple of 16 from 16 to MAX_CUDA_TILE."""
    if not (16 <= tile <= MAX_CUDA_TILE and tile % 16 == 0):
        raise ValueError(f"tile {tile}: the kernels take a multiple of 16 "
                         f"from 16 to {MAX_CUDA_TILE}")
    return next(s for s in SUB_TILES if tile % s == 0)


def column_slices(num_blocks: int, tile: int, num_sms: int) -> int:
    """Column slices per `tile`-wide column block for a launch of
    `num_blocks` blocks (runs × block_n column groups; dense-grid: batch
    slices × output blocks × column groups; times the row bands and column
    sub-blocks of a chunked tile) on `num_sms` SMs: doubled from 1 while
    the launch has fewer than two blocks per SM, up to tile/16 (a slice
    keeps at least 16 columns) and MAX_COLUMN_SLICES. Slices only split
    launches below 2·num_sms blocks, so block_n × slices stays far inside
    gridDim.y."""
    most = min(MAX_COLUMN_SLICES, tile // 16)
    slices = 1
    while slices < most and num_blocks * slices < 2 * num_sms:
        slices *= 2
    return slices


def decode_route(rows: int | None, tile: int, dtype: torch.dtype) -> bool:
    """Whether a work-list call runs the f32 decode kernel: f32 operands, a
    tile that is a multiple of 64 (one the kernels take) and 1 ..
    DECODE_MAX_ROWS live rows. `rows` None means every row of A."""
    return (dtype == torch.float32 and rows is not None
            and 1 <= rows <= DECODE_MAX_ROWS and sub_tile(tile) == 64)


def mma_family(tile: int, dtype: torch.dtype,
               rows: int | None = None) -> str:
    """The instructions of the kernel that serves `tile` at operand type
    `dtype`: "wgmma" (csrc/spamm_wgmma.cu) for bf16 and int8 at every tile
    from WGMMA_LOWEST_TILE, "mma.sync" (csrc/spamm_mm.cu) at tiles 16 and
    32; for f32 the
    CUDA cores: "fma_decode" (csrc/spamm_decode.cu) where `decode_route`
    takes `rows`, else "fma" (csrc/spamm_mm.cu). Raises ValueError for a
    tile the kernels do not take."""
    sub_tile(tile)
    if dtype == torch.float32:
        return "fma_decode" if decode_route(rows, tile, dtype) else "fma"
    return "mma.sync" if tile < WGMMA_LOWEST_TILE else "wgmma"


def decode_geometry(num_blocks: int, tile: int, rows: int,
                    num_sms: int) -> dict:
    """The launch of the f32 decode kernel over `num_blocks` (run, column
    group) pairs at `tile` for `rows` live rows: RB = the smallest row
    block ≥ rows; each tile-wide group cut into tile/width column pieces,
    width 32 when that gives a block an SM, else 16; a block's RB·width
    outputs go to min(RB·width, DECODE_MAX_CONSUMERS) consumer threads (at
    least a warp), each owning `columns_per_thread` adjacent columns of
    one row, beside one producer warp, over a DECODE_STAGES ring of
    (64·width + RB·64)-float stages."""
    rb = next(r for r in DECODE_ROW_BLOCKS if r >= rows)
    width = (DECODE_WIDTHS[1]
             if num_blocks * (tile // DECODE_WIDTHS[1]) >= num_sms
             else DECODE_WIDTHS[0])
    pieces = tile // width
    lanes = min(rb * width, DECODE_MAX_CONSUMERS)
    return {"mma": "fma_decode", "blocks": num_blocks * pieces,
            "column_slices": 1, "width": width,
            "threads": max(32, lanes) + 32,
            "columns_per_thread": rb * width // lanes,
            "stages": DECODE_STAGES, "sub_tile": WGMMA_BAND,
            "row_bands": 1, "column_sub_blocks": pieces, "row_block": rb,
            "rows": rows,
            "ring_bytes": DECODE_STAGES * (WGMMA_BAND * width + rb
                                           * WGMMA_BAND) * 4 + 128}


def launch_geometry(num_blocks: int, tile: int, dtype: torch.dtype,
                    num_sms: int, max_width: int | None = None,
                    rows: int | None = None) -> dict:
    """The launch of a work-list (f32, bf16 or int8) or dense-grid kernel
    over `num_blocks` (output block, column group) pairs at `tile`: its
    instruction family (`mma_family`), sub-tile (`sub_tile`), the R =
    tile/sub_tile row bands and column sub-blocks of each output block (1
    at tiles 16, 32, 64), the column slices of a sub-tile-wide block
    (`column_slices` over the num_blocks·R² blocks), a block's width,
    thread blocks, threads per block, ring stages and the block's dynamic
    shared memory. f32: width/4 threads along a row, each owning one float4
    of columns in as many rows as keep 128 threads (64 at sub-tile 16);
    bf16 and int8 on `mma.sync`: one warp per 16 rows of the sub-tile; on
    `wgmma`: `wgmma_geometry` (`max_width` goes there); on "fma_decode"
    (`rows` live rows): `decode_geometry`."""
    family = mma_family(tile, dtype, rows)
    if family == "fma_decode":
        return decode_geometry(num_blocks, tile, rows, num_sms)
    if family == "wgmma":
        return wgmma_geometry(num_blocks, tile, dtype, num_sms, max_width)
    sub = sub_tile(tile)
    r = tile // sub
    slices = column_slices(num_blocks * r * r, sub, num_sms)
    width = sub // slices
    threads = (min(sub, F32_THREADS // (width // 4)) * (width // 4)
               if dtype == torch.float32 else 2 * sub)
    return {"mma": family, "blocks": num_blocks * r * r * slices,
            "column_slices": slices, "width": width, "threads": threads,
            "stages": PIPELINE_STAGES[dtype], "sub_tile": sub,
            "row_bands": r, "column_sub_blocks": r,
            "ring_bytes": ring_bytes(sub, width, dtype)}


def wgmma_geometry(num_blocks: int, tile: int, dtype: torch.dtype,
                   num_sms: int, max_width: int | None = None) -> dict:
    """The launch of a `wgmma` kernel (bf16 or int8, a tile T from
    WGMMA_LOWEST_TILE) over `num_blocks` (output block, column group)
    pairs: each pair's T × T block is ⌈T/64⌉ row bands (`row_bands`: T //
    64 full ones and, where T is not a multiple of 64, a last one of
    `last_band_rows` = T % 64 rows) × ⌈T/width⌉ column pieces
    (`column_sub_blocks` × `column_slices`, the last one
    `last_piece_columns` wide: its other columns are loaded and never
    stored); a step is ⌈T/64⌉ K-chunks, 64 deep but the last, a ring stage
    each. The width, at most `max_width`: at a multiple of 64, base = the
    widest power of two dividing T up to WGMMA_MAX_WIDTH[dtype], cut into
    the slices `column_slices` gives on the launch (at T = 64 the decode
    split of 4 × 16 columns), `column_sub_blocks` = T/base; at the other
    tiles the one of WGMMA_WIDTHS[dtype] up to WGMMA_MAX_WIDTH_ODD[dtype]
    that loads the fewest columns a band and step, ⌈T/w⌉·(64 + w) (A's
    64-row chunk once a piece, B's w columns), fewer loaded columns on a
    tie, narrower while the launch has fewer than two blocks an SM (a
    decode step's few runs). A block runs WGMMA_THREADS threads over a
    WGMMA_STAGES ring (`wgmma_ring_bytes`)."""
    bands = -(-tile // WGMMA_BAND)
    if tile % WGMMA_BAND == 0:
        widest = max_width or WGMMA_MAX_WIDTH[dtype]
        base = max(w for w in (16, 32, 64, 128, 256)
                   if w <= widest and tile % w == 0)
        slices = column_slices(num_blocks * bands * (tile // base), base,
                               num_sms)
        width = base // slices
    else:
        widest = max_width or WGMMA_MAX_WIDTH_ODD[dtype]
        fits = [w for w in WGMMA_WIDTHS[dtype] if w <= widest]

        def pieces(w):
            return -(-tile // w)

        width = min(fits, key=lambda w: (pieces(w) * (WGMMA_BAND + w),
                                         pieces(w) * w))
        for w in sorted((w for w in fits if w < width), reverse=True):
            if num_blocks * bands * pieces(width) >= 2 * num_sms:
                break
            width = w
        slices = 1
    p = -(-tile // width)
    return {"mma": "wgmma", "blocks": num_blocks * bands * p,
            "column_slices": slices, "width": width,
            "threads": WGMMA_THREADS, "stages": WGMMA_STAGES,
            "sub_tile": WGMMA_BAND, "row_bands": bands,
            "last_band_rows": tile % WGMMA_BAND,
            "column_sub_blocks": p // slices,
            "last_piece_columns": tile - (p - 1) * width,
            "ring_bytes": wgmma_ring_bytes(tile, width, dtype)}


def stage_layout(tile: int, width: int, dtype: torch.dtype) -> dict:
    """A `wgmma` kernel's ring stage at `tile` and `width` (`stage_layout`
    of csrc/spamm_wgmma.cu): one K-chunk of a step, `a_row` the bytes of an
    A box row (64 columns), `b_rows` B's k rows (the chunk's, up to 64) at
    `b_at` (past A's box, from a 1024-byte boundary), `stage` its bytes
    (B's end, or the 64 rows a product reads from A's box, whichever is
    further, rounded up to 1024)."""
    def round1024(x):
        return -(-x // 1024) * 1024

    elem = 2 if dtype == torch.bfloat16 else 1
    a_row = WGMMA_BAND * elem
    b_rows = min(tile, WGMMA_BAND)
    b_at = round1024(b_rows * a_row)
    stage = round1024(max(b_at + b_rows * width * elem, WGMMA_BAND * a_row))
    return {"a_row": a_row, "b_rows": b_rows, "b_at": b_at, "stage": stage}


def wgmma_ring_bytes(tile: int, width: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of a `wgmma` kernel's block (`dynamic_bytes`
    of csrc/spamm_wgmma.cu): WGMMA_STAGES stages of `stage_layout`; int8's
    two transposed-B buffers of 64·width bytes; at a tile that is not a
    multiple of 64 the zero region the products past a chunk's depth read
    (bf16 32·width bytes and at least 2048, int8 2048); 1024 bytes to align
    the ring."""
    if dtype == torch.bfloat16:
        extra, zero = 0, max(32 * width, 2048)
    else:
        extra, zero = 2 * WGMMA_BAND * width, 2048
    return (WGMMA_STAGES * stage_layout(tile, width, dtype)["stage"] + extra
            + (zero if tile % WGMMA_BAND else 0) + 1024)


def ring_bytes(sub: int, width: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of a block of the kernels of csrc/spamm_mm.cu
    at sub-tile `sub` and width `width`, by their stage formulas; it does
    not grow with the tile. f32 at every sub-tile, bf16 and int8 at 16 and
    32 (`STAGE_BYTES` of F32Product, Bf16Product, Int8Product): the ring
    (the `wgmma` kernels': `wgmma_ring_bytes`)."""
    if dtype == torch.float32:
        stage = (sub * (sub + 4) + sub * width) * 4
    elif dtype == torch.bfloat16:
        stage = (sub * (sub + 8) + sub * (width + 8)) * 2
    else:
        lda = sub if (sub // 16) % 2 else sub + 16
        stage = sub * lda + sub * width + 16
    return PIPELINE_STAGES[dtype] * stage


def _num_sms(dev) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _geometry(num_blocks, tile, block_n, dtype, dev, max_width=None,
              rows=None) -> dict:
    """`launch_geometry` on `dev`'s SMs; raises when the launch's gridDim.y
    (block_n × column sub-blocks × column slices) exceeds MAX_GRID_Y."""
    geo = launch_geometry(num_blocks, tile, dtype, _num_sms(dev), max_width,
                          rows)
    y = block_n * geo["column_sub_blocks"] * geo["column_slices"]
    if y > MAX_GRID_Y:
        raise ValueError(f"block_n {block_n} at tile {tile} needs gridDim.y "
                         f"{y} > {MAX_GRID_Y}")
    return geo


def _check_aligned(named):
    """The kernels copy tiles with 16-byte cp.async or TMA: every operand
    must start on a 16-byte boundary."""
    for name, t in named:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for the "
                             f"kernel's 16-byte copies (offset "
                             f"{t.data_ptr() % 16})")


def _check_shapes(a, b, tables, runs, tile, block_n):
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"bad operands {tuple(a.shape)} @ {tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    if m % tile or k % tile or n % (tile * block_n):
        raise ValueError(f"{tuple(a.shape)} @ {tuple(b.shape)} not divisible "
                         f"by tile {tile} (block_n {block_n})")
    s = tables[0].shape
    if any(t.dim() != 1 or t.shape != s for t in tables):
        raise ValueError("step tables must be 1-D and equally long")
    if runs.dim() != 1 or runs.shape[0] < 1:
        raise ValueError("runs must be a 1-D table of run boundaries")
    return m, k, n


def _accumulate(acc, at, bt, tile):
    """acc += at @ bt as `tile` rank-1 updates in ascending inner index,
    each a multiply then an add in f32: every element is summed in the same
    order whatever the batch of blocks (the plain versions of both GEMMs)."""
    for kk in range(tile):
        acc = acc + at[:, :, kk, None] * bt[:, None, kk, :]
    return acc


def _check_rows(rows, m):
    """`rows`: None (every row of A) or the live rows, 0 .. m."""
    if rows is not None and not 0 <= rows <= m:
        raise ValueError(f"rows {rows} outside 0 .. {m}, the rows of a")


def spamm_mm_worklist_plain(a, b, step_i, step_j, step_k, step_flags, runs,
                            *, tile: int = 64, block_n: int = 1,
                            out_dtype=torch.float32,
                            rows: int | None = None) -> torch.Tensor:
    """The plain version: every run advances one step per iteration, all
    runs together, honouring each flag bit exactly as the kernel does. An
    ACC step adds its tile product as `tile` rank-1 updates in ascending
    inner index (multiply, then add, in f32), so every output element is
    accumulated in the same order whatever the batch of runs — the plain
    path is deterministic element by element, as frozen ≡ eager needs.
    `rows` (the live rows; A's others zero): output rows from `rows` on
    are zero, as the decode kernel leaves them."""
    m, k, n = _check_shapes(a, b, (step_i, step_j, step_k, step_flags), runs,
                            tile, block_n)
    _check_rows(rows, m)
    dev = a.device
    gm, gk, tn = m // tile, k // tile, tile * block_n
    out = torch.zeros(m, n, dtype=torch.float32, device=dev)
    runs = runs.to(dev, torch.long)
    starts, lengths = runs[:-1], runs[1:] - runs[:-1]
    if starts.numel() == 0:
        return out.to(out_dtype)
    si, sj, sk, sf = (t.to(dev, torch.long)
                      for t in (step_i, step_j, step_k, step_flags))
    a4 = a.float().reshape(gm, tile, gk, tile)
    b4 = b.float().reshape(gk, tile, n // tn, tn)
    o4 = out.view(gm, tile, n // tn, tn)
    acc = torch.zeros(starts.numel(), tile, tn, dtype=torch.float32,
                      device=dev)
    last = si.numel() - 1
    for q in range(int(lengths.max())):
        s = (starts + q).clamp(max=last)
        f = torch.where(lengths > q, sf[s], torch.zeros_like(sf[s]))
        acc[(f & STEP_INIT) != 0] = 0.0
        live = torch.nonzero((f & STEP_ACC) != 0).squeeze(1)
        if live.numel():
            st = s[live]
            at = a4[si[st], :, sk[st], :]            # (L, t, t)
            bt = b4[sk[st], :, sj[st], :]            # (L, t, t·block_n)
            acc[live] = _accumulate(acc[live], at, bt, tile)
        fl = torch.nonzero((f & STEP_FLUSH) != 0).squeeze(1)
        if fl.numel():
            st = s[fl]
            o4[si[st], :, sj[st], :] = acc[fl]
    if rows is not None:
        out[rows:] = 0.0
    return out.to(out_dtype)


def _check_cuda_worklist(named, tables, runs, tile, block_n, out_dtype):
    """Device, layout and type checks shared by the work-list kernels;
    `named` lists (name, tensor) of the operands."""
    dev = named[0][1].device
    if dev.type != "cuda":
        raise ValueError(f"the work-list kernels need CUDA tensors, got {dev}")
    for name, t in (*named, ("step_i", tables[0]), ("step_j", tables[1]),
                    ("step_k", tables[2]), ("step_flags", tables[3]),
                    ("runs", runs)):
        if t.device != dev:
            raise ValueError(f"{name} lies on {t.device}, a on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if any(t.dtype != torch.int32 for t in (*tables, runs)):
        raise TypeError("step tables and runs must be int32")
    if out_dtype != torch.float32:
        raise TypeError(f"the kernel writes float32, not {out_dtype}")
    sub_tile(tile)
    if not 1 <= block_n <= MAX_GRID_Y:
        raise ValueError(f"block_n {block_n} out of range")
    return dev


def spamm_mm_worklist_cuda(a, b, step_i, step_j, step_k, step_flags, runs,
                           *, tile: int = 64, block_n: int = 1,
                           out_dtype=torch.float32,
                           max_width: int | None = None,
                           rows: int | None = None) -> torch.Tensor:
    """The CUDA kernels, by `mma_family`: f32 on the CUDA cores (the decode
    kernel where `decode_route` takes `rows`, the live rows of A, whose
    other rows the caller zeroed; output rows from `rows` on stay zero),
    bf16 on `wgmma` (tiles from 48) or `mma.sync` (16, 32); the launch of
    `launch_geometry`. Takes two contiguous, 16-byte aligned float32 or
    bfloat16 operands and int32 tables on one CUDA device, a tile
    `sub_tile` takes and a float32 output; raises on anything else (mixed
    operand types too). `max_width` caps a `wgmma` block's columns below
    WGMMA_MAX_WIDTH / WGMMA_MAX_WIDTH_ODD (a width the kernels are built
    for); bf16 takes `rows` and ignores it."""
    global launches, decode_launches, bf16_launches, bf16_mma_sync_launches
    global last_geometry
    tables = (step_i, step_j, step_k, step_flags)
    m, k, n = _check_shapes(a, b, tables, runs, tile, block_n)
    dev = _check_cuda_worklist((("a", a), ("b", b)), tables, runs, tile,
                               block_n, out_dtype)
    if a.dtype != b.dtype or a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"spamm_mm_worklist_cuda takes two float32 or two "
                        f"bfloat16 operands, got {a.dtype} @ {b.dtype}")
    _check_rows(rows, m)
    _check_aligned((("a", a), ("b", b)))
    out = torch.zeros(m, n, dtype=torch.float32, device=dev)
    num_runs = runs.shape[0] - 1
    if num_runs == 0:
        return out
    geo = _geometry(num_runs * block_n, tile, block_n, a.dtype, dev,
                    max_width, rows)
    extra = ()
    if geo["mma"] == "fma_decode":
        fn, split = _decode_lib().spamm_decode_worklist_f32, geo["width"]
        extra = (rows,)
    elif geo["mma"] == "wgmma":
        fn, split = _wgmma_lib().spamm_wgmma_worklist_bf16, geo["width"]
    else:
        lib = _lib()
        fn = (lib.spamm_mm_worklist_f32 if a.dtype == torch.float32
              else lib.spamm_mm_worklist_bf16)
        split = geo["column_slices"]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(a.data_ptr(), b.data_ptr(), step_i.data_ptr(),
                step_j.data_ptr(), step_k.data_ptr(), step_flags.data_ptr(),
                runs.data_ptr(), num_runs, out.data_ptr(), m, k, n, tile,
                block_n, *extra, split, stream)
    if rc != 0:
        raise RuntimeError(
            f"spamm_mm_worklist kernel launch failed: CUDA error {rc}")
    last_geometry = geo
    if geo["mma"] == "fma_decode":
        decode_launches += 1
    elif a.dtype == torch.float32:
        launches += 1
    else:
        bf16_launches += 1
        bf16_mma_sync_launches += geo["mma"] == "mma.sync"
    return out


def spamm_mm_worklist(a, b, step_i, step_j, step_k, step_flags, runs, *,
                      tile: int = 64, block_n: int = 1,
                      out_dtype=torch.float32,
                      rows: int | None = None) -> torch.Tensor:
    """Work-list GEMM: the plain version for CPU operands, the CUDA kernel
    for CUDA operands."""
    fn = (spamm_mm_worklist_plain if a.device.type == "cpu"
          else spamm_mm_worklist_cuda)
    return fn(a, b, step_i, step_j, step_k, step_flags, runs, tile=tile,
              block_n=block_n, out_dtype=out_dtype, rows=rows)


def _check_int8(a_q, b_q, a_scale, b_scale, tables, runs, tile, block_n):
    m, k, n = _check_shapes(a_q, b_q, tables, runs, tile, block_n)
    if a_q.dtype != torch.int8 or b_q.dtype != torch.int8:
        raise TypeError(f"the int8 work-list takes int8 codes, got "
                        f"{a_q.dtype} @ {b_q.dtype}")
    gm, gk, gn = m // tile, k // tile, n // tile
    if tuple(a_scale.shape) != (gm, gk) or tuple(b_scale.shape) != (gk, gn):
        raise ValueError(f"scales {tuple(a_scale.shape)}, "
                         f"{tuple(b_scale.shape)} do not match the fine tile "
                         f"grids ({gm}, {gk}) and ({gk}, {gn})")
    return m, k, n


def spamm_mm_worklist_int8_plain(a_q, b_q, a_scale, b_scale, step_i, step_j,
                                 step_k, step_flags, runs, *, tile: int = 64,
                                 block_n: int = 1, out_dtype=torch.float32,
                                 rows: int | None = None) -> torch.Tensor:
    """The plain int8 version: the runs of `spamm_mm_worklist_plain`, with
    each ACC step's tile dot taken on the codes in f32 — exact, since every
    partial sum is an integer of magnitude ≤ tile·127² < 2²⁴ — then scaled
    and added as the kernel does: acc + (dot · a_scale[i, k]) ·
    b_scale[k, fine j], three f32 roundings in that order. `rows` is taken
    and ignored, as the kernels ignore it."""
    m, k, n = _check_int8(a_q, b_q, a_scale, b_scale,
                          (step_i, step_j, step_k, step_flags), runs, tile,
                          block_n)
    dev = a_q.device
    gm, gk, tn = m // tile, k // tile, tile * block_n
    out = torch.zeros(m, n, dtype=torch.float32, device=dev)
    runs = runs.to(dev, torch.long)
    starts, lengths = runs[:-1], runs[1:] - runs[:-1]
    if starts.numel() == 0:
        return out.to(out_dtype)
    si, sj, sk, sf = (t.to(dev, torch.long)
                      for t in (step_i, step_j, step_k, step_flags))
    a4 = a_q.float().reshape(gm, tile, gk, tile)
    b4 = b_q.float().reshape(gk, tile, n // tn, tn)
    sa = a_scale.float()
    sb = b_scale.float().reshape(gk, n // tn, block_n)
    o4 = out.view(gm, tile, n // tn, tn)
    acc = torch.zeros(starts.numel(), tile, tn, dtype=torch.float32,
                      device=dev)
    last = si.numel() - 1
    for q in range(int(lengths.max())):
        s = (starts + q).clamp(max=last)
        f = torch.where(lengths > q, sf[s], torch.zeros_like(sf[s]))
        acc[(f & STEP_INIT) != 0] = 0.0
        live = torch.nonzero((f & STEP_ACC) != 0).squeeze(1)
        if live.numel():
            st = s[live]
            dot = torch.bmm(a4[si[st], :, sk[st], :],
                            b4[sk[st], :, sj[st], :])    # (L, t, t·block_n)
            a_s = sa[si[st], sk[st]][:, None, None]
            b_s = sb[sk[st], sj[st]].repeat_interleave(tile, dim=1)[:, None]
            acc[live] = acc[live] + (dot * a_s) * b_s
        fl = torch.nonzero((f & STEP_FLUSH) != 0).squeeze(1)
        if fl.numel():
            st = s[fl]
            o4[si[st], :, sj[st], :] = acc[fl]
    return out.to(out_dtype)


def spamm_mm_worklist_int8_cuda(a_q, b_q, a_scale, b_scale, step_i, step_j,
                                step_k, step_flags, runs, *, tile: int = 64,
                                block_n: int = 1, out_dtype=torch.float32,
                                max_width: int | None = None,
                                rows: int | None = None) -> torch.Tensor:
    """The CUDA int8 kernels: exact s32 tile dots on the tensor cores,
    `wgmma` s8 at tiles from 48, `mma.sync` s8 at 16 and 32 (`mma_family`),
    each step's dot scaled once; the launch of
    `launch_geometry`. Takes contiguous, 16-byte aligned int8 codes,
    float32 scales (per T-level tile) and int32 tables on one CUDA device,
    a tile `sub_tile` takes and a float32 output; raises on anything
    else. `max_width` as in `spamm_mm_worklist_cuda`; `rows` is taken and
    ignored."""
    global int8_launches, int8_mma_sync_launches, last_geometry
    tables = (step_i, step_j, step_k, step_flags)
    m, k, n = _check_int8(a_q, b_q, a_scale, b_scale, tables, runs, tile,
                          block_n)
    dev = _check_cuda_worklist((("a_q", a_q), ("b_q", b_q),
                                ("a_scale", a_scale), ("b_scale", b_scale)),
                               tables, runs, tile, block_n, out_dtype)
    if a_scale.dtype != torch.float32 or b_scale.dtype != torch.float32:
        raise TypeError("the scales must be float32")
    _check_aligned((("a_q", a_q), ("b_q", b_q)))
    out = torch.zeros(m, n, dtype=torch.float32, device=dev)
    num_runs = runs.shape[0] - 1
    if num_runs == 0:
        return out
    geo = _geometry(num_runs * block_n, tile, block_n, torch.int8, dev,
                    max_width)
    if geo["mma"] == "wgmma":
        fn, split = _wgmma_lib().spamm_wgmma_worklist_int8, geo["width"]
    else:
        fn, split = _lib().spamm_mm_worklist_int8, geo["column_slices"]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(a_q.data_ptr(), b_q.data_ptr(), a_scale.data_ptr(),
                b_scale.data_ptr(), step_i.data_ptr(), step_j.data_ptr(),
                step_k.data_ptr(), step_flags.data_ptr(), runs.data_ptr(),
                num_runs, out.data_ptr(), m, k, n, tile, block_n, split,
                stream)
    if rc != 0:
        raise RuntimeError(
            f"spamm_mm_worklist_int8 kernel launch failed: CUDA error {rc}")
    last_geometry = geo
    int8_launches += 1
    int8_mma_sync_launches += geo["mma"] == "mma.sync"
    return out


def spamm_mm_worklist_int8(a_q, b_q, a_scale, b_scale, step_i, step_j, step_k,
                           step_flags, runs, *, tile: int = 64,
                           block_n: int = 1, out_dtype=torch.float32,
                           rows: int | None = None) -> torch.Tensor:
    """Int8 work-list GEMM: the plain version for CPU operands, the CUDA
    kernel for CUDA operands."""
    fn = (spamm_mm_worklist_int8_plain if a_q.device.type == "cpu"
          else spamm_mm_worklist_int8_cuda)
    return fn(a_q, b_q, a_scale, b_scale, step_i, step_j, step_k, step_flags,
              runs, tile=tile, block_n=block_n, out_dtype=out_dtype,
              rows=rows)


def _check_dense(a, b, kidx, nvalid, tile, block_n):
    """Shapes of a dense-grid call, 2-D or batched. Returns (batch, m, k,
    n, gm, gnb, gk)."""
    if a.dim() != b.dim() or a.dim() not in (2, 3):
        raise ValueError(f"bad operands {tuple(a.shape)} @ {tuple(b.shape)}")
    batch = a.shape[0] if a.dim() == 3 else 1
    m, k = a.shape[-2:]
    k2, n = b.shape[-2:]
    if k2 != k or (a.dim() == 3 and b.shape[0] != batch):
        raise ValueError(f"bad operands {tuple(a.shape)} @ {tuple(b.shape)}")
    if m % tile or k % tile or n % (tile * block_n):
        raise ValueError(f"{tuple(a.shape)} @ {tuple(b.shape)} not divisible "
                         f"by tile {tile} (block_n {block_n})")
    gm, gk, gnb = m // tile, k // tile, n // (tile * block_n)
    lead = tuple(a.shape[:-2])
    if tuple(kidx.shape) != lead + (gm, gnb, gk):
        raise ValueError(f"kidx {tuple(kidx.shape)} does not match the grid "
                         f"{lead + (gm, gnb, gk)}")
    if tuple(nvalid.shape) != lead + (gm, gnb):
        raise ValueError(f"nvalid {tuple(nvalid.shape)} does not match the "
                         f"grid {lead + (gm, gnb)}")
    return batch, m, k, n, gm, gnb, gk


def spamm_mm_plain(a, b, kidx, nvalid, *, tile: int = 64, block_n: int = 1,
                   out_dtype=torch.float32) -> torch.Tensor:
    """The plain version: every output block advances one valid k per
    iteration, all blocks together, with the rank-1 updates of the
    work-list plain version (so plain dense-grid ≡ plain work-list)."""
    batch, m, k, n, gm, gnb, gk = _check_dense(a, b, kidx, nvalid, tile,
                                               block_n)
    dev = a.device
    tn = tile * block_n
    a5 = a.float().reshape(batch, gm, tile, gk, tile)
    b5 = b.float().reshape(batch, gk, tile, gnb, tn)
    nv = nvalid.to(dev, torch.long).reshape(-1)          # (batch·gm·gnb,)
    kl = kidx.to(dev, torch.long).reshape(-1, gk)
    blk = torch.arange(nv.numel(), device=dev)
    bb, ii, jj = blk // (gm * gnb), (blk // gnb) % gm, blk % gnb
    acc = torch.zeros(nv.numel(), tile, tn, dtype=torch.float32, device=dev)
    for t in range(int(nv.max()) if nv.numel() else 0):
        live = torch.nonzero(nv > t).squeeze(1)
        kk = kl[live, t]
        at = a5[bb[live], ii[live], :, kk, :]            # (L, t, t)
        bt = b5[bb[live], kk, :, jj[live], :]            # (L, t, t·block_n)
        acc[live] = _accumulate(acc[live], at, bt, tile)
    out = acc.reshape(batch, gm, gnb, tile, tn).permute(0, 1, 3, 2, 4)
    return out.reshape(a.shape[:-2] + (m, n)).to(out_dtype)


def spamm_mm_cuda(a, b, kidx, nvalid, *, tile: int = 64, block_n: int = 1,
                  out_dtype=torch.float32) -> torch.Tensor:
    """The CUDA dense-grid kernel: one thread block per (slice, i, j,
    column group) × `column_slices` (× R² above tile 64). Takes
    contiguous, 16-byte aligned float32 operands and int32 kidx/nvalid on
    one CUDA device, a tile `sub_tile` takes and a float32 output; raises
    on anything else."""
    global dense_launches, last_geometry
    batch, m, k, n, gm, gnb, gk = _check_dense(a, b, kidx, nvalid, tile,
                                               block_n)
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"spamm_mm_cuda needs CUDA tensors, got {dev}")
    for name, t in (("a", a), ("b", b), ("kidx", kidx), ("nvalid", nvalid)):
        if t.device != dev:
            raise ValueError(f"{name} lies on {t.device}, a on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"spamm_mm_cuda takes float32 operands, got "
                        f"{a.dtype} @ {b.dtype}")
    if kidx.dtype != torch.int32 or nvalid.dtype != torch.int32:
        raise TypeError("kidx and nvalid must be int32")
    if out_dtype != torch.float32:
        raise TypeError(f"the kernel writes float32, not {out_dtype}")
    sub_tile(tile)
    if not 1 <= block_n <= MAX_GRID_Y or batch > 65535:
        raise ValueError(f"block_n {block_n} or batch {batch} out of range")
    _check_aligned((("a", a), ("b", b)))
    out = torch.empty(a.shape[:-2] + (m, n), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    geo = _geometry(batch * gm * gnb * block_n, tile, block_n, torch.float32,
                    dev)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.spamm_mm_dense_f32(
            a.data_ptr(), b.data_ptr(), kidx.data_ptr(), nvalid.data_ptr(),
            out.data_ptr(), batch, m, k, n, tile, block_n,
            geo["column_slices"], stream)
    if rc != 0:
        raise RuntimeError(f"spamm_mm kernel launch failed: CUDA error {rc}")
    last_geometry = geo
    dense_launches += 1
    return out


def spamm_mm(a, b, kidx, nvalid, *, tile: int = 64, block_n: int = 1,
             out_dtype=torch.float32) -> torch.Tensor:
    """Dense-grid GEMM: the plain version for CPU operands, the CUDA kernel
    for CUDA operands."""
    fn = spamm_mm_plain if a.device.type == "cpu" else spamm_mm_cuda
    return fn(a, b, kidx, nvalid, tile=tile, block_n=block_n,
              out_dtype=out_dtype)
