// SpAMM work-list GEMMs on Hopper's warpgroup tensor-core instructions
// (`wgmma`), fed by TMA copies into a ring of shared-memory stages completed
// on mbarriers: the bf16 and int8 work-list kernels at every tile from 48 up
// to 512 (a multiple of 16). Tiles 16 and 32 keep spamm_mm.cu's `mma.sync`
// kernels, which measured faster there: `wgmma` takes 64 rows, and a 16- or
// 32-row tile's product fills a fraction of them.
//
// spamm_worklist_bf16_wgmma_kernel replaces the Pallas TPU kernel
// src/repro/kernels/spamm_mm.py::spamm_mm_worklist
// (_spamm_mm_worklist_kernel) at bf16 operands; spamm_worklist_int8_wgmma_
// kernel replaces src/repro/kernels/spamm_mm.py::spamm_mm_worklist_int8
// (_spamm_mm_worklist_int8_kernel). Both walk the planner's own T-level
// step tables: INIT zeroes the register accumulator, ACC adds the step's
// tile product, FLUSH writes the accumulator out, steps without flag bits
// do nothing, and tiles no run visits stay exactly 0 (the caller zeroes the
// output).
//
// What bounds them on an H100. At the serving shapes the operand bytes: a
// 64-tile step reads 2·64² operand elements for 2·64³ operations, 64 flop
// per bf16 byte against the card's ≈ 295, so the tile traffic from L2
// (every (i, j) block reads its own A and B tiles) holds a block long
// before the tensor cores do; in HBM bytes, the B tiles the ACC steps touch
// (the activation stays in L2). So the design keeps tile bytes in flight
// per SM, spends no thread on a copy, and orders the blocks so that the B
// tiles come from HBM once. bf16 at the 64-tile prefill runs near the L2
// rate; int8 moves half the bytes but is held by each chunk's serial chain
// in the consumers (B transpose, the products' latency, the step's fold;
// launch/ablate_wgmma.py takes it apart).
//
// Design.
// 1. Block schedule (as spamm_mm.cu): a block owns one run (steps
//    [runs[p], runs[p+1]) of one output block (i, j)), one 64-row band of
//    it (gridDim.x: run × ⌈T/64⌉ bands; the last band of a tile that is
//    not a multiple of 64 holds its T % 64 live rows) and W columns of one
//    of its block_n column groups (gridDim.y: group × ⌈T/W⌉ column pieces;
//    a last piece reaching past the group is loaded and multiplied whole
//    and stored only inside the group). The host picks W
//    (kernels/spamm_mm.py::wgmma_geometry): at a multiple of 64 the widest
//    power of two dividing T, bf16 up to kMaxWidthBf16 = 256 (one A chunk
//    feeds 256 output columns), int8 up to kMaxWidthInt8 = 64 (at 128 its
//    s32 dot beside the f32 accumulator leaves one block an SM, and tiles
//    128–512 measured slower: launch/ablate_wgmma.py, `wide`), cut into
//    the column slices that fill 132 SMs at decode shapes
//    (kernels/spamm_mm.py::column_slices); at the other tiles the width
//    that loads the fewest columns a band and step, up to kMaxWidthOdd
//    (bf16 128, int8 96). The block builds the same shared-memory step
//    list (worklist.cuh), in kListCap chunks. Blocks launch column by
//    column (the M/T row tiles of one output column together: a
//    pair-major table's runs in raster order), so the B tiles of the
//    blocks in flight are read from HBM once and from L2 by the other
//    rows. No split-K: a cross-block sum would reorder the int8 kernel's
//    f32 folds and make bf16 non-deterministic.
// 2. Copies. Warp 4 is the producer: one lane walks the list and, for each
//    of an ACC entry's ⌈T/64⌉ K-chunks kc (64 deep, the last T % 64 where
//    that is not 0), waits for a free stage and issues
//    `cp.async.bulk.tensor.2d` loads of the band's live rows of the A chunk
//    (a box 64 columns wide at (row i·T + band·64, column k·T + kc·64): a
//    short last chunk's box reads columns past it that no product takes)
//    and of the chunk's k rows × W columns of B (at (row k·T + kc·64,
//    column j·T·block_n + group·T + piece·W)) into it, completed on the
//    stage's full barrier. kStagesWgmma stages, each sized to the tile
//    (`stage_layout`); each has a full and an empty barrier. The tensor
//    maps (a full band's and a last band's A rows, a 64-deep and a last
//    chunk's B rows) are encoded on the host (cuTensorMapEncodeTiled
//    through cudaGetDriverEntryPoint, so the library needs no -lcuda), kept
//    in a small table keyed by everything the encode reads (address, type,
//    shape, box, swizzle: a reused address of the same shape gives the
//    same map), and passed as __grid_constant__ parameters; the dynamic
//    shared-memory attribute is set once per kernel and device. So an
//    eager call pays no encode after its first. A map holds the operand's
//    address: a CUDA graph captures it by value, which is right because a
//    captured step's buffers are static (serving/graphs.py::StepGraph). TMA
//    needs a 16-byte aligned base and 16-byte multiple row strides; the
//    wrapper checks and raises.
// 3. Products. Warps 0-3 are one consumer warpgroup: per chunk they wait
//    on the full barrier, issue `wgmma.mma_async` m64nW on the landed
//    stage (accumulators in registers), wait for the group and free the
//    stage on its empty barrier (a group held in flight over the next
//    chunk's wait and transpose measured slower at both types). A chunk
//    issues a fixed number of products, the ones past its depth on a
//    region of zeros (they add nothing; a tile that is a multiple of 64
//    has none and allocates no such region): no branch stands between the
//    products, which ptxas would otherwise wait on one by one (C7520). The
//    rows of a 64-row product past a last band's live rows read whatever
//    the stage holds there; their outputs are never stored.
//    bf16: m64nWk16, 4 per chunk, f32 accumulators (W/2 registers a
//    thread). A lands K-major with TMA's 128-byte swizzle; B lands (k, n)
//    row-major (MN-major) in boxes of up to 64 columns with the widest
//    swizzle their rows take (128-byte at 64 columns, 64-byte at W = 32,
//    32-byte at W = 16), and the descriptor's transpose bit takes it as it
//    is. The tensor core adds a k16 slice in its own order: the kernel
//    agrees with its plain version within 1e-4 of the output's largest
//    magnitude (the products of bf16 values are exact in f32), is
//    deterministic, frozen ≡ eager, and at T > 64 a multiple of 64 ≡ the
//    64-tile kernel on the refined tables bit for bit (same k16 slices in
//    the same order per element).
//    int8: m64nWk32 s8 × s8 → s32, 2 per chunk. `wgmma` takes 8-bit B only
//    K-major, so the consumers transpose each landed (k, n) chunk once in
//    shared memory (4 × 4 byte blocks, `prmt`) into a K-major buffer laid
//    out as TMA's 64-byte swizzle would lay it (two buffers, alternating by
//    chunk; the k rows from a short chunk's depth to the next multiple of
//    32 written as zero codes, an exact k32 product): B lands with its
//    rows' swizzle (none at 16, 48 and 96 columns) and the lanes' stores
//    are rotated, so neither side of the transpose serialises on
//    shared-memory banks; A lands K-major with the 64-byte swizzle. Each
//    ACC step's s32 accumulators start at zero, carry across its chunks,
//    then fold into the f32 accumulator once per element with
//    __fadd_rn(acc, __fmul_rn(__fmul_rn(f32(dot), a_scale[i, k]),
//    b_scale[k, fine j])), the step's scales loaded into the list beside
//    its entry: the plain version's order, so the kernel is bit for bit
//    spamm_mm_worklist_int8_plain at every tile, block_n and width (the
//    integer dot is exact in any order; |dot| ≤ 512·127² < 2²⁴).
// 4. FLUSH stores the accumulator fragments of the live rows and the
//    piece's columns inside the group straight to the output.
// One walker serves every tile, built twice a width: for the multiples of
// 64 (every band full, every chunk 64 deep, known at compile time) and for
// the other tiles.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tma.cuh"
#include "worklist.cuh"

namespace {

using spamm::fill_worklist;
using spamm::kAcc;
using spamm::kFlush;
using spamm::kInit;
using spamm::kListCap;
using spamm::smem_addr;

// rows of a block's band, depth of a K-chunk, `wgmma`'s M
constexpr int kBand = 64;
// one consumer warpgroup and one producer warp
constexpr int kConsumers = 128;
constexpr int kThreads = kConsumers + 32;
// ring depth
constexpr int kStagesWgmma = 4;
// the widest column range of a block at a tile that is a multiple of 64
// (the largest `wgmma` N used) and at the other tiles
constexpr int kMaxWidthBf16 = 256;
constexpr int kMaxWidthInt8 = 64;
constexpr int kMaxWidthOddBf16 = 128;
constexpr int kMaxWidthOddInt8 = 96;
// the tiles the kernels take (kernels/spamm_mm.py::WGMMA_LOWEST_TILE,
// MAX_CUDA_TILE): below 48 the `mma.sync` kernels of spamm_mm.cu
constexpr int kMinTile = 48;
constexpr int kMaxTile = 512;

// ---------------------------------------------------------------------------
// PTX: wgmma (the barriers and TMA copies are tma.cuh's)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accumulator registers across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle mode (1: 128-byte, 2: 64-byte, 3:
// 32-byte)
__device__ __forceinline__ uint64_t smem_desc(const void* p, int lbo_bytes,
                                              int sbo_bytes, int mode) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(mode) << 62);
}

#include "wgmma_ops.cuh"

// ---------------------------------------------------------------------------
// The two products: what lands in a stage, and what the consumers do with
// it.
// ---------------------------------------------------------------------------

// a byte count rounded up to the 1024-byte boundary the swizzled layouts
// need
__host__ __device__ constexpr int round1024(int bytes) {
  return (bytes + 1023) / 1024 * 1024;
}

// The stage layout of a launch at tile T, operand bytes `elem` (2 bf16, 1
// int8) and width w: the bytes of an A box row (64 columns); B's k rows (a
// chunk's, up to 64) and their offset past A's box; the bytes of a stage
// (B's end, or the 64 rows a product reads from A's box, whichever is
// further, from a 1024-byte boundary). At a multiple of 64: the 64 × 64 A
// chunk, then the 64 × w B chunk.
struct StageLayout {
  int a_row, b_rows, b_at, stage;
};

__host__ __device__ constexpr StageLayout stage_layout(int tile, int elem,
                                                       int w) {
  StageLayout l{};
  l.a_row = kBand * elem;
  l.b_rows = tile < kBand ? tile : kBand;
  l.b_at = round1024(l.b_rows * l.a_row);
  const int reach = kBand * l.a_row;
  const int end = l.b_at + l.b_rows * w * elem;
  l.stage = round1024(end > reach ? end : reach);
  return l;
}

// bf16: A K-major (128-byte swizzle, 128-byte rows); B MN-major, in boxes
// of BOX = min(W, 64) columns, rows of 2·BOX bytes, swizzled by their
// width, a box column b_rows k rows apart
template <int W>
struct Bf16Wgmma {
  static constexpr int ELEM = 2;
  static constexpr int BOX = W < 64 ? W : 64;
  static constexpr int ROW = 2 * BOX;  // bytes of a B row (one k)
  static constexpr int B_MODE = BOX == 64 ? 1 : BOX == 32 ? 2 : 3;
  static constexpr int EXTRA = 0;  // no transposed-B buffers
  // the zero region a missing k16 slice's A (64 rows of 32 bytes) and B
  // (16 k rows of W columns) descriptors both start at
  static constexpr int ZERO = 32 * W > 2048 ? 32 * W : 2048;
  static constexpr int REGS = W / 2;
  // blocks an SM the registers are budgeted for
  static constexpr int MIN_BLOCKS = W <= 64 ? 2 : 1;

  struct Acc {
    float c[REGS];
  };

  __device__ static void zero(Acc& acc) {
#pragma unroll
    for (int r = 0; r < REGS; ++r) acc.c[r] = 0.f;
  }

  __device__ static void begin(Acc&) {}

  // bytes a chunk of depth d lands for `live` A rows
  __device__ static __forceinline__ int bytes(const StageLayout& l, int d,
                                              int live) {
    return live * l.a_row + d * W * 2;
  }

  // the chunk's loads: A's box at (ax, ay) of map a, W columns of B at
  // (bx, by) of map b, box by box
  __device__ static __forceinline__ void load(
      unsigned char* st, const StageLayout& l, const CUtensorMap* ma,
      const CUtensorMap* mb, int ax, int ay, int bx, int by, uint64_t* full) {
    tma_load_2d(st, ma, ax, ay, full);
#pragma unroll
    for (int q = 0; q < W / BOX; ++q)
      tma_load_2d(st + l.b_at + q * l.b_rows * ROW, mb, bx + q * BOX, by,
                  full);
  }

  // nothing to do between a chunk's landing and its products
  __device__ static __forceinline__ void prepare(const unsigned char*,
                                                 unsigned char*,
                                                 const StageLayout&, int) {}

  // issues acc += the chunk's k16 slices (four products, the ones past its
  // depth d on the zero region: A and B zeros) as one group
  __device__ static __forceinline__ void issue(
      const unsigned char* st, const unsigned char*,
      const unsigned char* zero, Acc& acc, const StageLayout& l, int d) {
    const uint64_t a0 = smem_desc(st, 16, 8 * 128, 1);
    const uint64_t b0 = smem_desc(st + l.b_at, l.b_rows * ROW, 8 * ROW,
                                  B_MODE);
    const uint64_t za = smem_desc(zero, 16, 8 * 32, 3);
    const uint64_t zb = smem_desc(zero, 16 * ROW, 8 * ROW, B_MODE);
    uint64_t da[4], db[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // k16 slice q: A's bytes 32q, B's rows 16q
      const bool real = 16 * q < d;
      da[q] = real ? a0 + ((32 * q) >> 4) : za;
      db[q] = real ? b0 + ((16 * q * ROW) >> 4) : zb;
    }
    wgmma_fence();
    fence_regs(acc.c);
#pragma unroll
    for (int q = 0; q < 4; ++q) wgmma_bf16<W>(acc.c, da[q], db[q]);
    wgmma_commit();
  }

  // after the group's wait: the accumulators are the products' again
  __device__ static void settle(Acc& acc) { fence_regs(acc.c); }

  __device__ static void finish(Acc&, float2) {}
};

// generic-proxy stores to shared memory made visible to the async proxy
// (the tensor cores' operand reads)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the consumers' stores (int8's transposed B) made visible to the tensor
// cores; then the warpgroup meets
__device__ __forceinline__ void publish_to_tensor_cores() {
  fence_proxy_async();
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// TMA's swizzle of a box with rows of S bytes (S = 32, 64 or 128; 0 for
// none): bits 7 .. 6 + log2(S/16) of a byte offset from a 1024-byte
// boundary XOR-ed into bits 4 .. (the 16-byte chunk of a row)
template <int S>
__device__ __forceinline__ int swizzled(int off) {
  constexpr int mask = S == 128 ? 7 : S == 64 ? 3 : S == 32 ? 1 : 0;
  return off ^ (((off >> 7) & mask) << 4);
}

// int8: A K-major (64-byte swizzle, 64-byte rows); B lands (k, n) row-major
// with the swizzle of its W-byte rows (none at 16, 48 and 96 columns, which
// no swizzle takes) and is transposed into a K-major buffer of W rows of
// 64 bytes in the 64-byte swizzle's layout (`bt_offset`)
template <int W>
struct Int8Wgmma {
  static constexpr int ELEM = 1;
  // the landed B rows' swizzle: their width, at 32, 64 and 128 bytes
  static constexpr int B_SWIZZLE = W == 32 || W == 64 || W == 128 ? W : 0;
  // two transposed-B buffers, alternating by chunk
  static constexpr int EXTRA = 2 * W * kBand;
  static constexpr int ZERO = 2048;  // the zero region: 64 rows of 32 bytes
  static constexpr int REGS = W / 2;
  static constexpr int MIN_BLOCKS = 3;
  static constexpr int CW = W / 4;           // 4-byte words of a landed row
  static constexpr int CL = CW % 8 ? 4 : 8;  // a warp's words
  static constexpr int ITEMS = (kBand / 4) * CW;  // 4 × 4 blocks of a chunk

  struct Acc {
    float c[REGS];  // the f32 accumulator
    int d[REGS];    // the s32 dot of the current ACC step
  };

  __device__ static void zero(Acc& acc) {
#pragma unroll
    for (int r = 0; r < REGS; ++r) acc.c[r] = 0.f;
  }

  // a step's s32 dot starts afresh and runs over all of its chunks
  __device__ static void begin(Acc& acc) {
#pragma unroll
    for (int r = 0; r < REGS; ++r) acc.d[r] = 0;
  }

  __device__ static __forceinline__ int bytes(const StageLayout& l, int d,
                                              int live) {
    return live * l.a_row + d * W;
  }

  __device__ static __forceinline__ void load(
      unsigned char* st, const StageLayout& l, const CUtensorMap* ma,
      const CUtensorMap* mb, int ax, int ay, int bx, int by, uint64_t* full) {
    tma_load_2d(st, ma, ax, ay, full);
    tma_load_2d(st + l.b_at, mb, bx, by, full);
  }

  // byte offset of (n, k) in a transposed-B buffer: row n of 64 bytes, its
  // 16-byte chunk k/16 XOR bits 1-2 of n (TMA's 64-byte swizzle)
  __device__ static __forceinline__ int bt_offset(int n, int k) {
    return n * 64 + ((((k >> 4) ^ (n >> 1)) & 3) << 4) + (k & 15);
  }

  // one 4 × 4 byte block of the landed (k, n) B tile at `bs`: k rows
  // 4·kb .. 4·kb + 3 of the 4-column word c, read as 4 words (each rotated
  // by `sel`, one prmt) and stored into `bt` as the 4 columns' k-words,
  // column 4·c + (s + rot) % 4 from o[s]
  __device__ static __forceinline__ void transpose_block(
      const unsigned char* bs, unsigned char* bt, int c, int kb, int rot,
      unsigned sel) {
    unsigned r[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      r[q] = __byte_perm(*reinterpret_cast<const unsigned*>(
                             bs + swizzled<B_SWIZZLE>((4 * kb + q) * W +
                                                      4 * c)),
                         0u, sel);
    const unsigned t0 = __byte_perm(r[0], r[1], 0x5140);
    const unsigned t1 = __byte_perm(r[0], r[1], 0x7362);
    const unsigned t2 = __byte_perm(r[2], r[3], 0x5140);
    const unsigned t3 = __byte_perm(r[2], r[3], 0x7362);
    const unsigned o[4] = {__byte_perm(t0, t2, 0x5410),
                           __byte_perm(t0, t2, 0x7632),
                           __byte_perm(t1, t3, 0x5410),
                           __byte_perm(t1, t3, 0x7632)};
#pragma unroll
    for (int s = 0; s < 4; ++s)
      *reinterpret_cast<unsigned*>(
          bt + bt_offset(4 * c + ((s + rot) & 3), 4 * kb)) = o[s];
  }

  // a chunk's transpose: its d landed (k, n) B rows into `bt`. A work item
  // is a 4 × 4 byte block: k rows 4·kb .. 4·kb + 3 of the 4-column word c,
  // read as 4 words and stored as the 4 columns' k-words. A warp's 32 items
  // are CL words c × 32/CL rows kb, and lane pair c_lo/2 stores its
  // columns rotated by c_lo/2 (its input bytes rotated first, one prmt
  // each), so the stores of a warp spread over the banks; the reads of the
  // swizzled landed rows too. Then the zero codes of a depth that is not a
  // multiple of 32; then the stores are made visible to the tensor cores
  // and the warpgroup meets.
  __device__ static __forceinline__ void prepare(
      const unsigned char* st, unsigned char* bt, const StageLayout& l,
      int d) {
    const unsigned char* bs = st + l.b_at;
    const int rot = (threadIdx.x % CL) >> 1;
    const unsigned sel = (rot & 3) | (((rot + 1) & 3) << 4) |
                         (((rot + 2) & 3) << 8) | (((rot + 3) & 3) << 12);
    const int items = (d / 4) * CW;
#pragma unroll
    for (int it = 0; it < (ITEMS + kConsumers - 1) / kConsumers; ++it) {
      const int e = threadIdx.x + it * kConsumers;
      // a full chunk of ITEMS a multiple of the consumers needs no test
      if ((ITEMS % kConsumers || d < kBand) && e >= items) break;
      int t = e / CL;
      const int kb_lo = t % 4;
      t /= 4;
      const int c = e % CL + CL * (t % (CW / CL));
      const int kb = kb_lo + 4 * (t / (CW / CL));
      transpose_block(bs, bt, c, kb, rot, sel);
    }
    if (d % 32)
      for (int n = threadIdx.x; n < W; n += kConsumers)
        *reinterpret_cast<uint4*>(bt + bt_offset(n, d)) =
            make_uint4(0u, 0u, 0u, 0u);
    // the generic-proxy stores, visible to the tensor cores' reads
    publish_to_tensor_cores();
  }

  // issues acc.d += the chunk's two k32 slices as one group, the second on
  // the zero region (A zeros) when the chunk is at most 32 deep
  __device__ static __forceinline__ void issue(
      const unsigned char* st, const unsigned char* bt,
      const unsigned char* zero, Acc& acc, const StageLayout&, int d) {
    const uint64_t da = smem_desc(st, 16, 8 * 64, 2);
    const uint64_t db = smem_desc(bt, 16, 8 * 64, 2);
    const uint64_t da1 = d > 32 ? da + 2 : smem_desc(zero, 16, 8 * 32, 3);
    wgmma_fence();
    fence_regs(acc.d);
    wgmma_s8<W>(acc.d, da, db);
    wgmma_s8<W>(acc.d, da1, db + 2);
    wgmma_commit();
  }

  __device__ static void settle(Acc& acc) { fence_regs(acc.d); }

  // after the step's last chunk: fold its dot into the f32 accumulator in
  // the plain version's order, with the step's scales
  __device__ static void finish(Acc& acc, float2 s) {
#pragma unroll
    for (int r = 0; r < REGS; ++r) {
      const float dot = __int2float_rn(acc.d[r]);
      acc.c[r] = __fadd_rn(acc.c[r], __fmul_rn(__fmul_rn(dot, s.x), s.y));
    }
  }
};

// Stores the consumer warpgroup's m64nW f32 fragments at `og` (row stride
// ldo): register r of a thread is row 16·warp + lane/4 (+8 for r % 4 ≥ 2),
// column 8·(r/4) + 2·(lane % 4) (+1 for odd r); the rows below `live` and
// the columns below `valid` only (a last band, a last piece)
template <int REGS>
__device__ __forceinline__ void store_fragments(float* og, size_t ldo,
                                                const float (&c)[REGS],
                                                int live, int valid) {
  const int warp = threadIdx.x / 32;
  const int ln = threadIdx.x % 32;
  if (16 * warp >= live) return;
  const size_t row = 16 * warp + ln / 4;
#pragma unroll
  for (int j = 0; j < REGS / 4; ++j) {
    if (8 * j >= valid) break;
    const int col = 8 * j + 2 * (ln % 4);
    *reinterpret_cast<float2*>(og + row * ldo + col) =
        make_float2(c[4 * j], c[4 * j + 1]);
    *reinterpret_cast<float2*>(og + (row + 8) * ldo + col) =
        make_float2(c[4 * j + 2], c[4 * j + 3]);
  }
}

// int8: loads each kept ACC step's two scales into `scl` beside its list
// entry (one load per thread per round of fill_worklist)
struct ScaleLoader {
  float2* scl;
  const float* a_scale;  // (gm, gk) at the tile T
  const float* b_scale;  // (gk, gn) at T, per fine tile
  int gk, gn, block_n, group;
  __device__ void operator()(int pos, int k, int i, int j, int f) const {
    if (f & kAcc)
      scl[pos] = make_float2(
          a_scale[static_cast<size_t>(i) * gk + k],
          b_scale[static_cast<size_t>(k) * gn +
                  static_cast<size_t>(j) * block_n + group]);
  }
};

// One block per (run × band, column group × column piece): the run's
// flagged steps, list chunk by list chunk; warp 4 loads, warps 0-3
// compute. ma / mb: the maps of a full band's A rows and a 64-deep chunk's
// B rows; ma_tail / mb_tail: a last band of tile % 64 rows and a last
// chunk of tile % 64 k rows (the same maps at a multiple of 64). ODD: the
// tile is not a multiple of 64 (else every band is full, every chunk 64
// deep and every piece inside the group, known at compile time: the
// walker at a multiple of 64 measured up to 18 % slower with them found
// at run time).
template <class P, int W, bool ODD>
__device__ void worklist_wgmma_block(
    const CUtensorMap* ma, const CUtensorMap* ma_tail, const CUtensorMap* mb,
    const CUtensorMap* mb_tail, const int* step_i, const int* step_j,
    const int* step_k, const int* step_flags, const int* runs, float* out,
    int n, int block_n, int tile, int raster, const float* a_scale,
    const float* b_scale, int gk, int gn) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ int4 list[kListCap];
  __shared__ float2 scl[kListCap];
  __shared__ int wsum[kThreads / 32];
  __shared__ __align__(8) uint64_t full[kStagesWgmma];
  __shared__ __align__(8) uint64_t empty[kStagesWgmma];
  const StageLayout lay =
      stage_layout(ODD ? tile : kBand, P::ELEM, W);
  // the ring (then int8's transposed-B buffers and the zero region) from a
  // 1024-byte boundary, which the swizzled layouts need
  unsigned char* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) &
                                    1023);
  unsigned char* bt = ring + kStagesWgmma * lay.stage;
  unsigned char* zero = bt + P::EXTRA;

  const int bands = ODD ? (tile + kBand - 1) / kBand : tile / kBand;
  // launch order q → run: the `raster` row tiles of one column first (run
  // p = i · runs/raster + j in a pair-major table of raster rows), so the
  // blocks in flight share their B tiles in L2; any permutation is right
  const int nruns = gridDim.x / bands;
  const int q = blockIdx.x / bands;
  const int run = nruns % raster ? q
                                 : q % raster * (nruns / raster) + q / raster;
  const int row0 = (blockIdx.x % bands) * kBand;
  const int live = ODD ? min(kBand, tile - row0) : kBand;
  const CUtensorMap* a_map = live == kBand ? ma : ma_tail;
  const int pieces = ODD ? (tile + W - 1) / W : tile / W;
  const int group = blockIdx.y / pieces;
  const int piece = blockIdx.y % pieces;
  const int col0 = group * tile + piece * W;
  const int valid = ODD ? min(W, tile - piece * W) : W;
  const int jstride = block_n * tile;
  const int warp = threadIdx.x / 32;
  const bool lane0 = threadIdx.x % 32 == 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStagesWgmma; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (ODD) {  // short chunks read the zero region
    for (int i = threadIdx.x; i < P::ZERO / 16; i += kThreads)
      reinterpret_cast<uint4*>(zero)[i] = make_uint4(0u, 0u, 0u, 0u);
    fence_proxy_async();
  }
  __syncthreads();

  const ScaleLoader scales{scl,   a_scale, b_scale, gk,
                           gn,    block_n, group};
  typename P::Acc acc;
  P::zero(acc);
  int stage = 0;
  unsigned phase = warp == 4 ? 1u : 0u;  // the producer's first waits pass
  int tb = 0;                            // int8: transposed-B buffer
  int base = runs[run];
  const int s1 = runs[run + 1];
  while (base < s1) {
    __syncthreads();  // both roles are done with the previous list chunk
    const int cnt =
        a_scale ? fill_worklist<kThreads>(list, wsum, step_i, step_j, step_k,
                                          step_flags, base, s1, scales)
                : fill_worklist<kThreads>(list, wsum, step_i, step_j, step_k,
                                          step_flags, base, s1);
    if (warp == 4) {
      if (lane0) {
        for (int e = 0; e < cnt; ++e) {
          const int4 en = list[e];
          if (!(en.w & kAcc)) continue;
          for (int kc = 0; kc < bands; ++kc) {
            const int d = ODD ? min(kBand, tile - kc * kBand) : kBand;
            mbar_wait(&empty[stage], phase);
            mbar_expect_tx(&full[stage], P::bytes(lay, d, live));
            P::load(ring + stage * lay.stage, lay, a_map,
                    d == kBand ? mb : mb_tail, en.x * tile + kc * kBand,
                    en.y * tile + row0, en.z * jstride + col0,
                    en.x * tile + kc * kBand, &full[stage]);
            if (++stage == kStagesWgmma) {
              stage = 0;
              phase ^= 1u;
            }
          }
        }
      }
    } else {
      for (int e = 0; e < cnt; ++e) {
        const int4 en = list[e];
        if (en.w & kInit) P::zero(acc);
        if (en.w & kAcc) {
          P::begin(acc);
          for (int kc = 0; kc < bands; ++kc) {
            const int d = ODD ? min(kBand, tile - kc * kBand) : kBand;
            unsigned char* st = ring + stage * lay.stage;
            mbar_wait(&full[stage], phase);
            P::prepare(st, bt + tb * (W * kBand), lay, d);
            P::issue(st, bt + tb * (W * kBand), zero, acc, lay, d);
            wgmma_wait_all();
            P::settle(acc);
            if (lane0) mbar_arrive(&empty[stage]);
            if (++stage == kStagesWgmma) {
              stage = 0;
              phase ^= 1u;
            }
            tb ^= 1;
          }
          P::finish(acc, scl[e]);
        }
        if (en.w & kFlush)
          store_fragments<P::REGS>(
              out + (static_cast<size_t>(en.y) * tile + row0) * n +
                  static_cast<size_t>(en.z) * jstride + col0,
              n, acc.c, live, valid);
      }
    }
  }
}

template <int W, bool ODD>
__global__ void __launch_bounds__(kThreads, Bf16Wgmma<W>::MIN_BLOCKS)
spamm_worklist_bf16_wgmma_kernel(
    const __grid_constant__ CUtensorMap ma,
    const __grid_constant__ CUtensorMap ma_tail,
    const __grid_constant__ CUtensorMap mb,
    const __grid_constant__ CUtensorMap mb_tail,
    const int* __restrict__ step_i, const int* __restrict__ step_j,
    const int* __restrict__ step_k, const int* __restrict__ step_flags,
    const int* __restrict__ runs, float* __restrict__ out, int n, int block_n,
    int tile, int raster) {
  worklist_wgmma_block<Bf16Wgmma<W>, W, ODD>(
      &ma, &ma_tail, &mb, &mb_tail, step_i, step_j, step_k, step_flags, runs,
      out, n, block_n, tile, raster, nullptr, nullptr, 0, 0);
}

template <int W, bool ODD>
__global__ void __launch_bounds__(kThreads, Int8Wgmma<W>::MIN_BLOCKS)
spamm_worklist_int8_wgmma_kernel(
    const __grid_constant__ CUtensorMap ma,
    const __grid_constant__ CUtensorMap ma_tail,
    const __grid_constant__ CUtensorMap mb,
    const __grid_constant__ CUtensorMap mb_tail,
    const float* __restrict__ a_scale, const float* __restrict__ b_scale,
    const int* __restrict__ step_i, const int* __restrict__ step_j,
    const int* __restrict__ step_k, const int* __restrict__ step_flags,
    const int* __restrict__ runs, float* __restrict__ out, int k, int n,
    int block_n, int tile, int raster) {
  worklist_wgmma_block<Int8Wgmma<W>, W, ODD>(
      &ma, &ma_tail, &mb, &mb_tail, step_i, step_j, step_k, step_flags, runs,
      out, n, block_n, tile, raster, a_scale, b_scale, k / tile, n / tile);
}

// ---------------------------------------------------------------------------
// Host side: launches (tensor maps: tma.cuh)
// ---------------------------------------------------------------------------

// TMA's swizzle of a box whose rows are `bytes` bytes (none but at 32, 64
// and 128)
CUtensorMapSwizzle swizzle_of(int bytes) {
  return bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
         : bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
         : bytes == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                       : CU_TENSOR_MAP_SWIZZLE_NONE;
}

// the maps of operand `p` ((rows, cols), `elem` bytes an element) in boxes
// of `box_cols` columns: of 64 rows (a full band of A, a 64-deep chunk of
// B) and of tile % 64 rows (a last band, a last chunk); one of them where
// the tile is a multiple of 64 or below it
bool maps_of(CUtensorMap* full, CUtensorMap* tail, const void* p,
             CUtensorMapDataType type, int elem, int rows, int cols,
             int tile, int box_cols) {
  const auto sw = swizzle_of(box_cols * elem);
  if (tile > kBand || tile % kBand == 0)
    if (!cached_map(full, p, type, elem, rows, cols, kBand, box_cols, sw))
      return false;
  if (tile % kBand == 0) {
    *tail = *full;
    return true;
  }
  if (!cached_map(tail, p, type, elem, rows, cols, tile % kBand, box_cols,
                  sw))
    return false;
  if (tile < kBand) *full = *tail;
  return true;
}

// dynamic shared memory of a launch at `tile`: the ring of its stages
// (`stage_layout`), int8's transposed-B buffers, the zero region (a tile
// that is not a multiple of 64) and room to align the ring to 1024 bytes
template <class P, int W>
int dynamic_bytes(int tile) {
  return kStagesWgmma * stage_layout(tile, P::ELEM, W).stage + P::EXTRA +
         (tile % kBand ? P::ZERO : 0) + 1024;
}

// one launch shape a kernel (tma.cuh's launch_upto keeps a bit a device
// for each)
template <class P, bool ODD>
struct Shape {};

// The launch of kernel `full` (a tile that is a multiple of 64) or `odd`
// of product P (tma.cuh's launch_upto: the dynamic shared-memory attribute
// set on a device's first launch, to the largest the kernel takes),
// gridDim run × band, column group × column piece
template <class P, int W, class K, class... Args>
int launch(K full, K odd, int num_runs, int tile, int block_n,
           cudaStream_t stream, Args... args) {
  const dim3 grid(num_runs * ((tile + kBand - 1) / kBand),
                  block_n * ((tile + W - 1) / W));
  const int smem = dynamic_bytes<P, W>(tile);
  if (tile % kBand)
    return launch_upto<Shape<P, true>>(odd, grid, kThreads, smem,
                                       dynamic_bytes<P, W>(2 * kBand + 16),
                                       stream, args...);
  return launch_upto<Shape<P, false>>(full, grid, kThreads, smem,
                                      dynamic_bytes<P, W>(2 * kBand), stream,
                                      args...);
}

template <int W>
int bf16_at(const void* a, const void* b, const int* si, const int* sj,
            const int* sk, const int* sf, const int* runs, int num_runs,
            float* out, int m, int k, int n, int tile, int block_n,
            cudaStream_t st) {
  using P = Bf16Wgmma<W>;
  CUtensorMap ma, ma_tail, mb, mb_tail;
  if (!maps_of(&ma, &ma_tail, a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, m, k,
               tile, kBand) ||
      !maps_of(&mb, &mb_tail, b, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, k, n,
               tile, P::BOX))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<P, W>(spamm_worklist_bf16_wgmma_kernel<W, false>,
                      spamm_worklist_bf16_wgmma_kernel<W, true>, num_runs,
                      tile, block_n, st, ma, ma_tail, mb, mb_tail, si, sj,
                      sk, sf, runs, out, n, block_n, tile, m / tile);
}

template <int W>
int int8_at(const void* a, const void* b, const float* sa, const float* sb,
            const int* si, const int* sj, const int* sk, const int* sf,
            const int* runs, int num_runs, float* out, int m, int k, int n,
            int tile, int block_n, cudaStream_t st) {
  using P = Int8Wgmma<W>;
  CUtensorMap ma, ma_tail, mb, mb_tail;
  if (!maps_of(&ma, &ma_tail, a, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, m, k,
               tile, kBand) ||
      !maps_of(&mb, &mb_tail, b, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, k, n,
               tile, W))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<P, W>(spamm_worklist_int8_wgmma_kernel<W, false>,
                      spamm_worklist_int8_wgmma_kernel<W, true>, num_runs,
                      tile, block_n, st, ma, ma_tail, mb, mb_tail, sa, sb,
                      si, sj, sk, sf,
                      runs, out, k, n, block_n, tile, m / tile);
}

// what the kernels take: a multiple of 16 from kMinTile up to kMaxTile,
// and a width up to the dtype's widest at that tile (a multiple of 64, or
// not)
bool takes(int tile, int width, int widest, int widest_odd) {
  return tile % 16 == 0 && tile >= kMinTile && tile <= kMaxTile &&
         width >= 16 && width <= (tile % kBand ? widest_odd : widest);
}

}  // namespace

// a: (m, k), b: (k, n) row-major bf16, 16-byte aligned; step tables (S,)
// int32; runs (num_runs + 1,) int32 run boundaries into the step tables;
// out: (m, n) float32, zero-initialised; tile a multiple of 16 from 48 up
// to 512; width: the columns of a block, one of 16, 32, 64, 128, 256 (up
// to 128 at a tile that is not a multiple of 64; a group's last column
// piece may reach past the tile). Else returns cudaErrorInvalidValue
// without launching. Returns cudaGetLastError().
extern "C" int spamm_wgmma_worklist_bf16(const void* a, const void* b,
                                         const int* step_i,
                                         const int* step_j,
                                         const int* step_k,
                                         const int* step_flags,
                                         const int* runs, int num_runs,
                                         float* out, int m, int k, int n,
                                         int tile, int block_n, int width,
                                         void* stream) {
  if (!takes(tile, width, kMaxWidthBf16, kMaxWidthOddBf16))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
#define SPAMM_BF16_AT(W)                                                    \
  if (width == W)                                                          \
    return bf16_at<W>(a, b, step_i, step_j, step_k, step_flags, runs,      \
                      num_runs, out, m, k, n, tile, block_n, st);
  SPAMM_BF16_AT(16)
  SPAMM_BF16_AT(32)
  SPAMM_BF16_AT(64)
  SPAMM_BF16_AT(128)
  SPAMM_BF16_AT(256)
#undef SPAMM_BF16_AT
  return static_cast<int>(cudaErrorInvalidValue);
}

// a: (m, k), b: (k, n) row-major int8 codes, 16-byte aligned; a_scale:
// (m/tile, k/tile), b_scale: (k/tile, n/tile) float32 per FINE tile; step
// tables, runs, out and tile as spamm_wgmma_worklist_bf16; width one of
// 16, 32, 48, 64, 96 (up to 64 at a multiple of 64; else returns
// cudaErrorInvalidValue without launching). Returns cudaGetLastError().
extern "C" int spamm_wgmma_worklist_int8(const void* a, const void* b,
                                         const float* a_scale,
                                         const float* b_scale,
                                         const int* step_i,
                                         const int* step_j,
                                         const int* step_k,
                                         const int* step_flags,
                                         const int* runs, int num_runs,
                                         float* out, int m, int k, int n,
                                         int tile, int block_n, int width,
                                         void* stream) {
  if (!takes(tile, width, kMaxWidthInt8, kMaxWidthOddInt8))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
#define SPAMM_INT8_AT(W)                                                    \
  if (width == W)                                                          \
    return int8_at<W>(a, b, a_scale, b_scale, step_i, step_j, step_k,      \
                      step_flags, runs, num_runs, out, m, k, n, tile,      \
                      block_n, st);
  SPAMM_INT8_AT(16)
  SPAMM_INT8_AT(32)
  SPAMM_INT8_AT(48)
  SPAMM_INT8_AT(64)
  SPAMM_INT8_AT(96)
#undef SPAMM_INT8_AT
  return static_cast<int>(cudaErrorInvalidValue);
}
