// SpAMM work-list GEMMs on Hopper's warpgroup tensor-core instructions
// (`wgmma`), fed by TMA copies into a ring of shared-memory stages completed
// on mbarriers: the bf16 and int8 work-list kernels at every tile that is a
// multiple of 64 (64, 128, …, 512). Tiles walked with a sub-tile of 16 or
// 32 keep spamm_mm.cu's `mma.sync` kernels: `wgmma` takes 64 rows.
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
//    it (gridDim.x: run × T/64 bands) and W columns of one of its block_n
//    column groups (gridDim.y: group × T/W column pieces). W is the
//    launch's width: at T = 64 it is 64 / slices, the column slices that
//    fill 132 SMs at decode shapes (kernels/spamm_mm.py::column_slices); at
//    T > 64, bf16 takes up to kMaxWidthBf16 = 256, so one A chunk feeds 256
//    output columns; int8 up to kMaxWidthInt8 = 64: at 128 its s32 dot
//    beside the f32 accumulator leaves one block an SM, and tiles 128–512
//    measured slower (launch/ablate_wgmma.py, `wide`). The block builds
//    the same shared-memory step
//    list (worklist.cuh), in kListCap chunks. Blocks launch column by
//    column (the M/T row tiles of one output column together: a pair-major
//    table's runs in raster order), so the B tiles of the blocks in flight
//    are read from HBM once and from L2 by the other rows. No split-K: a
//    cross-block sum would reorder the int8 kernel's f32 folds and make
//    bf16 non-deterministic.
// 2. Copies. Warp 4 is the producer: one lane walks the list and, for each
//    of an ACC entry's T/64 K-chunks kc, waits for a free stage and issues
//    `cp.async.bulk.tensor.2d` loads of the 64 × 64 A chunk at (row i·T +
//    band·64, column k·T + kc·64) and of the 64 × W B chunk at (row k·T +
//    kc·64, column j·T·block_n + group·T + piece·W) into it, completed on
//    the stage's full barrier. kStagesWgmma stages; each has a full and an
//    empty barrier. The tensor maps are encoded on the host
//    (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, so the
//    library needs no -lcuda), kept in a small table keyed by everything
//    the encode reads (address, type, shape, box, swizzle: a reused
//    address of the same shape gives the same map), and passed as
//    __grid_constant__ parameters; the dynamic shared-memory attribute is
//    set once per kernel and device. So an eager call pays no encode after
//    its first. A map holds the operand's address: a CUDA graph captures
//    it by value, which is right because a captured step's buffers are
//    static (serving/graphs.py::StepGraph). TMA needs a 16-byte aligned
//    base and 16-byte multiple row strides; the wrapper checks and raises.
// 3. Products. Warps 0-3 are one consumer warpgroup: per chunk they wait
//    on the full barrier, issue `wgmma.mma_async` m64nW on the landed
//    stage (accumulators in registers), wait for the group and free the
//    stage on its empty barrier (a group held in flight over the next
//    chunk's wait and transpose measured slower at both types).
//    bf16: m64nWk16, 4 per chunk, f32 accumulators (W/2 registers a
//    thread). A lands K-major with TMA's 128-byte swizzle; B lands (k, n)
//    row-major (MN-major) with the widest swizzle its rows take (128-byte
//    in boxes of 64 columns, 64-byte at W = 32, 32-byte at W = 16), and the
//    descriptor's transpose bit takes it as it is. The tensor core adds a
//    k16 slice in its own order: the kernel agrees with its plain version
//    within 1e-4 of the output's largest magnitude (the products of bf16
//    values are exact in f32), is deterministic, frozen ≡ eager, and at
//    T > 64 ≡ the 64-tile kernel on the refined tables bit for bit (same
//    k16 slices in the same order per element).
//    int8: m64nWk32 s8 × s8 → s32, 2 per chunk. `wgmma` takes 8-bit B only
//    K-major, so the consumers transpose each landed (k, n) chunk once in
//    shared memory (4 × 4 byte blocks, `prmt`) into a K-major buffer laid
//    out as TMA's 64-byte swizzle would lay it (two buffers, alternating by
//    chunk): B lands with its rows' swizzle and the lanes' stores are
//    rotated, so neither side of the transpose serialises on shared-memory
//    banks; A lands K-major with the 64-byte swizzle. Each ACC step's s32
//    accumulators start at zero, carry across its T/64 chunks, then fold
//    into the f32 accumulator once per element with
//    __fadd_rn(acc, __fmul_rn(__fmul_rn(f32(dot), a_scale[i, k]),
//    b_scale[k, fine j])), the step's scales loaded into the list beside
//    its entry: the plain version's order, so the kernel is bit for bit
//    spamm_mm_worklist_int8_plain at every tile, block_n and width (the
//    integer dot is exact in any order; |dot| ≤ 512·127² < 2²⁴).
// 4. FLUSH stores the accumulator fragments straight to the output.
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
// the widest column range of a block (the largest `wgmma` N used)
constexpr int kMaxWidthBf16 = 256;
constexpr int kMaxWidthInt8 = 64;
// the largest tile the kernels take (kernels/spamm_mm.py::MAX_CUDA_TILE)
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
// it. Stage layout: the 64 × 64 A chunk, then the 64 × W B chunk.
// ---------------------------------------------------------------------------

// bytes of one ring stage of operand type T at width W
template <class T, int W>
constexpr int kStageBytes = (kBand * kBand + kBand * W) * sizeof(T);

// bf16: A K-major (128-byte swizzle, 128-byte rows); B MN-major, in boxes
// of BOX = min(W, 64) columns, rows of 2·BOX bytes, swizzled by their width
template <int W>
struct Bf16Wgmma {
  using T = __nv_bfloat16;
  static constexpr int STAGE = kStageBytes<T, W>;
  static constexpr int A_BYTES = kBand * kBand * 2;
  static constexpr int BOX = W < 64 ? W : 64;
  static constexpr int ROW = 2 * BOX;            // bytes of a B row (one k)
  static constexpr int BOX_BYTES = kBand * ROW;
  static constexpr int B_MODE = BOX == 64 ? 1 : BOX == 32 ? 2 : 3;
  static constexpr int EXTRA = 0;                // no transposed-B buffers
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

  // the producer's loads of one chunk: A at (x, y) of map a, W columns of
  // B at (x, y) of map b, box by box
  __device__ static void load(unsigned char* st, const CUtensorMap* ma,
                              const CUtensorMap* mb, int ax, int ay, int bx,
                              int by, uint64_t* full) {
    mbar_expect_tx(full, STAGE);
    tma_load_2d(st, ma, ax, ay, full);
#pragma unroll
    for (int q = 0; q < W / BOX; ++q)
      tma_load_2d(st + A_BYTES + q * BOX_BYTES, mb, bx + q * BOX, by, full);
  }

  // nothing to do between a chunk's landing and its products
  __device__ static void prepare(const unsigned char*, unsigned char*) {}

  // issues acc += A_chunk · B_chunk (four k16 products) as one group
  __device__ static void issue(const unsigned char* st, const unsigned char*,
                               Acc& acc) {
    const uint64_t da = smem_desc(st, 16, 8 * 128, 1);
    const uint64_t db = smem_desc(st + A_BYTES, BOX_BYTES, 8 * ROW, B_MODE);
    wgmma_fence();
    fence_regs(acc.c);
#pragma unroll
    for (int kk = 0; kk < kBand / 16; ++kk)
      wgmma_bf16<W>(acc.c, da + ((kk * 32) >> 4),
                    db + ((kk * 16 * ROW) >> 4));
    wgmma_commit();
  }

  // after the group's wait: the accumulators are the products' again
  __device__ static void settle(Acc& acc) { fence_regs(acc.c); }

  __device__ static void finish(Acc&, float2) {}
};

// TMA's swizzle of a box with rows of S bytes (S = 32, 64 or 128; 0 for
// none): bits 7 .. 6 + log2(S/16) of a byte offset from a 1024-byte
// boundary XOR-ed into bits 4 .. (the 16-byte chunk of a row)
template <int S>
__device__ __forceinline__ int swizzled(int off) {
  constexpr int mask = S == 128 ? 7 : S == 64 ? 3 : S == 32 ? 1 : 0;
  return off ^ (((off >> 7) & mask) << 4);
}

// int8: A K-major (64-byte swizzle, 64-byte rows); B lands (k, n) row-major
// with the swizzle of its W-byte rows (none at W = 16) and is transposed
// into a K-major buffer of W rows of 64 bytes in the 64-byte swizzle's
// layout (`bt_offset`)
template <int W>
struct Int8Wgmma {
  using T = signed char;
  static constexpr int STAGE = kStageBytes<T, W>;
  static constexpr int A_BYTES = kBand * kBand;
  // the landed B rows' swizzle: their width, from 32 bytes up
  static constexpr int B_SWIZZLE = W >= 32 ? W : 0;
  // two transposed-B buffers, alternating by chunk
  static constexpr int EXTRA = 2 * W * kBand;
  static constexpr int REGS = W / 2;
  static constexpr int MIN_BLOCKS = 3;
  static constexpr int CW = W / 4;            // 4-byte words of a landed row
  static constexpr int CL = CW < 8 ? CW : 8;  // a warp's words
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

  __device__ static void load(unsigned char* st, const CUtensorMap* ma,
                              const CUtensorMap* mb, int ax, int ay, int bx,
                              int by, uint64_t* full) {
    mbar_expect_tx(full, STAGE);
    tma_load_2d(st, ma, ax, ay, full);
    tma_load_2d(st + A_BYTES, mb, bx, by, full);
  }

  // byte offset of (n, k) in a transposed-B buffer: row n of 64 bytes, its
  // 16-byte chunk k/16 XOR bits 1-2 of n (TMA's 64-byte swizzle)
  __device__ static __forceinline__ int bt_offset(int n, int k) {
    return n * 64 + ((((k >> 4) ^ (n >> 1)) & 3) << 4) + (k & 15);
  }

  // a chunk's transpose: its landed (k, n) B tile into `bt`. A work item
  // is a 4 × 4 byte block: k rows 4·kb .. 4·kb + 3 of the 4-column word c,
  // read as 4 words and stored as the 4 columns' k-words. A warp's 32 items
  // are 8 words c × 4 rows kb, and lane pair c_lo/2 stores its columns
  // rotated by c_lo/2 (its input bytes rotated first, one prmt each), so
  // each of the 4 stores of a warp hits 32 distinct banks; the reads of the
  // swizzled landed rows hit 16. Then the stores are made visible to the
  // tensor cores and the warpgroup meets.
  __device__ static void prepare(const unsigned char* st, unsigned char* bt) {
    const unsigned char* bs = st + A_BYTES;
    const int rot = (threadIdx.x % CL) >> 1;
    const unsigned sel = (rot & 3) | (((rot + 1) & 3) << 4) |
                         (((rot + 2) & 3) << 8) | (((rot + 3) & 3) << 12);
#pragma unroll
    for (int it = 0; it < (ITEMS + kConsumers - 1) / kConsumers; ++it) {
      const int e = threadIdx.x + it * kConsumers;
      if (ITEMS % kConsumers && e >= ITEMS) break;
      int t = e / CL;
      const int kb_lo = t % 4;
      t /= 4;
      const int c = e % CL + CL * (t % (CW / CL));
      const int kb = kb_lo + 4 * (t / (CW / CL));
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
      // o[s]: column 4·c + (s + rot) % 4, k rows 4·kb .. 4·kb + 3
      const unsigned o[4] = {__byte_perm(t0, t2, 0x5410),
                             __byte_perm(t0, t2, 0x7632),
                             __byte_perm(t1, t3, 0x5410),
                             __byte_perm(t1, t3, 0x7632)};
#pragma unroll
      for (int s = 0; s < 4; ++s)
        *reinterpret_cast<unsigned*>(
            bt + bt_offset(4 * c + ((s + rot) & 3), 4 * kb)) = o[s];
    }
    // the generic-proxy stores, visible to the tensor cores' reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
  }

  // issues acc.d += A_chunk · Bt (two k32 products) as one group
  __device__ static void issue(const unsigned char* st, const unsigned char* bt,
                               Acc& acc) {
    const uint64_t da = smem_desc(st, 16, 8 * 64, 2);
    const uint64_t db = smem_desc(bt, 16, 8 * 64, 2);
    wgmma_fence();
    fence_regs(acc.d);
#pragma unroll
    for (int kk = 0; kk < kBand / 32; ++kk)
      wgmma_s8<W>(acc.d, da + ((kk * 32) >> 4), db + ((kk * 32) >> 4));
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
// column 8·(r/4) + 2·(lane % 4) (+1 for odd r).
template <int REGS>
__device__ __forceinline__ void store_fragments(float* og, size_t ldo,
                                                const float (&c)[REGS]) {
  const int warp = threadIdx.x / 32;
  const int ln = threadIdx.x % 32;
  const size_t row = 16 * warp + ln / 4;
#pragma unroll
  for (int j = 0; j < REGS / 4; ++j) {
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
// flagged steps, list chunk by list chunk; warp 4 loads, warps 0-3 compute.
template <class P, int W>
__device__ void worklist_wgmma_block(const CUtensorMap* ma,
                                     const CUtensorMap* mb,
                                     const int* step_i, const int* step_j,
                                     const int* step_k,
                                     const int* step_flags, const int* runs,
                                     float* out, int n, int block_n, int tile,
                                     int raster, const float* a_scale,
                                     const float* b_scale, int gk, int gn) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ int4 list[kListCap];
  __shared__ float2 scl[kListCap];
  __shared__ int wsum[kThreads / 32];
  __shared__ __align__(8) uint64_t full[kStagesWgmma];
  __shared__ __align__(8) uint64_t empty[kStagesWgmma];
  // the ring (and int8's transposed-B buffers) from a 1024-byte boundary,
  // which the swizzled layouts need
  unsigned char* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) &
                                    1023);
  unsigned char* bt = ring + kStagesWgmma * P::STAGE;

  const int bands = tile / kBand;
  // launch order q → run: the `raster` row tiles of one column first (run
  // p = i · runs/raster + j in a pair-major table of raster rows), so the
  // blocks in flight share their B tiles in L2; any permutation is right
  const int nruns = gridDim.x / bands;
  const int q = blockIdx.x / bands;
  const int run = nruns % raster ? q
                                 : q % raster * (nruns / raster) + q / raster;
  const int row0 = (blockIdx.x % bands) * kBand;
  const int pieces = tile / W;  // column pieces of a tile-wide group
  const int group = blockIdx.y / pieces;
  const int col0 = group * tile + (blockIdx.y % pieces) * W;
  const int jstride = block_n * tile;
  const int chunks = tile / kBand;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStagesWgmma; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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
      if (threadIdx.x % 32 == 0) {
        for (int e = 0; e < cnt; ++e) {
          const int4 en = list[e];
          if (!(en.w & kAcc)) continue;
          for (int kc = 0; kc < chunks; ++kc) {
            mbar_wait(&empty[stage], phase);
            P::load(ring + stage * P::STAGE, ma, mb, en.x * tile + kc * kBand,
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
          for (int kc = 0; kc < chunks; ++kc) {
            unsigned char* st = ring + stage * P::STAGE;
            mbar_wait(&full[stage], phase);
            P::prepare(st, bt + tb * (W * kBand));
            P::issue(st, bt + tb * (W * kBand), acc);
            wgmma_wait_all();
            P::settle(acc);
            if (threadIdx.x % 32 == 0) mbar_arrive(&empty[stage]);
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
              n, acc.c);
      }
    }
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads, Bf16Wgmma<W>::MIN_BLOCKS)
spamm_worklist_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap ma,
                                 const __grid_constant__ CUtensorMap mb,
                                 const int* __restrict__ step_i,
                                 const int* __restrict__ step_j,
                                 const int* __restrict__ step_k,
                                 const int* __restrict__ step_flags,
                                 const int* __restrict__ runs,
                                 float* __restrict__ out, int n, int block_n,
                                 int tile, int raster) {
  worklist_wgmma_block<Bf16Wgmma<W>, W>(&ma, &mb, step_i, step_j, step_k,
                                        step_flags, runs, out, n, block_n,
                                        tile, raster, nullptr, nullptr, 0, 0);
}

template <int W>
__global__ void __launch_bounds__(kThreads, Int8Wgmma<W>::MIN_BLOCKS)
spamm_worklist_int8_wgmma_kernel(const __grid_constant__ CUtensorMap ma,
                                 const __grid_constant__ CUtensorMap mb,
                                 const float* __restrict__ a_scale,
                                 const float* __restrict__ b_scale,
                                 const int* __restrict__ step_i,
                                 const int* __restrict__ step_j,
                                 const int* __restrict__ step_k,
                                 const int* __restrict__ step_flags,
                                 const int* __restrict__ runs,
                                 float* __restrict__ out, int k, int n,
                                 int block_n, int tile, int raster) {
  worklist_wgmma_block<Int8Wgmma<W>, W>(
      &ma, &mb, step_i, step_j, step_k, step_flags, runs, out, n, block_n,
      tile, raster, a_scale, b_scale, k / tile, n / tile);
}

// ---------------------------------------------------------------------------
// Host side: launches (tensor maps: tma.cuh)
// ---------------------------------------------------------------------------

// dynamic shared memory of a launch: the ring, int8's transposed-B
// buffers, and room to align the ring to 1024 bytes
template <class P>
constexpr int kDynamicBytes = kStagesWgmma * P::STAGE + P::EXTRA + 1024;

// The launch of kernel `kern` of product P (tma.cuh's launch_once: the
// dynamic shared-memory attribute set on a device's first launch).
template <class P, class K, class... Args>
int launch(K kern, dim3 grid, cudaStream_t stream, Args... args) {
  return launch_once<P>(kern, grid, kThreads, kDynamicBytes<P>, stream,
                        args...);
}

// gridDim of a launch: run × band, column group × column piece
dim3 grid_of(int num_runs, int tile, int block_n, int width) {
  return dim3(num_runs * (tile / kBand), block_n * (tile / width));
}

template <int W>
int bf16_at(const void* a, const void* b, const int* si, const int* sj,
            const int* sk, const int* sf, const int* runs, int num_runs,
            float* out, int m, int k, int n, int tile, int block_n,
            cudaStream_t st) {
  using P = Bf16Wgmma<W>;
  CUtensorMap ma, mb;
  const auto sw = P::BOX == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                  : P::BOX == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                 : CU_TENSOR_MAP_SWIZZLE_32B;
  if (!cached_map(&ma, a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, m, k, kBand,
                  kBand, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !cached_map(&mb, b, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, k, n, kBand,
                  P::BOX, sw))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<P>(spamm_worklist_bf16_wgmma_kernel<W>,
                   grid_of(num_runs, tile, block_n, W), st, ma, mb, si, sj,
                   sk, sf, runs, out, n, block_n, tile, m / tile);
}

template <int W>
int int8_at(const void* a, const void* b, const float* sa, const float* sb,
            const int* si, const int* sj, const int* sk, const int* sf,
            const int* runs, int num_runs, float* out, int m, int k, int n,
            int tile, int block_n, cudaStream_t st) {
  using P = Int8Wgmma<W>;
  CUtensorMap ma, mb;
  if (!cached_map(&ma, a, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, m, k, kBand,
                  kBand, CU_TENSOR_MAP_SWIZZLE_64B) ||
      !cached_map(&mb, b, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, k, n, kBand, W,
                  P::B_SWIZZLE == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                  : P::B_SWIZZLE == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                  : P::B_SWIZZLE == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                                       : CU_TENSOR_MAP_SWIZZLE_NONE))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<P>(spamm_worklist_int8_wgmma_kernel<W>,
                   grid_of(num_runs, tile, block_n, W), st, ma, mb, sa, sb,
                   si, sj, sk, sf, runs, out, k, n, block_n, tile, m / tile);
}

// what the kernels take: a tile that is a multiple of 64 up to kMaxTile, a
// width that divides it, up to the dtype's widest
bool takes(int tile, int width, int widest) {
  return tile % kBand == 0 && tile >= kBand && tile <= kMaxTile &&
         width >= 16 && width <= widest && tile % width == 0;
}

}  // namespace

// a: (m, k), b: (k, n) row-major bf16, 16-byte aligned; step tables (S,)
// int32; runs (num_runs + 1,) int32 run boundaries into the step tables;
// out: (m, n) float32, zero-initialised; tile a multiple of 64 up to 512;
// width: the columns of a block, one of 16, 32, 64, 128, 256 dividing the
// tile. Else returns cudaErrorInvalidValue without launching. Returns
// cudaGetLastError().
extern "C" int spamm_wgmma_worklist_bf16(const void* a, const void* b,
                                         const int* step_i,
                                         const int* step_j,
                                         const int* step_k,
                                         const int* step_flags,
                                         const int* runs, int num_runs,
                                         float* out, int m, int k, int n,
                                         int tile, int block_n, int width,
                                         void* stream) {
  if (!takes(tile, width, kMaxWidthBf16))
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
// 16, 32, 64 dividing the tile (else returns cudaErrorInvalidValue without
// launching). Returns cudaGetLastError().
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
  if (!takes(tile, width, kMaxWidthInt8))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
#define SPAMM_INT8_AT(W)                                                    \
  if (width == W)                                                          \
    return int8_at<W>(a, b, a_scale, b_scale, step_i, step_j, step_k,      \
                      step_flags, runs, num_runs, out, m, k, n, tile,      \
                      block_n, st);
  SPAMM_INT8_AT(16)
  SPAMM_INT8_AT(32)
  SPAMM_INT8_AT(64)
#undef SPAMM_INT8_AT
  return static_cast<int>(cudaErrorInvalidValue);
}
