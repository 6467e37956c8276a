// SpAMM GEMMs (paper §3.3, Alg. 2): C[i, j] = Σ over the valid k of
// A[i, k] · B[k, j], driven by the planner's step tables (work-list kernels)
// or by dense per-(i, j) valid-k lists (dense-grid kernel).
//
// The work-list kernels replace the Pallas TPU kernel
// src/repro/kernels/spamm_mm.py::spamm_mm_worklist (_spamm_mm_worklist_kernel).
// The TPU kernel walks one sequential 1-D grid over the steps and carries
// its f32 accumulator in VMEM from step to step. Blocks on a GPU run in
// parallel and in no order, so here each (i, j) RUN of consecutive steps
// (the rows of `runs`: steps [runs[p], runs[p+1]) share one output block)
// is one thread block (times block_n column groups and the column slices
// below, in gridDim.y). INIT zeroes the register accumulator, ACC adds
// A[i,k]·B[k,j-block] for that step, FLUSH writes the accumulator out;
// steps without flag bits (bucket padding, steps a frozen gate switched
// off) do nothing. The output is zero-initialised by the caller, so tiles no
// run visits stay exactly 0.
//
// Schedule of a block (both work-list kernels and the dense-grid kernel):
// 1. Step list. The block reads its run's step_flags/step_k/step_i/step_j
//    in coalesced rounds of one step per thread and keeps the steps with a
//    flag bit, in table order (warp ballot, then a prefix over the warps),
//    as int4 entries of a shared-memory list of kListCap entries; a longer
//    run is walked in several such chunks. A frozen plan's gated-off steps
//    cost one coalesced read each, not a dependent global load.
// 2. Pipeline. The A and B tiles of the list's ACC entries stream through a
//    ring of STAGES stages in dynamic shared memory, filled by 16-byte
//    cp.async: while one ACC step computes, the next STAGES-1 load.
// 3. Tile product (one per operand type, below) into registers; FLUSH
//    stores the registers straight to the output.
// The dense-grid kernel builds the same list from its valid-k list (ACC on
// every entry, INIT on the first, FLUSH on the last; one INIT|FLUSH entry
// when nvalid is 0, so the block writes zeros) and walks it with the same
// pipeline and tile product.
//
// Column slices: at decode shapes the runs alone cannot fill 132 SMs (8
// runs for wk/wv, 72 for w2), so the wrapper splits each t-wide output
// block into `slices` column slices of W = t / slices, one block each; a
// slice walks the same list over its W columns. The rule is the host
// function `column_slices` in kernels/spamm_mm.py.
//
// Tiles: every multiple of 16 up to kMaxTile (512), as the reference's
// kernels take any tile that divides the operands; at bf16 and int8 the
// `wgmma` kernels of spamm_wgmma.cu serve every tile from 48, so here
// those two take only the tiles 16 and 32, where the `wgmma` kernels were
// slower (SPAMM_DISPATCH_MMA). The tile products are
// built for a sub-tile SUB of 16, 32 or 64 (the largest that divides the
// tile T). At T = SUB (tiles 16, 32, 64) a block owns a whole output block,
// as above. At T > SUB the work-list (or valid-k list) stays the planner's
// own T-level one, so every step table, flag and scale is the reference's;
// each T × T·block_n output block is cut into R = T / SUB row bands
// (gridDim.x: run × band) and R column sub-blocks of SUB columns, each cut
// into the slices above (gridDim.y: group × sub-block × slice), and each
// ACC entry of the list is walked as R K-chunks of SUB: chunk kc loads A
// rows i·T + band·SUB, columns k·T + kc·SUB, and B rows k·T + kc·SUB,
// through the same ring, kc ascending. A ring stage stays one SUB-tile
// product's, so shared memory does not grow with T.
//
// f32 (the numerics of record): no tensor cores, no TF32. 128 threads per
// block (64 at t = 16): W/4 threads along a row, each owning one float4 of
// 4 columns in RM rows strided by the thread rows (8 × 4 outputs at t = 64
// on a whole block, 2 × 4 on a decode slice of 16 columns). A rows are
// read as float4 over 4 consecutive q, B rows as float4, so a 4-q step
// costs RM + 4 shared loads for 16·RM FMAs (128 per 12 LDS.128 at t = 64);
// a warp's B load covers 16 distinct float4s, its A loads 2 adjacent rows
// (different banks through the 4-float row pad). Every output element is
// accumulated with fmaf over the run's ACC steps in table order and, within
// a tile, over ascending q: the order of the earlier one-FMA-per-q kernel,
// whatever the slices, the thread layout or the pipeline; at T > SUB the
// chunks ascend, so q still runs from 0 to T − 1 within a step, the order
// of the plain version. So frozen ≡ eager, dense-grid ≡ work-list and any
// two geometries agree bit for bit.
// Bound: 2·t³ operations per ACC step at the 67 TFLOP/s f32 peak of the
// CUDA cores, or (decode) the A and B tile bytes.
//
// bf16 (tiles 16 and 32): tensor cores, mma.sync.aligned.m16n8k16
// bf16 × bf16 → f32. Warp w owns rows 16w .. 16w+15 of the output block
// and all W columns (W/8 m16n8 accumulators in registers, f32); A
// fragments come from the row-major A tile by ldmatrix.x4, B fragments
// from the row-major (k, n) B tile by ldmatrix.x4.trans. Tile rows are
// padded by 16 bytes so the 8 row addresses of an ldmatrix hit 8 distinct
// bank groups. The tensor core adds the products of one k16 slice in its
// own order, so the bf16 kernel is NOT bit-identical to the f32 kernel on
// the bf16-rounded operands: it agrees within 1e-4 of the output's
// largest magnitude (the port's contract; a product of two bf16 values is
// exact in f32, only the order of the additions differs). It is
// deterministic, and frozen ≡ eager bit for bit (same kernel, same steps).
// Bound: the bf16 tensor-core peak (989 TFLOP/s) or, at serving shapes,
// the bf16 operand bytes.
//
// The dense-grid kernel replaces the Pallas TPU kernel
// src/repro/kernels/spamm_mm.py::spamm_mm (_spamm_mm_kernel), which walks
// the whole (gm, gn, gk) grid and masks the steps t >= nvalid[i, j] out,
// reading k = kidx[i, j, t]. Here one thread block owns one output block
// (i, j) (times block_n column groups and column slices in gridDim.y) of
// one batch slice (gridDim.z) and walks only its valid k's. Its bound is
// the work-list kernel's.
//
// The int8 work-list kernel replaces the Pallas TPU kernel
// src/repro/kernels/spamm_mm.py::spamm_mm_worklist_int8
// (_spamm_mm_worklist_int8_kernel): per-tile quantized int8 operands, one
// f32 scale per A tile (gm, gk) and per FINE B tile (gk, gn), the same step
// tables and flags. Each ACC step takes the exact int32 tile dot and adds
// (f32(dot)·a_scale[i, k])·b_scale[k, j·block_n + group] to the f32
// accumulator, in the reference's order, with __fmul_rn/__fadd_rn so nvcc
// cannot contract the two multiplies and the add: the kernel is bit-
// identical to its plain version. Its bound is the int8 tensor-core peak
// (1,979 TOP/s) or, at serving shapes, the int8 operand bytes (a step
// reads 2·t² bytes for 2·t³ operations, so the tile traffic from L2 holds
// it long before the tensor cores do). It runs (tiles 16 and 32) on the
// pipeline above, with the f32/bf16 geometry and column slices, and the
// tensor cores:
// mma.sync.aligned.m16n8k32 s8 × s8 → s32 (m16n8k16 at t = 16), one warp
// per 16 rows of the output block with W/8 m16n8 accumulators, A
// fragments by ldmatrix from the row-major A tile as in bf16. The .col B
// operand wants 4 consecutive k of one column in a register, so B must be
// K-major in shared memory: the ring lands the (k, n) B tile as it is in
// global memory (rows permuted so that the reads below hit 32 banks), and
// each ACC step first transposes it once, shared to shared, into a (W × t)
// buffer (4 × 4 byte blocks, 4 word loads, 8 prmt, 4 word stores; rows
// XOR-swizzled so the stores spread over the banks and each ldmatrix hits
// 8 distinct bank groups); the `wgmma` s8 kernel of spamm_wgmma.cu (tiles
// from 48) transposes into a K-major layout the same way. Gathering each
// lane's B bytes straight from the landed tile instead (byte loads, no
// transpose) was slower at every serving shape: every warp reads all of
// B, a byte at a time. Each ACC step starts its s32 fragments afresh (its
// scales are its own) and folds them into the f32 accumulator once, with
// the exact expression above and the step's scales. The integer tile
// dot is exact in any order (|dot| ≤ T·127² < 2²⁴ up to T = 1040, so
// f32(dot) is exact too at T = 512), and the tensor-core sum equals the
// plain version's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "worklist.cuh"

namespace {

using spamm::fill_worklist;
using spamm::kAcc;
using spamm::kFlush;
using spamm::kInit;
using spamm::kListCap;
using spamm::smem_addr;

// ring depth of the pipelined tile products
constexpr int kStagesF32 = 2;
constexpr int kStagesBf16 = 3;
constexpr int kStagesInt8 = 4;
// threads of an f32 block that has at least this many float4 outputs
constexpr int kThreadsF32 = 128;
// the largest tile the kernels take (a multiple of 16)
constexpr int kMaxTile = 512;

// The sub-tile of the tile products a tile T is walked with: 64, 32 or 16,
// the largest that divides T; 0 for a tile the kernels do not take (the
// rule of `sub_tile` in kernels/spamm_mm.py).
inline int sub_tile(int tile) {
  if (tile < 16 || tile > kMaxTile || tile % 16) return 0;
  return tile % 64 == 0 ? 64 : tile % 32 == 0 ? 32 : 16;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stores NB m16n8 f32 accumulator fragments of one warp (rows 16·warp ..
// +15 of the block at `og`): c0, c1 at row lane/4, columns 2·(lane%4) +
// 0/1 of each n8 block; c2, c3 eight rows below.
template <int NB>
__device__ __forceinline__ void store_m16n8(float* og, size_t ldo,
                                            const float (&c)[NB][4]) {
  const int warp = threadIdx.x / 32;
  const int ln = threadIdx.x % 32;
  const size_t r = 16 * warp + ln / 4;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    const int col = nb * 8 + 2 * (ln % 4);
    *reinterpret_cast<float2*>(og + r * ldo + col) =
        make_float2(c[nb][0], c[nb][1]);
    *reinterpret_cast<float2*>(og + (r + 8) * ldo + col) =
        make_float2(c[nb][2], c[nb][3]);
  }
}

// ---------------------------------------------------------------------------
// Tile products of TILE × TILE (the walk's sub-tile SUB) times TILE × W:
// zero() at INIT; per ACC step begin(), then compute() on each of the
// step's K-chunks in ascending order, then finish() on the last chunk's
// stage; store() at FLUSH.
// ---------------------------------------------------------------------------

// f32 tile product: CUDA-core FMAs in ascending q.
template <int TILE, int SL>
struct F32Product {
  using T = float;
  static constexpr int SUB = TILE;
  static constexpr int W = TILE / SL;          // output columns per block
  static constexpr int TC = W / 4;             // threads along a row
  static constexpr int TR =
      TILE < kThreadsF32 / TC ? TILE : kThreadsF32 / TC;
  static constexpr int RM = TILE / TR;         // rows per thread
  static constexpr int NT = TR * TC;
  static constexpr int STAGES = kStagesF32;
  static constexpr int LDA = TILE + 4;         // padded A row (floats)
  static constexpr int STAGE_BYTES = (TILE * LDA + TILE * W) * 4;
  static_assert(TC >= 1 && NT % 32 == 0, "bad f32 geometry");

  struct Acc {
    float4 v[RM];  // row ty + TR·m, columns 4·tx .. 4·tx + 3
  };

  __device__ static void zero(Acc& acc) {
#pragma unroll
    for (int m = 0; m < RM; ++m) acc.v[m] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // the chunks add straight into the accumulator
  __device__ static void begin(Acc&) {}
  __device__ static void finish(const unsigned char*, Acc&) {}

  // cp.async of the (TILE × TILE) A tile at `ag` and the (TILE × W) B tile
  // at `bg` into one stage (the list entry is the int8 product's)
  __device__ static void load(unsigned char* stage, const float* ag,
                              size_t lda, const float* bg, size_t ldb,
                              int4) {
    float* as = reinterpret_cast<float*>(stage);
    float* bs = as + TILE * LDA;
    for (int e = threadIdx.x; e < TILE * TILE / 4; e += NT) {
      const int r = e / (TILE / 4);
      const int c = 4 * (e % (TILE / 4));
      cp_async16(as + r * LDA + c, ag + static_cast<size_t>(r) * lda + c);
    }
    for (int e = threadIdx.x; e < TILE * W / 4; e += NT) {
      const int r = e / (W / 4);
      const int c = 4 * (e % (W / 4));
      cp_async16(bs + r * W + c, bg + static_cast<size_t>(r) * ldb + c);
    }
  }

  __device__ static __forceinline__ float4 fma4(float a, float4 b,
                                                float4 c) {
    return make_float4(fmaf(a, b.x, c.x), fmaf(a, b.y, c.y),
                       fmaf(a, b.z, c.z), fmaf(a, b.w, c.w));
  }

  __device__ static __forceinline__ float lane(float4 v, int q) {
    return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
  }

  // acc += A_tile · B_tile, one fmaf per output and q, q ascending
  __device__ static void compute(const unsigned char* stage, Acc& acc) {
    const float* as = reinterpret_cast<const float*>(stage);
    const float* bs = as + TILE * LDA;
    const int tx = threadIdx.x % TC;
    const int ty = threadIdx.x / TC;
#pragma unroll 4
    for (int q = 0; q < TILE; q += 4) {
      float4 av[RM];
#pragma unroll
      for (int m = 0; m < RM; ++m)
        av[m] = *reinterpret_cast<const float4*>(as + (ty + TR * m) * LDA + q);
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        const float4 bv =
            *reinterpret_cast<const float4*>(bs + (q + qq) * W + 4 * tx);
#pragma unroll
        for (int m = 0; m < RM; ++m)
          acc.v[m] = fma4(lane(av[m], qq), bv, acc.v[m]);
      }
    }
  }

  // writes the thread's outputs into the (TILE × W) block at `og`
  __device__ static void store(float* og, size_t ldo, const Acc& acc) {
    const int tx = threadIdx.x % TC;
    const int ty = threadIdx.x / TC;
#pragma unroll
    for (int m = 0; m < RM; ++m)
      *reinterpret_cast<float4*>(og + static_cast<size_t>(ty + TR * m) * ldo +
                                 4 * tx) = acc.v[m];
  }
};

// ---------------------------------------------------------------------------
// bf16 tile product: mma.sync m16n8k16 on the tensor cores, f32 accumulate.
// ---------------------------------------------------------------------------
template <int TILE, int SL>
struct Bf16Product {
  using T = __nv_bfloat16;
  static constexpr int SUB = TILE;
  static constexpr int W = TILE / SL;
  static constexpr int NB = W / 8;             // m16n8 accumulators per warp
  static constexpr int NT = 32 * (TILE / 16);  // one warp per 16 rows
  static constexpr int STAGES = kStagesBf16;
  static constexpr int LDA = TILE + 8;         // padded rows (bf16 values)
  static constexpr int LDB = W + 8;
  static constexpr int STAGE_BYTES = (TILE * LDA + TILE * LDB) * 2;
  static_assert(NB % 2 == 0, "ldmatrix.x4.trans takes two n8 blocks");

  struct Acc {
    float c[NB][4];
  };

  __device__ static void zero(Acc& acc) {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc.c[nb][r] = 0.f;
  }

  // nothing to start or fold per step: the products add into the f32
  // fragments
  __device__ static void begin(Acc&) {}
  __device__ static void finish(const unsigned char*, Acc&) {}

  __device__ static void load(unsigned char* stage, const T* ag, size_t lda,
                              const T* bg, size_t ldb, int4) {
    T* as = reinterpret_cast<T*>(stage);
    T* bs = as + TILE * LDA;
    for (int e = threadIdx.x; e < TILE * TILE / 8; e += NT) {
      const int r = e / (TILE / 8);
      const int c = 8 * (e % (TILE / 8));
      cp_async16(as + r * LDA + c, ag + static_cast<size_t>(r) * lda + c);
    }
    for (int e = threadIdx.x; e < TILE * W / 8; e += NT) {
      const int r = e / (W / 8);
      const int c = 8 * (e % (W / 8));
      cp_async16(bs + r * LDB + c, bg + static_cast<size_t>(r) * ldb + c);
    }
  }

  __device__ static void compute(const unsigned char* stage, Acc& acc) {
    const T* as = reinterpret_cast<const T*>(stage);
    const T* bs = as + TILE * LDA;
    const int warp = threadIdx.x / 32;
    const int ln = threadIdx.x % 32;
#pragma unroll
    for (int kk = 0; kk < TILE; kk += 16) {
      unsigned a0, a1, a2, a3;
      // matrices: rows 0-7 / 8-15 of the warp's 16 at k 0-7, then at k 8-15
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
          : "=r"(a0), "=r"(a1), "=r"(a2), "=r"(a3)
          : "r"(smem_addr(as + (16 * warp + ln % 16) * LDA + kk +
                          (ln / 16) * 8)));
#pragma unroll
      for (int nb = 0; nb < NB; nb += 2) {
        unsigned b0, b1, b2, b3;
        // matrices: k 0-7 / 8-15 at columns n0 .. n0+7, then at n0+8 ..
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
            "{%0,%1,%2,%3}, [%4];\n"
            : "=r"(b0), "=r"(b1), "=r"(b2), "=r"(b3)
            : "r"(smem_addr(bs + (kk + ln % 8 + ((ln / 8) % 2) * 8) * LDB +
                            nb * 8 + (ln / 16) * 8)));
        mma(acc.c[nb], a0, a1, a2, a3, b0, b1);
        mma(acc.c[nb + 1], a0, a1, a2, a3, b2, b3);
      }
    }
  }

  __device__ static __forceinline__ void mma(float (&c)[4], unsigned a0,
                                             unsigned a1, unsigned a2,
                                             unsigned a3, unsigned b0,
                                             unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }

  __device__ static void store(float* og, size_t ldo, const Acc& acc) {
    store_m16n8<NB>(og, ldo, acc.c);
  }
};

// ---------------------------------------------------------------------------
// int8 tile product: mma.sync s8 × s8 → s32 on the tensor cores, each ACC
// step's exact tile dot scaled into the f32 accumulator.
// ---------------------------------------------------------------------------
template <int TILE, int SL>
struct Int8Product {
  using T = signed char;
  static constexpr int SUB = TILE;
  static constexpr int W = TILE / SL;
  static constexpr int NB = W / 8;             // m16n8 accumulators per warp
  static constexpr int NT = 32 * (TILE / 16);  // one warp per 16 rows
  static constexpr int STAGES = kStagesInt8;
  static constexpr int KS = TILE >= 32 ? 32 : 16;  // mma depth
  // rows of TILE bytes padded to an odd number of 16-byte units, so the 8
  // row addresses of an ldmatrix hit 8 distinct bank groups
  static constexpr int LDA = (TILE / 16) % 2 ? TILE : TILE + 16;
  static constexpr int KB = TILE / 4;          // 4-row blocks of a B tile
  static constexpr int CW = W / 4;             // 4-byte words of a B row
  static constexpr int A_BYTES = TILE * LDA;
  static constexpr int B_BYTES = TILE * W;     // the landed (k, n) B tile
  // A tile, B tile, then a_scale and b_scale of the step
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES + 16;
  static_assert(NB % 2 == 0, "ldmatrix.x4 takes two n8 blocks");

  const float* a_scale;  // (gm, gk) at the walk's tile T
  const float* b_scale;  // (gk, gn) at T, per fine tile
  int gk, gn, block_n, group;

  struct Acc {
    float c[NB][4];  // the f32 accumulator
    int d[NB][4];    // the s32 tile dot of the current ACC step
  };

  __device__ static void zero(Acc& acc) {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc.c[nb][r] = 0.f;
  }

  // a step's s32 dot starts afresh
  __device__ static void begin(Acc& acc) {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc.d[nb][r] = 0;
  }

  // slot of B row k in the landed tile: rows k ≡ q (mod 4) together, so
  // the transposer's word loads are consecutive across a warp
  __device__ static __forceinline__ int b_slot(int k) {
    return (k % 4) * KB + k / 4;
  }

  // row of output column n in the transposed tile: n XOR (bits 3-4 of n)
  // in its low two bits, which spreads a warp's transposed stores over the
  // banks and keeps the 8 rows of each ldmatrix in distinct bank groups
  __device__ static __forceinline__ int bt_row(int n) {
    return n ^ ((n >> 3) & 3);
  }

  // cp.async of the A tile at `ag`, the B tile at `bg` and the entry's
  // (k, i, j) scales into one stage
  __device__ void load(unsigned char* stage, const T* ag, size_t lda,
                       const T* bg, size_t ldb, int4 en) const {
    T* as = reinterpret_cast<T*>(stage);
    T* bs = as + A_BYTES;
    for (int e = threadIdx.x; e < TILE * TILE / 16; e += NT) {
      const int r = e / (TILE / 16);
      const int c = 16 * (e % (TILE / 16));
      cp_async16(as + r * LDA + c, ag + static_cast<size_t>(r) * lda + c);
    }
    for (int e = threadIdx.x; e < TILE * W / 16; e += NT) {
      const int r = e / (W / 16);
      const int c = 16 * (e % (W / 16));
      cp_async16(bs + b_slot(r) * W + c, bg + static_cast<size_t>(r) * ldb + c);
    }
    float* sc = reinterpret_cast<float*>(bs + B_BYTES);
    if (threadIdx.x == 0)
      cp_async4(sc, a_scale + static_cast<size_t>(en.y) * gk + en.x);
    if (threadIdx.x == 1)
      cp_async4(sc + 1, b_scale + static_cast<size_t>(en.x) * gn +
                            static_cast<size_t>(en.z) * block_n + group);
  }

  __device__ static __forceinline__ void mma(int (&d)[4], unsigned a0,
                                             unsigned a1, unsigned a2,
                                             unsigned a3, unsigned b0,
                                             unsigned b1) {
    if constexpr (KS == 32) {
      asm volatile(
          "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    } else {
      (void)a2;
      (void)a3;
      (void)b1;
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
          "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
          : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
          : "r"(a0), "r"(a1), "r"(b0));
    }
  }

  // acc.d += A_q·B_q for the stage's tiles
  __device__ void compute(const unsigned char* stage, Acc& acc) const {
    __shared__ __align__(16) unsigned char bt[W * LDA];
    const unsigned char* as = stage;
    const unsigned char* bs = stage + A_BYTES;
    // 1. transpose the landed (k, n) B tile into bt (rows n, TILE bytes of
    //    k): 4 × 4 byte blocks, 4 k rows of one 4-column word each
    for (int e = threadIdx.x; e < KB * CW; e += NT) {
      const int c = e % CW;
      const int kb = e / CW;
      unsigned r[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        r[q] = *reinterpret_cast<const unsigned*>(bs + (q * KB + kb) * W +
                                                  4 * c);
      const unsigned t0 = __byte_perm(r[0], r[1], 0x5140);
      const unsigned t1 = __byte_perm(r[0], r[1], 0x7362);
      const unsigned t2 = __byte_perm(r[2], r[3], 0x5140);
      const unsigned t3 = __byte_perm(r[2], r[3], 0x7362);
      const unsigned o[4] = {__byte_perm(t0, t2, 0x5410),
                             __byte_perm(t0, t2, 0x7632),
                             __byte_perm(t1, t3, 0x5410),
                             __byte_perm(t1, t3, 0x7632)};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<unsigned*>(bt + bt_row(4 * c + j) * LDA + 4 * kb) =
            o[j];
    }
    __syncthreads();
    // 2. the exact s32 tile dots on the tensor cores
    const int warp = threadIdx.x / 32;
    const int ln = threadIdx.x % 32;
    int(&d)[NB][4] = acc.d;
#pragma unroll
    for (int kk = 0; kk < TILE; kk += KS) {
      unsigned a0, a1, a2 = 0, a3 = 0;
      if constexpr (KS == 32) {
        // matrices: rows 0-7 / 8-15 of the warp's 16 at k 0-15, then at
        // k 16-31
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
            : "=r"(a0), "=r"(a1), "=r"(a2), "=r"(a3)
            : "r"(smem_addr(as + (16 * warp + ln % 16) * LDA + kk +
                            (ln / 16) * 16)));
      } else {
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
            : "=r"(a0), "=r"(a1)
            : "r"(smem_addr(as + (16 * warp + ln % 16) * LDA + kk)));
      }
#pragma unroll
      for (int nb = 0; nb < NB; nb += 2) {
        if constexpr (KS == 32) {
          // matrices: columns n0 .. n0+7 at k 0-15, at k 16-31, then
          // columns n0+8 .. n0+15 at k 0-15, at k 16-31
          const int mi = ln / 8;
          const int n = nb * 8 + (mi / 2) * 8 + ln % 8;
          unsigned b0, b1, b2, b3;
          asm volatile(
              "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, "
              "[%4];\n"
              : "=r"(b0), "=r"(b1), "=r"(b2), "=r"(b3)
              : "r"(smem_addr(bt + bt_row(n) * LDA + kk + (mi % 2) * 16)));
          mma(d[nb], a0, a1, a2, a3, b0, b1);
          mma(d[nb + 1], a0, a1, a2, a3, b2, b3);
        } else {
          // matrices: columns n0 .. n0+7, then n0+8 .. n0+15, at k 0-15
          const int n = nb * 8 + ((ln / 8) % 2) * 8 + ln % 8;
          unsigned b0, b1;
          asm volatile(
              "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
              : "=r"(b0), "=r"(b1)
              : "r"(smem_addr(bt + bt_row(n) * LDA + kk)));
          mma(d[nb], a0, a1, a2, a3, b0, 0u);
          mma(d[nb + 1], a0, a1, a2, a3, b1, 0u);
        }
      }
    }
  }

  // after the step's product: fold its dot into the f32 accumulator in the
  // plain version's order, with the step's scales (landed in `stage`)
  __device__ static void finish(const unsigned char* stage, Acc& acc) {
    const float* sc =
        reinterpret_cast<const float*>(stage + A_BYTES + B_BYTES);
    const float sa = sc[0];
    const float sb = sc[1];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        acc.c[nb][r] = __fadd_rn(
            acc.c[nb][r],
            __fmul_rn(__fmul_rn(__int2float_rn(acc.d[nb][r]), sa), sb));
  }

  __device__ static void store(float* og, size_t ldo, const Acc& acc) {
    store_m16n8<NB>(og, ldo, acc.c);
  }
};

// ---------------------------------------------------------------------------
// Step lists and the pipelined walk, shared by every kernel above.
// ---------------------------------------------------------------------------

// The walk's tile: T = `tile` for a chunked (CH) kernel, else P's own
// tile, a compile-time constant (tiles 16, 32 and 64 keep their kernels).
template <class P, bool CH>
__device__ __forceinline__ int walk_tile(int tile) {
  return CH ? tile : P::SUB;
}

// Walks `n` list entries with the tile product `prod` at tile T (see
// walk_tile): INIT zeroes `acc`, ACC adds the entry's tile product as R =
// T/SUB K-chunks (each chunk's tiles prefetched STAGES-1 chunks ahead
// through the ring in `smem`; the product's load sees the entry, for
// per-step scales), FLUSH stores `acc`. An entry (k, i, j) reads, for
// chunk kc, A's SUB × SUB tile at rows i·T + row0, columns k·T + kc·SUB and
// B's SUB × W tile at rows k·T + kc·SUB, columns j·jstride + col0, and
// flushes to the output at rows i·T + row0, the same columns. Every branch
// is uniform across the block (flags come from shared memory).
template <class P, bool CH>
__device__ void walk_list(const P& prod, unsigned char* smem,
                          const int4* list, int n, const typename P::T* a,
                          size_t lda, const typename P::T* b, size_t ldb,
                          float* out, size_t ldo, size_t jstride, size_t col0,
                          size_t row0, int tile, typename P::Acc& acc) {
  const int t = walk_tile<P, CH>(tile);
  const int chunks = t / P::SUB;
  auto next_acc = [&](int e) {
    while (e < n && !(list[e].w & kAcc)) ++e;
    return e;
  };
  // the next chunk to load: entry ld, chunk ldc
  int ld = next_acc(0), ldc = 0;
  auto load = [&](int st) {
    const int4 en = list[ld];
    const size_t kc = static_cast<size_t>(ldc) * P::SUB;
    prod.load(smem + st * P::STAGE_BYTES,
              a + (static_cast<size_t>(en.y) * t + row0) * lda +
                  static_cast<size_t>(en.x) * t + kc,
              lda,
              b + (static_cast<size_t>(en.x) * t + kc) * ldb +
                  static_cast<size_t>(en.z) * jstride + col0,
              ldb, en);
    if (++ldc == chunks) {
      ldc = 0;
      ld = next_acc(ld + 1);
    }
  };
#pragma unroll
  for (int p = 0; p < P::STAGES - 1; ++p) {
    if (ld < n) load(p);
    cp_async_commit();
  }
  int stage = 0;
  for (int e = 0; e < n; ++e) {
    const int4 en = list[e];
    if (en.w & kInit) P::zero(acc);
    if (en.w & kAcc) {
      P::begin(acc);
      for (int c = 0; c < chunks; ++c) {
        cp_async_wait<P::STAGES - 2>();
        __syncthreads();  // the stage has landed; the previous one is free
        if (ld < n) load((stage + P::STAGES - 1) % P::STAGES);
        cp_async_commit();
        prod.compute(smem + stage * P::STAGE_BYTES, acc);
        if (c == chunks - 1) P::finish(smem + stage * P::STAGE_BYTES, acc);
        stage = (stage + 1) % P::STAGES;
      }
    }
    if (en.w & kFlush)
      P::store(out + (static_cast<size_t>(en.y) * t + row0) * ldo +
                   static_cast<size_t>(en.z) * jstride + col0,
               ldo, acc);
  }
}

// One block per (run, column group × column slice) at T = SUB; per (run ×
// row band, column group × column sub-block × column slice) at T > SUB: the
// run's flagged steps, chunk by chunk, through walk_list with the tile
// product `prod`.
template <class P, bool CH>
__device__ void worklist_block(const P& prod, const typename P::T* a,
                               const typename P::T* b, const int* step_i,
                               const int* step_j, const int* step_k,
                               const int* step_flags, const int* runs,
                               float* out, int k, int n, int block_n,
                               int tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int4 list[kListCap];
  __shared__ int wsum[P::NT / 32];
  const int t = walk_tile<P, CH>(tile);
  const int bands = t / P::SUB;
  const int run = blockIdx.x / bands;
  const int band = blockIdx.x % bands;
  const int slices = t / P::W;  // column slices of a t-wide group
  const int group = blockIdx.y / slices;
  const int slice = blockIdx.y % slices;
  const size_t col0 = static_cast<size_t>(group) * t + slice * P::W;
  int base = runs[run];
  const int s1 = runs[run + 1];
  typename P::Acc acc;
  P::zero(acc);
  while (base < s1) {
    __syncthreads();  // every thread is done with the previous chunk
    const int cnt = fill_worklist<P::NT>(list, wsum, step_i, step_j, step_k,
                                         step_flags, base, s1);
    walk_list<P, CH>(prod, smem, list, cnt, a, k, b, n, out, n,
                     static_cast<size_t>(block_n) * t, col0,
                     static_cast<size_t>(band) * P::SUB, tile, acc);
  }
}

// The kernels, templated on the sub-tile TILE, the column slices SL of a
// TILE-wide block and (f32) CH: false for the tile TILE itself (the `tile`
// argument is then TILE), true for a larger tile `tile` walked in chunks.
// bf16 and int8 take the tile TILE itself only (16 or 32: the larger tiles
// are spamm_wgmma.cu's).
template <int TILE, int SL, bool CH>
__global__ void __launch_bounds__(F32Product<TILE, SL>::NT, 3)
spamm_worklist_f32_kernel(const float* __restrict__ a,
                          const float* __restrict__ b,
                          const int* __restrict__ step_i,
                          const int* __restrict__ step_j,
                          const int* __restrict__ step_k,
                          const int* __restrict__ step_flags,
                          const int* __restrict__ runs,
                          float* __restrict__ out, int k, int n,
                          int block_n, int tile) {
  worklist_block<F32Product<TILE, SL>, CH>({}, a, b, step_i, step_j, step_k,
                                           step_flags, runs, out, k, n,
                                           block_n, tile);
}

template <int TILE, int SL>
__global__ void __launch_bounds__(Bf16Product<TILE, SL>::NT)
spamm_worklist_bf16_kernel(const __nv_bfloat16* __restrict__ a,
                           const __nv_bfloat16* __restrict__ b,
                           const int* __restrict__ step_i,
                           const int* __restrict__ step_j,
                           const int* __restrict__ step_k,
                           const int* __restrict__ step_flags,
                           const int* __restrict__ runs,
                           float* __restrict__ out, int k, int n,
                           int block_n, int tile) {
  worklist_block<Bf16Product<TILE, SL>, false>({}, a, b, step_i, step_j,
                                               step_k, step_flags, runs, out,
                                               k, n, block_n, tile);
}

template <int TILE, int SL>
__global__ void __launch_bounds__(Int8Product<TILE, SL>::NT)
spamm_worklist_int8_kernel(const signed char* __restrict__ a,
                           const signed char* __restrict__ b,
                           const float* __restrict__ a_scale,
                           const float* __restrict__ b_scale,
                           const int* __restrict__ step_i,
                           const int* __restrict__ step_j,
                           const int* __restrict__ step_k,
                           const int* __restrict__ step_flags,
                           const int* __restrict__ runs,
                           float* __restrict__ out, int k, int n,
                           int block_n, int tile) {
  using P = Int8Product<TILE, SL>;
  // the scales are the tiles': per (i, k) of A, per fine (k, j) of B
  const P prod{a_scale, b_scale, k / TILE, n / TILE, block_n,
               static_cast<int>(blockIdx.y) / SL};
  worklist_block<P, false>(prod, a, b, step_i, step_j, step_k, step_flags,
                           runs, out, k, n, block_n, tile);
}

// One block per (slice, i, j, column group × column slice) at T = SUB; per
// (slice, (i, j) × row band, column group × column sub-block × column
// slice) at T > SUB: the valid-k list kidx[slice, i, j, 0 .. nvalid) as ACC
// entries (INIT on the first, FLUSH on the last; one INIT|FLUSH entry when
// nvalid is 0, so the block writes zeros), chunk by chunk, through
// walk_list.
template <int TILE, int SL, bool CH>
__global__ void __launch_bounds__(F32Product<TILE, SL>::NT, 3)
spamm_dense_f32_kernel(const float* __restrict__ a,
                       const float* __restrict__ b,
                       const int* __restrict__ kidx,
                       const int* __restrict__ nvalid,
                       float* __restrict__ out, int m, int k, int n,
                       int gnb, int block_n, int tile) {
  using P = F32Product<TILE, SL>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int4 list[kListCap];
  const int t = walk_tile<P, CH>(tile);
  const int bands = t / P::SUB;
  const int pair = blockIdx.x / bands;  // i * gnb + j
  const int band = blockIdx.x % bands;
  const int i = pair / gnb;
  const int j = pair - i * gnb;
  const int slices = t / P::W;
  const int group = blockIdx.y / slices;
  const int slice = blockIdx.y % slices;
  const size_t col0 = static_cast<size_t>(group) * t + slice * P::W;
  const size_t z = blockIdx.z;
  const int gk = k / t;
  const size_t pair_id = z * (m / t) * gnb + pair;
  const int nv = nvalid[pair_id];
  const int* kl = kidx + pair_id * gk;
  const int total = nv > 0 ? nv : 1;
  typename P::Acc acc;
  P::zero(acc);
  for (int t0 = 0; t0 < total; t0 += kListCap) {
    const int cnt = min(kListCap, total - t0);
    __syncthreads();  // every thread is done with the previous chunk
    for (int e = threadIdx.x; e < cnt; e += P::NT) {
      const int s = t0 + e;
      const int f = (nv > 0 ? kAcc : 0) | (s == 0 ? kInit : 0) |
                    (s == total - 1 ? kFlush : 0);
      list[e] = make_int4(nv > 0 ? kl[s] : 0, i, j, f);
    }
    __syncthreads();
    walk_list<P, CH>(P{}, smem, list, cnt, a + z * m * k, k, b + z * k * n,
                     n, out + z * m * n, n, static_cast<size_t>(block_n) * t,
                     col0, static_cast<size_t>(band) * P::SUB, tile, acc);
  }
}

// Launches kernel `kern` with P's block size and ring, gridDim (x, y, z),
// after raising its dynamic shared-memory limit to the ring's size.
template <class P, class K, class... Args>
int launch(K kern, dim3 grid, cudaStream_t stream, Args... args) {
  constexpr int smem = P::STAGES * P::STAGE_BYTES;
  const cudaError_t rc = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  kern<<<grid, P::NT, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// The launches: at tile == TILE the kernel built for that tile, one block
// per run (or output block) and column group × slice; above it the chunked
// kernel, with R = tile / TILE row bands in gridDim.x and R column
// sub-blocks in gridDim.y.
template <int TILE, int SL>
int worklist_f32(const float* a, const float* b, const int* si,
                 const int* sj, const int* sk, const int* sf,
                 const int* runs, int num_runs, float* out, int k, int n,
                 int tile, int block_n, cudaStream_t st) {
  using P = F32Product<TILE, SL>;
  const int r = tile / TILE;
  if (r == 1)
    return launch<P>(spamm_worklist_f32_kernel<TILE, SL, false>,
                     dim3(num_runs, block_n * SL), st, a, b, si, sj, sk, sf,
                     runs, out, k, n, block_n, tile);
  return launch<P>(spamm_worklist_f32_kernel<TILE, SL, true>,
                   dim3(num_runs * r, block_n * r * SL), st, a, b, si, sj,
                   sk, sf, runs, out, k, n, block_n, tile);
}

// the mma.sync kernels: the tile TILE itself only (SPAMM_DISPATCH_MMA)
template <int TILE, int SL>
int worklist_bf16(const __nv_bfloat16* a, const __nv_bfloat16* b,
                  const int* si, const int* sj, const int* sk, const int* sf,
                  const int* runs, int num_runs, float* out, int k, int n,
                  int tile, int block_n, cudaStream_t st) {
  return launch<Bf16Product<TILE, SL>>(
      spamm_worklist_bf16_kernel<TILE, SL>,
      dim3(num_runs, block_n * SL), st, a, b, si, sj, sk, sf, runs, out, k,
      n, block_n, tile);
}

template <int TILE, int SL>
int worklist_int8(const signed char* a, const signed char* b, const float* sa,
                  const float* sb, const int* si, const int* sj,
                  const int* sk, const int* sf, const int* runs, int num_runs,
                  float* out, int k, int n, int tile, int block_n,
                  cudaStream_t st) {
  return launch<Int8Product<TILE, SL>>(
      spamm_worklist_int8_kernel<TILE, SL>,
      dim3(num_runs, block_n * SL), st, a, b, sa, sb, si, sj, sk, sf, runs,
      out, k, n, block_n, tile);
}

template <int TILE, int SL>
int dense_f32(const float* a, const float* b, const int* kidx,
              const int* nvalid, float* out, int batch, int m, int k, int n,
              int tile, int block_n, cudaStream_t st) {
  using P = F32Product<TILE, SL>;
  const int r = tile / TILE;
  const int gnb = n / (tile * block_n);
  if (r == 1)
    return launch<P>(spamm_dense_f32_kernel<TILE, SL, false>,
                     dim3((m / tile) * gnb, block_n * SL, batch), st, a, b,
                     kidx, nvalid, out, m, k, n, gnb, block_n, tile);
  return launch<P>(spamm_dense_f32_kernel<TILE, SL, true>,
                   dim3((m / tile) * gnb * r, block_n * r * SL, batch), st, a,
                   b, kidx, nvalid, out, m, k, n, gnb, block_n, tile);
}

// Calls F<SUB, SL>(args...) for the tiles the kernels take: tile a multiple
// of 16 up to kMaxTile, walked with SUB = sub_tile(tile), and slices 1 ..
// SUB/16 (a power of two, at most 4), so that a slice is at least 16
// columns wide. Anything else returns cudaErrorInvalidValue without
// launching.
#define SPAMM_DISPATCH(F, tile, slices, ...)                               \
  do {                                                                     \
    const int sub_ = sub_tile(tile);                                       \
    if (sub_ == 16 && (slices) == 1) return F<16, 1>(__VA_ARGS__);         \
    if (sub_ == 32 && (slices) == 1) return F<32, 1>(__VA_ARGS__);         \
    if (sub_ == 32 && (slices) == 2) return F<32, 2>(__VA_ARGS__);         \
    if (sub_ == 64 && (slices) == 1) return F<64, 1>(__VA_ARGS__);         \
    if (sub_ == 64 && (slices) == 2) return F<64, 2>(__VA_ARGS__);         \
    if (sub_ == 64 && (slices) == 4) return F<64, 4>(__VA_ARGS__);         \
    return static_cast<int>(cudaErrorInvalidValue);                        \
  } while (0)

// The same for the mma.sync tensor-core kernels (bf16, int8), which take
// only the tiles 16 and 32, each its own sub-tile: the tiles from 48 are
// the `wgmma` kernels' (spamm_wgmma.cu) and return cudaErrorInvalidValue
// here without launching.
#define SPAMM_DISPATCH_MMA(F, tile, slices, ...)                           \
  do {                                                                     \
    if ((tile) == 16 && (slices) == 1) return F<16, 1>(__VA_ARGS__);       \
    if ((tile) == 32 && (slices) == 1) return F<32, 1>(__VA_ARGS__);       \
    if ((tile) == 32 && (slices) == 2) return F<32, 2>(__VA_ARGS__);       \
    return static_cast<int>(cudaErrorInvalidValue);                        \
  } while (0)

}  // namespace

// Ring depth of the pipelined kernels: f32 (dtype 0), bf16 (1), int8 (2).
extern "C" int spamm_mm_stages(int dtype) {
  return dtype == 2 ? kStagesInt8 : dtype == 1 ? kStagesBf16 : kStagesF32;
}

// a: (m, k), b: (k, n) row-major float32, 16-byte aligned; step tables
// (S,) int32; runs (num_runs + 1,) int32 run boundaries into the step
// tables; out: (m, n) float32, zero-initialised and 16-byte aligned;
// slices: column slices per sub-tile-wide column block. tile a multiple of
// 16 up to 512 and slices 1 .. sub_tile(tile)/16 (a power of two, at most
// 4), else returns cudaErrorInvalidValue without launching. Returns
// cudaGetLastError().
extern "C" int spamm_mm_worklist_f32(const float* a, const float* b,
                                     const int* step_i, const int* step_j,
                                     const int* step_k, const int* step_flags,
                                     const int* runs, int num_runs,
                                     float* out, int m, int k, int n,
                                     int tile, int block_n, int slices,
                                     void* stream) {
  (void)m;
  SPAMM_DISPATCH(worklist_f32, tile, slices, a, b, step_i, step_j, step_k,
                 step_flags, runs, num_runs, out, k, n, tile, block_n,
                 static_cast<cudaStream_t>(stream));
}

// As spamm_mm_worklist_f32 with a: (m, k), b: (k, n) row-major bf16
// operands, tile 16 or 32; out stays float32.
extern "C" int spamm_mm_worklist_bf16(const __nv_bfloat16* a,
                                      const __nv_bfloat16* b,
                                      const int* step_i, const int* step_j,
                                      const int* step_k,
                                      const int* step_flags, const int* runs,
                                      int num_runs, float* out, int m, int k,
                                      int n, int tile, int block_n,
                                      int slices, void* stream) {
  (void)m;
  SPAMM_DISPATCH_MMA(worklist_bf16, tile, slices, a, b, step_i, step_j,
                     step_k, step_flags, runs, num_runs, out, k, n, tile,
                     block_n, static_cast<cudaStream_t>(stream));
}

// a: (m, k), b: (k, n) row-major int8 codes, 16-byte aligned; a_scale:
// (m/tile, k/tile), b_scale: (k/tile, n/tile) float32 per FINE tile; step
// tables, runs, out and slices as spamm_mm_worklist_f32; tile 16 or 32
// (else returns cudaErrorInvalidValue without launching). Returns
// cudaGetLastError().
extern "C" int spamm_mm_worklist_int8(const signed char* a,
                                      const signed char* b,
                                      const float* a_scale,
                                      const float* b_scale,
                                      const int* step_i, const int* step_j,
                                      const int* step_k,
                                      const int* step_flags, const int* runs,
                                      int num_runs, float* out, int m, int k,
                                      int n, int tile, int block_n,
                                      int slices, void* stream) {
  (void)m;
  SPAMM_DISPATCH_MMA(worklist_int8, tile, slices, a, b, a_scale, b_scale,
                     step_i, step_j, step_k, step_flags, runs, num_runs, out,
                     k, n, tile, block_n, static_cast<cudaStream_t>(stream));
}

// a: (batch, m, k), b: (batch, k, n) row-major float32, 16-byte aligned;
// kidx: (batch, m/tile, n/(tile·block_n), k/tile) int32 valid-k lists, the
// first nvalid entries of each in ascending order; nvalid: (batch, m/tile,
// n/(tile·block_n)) int32; out: (batch, m, n) float32, 16-byte aligned,
// every element written; slices: column slices per sub-tile-wide column
// block. tile and slices as spamm_mm_worklist_f32 (else returns
// cudaErrorInvalidValue without launching). Returns cudaGetLastError().
extern "C" int spamm_mm_dense_f32(const float* a, const float* b,
                                  const int* kidx, const int* nvalid,
                                  float* out, int batch, int m, int k, int n,
                                  int tile, int block_n, int slices,
                                  void* stream) {
  SPAMM_DISPATCH(dense_f32, tile, slices, a, b, kidx, nvalid, out, batch, m,
                 k, n, tile, block_n, static_cast<cudaStream_t>(stream));
}
