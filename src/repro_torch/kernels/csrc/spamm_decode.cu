// The f32 SpAMM work-list GEMM at decode: C[i, j] = Σ over the kept k of
// A[i, k] · B[k, j] for the first `rows` rows of A only, the rows that hold
// data. It replaces the Pallas TPU kernel
// src/repro/kernels/spamm_mm.py::spamm_mm_worklist
// (_spamm_mm_worklist_kernel) at f32 operands when a call has at most
// kMaxRows live rows (a decode step: the batch's rows, zero-padded by the
// caller to one 64-row tile); more rows, and every other operand type, run
// spamm_mm.cu's and spamm_wgmma.cu's kernels.
//
// What bounds it on an H100. A decode step of w2 (64(4) × 18432 × 4608)
// keeps about half of its 64 × 64 B tiles at vf 0.5: 170 MB of weight read
// once from HBM (0.051 ms at 3.35 TB/s) against 2·4·64·64 FMAs a kept tile
// (0.005 ms at 67 TFLOP/s), so the bytes. The 64-row kernel of spamm_mm.cu
// multiplies the 60 zero rows too (its padded FMAs alone cost 0.081 ms),
// copies the whole 64 × 64 A tile beside each B slice and keeps one stage
// in flight a block. And each output element is one chain of dependent
// FMAs (144 steps × 64 at w2): few outputs, each a long chain, so the
// latency of a step's FMAs and shared-memory loads, not their count, sets
// a block's pace. So here:
// 1. Live rows. The kernel is templated on RB ∈ {1, 2, 4, 8, 16}, the
//    live rows rounded up; a step copies RB × 64 floats of A (≤ 4 KB), not
//    the 64 × 64 tile, and computes RB rows. Rows at and above `rows` are
//    never written: they stay the caller's zeros.
// 2. The weight streams through a ring of kStagesDecode stages filled by
//    one producer warp with TMA 2-D copies (tma.cuh), each completed on the
//    stage's full barrier and freed by one arrival a consumer warp: a stage
//    holds a 64 × W box of B (rows k·T + kc·64, columns j·T·block_n +
//    group·T + piece·W) and the RB × 64 box of A at (row 0, column k·T +
//    kc·64). W is 32 (one 128-byte line a row) or 16. Four stages a block
//    and no L2 promotion measured best: a smaller ring puts more blocks on
//    an SM (launch/ablate_wgmma.py's f32 lines time the result).
// 3. Consumers: RB·W outputs over min(RB·W, kMaxConsumers) threads, thread
//    t owning CL = 1, 2 or 4 adjacent columns of row t / (W/CL), so that a
//    block's chains spread over the SM's four schedulers; the chunk's 64 q
//    are unrolled so the compiler issues the shared-memory loads well ahead
//    of their FMAs. Every output element is one fmaf chain, steps in table
//    order, K-chunks ascending, q ascending within a chunk: the order of
//    spamm_mm.cu's F32Product::compute, so on the live rows the kernel is
//    bit for bit the 64-row kernel (at any tile that is a multiple of 64,
//    the chunked one), frozen ≡ eager and graphed ≡ eager. No split over K,
//    no reordered sum, no tensor cores.
// 4. Grid: one block per (run, column group × column piece of W), at band 0
//    only (the live rows lie in the first row tile). The wrapper takes W =
//    32 when that gives a block an SM, else 16
//    (kernels/spamm_mm.py::decode_geometry): w1 decode's 288 runs give 576
//    blocks of 32 columns, w2's 72 give 144. The columns split without
//    reading a weight byte twice. The step list is worklist.cuh's.
#include <cuda.h>
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

// rows of a B box, depth of a K-chunk
constexpr int kBand = 64;
// ring depth
constexpr int kStagesDecode = 4;
// the most live rows a launch takes (the route's cut)
constexpr int kMaxRows = 16;
// the largest tile the kernel takes (kernels/spamm_mm.py::MAX_CUDA_TILE)
constexpr int kMaxTile = 512;
// L2 fetch size of the weight's copies
constexpr CUtensorMapL2promotion kPromotion =
    CU_TENSOR_MAP_L2_PROMOTION_NONE;

// the most consumer threads of a block (four warps)
constexpr int kMaxConsumers = 128;

// The block of RB live rows × W columns: its consumer threads, each owning
// CL adjacent columns of one row (one column while the block's RB·W
// outputs fit kMaxConsumers threads, so the work spreads over the SM's
// four schedulers; 2 or 4 above), and its ring stage.
template <int RB, int W>
struct Decode {
  static constexpr int LANES =                // consumer threads with outputs
      RB * W < kMaxConsumers ? RB * W : kMaxConsumers;
  static constexpr int CL = RB * W / LANES;   // columns a thread owns
  static constexpr int CPR = W / CL;          // threads along a row
  static constexpr int CONSUMERS = LANES < 32 ? 32 : LANES;
  static constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
  static constexpr int B_BYTES = kBand * W * 4;   // the 64 × W box of B
  static constexpr int A_BYTES = RB * kBand * 4;  // the RB × 64 box of A
  static constexpr int STAGE = B_BYTES + A_BYTES;
  static_assert(CL == 1 || CL == 2 || CL == 4, "columns a thread owns");
};

// dynamic shared memory of a launch: the ring and room to align it to 128
// bytes (a TMA destination's alignment)
template <class D>
constexpr int kDynamicBytes = kStagesDecode * D::STAGE + 128;

// CL floats at p (CL-aligned) as one vector load
template <int CL>
__device__ __forceinline__ void load_cols(const float* p, float (&v)[CL]) {
  if constexpr (CL == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else if constexpr (CL == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x, v[1] = x.y;
  } else {
    v[0] = *p;
  }
}

// acc += A row (64 floats at `a`) · B box columns (W-float rows at `b`),
// one fmaf per output and q, q ascending
template <int W, int CL>
__device__ __forceinline__ void chunk_product(const float* a, const float* b,
                                              float (&acc)[CL]) {
#pragma unroll
  for (int q = 0; q < kBand; q += 4) {
    const float4 av = *reinterpret_cast<const float4*>(a + q);
#pragma unroll
    for (int qq = 0; qq < 4; ++qq) {
      const float s = qq == 0 ? av.x : qq == 1 ? av.y : qq == 2 ? av.z : av.w;
      float bv[CL];
      load_cols<CL>(b + (q + qq) * W, bv);
#pragma unroll
      for (int j = 0; j < CL; ++j) acc[j] = fmaf(s, bv[j], acc[j]);
    }
  }
}

// One block per (run, column group × column piece): the run's flagged
// steps, list chunk by list chunk; the last warp loads, the others compute.
template <int RB, int W>
__global__ void __launch_bounds__(Decode<RB, W>::THREADS, 1)
spamm_worklist_f32_decode_kernel(const __grid_constant__ CUtensorMap ma,
                                 const __grid_constant__ CUtensorMap mb,
                                 const int* __restrict__ step_i,
                                 const int* __restrict__ step_j,
                                 const int* __restrict__ step_k,
                                 const int* __restrict__ step_flags,
                                 const int* __restrict__ runs,
                                 float* __restrict__ out, int n, int block_n,
                                 int tile, int rows) {
  using D = Decode<RB, W>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int4 list[kListCap];
  __shared__ int wsum[D::THREADS / 32];
  __shared__ __align__(8) uint64_t full[kStagesDecode];
  __shared__ __align__(8) uint64_t empty[kStagesDecode];
  unsigned char* ring =
      smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127);

  const int run = blockIdx.x;
  const int pieces = tile / W;  // column pieces of a tile-wide group
  const int group = blockIdx.y / pieces;
  const int col0 = group * tile + (blockIdx.y % pieces) * W;
  const int jstride = block_n * tile;
  const int chunks = tile / kBand;
  const bool producer = threadIdx.x >= D::CONSUMERS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStagesDecode; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], D::CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // a consumer's outputs: row r, columns c .. c + CL - 1 of the block
  const int r = threadIdx.x / D::CPR;
  const int c = D::CL * (threadIdx.x % D::CPR);
  const bool owns = threadIdx.x < D::LANES;
  float acc[D::CL] = {};
  int stage = 0;
  unsigned phase = producer ? 1u : 0u;  // the producer's first waits pass
  int base = runs[run];
  const int s1 = runs[run + 1];
  while (base < s1) {
    __syncthreads();  // both roles are done with the previous list chunk
    const int cnt = fill_worklist<D::THREADS>(list, wsum, step_i, step_j,
                                              step_k, step_flags, base, s1);
    if (producer) {
      if (threadIdx.x == D::CONSUMERS) {
        for (int e = 0; e < cnt; ++e) {
          const int4 en = list[e];
          // a run of another row tile holds no live row
          if (!(en.w & kAcc) || en.y != 0) continue;
          for (int kc = 0; kc < chunks; ++kc) {
            mbar_wait(&empty[stage], phase);
            unsigned char* st = ring + stage * D::STAGE;
            const int k0 = en.x * tile + kc * kBand;
            mbar_expect_tx(&full[stage], D::STAGE);
            tma_load_2d(st, &mb, en.z * jstride + col0, k0, &full[stage]);
            tma_load_2d(st + D::B_BYTES, &ma, k0, 0, &full[stage]);
            if (++stage == kStagesDecode) {
              stage = 0;
              phase ^= 1u;
            }
          }
        }
      }
    } else {
      for (int e = 0; e < cnt; ++e) {
        const int4 en = list[e];
        if (en.y != 0) continue;
        if (en.w & kInit)
#pragma unroll
          for (int j = 0; j < D::CL; ++j) acc[j] = 0.f;
        if (en.w & kAcc) {
          for (int kc = 0; kc < chunks; ++kc) {
            const unsigned char* st = ring + stage * D::STAGE;
            mbar_wait(&full[stage], phase);
            if (owns)
              chunk_product<W, D::CL>(
                  reinterpret_cast<const float*>(st + D::B_BYTES) + r * kBand,
                  reinterpret_cast<const float*>(st) + c, acc);
            // the warp's reads are done: one arrival a warp frees the stage
            __syncwarp();
            if (threadIdx.x % 32 == 0) mbar_arrive(&empty[stage]);
            if (++stage == kStagesDecode) {
              stage = 0;
              phase ^= 1u;
            }
          }
        }
        if ((en.w & kFlush) && owns && r < rows) {
          float* o = out + static_cast<size_t>(r) * n +
                     static_cast<size_t>(en.z) * jstride + col0 + c;
#pragma unroll
          for (int j = 0; j < D::CL; ++j) o[j] = acc[j];
        }
      }
    }
  }
}

// The launch at RB live rows and width W: one block per run and column
// group × column piece.
template <int RB, int W>
int decode_at(const float* a, const float* b, const int* si, const int* sj,
              const int* sk, const int* sf, const int* runs, int num_runs,
              float* out, int m, int k, int n, int tile, int block_n,
              int rows, cudaStream_t st) {
  using D = Decode<RB, W>;
  CUtensorMap ma, mb;
  if (!cached_map(&ma, a, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, m, k, RB,
                  kBand, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !cached_map(&mb, b, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, k, n, kBand, W,
                  CU_TENSOR_MAP_SWIZZLE_NONE, kPromotion))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_once<D>(spamm_worklist_f32_decode_kernel<RB, W>,
                        dim3(num_runs, block_n * (tile / W)), D::THREADS,
                        kDynamicBytes<D>, st, ma, mb, si, sj, sk, sf, runs,
                        out, n, block_n, tile, rows);
}

}  // namespace

// a: (m, k), b: (k, n) row-major float32, 16-byte aligned, a's rows at and
// above `rows` zero; step tables (S,) int32; runs (num_runs + 1,) int32 run
// boundaries into the step tables; out: (m, n) float32, zero-initialised:
// rows below `rows` written, the rest left as they are. tile a multiple of
// 64 up to 512, rows 1 .. kMaxRows (at most the tile), width 16 or 32.
// Else returns cudaErrorInvalidValue without launching. Returns
// cudaGetLastError().
extern "C" int spamm_decode_worklist_f32(const float* a, const float* b,
                                         const int* step_i,
                                         const int* step_j,
                                         const int* step_k,
                                         const int* step_flags,
                                         const int* runs, int num_runs,
                                         float* out, int m, int k, int n,
                                         int tile, int block_n, int rows,
                                         int width, void* stream) {
  if (tile % kBand || tile < kBand || tile > kMaxTile || rows < 1 ||
      rows > kMaxRows || m < kBand)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const int rb = rows <= 1 ? 1 : rows <= 2 ? 2 : rows <= 4 ? 4
                                 : rows <= 8 ? 8 : 16;
#define SPAMM_DECODE_AT(RB, W)                                              \
  if (rb == RB && width == W)                                              \
    return decode_at<RB, W>(a, b, step_i, step_j, step_k, step_flags, runs, \
                            num_runs, out, m, k, n, tile, block_n, rows, st);
  SPAMM_DECODE_AT(1, 16)
  SPAMM_DECODE_AT(1, 32)
  SPAMM_DECODE_AT(2, 16)
  SPAMM_DECODE_AT(2, 32)
  SPAMM_DECODE_AT(4, 16)
  SPAMM_DECODE_AT(4, 32)
  SPAMM_DECODE_AT(8, 16)
  SPAMM_DECODE_AT(8, 32)
  SPAMM_DECODE_AT(16, 16)
  SPAMM_DECODE_AT(16, 32)
#undef SPAMM_DECODE_AT
  return static_cast<int>(cudaErrorInvalidValue);
}
