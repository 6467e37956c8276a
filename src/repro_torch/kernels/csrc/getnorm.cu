// Get-norm kernels (paper §3.2): per-(t×t)-tile Frobenius norms of a 2-D
// float32 matrix, the `normmap` the SpAMM gate reads; the same norms of the
// matrix's per-tile int8 view fused with its quantization scales; and one
// level of the norm pyramid pooled from a normmap.
//
// tile_norms replaces the Pallas TPU kernel
// src/repro/kernels/getnorm.py::tile_norms (bodies _getnorm_kernel and
// _tile_sumsq, use_mxu=False). tile_norms_quant replaces
// src/repro/kernels/getnorm.py::tile_norms_quant (body
// _getnorm_quant_kernel): per tile, scale = max(amax, 1e-30)·f32(1/127),
// q = clip(rint(x / scale), ±127), and the norm of the dequantized tile
// q·scale, from one launch.
//
// What bounds them on an H100: bytes. Every element is read once (4 B) for
// 2 flops (9 in the int8 variant), far below the ~20 flop/B where f32 CUDA
// cores would take over, so the least time is M·K·4 B over the 3.35 TB/s
// of HBM3. A streaming reduction at 0.5 flop/B has no use for TMA or wgmma:
// what it needs is enough loads in flight, about 16–32 KB per SM.
//
// Design (tiles 16, 32 and 64, the tiles the work-list kernels take): the
// walk is a template on the tile, so each thread's loads are a fixed-count
// unrolled array, all in flight before the first fmaf, and the tile stays in
// the thread's registers (16 floats at tile 64). 16-byte loads when the row
// stride and base allow it, else 4-byte ones. Load j of a tile's thread t is
// the tile's load t + j·T, T = min(256, loads per tile): 256 threads per
// tile at tiles 32 and 64, one 256-thread block each (at tile 64 a block
// has 16 KB in flight); 64 threads per tile at tile 16 with 16-byte loads,
// so a block takes four neighbouring tiles and no thread idles. Each thread
// squares and sums its registers in order (fmaf), then a warp-shuffle tree
// and the tile's warp sums in its first warp (tile_sum) give the total.
// tile_norms_quant takes max|x| from the same registers (a shuffle tree and
// one barrier, tile_max), then quantizes, dequantizes and sums the squares
// from them: the tile is read from memory once. Any other tile takes the
// runtime-tile kernels (*_any_*), one 256-thread block per tile walking it
// in a loop over a run-time count (and reading it twice for the int8
// variant). At w1 both templated kernels run at the bytes bound; at the
// activation shapes (one or a few blocks per SM) the int8 kernel's time is
// its exact division, __fdiv_rn, whose per-element check branches to a
// slow path: a multiply by the reciprocal would halve it but move the
// quantizer's bits, so the division stays (launch/ablate_getnorm.py).
//
// The bits: every path sums with the same element-to-thread assignment,
// the same fmaf order within a thread and the same tree (tile_sum). A tile
// of 64 threads is the tree a 256-thread block gives when its other warps
// hold zeros, and adding a zero partial is exact. So the templated kernels
// give the runtime-tile kernels' output bit for bit. The division, rint and
// dequantizing multiply are __fdiv_rn / rintf / __fmul_rn, which nvcc never
// contracts: on the card the fused norms are bit-identical to tile_norms run
// on the dequantized matrix (on the same load path: 16-byte and 4-byte
// loads split a tile among threads differently), and the scales to the
// per-tile quantizer's (the reference's own contract,
// getnorm.py:57-74).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kTiny = 1e-30f;
constexpr float kInv127 = 1.0f / 127.0f;  // f32(1)/f32(127), as the quantizer

// Calls op(v) for every element v of the (tile × tile) tile at `base` (row
// stride k) that this thread owns: 16-byte loads when `vec`, else scalars.
// The assignment of elements to threads and their order within a thread
// are fixed, so every caller sums in the same order.
template <class Op>
__device__ __forceinline__ void tile_walk(const float* __restrict__ base,
                                          int k, int tile, int vec, Op op) {
  if (vec) {
    const int tq = tile / 4;  // float4 loads per tile row
    const int n = tile * tq;
    for (int e = threadIdx.x; e < n; e += kThreads) {
      const int r = e / tq;
      const int c = e - r * tq;
      const float4 v =
          reinterpret_cast<const float4*>(base + static_cast<size_t>(r) * k)[c];
      op(v.x);
      op(v.y);
      op(v.z);
      op(v.w);
    }
  } else {
    const int n = tile * tile;
    for (int e = threadIdx.x; e < n; e += kThreads) {
      const int r = e / tile;
      const int c = e - r * tile;
      op(base[static_cast<size_t>(r) * k + c]);
    }
  }
}

// The loads of one templated (TILE × TILE) tile: 16-byte ones when VEC,
// else 4-byte; T = kTileThreads threads per tile hold kPer loads each, the
// walk's assignment with every thread that holds a load and no other.
template <int TILE, bool VEC>
struct TileShape {
  static constexpr int kTile = TILE;
  static constexpr bool kVec = VEC;
  static constexpr int kWidth = VEC ? 4 : 1;       // floats per load
  static constexpr int kRowLoads = TILE / kWidth;  // loads per tile row
  static constexpr int kLoads = TILE * kRowLoads;  // loads per tile
  static constexpr int kTileThreads = kLoads < kThreads ? kLoads : kThreads;
  static constexpr int kPer = kLoads / kTileThreads;  // loads per thread
  static constexpr int kRegs = kPer * kWidth;         // floats per thread
  static constexpr int kTilesPerBlock = kThreads / kTileThreads;
  static_assert(kTileThreads % 32 == 0 && kLoads % kTileThreads == 0,
                "a tile takes whole warps, each thread the same loads");
};

// Thread t's elements of the tile at `base` (row stride k), in the walk's
// order: load j is the tile's load t + j·kTileThreads. The loop is unrolled,
// so every load is in flight before the first is used.
template <class S>
__device__ __forceinline__ void load_tile(const float* __restrict__ base,
                                          int k, int t,
                                          float (&v)[S::kRegs]) {
#pragma unroll
  for (int j = 0; j < S::kPer; ++j) {
    const int e = t + j * S::kTileThreads;
    const int r = e / S::kRowLoads;
    const int c = e % S::kRowLoads;
    const float* p = base + static_cast<size_t>(r) * k + c * S::kWidth;
    if constexpr (S::kVec) {
      const float4 q = *reinterpret_cast<const float4*>(p);
      v[4 * j] = q.x;
      v[4 * j + 1] = q.y;
      v[4 * j + 2] = q.z;
      v[4 * j + 3] = q.w;
    } else {
      v[j] = *p;
    }
  }
}

// Sum of the partial sums of a tile's NT threads (NT/32 whole warps of the
// block, the tile's own): a warp-shuffle tree, then the NT/32 warp sums in
// the tile's first warp. The total is valid in the tile's first thread.
// NT = kThreads is the one-tile-per-block tree; a tile of two warps gets
// the sum that tree gives when warps 2–7 hold zeros (s0 + s1).
template <int NT>
__device__ __forceinline__ float tile_sum(float s) {
  __shared__ float warp_sums[kThreads / 32];
  constexpr int kWarps = NT / 32;
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, off);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = s;
  __syncthreads();
  const int first = warp - warp % kWarps;
  if (warp == first) {
    s = lane < kWarps ? warp_sums[first + lane] : 0.f;
    for (int off = kWarps / 2; off > 0; off >>= 1) {
      s += __shfl_down_sync(0xffffffffu, s, off);
    }
  }
  return s;
}

// Max over a tile's NT threads, returned to each of them: a butterfly in
// each warp, then the tile's warp maxima after one barrier.
template <int NT>
__device__ __forceinline__ float tile_max(float m) {
  __shared__ float warp_max[kThreads / 32];
  constexpr int kWarps = NT / 32;
  for (int off = 16; off > 0; off >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) warp_max[warp] = m;
  __syncthreads();
  const int first = warp - warp % kWarps;
  m = warp_max[first];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, warp_max[first + w]);
  return m;
}

// Block-wide max over NT threads, returned to every thread.
template <int NT>
__device__ __forceinline__ float block_max(float m) {
  __shared__ float warp_max[NT / 32];
  __shared__ float total;
  for (int off = 16; off > 0; off >>= 1) {
    m = fmaxf(m, __shfl_down_sync(0xffffffffu, m, off));
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = warp_max[0];
    for (int w = 1; w < NT / 32; ++w) t = fmaxf(t, warp_max[w]);
    total = t;
  }
  __syncthreads();
  return total;
}

// The int8 view of v under `scale`, dequantized: q = clip(rint(v / scale),
// ±127), then q·scale, with the quantizer's roundings and no contraction.
__device__ __forceinline__ float dequantized(float v, float scale) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.f), 127.f);
  return __fmul_rn(q, scale);
}

// The templated kernels' tiles: tile `id` of the (M/t, K/t) grid, row-major
// (ids past the last tile of a partly filled block load the last tile and
// store nothing). Sets this thread's index t within its tile and loads its
// elements of the tile into v.
template <class S>
__device__ __forceinline__ int load_block_tile(const float* __restrict__ x,
                                               int k, int gk, int tiles,
                                               int& t, float (&v)[S::kRegs]) {
  t = threadIdx.x % S::kTileThreads;
  const int id = blockIdx.x * S::kTilesPerBlock + threadIdx.x / S::kTileThreads;
  const int at = id < tiles ? id : tiles - 1;
  const int ti = at / gk;
  const int tj = at - ti * gk;
  load_tile<S>(x + static_cast<size_t>(ti) * S::kTile * k +
                   static_cast<size_t>(tj) * S::kTile,
               k, t, v);
  return id;
}

template <class S>
__global__ void __launch_bounds__(kThreads)
tile_norms_f32_kernel(const float* __restrict__ x, float* __restrict__ out,
                      int k, int gk, int tiles) {
  int t;
  float v[S::kRegs];
  const int id = load_block_tile<S>(x, k, gk, tiles, t, v);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < S::kRegs; ++i) s = fmaf(v[i], v[i], s);
  s = tile_sum<S::kTileThreads>(s);
  if (t == 0 && id < tiles) out[id] = sqrtf(s);
}

template <class S>
__global__ void __launch_bounds__(kThreads)
tile_norms_quant_f32_kernel(const float* __restrict__ x,
                            float* __restrict__ norms,
                            float* __restrict__ scales, int k, int gk,
                            int tiles) {
  int t;
  float v[S::kRegs];
  const int id = load_block_tile<S>(x, k, gk, tiles, t, v);
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < S::kRegs; ++i) m = fmaxf(m, fabsf(v[i]));
  const float scale =
      __fmul_rn(fmaxf(tile_max<S::kTileThreads>(m), kTiny), kInv127);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < S::kRegs; ++i) {
    const float dq = dequantized(v[i], scale);
    s = fmaf(dq, dq, s);
  }
  s = tile_sum<S::kTileThreads>(s);
  if (t == 0 && id < tiles) {
    norms[id] = sqrtf(s);
    scales[id] = scale;
  }
}

// The runtime-tile kernels: any tile, one 256-thread block per tile, the
// grid (K/t, M/t).
__global__ void __launch_bounds__(kThreads)
tile_norms_any_f32_kernel(const float* __restrict__ x, float* __restrict__ out,
                          int k, int tile, int vec) {
  const int tj = blockIdx.x;
  const int ti = blockIdx.y;
  const int gk = gridDim.x;
  const float* base = x + static_cast<size_t>(ti) * tile * k +
                      static_cast<size_t>(tj) * tile;
  float s = 0.f;
  tile_walk(base, k, tile, vec, [&](float v) { s = fmaf(v, v, s); });
  s = tile_sum<kThreads>(s);
  if (threadIdx.x == 0) {
    out[static_cast<size_t>(ti) * gk + tj] = sqrtf(s);
  }
}

__global__ void __launch_bounds__(kThreads)
tile_norms_quant_any_f32_kernel(const float* __restrict__ x,
                                float* __restrict__ norms,
                                float* __restrict__ scales, int k, int tile,
                                int vec) {
  const int tj = blockIdx.x;
  const int ti = blockIdx.y;
  const int gk = gridDim.x;
  const float* base = x + static_cast<size_t>(ti) * tile * k +
                      static_cast<size_t>(tj) * tile;
  float m = 0.f;
  tile_walk(base, k, tile, vec, [&](float v) { m = fmaxf(m, fabsf(v)); });
  const float scale =
      __fmul_rn(fmaxf(block_max<kThreads>(m), kTiny), kInv127);
  float s = 0.f;
  tile_walk(base, k, tile, vec, [&](float v) {
    const float dq = dequantized(v, scale);
    s = fmaf(dq, dq, s);
  });
  s = tile_sum<kThreads>(s);
  if (threadIdx.x == 0) {
    const size_t o = static_cast<size_t>(ti) * gk + tj;
    norms[o] = sqrtf(s);
    scales[o] = scale;
  }
}

// tile_norms(use_mxu=True) and tile_norms_quant(use_mxu=True) replace the
// MXU branch of the Pallas body _tile_sumsq (src/repro/kernels/getnorm.py,
// use_mxu=True, under _getnorm_kernel and _getnorm_quant_kernel): the
// paper's tensor-core reduction, Eq. 3-4. The tile's sum of squares is taken
// as two products against ones: Eq. 3, the row sums D = SQ·1, then Eq. 4,
// their total 1ᵀ·D.
//
// What bounds it on an H100: bytes, as the CUDA-core variant (M·K·4 B read
// once). Design: one 128-thread block (4 warps) per tile, the grid (K/t,
// M/t), t % 16 == 0. Warp w owns the 16-row strips w, w+4, ... of the tile;
// lane (g = lane/4, q = lane%4) loads 16-byte vectors of rows g and g+8 of
// the strip (a quad of lanes covers 64 contiguous bytes of a row) and feeds
// the squares as the A operand of mma.sync.m16n8k8 TF32 against a B of ones,
// accumulating the strip's 16 row sums in f32 (Eq. 3). The row sums go to
// shared memory; warp 0 then issues ones(16×8)·rows(8×8 chunk) over the
// t/8 chunks (Eq. 4) and thread 0 writes sqrt of the total.
//
// f32 accuracy from TF32 inputs: each square (and each row sum) is split as
// hi = rna_tf32(v), lo = rna_tf32(v − hi) — v − hi is exact in f32 — and both
// halves are multiplied by the ones, so each element enters the sum with a
// relative error of about 2⁻²² (the ones are exact in TF32, so the third
// term of a 3×TF32 product vanishes). The square and the difference are
// __fmul_rn/__fsub_rn (never contracted into an FMA). Both kernels sum
// through ONE device function (mxu_tile_sumsq: the same element-to-lane
// assignment, the same mma sequence), so on the card the fused norms are
// bit-identical to the plain kernel run on the dequantized matrix.
constexpr int kMxuThreads = 128;
constexpr int kMxuWarps = kMxuThreads / 32;
constexpr uint32_t kOneTf32 = 0x3f800000u;  // 1.0f, exact in TF32

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// d += A·B for one m16n8k8 TF32 product with f32 accumulation: a0..a3 are
// this lane's A fragment (rows g, g+8 of columns q, q+4), b0/b1 its B
// fragment (rows q, q+4 of column g).
__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Eq. 3 step: d += SQ·1 for the four f32 squares of this lane's A fragment,
// as hi·1 + lo·1.
__device__ __forceinline__ void rowsum_step(float (&d)[4], float s0, float s1,
                                            float s2, float s3) {
  const uint32_t h0 = tf32_rna(s0), h1 = tf32_rna(s1);
  const uint32_t h2 = tf32_rna(s2), h3 = tf32_rna(s3);
  mma_tf32(d, h0, h1, h2, h3, kOneTf32, kOneTf32);
  mma_tf32(d, tf32_rna(__fsub_rn(s0, __uint_as_float(h0))),
           tf32_rna(__fsub_rn(s1, __uint_as_float(h1))),
           tf32_rna(__fsub_rn(s2, __uint_as_float(h2))),
           tf32_rna(__fsub_rn(s3, __uint_as_float(h3))), kOneTf32, kOneTf32);
}

__device__ __forceinline__ float4 load4(const float* __restrict__ base, int k,
                                        int r, int c, int vec) {
  const float* p = base + static_cast<size_t>(r) * k + c;
  if (vec) return *reinterpret_cast<const float4*>(p);
  return make_float4(p[0], p[1], p[2], p[3]);
}

// Calls op(u, v) for every 4-column group this lane owns: u from row 16s+g,
// v from row 16s+g+8 of each strip s of warp w, at columns c+4q..c+4q+3 of
// each 16-column segment c. `strip_done(s)` runs after each strip.
template <class Op, class Done>
__device__ __forceinline__ void strip_walk(const float* __restrict__ base,
                                           int k, int tile, int vec, Op op,
                                           Done strip_done) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  for (int s = warp; s < tile / 16; s += kMxuWarps) {
    for (int c = 0; c < tile; c += 16) {
      op(load4(base, k, 16 * s + g, c + 4 * q, vec),
         load4(base, k, 16 * s + g + 8, c + 4 * q, vec));
    }
    strip_done(s);
  }
}

// Sum of squares of f(v) over the (tile × tile) tile at `base` on the tensor
// cores (Eq. 3-4); `rows` is `tile` floats of shared memory. Every thread
// of the block calls it; the total is valid in thread 0.
template <class F>
__device__ __forceinline__ float mxu_tile_sumsq(const float* __restrict__ base,
                                                int k, int tile, int vec, F f,
                                                float* rows) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  auto sq = [&](float v) {
    const float x = f(v);
    return __fmul_rn(x, x);
  };
  strip_walk(
      base, k, tile, vec,
      [&](float4 u, float4 v) {
        rowsum_step(d, sq(u.x), sq(v.x), sq(u.y), sq(v.y));
        rowsum_step(d, sq(u.z), sq(v.z), sq(u.w), sq(v.w));
      },
      [&](int s) {
        // every column of D holds the row sum: D[g][2q] and D[g+8][2q]
        if (q == 0) {
          rows[16 * s + g] = d[0];
          rows[16 * s + g + 8] = d[2];
        }
        d[0] = d[1] = d[2] = d[3] = 0.f;
      });
  __syncthreads();
  if (threadIdx.x >= 32) return 0.f;
  // Eq. 4: D = ones(16×8) · R, R's column g = the chunk rows[c..c+7]
  for (int c = 0; c < tile; c += 8) {
    const float r0 = rows[c + q], r1 = rows[c + q + 4];
    const uint32_t h0 = tf32_rna(r0), h1 = tf32_rna(r1);
    mma_tf32(d, kOneTf32, kOneTf32, kOneTf32, kOneTf32, h0, h1);
    mma_tf32(d, kOneTf32, kOneTf32, kOneTf32, kOneTf32,
             tf32_rna(__fsub_rn(r0, __uint_as_float(h0))),
             tf32_rna(__fsub_rn(r1, __uint_as_float(h1))));
  }
  return d[0];
}

__global__ void __launch_bounds__(kMxuThreads)
tile_norms_mxu_f32_kernel(const float* __restrict__ x, float* __restrict__ out,
                          int k, int tile, int vec) {
  extern __shared__ float rows[];
  const int tj = blockIdx.x;
  const int ti = blockIdx.y;
  const float* base = x + static_cast<size_t>(ti) * tile * k +
                      static_cast<size_t>(tj) * tile;
  const float s =
      mxu_tile_sumsq(base, k, tile, vec, [](float v) { return v; }, rows);
  if (threadIdx.x == 0) {
    out[static_cast<size_t>(ti) * gridDim.x + tj] = sqrtf(s);
  }
}

__global__ void __launch_bounds__(kMxuThreads)
tile_norms_quant_mxu_f32_kernel(const float* __restrict__ x,
                                float* __restrict__ norms,
                                float* __restrict__ scales, int k, int tile,
                                int vec) {
  extern __shared__ float rows[];
  const int tj = blockIdx.x;
  const int ti = blockIdx.y;
  const float* base = x + static_cast<size_t>(ti) * tile * k +
                      static_cast<size_t>(tj) * tile;
  float m = 0.f;
  auto amax = [&](float4 u) {
    m = fmaxf(m, fmaxf(fmaxf(fabsf(u.x), fabsf(u.y)),
                       fmaxf(fabsf(u.z), fabsf(u.w))));
  };
  strip_walk(
      base, k, tile, vec, [&](float4 u, float4 v) { amax(u); amax(v); },
      [](int) {});
  const float scale =
      __fmul_rn(fmaxf(block_max<kMxuThreads>(m), kTiny), kInv127);
  const float s = mxu_tile_sumsq(
      base, k, tile, vec, [&](float v) { return dequantized(v, scale); },
      rows);
  if (threadIdx.x == 0) {
    const size_t o = static_cast<size_t>(ti) * gridDim.x + tj;
    norms[o] = sqrtf(s);
    scales[o] = scale;
  }
}

// pool_norms replaces the Pallas TPU kernel
// src/repro/kernels/getnorm.py::pool_norms (body _pool_kernel): one pyramid
// level, out[s, r, c] = sqrt of the sum of squares of the 2×2 group of fine
// norms at rows 2r, 2r+1 and columns 2c, 2c+1 of slice s, with entries past
// a ragged (odd) edge taken as zero.
//
// What bounds it on an H100: bytes, and at the sizes the planner pools
// (normmaps of at most a few hundred tiles a side: 256×256 is 0.26 MB) the
// launch latency long before them. Design: one thread per coarse entry,
// slice-major, so a warp covers 32 neighbouring coarse columns and reads 64
// neighbouring fine norms of each of the two rows. A leading slice count
// covers the 3-D normmaps of per-expert weights; the row and column pairs
// are indexed inside one slice, so no pair crosses slices when gm or gk is
// odd. The sum keeps the TPU body's order, row pairs first, then the
// column pair: (r0c0² + r1c0²) + (r0c1² + r1c1²). __fmul_rn/__fadd_rn keep
// nvcc from contracting a product and a sum into an FMA, so the result is
// the plain version's, rounding for rounding.
__global__ void __launch_bounds__(kThreads)
pool_norms_f32_kernel(const float* __restrict__ x, float* __restrict__ out,
                      int gm, int gk, int gmc, int gkc, long long total) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (e >= total) return;
  const int c = static_cast<int>(e % gkc);
  const long long rs = e / gkc;
  const int r = static_cast<int>(rs % gmc);
  const long long s = rs / gmc;
  const float* xs = x + s * gm * gk;
  const int r0 = 2 * r;
  const int c0 = 2 * c;
  const bool has_r1 = r0 + 1 < gm;
  const bool has_c1 = c0 + 1 < gk;
  const float v00 = xs[static_cast<size_t>(r0) * gk + c0];
  const float v10 = has_r1 ? xs[static_cast<size_t>(r0 + 1) * gk + c0] : 0.f;
  const float v01 = has_c1 ? xs[static_cast<size_t>(r0) * gk + c0 + 1] : 0.f;
  const float v11 = (has_r1 && has_c1)
                        ? xs[static_cast<size_t>(r0 + 1) * gk + c0 + 1]
                        : 0.f;
  const float col0 = __fadd_rn(__fmul_rn(v00, v00), __fmul_rn(v10, v10));
  const float col1 = __fadd_rn(__fmul_rn(v01, v01), __fmul_rn(v11, v11));
  out[e] = sqrtf(__fadd_rn(col0, col1));
}

// Calls launch(S{}) with the TileShape of a templated tile (16, 32, 64) and
// returns true; returns false for any other tile.
template <class F>
bool templated_tile(int tile, int vec, F&& launch) {
  switch (tile) {
    case 16:
      vec ? launch(TileShape<16, true>{}) : launch(TileShape<16, false>{});
      return true;
    case 32:
      vec ? launch(TileShape<32, true>{}) : launch(TileShape<32, false>{});
      return true;
    case 64:
      vec ? launch(TileShape<64, true>{}) : launch(TileShape<64, false>{});
      return true;
    default:
      return false;
  }
}

// 16-byte loads when the tile width, the row stride and the base allow them.
int vec_loads(const float* x, int k, int tile) {
  return (tile % 4 == 0) && (k % 4 == 0) &&
         (reinterpret_cast<uintptr_t>(x) % 16 == 0);
}

template <class S>
unsigned tile_blocks(int tiles) {
  return static_cast<unsigned>((tiles + S::kTilesPerBlock - 1) /
                               S::kTilesPerBlock);
}

}  // namespace

// x: (m, k) row-major float32, m % tile == 0 == k % tile; out: (m/tile,
// k/tile) float32. Launches on `stream` and returns cudaGetLastError().
extern "C" int spamm_tile_norms_f32(const float* x, float* out, int m, int k,
                                    int tile, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const int vec = vec_loads(x, k, tile);
  const int gk = k / tile;
  const int tiles = (m / tile) * gk;
  const bool templated = templated_tile(tile, vec, [&](auto shape) {
    using S = decltype(shape);
    tile_norms_f32_kernel<S><<<tile_blocks<S>(tiles), kThreads, 0, st>>>(
        x, out, k, gk, tiles);
  });
  if (!templated) {
    tile_norms_any_f32_kernel<<<dim3(gk, m / tile), kThreads, 0, st>>>(
        x, out, k, tile, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

// x: (m, k) row-major float32, m % tile == 0 == k % tile; norms, scales:
// (m/tile, k/tile) float32. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int spamm_tile_norms_quant_f32(const float* x, float* norms,
                                          float* scales, int m, int k,
                                          int tile, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const int vec = vec_loads(x, k, tile);
  const int gk = k / tile;
  const int tiles = (m / tile) * gk;
  const bool templated = templated_tile(tile, vec, [&](auto shape) {
    using S = decltype(shape);
    tile_norms_quant_f32_kernel<S><<<tile_blocks<S>(tiles), kThreads, 0,
                                     st>>>(x, norms, scales, k, gk, tiles);
  });
  if (!templated) {
    tile_norms_quant_any_f32_kernel<<<dim3(gk, m / tile), kThreads, 0, st>>>(
        x, norms, scales, k, tile, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

// x: (slices, gm, gk) row-major float32 normmaps; out: (slices, ⌈gm/2⌉,
// ⌈gk/2⌉) float32. Launches on `stream` and returns cudaGetLastError().
extern "C" int spamm_pool_norms_f32(const float* x, float* out, int slices,
                                    int gm, int gk, void* stream) {
  const int gmc = (gm + 1) / 2;
  const int gkc = (gk + 1) / 2;
  const long long total = static_cast<long long>(slices) * gmc * gkc;
  const long long blocks = (total + kThreads - 1) / kThreads;
  pool_norms_f32_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      x, out, gm, gk, gmc, gkc, total);
  return static_cast<int>(cudaGetLastError());
}

// x: (m, k) row-major float32, m % tile == 0 == k % tile, tile % 16 == 0;
// out: (m/tile, k/tile) float32 — the tensor-core (Eq. 3-4) tile norms.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int spamm_tile_norms_mxu_f32(const float* x, float* out, int m,
                                        int k, int tile, void* stream) {
  const dim3 grid(k / tile, m / tile);
  const int vec = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  tile_norms_mxu_f32_kernel<<<grid, kMxuThreads, tile * sizeof(float),
                              static_cast<cudaStream_t>(stream)>>>(x, out, k,
                                                                   tile, vec);
  return static_cast<int>(cudaGetLastError());
}

// As spamm_tile_norms_quant_f32, with the tensor-core sum; tile % 16 == 0.
extern "C" int spamm_tile_norms_quant_mxu_f32(const float* x, float* norms,
                                              float* scales, int m, int k,
                                              int tile, void* stream) {
  const dim3 grid(k / tile, m / tile);
  const int vec = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  tile_norms_quant_mxu_f32_kernel<<<grid, kMxuThreads, tile * sizeof(float),
                                    static_cast<cudaStream_t>(stream)>>>(
      x, norms, scales, k, tile, vec);
  return static_cast<int>(cudaGetLastError());
}
