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
// its exact division, __fdiv_rn: a multiply by the reciprocal would cut it
// but move the quantizer's bits, so the division stays. A zero dividend
// (most of a zero-padded decode tile) would branch to the division's slow
// path; it divides the scale in its place (dequantized), the same bits
// (launch/ablate_getnorm.py, variant div_zeros).
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
// each warp, then (a tile of several warps) the tile's warp maxima after
// one barrier.
template <int NT>
__device__ __forceinline__ float tile_max(float m) {
  __shared__ float warp_max[kThreads / 32];
  constexpr int kWarps = NT / 32;
  for (int off = 16; off > 0; off >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  if constexpr (kWarps == 1) return m;
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) warp_max[warp] = m;
  __syncthreads();
  const int first = warp - warp % kWarps;
  m = warp_max[first];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, warp_max[first + w]);
  return m;
}

// The int8 view of v under `scale`, dequantized: q = clip(rint(v / scale),
// ±127), then q·scale, with the quantizer's roundings and no contraction.
// A zero dividend takes the exact division's slow path, and 0 / scale is
// the zero itself: a zero divides the scale instead and keeps its own
// value, without a branch, so the result is the division's bit for bit.
__device__ __forceinline__ float dequantized(float v, float scale) {
  const float d = rintf(__fdiv_rn(v == 0.f ? scale : v, scale));
  const float q = fminf(fmaxf(v == 0.f ? v : d, -127.f), 127.f);
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
      __fmul_rn(fmaxf(tile_max<kThreads>(m), kTiny), kInv127);
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
// as products against ones: Eq. 3, the row sums R = SQ·1, then Eq. 4, their
// total 1ᵀ·R.
//
// What bounds it on an H100: bytes, as the CUDA-core variant (M·K·4 B read
// once); at the activation shapes (one or a few blocks per SM) the chain of
// one block: its loads, its products and its barriers.
//
// Design. A tile (t % 16 == 0) is t/16 strips of 16 rows, each t/16
// segments of 16 columns. A warp sums one unit: a whole strip, or at tile
// 64 a run of kSegs64 of its segments. Lane (g = lane/4, q = lane%4) loads,
// per segment, 16 bytes of rows g and g+8 at columns 4q..4q+3 (a quad of
// lanes covers 64 contiguous bytes of a row). Eq. 3 is mma.sync.m16n8k8
// TF32 of the squares against a B of ones, in kChains independent
// accumulators (float j of each load goes to chain j % kChains), so a warp
// has products in flight where one chain would wait on each; one more
// product against ones sums the chains into the unit's 16 row sums (lane
// q gives chain q). Two chains: one and four were slower at the activation
// shapes (launch/ablate_getnorm.py). Eq. 4 is three products with A = ones:
// column g of B takes row sums g and g+8; the eight column sums fold into
// two (even and odd columns); the odd sum goes onto the even one in the
// same accumulator. A tile of several units sums their totals after one
// barrier, four to a product (column 0 of B). No sum is taken on the CUDA
// cores.
//
// Templated tiles (16, 32, 64): every load of a lane is issued before the
// first product and the unit stays in registers (8 float4 a lane at tile
// 64). One warp per unit: one tile per warp at tile 16, four tiles to a
// 128-thread block; two warps and two tiles per block at tile 32; four
// warps at tile 64 (eight, kSegs64 = 2, shorten the decode chain but cost
// the int8 kernel a fifth more at w1). A flat grid over the tiles;
// ids past the last tile of a partly filled block load the last tile and
// store nothing. The int8 kernel takes max|x| from the same registers
// (tile_max, one barrier), then quantizes, dequantizes and squares them:
// the tile is read once. Any other tile takes the runtime-tile kernels
// (*_mxu_any_*): one 128-thread block per tile, whose warps walk the units
// in a loop over a run-time count (the int8 one reads its tile twice).
//
// f32 accuracy from TF32 inputs: each value that enters a product (a
// square, a partial sum) is split into two TF32 halves (split_tf32: hi =
// v truncated, lo = v − hi rounded), and both halves are multiplied by the
// ones, so each enters the sum with a relative error below 2⁻²¹ (the ones
// are exact in TF32, so the third term of a 3×TF32 product vanishes). The
// square and the difference are __fmul_rn/__fsub_rn, never contracted into
// an FMA.
//
// The bits: every path sums through the same helpers (eq3_segment,
// unit_total, units_total) with the same element-to-lane assignment and the
// same products in the same order, and 4-byte loads fill the same registers
// as 16-byte ones. So the templated kernels give the runtime-tile kernels'
// output bit for bit, the two load paths agree, and on the card the fused
// norms are bit-identical to the plain kernel run on the dequantized matrix.
constexpr int kMxuThreads = 128;
constexpr uint32_t kOneTf32 = 0x3f800000u;  // 1.0f, exact in TF32
// 16-column segments of a warp's unit at tile 64: 4, a whole strip (four
// warps per tile); 2, half a strip (eight warps)
constexpr int kSegs64 = 4;
// independent Eq. 3 accumulators of a warp (float j of each load goes to
// chain j % kChains)
constexpr int kChains = 2;

// 16-column segments of a warp's unit: a whole strip but at tile 64.
__host__ __device__ constexpr int mxu_unit_segs(int tile) {
  return tile == 64 ? kSegs64 : tile / 16;
}

// Units (warps' shares) of a tile.
__host__ __device__ constexpr int mxu_units(int tile) {
  return (tile / 16) * (tile / 16 / mxu_unit_segs(tile));
}

// v as two TF32 halves, hi + lo, within 2⁻²¹ of v: hi is v truncated to
// TF32 (its low 13 bits cleared); lo is the rest, v − hi (exact in f32,
// below 2⁻¹⁰ of v), rounded to TF32 to nearest, ties away from zero, on its
// bits. Integer operations on the bits: cvt.rna.tf32.f32 compiles to a
// longer sequence that guards special values. A NaN or an infinity stays
// in hi (lo is then a NaN rounded to −0).
struct Tf32Pair {
  uint32_t hi, lo;
};

__device__ __forceinline__ Tf32Pair split_tf32(float v) {
  const uint32_t hi = __float_as_uint(v) & 0xffffe000u;
  const float lo = __fsub_rn(v, __uint_as_float(hi));
  return {hi, (__float_as_uint(lo) + 0x1000u) & 0xffffe000u};
}

// d += A·B for one m16n8k8 TF32 product with f32 accumulation: a0..a3 are
// this lane's A fragment (A[g][q], A[g+8][q], A[g][q+4], A[g+8][q+4]),
// b0/b1 its B fragment (B[q][g], B[q+4][g]); d holds D[g][2q], D[g][2q+1],
// D[g+8][2q], D[g+8][2q+1].
__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += ones(16×8)·B with this lane's B fragment b0 = B[q][g], b1 = B[q+4][g]:
// column n of D gains the sum of column n of B.
__device__ __forceinline__ void mma_ones_b(float (&d)[4], uint32_t b0,
                                           uint32_t b1) {
  mma_tf32(d, kOneTf32, kOneTf32, kOneTf32, kOneTf32, b0, b1);
}

// Eq. 3 over one 16-column segment: u and v are this lane's four elements
// of rows g and g+8 at columns 4q..4q+3 of the segment. Float j adds the
// squares of f(u[j]) and f(v[j]) to chain j % kChains: A = [hi u², hi v²,
// lo u², lo v²] against ones, so every column of a chain holds its row
// sums.
template <class F>
__device__ __forceinline__ void eq3_segment(float (&acc)[kChains][4],
                                            const float (&u)[4],
                                            const float (&v)[4], F f) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float fu = f(u[j]), fv = f(v[j]);
    const Tf32Pair a = split_tf32(__fmul_rn(fu, fu));
    const Tf32Pair b = split_tf32(__fmul_rn(fv, fv));
    mma_tf32(acc[j % kChains], a.hi, b.hi, a.lo, b.lo, kOneTf32, kOneTf32);
  }
}

// A unit's total from its Eq. 3 chains, valid in lane 0 (and in every
// lane with q == 0).
__device__ __forceinline__ float unit_total(const float (&acc)[kChains][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  // Eq. 3, the chains summed: lane q gives chain q's sums of rows g, g+8
  float cg = 0.f, cg8 = 0.f;
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
    cg = q == c ? acc[c][0] : cg;
    cg8 = q == c ? acc[c][2] : cg8;
  }
  const Tf32Pair p = split_tf32(cg), p8 = split_tf32(cg8);
  float r[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(r, p.hi, p8.hi, p.lo, p8.lo, kOneTf32, kOneTf32);
  // Eq. 4: column g of B takes R[g] (lane q = 0) and R[g+8] (q = 1), so
  // column n of c is C[n] = R[n] + R[n+8]; lane q holds C[2q] and C[2q+1]
  const Tf32Pair s = split_tf32(q == 0 ? r[0] : r[2]);
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  mma_ones_b(c, q < 2 ? s.hi : 0u, q < 2 ? s.lo : 0u);
  // column 0 takes the even C[2q] (group 0), column 1 the odd C[2q+1]
  // (group 1); then lane 0 gives the odd sum t[1] onto column 0
  const Tf32Pair e = split_tf32(g == 0 ? c[0] : c[1]);
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_ones_b(t, g < 2 ? e.hi : 0u, g < 2 ? e.lo : 0u);
  const Tf32Pair o = split_tf32(t[1]);
  mma_ones_b(t, lane == 0 ? o.hi : 0u, lane == 0 ? o.lo : 0u);
  return t[0];
}

// Sum of n ≥ 2 unit totals tot[0..n) (shared memory), four to a product
// against ones: lane q of group 0 gives tot[i+q] as B[q][0] and B[q+4][0],
// the products chained in one accumulator. Valid in lane 0.
__device__ __forceinline__ float units_total(const float* tot, int n) {
  const int lane = threadIdx.x & 31;
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i = 0; i < n; i += 4) {
    const int at = i + (lane & 3);
    const float v = tot[at < n ? at : n - 1];
    const Tf32Pair p = split_tf32(lane < 4 && at < n ? v : 0.f);
    mma_ones_b(d, p.hi, p.lo);
  }
  return d[0];
}

// Total of a tile's NW unit totals, one from each of the tile's warps
// (neighbouring warps of the block): a single unit's own, else after one
// barrier units_total. Valid in lane 0 of each of the tile's warps.
template <int NW>
__device__ __forceinline__ float tile_units_total(float t) {
  if constexpr (NW == 1) {
    return t;
  } else {
    __shared__ float tot[kThreads / 32];
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) tot[warp] = t;
    __syncthreads();
    return units_total(tot + (warp - warp % NW), NW);
  }
}

// Columns c..c+3 of row r of the tile at `base` (row stride k): one
// 16-byte load when VEC, else four 4-byte ones into the same registers.
template <bool VEC>
__device__ __forceinline__ void load4(const float* __restrict__ base, int k,
                                      int r, int c, float (&out)[4]) {
  const float* p = base + static_cast<size_t>(r) * k + c;
  if constexpr (VEC) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else {
    out[0] = p[0];
    out[1] = p[1];
    out[2] = p[2];
    out[3] = p[3];
  }
}

// One templated (TILE × TILE) tensor-core tile: kSegs segments per warp,
// kTileWarps warps per tile, kTilesPerBlock tiles per kBlock-thread block.
template <int TILE, bool VEC>
struct MxuShape {
  static constexpr int kTile = TILE;
  static constexpr bool kVec = VEC;
  static constexpr int kSegs = mxu_unit_segs(TILE);
  static constexpr int kSplit = TILE / 16 / kSegs;  // warps per strip
  static constexpr int kTileWarps = mxu_units(TILE);
  static constexpr int kTileThreads = 32 * kTileWarps;
  static constexpr int kBlock =
      kTileThreads > kMxuThreads ? kTileThreads : kMxuThreads;
  static constexpr int kTilesPerBlock = kBlock / kTileThreads;
  static_assert(kTileWarps <= kThreads / 32, "a block of at most 8 warps");
};

// The templated kernels' units: tile `id` of the (M/t, K/t) grid, row-major
// (ids past the last tile of a partly filled block load the last tile and
// store nothing). Loads this warp's unit into u (rows g) and v (rows g+8),
// one segment per entry, every load issued before any is used.
template <class S>
__device__ __forceinline__ int load_unit(const float* __restrict__ x, int k,
                                         int gk, int tiles,
                                         float (&u)[S::kSegs][4],
                                         float (&v)[S::kSegs][4]) {
  const int id = blockIdx.x * S::kTilesPerBlock + threadIdx.x / S::kTileThreads;
  const int at = id < tiles ? id : tiles - 1;
  const int ti = at / gk;
  const int tj = at - ti * gk;
  const int w = (threadIdx.x % S::kTileThreads) >> 5;
  const int lane = threadIdx.x & 31;
  const int row = 16 * (w / S::kSplit) + (lane >> 2);
  const int col = 16 * S::kSegs * (w % S::kSplit) + 4 * (lane & 3);
  const float* base = x + static_cast<size_t>(ti) * S::kTile * k +
                      static_cast<size_t>(tj) * S::kTile;
#pragma unroll
  for (int i = 0; i < S::kSegs; ++i) {
    load4<S::kVec>(base, k, row, col + 16 * i, u[i]);
    load4<S::kVec>(base, k, row + 8, col + 16 * i, v[i]);
  }
  return id;
}

// Sum of squares of f over a templated tile from its warps' registers
// (Eq. 3-4); valid in lane 0 of each of the tile's warps.
template <class S, class F>
__device__ __forceinline__ float tile_sumsq(const float (&u)[S::kSegs][4],
                                            const float (&v)[S::kSegs][4],
                                            F f) {
  float acc[kChains][4] = {};
#pragma unroll
  for (int i = 0; i < S::kSegs; ++i) eq3_segment(acc, u[i], v[i], f);
  return tile_units_total<S::kTileWarps>(unit_total(acc));
}

template <class S>
__global__ void __launch_bounds__(S::kBlock)
tile_norms_mxu_f32_kernel(const float* __restrict__ x, float* __restrict__ out,
                          int k, int gk, int tiles) {
  float u[S::kSegs][4], v[S::kSegs][4];
  const int id = load_unit<S>(x, k, gk, tiles, u, v);
  const float s = tile_sumsq<S>(u, v, [](float e) { return e; });
  if (threadIdx.x % S::kTileThreads == 0 && id < tiles) out[id] = sqrtf(s);
}

template <class S>
__global__ void __launch_bounds__(S::kBlock)
tile_norms_quant_mxu_f32_kernel(const float* __restrict__ x,
                                float* __restrict__ norms,
                                float* __restrict__ scales, int k, int gk,
                                int tiles) {
  float u[S::kSegs][4], v[S::kSegs][4];
  const int id = load_unit<S>(x, k, gk, tiles, u, v);
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < S::kSegs; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      m = fmaxf(m, fmaxf(fabsf(u[i][j]), fabsf(v[i][j])));
    }
  }
  const float scale =
      __fmul_rn(fmaxf(tile_max<S::kTileThreads>(m), kTiny), kInv127);
  const float s = tile_sumsq<S>(
      u, v, [=](float e) { return dequantized(e, scale); });
  if (threadIdx.x % S::kTileThreads == 0 && id < tiles) {
    norms[id] = sqrtf(s);
    scales[id] = scale;
  }
}

// The runtime-tile walk: calls op(u, v) with this warp's loads of each
// segment (rows g and g+8, as load_unit) of each unit it owns — units
// warp, warp + 4, ...; unit w is segments [w % split · segs, + segs) of
// strip w / split — then done(w) after the unit's last segment.
template <class Op, class Done>
__device__ __forceinline__ void unit_walk(const float* __restrict__ base,
                                          int k, int tile, int vec, Op op,
                                          Done done) {
  const int segs = mxu_unit_segs(tile);
  const int split = tile / 16 / segs;
  const int lane = threadIdx.x & 31;
  for (int w = threadIdx.x >> 5; w < mxu_units(tile);
       w += kMxuThreads / 32) {
    const int row = 16 * (w / split) + (lane >> 2);
    const int col = 16 * segs * (w % split) + 4 * (lane & 3);
    for (int i = 0; i < segs; ++i) {
      float u[4], v[4];
      if (vec) {
        load4<true>(base, k, row, col + 16 * i, u);
        load4<true>(base, k, row + 8, col + 16 * i, v);
      } else {
        load4<false>(base, k, row, col + 16 * i, u);
        load4<false>(base, k, row + 8, col + 16 * i, v);
      }
      op(u, v);
    }
    done(w);
  }
}

// Sum of squares of f over the tile at `base` (Eq. 3-4), in the templated
// kernels' order; `tot` holds mxu_units(tile) floats of shared memory.
// Every thread of the block calls it; valid in thread 0.
template <class F>
__device__ __forceinline__ float any_tile_sumsq(const float* __restrict__ base,
                                                int k, int tile, int vec, F f,
                                                float* tot) {
  float acc[kChains][4] = {};
  unit_walk(
      base, k, tile, vec,
      [&](const float (&u)[4], const float (&v)[4]) {
        eq3_segment(acc, u, v, f);
      },
      [&](int w) {
        const float t = unit_total(acc);
        if ((threadIdx.x & 31) == 0) tot[w] = t;
#pragma unroll
        for (int c = 0; c < kChains; ++c) {
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[c][r] = 0.f;
        }
      });
  __syncthreads();
  const int n = mxu_units(tile);
  return n == 1 ? tot[0] : units_total(tot, n);
}

// The runtime-tile kernels: any tile % 16 == 0, one block per tile, a flat
// grid over the tiles.
__device__ __forceinline__ const float* tile_base(const float* x, int k,
                                                  int gk, int tile, int id) {
  const int ti = id / gk;
  const int tj = id - ti * gk;
  return x + static_cast<size_t>(ti) * tile * k +
         static_cast<size_t>(tj) * tile;
}

__global__ void __launch_bounds__(kMxuThreads)
tile_norms_mxu_any_f32_kernel(const float* __restrict__ x,
                              float* __restrict__ out, int k, int gk, int tile,
                              int vec) {
  extern __shared__ float tot[];
  const float s = any_tile_sumsq(tile_base(x, k, gk, tile, blockIdx.x), k,
                                 tile, vec, [](float e) { return e; }, tot);
  if (threadIdx.x == 0) out[blockIdx.x] = sqrtf(s);
}

__global__ void __launch_bounds__(kMxuThreads)
tile_norms_quant_mxu_any_f32_kernel(const float* __restrict__ x,
                                    float* __restrict__ norms,
                                    float* __restrict__ scales, int k, int gk,
                                    int tile, int vec) {
  extern __shared__ float tot[];
  const float* base = tile_base(x, k, gk, tile, blockIdx.x);
  float m = 0.f;
  unit_walk(
      base, k, tile, vec,
      [&](const float (&u)[4], const float (&v)[4]) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          m = fmaxf(m, fmaxf(fabsf(u[j]), fabsf(v[j])));
        }
      },
      [](int) {});
  const float scale =
      __fmul_rn(fmaxf(tile_max<kMxuThreads>(m), kTiny), kInv127);
  const float s = any_tile_sumsq(
      base, k, tile, vec, [=](float e) { return dequantized(e, scale); },
      tot);
  if (threadIdx.x == 0) {
    norms[blockIdx.x] = sqrtf(s);
    scales[blockIdx.x] = scale;
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

// Calls launch(Shape<tile, vec>{}) for a templated tile (16, 32, 64) and
// returns true; returns false for any other tile.
template <template <int, bool> class Shape, class F>
bool templated_tile(int tile, int vec, F&& launch) {
  switch (tile) {
    case 16:
      vec ? launch(Shape<16, true>{}) : launch(Shape<16, false>{});
      return true;
    case 32:
      vec ? launch(Shape<32, true>{}) : launch(Shape<32, false>{});
      return true;
    case 64:
      vec ? launch(Shape<64, true>{}) : launch(Shape<64, false>{});
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

__global__ void launch_floor_kernel() {}

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
  const bool templated = templated_tile<TileShape>(tile, vec, [&](auto s) {
    using S = decltype(s);
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
  const bool templated = templated_tile<TileShape>(tile, vec, [&](auto s) {
    using S = decltype(s);
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
  const auto st = static_cast<cudaStream_t>(stream);
  const int vec = vec_loads(x, k, tile);
  const int gk = k / tile;
  const int tiles = (m / tile) * gk;
  const bool templated = templated_tile<MxuShape>(tile, vec, [&](auto s) {
    using S = decltype(s);
    tile_norms_mxu_f32_kernel<S><<<tile_blocks<S>(tiles), S::kBlock, 0, st>>>(
        x, out, k, gk, tiles);
  });
  if (!templated) {
    tile_norms_mxu_any_f32_kernel<<<tiles, kMxuThreads,
                                    mxu_units(tile) * sizeof(float), st>>>(
        x, out, k, gk, tile, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

// As spamm_tile_norms_quant_f32, with the tensor-core sum; tile % 16 == 0.
extern "C" int spamm_tile_norms_quant_mxu_f32(const float* x, float* norms,
                                              float* scales, int m, int k,
                                              int tile, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const int vec = vec_loads(x, k, tile);
  const int gk = k / tile;
  const int tiles = (m / tile) * gk;
  const bool templated = templated_tile<MxuShape>(tile, vec, [&](auto s) {
    using S = decltype(s);
    tile_norms_quant_mxu_f32_kernel<S><<<tile_blocks<S>(tiles), S::kBlock, 0,
                                         st>>>(x, norms, scales, k, gk, tiles);
  });
  if (!templated) {
    tile_norms_quant_mxu_any_f32_kernel<<<tiles, kMxuThreads,
                                          mxu_units(tile) * sizeof(float),
                                          st>>>(x, norms, scales, k, gk, tile,
                                                vec);
  }
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel on `stream`: its device time is the launch floor that
// the get-norm kernels' times at small shapes are read against. Returns
// cudaGetLastError().
extern "C" int spamm_launch_floor(void* stream) {
  launch_floor_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
