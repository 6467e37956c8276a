// Get-norm kernels (paper §3.2): per-(t×t)-tile Frobenius norms of a 2-D
// float32 matrix, the `normmap` the SpAMM gate reads, and one level of the
// norm pyramid pooled from a normmap.
//
// tile_norms replaces the Pallas TPU kernel
// src/repro/kernels/getnorm.py::tile_norms (bodies _getnorm_kernel and
// _tile_sumsq, use_mxu=False).
//
// What bounds it on an H100: bytes. Every element is read once (4 B) for 2
// flops, far below the ~20 flop/B where f32 CUDA cores would take over, so
// the least time is M·K·4 B over the 3.35 TB/s of HBM3.
//
// Design: one 256-thread block per tile, the grid (K/t, M/t). Threads walk
// the tile with 16-byte loads when the tile width and row stride allow it
// (16 neighbouring threads cover one 256-byte tile row of a t=64 tile, so a
// warp reads two contiguous row segments), square and sum in f32 registers,
// then a warp-shuffle tree and a 8-entry shared-memory stage reduce the 256
// partial sums; thread 0 writes sqrt of the total. Nothing is kept between
// tiles, so there is no cross-block reduction. The TPU kernel's MXU variant
// (sums via dots against ones, use_mxu=True) has no counterpart here yet.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
tile_norms_f32_kernel(const float* __restrict__ x, float* __restrict__ out,
                      int k, int tile, int vec) {
  const int tj = blockIdx.x;
  const int ti = blockIdx.y;
  const int gk = gridDim.x;
  const float* base = x + static_cast<size_t>(ti) * tile * k +
                      static_cast<size_t>(tj) * tile;
  float s = 0.f;
  if (vec) {
    const int tq = tile / 4;  // float4 loads per tile row
    const int n = tile * tq;
    for (int e = threadIdx.x; e < n; e += kThreads) {
      const int r = e / tq;
      const int c = e - r * tq;
      const float4 v =
          reinterpret_cast<const float4*>(base + static_cast<size_t>(r) * k)[c];
      s = fmaf(v.x, v.x, s);
      s = fmaf(v.y, v.y, s);
      s = fmaf(v.z, v.z, s);
      s = fmaf(v.w, v.w, s);
    }
  } else {
    const int n = tile * tile;
    for (int e = threadIdx.x; e < n; e += kThreads) {
      const int r = e / tile;
      const int c = e - r * tile;
      const float v = base[static_cast<size_t>(r) * k + c];
      s = fmaf(v, v, s);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, off);
  }
  __shared__ float warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < kThreads / 32 ? warp_sums[lane] : 0.f;
    for (int off = 4; off > 0; off >>= 1) {
      s += __shfl_down_sync(0xffffffffu, s, off);
    }
    if (lane == 0) {
      out[static_cast<size_t>(ti) * gk + tj] = sqrtf(s);
    }
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

}  // namespace

// x: (m, k) row-major float32, m % tile == 0 == k % tile; out: (m/tile,
// k/tile) float32. Launches on `stream` and returns cudaGetLastError().
extern "C" int spamm_tile_norms_f32(const float* x, float* out, int m, int k,
                                    int tile, void* stream) {
  const dim3 grid(k / tile, m / tile);
  const int vec = (tile % 4 == 0) && (k % 4 == 0) &&
                  (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  tile_norms_f32_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(x, out, k,
                                                               tile, vec);
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
