// Get-norm kernel (paper §3.2): per-(t×t)-tile Frobenius norms of a 2-D
// float32 matrix, the `normmap` the SpAMM gate reads.
//
// Replaces the Pallas TPU kernel src/repro/kernels/getnorm.py::tile_norms
// (bodies _getnorm_kernel and _tile_sumsq, use_mxu=False).
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
