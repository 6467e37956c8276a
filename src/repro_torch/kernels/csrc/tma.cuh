// TMA copies into mbarrier rings, shared by spamm_wgmma.cu (the `wgmma`
// bf16 and int8 work-list kernels) and spamm_decode.cu (the f32 work-list
// kernel at decode): the PTX of the barriers and of the 2-D tensor copy, the
// host's tensor-map encode (cuTensorMapEncodeTiled through the runtime, so
// no library needs -lcuda) with a small cache of encoded maps, and the
// launch that raises a kernel's dynamic shared-memory limit once a device.
// Each library includes it once; everything here has internal linkage.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <mutex>

#include "worklist.cuh"

namespace {

using spamm::smem_addr;

// ---------------------------------------------------------------------------
// PTX: mbarriers, TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// waits until the phase of parity `parity` of the barrier has completed; a
// wait that outlasts 2²⁴ tries (seconds: a copy or an arrival that never
// comes) traps, so the launch fails with an error instead of hanging
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = smem_addr(bar);
  unsigned done = 0;
  for (unsigned tries = 0; !done; ++tries) {
    if (tries == (1u << 24)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// TMA: the box of `map` at column x, row y (elements) into `dst`,
// completing on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(smem_addr(bar))
      : "memory");
}

// ---------------------------------------------------------------------------
// Host side: tensor maps and launches
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up once through the runtime
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return rc == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 2-D row-major (rows, cols) operand as TMA boxes of (box_rows,
// box_cols), its L2 fetches promoted to `promotion`. Returns false when
// the encode refuses it.
bool encode(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
            int elem, long long rows, long long cols, int box_rows,
            int box_cols, CUtensorMapSwizzle swizzle,
            CUtensorMapL2promotion promotion) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, promotion,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Encoded maps by everything `encode` reads: a table of kMapSlots in sets
// of kMapWays (a call's two operands whose keys share a set both stay), a
// miss filling an empty way or evicting the set's ways in turn. The map is
// a function of its key alone, so a hit is the map an encode would give.
struct MapKey {
  const void* ptr;
  long long rows, cols;
  int type, box_rows, box_cols, swizzle, promotion;
};

struct MapSlot {
  MapKey key;
  CUtensorMap map;
  bool full;
};

constexpr int kMapSlots = 256;
constexpr int kMapWays = 4;
std::mutex g_maps_mu;
MapSlot g_maps[kMapSlots];
unsigned char g_evict[kMapSlots / kMapWays];  // each set's next victim

bool same_key(const MapKey& x, const MapKey& y) {
  return x.ptr == y.ptr && x.rows == y.rows && x.cols == y.cols &&
         x.type == y.type && x.box_rows == y.box_rows &&
         x.box_cols == y.box_cols && x.swizzle == y.swizzle &&
         x.promotion == y.promotion;
}

bool cached_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
                int elem, long long rows, long long cols, int box_rows,
                int box_cols, CUtensorMapSwizzle swizzle,
                CUtensorMapL2promotion promotion =
                    CU_TENSOR_MAP_L2_PROMOTION_L2_256B) {
  const MapKey key{ptr,      rows,     cols,
                   static_cast<int>(type), box_rows, box_cols,
                   static_cast<int>(swizzle), static_cast<int>(promotion)};
  uint64_t h = reinterpret_cast<uintptr_t>(ptr) >> 4;
  for (const long long v : {rows, cols, static_cast<long long>(box_cols),
                            static_cast<long long>(box_rows),
                            static_cast<long long>(key.type * 8 + key.swizzle),
                            static_cast<long long>(key.promotion)})
    h = (h ^ static_cast<uint64_t>(v)) * 0x100000001b3ull;
  const int set = static_cast<int>((h ^ (h >> 29)) % (kMapSlots / kMapWays));
  MapSlot* ways = g_maps + set * kMapWays;
  std::lock_guard<std::mutex> hold(g_maps_mu);
  MapSlot* slot = nullptr;
  for (int w = 0; w < kMapWays; ++w) {
    if (ways[w].full && same_key(ways[w].key, key)) {
      *map = ways[w].map;
      return true;
    }
    if (!slot && !ways[w].full) slot = &ways[w];
  }
  if (!slot) slot = &ways[g_evict[set]++ % kMapWays];
  if (!encode(&slot->map, ptr, type, elem, rows, cols, box_rows, box_cols,
              swizzle, promotion)) {
    slot->full = false;
    return false;
  }
  slot->key = key;
  slot->full = true;
  *map = slot->map;
  return true;
}

// The launch of kernel `kern` (product or shape P: one static bit a device
// for each P) with `threads` threads and `smem` bytes of dynamic shared
// memory, at most `limit`: the shared-memory attribute (`limit`) is set on
// a device's first launch.
template <class P, class K, class... Args>
int launch_upto(K kern, dim3 grid, int threads, int smem, int limit,
                cudaStream_t stream, Args... args) {
  static std::atomic<uint64_t> ready{0};
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (!(ready.load(std::memory_order_acquire) & bit)) {
    rc = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    ready.fetch_or(bit, std::memory_order_release);
  }
  kern<<<grid, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// launch_upto at a fixed `smem`
template <class P, class K, class... Args>
int launch_once(K kern, dim3 grid, int threads, int smem, cudaStream_t stream,
                Args... args) {
  return launch_upto<P>(kern, grid, threads, smem, smem, stream, args...);
}

}  // namespace
