// Step lists of the work-list GEMMs, shared by spamm_mm.cu (CUDA-core f32,
// `mma.sync` bf16 and int8 at sub-tiles 16 and 32, the dense-grid kernel)
// and spamm_wgmma.cu (`wgmma` bf16 and int8 at tiles that are multiples of
// 64). A block reads its run's step tables in coalesced rounds of one step
// per thread and keeps the steps with a flag bit, in table order (warp
// ballot, then a prefix over the warps), as int4 entries (k, i, j, flags)
// of a shared-memory list of kListCap entries; a longer run is walked in
// several such chunks.
#pragma once

#include <cuda_runtime.h>

namespace spamm {

constexpr int kInit = 1;
constexpr int kAcc = 2;
constexpr int kFlush = 4;
// entries of a block's shared-memory step list (int4 each: k, i, j, flags)
constexpr int kListCap = 256;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// What a list entry needs besides (k, i, j, flags): nothing, by default.
struct NoExtra {
  __device__ void operator()(int, int, int, int, int) const {}
};

// Appends the flagged steps of [base, s1) to `list` (entries: k, i, j,
// flags), in table order, in rounds of NT steps (every thread of the block
// takes part) while a whole round still fits; advances `base` past the
// steps read. `extra(pos, k, i, j, flags)` runs for each entry kept, with
// its list position (the int8 wgmma kernel loads the step's scales there).
// Returns the entry count.
template <int NT, class Extra = NoExtra>
__device__ int fill_worklist(int4* list, int* wsum, const int* step_i,
                             const int* step_j, const int* step_k,
                             const int* step_flags, int& base, int s1,
                             const Extra& extra = Extra{}) {
  const int ln = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  int cnt = 0;
  while (base < s1 && cnt + NT <= kListCap) {
    const int s = base + threadIdx.x;
    int f = 0, kk = 0, ii = 0, jj = 0;
    if (s < s1) {
      f = step_flags[s];
      kk = step_k[s];
      ii = step_i[s];
      jj = step_j[s];
    }
    const unsigned bal = __ballot_sync(0xffffffffu, f != 0);
    if (ln == 0) wsum[warp] = __popc(bal);
    __syncthreads();
    int off = cnt, total = 0;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) {
      const int c = wsum[w];
      total += c;
      if (w < warp) off += c;
    }
    if (f != 0) {
      const int pos = off + __popc(bal & ((1u << ln) - 1u));
      list[pos] = make_int4(kk, ii, jj, f);
      extra(pos, kk, ii, jj, f);
    }
    cnt += total;
    base += NT;
    __syncthreads();  // list complete; wsum free for the next round
  }
  return cnt;
}

}  // namespace spamm
