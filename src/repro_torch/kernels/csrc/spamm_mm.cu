// SpAMM GEMMs (paper §3.3, Alg. 2): C[i, j] = Σ over the valid k of
// A[i, k] · B[k, j], driven by the planner's step tables (work-list kernel)
// or by dense per-(i, j) valid-k lists (dense-grid kernel).
//
// The work-list kernel replaces the Pallas TPU kernel
// src/repro/kernels/spamm_mm.py::spamm_mm_worklist (_spamm_mm_worklist_kernel).
// The TPU kernel walks one sequential 1-D grid over the steps and carries
// its f32 accumulator in VMEM from step to step. Blocks on a GPU run in
// parallel and in no order, so here each (i, j) RUN of consecutive steps
// (the rows of `runs`: steps [runs[p], runs[p+1]) share one output block)
// is one thread block that walks its steps in a loop: INIT zeroes the
// register accumulator, ACC adds A[i,k]·B[k,j-block] for that step, FLUSH
// writes the accumulator out; steps without flag bits (bucket padding,
// steps the frozen gate switched off) do nothing. The ACC steps of a run are
// accumulated in table order (ascending k) with plain f32 FMAs — no TF32,
// no split over k, no atomics — so a work-list and a frozen plan that keep
// the same active steps give bit-identical outputs. The output is
// zero-initialised by the caller, so tiles no run visits stay exactly 0.
//
// What bounds it on an H100: operations, at the serving shapes. One ACC step
// is 2·t³ flops against 2·t² fresh floats (t = 64: 16 flop/B, with the A and
// B tiles re-read by other runs mostly from L2); the least time is the
// executed flops over the 67 TFLOP/s f32 peak of the CUDA cores.
//
// Design (simple first; wgmma/TMA/pipelining come later): 256 threads per
// block, each owning a (t/16)×(t/16) sub-grid of the output block (rows
// ty + 16·m, columns tx + 16·n) in registers. Per ACC step both tiles are
// staged in shared memory (rows padded by one float against bank
// conflicts) with coalesced loads, then every thread runs t rank-1 updates.
// block_n > 1 (super-columns) splits into gridDim.y column groups of width
// t: each group is an independent output block with the same run, so the
// per-element accumulation order does not change.
//
// The dense-grid kernel replaces the Pallas TPU kernel
// src/repro/kernels/spamm_mm.py::spamm_mm (_spamm_mm_kernel), which walks
// the whole (gm, gn, gk) grid and masks the steps t >= nvalid[i, j] out,
// reading k = kidx[i, j, t]. Here one thread block owns one output block
// (i, j) (times block_n column groups in gridDim.y) of one batch slice
// (gridDim.z, so a batch of per-slice products is one launch) and walks
// only its t < nvalid[b, i, j] valid k's; a block with nvalid = 0 writes
// zeros, as the Pallas kernel flushes its zeroed accumulator. Its bound is
// the same as the work-list kernel's: 2·t³ operations per valid step at the
// f32 CUDA-core peak.
//
// Both kernels add a step's tile product through ONE device function
// (acc_tile_product: shared-memory staging, then t rank-1 FMA updates in
// ascending inner index) and write through one (store_tile). With the same
// valid k's in the same ascending order, the dense-grid and the work-list
// kernel therefore give bit-identical outputs.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kInit = 1;
constexpr int kAcc = 2;
constexpr int kFlush = 4;

// acc += A_tile · B_tile for one (TILE × TILE) A tile at `ag` (row stride
// lda) and one (TILE × TILE) B tile at `bg` (row stride ldb). Each of the
// 256 threads owns the R×R outputs at rows ty + 16·m, columns tx + 16·c.
// Both tiles are staged in shared memory (rows padded by one float against
// bank conflicts) with coalesced loads, then every thread runs TILE rank-1
// updates in ascending q with plain f32 FMAs.
template <int TILE>
__device__ __forceinline__ void acc_tile_product(
    const float* __restrict__ ag, size_t lda, const float* __restrict__ bg,
    size_t ldb, float (&acc)[TILE / 16][TILE / 16]) {
  constexpr int R = TILE / 16;
  __shared__ float as[TILE][TILE + 1];
  __shared__ float bs[TILE][TILE + 1];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  __syncthreads();  // the previous step's readers are done with as/bs
  for (int e = threadIdx.x; e < TILE * TILE; e += kThreads) {
    const int r = e / TILE;
    const int c = e - r * TILE;
    as[r][c] = ag[static_cast<size_t>(r) * lda + c];
    bs[r][c] = bg[static_cast<size_t>(r) * ldb + c];
  }
  __syncthreads();
#pragma unroll 8
  for (int q = 0; q < TILE; ++q) {
    float av[R];
    float bv[R];
#pragma unroll
    for (int m = 0; m < R; ++m) av[m] = as[ty + 16 * m][q];
#pragma unroll
    for (int c = 0; c < R; ++c) bv[c] = bs[q][tx + 16 * c];
#pragma unroll
    for (int m = 0; m < R; ++m)
#pragma unroll
      for (int c = 0; c < R; ++c) acc[m][c] = fmaf(av[m], bv[c], acc[m][c]);
  }
}

template <int TILE>
__device__ __forceinline__ void zero_acc(float (&acc)[TILE / 16][TILE / 16]) {
#pragma unroll
  for (int m = 0; m < TILE / 16; ++m)
#pragma unroll
    for (int c = 0; c < TILE / 16; ++c) acc[m][c] = 0.f;
}

// Writes the thread's R×R outputs to the (TILE × TILE) output block at
// `og` (row stride ldo).
template <int TILE>
__device__ __forceinline__ void store_tile(
    float* __restrict__ og, size_t ldo,
    const float (&acc)[TILE / 16][TILE / 16]) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int m = 0; m < TILE / 16; ++m)
#pragma unroll
    for (int c = 0; c < TILE / 16; ++c)
      og[static_cast<size_t>(ty + 16 * m) * ldo + tx + 16 * c] = acc[m][c];
}

template <int TILE>
__global__ void __launch_bounds__(kThreads)
spamm_worklist_f32_kernel(const float* __restrict__ a,
                          const float* __restrict__ b,
                          const int* __restrict__ step_i,
                          const int* __restrict__ step_j,
                          const int* __restrict__ step_k,
                          const int* __restrict__ step_flags,
                          const int* __restrict__ runs,
                          float* __restrict__ out, int k, int n,
                          int block_n) {
  const int run = blockIdx.x;
  const int group = blockIdx.y;
  const int s0 = runs[run];
  const int s1 = runs[run + 1];
  float acc[TILE / 16][TILE / 16];
  zero_acc<TILE>(acc);

  for (int s = s0; s < s1; ++s) {
    const int f = step_flags[s];  // uniform across the block
    if (f & kInit) zero_acc<TILE>(acc);
    if (f & kAcc) {
      const int i = step_i[s];
      const int j = step_j[s];
      const int kk = step_k[s];
      acc_tile_product<TILE>(
          a + static_cast<size_t>(i) * TILE * k +
              static_cast<size_t>(kk) * TILE,
          k,
          b + static_cast<size_t>(kk) * TILE * n +
              (static_cast<size_t>(j) * block_n + group) * TILE,
          n, acc);
    }
    if (f & kFlush) {
      const int i = step_i[s];
      const int j = step_j[s];
      store_tile<TILE>(out + static_cast<size_t>(i) * TILE * n +
                           (static_cast<size_t>(j) * block_n + group) * TILE,
                       n, acc);
    }
  }
}

// One block per (slice, i, j, column group): acc = Σ_{t < nvalid} A[i, k_t]
// · B[k_t, j-block], k_t = kidx[slice, i, j, t] in the table's (ascending)
// order, then one store — zeros where nvalid is 0.
template <int TILE>
__global__ void __launch_bounds__(kThreads)
spamm_dense_f32_kernel(const float* __restrict__ a,
                       const float* __restrict__ b,
                       const int* __restrict__ kidx,
                       const int* __restrict__ nvalid,
                       float* __restrict__ out, int m, int k, int n,
                       int gnb, int block_n) {
  const int pair = blockIdx.x;  // i * gnb + j
  const int group = blockIdx.y;
  const size_t slice = blockIdx.z;
  const int i = pair / gnb;
  const int j = pair - i * gnb;
  const int gk = k / TILE;
  const size_t pair_id = slice * (m / TILE) * gnb + pair;
  const int nv = nvalid[pair_id];
  const int* kl = kidx + pair_id * gk;
  const float* ag = a + slice * m * k + static_cast<size_t>(i) * TILE * k;
  const float* bg = b + slice * k * n +
                    (static_cast<size_t>(j) * block_n + group) * TILE;
  float acc[TILE / 16][TILE / 16];
  zero_acc<TILE>(acc);
  for (int t = 0; t < nv; ++t) {
    const int kk = kl[t];
    acc_tile_product<TILE>(ag + static_cast<size_t>(kk) * TILE, k,
                           bg + static_cast<size_t>(kk) * TILE * n, n, acc);
  }
  store_tile<TILE>(out + slice * m * n + static_cast<size_t>(i) * TILE * n +
                       (static_cast<size_t>(j) * block_n + group) * TILE,
                   n, acc);
}

template <int TILE>
void launch_worklist(const float* a, const float* b, const int* si,
                     const int* sj, const int* sk, const int* sf,
                     const int* runs, int num_runs, float* out, int k, int n,
                     int block_n, cudaStream_t stream) {
  const dim3 grid(num_runs, block_n);
  spamm_worklist_f32_kernel<TILE><<<grid, kThreads, 0, stream>>>(
      a, b, si, sj, sk, sf, runs, out, k, n, block_n);
}

template <int TILE>
void launch_dense(const float* a, const float* b, const int* kidx,
                  const int* nvalid, float* out, int batch, int m, int k,
                  int n, int block_n, cudaStream_t stream) {
  const int gnb = n / (TILE * block_n);
  const dim3 grid((m / TILE) * gnb, block_n, batch);
  spamm_dense_f32_kernel<TILE><<<grid, kThreads, 0, stream>>>(
      a, b, kidx, nvalid, out, m, k, n, gnb, block_n);
}

}  // namespace

// a: (m, k), b: (k, n) row-major float32; step tables (S,) int32; runs
// (num_runs + 1,) int32 run boundaries into the step tables; out: (m, n)
// float32, zero-initialised. tile must be 16, 32 or 64 (else returns
// cudaErrorInvalidValue without launching). Returns cudaGetLastError().
extern "C" int spamm_mm_worklist_f32(const float* a, const float* b,
                                     const int* step_i, const int* step_j,
                                     const int* step_k, const int* step_flags,
                                     const int* runs, int num_runs,
                                     float* out, int m, int k, int n,
                                     int tile, int block_n, void* stream) {
  (void)m;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 16:
      launch_worklist<16>(a, b, step_i, step_j, step_k, step_flags, runs,
                          num_runs, out, k, n, block_n, st);
      break;
    case 32:
      launch_worklist<32>(a, b, step_i, step_j, step_k, step_flags, runs,
                          num_runs, out, k, n, block_n, st);
      break;
    case 64:
      launch_worklist<64>(a, b, step_i, step_j, step_k, step_flags, runs,
                          num_runs, out, k, n, block_n, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// a: (batch, m, k), b: (batch, k, n) row-major float32; kidx: (batch,
// m/tile, n/(tile·block_n), k/tile) int32 valid-k lists, the first nvalid
// entries of each in ascending order; nvalid: (batch, m/tile,
// n/(tile·block_n)) int32; out: (batch, m, n) float32, every element
// written. tile must be 16, 32 or 64 (else returns cudaErrorInvalidValue
// without launching). Returns cudaGetLastError().
extern "C" int spamm_mm_dense_f32(const float* a, const float* b,
                                  const int* kidx, const int* nvalid,
                                  float* out, int batch, int m, int k, int n,
                                  int tile, int block_n, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 16:
      launch_dense<16>(a, b, kidx, nvalid, out, batch, m, k, n, block_n, st);
      break;
    case 32:
      launch_dense<32>(a, b, kidx, nvalid, out, batch, m, k, n, block_n, st);
      break;
    case 64:
      launch_dense<64>(a, b, kidx, nvalid, out, batch, m, k, n, block_n, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
