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
//
// bf16 operands (the reference's bf16 plans run its one work-list kernel on
// bf16 inputs with f32 accumulation): the work-list kernel is a template on
// the operand type. bf16 tiles are widened with __bfloat162float into the
// same f32 shared-memory tiles and run the same FMAs. A product of two bf16
// values is exact in f32, so each FMA rounds exactly as a multiply and an
// add would: the bf16 kernel is bit-identical to the f32 kernel on the
// bf16-rounded operands. Its bound is the bf16 tensor-core peak (989
// TFLOP/s) against half the operand bytes; this first version keeps the
// CUDA-core FMAs (wgmma is later work).
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
// (1,979 TOP/s) or, at serving shapes, the int8 operand bytes. Design
// (simple first): the run-per-block schedule of the f32 kernel; per ACC
// step the A tile is staged as 4-byte words and the B tile TRANSPOSED, so
// each thread's R×R outputs take t/4 __dp4a (4 int8 products + int32
// accumulate) per output on the CUDA cores; mma.sync/wgmma s8 come later.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kInit = 1;
constexpr int kAcc = 2;
constexpr int kFlush = 4;

// acc += A_tile · B_tile for one (TILE × TILE) A tile at `ag` (row stride
// lda) and one (TILE × TILE) B tile at `bg` (row stride ldb), f32 or bf16
// (widened to f32 as it is staged). Each of the
// 256 threads owns the R×R outputs at rows ty + 16·m, columns tx + 16·c.
// Both tiles are staged in shared memory (rows padded by one float against
// bank conflicts) with coalesced loads, then every thread runs TILE rank-1
// updates in ascending q with plain f32 FMAs.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <int TILE, class T>
__device__ __forceinline__ void acc_tile_product(
    const T* __restrict__ ag, size_t lda, const T* __restrict__ bg,
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
    as[r][c] = to_f32(ag[static_cast<size_t>(r) * lda + c]);
    bs[r][c] = to_f32(bg[static_cast<size_t>(r) * ldb + c]);
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

template <int TILE, class T>
__global__ void __launch_bounds__(kThreads)
spamm_worklist_f32_kernel(const T* __restrict__ a,
                          const T* __restrict__ b,
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
      acc_tile_product<TILE, T>(
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
    acc_tile_product<TILE, float>(ag + static_cast<size_t>(kk) * TILE, k,
                           bg + static_cast<size_t>(kk) * TILE * n, n, acc);
  }
  store_tile<TILE>(out + slice * m * n + static_cast<size_t>(i) * TILE * n +
                       (static_cast<size_t>(j) * block_n + group) * TILE,
                   n, acc);
}

// One int8 ACC step: acc += (f32(A_q·B_q)·sa)·sb for one (TILE × TILE)
// int8 A tile at `ag` (row stride lda) and one (TILE × TILE) int8 B tile at
// `bg` (row stride ldb). A is staged as 4-byte words of 4 consecutive k; B
// transposed, so a word holds 4 consecutive k of one output column. Each
// thread owns the outputs of acc_tile_product (rows ty + 16·m, columns
// tx + 16·c) and forms their exact int32 dots with __dp4a in ascending k.
template <int TILE>
__device__ __forceinline__ void acc_tile_product_int8(
    const signed char* __restrict__ ag, size_t lda,
    const signed char* __restrict__ bg, size_t ldb, float sa, float sb,
    float (&acc)[TILE / 16][TILE / 16]) {
  constexpr int R = TILE / 16;
  constexpr int W = TILE / 4;  // 4-byte words per tile row
  __shared__ int as[TILE][W + 1];
  __shared__ int bt[TILE][W + 1];  // bt[c][w] = B[4w .. 4w+3][c]
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  __syncthreads();  // the previous step's readers are done with as/bt
  for (int e = threadIdx.x; e < TILE * W; e += kThreads) {
    const int r = e / W;
    const int w = e - r * W;
    as[r][w] = *reinterpret_cast<const int*>(ag + static_cast<size_t>(r) *
                                                      lda + 4 * w);
    // B row r, columns 4w .. 4w+3 → byte (r % 4) of word r / 4 of each
    // of the four transposed columns
    const int v = *reinterpret_cast<const int*>(bg + static_cast<size_t>(r) *
                                                         ldb + 4 * w);
    signed char* col = reinterpret_cast<signed char*>(&bt[4 * w][0]);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      col[q * (W + 1) * 4 + r] = static_cast<signed char>(v >> (8 * q));
    }
  }
  __syncthreads();
  int dot[R][R];
#pragma unroll
  for (int m = 0; m < R; ++m)
#pragma unroll
    for (int c = 0; c < R; ++c) dot[m][c] = 0;
#pragma unroll 4
  for (int w = 0; w < W; ++w) {
    int av[R];
    int bv[R];
#pragma unroll
    for (int m = 0; m < R; ++m) av[m] = as[ty + 16 * m][w];
#pragma unroll
    for (int c = 0; c < R; ++c) bv[c] = bt[tx + 16 * c][w];
#pragma unroll
    for (int m = 0; m < R; ++m)
#pragma unroll
      for (int c = 0; c < R; ++c) dot[m][c] = __dp4a(av[m], bv[c], dot[m][c]);
  }
#pragma unroll
  for (int m = 0; m < R; ++m)
#pragma unroll
    for (int c = 0; c < R; ++c)
      acc[m][c] = __fadd_rn(
          acc[m][c], __fmul_rn(__fmul_rn(__int2float_rn(dot[m][c]), sa), sb));
}

template <int TILE>
__global__ void __launch_bounds__(kThreads)
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
                           int block_n) {
  const int run = blockIdx.x;
  const int group = blockIdx.y;
  const int s0 = runs[run];
  const int s1 = runs[run + 1];
  const int gk = k / TILE;
  const int gn = n / TILE;
  float acc[TILE / 16][TILE / 16];
  zero_acc<TILE>(acc);

  for (int s = s0; s < s1; ++s) {
    const int f = step_flags[s];  // uniform across the block
    if (f & kInit) zero_acc<TILE>(acc);
    if (f & kAcc) {
      const int i = step_i[s];
      const int jf = step_j[s] * block_n + group;  // fine column tile
      const int kk = step_k[s];
      acc_tile_product_int8<TILE>(
          a + static_cast<size_t>(i) * TILE * k +
              static_cast<size_t>(kk) * TILE,
          k, b + static_cast<size_t>(kk) * TILE * n +
                 static_cast<size_t>(jf) * TILE,
          n, a_scale[static_cast<size_t>(i) * gk + kk],
          b_scale[static_cast<size_t>(kk) * gn + jf], acc);
    }
    if (f & kFlush) {
      const int i = step_i[s];
      const int jf = step_j[s] * block_n + group;
      store_tile<TILE>(out + static_cast<size_t>(i) * TILE * n +
                           static_cast<size_t>(jf) * TILE,
                       n, acc);
    }
  }
}

template <int TILE, class T>
void launch_worklist(const T* a, const T* b, const int* si, const int* sj,
                     const int* sk, const int* sf, const int* runs,
                     int num_runs, float* out, int k, int n, int block_n,
                     cudaStream_t stream) {
  const dim3 grid(num_runs, block_n);
  spamm_worklist_f32_kernel<TILE, T><<<grid, kThreads, 0, stream>>>(
      a, b, si, sj, sk, sf, runs, out, k, n, block_n);
}

template <class T>
int worklist_entry(const T* a, const T* b, const int* step_i,
                   const int* step_j, const int* step_k,
                   const int* step_flags, const int* runs, int num_runs,
                   float* out, int k, int n, int tile, int block_n,
                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 16:
      launch_worklist<16, T>(a, b, step_i, step_j, step_k, step_flags, runs,
                             num_runs, out, k, n, block_n, st);
      break;
    case 32:
      launch_worklist<32, T>(a, b, step_i, step_j, step_k, step_flags, runs,
                             num_runs, out, k, n, block_n, st);
      break;
    case 64:
      launch_worklist<64, T>(a, b, step_i, step_j, step_k, step_flags, runs,
                             num_runs, out, k, n, block_n, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int TILE>
void launch_worklist_int8(const signed char* a, const signed char* b,
                          const float* sa, const float* sb, const int* si,
                          const int* sj, const int* sk, const int* sf,
                          const int* runs, int num_runs, float* out, int k,
                          int n, int block_n, cudaStream_t stream) {
  const dim3 grid(num_runs, block_n);
  spamm_worklist_int8_kernel<TILE><<<grid, kThreads, 0, stream>>>(
      a, b, sa, sb, si, sj, sk, sf, runs, out, k, n, block_n);
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
  return worklist_entry<float>(a, b, step_i, step_j, step_k, step_flags,
                               runs, num_runs, out, k, n, tile, block_n,
                               stream);
}

// As spamm_mm_worklist_f32 with a: (m, k), b: (k, n) row-major bf16
// operands; out stays float32.
extern "C" int spamm_mm_worklist_bf16(const __nv_bfloat16* a,
                                      const __nv_bfloat16* b,
                                      const int* step_i, const int* step_j,
                                      const int* step_k,
                                      const int* step_flags, const int* runs,
                                      int num_runs, float* out, int m, int k,
                                      int n, int tile, int block_n,
                                      void* stream) {
  (void)m;
  return worklist_entry<__nv_bfloat16>(a, b, step_i, step_j, step_k,
                                       step_flags, runs, num_runs, out, k, n,
                                       tile, block_n, stream);
}

// a: (m, k), b: (k, n) row-major int8 codes, 4-byte aligned; a_scale:
// (m/tile, k/tile), b_scale: (k/tile, n/tile) float32 per FINE tile; step
// tables and runs as spamm_mm_worklist_f32; out: (m, n) float32,
// zero-initialised. tile must be 16, 32 or 64 (else returns
// cudaErrorInvalidValue without launching). Returns cudaGetLastError().
extern "C" int spamm_mm_worklist_int8(const signed char* a,
                                      const signed char* b,
                                      const float* a_scale,
                                      const float* b_scale,
                                      const int* step_i, const int* step_j,
                                      const int* step_k,
                                      const int* step_flags, const int* runs,
                                      int num_runs, float* out, int m, int k,
                                      int n, int tile, int block_n,
                                      void* stream) {
  (void)m;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 16:
      launch_worklist_int8<16>(a, b, a_scale, b_scale, step_i, step_j,
                               step_k, step_flags, runs, num_runs, out, k, n,
                               block_n, st);
      break;
    case 32:
      launch_worklist_int8<32>(a, b, a_scale, b_scale, step_i, step_j,
                               step_k, step_flags, runs, num_runs, out, k, n,
                               block_n, st);
      break;
    case 64:
      launch_worklist_int8<64>(a, b, a_scale, b_scale, step_i, step_j,
                               step_k, step_flags, runs, num_runs, out, k, n,
                               block_n, st);
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
