// Device helpers shared by the port's kernels: warp and block reductions
// that keep a NaN in max (like jnp.max / torch.amax), the launch-attribute
// step for large dynamic shared memory, a NaN-keeping clip, and the tile
// pass: a ring of row tiles of an operator in shared memory, filled by the
// bulk copy and used for both products A x and A^T r, so that the operator
// is read from device memory once.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace proxtpu {

// max that propagates NaN like jnp.max / torch.amax
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_nanmax(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = nanmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide max and sum of THREADS threads; every thread gets both.
// `scratch` holds 2 * (THREADS / 32) floats.  Starts and ends with a
// barrier's worth of synchronisation, so it may be called in a loop.
template <int THREADS>
__device__ __forceinline__ void block_reduce(float& mx, float& sum,
                                             float* scratch) {
  constexpr int kWarps = THREADS / 32;
  static_assert(kWarps <= 32, "one warp finishes the reduction");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  mx = warp_nanmax(mx);
  sum = warp_sum(sum);
  if (lane == 0) {
    scratch[warp] = mx;
    scratch[kWarps + warp] = sum;
  }
  __syncthreads();
  if (warp == 0) {
    float m = lane < kWarps ? scratch[lane] : 0.f;
    float s = lane < kWarps ? scratch[kWarps + lane] : 0.f;
    m = warp_nanmax(m);
    s = warp_sum(s);
    if (lane == 0) {
      scratch[0] = m;
      scratch[kWarps] = s;
    }
  }
  __syncthreads();
  mx = scratch[0];
  sum = scratch[kWarps];
  __syncthreads();  // scratch is free again for the next call
}

// out[m] = (A x)[m] - c[m] (SUB) or (A x)[m] + c[m], for the M rows of a
// row-major A (M, N); x is in shared memory.  Each warp takes rows with a
// stride; lanes stride along the row, so the reads of A are coalesced.  The
// loads of a row are issued UNROLL at a time before their products are
// summed: a pass is bound by how many reads are in flight, and the compiler
// does not batch them across the dependent sum on its own.  The order of
// the sum does not depend on UNROLL.
template <int THREADS, bool SUB>
__device__ __forceinline__ void rows_dot(const float* __restrict__ A,
                                         const float* __restrict__ c,
                                         const float* x, float* out, int M,
                                         int N) {
  constexpr int kWarps = THREADS / 32;
  constexpr int kUnroll = 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int m = warp; m < M; m += kWarps) {
    const float* row = A + (size_t)m * N;
    float acc = 0.f;
    int n = lane;
    for (; n + 32 * (kUnroll - 1) < N; n += 32 * kUnroll) {
      float a[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) a[j] = __ldg(row + n + 32 * j);
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) acc = fmaf(a[j], x[n + 32 * j], acc);
    }
    for (; n < N; n += 32) acc = fmaf(__ldg(row + n), x[n], acc);
    acc = warp_sum(acc);
    if (lane == 0) out[m] = SUB ? acc - c[m] : acc + c[m];
  }
}

// clip(v, lo, hi) = min(max(v, lo), hi) that keeps a NaN (fminf/fmaxf
// would drop it), like jnp.clip / torch.clamp
__device__ __forceinline__ float nanclip(float v, float lo, float hi) {
  if (v != v) return v;
  return fminf(fmaxf(v, lo), hi);
}

// Opt in to more than 48 KB of dynamic shared memory where needed.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return cudaSuccess;
}

// ---- The tile pass -------------------------------------------------------
//
// A tile is `rows` full rows of a row-major operator (rows, N): one
// contiguous run of rows * N * 4 bytes.  Where the run starts on 16 bytes
// and N * 4 is a multiple of 16, one thread fills a stage of the ring with
// one bulk copy (cp.async.bulk, no tensor map) that reports its bytes to the
// stage's mbarrier; else every thread fills it with ordinary loads and
// stores.  Both passes then read the tile from shared memory:
//   tile_rows_dot  out[m] = a_m . x - c[m]   a warp per row, as rows_dot
//   tile_cols_fma  g[n] += sum_m r[m] A[m, n]  a thread per column, rows in
//                  ascending order in one fmaf chain
// The order of every sum is rows_dot's and a column loop's over the whole
// operator, whatever the tile height: cutting into tiles changes no bit.

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbarrier_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   shared_addr(bar)),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (and to the
// cluster); the caller follows it with a block barrier
__device__ __forceinline__ void mbarrier_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// spin until the barrier's phase differs from `parity`
__device__ __forceinline__ void mbarrier_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = shared_addr(bar);
  uint32_t ready = 0;
  while (!ready) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(ready)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// One thread: arm the stage's barrier with `bytes` and start the bulk copy
// of `bytes` (a multiple of 16, source and destination on 16 bytes) into
// the stage.
__device__ __forceinline__ void fill_stage_bulk(float* stage,
                                                const float* src,
                                                uint32_t bytes,
                                                uint64_t* bar) {
  const uint32_t bar_addr = shared_addr(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar_addr),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(shared_addr(stage)),
      "l"(src), "r"(bytes), "r"(bar_addr)
      : "memory");
}

// Every thread: copy `count` floats into the stage with ordinary loads, four
// in flight per thread; readable after the next block barrier.
template <int THREADS>
__device__ __forceinline__ void fill_stage_loads(float* stage,
                                                 const float* __restrict__ src,
                                                 int count) {
  int k = threadIdx.x;
  for (; k + 3 * THREADS < count; k += 4 * THREADS) {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = __ldg(src + k + j * THREADS);
#pragma unroll
    for (int j = 0; j < 4; ++j) stage[k + j * THREADS] = v[j];
  }
  for (; k < count; k += THREADS) stage[k] = __ldg(src + k);
}

// Pass 1 on a tile: out[m] = a_m . x - c[m] for its `rows` rows.  A warp
// takes rows with a stride; a lane strides the row by 32 in one fmaf chain,
// then the warp's tree: rows_dot's order.  `tile` is in shared memory (or,
// read in place, in device memory); x in shared memory.
template <int THREADS>
__device__ __forceinline__ void tile_rows_dot(const float* tile,
                                              const float* __restrict__ c,
                                              const float* x, float* out,
                                              int rows, int N) {
  constexpr int kWarps = THREADS / 32;
  constexpr int kUnroll = 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int m = warp; m < rows; m += kWarps) {
    const float* row = tile + (size_t)m * N;
    float acc = 0.f;
    int n = lane;
    for (; n + 32 * (kUnroll - 1) < N; n += 32 * kUnroll) {
      float a[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) a[j] = row[n + 32 * j];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) acc = fmaf(a[j], x[n + 32 * j], acc);
    }
    for (; n < N; n += 32) acc = fmaf(row[n], x[n], acc);
    acc = warp_sum(acc);
    if (lane == 0) out[m] = acc - c[m];
  }
}

// Pass 2 on a tile: g[n] (+)= sum over the tile's rows, ascending, of
// r[m] * A[m, n], a thread per column; `first` starts the chain from 0.
// Only the thread that owns column n touches g[n].
template <int THREADS>
__device__ __forceinline__ void tile_cols_fma(const float* tile,
                                              const float* r, float* g,
                                              int rows, int N, bool first) {
  constexpr int kUnroll = 8;
  for (int n = threadIdx.x; n < N; n += THREADS) {
    const float* col = tile + n;
    float acc = first ? 0.f : g[n];
    int m = 0;
    for (; m + kUnroll <= rows; m += kUnroll) {
      float a[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) a[j] = col[(size_t)(m + j) * N];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) acc = fmaf(a[j], r[m + j], acc);
    }
    for (; m < rows; ++m) acc = fmaf(col[(size_t)m * N], r[m], acc);
    g[n] = acc;
  }
}

}  // namespace proxtpu
