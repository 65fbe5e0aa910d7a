// Device helpers shared by the port's kernels: warp and block reductions
// that keep a NaN in max (like jnp.max / torch.amax), the launch-attribute
// step for large dynamic shared memory, and a NaN-keeping clip.
#pragma once

#include <cuda_runtime.h>

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

}  // namespace proxtpu
