// Hopper (sm_90a) read-floor probe: the per-lane sum of a stacked operator.
//
// Replaces the Pallas TPU kernel of benchmarks/trip_overhead_bench.py:
//   read_reduce <- _dma_reduce_kernel (trip_overhead_bench.py:83, via
//                  dma_floor_loop)
//
// out[l] = sum of the n = M * N entries of lane l of A (B, M, N) f32: the
// cheapest kernel that still reads every byte of A once, so its time at a
// step kernel's shape is the measured floor that kernel is judged against.
//
// Bound: the bytes of A over the memory rate; one add per entry is far
// below the card's rate.  The TPU kernel summed one lane block per grid
// step; a block per lane would leave most of the 132 SMs idle at B = 64, so
// a lane is cut into S chunks, one block each, read with 16-byte loads, four
// in flight per thread.  The sum must not change from run to run, so blocks
// do not add into out with atomics: each writes its partial sum, and a
// second kernel adds a lane's S partials in order.  Within a block the
// order is fixed too (a thread's strided chain, a shuffle tree, the warps
// in order).
//
// Plain C interface for ctypes.  The entry launches both kernels on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

using proxtpu::warp_sum;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;

// The sum of lane's entries [lo, hi) by one block; every thread returns it.
__device__ __forceinline__ float block_chunk_sum(const float* __restrict__ a,
                                                 long long lo, long long hi,
                                                 float* red) {
  float acc = 0.f;
  const float* p = a + lo;
  const long long n = hi - lo;
  if ((reinterpret_cast<uintptr_t>(p) & 15u) == 0) {
    const float4* p4 = reinterpret_cast<const float4*>(p);
    const long long n4 = n / 4;
    long long j = threadIdx.x;
    for (; j + (long long)kThreads * (kUnroll - 1) < n4;
         j += (long long)kThreads * kUnroll) {
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(p4 + j + kThreads * u);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        acc += (v[u].x + v[u].y) + (v[u].z + v[u].w);
    }
    for (; j < n4; j += kThreads) {
      const float4 v = __ldg(p4 + j);
      acc += (v.x + v.y) + (v.z + v.w);
    }
    for (long long k = 4 * n4 + threadIdx.x; k < n; k += kThreads)
      acc += __ldg(p + k);
  } else {
    for (long long k = threadIdx.x; k < n; k += kThreads) acc += __ldg(p + k);
  }
  acc = warp_sum(acc);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = acc;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += red[w];
  return total;
}

__global__ void __launch_bounds__(kThreads)
read_reduce_partial_kernel(const float* __restrict__ A,
                           float* __restrict__ partial, long long n, int S,
                           long long chunk) {
  __shared__ float red[kWarps];
  const int l = blockIdx.x / S, s = blockIdx.x % S;
  const long long lo = (long long)s * chunk;
  const long long hi = lo + chunk < n ? lo + chunk : n;
  const float total =
      block_chunk_sum(A + (size_t)l * n, lo, hi > lo ? hi : lo, red);
  if (threadIdx.x == 0) partial[blockIdx.x] = total;
}

__global__ void read_reduce_combine_kernel(const float* __restrict__ partial,
                                           float* __restrict__ out, int B,
                                           int S) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= B) return;
  float total = 0.f;
  for (int s = 0; s < S; ++s) total += partial[(size_t)l * S + s];
  out[l] = total;
}

}  // namespace

extern "C" {

// A (B, n) f32 contiguous, partial (B, S) scratch, out (B,).  A lane is cut
// into S chunks of `chunk` entries (a multiple of 4, so that a chunk of an
// aligned lane starts on 16 bytes); S * chunk >= n.
int proxtpu_read_reduce(const float* A, float* partial, float* out, int B,
                        long long n, int S, long long chunk, void* stream) {
  const long long blocks = (long long)B * S;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  read_reduce_partial_kernel<<<(unsigned int)blocks, kThreads, 0,
                               (cudaStream_t)stream>>>(A, partial, n, S,
                                                       chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  read_reduce_combine_kernel<<<(B + 127) / 128, 128, 0,
                               (cudaStream_t)stream>>>(partial, out, B, S);
  return (int)cudaGetLastError();
}

}  // extern "C"
