// Hopper (sm_90a) read-floor probe: the per-lane sum of a stacked operator.
//
// Replaces the Pallas TPU kernel of benchmarks/trip_overhead_bench.py:
//   read_reduce <- _dma_reduce_kernel (trip_overhead_bench.py:83, via
//                  dma_floor_loop)
//
// out[l] = sum of the n = M * N entries of lane l of A (B, M, N) f32: the
// cheapest kernel that still reads every byte of A once, so its time at a
// step kernel's shape is the measured floor that kernel is judged against.
// A second instance reads A in bfloat16 (proxtpu_read_reduce_bf16) and sums
// in float32, each entry cast up as it is read (exact): the floor of the
// one-step kernels' bf16 instances.  The JAX probe sizes its bytes by A's
// dtype (trip_overhead_bench.py:92-110); both instances read 16 bytes a
// load, four float or eight bf16 entries, summed in pairs.
//
// Bound: the bytes of A over the memory rate; one add per entry is far
// below the card's rate.  The TPU kernel summed one lane block per grid
// step; a block per lane would leave most of the 132 SMs idle at B = 64, so
// a lane is cut into S chunks, one block each, read with 16-byte loads, four
// in flight per thread.  The sum must not change from run to run, so blocks
// do not add into out with atomics: each writes its partial sum and takes a
// ticket from the lane's counter, and the block that draws the last ticket
// adds the lane's S partials in the order s = 0 .. S - 1 and sets the
// counter back to 0.  One launch a call; the counters are zeroed once by
// the caller, not per call.  Within a block the order is fixed too (a
// thread's strided chain, a shuffle tree, the warps in order).  On an NVIDIA
// H100 80GB HBM3 at 700 W the ticket costs what the boundary between two
// kernels of one CUDA graph cost (31.7 against 31.9 us at (256, 200, 400)),
// and 0.5 to 0.9 us more where the grid is more than one wave of small
// blocks ((64, 200, 400), (1024, 64, 128)).  At shapes that fit the 50 MB
// L2 a call takes a few microseconds on the device, so the wrapper
// (kernels/probe.py) keeps its own work per call near that.
//
// Plain C interface for ctypes.  Each entry launches the kernel on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

using proxtpu::warp_sum;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;

using proxtpu::bf16_hi;
using proxtpu::bf16_lo;
using proxtpu::to_float;

// The sum of 16 bytes of entries: four float, or eight bf16 in a uint4.
__device__ __forceinline__ float sum16(float4 v) {
  return (v.x + v.y) + (v.z + v.w);
}
__device__ __forceinline__ float sum16(uint4 w) {
  return ((bf16_lo(w.x) + bf16_hi(w.x)) + (bf16_lo(w.y) + bf16_hi(w.y))) +
         ((bf16_lo(w.z) + bf16_hi(w.z)) + (bf16_lo(w.w) + bf16_hi(w.w)));
}

// The sum of lane's entries [lo, hi) by one block; every thread returns it.
template <typename T>
__device__ __forceinline__ float block_chunk_sum(const T* __restrict__ a,
                                                 long long lo, long long hi,
                                                 float* red) {
  using V = typename std::conditional<sizeof(T) == 4, float4, uint4>::type;
  constexpr int kPer = 16 / sizeof(T);  // entries a 16-byte load
  float acc = 0.f;
  const T* p = a + lo;
  const long long n = hi - lo;
  if ((reinterpret_cast<uintptr_t>(p) & 15u) == 0) {
    const V* p4 = reinterpret_cast<const V*>(p);
    const long long n4 = n / kPer;
    long long j = threadIdx.x;
    for (; j + (long long)kThreads * (kUnroll - 1) < n4;
         j += (long long)kThreads * kUnroll) {
      V v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(p4 + j + kThreads * u);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc += sum16(v[u]);
    }
    for (; j < n4; j += kThreads) acc += sum16(__ldg(p4 + j));
    for (long long k = kPer * n4 + threadIdx.x; k < n; k += kThreads)
      acc += to_float(p[k]);
  } else {
    for (long long k = threadIdx.x; k < n; k += kThreads)
      acc += to_float(p[k]);
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

// counter += 1, returning the old value: releases this thread's earlier
// stores and acquires those released by the earlier tickets in one
// operation.  (A __threadfence() on either side is a sequentially
// consistent fence and costs more than the whole of a small call; a release
// here and an acquire fence in the last block measured no faster.)
__device__ __forceinline__ unsigned int draw_ticket(unsigned int* counter) {
  unsigned int old;
  asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(counter)
               : "memory");
  return old;
}

// Block (l, s) sums chunk s of lane l into partial[l * S + s]; the last of a
// lane's S blocks to get there (a ticket from counter[l], which it sets
// back to 0) adds the S partials in order into out[l].
template <typename T>
__global__ void __launch_bounds__(kThreads)
read_reduce_kernel(const T* __restrict__ A, float* partial,
                   unsigned int* counter, float* __restrict__ out,
                   long long n, int S, long long chunk) {
  __shared__ float red[kWarps];
  const int l = blockIdx.x / S, s = blockIdx.x % S;
  const long long lo = (long long)s * chunk;
  const long long hi = lo + chunk < n ? lo + chunk : n;
  const float total =
      block_chunk_sum(A + (size_t)l * n, lo, hi > lo ? hi : lo, red);
  // the first warp finishes alone
  if (threadIdx.x >= 32) return;
  if (S == 1) {
    if (threadIdx.x == 0) out[l] = total;
    return;
  }
  float* lane_partial = partial + (size_t)l * S;
  unsigned int ticket = 0;
  if (threadIdx.x == 0) {
    lane_partial[s] = total;
    ticket = draw_ticket(&counter[l]);
  }
  if (__shfl_sync(0xffffffffu, ticket, 0) != (unsigned int)(S - 1)) return;
  // 32 partials are loaded at a time, then added one by one, so the order
  // is s = 0 .. S - 1 and the loads do not wait for one another
  float sum = 0.f;
  for (int base = 0; base < S; base += 32) {
    const int k = base + (int)threadIdx.x;
    const float v = k < S ? __ldcg(lane_partial + k) : 0.f;
    const int count = S - base < 32 ? S - base : 32;
    for (int j = 0; j < count; ++j) sum += __shfl_sync(0xffffffffu, v, j);
  }
  if (threadIdx.x == 0) {
    out[l] = sum;
    counter[l] = 0;  // ready for the next call on this stream
  }
}

template <typename T>
int launch(const T* A, float* partial, unsigned int* counter, float* out,
           int B, long long n, int S, long long chunk, void* stream) {
  const long long blocks = (long long)B * S;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  read_reduce_kernel<T><<<(unsigned int)blocks, kThreads, 0,
                          (cudaStream_t)stream>>>(A, partial, counter, out, n,
                                                  S, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// A (B, n) f32 contiguous, partial (B, S) scratch, counter (B,) zeros (left
// zero again by the kernel), out (B,).  A lane is cut into S chunks of
// `chunk` entries (a multiple of 4, so that a chunk of an aligned lane
// starts on 16 bytes); S * chunk >= n.
int proxtpu_read_reduce(const float* A, float* partial, unsigned int* counter,
                        float* out, int B, long long n, int S,
                        long long chunk, void* stream) {
  return launch(A, partial, counter, out, B, n, S, chunk, stream);
}

// The same with A in bfloat16; `chunk` a multiple of 8.
int proxtpu_read_reduce_bf16(const __nv_bfloat16* A, float* partial,
                             unsigned int* counter, float* out, int B,
                             long long n, int S, long long chunk,
                             void* stream) {
  return launch(A, partial, counter, out, B, n, S, chunk, stream);
}

}  // extern "C"
