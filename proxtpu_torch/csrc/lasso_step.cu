// Hopper (sm_90a) kernels for the batched lasso forward-backward / FISTA step.
//
// Replaces the Pallas TPU kernels of proxtpu/kernels/lasso.py:
//   fista_step  <- _fista_full_step_kernel (lasso.py:156, via fused_fista_full_step)
//                  and _fista_packed_step_kernel (lasso.py:1238, via
//                  fused_fista_packed_step): the packed kernel computes the
//                  same per-problem math in a layout that only strips the
//                  TPU's 128-lane padding; a 400-float row has none here.
//   fb_step     <- _fb_step_kernel (lasso.py:37, via fused_fb_prox_grad)
//
// Per lane i (one CTA each), with A_i (M, N) row-major f32:
//   r = A x - b;  g = A^T r;  y = x - gamma g;  z = sign(y) max(|y| - thr, 0)
//   [z = z / shrink]   (divide, not multiply by the reciprocal: bit-faithful
//                       to ElasticNet.prox)
//   res = max |x - z|,  rs = sum (x - z)(z - z_prev)
//   fista_step only: beta = 0 if RESTART and rs > 0;  x <- z + beta (z - z_prev);
//   z_prev <- z, both in place.  A frozen lane (done != 0) keeps x and z_prev
//   untouched (a select, not the TPU kernel's blend: equal for finite values,
//   and a frozen lane stays finite when x+ is not) and reports res = rs = 0.
//
// Bound: reading A from device memory.  At the flagship shape (256, 200, 400)
// A is 81.9 MB per step, ~24.5 us at the H100 datasheet's 3.35 TB/s if read
// once.  This version reads A twice (pass 1 row-wise, pass 2 column-wise);
// one lane's A is 312.5 KiB, more than a block's 227 KB of shared memory, so
// it cannot be staged whole, and the second read is meant to hit the 50 MB L2
// while the lane's slab is still resident.  Frozen lanes return before
// touching A, so a batch whose lanes converge reads less.  Reading A once
// (a 2-CTA cluster reducing A^T r through DSMEM, or a persistent kernel) is
// later work.
//
// Plain C interface for ctypes.  Every entry launches on the given stream,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;  // loads of A each thread keeps in flight

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

// Block-wide reductions; every thread gets the result.  `scratch` holds
// 2 * kWarps floats.
__device__ __forceinline__ void block_reduce(float& mx, float& sum,
                                             float* scratch) {
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
}

// Pass 1: r = A x - b into shared memory.  x is already in shared memory.
// Each warp takes rows with a stride; lanes stride along the row, so the
// reads of the row-major slab are coalesced.  The loads of a row are issued
// kUnroll at a time before their products are summed: the step is bound by
// how many reads are in flight, and the compiler does not batch them across
// the dependent sum on its own.  The order of the sum is unchanged.
__device__ __forceinline__ void residual(const float* __restrict__ Ai,
                                         const float* __restrict__ bi,
                                         const float* xs, float* r, int M,
                                         int N) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int m = warp; m < M; m += kWarps) {
    const float* row = Ai + (size_t)m * N;
    float acc = 0.f;
    int n = lane;
    for (; n + 32 * (kUnroll - 1) < N; n += 32 * kUnroll) {
      float a[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) a[j] = __ldg(row + n + 32 * j);
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) acc = fmaf(a[j], xs[n + 32 * j], acc);
    }
    for (; n < N; n += 32) acc = fmaf(__ldg(row + n), xs[n], acc);
    acc = warp_sum(acc);
    if (lane == 0) r[m] = acc - bi[m];
  }
}

// Pass 2 and the prox for column n: g = (A^T r)_n, then z.  Threads take
// neighbouring columns, so each step of the m loop is a coalesced row read.
template <bool SHRINK>
__device__ __forceinline__ float prox_column(const float* __restrict__ Ai,
                                             const float* r, float xv, int n,
                                             int M, int N, float gamma,
                                             float thr, float shrink) {
  // kUnroll loads in flight, as in pass 1; the sum runs over m in order
  const float* col = Ai + n;
  float g = 0.f;
  int m = 0;
  for (; m + kUnroll <= M; m += kUnroll) {
    float a[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) a[j] = __ldg(col + (size_t)(m + j) * N);
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) g = fmaf(a[j], r[m + j], g);
  }
  for (; m < M; ++m) g = fmaf(__ldg(col + (size_t)m * N), r[m], g);
  // explicit roundings: y = x - gamma * g as two ops, like the reference
  const float y = __fsub_rn(xv, __fmul_rn(gamma, g));
  const float a = fabsf(y) - thr;
  // max(a, 0) that keeps a NaN (fmaxf would drop it)
  const float mag = (a > 0.f || a != a) ? a : 0.f;
  float z = copysignf(mag, y);
  if (SHRINK) z = z / shrink;
  return z;
}

template <bool RESTART, bool SHRINK>
__global__ void __launch_bounds__(kThreads)
fista_step_kernel(const float* __restrict__ A, const float* __restrict__ b,
                  float* __restrict__ x, float* __restrict__ zp,
                  const float* __restrict__ beta,
                  const float* __restrict__ gamma,
                  const float* __restrict__ thr,
                  const float* __restrict__ done,
                  const float* __restrict__ shrink, float* __restrict__ res,
                  float* __restrict__ rs, int M, int N) {
  extern __shared__ float smem[];
  float* xs = smem;      // N: x, then z (each column by its owning thread)
  float* r = smem + N;   // M
  __shared__ float scratch[2 * kWarps];

  const int i = blockIdx.x;
  if (done[i] != 0.f) {  // frozen lane: carries untouched, read-outs 0
    if (threadIdx.x == 0) {
      res[i] = 0.f;
      rs[i] = 0.f;
    }
    return;
  }
  const float* Ai = A + (size_t)i * M * N;
  float* xi = x + (size_t)i * N;
  float* zpi = zp + (size_t)i * N;
  const float gi = gamma[i], ti = thr[i];
  const float si = SHRINK ? shrink[i] : 1.f;

  for (int n = threadIdx.x; n < N; n += kThreads) xs[n] = xi[n];
  __syncthreads();
  residual(Ai, b + (size_t)i * M, xs, r, M, N);
  __syncthreads();

  float mx = 0.f, dot = 0.f;
  for (int n = threadIdx.x; n < N; n += kThreads) {
    const float xv = xs[n];
    const float z = prox_column<SHRINK>(Ai, r, xv, n, M, N, gi, ti, si);
    const float d = xv - z;
    mx = nanmax(mx, fabsf(d));
    dot = fmaf(d, z - zpi[n], dot);
    xs[n] = z;  // x[n] is no longer needed: only this thread reads column n
  }
  block_reduce(mx, dot, scratch);

  const float bi = (RESTART && dot > 0.f) ? 0.f : beta[i];
  for (int n = threadIdx.x; n < N; n += kThreads) {
    const float z = xs[n];
    xi[n] = __fadd_rn(z, __fmul_rn(bi, z - zpi[n]));
    zpi[n] = z;
  }
  if (threadIdx.x == 0) {
    res[i] = mx;
    rs[i] = dot;
  }
}

template <bool SHRINK>
__global__ void __launch_bounds__(kThreads)
fb_step_kernel(const float* __restrict__ A, const float* __restrict__ b,
               const float* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ thr,
               const float* __restrict__ shrink, float* __restrict__ z_out,
               float* __restrict__ res, int M, int N) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* r = smem + N;
  __shared__ float scratch[2 * kWarps];

  const int i = blockIdx.x;
  const float* Ai = A + (size_t)i * M * N;
  const float* xi = x + (size_t)i * N;
  float* zi = z_out + (size_t)i * N;
  const float gi = gamma[i], ti = thr[i];
  const float si = SHRINK ? shrink[i] : 1.f;

  for (int n = threadIdx.x; n < N; n += kThreads) xs[n] = xi[n];
  __syncthreads();
  residual(Ai, b + (size_t)i * M, xs, r, M, N);
  __syncthreads();

  float mx = 0.f, unused = 0.f;
  for (int n = threadIdx.x; n < N; n += kThreads) {
    const float xv = xs[n];
    const float z = prox_column<SHRINK>(Ai, r, xv, n, M, N, gi, ti, si);
    mx = nanmax(mx, fabsf(xv - z));
    zi[n] = z;
  }
  block_reduce(mx, unused, scratch);
  if (threadIdx.x == 0) res[i] = mx;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return cudaSuccess;
}

}  // namespace

extern "C" {

int proxtpu_fista_step(const float* A, const float* b, float* x, float* zp,
                       const float* beta, const float* gamma,
                       const float* thr, const float* done,
                       const float* shrink, float* res, float* rs, int B,
                       int M, int N, int restart, void* stream) {
  const size_t smem = (size_t)(N + M) * sizeof(float);
  auto kernel = restart ? (shrink ? fista_step_kernel<true, true>
                                  : fista_step_kernel<true, false>)
                        : (shrink ? fista_step_kernel<false, true>
                                  : fista_step_kernel<false, false>);
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      A, b, x, zp, beta, gamma, thr, done, shrink, res, rs, M, N);
  return (int)cudaGetLastError();
}

int proxtpu_fb_step(const float* A, const float* b, const float* x,
                    const float* gamma, const float* thr, const float* shrink,
                    float* z, float* res, int B, int M, int N, void* stream) {
  const size_t smem = (size_t)(N + M) * sizeof(float);
  auto kernel = shrink ? fb_step_kernel<true> : fb_step_kernel<false>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(A, b, x, gamma, thr,
                                                      shrink, z, res, M, N);
  return (int)cudaGetLastError();
}

// Largest dynamic shared memory a block of this device may opt in to.
int proxtpu_max_smem_optin(int device, int* out) {
  return (int)cudaDeviceGetAttribute(
      out, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

const char* proxtpu_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
