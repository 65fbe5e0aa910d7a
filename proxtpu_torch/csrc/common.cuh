// Device helpers shared by the port's kernels: warp and block reductions
// that keep a NaN in max (like jnp.max / torch.amax), the launch-attribute
// step for large dynamic shared memory, a NaN-keeping clip, and the tile
// pass: a ring of row tiles of an operator in shared memory, filled by the
// bulk copy and used for both products A x and A^T r, so that the operator
// is read from device memory once (TileRing, which the three lasso kernels
// share), or for A x alone (the box-QP kernel).  The operator's entries are
// float, or bfloat16 cast up to float as each is read (the one-step lasso
// kernels' bf16-A instance).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

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

// Block-wide max and sum of the block's first THREADS threads; every thread
// of the block calls it and gets both (a block may be larger than THREADS:
// what its other threads pass in is ignored).  `scratch` holds
// 2 * (THREADS / 32) floats.  Starts and ends with a barrier's worth of
// synchronisation, so it may be called in a loop.
template <int THREADS>
__device__ __forceinline__ void block_reduce(float& mx, float& sum,
                                             float* scratch) {
  constexpr int kWarps = THREADS / 32;
  static_assert(kWarps <= 32, "one warp finishes the reduction");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  mx = warp_nanmax(mx);
  sum = warp_sum(sum);
  if (lane == 0 && warp < kWarps) {
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
// A tile is `rows` full rows of a row-major operator (rows, N) of entries of
// type T (float or __nv_bfloat16): one contiguous run of rows * N *
// sizeof(T) bytes.  Where the run starts on 16 bytes and N * sizeof(T) is a
// multiple of 16, one thread fills a stage of the ring with one bulk copy
// (cp.async.bulk, no tensor map) that reports its bytes to the stage's
// mbarrier; else every thread fills it with ordinary loads and stores.  Both
// passes then read the tile from shared memory, each entry cast to float as
// it is read (exact for bf16, nothing for float):
//   tile_rows_dot  out[m] = a_m . x -+ c[m]  a warp per row: a lane strides
//                  the row by 32 in one fmaf chain, then the warp's tree
//   tile_cols_fma  g[n] += sum_m r[m] A[m, n]  a thread per column, rows in
//                  ascending order in one fmaf chain
// The order of every sum is that of a warp per row and a column loop over
// the whole operator, whatever the tile height: cutting into tiles changes
// no bit, and a bf16 operator gives the bits of the float operator of the
// same values.

// An operator entry as float: bf16 -> float is exact.
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

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

// One thread: arrive on the stage's barrier, which then waits for `bytes`
// more bytes of bulk copies.
__device__ __forceinline__ void mbarrier_expect_bytes(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(shared_addr(bar)),
               "r"(bytes)
               : "memory");
}

// One thread: start the bulk copy of `bytes` (a multiple of 16, source and
// destination on 16 bytes) to `dst` in shared memory, which reports its
// bytes to `bar`.
template <typename T>
__device__ __forceinline__ void bulk_copy(T* dst, const T* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(shared_addr(dst)),
      "l"(src), "r"(bytes), "r"(shared_addr(bar))
      : "memory");
}

// One thread: arm the stage's barrier with `bytes` and start the bulk copy
// of `bytes` into the stage.
template <typename T>
__device__ __forceinline__ void fill_stage_bulk(T* stage, const T* src,
                                                uint32_t bytes,
                                                uint64_t* bar) {
  mbarrier_expect_bytes(bar, bytes);
  bulk_copy(stage, src, bytes, bar);
}

// Every thread: copy `count` entries into the stage with ordinary loads,
// four in flight per thread; readable after the next block barrier.
template <int THREADS, typename T>
__device__ __forceinline__ void fill_stage_loads(T* stage,
                                                 const T* __restrict__ src,
                                                 int count) {
  int k = threadIdx.x;
  for (; k + 3 * THREADS < count; k += 4 * THREADS) {
    T v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = __ldg(src + k + j * THREADS);
#pragma unroll
    for (int j = 0; j < 4; ++j) stage[k + j * THREADS] = v[j];
  }
  for (; k < count; k += THREADS) stage[k] = __ldg(src + k);
}

// Where the N entries of a row lie in device memory, `stride` entries from
// one row to the next.  In the natural layout (PACKED false) a row is one
// run.  In the lane-packed layout of kernels/lasso.py (pack_lasso_batch) a
// problem's row is two runs: its first `nfull` entries, and the other
// N - nfull `gap` entries further on; entry n is at offset map(n).
template <bool PACKED>
struct RowMap {
  size_t stride;
  int nfull;
  size_t gap;
  __device__ __forceinline__ size_t operator()(int n) const {
    if constexpr (PACKED)
      return n < nfull ? (size_t)n : (size_t)n + gap;
    else
      return (size_t)n;
  }
};

// The rows of an operator in the natural layout: one run of N entries each.
__host__ __device__ inline RowMap<false> natural_rows(int N) {
  return RowMap<false>{(size_t)N, N, 0};
}

// Pass 1 on a tile: out[m] = a_m . x - c[m] (or + c[m] where ADD) for its
// `rows` rows, row m's entry n at tile + m map.stride + map(n) (RowMap: a
// tile in shared memory, or a natural lane read in place, is natural_rows;
// a packed lane read in place, two runs a row).  A warp takes rows with a
// stride; a lane strides the row by 32 in one fmaf chain, then the warp's
// tree.  The loads of a row are issued kUnroll at a time before their
// products are summed: a pass is bound by how many reads are in flight, and
// the compiler does not batch them across the dependent sum on its own.  The
// row's tail (fewer than kUnroll entries a lane) is one more batch under a
// predicate, so that its loads too are in flight together.  The order of the
// sum depends neither on kUnroll nor on the map.  `tile` is in shared memory
// (or, read in place, in device memory); x in shared memory.  c may be out
// itself (a packed lane's b, gathered into r): lane 0 reads c[m] before it
// writes out[m], and no other thread touches either, so c is not
// __restrict__.
template <int THREADS, bool ADD = false, typename T = float, bool PACKED>
__device__ __forceinline__ void tile_rows_dot(const T* tile,
                                              RowMap<PACKED> map,
                                              const float* c, const float* x,
                                              float* out, int rows, int N) {
  constexpr int kWarps = THREADS / 32;
  constexpr int kUnroll = 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int m = warp; m < rows; m += kWarps) {
    const T* row = tile + (size_t)m * map.stride;
    float acc = 0.f;
    int n = lane;
    for (; n + 32 * (kUnroll - 1) < N; n += 32 * kUnroll) {
      float a[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j)
        a[j] = to_float(row[map(n + 32 * j)]);
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) acc = fmaf(a[j], x[n + 32 * j], acc);
    }
    if (n < N) {
      float a[kUnroll - 1], xv[kUnroll - 1];
#pragma unroll
      for (int j = 0; j < kUnroll - 1; ++j) {
        const bool in = n + 32 * j < N;
        a[j] = in ? to_float(row[map(n + 32 * j)]) : 0.f;
        xv[j] = in ? x[n + 32 * j] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kUnroll - 1; ++j)
        if (n + 32 * j < N) acc = fmaf(a[j], xv[j], acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) out[m] = ADD ? acc + c[m] : acc - c[m];
  }
}

// Pass 1 on a tile of rows in the natural layout.
template <int THREADS, bool ADD = false, typename T = float>
__device__ __forceinline__ void tile_rows_dot(const T* tile,
                                              const float* __restrict__ c,
                                              const float* x, float* out,
                                              int rows, int N) {
  tile_rows_dot<THREADS, ADD, T>(tile, natural_rows(N), c, x, out, rows, N);
}

// Pass 2 on one column of a tile: acc + sum over the tile's rows, ascending,
// of r[m] * A[m, n], in one fmaf chain; `col` points at the column's first
// entry, and the next row's is `stride` entries on (N in a tile).  r is in
// shared memory: where it starts on 16 bytes, eight of its entries are two
// loads.  The tail (fewer than kUnroll rows) is one more batch under a
// predicate.
template <typename T>
__device__ __forceinline__ float tile_col_fma(const T* col, const float* r,
                                              int rows, size_t stride,
                                              float acc) {
  constexpr int kUnroll = 8;
  const bool vec = (reinterpret_cast<uintptr_t>(r) & 15) == 0;
  int m = 0;
  for (; m + kUnroll <= rows; m += kUnroll) {
    float a[kUnroll], rv[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) a[j] = col[(m + j) * stride];
    if (vec) {
      const float4 lo = *reinterpret_cast<const float4*>(r + m);
      const float4 hi = *reinterpret_cast<const float4*>(r + m + 4);
      rv[0] = lo.x, rv[1] = lo.y, rv[2] = lo.z, rv[3] = lo.w;
      rv[4] = hi.x, rv[5] = hi.y, rv[6] = hi.z, rv[7] = hi.w;
    } else {
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) rv[j] = r[m + j];
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) acc = fmaf(a[j], rv[j], acc);
  }
  if (m < rows) {
    float a[kUnroll - 1], rv[kUnroll - 1];
#pragma unroll
    for (int j = 0; j < kUnroll - 1; ++j) {
      const bool in = m + j < rows;
      a[j] = in ? to_float(col[(m + j) * stride]) : 0.f;
      rv[j] = in ? r[m + j] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kUnroll - 1; ++j)
      if (m + j < rows) acc = fmaf(a[j], rv[j], acc);
  }
  return acc;
}

// Pass 2 on a tile: g[n] (+)= sum over the tile's rows, ascending, of
// r[m] * A[m, n], a thread per column; `first` starts the chain from 0.
// Only the thread that owns column n touches g[n].
template <int THREADS, typename T>
__device__ __forceinline__ void tile_cols_fma(const T* tile, const float* r,
                                              float* g, int rows, int N,
                                              bool first) {
  for (int n = threadIdx.x; n < N; n += THREADS)
    g[n] = tile_col_fma(tile + n, r, rows, N, first ? 0.f : g[n]);
}

// ---- The bfloat16 passes -------------------------------------------------
//
// The same sums in the same order as tile_rows_dot and tile_cols_fma on a
// bf16 tile, with fewer shared-memory instructions an entry:
//   tile_rows_dot_xreg  lane l keeps x[l + 32 k] in registers, k < KX =
//                       ceil(N / 32) <= kXRegs, for every row of every tile,
//                       so pass 1 loads only A from shared memory
//   tile_cols_fma_pair  a thread per two adjacent columns (N even): one
//                       32-bit load (a bf16 pair) per row feeds two chains
// A bf16 pair in a 32-bit word holds column n in its low half (little
// endian); bf16 -> float is the half moved to the top 16 bits (exact).
constexpr int kXRegs = 16;  // x in registers up to N = 32 * kXRegs

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// Pass 1 on a tile of bf16 rows, x in registers: out[m] = a_m . x - c[m].
// KX chunks a lane: the first KX - 1 in every lane, the last in the lanes
// with l + 32 (KX - 1) < N.  All of a row's loads go out before its
// products are summed, in the order of tile_rows_dot.
template <int THREADS, int KX>
__device__ __forceinline__ void rows_dot_xreg(const __nv_bfloat16* tile,
                                              const float* __restrict__ c,
                                              const float (&xr)[kXRegs],
                                              float* out, int rows, int N) {
  constexpr int kWarps = THREADS / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool last = lane + 32 * (KX - 1) < N;
  for (int m = warp; m < rows; m += kWarps) {
    const __nv_bfloat16* row = tile + m * N + lane;
    float a[KX];
#pragma unroll
    for (int k = 0; k < KX - 1; ++k) a[k] = to_float(row[32 * k]);
    a[KX - 1] = last ? to_float(row[32 * (KX - 1)]) : 0.f;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < KX - 1; ++k) acc = fmaf(a[k], xr[k], acc);
    if (last) acc = fmaf(a[KX - 1], xr[KX - 1], acc);
    acc = warp_sum(acc);
    if (lane == 0) out[m] = acc - c[m];
  }
}

// rows_dot_xreg at the block's KX = ceil(N / 32), 1 <= KX <= kXRegs (a
// uniform jump once per tile).
template <int THREADS>
__device__ __forceinline__ void tile_rows_dot_xreg(
    const __nv_bfloat16* tile, const float* __restrict__ c,
    const float (&xr)[kXRegs], float* out, int rows, int N) {
  switch ((N + 31) / 32) {
#define PROXTPU_ROWS_DOT_XREG(K) \
  case K:                        \
    rows_dot_xreg<THREADS, K>(tile, c, xr, out, rows, N); \
    break;
    PROXTPU_ROWS_DOT_XREG(1) PROXTPU_ROWS_DOT_XREG(2) PROXTPU_ROWS_DOT_XREG(3)
    PROXTPU_ROWS_DOT_XREG(4) PROXTPU_ROWS_DOT_XREG(5) PROXTPU_ROWS_DOT_XREG(6)
    PROXTPU_ROWS_DOT_XREG(7) PROXTPU_ROWS_DOT_XREG(8) PROXTPU_ROWS_DOT_XREG(9)
    PROXTPU_ROWS_DOT_XREG(10) PROXTPU_ROWS_DOT_XREG(11)
    PROXTPU_ROWS_DOT_XREG(12) PROXTPU_ROWS_DOT_XREG(13)
    PROXTPU_ROWS_DOT_XREG(14) PROXTPU_ROWS_DOT_XREG(15)
    PROXTPU_ROWS_DOT_XREG(16)
#undef PROXTPU_ROWS_DOT_XREG
  }
}

// Pass 2 on a tile of bf16 rows (N even, rows on 4 bytes), two adjacent
// columns a thread: g[n], g[n + 1] (+)= sum over the tile's rows, ascending,
// of r[m] A[m, n] and r[m] A[m, n + 1], one fmaf chain each, as
// tile_cols_fma sums them; `first` starts the chains from 0.  Only the
// thread that owns the pair touches it.
template <int THREADS>
__device__ __forceinline__ void tile_cols_fma_pair(const __nv_bfloat16* tile,
                                                   const float* r, float* g,
                                                   int rows, int N,
                                                   bool first) {
  constexpr int kUnroll = 8;
  const int words = N / 2;
  const bool vec = (reinterpret_cast<uintptr_t>(r) & 15) == 0;
  const uint32_t* base = reinterpret_cast<const uint32_t*>(tile);
  float2* g2 = reinterpret_cast<float2*>(g);
  for (int p = threadIdx.x; p < words; p += THREADS) {
    const uint32_t* col = base + p;
    float2 acc = first ? make_float2(0.f, 0.f) : g2[p];
    int m = 0;
    for (; m + kUnroll <= rows; m += kUnroll) {
      uint32_t w[kUnroll];
      float rv[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) w[j] = col[(m + j) * words];
      if (vec) {
        const float4 lo = *reinterpret_cast<const float4*>(r + m);
        const float4 hi = *reinterpret_cast<const float4*>(r + m + 4);
        rv[0] = lo.x, rv[1] = lo.y, rv[2] = lo.z, rv[3] = lo.w;
        rv[4] = hi.x, rv[5] = hi.y, rv[6] = hi.z, rv[7] = hi.w;
      } else {
#pragma unroll
        for (int j = 0; j < kUnroll; ++j) rv[j] = r[m + j];
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        acc.x = fmaf(bf16_lo(w[j]), rv[j], acc.x);
        acc.y = fmaf(bf16_hi(w[j]), rv[j], acc.y);
      }
    }
    if (m < rows) {
      uint32_t w[kUnroll - 1];
      float rv[kUnroll - 1];
#pragma unroll
      for (int j = 0; j < kUnroll - 1; ++j) {
        const bool in = m + j < rows;
        w[j] = in ? col[(m + j) * words] : 0u;
        rv[j] = in ? r[m + j] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kUnroll - 1; ++j)
        if (m + j < rows) {
          acc.x = fmaf(bf16_lo(w[j]), rv[j], acc.x);
          acc.y = fmaf(bf16_hi(w[j]), rv[j], acc.y);
        }
    }
    g2[p] = acc;
  }
}

// How the tiles of a slab reach the two passes: through the ring by the bulk
// copy, through the ring by ordinary loads (a lane that does not start on 16
// bytes, or N * 4 no multiple of 16), or read in place from device memory,
// twice, where no ring fits the block's shared memory.
enum Fill { kFillBulk = 0, kFillLoads = 1, kFillNone = 2 };

__host__ __device__ inline size_t round_up(size_t v, size_t to) {
  return (v + to - 1) / to * to;
}

// One block's walk over its slab of `rows` full rows of N entries of type T
// (float, or bf16 in the one-step lasso kernels), in tiles
// of R rows (the last may be short) through a ring of S stages, `sweeps`
// times over.  Tile number q of sweeps * ntiles is tile q % ntiles of the
// slab and goes through stage q % S; its barrier completes phase q / S.  A
// stage is refilled once every thread has finished both passes on the tile
// in it, which a block barrier after a later tile's pass 1 shows:
// `refill(released)` is called right after such a barrier with the number of
// tiles released so far, and starts every fill the ring has room for.
//
//   ring.init_barriers();  __syncthreads();  ring.prime();
//   per sweep:  ring.sweep(c, x, r, g);  a block (or cluster) barrier;
//               ring.refill(ring.q);
//   or, pass 1 alone, per sweep:  ring.sweep_rows(c, x, out);
//
// After sweep(), r[m] = a_m . x - c[m] for the slab's rows (c may be r
// itself: tile_rows_dot), and g[n] = sum over the slab's rows, ascending, of
// r[m] A[m, n], which the thread that owns column n (n = threadIdx.x + k
// THREADS) may read at once; A crossed the memory system once.  After
// sweep_rows(), out[m] = a_m . x + c[m] for the slab's rows, readable after
// the block's next barrier; a tile's stage is refilled right after the
// barrier that ends its pass 1.  With ordinary loads a refill is read at
// least one tile's barrier after its stores, which needs S >= 3 or a slab of
// one tile (no refill at all).  Every thread of the block makes every call.
//
// With PACKED, the slab's rows lie as `map` says (RowMap: two runs a row,
// `map.stride` entries apart) and a fill gathers a tile's rows into the
// stage as if they were one run of rows * N entries, so that the passes
// read the same tile: by bulk copies, two a row, that the last warp's lanes
// start after one of them has armed the stage's barrier with the tile's
// bytes (every run then starts and ends on 16 bytes: N % 4 == 0), or by
// ordinary loads.
template <int THREADS, int FILL, typename T = float, bool PACKED = false>
struct TileRing {
  T* stages;            // S stages of stage_elems entries, on 128 bytes
  size_t stage_elems;
  uint64_t* bars;       // S mbarriers (bulk copy only)
  const T* slab;        // the slab's first row, in device memory
  int rows, N, R, S, ntiles, total;
  int fq, fj, fs;       // next tile to fill: number, tile of the slab, stage
  int q, cs;            // tiles consumed; the stage of tile q
  uint32_t parity;      // the phase tile q's barrier completes, mod 2
  RowMap<PACKED> map;   // where the slab's rows lie (PACKED only)

  __device__ __forceinline__ TileRing(T* stages, size_t stage_elems,
                                      uint64_t* bars, const T* slab,
                                      int rows, int N, int R, int S,
                                      int sweeps, RowMap<PACKED> map = {})
      : stages(stages), stage_elems(stage_elems), bars(bars), slab(slab),
        rows(rows), N(N), R(R), S(S), ntiles((rows + R - 1) / R),
        total(sweeps * ((rows + R - 1) / R)), fq(0), fj(0), fs(0), q(0),
        cs(0), parity(0), map(map) {}

  // before the block barrier that precedes prime()
  __device__ __forceinline__ void init_barriers() {
    if (FILL == kFillBulk && threadIdx.x == 0) {
      for (int s = 0; s < S; ++s) mbarrier_init(&bars[s], 1);
      mbarrier_init_fence();
    }
  }

  __device__ __forceinline__ void refill(int released) {
    if (FILL != kFillNone) {
      while (fq < total && fq < released + S) {
        const T* src = slab + (size_t)fj * R * N;
        const int count = min(R, rows - fj * R) * N;
        T* stage = stages + fs * stage_elems;
        if constexpr (PACKED) {
          fill_packed(stage, slab + (size_t)fj * R * map.stride,
                      min(R, rows - fj * R), &bars[fs]);
        } else if (FILL == kFillBulk) {
          // by the last warp, which has no row of a short tile in pass 1
          if (threadIdx.x == THREADS - 32)
            fill_stage_bulk(stage, src, (uint32_t)count * sizeof(T),
                            &bars[fs]);
        } else {
          fill_stage_loads<THREADS>(stage, src, count);
        }
        ++fq;
        if (++fj == ntiles) fj = 0;
        if (++fs == S) fs = 0;
      }
    }
  }

  // the first fills; ordinary stores into the first stages are read after
  // this barrier
  __device__ __forceinline__ void prime() {
    refill(0);
    if (FILL == kFillLoads) __syncthreads();
  }

  __device__ __forceinline__ void sweep(const float* c, const float* x,
                                        float* r, float* g) {
    for (int j = 0; j < ntiles; ++j) {
      const int tile_rows = min(R, rows - j * R);
      const T* tile = wait_tile(j);
      tile_rows_dot<THREADS, false, T>(tile, natural_rows(N), c + j * R, x,
                                       r + j * R, tile_rows, N);
      // r of this tile complete; every thread is past pass 2 of the tile
      // before, whose stage is free
      __syncthreads();
      refill(q);
      tile_cols_fma<THREADS, T>(tile, r + j * R, g, tile_rows, N, j == 0);
      next_tile();
    }
  }

  // sweep() with the caller's passes: rows(tile, m0, tile_rows) on the tile
  // of the slab's rows [m0, m0 + tile_rows) once it has landed, then a
  // block barrier, then cols(tile, m0, tile_rows) (the bf16 instances)
  template <typename Rows, typename Cols>
  __device__ __forceinline__ void sweep_with(Rows rows_pass, Cols cols_pass) {
    for (int j = 0; j < ntiles; ++j) {
      const int tile_rows = min(R, rows - j * R);
      const T* tile = wait_tile(j);
      rows_pass(tile, j * R, tile_rows);
      __syncthreads();
      refill(q);
      cols_pass(tile, j * R, tile_rows);
      next_tile();
    }
  }

  __device__ __forceinline__ void sweep_rows(const float* __restrict__ c,
                                             const float* x, float* out) {
    for (int j = 0; j < ntiles; ++j) {
      const int tile_rows = min(R, rows - j * R);
      const T* tile = wait_tile(j);
      tile_rows_dot<THREADS, true, T>(tile, c + j * R, x, out + j * R,
                                      tile_rows, N);
      __syncthreads();  // every thread is past this tile, whose stage is free
      next_tile();
      refill(q);
    }
  }

 private:
  // PACKED: the tile of `nrows` rows from `src` into `stage`, row k's
  // entries at stage + k N, as the natural layout's one run would put them
  __device__ __forceinline__ void fill_packed(T* stage, const T* src,
                                              int nrows, uint64_t* bar) {
    if (FILL == kFillBulk) {
      // by the last warp, which has no row of a short tile in pass 1
      if (threadIdx.x >= THREADS - 32) {
        const int lane = threadIdx.x % 32, left = N - map.nfull;
        if (lane == 0)
          mbarrier_expect_bytes(bar, (uint32_t)(nrows * N * sizeof(T)));
        __syncwarp();
        for (int k = lane; k < nrows; k += 32) {
          const T* row = src + (size_t)k * map.stride;
          T* dst = stage + (size_t)k * N;
          if (map.nfull > 0)
            bulk_copy(dst, row, (uint32_t)(map.nfull * sizeof(T)), bar);
          if (left > 0)
            bulk_copy(dst + map.nfull, row + map(map.nfull),
                      (uint32_t)(left * sizeof(T)), bar);
        }
      }
    } else {
      for (int k = threadIdx.x; k < nrows * N; k += THREADS) {
        const int m = k / N;
        stage[k] = __ldg(src + (size_t)m * map.stride + map(k - m * N));
      }
    }
  }

  // tile j of the slab: in its stage once its copy has landed, or in place
  __device__ __forceinline__ const T* wait_tile(int j) {
    if (FILL == kFillNone) return slab + (size_t)j * R * N;
    if (FILL == kFillBulk) mbarrier_wait(&bars[cs], parity);
    return stages + cs * stage_elems;
  }

  __device__ __forceinline__ void next_tile() {
    ++q;
    if (++cs == S) {
      cs = 0;
      parity ^= 1;
    }
  }
};

// Launch attributes of a kernel that may want most of an SM's shared memory
// for several resident blocks: raises the kernel's dynamic shared memory
// limit to `smem` and asks for the largest shared-memory carveout.  The
// attributes are set once per device and size, not once per launch.
struct Prepared {
  std::mutex lock;
  int device = -1;
  size_t bytes = 0;
};

template <typename Kernel>
cudaError_t prepare_once(Prepared& done, Kernel kernel, size_t smem) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> guard(done.lock);
  if (done.device == device && smem <= done.bytes) return cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  done.device = device;
  done.bytes = smem;
  return cudaSuccess;
}

}  // namespace proxtpu
