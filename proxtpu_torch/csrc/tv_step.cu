// Hopper (sm_90a) kernels for K Chambolle-Pock iterations of TV denoising.
//
// Replaces the Pallas TPU kernel of proxtpu/kernels/tv.py:
//   cp_k_steps <- _cp_k_steps_kernel (tv.py:76, body _cp_body, via
//                 fused_cp_k_steps)
//
// Per image i, with b, x, yx, yy (H, W) row-major f32 and the image's own
// g1, g2, lam, one iteration is
//   div  = (dxm - dxm[r-1]) + (dym - dym[c-1])   dxm = yx, 0 on the last row
//                                                dym = yy, 0 on the last col
//   xbar = ((x + g1 div) + g1 b) / (1 + g1)
//   mid  = 2 xbar - x
//   gx   = mid[r+1] - mid (0 on the last row);  gy likewise along columns
//   v    = y + g2 (gx, gy);  n = sqrt(vx^2 + vy^2)
//   ybar = v * (n > lam ? lam / max(n, 1e-30) : 1)
// and res = max|xbar - x| + max(max|ybx - yx|, max|yby - yy|) of the last
// of the K iterations.  Boundary values are SELECTED as 0, never multiplied
// by a 0 mask: the cell outside is not read.  Every operation is rounded on
// its own (__fmul_rn, __fadd_rn, IEEE division and square root, no fma
// contraction), in the plain version's order, so both kernels return the
// plain version's bits.
//
// The TPU kernel packed 128 / W images side by side to fill its lanes,
// masked the seams, wrote six planes (the last and the previous state) and
// left the residual to XLA.  Here the natural (H, W) layout of an image is
// kept, the previous step's values stay in registers for the residual, the
// residual is reduced on the chip and three planes are written.
//
// What bounds it: the bytes are few (four planes read and three written per
// launch, whatever K: 35 us at 64 x 256 x 256 on 3.35 TB/s), the
// instructions many (about 25 floating-point operations a cell and step, of
// which two IEEE divisions and a square root are sequences of their own:
// 89 instructions a cell and step in the loops of cp_band_kernel's SASS),
// so the kernel is bound by instruction issue and shared-memory traffic.
// The design keeps every instruction on a cell the image needs:
//
// cp_band_kernel (the rule): a thread-block cluster of C blocks per image,
//   block c owning the band of full rows [c H / C, (c + 1) H / C); an image
//   one block holds takes one block (C = 1).  The five planes of a band (b,
//   x, yx, yy, mid) stay in the block's shared memory for the K steps and
//   each cell is computed once a step: no halo.  The stencils reach one row
//   up (yx[r-1] in the divergence) and one row down (mid[r+1] in gx), so
//   only a band's first and last rows need a neighbour's: they are read from
//   its shared memory (distributed shared memory).  Two cluster barriers a
//   step: after the primal half (mid complete, every read of the old y
//   done) and after the dual half (y complete, every read of mid done).  A
//   thread owns one column (several where W exceeds the block) and walks
//   down a run of rows with the row above's yx and the row's mid in
//   registers; every other operand is one shared-memory access of a warp's
//   32 consecutive cells (the planes lie a compile-time spacing apart, so
//   one address reaches all five).  The residual is computed on the last
//   step only (a step of its own in the code), reduced in the block and then
//   by rank 0 over the cluster's blocks; one launch a call, no scratch, no
//   atomics.  On an NVIDIA H100 80GB HBM3 at 700 W, K = 8: 64 x 256 x 256 in
//   clusters of 16 blocks of 512 threads (two an SM) about 248 us, 64 x 64 x
//   64 one block of 1024 threads an image about 25 us (the halo kernel this
//   one replaced: 305 and 32).
//
// cp_halo_kernel: for an image no cluster can hold (five planes of 512 x 512
//   are 5.2 MB, 16 blocks hold 3.6 MB).  A block loads its tile with a halo
//   of K cells per side, clipped to the image, runs the K steps on all of it
//   and stores the tile alone.  After step s the cells within s of a
//   clipped-off side are wrong (a neighbour outside the region was not
//   loaded and counted as 0); they never reach the tile.  Where the halo
//   ends at the image's edge the 0 is the true boundary.  Neighbouring
//   blocks read what others write, so the outputs must not be the inputs.
//   The residual of a tiled image is combined by atomicMax on the bit
//   pattern of the non-negative maxima (order-independent, NaN kept as the
//   largest pattern) in a zeroed scratch; the block that draws the last
//   ticket of its image writes res.
//
// The launch plan (variant, C, threads, or the tile) is chosen on the host
// (kernels/tv.py: cp_plan) from the shape alone and checked here against
// the kernels' own layout; a plan the device refuses is an error, no other
// is tried.
//
// A frozen image (done != 0) is not advanced and reports res 0: with
// done == 1 its state is copied to the outputs, with done >= 2 the caller
// vouches that the outputs hold it already and the blocks return at once.
//
// Plain C interface for ctypes.  The entries launch on the given stream, do
// not synchronise, and return cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <mutex>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using proxtpu::nanmax;
using proxtpu::prepare;
using proxtpu::prepare_once;
using proxtpu::Prepared;
using proxtpu::warp_nanmax;

constexpr int kPlanes = 5;  // b, x, yx, yy, mid

// ---- cp_band_kernel --------------------------------------------------------

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// every thread of the cluster (of the block where C == 1)
__device__ __forceinline__ void band_sync(int C) {
  if (C > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
}

// One block's band of an image in shared memory, and the part of it one
// thread walks.  Five planes (b, x, yx, yy, mid), each of the longest band's
// rows of Wp = W rounded up to 32 floats, lie PLANE floats apart (a constant
// of the kernel at least as large as the band), so that one address and an
// immediate offset reach a cell in each, and a warp's 32 cells of a row are
// one access without bank conflicts.  They have the same
// offsets in every block of the cluster.  The columns past W are scratch:
// the threads on them compute what they compute and every value they feed to
// a real cell is selected away.  A thread owns column tc of every block of
// CW columns (CW a multiple of 32 that divides Wp) and the rows [ra, rb) of
// the band; whole warps past the last row group idle.
template <int PLANE>
struct Band {
  static constexpr int cap = PLANE;
  float* bs;          // b; x, yx, yy and mid follow at cap, 2 cap, ...
  const float* up;    // yx's row above the band, in the block above
  const float* down;  // mid's row below the band, in the block below
  int H, W, Wp, r0, rows, CW, ra, rb, tc;
  float g1, g2, lam, one_g1;
  float mx, myx, myy;  // the last step's maxima, this thread's cells

  // One cell of the primal half at p (in the b plane): xbar over x, mid
  // beside it, from y of the cell, the one above (`above`, raw) and the one
  // to the left.  Returns the cell's raw yx, the next row's `above`.
  // LASTROW: the image's last row, whose dxm is 0.
  template <bool LAST, bool LASTROW>
  __device__ __forceinline__ float primal_cell(float* p, float above,
                                               bool left_ok, bool right_ok,
                                               bool valid) {
    const float bv = p[0], xv = p[cap], yxv = p[2 * cap];
    const float yyv = p[3 * cap], yy_left = p[3 * cap - 1];
    const float left = left_ok ? yy_left : 0.f;
    const float dxm = LASTROW ? 0.f : yxv;
    const float dym = right_ok ? yyv : 0.f;
    const float div = __fadd_rn(__fsub_rn(dxm, above), __fsub_rn(dym, left));
    const float tt = __fadd_rn(xv, __fmul_rn(g1, div));
    const float xbar = __fdiv_rn(__fadd_rn(tt, __fmul_rn(g1, bv)), one_g1);
    p[cap] = xbar;
    p[4 * cap] = __fsub_rn(__fmul_rn(2.f, xbar), xv);
    if (LAST && valid) mx = nanmax(mx, fabsf(__fsub_rn(xbar, xv)));
    return yxv;
  }

  // One cell of the dual half at p: y of the cell from its own, mid of the
  // cell (`m`), of the one below (`below`) and of the one to the right.
  // INNER: a row below in the image (else gx is 0).
  template <bool LAST, bool INNER>
  __device__ __forceinline__ void dual_cell(float* p, float m, float below,
                                            bool right_ok, bool valid) {
    const float right = p[4 * cap + 1];
    const float yxv = p[2 * cap], yyv = p[3 * cap];
    const float gx = INNER ? __fsub_rn(below, m) : 0.f;
    const float gy = right_ok ? __fsub_rn(right, m) : 0.f;
    const float vx = __fadd_rn(yxv, __fmul_rn(g2, gx));
    const float vy = __fadd_rn(yyv, __fmul_rn(g2, gy));
    const float nrm =
        __fsqrt_rn(__fadd_rn(__fmul_rn(vx, vx), __fmul_rn(vy, vy)));
    const float scale = nrm > lam ? __fdiv_rn(lam, fmaxf(nrm, 1e-30f)) : 1.f;
    const float ybx = __fmul_rn(vx, scale), yby = __fmul_rn(vy, scale);
    p[2 * cap] = ybx;
    p[3 * cap] = yby;
    if (LAST && valid) {
      myx = nanmax(myx, fabsf(__fsub_rn(ybx, yxv)));
      myy = nanmax(myy, fabsf(__fsub_rn(yby, yyv)));
    }
  }

  // The primal half on column c of the thread's rows.
  template <bool LAST>
  __device__ __forceinline__ void primal(int c) {
    const bool left_ok = c > 0, right_ok = c < W - 1, valid = c < W;
    float* p = bs + ra * Wp + c;
    float above = 0.f;  // raw yx of the row above (never the image's last)
    if (r0 + ra > 0) above = ra > 0 ? p[2 * cap - Wp] : up[c];
    // the image's last row, if this thread has it, comes last
    const int rm = r0 + rb == H && rb > ra ? rb - 1 : rb;
    for (int r = ra; r < rm; ++r, p += Wp)
      above = primal_cell<LAST, false>(p, above, left_ok, right_ok, valid);
    if (rm < rb) primal_cell<LAST, true>(p, above, left_ok, right_ok, valid);
  }

  // The dual half on column c of the thread's rows; mid walks down in a
  // register.
  template <bool LAST>
  __device__ __forceinline__ void dual(int c) {
    if (ra >= rb) return;
    const bool right_ok = c < W - 1, valid = c < W;
    float* p = bs + ra * Wp + c;
    float m = p[4 * cap];
    // the band's last row, if this thread has it, comes last: its row below
    // is in the next block, or outside the image
    const int rl = rb == rows ? rb - 1 : rb;
    for (int r = ra; r < rl; ++r, p += Wp) {
      const float below = p[4 * cap + Wp];
      dual_cell<LAST, true>(p, m, below, right_ok, valid);
      m = below;
    }
    if (rl < rb) {
      if (r0 + rows < H)
        dual_cell<LAST, true>(p, m, down[c], right_ok, valid);
      else
        dual_cell<LAST, false>(p, m, 0.f, right_ok, valid);
    }
  }

  template <bool LAST>
  __device__ __forceinline__ void step(int C, bool active) {
    if (active)
      for (int c0 = 0; c0 < Wp; c0 += CW) primal<LAST>(c0 + tc);
    band_sync(C);  // mid complete; every read of the old y done
    if (active)
      for (int c0 = 0; c0 < Wp; c0 += CW) dual<LAST>(c0 + tc);
  }
};

template <int THREADS, int PLANE>
__global__ void __launch_bounds__(THREADS, 1024 / THREADS)
cp_band_kernel(const float* __restrict__ b, const float* __restrict__ x,
               const float* __restrict__ yx, const float* __restrict__ yy,
               const float* __restrict__ g1v, const float* __restrict__ g2v,
               const float* __restrict__ lamv,
               const float* __restrict__ done, float* __restrict__ xo,
               float* __restrict__ yxo, float* __restrict__ yyo,
               float* __restrict__ res, int H, int W, int K) {
  constexpr int kWarps = THREADS / 32;
  extern __shared__ __align__(16) float band_smem[];
  __shared__ float red[3 * kWarps];

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int i = blockIdx.x / C;
  const int r0 = (int)((long long)rank * H / C);
  const int rows = (int)((long long)(rank + 1) * H / C) - r0;
  const size_t base = ((size_t)i * H + r0) * W;

  // frozen image: the same test in every block of the cluster, so all
  // return before any barrier
  const float frozen = done != nullptr ? done[i] : 0.f;
  if (frozen != 0.f) {
    if (frozen < 2.f) {  // at 2 the outputs hold the band already
      for (int k = threadIdx.x; k < rows * W; k += THREADS) {
        xo[base + k] = x[base + k];
        yxo[base + k] = yx[base + k];
        yyo[base + k] = yy[base + k];
      }
    }
    if (rank == 0 && threadIdx.x == 0) res[i] = 0.f;
    return;
  }

  // a guard of 16 bytes (the left neighbour read of the band's first cell),
  // the five planes, a guard of 16 bytes (the right neighbour read of the
  // last cell)
  Band<PLANE> band;
  const int Wp = (W + 31) / 32 * 32;
  band.bs = reinterpret_cast<float*>(band_smem) + 4;
  band.H = H;
  band.W = W;
  band.Wp = Wp;
  band.r0 = r0;
  band.rows = rows;
  band.up = nullptr;
  band.down = nullptr;
  if (rank > 0) {
    const int above_rows = r0 - (int)((long long)(rank - 1) * H / C);
    band.up = cluster.map_shared_rank(band.bs, rank - 1) + 2 * PLANE +
              (above_rows - 1) * Wp;
  }
  if (rank + 1 < C)
    band.down = cluster.map_shared_rank(band.bs, rank + 1) + 4 * PLANE;

  // the walk: groups of CW column threads, each group a run of rows
  band.CW = 32;
  for (int cw = 64; cw <= THREADS && cw <= Wp; cw += 32)
    if (Wp % cw == 0) band.CW = cw;
  const int groups = THREADS / band.CW;
  const int group = threadIdx.x / band.CW;
  const bool active = group < groups;
  band.tc = threadIdx.x % band.CW;
  band.ra = active ? (int)((long long)group * rows / groups) : 0;
  band.rb = active ? (int)((long long)(group + 1) * rows / groups) : 0;
  band.g1 = g1v[i];
  band.g2 = g2v[i];
  band.lam = lamv[i];
  band.one_g1 = __fadd_rn(1.f, band.g1);
  band.mx = band.myx = band.myy = 0.f;

  // the thread's own cells in, four rows' loads in flight at a time;
  // columns past W are 0
  constexpr int cap = PLANE;
  if (active) {
    for (int c = band.tc; c < Wp; c += band.CW) {
#pragma unroll 4
      for (int r = band.ra; r < band.rb; ++r) {
        float bv = 0.f, xv = 0.f, yxv = 0.f, yyv = 0.f;
        if (c < W) {
          const size_t g = base + (size_t)r * W + c;
          bv = b[g];
          xv = x[g];
          yxv = yx[g];
          yyv = yy[g];
        }
        float* p = band.bs + r * Wp + c;
        p[0] = bv;
        p[cap] = xv;
        p[2 * cap] = yxv;
        p[3 * cap] = yyv;
      }
    }
  }
  band_sync(C);  // every band loaded

  for (int s = 0; s < K - 1; ++s) {
    band.template step<false>(C, active);
    band_sync(C);  // y complete; every read of mid done
  }
  band.template step<true>(C, active);

  // the band's three maxima into red[0..2]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float mx = warp_nanmax(band.mx), myx = warp_nanmax(band.myx),
        myy = warp_nanmax(band.myy);
  if (lane == 0) {
    red[warp] = mx;
    red[kWarps + warp] = myx;
    red[2 * kWarps + warp] = myy;
  }
  __syncthreads();
  if (warp == 0) {
    mx = warp_nanmax(lane < kWarps ? red[lane] : 0.f);
    myx = warp_nanmax(lane < kWarps ? red[kWarps + lane] : 0.f);
    myy = warp_nanmax(lane < kWarps ? red[2 * kWarps + lane] : 0.f);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    red[0] = mx;
    red[1] = myx;
    red[2] = myy;
  }
  // y complete, every read of mid done, and every block's maxima published
  band_sync(C);
  if (rank == 0 && threadIdx.x == 0) {
    float ax = red[0], ayx = red[1], ayy = red[2];
    for (int q = 1; q < C; ++q) {
      const float* other = cluster.map_shared_rank(red, q);
      ax = nanmax(ax, other[0]);
      ayx = nanmax(ayx, other[1]);
      ayy = nanmax(ayy, other[2]);
    }
    res[i] = __fadd_rn(ax, nanmax(ayx, ayy));
  }
  if (C > 1) cluster_arrive();  // rank 0 is done with the others' maxima
  if (active) {
    for (int c = band.tc; c < W; c += band.CW) {
#pragma unroll 4
      for (int r = band.ra; r < band.rb; ++r) {
        const float* p = band.bs + r * Wp + c;
        const size_t g = base + (size_t)r * W + c;
        xo[g] = p[cap];
        yxo[g] = p[2 * cap];
        yyo[g] = p[3 * cap];
      }
    }
  }
  // no block leaves while rank 0 may still read its maxima
  if (C > 1) cluster_wait();
}

// ---- cp_halo_kernel --------------------------------------------------------

constexpr int kHaloThreads = 1024;
constexpr int kHaloWarps = kHaloThreads / 32;

// (r, c) of the cell kHaloThreads after (r, c) in a region ew wide, where
// kHaloThreads = dr * ew + dc
__device__ __forceinline__ void next_cell(int& r, int& c, int dr, int dc,
                                          int ew) {
  r += dr;
  c += dc;
  if (c >= ew) {
    c -= ew;
    ++r;
  }
}

__global__ void __launch_bounds__(kHaloThreads)
cp_halo_kernel(const float* __restrict__ b, const float* __restrict__ x,
               const float* __restrict__ yx, const float* __restrict__ yy,
               const float* __restrict__ g1v, const float* __restrict__ g2v,
               const float* __restrict__ lamv,
               const float* __restrict__ done, float* __restrict__ xo,
               float* __restrict__ yxo, float* __restrict__ yyo,
               float* __restrict__ res, unsigned int* __restrict__ scratch,
               int H, int W, int K, int TH, int TW, int tiles_r,
               int tiles_c, int max_cells) {
  extern __shared__ float smem[];
  __shared__ float red[3 * kHaloWarps];

  const int tiles = tiles_r * tiles_c;
  const int i = blockIdx.x / tiles;
  const int t = blockIdx.x % tiles;
  // the tile, and the region loaded for it: the tile plus K cells per
  // side, clipped to the image
  const int r0 = (t / tiles_c) * TH, c0 = (t % tiles_c) * TW;
  const int r1 = min(H, r0 + TH), c1 = min(W, c0 + TW);
  const int er0 = max(0, r0 - K), ec0 = max(0, c0 - K);
  const int eh = min(H, r1 + K) - er0, ew = min(W, c1 + K) - ec0;
  const int cells = eh * ew;
  const size_t base = (size_t)i * H * W;

  const float frozen = done != nullptr ? done[i] : 0.f;
  if (frozen != 0.f) {
    if (frozen < 2.f) {  // copy the tile; at 2 the outputs hold it already
      const int th = r1 - r0, tw = c1 - c0;
      for (int idx = threadIdx.x; idx < th * tw; idx += kHaloThreads) {
        const size_t g = base + (size_t)(r0 + idx / tw) * W + c0 + idx % tw;
        xo[g] = x[g];
        yxo[g] = yx[g];
        yyo[g] = yy[g];
      }
    }
    if (t == 0 && threadIdx.x == 0) res[i] = 0.f;
    return;
  }

  float* bs = smem;
  float* xs = bs + max_cells;
  float* yxs = xs + max_cells;
  float* yys = yxs + max_cells;
  float* ms = yys + max_cells;

  for (int idx = threadIdx.x; idx < cells; idx += kHaloThreads) {
    const size_t g = base + (size_t)(er0 + idx / ew) * W + ec0 + idx % ew;
    bs[idx] = b[g];
    xs[idx] = x[g];
    yxs[idx] = yx[g];
    yys[idx] = yy[g];
  }
  const float g1 = g1v[i], g2 = g2v[i], lam = lamv[i];
  const float one_g1 = __fadd_rn(1.f, g1);
  // the tile inside the loaded region
  const int ir0 = r0 - er0, ir1 = r1 - er0, ic0 = c0 - ec0, ic1 = c1 - ec0;
  // the image's last row and column in the region's coordinates
  const int img_last_r = H - 1 - er0, img_last_c = W - 1 - ec0;
  float mx = 0.f, myx = 0.f, myy = 0.f;
  // a thread's cells lie kHaloThreads apart: their rows and columns follow
  // from the first by additions, with no division in the loops
  const int tr = threadIdx.x / ew, tc = threadIdx.x % ew;
  const int dr = kHaloThreads / ew, dc = kHaloThreads % ew;
  __syncthreads();

  for (int step = 0; step < K; ++step) {
    const bool last = step == K - 1;
    // primal half: xbar over x, mid beside it; reads y of the cell, the
    // one above and the one to the left
    int r = tr, c = tc;
    for (int idx = threadIdx.x; idx < cells; idx += kHaloThreads) {
      // the dual field's own cell is always loaded, so its mask is the
      // image's last row and column, not the region's: masking at a
      // clipped-off side would put one more wrong row into y than the
      // halo has room for
      const float dxm = r < img_last_r ? yxs[idx] : 0.f;
      const float dym = c < img_last_c ? yys[idx] : 0.f;
      const float up = r > 0 ? yxs[idx - ew] : 0.f;
      const float left = c > 0 ? yys[idx - 1] : 0.f;
      const float div = __fadd_rn(__fsub_rn(dxm, up), __fsub_rn(dym, left));
      const float xv = xs[idx];
      const float tt = __fadd_rn(xv, __fmul_rn(g1, div));
      const float xbar =
          __fdiv_rn(__fadd_rn(tt, __fmul_rn(g1, bs[idx])), one_g1);
      ms[idx] = __fsub_rn(__fmul_rn(2.f, xbar), xv);
      xs[idx] = xbar;
      if (last && r >= ir0 && r < ir1 && c >= ic0 && c < ic1)
        mx = nanmax(mx, fabsf(__fsub_rn(xbar, xv)));
      next_cell(r, c, dr, dc, ew);
    }
    __syncthreads();  // mid complete; every read of the old y done
    // dual half: reads mid of the cell, the one below and the one to the
    // right; writes the cell's own y only
    r = tr;
    c = tc;
    for (int idx = threadIdx.x; idx < cells; idx += kHaloThreads) {
      const float m = ms[idx];
      const float gx = r < eh - 1 ? __fsub_rn(ms[idx + ew], m) : 0.f;
      const float gy = c < ew - 1 ? __fsub_rn(ms[idx + 1], m) : 0.f;
      const float yxv = yxs[idx], yyv = yys[idx];
      const float vx = __fadd_rn(yxv, __fmul_rn(g2, gx));
      const float vy = __fadd_rn(yyv, __fmul_rn(g2, gy));
      const float nrm =
          __fsqrt_rn(__fadd_rn(__fmul_rn(vx, vx), __fmul_rn(vy, vy)));
      const float scale =
          nrm > lam ? __fdiv_rn(lam, fmaxf(nrm, 1e-30f)) : 1.f;
      const float ybx = __fmul_rn(vx, scale), yby = __fmul_rn(vy, scale);
      yxs[idx] = ybx;
      yys[idx] = yby;
      if (last && r >= ir0 && r < ir1 && c >= ic0 && c < ic1) {
        myx = nanmax(myx, fabsf(__fsub_rn(ybx, yxv)));
        myy = nanmax(myy, fabsf(__fsub_rn(yby, yyv)));
      }
      next_cell(r, c, dr, dc, ew);
    }
    __syncthreads();  // y complete; every read of mid done
  }

  const int tw = c1 - c0;
  for (int idx = threadIdx.x; idx < (r1 - r0) * tw; idx += kHaloThreads) {
    const int r = idx / tw, c = idx % tw;
    const size_t g = base + (size_t)(r0 + r) * W + c0 + c;
    const int s = (ir0 + r) * ew + ic0 + c;
    xo[g] = xs[s];
    yxo[g] = yxs[s];
    yyo[g] = yys[s];
  }

  // the tile's three maxima, then the image's
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  mx = warp_nanmax(mx);
  myx = warp_nanmax(myx);
  myy = warp_nanmax(myy);
  if (lane == 0) {
    red[warp] = mx;
    red[kHaloWarps + warp] = myx;
    red[2 * kHaloWarps + warp] = myy;
  }
  __syncthreads();
  if (warp == 0) {
    mx = warp_nanmax(red[lane]);
    myx = warp_nanmax(red[kHaloWarps + lane]);
    myy = warp_nanmax(red[2 * kHaloWarps + lane]);
    if (lane == 0) {
      unsigned int* s = scratch + 4 * (size_t)i;
      atomicMax(s + 0, __float_as_uint(mx));
      atomicMax(s + 1, __float_as_uint(myx));
      atomicMax(s + 2, __float_as_uint(myy));
      __threadfence();
      if (atomicAdd(s + 3, 1u) == (unsigned int)tiles - 1) {
        __threadfence();
        const float ax = __uint_as_float(atomicMax(s + 0, 0u));
        const float ayx = __uint_as_float(atomicMax(s + 1, 0u));
        const float ayy = __uint_as_float(atomicMax(s + 2, 0u));
        res[i] = __fadd_rn(ax, nanmax(ayx, ayy));
      }
    }
  }
}

// ---- the band kernel's variants ---------------------------------------------

using BandKernel = void (*)(const float*, const float*, const float*,
                            const float*, const float*, const float*,
                            const float*, const float*, float*, float*,
                            float*, float*, int, int, int);

// A variant and the last plan it was checked at on a device: the launch
// attributes set and at least one cluster held.  Checked once per device
// and plan, not once per launch.
struct BandVariant {
  BandKernel kernel;
  std::mutex lock;
  int device = -1, C = 0, smem = 0;
};

// The planes' spacing of the band kernel's variants, in floats: the least
// that holds ceil(H / C) rows of Wp floats is launched.  The largest fills a
// block's 227 KB; up to 4096 two blocks share an SM.
constexpr int kSpacings[5] = {1024, 2048, 4096, 8192, 11520};

int plane_index(int H, int W, int C) {
  const long long cap = (long long)((H + C - 1) / C) * ((W + 31) / 32 * 32);
  for (int k = 0; k < 5; ++k)
    if (cap <= kSpacings[k]) return k;
  return -1;
}

// Dynamic shared memory of the band kernel: a guard of 16 bytes, five planes
// of the variant's spacing, a guard of 16 bytes.  kernels/tv.py
// (cp_band_bytes) computes the same total.
size_t band_bytes(int H, int W, int C) {
  const int k = plane_index(H, W, C);
  return k < 0 ? 0 : 16 + (size_t)kSpacings[k] * 20 + 16;
}

#define PROXTPU_BAND_ROW(T)                                         \
  {{cp_band_kernel<T, 1024>}, {cp_band_kernel<T, 2048>},            \
   {cp_band_kernel<T, 4096>}, {cp_band_kernel<T, 8192>},            \
   {cp_band_kernel<T, 11520>}}

BandVariant* band_variant(int threads, int plane) {
  static BandVariant table[2][5] = {PROXTPU_BAND_ROW(512),
                                    PROXTPU_BAND_ROW(1024)};
  const int t = threads == 512 ? 0 : threads == 1024 ? 1 : -1;
  return t < 0 || plane < 0 ? nullptr : &table[t][plane];
}

#undef PROXTPU_BAND_ROW

// The launch of the band kernel at C blocks per image of `threads` threads
// and `smem_bytes` of dynamic shared memory, checked against its layout;
// the kernel's attributes are set for it.  With `clusters`, the clusters the
// device holds at once at this plan are counted (else a count under 1 is an
// error).
cudaError_t band_config(int B, int H, int W, int C, int threads,
                        int smem_bytes, BandVariant** out,
                        cudaLaunchConfig_t* config, cudaLaunchAttribute* attr,
                        cudaStream_t stream, int* clusters) {
  const bool sizes_ok = C >= 1 && C <= 16 && H >= C && W >= 1;
  BandVariant* v = *out =
      sizes_ok ? band_variant(threads, plane_index(H, W, C)) : nullptr;
  const bool ok = v != nullptr && (size_t)smem_bytes == band_bytes(H, W, C);
  if (!ok) return cudaErrorInvalidValue;
  if ((long long)B * C > 2147483647LL) return cudaErrorInvalidConfiguration;
  *config = cudaLaunchConfig_t{};
  config->gridDim = dim3((unsigned int)(B * C));
  config->blockDim = dim3(threads);
  config->dynamicSmemBytes = smem_bytes;
  config->stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config->attrs = attr;
  config->numAttrs = 1;

  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> guard(v->lock);
  if (!clusters && v->device == device && v->C == C && v->smem == smem_bytes)
    return cudaSuccess;
  Prepared attrs;
  err = prepare_once(attrs, v->kernel, smem_bytes);
  if (err != cudaSuccess) return err;
  if (C > 8) {
    err = cudaFuncSetAttribute(
        v->kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  int held = 0;
  err = cudaOccupancyMaxActiveClusters(&held, v->kernel, config);
  if (err != cudaSuccess) return err;
  if (clusters) {
    *clusters = held;
    return cudaSuccess;
  }
  if (held < 1) return cudaErrorLaunchOutOfResources;
  v->device = device;
  v->C = C;
  v->smem = smem_bytes;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The band kernel: C blocks per image as one cluster (C <= 8, or <= 16 where
// the device allows a non-portable cluster), `threads` of 512 or 1024 per
// block, `smem_bytes` = band_bytes(H, W, C).  done may be NULL (every
// image advanced).  Returns cudaErrorInvalidValue for a plan the kernel does
// not take and cudaErrorLaunchOutOfResources where the device cannot hold
// one such cluster; never launches another plan.
int proxtpu_cp_k_steps(const float* b, const float* x, const float* yx,
                       const float* yy, const float* g1, const float* g2,
                       const float* lam, const float* done, float* xo,
                       float* yxo, float* yyo, float* res, int B, int H,
                       int W, int K, int C, int threads, int smem_bytes,
                       void* stream) {
  BandVariant* v = nullptr;
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr[1];
  cudaError_t err = band_config(B, H, W, C, threads, smem_bytes, &v, &config,
                                attr, (cudaStream_t)stream, nullptr);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&config, v->kernel, b, x, yx, yy, g1, g2, lam,
                           done, xo, yxo, yyo, res, H, W, K);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Clusters of the band kernel at this plan that the device holds at once
// (0 where it holds none).
int proxtpu_cp_active_clusters(int H, int W, int C, int threads,
                               int smem_bytes, int* out) {
  BandVariant* v = nullptr;
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr[1];
  *out = 0;
  return (int)band_config(1, H, W, C, threads, smem_bytes, &v, &config, attr,
                          nullptr, out);
}

// The halo kernel.  scratch: (B, 4) unsigned ints, zeroed by the caller.
// done may be NULL.  (TH, TW): the tile of one block; a tile's loaded
// region, (TH + 2K) x (TW + 2K) clipped to the image, must fit the device's
// shared memory five times over.
int proxtpu_cp_k_steps_halo(const float* b, const float* x, const float* yx,
                            const float* yy, const float* g1, const float* g2,
                            const float* lam, const float* done, float* xo,
                            float* yxo, float* yyo, float* res,
                            unsigned int* scratch, int B, int H, int W, int K,
                            int TH, int TW, void* stream) {
  if (TH < 1 || TW < 1) return (int)cudaErrorInvalidValue;
  const int tiles_r = (H + TH - 1) / TH, tiles_c = (W + TW - 1) / TW;
  const int eh = min(H, TH + 2 * K), ew = min(W, TW + 2 * K);
  const int max_cells = eh * ew;
  const size_t smem = (size_t)kPlanes * max_cells * sizeof(float);
  cudaError_t err = prepare(cp_halo_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * tiles_r * tiles_c;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  cp_halo_kernel<<<(unsigned int)blocks, kHaloThreads, smem,
                   (cudaStream_t)stream>>>(
      b, x, yx, yy, g1, g2, lam, done, xo, yxo, yyo, res, scratch, H, W, K,
      TH, TW, tiles_r, tiles_c, max_cells);
  return (int)cudaGetLastError();
}

}  // extern "C"
