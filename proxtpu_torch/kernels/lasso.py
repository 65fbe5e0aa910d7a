"""Batched lasso FISTA solvers with hand-written Hopper kernels.

Counterpart of ``proxtpu/kernels/lasso.py``.  The hot op, per problem lane
i, is one forward-backward step

    z_i = soft_threshold(x_i - gamma_i A_i^T (A_i x_i - b_i), gamma_i lam_i)
    res_i = ||x_i - z_i||_inf

and, for FISTA, the extrapolation, adaptive restart and freeze of converged
lanes around it.  Each step has a plain PyTorch version (``reference_*``) and
a wrapper (``fused_*``) over a CUDA kernel in ``proxtpu_torch/csrc``.  A
wrapper runs the plain version for tensors on the CPU; for CUDA tensors it
launches its kernel or raises on operands the kernel does not take.  Each
wrapper counts its launches in its ``launches`` attribute.

``fused_fista_k_steps`` runs K full iterations per launch;
``solve_lasso_batch_blocked`` drives it, testing for convergence once per
block of K.  All three kernels stream a lane's A once per step through a
ring of row tiles in shared memory; ``fista_k_steps`` serves a lane by a
cluster of thread blocks where the batch leaves SMs idle.  The launch plans
are chosen here on the host (:func:`step_plan`, :func:`k_steps_plan`).
``fb_step`` and ``fista_step`` also take A stored in bfloat16 (the warm
stage of :func:`solve_lasso_batch_mixed`): they compute in float32 on each
entry cast up, and return the bits of the float32 kernel on ``A.float()``.

Beside them: the over-relaxed solvers (``step_mult``), the compacting
driver (:func:`solve_lasso_batch_compacting`), the shared-A solver
(:func:`solve_lasso_multirhs`, two ``torch.matmul`` a step in full float32,
no hand-written kernel, as the reference leaves it to XLA) and the
two-stage mixed-precision solver (:func:`solve_lasso_batch_mixed`).

The TPU's lane-packed layout (``pack_lasso_batch``) is not ported: it only
strips the 128-lane padding of the TPU's tiles, and a row on the card has
none.  ``solve_lasso_batch_packed`` keeps its signature and results and runs
the natural layout through the full-step kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..parallel.sharded_ops import (
    all_reduce,
    lane_parallel,
    localize_multirhs,
    place_lanes,
)
from ..utils.host_loop import run_host_loop
from ..utils.precision import require_full_f32_matmul
from ..utils.profiling import estimate, kernel_cost
from . import _build

# t after a restart: the simple t-sequence one step from t = 1
_PHI = (1 + math.sqrt(5.0)) / 2


def _round_up(v, to):
    return -(-v // to) * to


def _soft_threshold(y, thr):
    return torch.sign(y) * torch.clamp(torch.abs(y) - thr, min=0.0)


def reference_fb_prox_grad(A, b, x, gamma, thr, shrink=None):
    """Plain version of the FB step (two reads of A).

    Args: A (B, M, N), b (B, M), x (B, N); gamma, thr (B,) per-lane step and
    soft-threshold level; ``shrink`` (B,) optional elastic-net prox
    denominator ``1 + gamma*lam2`` (divided, bit-matching
    ``ElasticNet.prox``).  An A stored in bfloat16 is cast up to x's dtype
    first, as the kernel casts each entry.  Returns ``(z (B, N), res_inf
    (B,))``."""
    require_full_f32_matmul()
    if A.dtype == torch.bfloat16:
        A = A.to(x.dtype)
    r = torch.bmm(A, x.unsqueeze(2)).squeeze(2) - b
    grad = torch.bmm(r.unsqueeze(1), A).squeeze(1)
    y = x - gamma[:, None] * grad
    z = _soft_threshold(y, thr[:, None])
    if shrink is not None:
        z = z / shrink[:, None]
    return z, torch.amax(torch.abs(x - z), dim=1)


def reference_fista_full_step(A, b, x, z_prev, beta, gamma, thr, done_mask,
                              shrink=None, restart=False):
    """Plain version of one full FISTA iteration per lane.

    The FB step at ``x``; the restart signal ``rs = <x - z, z - z_prev>``;
    with ``restart``, ``beta = 0`` where ``rs > 0``; the extrapolation
    ``x_new = z + beta (z - z_prev)``; lanes with ``done_mask != 0`` keep
    ``(x, z_prev)`` and report ``res = rs = 0``.  Returns new tensors
    ``(x_new, z, res_inf, rs)``."""
    z, res = reference_fb_prox_grad(A, b, x, gamma, thr, shrink)
    rs = torch.sum((x - z) * (z - z_prev), dim=1)
    if restart:
        beta = torch.where(rs > 0, torch.zeros_like(beta), beta)
    x_new = z + beta[:, None] * (z - z_prev)
    frozen = done_mask != 0
    zero = torch.zeros_like(res)
    return (torch.where(frozen[:, None], x, x_new),
            torch.where(frozen[:, None], z_prev, z),
            torch.where(frozen, zero, res),
            torch.where(frozen, zero, rs))


def _check_operands(A, b, vectors, scalars, smem_bytes, a_dtypes=(
        torch.float32,)):
    """Raise unless the kernels take these operands: float32 (A of one of
    ``a_dtypes``), contiguous, on A's CUDA device, A (B, M, N), b (B, M),
    ``vectors`` (B, N), ``scalars`` (B,) (both as ``(name, tensor)``
    pairs), and a block's shared memory holds ``smem_bytes``."""
    if A.dim() != 3:
        raise ValueError(f"A must be (B, M, N), got shape {tuple(A.shape)}")
    B, M, N = A.shape
    named = [("A", A, (B, M, N)), ("b", b, (B, M))]
    named += [(n, t, (B, N)) for n, t in vectors]
    named += [(n, t, (B,)) for n, t in scalars]
    for name, t, shape in named:
        if not t.is_cuda or t.device != A.device:
            raise ValueError(f"{name} is on {t.device}; the kernel needs "
                             f"every operand on one CUDA device ({A.device})")
        dtypes = a_dtypes if name == "A" else (torch.float32,)
        if t.dtype not in dtypes:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes "
                            + " or ".join(map(str, dtypes)))
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    _build.check_shared_bytes(smem_bytes, A.device)


# A's types the one-step kernels take: float32, or bfloat16 storage
STEP_A_DTYPES = (torch.float32, torch.bfloat16)


def _operands_ok(A, b, vectors, scalars):
    """Whether :func:`_check_operands` would pass these tensors (A of
    ``STEP_A_DTYPES``): the same tests with no name, list or message built,
    for the wrappers that run once per iteration.  Where it says no,
    ``_check_operands`` raises."""
    if A.dim() != 3 or not A.is_cuda:
        return False
    B, M, N = A.shape
    index, f32 = A.get_device(), torch.float32
    if (A.dtype not in STEP_A_DTYPES or not A.is_contiguous()
            or b.shape != (B, M)
            or not b.is_cuda or b.get_device() != index
            or b.dtype is not f32 or not b.is_contiguous()):
        return False
    for tensors, shape in ((vectors, (B, N)), (scalars, (B,))):
        for t in tensors:
            if (t.shape != shape or not t.is_cuda
                    or t.get_device() != index or t.dtype is not f32
                    or not t.is_contiguous()):
                return False
    return True


# a stage of the ring holds full rows, about this many bytes of them: each
# tile costs a block barrier and the latency of one row's dot product, so
# few tall tiles beat many short ones, and three stages of 64 KB (one in
# use, two in flight) fill a block's 227 KB.  Below three stages a refill
# by ordinary stores could meet its own reader.
_STAGE_BYTES = 64 * 1024
_STAGES = 3

# The launch plan of the ``fb_step`` and ``fista_step`` kernels
# (csrc/lasso_step.cu): one thread block per lane.
STEP_THREADS = (256, 512, 1024)
# what a resident block costs an SM beside its own shared memory: 1 KB the
# system reserves and the kernels' static scratch, with room for rounding
_BLOCK_OVERHEAD = 1024 + 512
# two blocks share an SM only with tiles of at least this many rows: every
# tile costs a block barrier and the latency of one row's dot product (on an
# H100 two blocks with tiles of 16 rows beat one with tiles of 32 to 64 by 6
# to 15 us at 256 lanes of 200 x 400 and 400 x 200; with 8 rows they are even)
_MIN_SHARED_ROWS = 16


def step_threads(N):
    """Threads of a block of the one-step kernels that walks a ring: 512, or
    1024 where N is above 512 (a thread per column in pass 2, a warp per row
    in pass 1)."""
    return STEP_THREADS[1] if N <= STEP_THREADS[1] else STEP_THREADS[2]


def step_shared_bytes(M, N, R, S, elem=4):
    """Dynamic shared memory of one block of ``fb_step`` or ``fista_step``
    for A of ``elem`` bytes an entry (4: float32, 2: bfloat16).  With a ring
    (S > 0): x and the gradient of N (rounded up to 4) floats each, the
    residual of M (rounded up to 4), then on 128 bytes S stages of R rows
    (each rounded up to 128 bytes) and S 8-byte barriers.  With the lane
    read in place (S = 0): x and the residual, N + M floats.  The same sum
    as ``StepLayout`` in csrc/lasso_step.cuh; the entries refuse a launch
    whose total differs."""
    if S == 0:
        return (N + M) * 4
    fixed = (2 * _round_up(N, 4) + _round_up(M, 4)) * 4
    return _round_up(fixed, 128) + S * (_round_up(R * N * elem, 128) + 8)


def _ring_rows(M, N, warps, budget, elem, whole_rounds):
    """Most rows per tile of a ring of ``_STAGES`` stages of at most
    ``_STAGE_BYTES`` within ``budget`` bytes (0 where not one row of
    ``elem``-byte entries fits); with ``whole_rounds``, a multiple of the
    block's ``warps`` where one fits (pass 1 gives a warp a row, so a tile
    takes whole rounds)."""
    room = budget - step_shared_bytes(M, N, 0, _STAGES)
    stage = min(_STAGE_BYTES, room // _STAGES // 128 * 128)
    R = max(0, min(M, stage // (N * elem)))
    if whole_rounds and warps < R < M:
        R -= R % warps
    return R


def _step_plan(B, M, N, sms, limit, elem, whole_rounds=None):
    """``(threads, R, S, shared bytes)``, the launch plan of ``fb_step`` and
    ``fista_step`` for a batch of B lanes of (M, N), A of ``elem`` bytes an
    entry (4: float32, 2: bfloat16), on a device of ``sms`` SMs and
    ``limit`` bytes of shared memory per block.

    A lane that fits a quarter of an SM's shared memory takes one stage
    that holds it (``S == 1``, ``R == M``, no refill) and 256 threads, so
    that four or more such blocks share an SM.  Else the block walks a ring
    of three stages of R full rows, at most 64 KB each, with
    :func:`step_threads`' threads: a batch of more lanes than SMs plans for
    two blocks per SM (half an SM's shared memory each), so that all lanes
    of up to ``2 sms`` run in one wave and each block's barrier and copy
    waits are hidden by the other's work, if that leaves tiles of
    ``_MIN_SHARED_ROWS`` rows or more; a smaller batch gives a block the
    whole SM.  Where not even three one-row stages fit a whole SM, 256
    threads read the lane in place (``S == 0``), which takes rows as wide as
    ``(N + M) * 4 <= limit`` allows.  Rows of bfloat16 are half as wide, so
    a shape may take another branch at ``elem = 2``.

    Tiles of float32 rows take whole rounds of the block's warps
    (``whole_rounds``, by default at ``elem = 4``).  Tiles of bf16 rows
    take the most rows that fit, spread evenly and rounded up to a multiple
    of 4 where that still fits (pass 2 then reads a tile's residual four at
    a time): the bf16 instances' passes cost less a row, so the count of
    tiles, each a block barrier and a row's latency, weighs more (on an
    H100 at 256 lanes of 200 x 400, five tiles of 40 rows beat seven of 29
    or 32)."""
    if whole_rounds is None:
        whole_rounds = elem == 4
    per_sm = limit + 1024
    one = step_shared_bytes(M, N, M, 1, elem)
    if one <= per_sm // 4 - _BLOCK_OVERHEAD:
        return STEP_THREADS[0], M, 1, one
    threads = step_threads(N)
    budgets = [per_sm // k - _BLOCK_OVERHEAD
               for k in ((2, 1) if B > sms else (1,))]
    for budget in budgets:
        most = _ring_rows(M, N, threads // 32, budget, elem, whole_rounds)
        if most >= min(M, _MIN_SHARED_ROWS) or (
                most and budget == budgets[-1]):
            R = -(-M // -(-M // most))  # the M rows spread evenly
            if not whole_rounds:
                R = min(_round_up(R, 4), most)
            return (threads, R, _STAGES,
                    step_shared_bytes(M, N, R, _STAGES, elem))
    return STEP_THREADS[0], M, 0, step_shared_bytes(M, N, M, 0)


# the widest row whose x a lane of the bf16 instances keeps in registers in
# pass 1 (csrc/common.cuh: kXRegs chunks of 32 columns)
BF16_XREG_COLUMNS = 32 * 16


def bf16_fields(N, threads, S):
    """``(cols, xregs)`` of a bf16 plan: two columns a thread in pass 2 where
    N is even (every row of a stage then starts on 4 bytes), x in registers
    where N is at most ``BF16_XREG_COLUMNS`` and the block has at most 512
    threads; neither for a lane read in place (``S == 0``)."""
    if S == 0:
        return 1, 0
    return (2 if N % 2 == 0 else 1,
            int(N <= BF16_XREG_COLUMNS and threads <= STEP_THREADS[1]))


def step_plan(B, M, N, sms, limit, elem=4):
    """``(threads, R, S, shared bytes)``, the launch plan of ``fb_step`` and
    ``fista_step`` (see :func:`_step_plan`); at ``elem = 2`` (A in bfloat16)
    followed by :func:`bf16_fields`' ``(cols, xregs)``."""
    plan = _step_plan(B, M, N, sms, limit, elem)
    return plan if elem == 4 else plan + bf16_fields(N, plan[0], plan[2])


# the plan of a shape, computed once: the wrappers run once per iteration
cached_step_plan = functools.lru_cache(maxsize=None)(step_plan)

# the C entries, looked up once
_entries = {}


def _launch_step(name, A, args, flags):
    """Launch the one-step kernel ``name`` at A's cached plan on the current
    stream of A's device, its float32 or its bfloat16 instance by A's type;
    ``args`` are the tensors (None for an absent one) and ``flags`` the
    integers between the shape and the plan."""
    elem = A.element_size()
    if elem == 2:
        name += "_bf16"
    entry = _entries.get(name)
    if entry is None:
        entry = _entries[name] = getattr(_build.library(), "proxtpu_" + name)
    index = A.get_device()
    B, M, N = A.shape
    limit = _build.max_shared_bytes(index)
    plan = cached_step_plan(B, M, N, _build.sm_count(index), limit, elem)
    if plan[3] > limit:
        _build.check_shared_bytes(plan[3], A.device)
    ptrs = [None if t is None else t.data_ptr() for t in args]
    if index == torch.cuda.current_device():
        # the stream's handle as an int, without a Stream object around it
        err = entry(*ptrs, B, M, N, *flags, *plan,
                    torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = entry(*ptrs, B, M, N, *flags, *plan,
                        torch._C._cuda_getCurrentRawStream(index))
    if err:
        _build.check(err, name)


# The JAX package's pl.CostEstimate of each kernel (lasso.py:146, :262,
# :860), what the wrappers report to utils.profiling.compiled_stats; the
# packed kernel that fista_step serves takes the natural layout's formula.
def _fb_step_cost(A, b, x, *args, **kwargs):
    B, M, N = A.shape
    return estimate(4 * B * M * N, B * M * N * A.element_size()
                    + 3 * B * N * x.element_size())


def _fista_step_cost(A, b, x, *args, **kwargs):
    B, M, N = A.shape
    return estimate(4 * B * M * N, B * M * N * A.element_size()
                    + 5 * B * N * x.element_size())


def _fista_k_steps_cost(A, b, x, z_prev, t, gamma, thr, done_mask, K=8,
                        restart=False):
    B, M, N = A.shape
    return estimate(4 * K * B * M * N, B * M * N * x.element_size(), K * B)


@kernel_cost("fb_step", _fb_step_cost)
def fused_fb_prox_grad(A, b, x, gamma, thr, shrink=None):
    """One FB step for the batch (see :func:`reference_fb_prox_grad`),
    through the ``fb_step`` kernel for CUDA tensors, at the launch plan of
    :func:`step_plan`.  A may be float32 or bfloat16 (the kernel's bf16
    instance, counted in ``launches_bf16``; the float32 one in
    ``launches``).  Returns ``(z (B, N), res_inf (B,))``."""
    if A.device.type == "cpu":
        return reference_fb_prox_grad(A, b, x, gamma, thr, shrink)
    scalars = (gamma, thr) if shrink is None else (gamma, thr, shrink)
    if not _operands_ok(A, b, (x,), scalars):
        _check_operands(A, b, [("x", x)],
                        zip(("gamma", "thr", "shrink"), scalars), 0,
                        STEP_A_DTYPES)
    z = torch.empty_like(x)
    res = x.new_empty(A.shape[0])
    _launch_step("fb_step", A, (A, b, x, gamma, thr, shrink, z, res), ())
    if A.dtype is torch.bfloat16:
        fused_fb_prox_grad.launches_bf16 += 1
    else:
        fused_fb_prox_grad.launches += 1
    return z, res


fused_fb_prox_grad.launches = 0
fused_fb_prox_grad.launches_bf16 = 0


@kernel_cost("fista_step", _fista_step_cost)
def fused_fista_full_step(A, b, x, z_prev, beta, gamma, thr, done_mask,
                          shrink=None, restart=False):
    """One full FISTA iteration for the batch (see
    :func:`reference_fista_full_step`), through the ``fista_step`` kernel
    for CUDA tensors, at the launch plan of :func:`step_plan`.  A may be
    float32 or bfloat16, as for :func:`fused_fb_prox_grad` (launches of the
    bf16 instance are counted in ``launches_bf16``).

    ``x`` and ``z_prev`` are updated IN PLACE to ``(x_new, z)`` and returned
    (the JAX kernel aliases them to its outputs); they must be separate
    buffers.  ``done_mask`` (B,) is float, nonzero for frozen lanes.
    Returns ``(x, z_prev, res_inf, rs)``."""
    if x.data_ptr() == z_prev.data_ptr():
        raise ValueError("x and z_prev must be separate buffers: both are "
                         "updated in place")
    if A.device.type == "cpu":
        x_new, z, res, rs = reference_fista_full_step(
            A, b, x, z_prev, beta, gamma, thr, done_mask, shrink, restart)
        x.copy_(x_new)
        z_prev.copy_(z)
        return x, z_prev, res, rs
    scalars = (beta, gamma, thr, done_mask)
    if shrink is not None:
        scalars += (shrink,)
    if not _operands_ok(A, b, (x, z_prev), scalars):
        _check_operands(
            A, b, [("x", x), ("z_prev", z_prev)],
            zip(("beta", "gamma", "thr", "done_mask", "shrink"), scalars), 0,
            STEP_A_DTYPES)
    res = x.new_empty(A.shape[0])
    rs = torch.empty_like(res)
    _launch_step("fista_step", A, (A, b, x, z_prev, beta, gamma, thr,
                                   done_mask, shrink, res, rs),
                 (int(restart),))
    if A.dtype is torch.bfloat16:
        fused_fista_full_step.launches_bf16 += 1
    else:
        fused_fista_full_step.launches += 1
    return x, z_prev, res, rs


fused_fista_full_step.launches = 0
fused_fista_full_step.launches_bf16 = 0


def reference_fista_k_steps(A, b, x, z_prev, t, gamma, thr, done_mask, K=8,
                            restart=False):
    """Plain version of K FISTA iterations per lane.

    Each step: the FB step at ``x``; with ``restart``, ``t = 1`` where
    ``<x - z, z - z_prev> > 0`` (reset BEFORE the coefficient is drawn);
    ``t' = (1 + sqrt(1 + 4 t^2)) / 2``, ``beta = (t - 1) / t'``; ``x = z +
    beta (z - z_prev)``, ``z_prev = z``, ``t = t'``.  Lanes with
    ``done_mask != 0`` keep ``(x, z_prev, t)`` and report ``res = 0``.
    Returns new tensors ``(x, z_prev, t, res_inf)``, ``res_inf`` being
    ``||x - z||_inf`` of the last step."""
    x_in, zp_in, t_in = x, z_prev, t
    res = torch.zeros_like(t)
    for _ in range(K):
        z, res = reference_fb_prox_grad(A, b, x, gamma, thr)
        if restart:
            rs = torch.sum((x - z) * (z - z_prev), dim=1)
            t = torch.where(rs > 0, torch.ones_like(t), t)
        t_new = (1 + torch.sqrt(1 + 4 * t * t)) / 2
        beta = (t - 1) / t_new
        x, z_prev, t = z + beta[:, None] * (z - z_prev), z, t_new
    frozen = done_mask != 0
    return (torch.where(frozen[:, None], x_in, x),
            torch.where(frozen[:, None], zp_in, z_prev),
            torch.where(frozen, t_in, t),
            torch.where(frozen, torch.zeros_like(res), res))


# The launch plan of the ``fista_k_steps`` kernel (csrc/lasso_step.cu).
CLUSTER_SIZES = (8, 4, 2, 1)
# least rows of a lane one thread block of a cluster takes: below it the
# N-wide epilogue every block repeats and the cluster barrier outweigh the
# rows it saves, and small problems keep one block per lane, which sums in
# the order of a plain loop over the rows
MIN_SLAB_ROWS = 64
# rows of a tile where no ring fits and the tiles are read in place
_DIRECT_ROWS = 8


def cluster_plan(B, M, sms, min_rows=MIN_SLAB_ROWS):
    """Thread blocks per lane, C: the largest of 8, 4, 2, 1 such that the
    B * C blocks fit the ``sms`` SMs in one wave and every block gets at
    least ``min_rows`` of the lane's M rows."""
    for C in CLUSTER_SIZES:
        if C == 1 or (B * C <= sms and M // C >= min_rows):
            return C


def slab_bounds(M, C):
    """The rows ``[lo, hi)`` of each of the C blocks of a lane: block c takes
    ``[c M // C, (c + 1) M // C)``, so the slabs differ by at most a row."""
    return [(c * M // C, (c + 1) * M // C) for c in range(C)]


def k_steps_shared_bytes(M, N, C, R, S):
    """Dynamic shared memory of one block of ``fista_k_steps``.  With a ring
    (S > 0): x, z_prev and two partial gradients of N (rounded up to 4)
    floats, the residual of the longest slab, then on 128 bytes S stages of
    R rows (each rounded up to 128 bytes) and S 8-byte barriers.  With the
    tiles read in place (S = 0): x, one gradient and the residual (z_prev
    stays in device memory).  The same sum as ``KStepsLayout`` in
    csrc/lasso_step.cu, which refuses a launch whose total differs."""
    fixed = ((4 if S else 2) * _round_up(N, 4)
             + _round_up(-(-M // C), 4)) * 4
    if S == 0:
        return fixed
    return _round_up(fixed, 128) + S * (_round_up(R * N * 4, 128) + 8)


def ring_plan(M, N, C, limit, shared_bytes=k_steps_shared_bytes):
    """``(R, S)``: rows per tile and stages of the ring of a block that owns
    ``ceil(M / C)`` rows of N floats, within ``limit`` bytes of shared
    memory by the kernel's layout ``shared_bytes(M, N, C, R, S)``
    (``fista_k_steps``' by default).  Three stages of about
    ``_STAGE_BYTES``, or of fewer rows where those do not fit; ``S == 0``
    where not even three one-row stages fit."""
    R = max(1, min(-(-M // C), _STAGE_BYTES // (N * 4)))
    while shared_bytes(M, N, C, R, _STAGES) > limit:
        if R == 1:
            return _DIRECT_ROWS, 0
        R //= 2
    return R, _STAGES


def k_steps_plan(B, M, N, sms, limit):
    """``(C, R, S)``, the launch plan of ``fista_k_steps`` for a batch of B
    lanes of (M, N) on a device of ``sms`` SMs and ``limit`` bytes of shared
    memory per block: :func:`cluster_plan`'s blocks per lane and
    :func:`ring_plan`'s ring; where no ring fits (``S == 0``), one block per
    lane reads tiles of ``_DIRECT_ROWS`` rows in place from device memory,
    which takes rows as wide as ``(2 N + M) * 4 <= limit`` allows."""
    C = cluster_plan(B, M, sms)
    R, S = ring_plan(M, N, C, limit)
    return (C, R, S) if S else (1, R, S)


@kernel_cost("fista_k_steps", _fista_k_steps_cost)
def fused_fista_k_steps(A, b, x, z_prev, t, gamma, thr, done_mask, K=8,
                        restart=False):
    """K FISTA iterations for the batch in one launch of the
    ``fista_k_steps`` kernel (see :func:`reference_fista_k_steps`).

    The kernel runs :func:`k_steps_plan`'s thread blocks per lane as one
    cluster and reads A once per inner step; a plan the device refuses
    raises, no other is tried.

    ``x``, ``z_prev`` and ``t`` are updated IN PLACE and returned (the JAX
    kernel aliases them to its outputs); x and z_prev must be separate
    buffers.  ``done_mask`` (B,) is float, nonzero for frozen lanes.
    Returns ``(x, z_prev, t, res_inf)``."""
    if x.data_ptr() == z_prev.data_ptr():
        raise ValueError("x and z_prev must be separate buffers: both are "
                         "updated in place")
    if K < 1:
        raise ValueError(f"K must be >= 1, got {K}")
    if A.device.type == "cpu":
        xn, zn, tn, res = reference_fista_k_steps(
            A, b, x, z_prev, t, gamma, thr, done_mask, K, restart)
        x.copy_(xn)
        z_prev.copy_(zn)
        t.copy_(tn)
        return x, z_prev, t, res
    # the plan decides the shared memory, so that is checked after it
    _check_operands(A, b, [("x", x), ("z_prev", z_prev)],
                    [("t", t), ("gamma", gamma), ("thr", thr),
                     ("done_mask", done_mask)], smem_bytes=0)
    B, M, N = A.shape
    C, R, S = k_steps_plan(B, M, N, _build.sm_count(A.device.index),
                           _build.max_shared_bytes(A.device.index))
    smem = k_steps_shared_bytes(M, N, C, R, S)
    _build.check_shared_bytes(smem, A.device)
    res = torch.empty(B, dtype=x.dtype, device=x.device)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.library().proxtpu_fista_k_steps(
            A.data_ptr(), b.data_ptr(), x.data_ptr(), z_prev.data_ptr(),
            t.data_ptr(), gamma.data_ptr(), thr.data_ptr(),
            done_mask.data_ptr(), res.data_ptr(), B, M, N, int(K),
            int(restart), C, R, S, smem, ctypes.c_void_p(stream))
    _build.check(err, "fista_k_steps")
    fused_fista_k_steps.launches += 1
    return x, z_prev, t, res


fused_fista_k_steps.launches = 0


def _per_lane(v, B, like):
    """Scalar or (B,) value -> contiguous (B,) tensor like ``like``."""
    t = torch.as_tensor(v, dtype=like.dtype, device=like.device)
    return t.expand(B).contiguous()


def _validate_step_mult(step_mult, restart, mf):
    if step_mult == 1.0:
        return
    if not (0.0 < step_mult < 2.0):
        raise ValueError(
            f"step_mult={step_mult} outside (0, 2): forward-backward on the "
            f"L-smooth quadratic diverges at gamma >= 2/L")
    if step_mult > 1.0 and not restart:
        raise ValueError(
            "step_mult > 1 requires restart=True: Nesterov momentum at "
            "gamma > 1/L is unstable without the gradient-scheme restart "
            "(measured: divergence on the flagship workload)")
    if mf is not None:
        raise ValueError("step_mult is not supported with mf (the "
                         "strongly-convex constant-beta variant)")


def _real_operands(*tensors):
    """The lasso solvers take real operands: a complex one raises
    ``ValueError`` naming its dtype (``match_kernel_solver`` sends complex
    problems to the generic driver)."""
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.is_complex():
            raise ValueError(
                f"the batched lasso solvers take real operands, got {t.dtype}"
                "; solve a complex lasso through BatchedAlgorithm, whose "
                "generic driver takes it")


def _check_options(mf, restart, lam2, step_mult):
    """The reference's ``ValueError`` for options that do not compose."""
    _validate_step_mult(step_mult, restart, mf)
    if lam2 is not None and (mf is not None or step_mult != 1.0):
        raise ValueError(
            "lam2 (elastic net) composes with restart only; the mf and "
            "step_mult analyses were validated for the pure-l1 prox")
    if mf is not None and restart:
        raise ValueError(
            "restart needs the t-recursion; mf>0 uses a constant "
            "extrapolation coefficient (restart would be a no-op)")


def _x0_or_zeros(x0, B, N, like):
    """``x0`` as a (B, N) tensor of ``like``'s dtype and device, or zeros."""
    if x0 is None:
        return torch.zeros((B, N), dtype=like.dtype, device=like.device)
    return torch.as_tensor(x0, dtype=like.dtype,
                           device=like.device).reshape(B, N)


def _mf_beta_pair(gamma, mf, dtype):
    """Per-lane ``(beta1, beta_const)`` of the strongly-convex (mf > 0)
    FISTA variant, drawn with the same sequence operations as the generic
    driver's ``AdaptiveNesterovSequence(m=mf)`` under the fixed stepsize
    ``gamma`` (B,): f32 rounds the first coefficient differently from the
    later ones, hence the pair.  The operations are elementwise, so one
    batched call gives every lane's pair."""
    from ..accel.nesterov import AdaptiveNesterovSequence

    seq = AdaptiveNesterovSequence(m=float(mf))
    gamma = gamma.to(dtype)
    st = tuple(torch.full_like(gamma, -1.0) for _ in range(2))
    beta1, st = seq.next_coeff(st, gamma)
    beta2, _ = seq.next_coeff(st, gamma)
    return beta1, beta2


@lane_parallel
def solve_lasso_batch(A, b, lam, Lf, tol, maxit=1000, use_kernel=True,
                      restart=False, x0=None, mf=None, step_mult=1.0,
                      stall_patience=100, lam2=None):
    """Batched FISTA lasso / elastic-net solver.

    Same contract as ``proxtpu.kernels.lasso.solve_lasso_batch``: per-lane
    stopping rule ``||x - z||_inf / gamma <= tol`` with ``gamma = 1/Lf``;
    converged lanes freeze; ``restart=True`` adds the O'Donoghue-Candès
    gradient-scheme adaptive restart; ``lam2`` (scalar or (B,)) adds the
    ridge term ``lam2/2 ||x||^2`` through the prox; ``x0`` warm-starts.
    ``use_kernel=False`` runs the plain PyTorch route.  ``lam`` and ``Lf``
    are scalars or (B,).  ``mf`` (a float > 0, the strong-convexity
    modulus) replaces the t-recursion by the constant coefficient of the
    generic driver's ``AdaptiveNesterovSequence(m=mf)``: its first
    coefficient beta1 applies to the first extrapolation, a constant one
    after that; it excludes ``restart`` and ``lam2``.

    ``step_mult`` in (0, 2) over-relaxes the step to ``step_mult / Lf``
    (above 1 only with ``restart``; not with ``mf`` or ``lam2``).  The
    stopping rule is then the canonical ``||x - z||_inf * Lf <= tol``,
    which certifies the ``step_mult == 1`` criterion by the monotonicity of
    the gradient mapping in the step.  A lane whose criterion runs away
    (above 10x its best) or does not improve by 0.1% for ``stall_patience``
    iterations cold-restarts from ``x0`` at ``1 / Lf`` with fresh momentum.
    ``step_mult == 1`` takes the textbook path unchanged.

    Returns ``(xs (B, N), iters (B,) int32, done (B,) bool)``."""
    _real_operands(A, b, x0)
    _check_options(mf, restart, lam2, step_mult)
    B, M, N = A.shape
    dtype = A.dtype
    lam = _per_lane(lam, B, A)
    x0 = _x0_or_zeros(x0, B, N, A)
    if step_mult != 1.0:
        return _solve_overrelaxed(A, b, lam, Lf, step_mult, tol, x0,
                                  maxit=maxit, use_kernel=use_kernel,
                                  stall_patience=stall_patience,
                                  full_step_init=False)
    gamma = 1.0 / _per_lane(Lf, B, A)
    thr = gamma * lam
    shrink = None if lam2 is None else 1.0 + gamma * _per_lane(lam2, B, A)
    step = fused_fb_prox_grad if use_kernel else reference_fb_prox_grad
    z0, res0 = step(A, b, x0, gamma, thr, shrink)
    # the init FB step counts as iteration 1; its extrapolation coefficient
    # is 0 (t = 1), so the next point is z0 itself, with t advanced once
    t0 = torch.ones((B,), dtype=dtype, device=A.device)
    t1 = (1 + torch.sqrt(1 + 4 * t0 * t0)) / 2
    done0 = res0 / gamma <= tol
    iters0 = torch.ones((B,), dtype=torch.int32, device=A.device)
    beta_const = None
    if mf is not None:
        beta1, beta_const = _mf_beta_pair(gamma, mf, dtype)
        # the mf > 0 sequence has no zero first coefficient: the generic
        # driver extrapolates step 1 as z0 + beta1 (z0 - x0)
        x_init = z0 + beta1[:, None] * (z0 - x0)
    else:
        # x and z_prev start equal but are separate buffers: the kernel
        # updates both in place
        x_init = z0.clone()
    body = _make_fista_body(A, b, gamma, thr, tol, use_kernel=use_kernel,
                            restart=restart, shrink=shrink,
                            beta_const=beta_const)
    return _run_loop(body, (x_init, z0, t1, done0, iters0), maxit)


def _make_fista_body(A, b, gamma, thr, tol, *, use_kernel, restart,
                     shrink=None, beta_const=None):
    """One iteration ``body(k, (x, z_prev, t, done, iters))`` -> the next
    state, where ``k`` is the new iteration number.  ``beta_const`` (B,)
    replaces the t-recursion by a constant per-lane coefficient (the
    mf > 0 variant).  A may be stored in bfloat16; the state is in
    gamma's dtype."""
    dtype = gamma.dtype

    if use_kernel:
        def body(k, state):
            x, z_prev, t, done, iters = state
            if beta_const is not None:
                beta, t_new = beta_const, t
            else:
                t_new = (1 + torch.sqrt(1 + 4 * t * t)) / 2
                beta = (t - 1) / t_new
            x, z, res, rs = fused_fista_full_step(
                A, b, x, z_prev, beta, gamma, thr, done.to(dtype), shrink,
                restart=restart)
            if restart:
                # the kernel zeroed the triggering lane's beta for THIS
                # extrapolation (t reset to 1 before the coefficient), so
                # its t advances from 1 to phi
                t_new = torch.where(rs > 0, _PHI, t_new)
            newly_done = res / gamma <= tol
            iters = torch.where(done, iters, k)
            return (x, z, torch.where(done, t, t_new), done | newly_done,
                    iters)
    else:
        def body(k, state):
            x, z_prev, t, done, iters = state
            z, res = reference_fb_prox_grad(A, b, x, gamma, thr, shrink)
            if restart:
                # immediate restart: reset t BEFORE drawing the coefficient
                rs = torch.sum((x - z) * (z - z_prev), dim=1)
                t = torch.where(rs > 0, torch.ones_like(t), t)
            if beta_const is not None:
                beta, t_new = beta_const[:, None], t
            else:
                t_new = (1 + torch.sqrt(1 + 4 * t * t)) / 2
                beta = ((t - 1) / t_new)[:, None]
            x_new = z + beta * (z - z_prev)
            newly_done = res / gamma <= tol
            keep = done[:, None]
            x_new = torch.where(keep, x, x_new)
            z = torch.where(keep, z_prev, z)
            iters = torch.where(done, iters, k)
            return (x_new, z, torch.where(done, t, t_new),
                    done | newly_done, iters)

    return body


def _run_loop(body, state, maxit):
    """Run ``body`` from iteration 1 until every lane is done or ``maxit``
    (see :func:`run_host_loop`).  Returns ``(z, iters, done)``."""
    state, k = run_host_loop(body, state, lambda s: s[3], maxit)
    _, z, _, done, iters = state[:5]
    return z, torch.where(done, iters, k), done


def _solve_overrelaxed(A, b, lam, Lf, step_mult, tol, x0, *, maxit,
                       use_kernel, stall_patience, full_step_init):
    """Over-relaxed restart-FISTA with the per-lane stall safeguard (see
    :func:`solve_lasso_batch`, ``step_mult``): the reference's
    ``_solve_lasso_batch_overrelaxed`` and, with ``full_step_init``,
    ``_solve_packed_overrelaxed``, whose init is the full step at beta = 0
    from ``z_prev = x0`` instead of the FB step.  A lane's step ``gam``
    lives in the loop's state, so that a stalling lane falls back to
    ``1 / Lf`` mid-solve; the kernels take the per-lane step and threshold
    as operands of every call.  ``lam`` is (B,); ``x0`` is not modified."""
    B = A.shape[0]
    dtype = A.dtype
    Lf = _per_lane(Lf, B, A)
    gamma0 = 1.0 / Lf                # canonical 1/L (the criterion)
    gamma_init = step_mult / Lf      # the step
    step = fused_fista_full_step if use_kernel else reference_fista_full_step

    def full_step(x, zp, beta, gam, dm):
        return step(A, b, x, zp, beta, gam, gam * lam, dm, restart=True)

    if full_step_init:
        zeros = torch.zeros((B,), dtype=dtype, device=A.device)
        x, z_prev, res0, _ = full_step(x0.clone(), x0.clone(), zeros,
                                       gamma_init, zeros)
    else:
        fb = fused_fb_prox_grad if use_kernel else reference_fb_prox_grad
        z0, res0 = fb(A, b, x0, gamma_init, gamma_init * lam)
        x, z_prev = z0.clone(), z0
    crit0 = res0 / gamma0
    t0 = torch.ones((B,), dtype=dtype, device=A.device)
    state = (x, z_prev, (1 + torch.sqrt(1 + 4 * t0 * t0)) / 2,
             crit0 <= tol, torch.ones((B,), dtype=torch.int32,
                                      device=A.device),
             gamma_init,                    # per-lane step (may back off)
             crit0,                         # best criterion seen
             torch.zeros((B,), dtype=torch.int32, device=A.device))

    def body(k, state):
        x, z_prev, t, done, iters, gam, best, since = state
        t_new = (1 + torch.sqrt(1 + 4 * t * t)) / 2
        beta = (t - 1) / t_new
        x_new, z, res, rs = full_step(x, z_prev, beta, gam, done.to(dtype))
        # immediate restart: rs > 0 lanes had beta zeroed in the step
        t_new = torch.where(rs > 0, _PHI, t_new)
        crit = res / gamma0              # canonical ||G_{1/L}|| certificate
        # The safeguard.  An over-relaxed lane fails by diverging, so two
        # triggers: a runaway (crit 10x past its best) and stall_patience
        # iterations without a 0.1% improvement.  A triggered lane
        # cold-restarts the textbook solve (step 1/L, fresh momentum, back
        # to x0); `gam > gamma0` makes the trigger one-shot.  Every update
        # keeps done lanes frozen: the host tests all-done only now and
        # then.
        improved = crit < best * 0.999
        runaway = crit > best * 10.0
        best = torch.where(~done & improved, crit, best)
        since = torch.where(done | improved, 0, since + 1)
        stall = ~done & ((since >= stall_patience) | runaway) & (gam > gamma0)
        gam = torch.where(stall, gamma0, gam)
        t_new = torch.where(stall, 1.0, t_new)
        since = torch.where(stall, 0, since)
        x_new = torch.where(stall[:, None], x0, x_new)
        z = torch.where(stall[:, None], x0, z)
        iters = torch.where(done, iters, k)
        return (x_new, z, torch.where(done, t, t_new), done | (crit <= tol),
                iters, gam, best, since)

    return _run_loop(body, state, maxit)


@lane_parallel
def solve_lasso_batch_packed(A, b, lam, Lf, tol, maxit=1000, restart=False,
                             x0=None, pack=None, mf=None, step_mult=1.0,
                             stall_patience=100, lam2=None, use_kernel=True):
    """Batched FISTA, the bulk solver of the main path.

    Same signature and results as
    ``proxtpu.kernels.lasso.solve_lasso_batch_packed``.  ``pack`` is checked
    (it must divide B) but selects no layout: the packing exists only to
    strip the TPU's lane padding, so the natural layout runs through the
    full-step kernel.  ``use_kernel=False`` runs the plain route (it takes
    the place of the JAX ``interpret`` flag).  ``mf``, ``step_mult`` and
    ``stall_patience`` as in :func:`solve_lasso_batch`; the over-relaxed
    solve starts, as every solve here, with the full step at beta = 0."""
    _real_operands(A, b, x0)
    _check_options(mf, restart, lam2, step_mult)
    B, M, N = A.shape
    if pack is not None and not (pack >= 1 and B % pack == 0):
        raise ValueError(f"pack must be a positive divisor of B={B}, "
                         f"got {pack}")
    if lam2 is not None:
        return solve_lasso_batch(A, b, lam, Lf, tol, maxit=maxit,
                                 use_kernel=use_kernel, restart=restart,
                                 x0=x0, lam2=lam2)
    x0 = _x0_or_zeros(x0, B, N, A)
    if step_mult != 1.0:
        return _solve_overrelaxed(A, b, _per_lane(lam, B, A), Lf, step_mult,
                                  tol, x0, maxit=maxit, use_kernel=use_kernel,
                                  stall_patience=stall_patience,
                                  full_step_init=True)
    return _solve_packed_core(A, b, lam, Lf, tol, x0, maxit=maxit,
                              restart=restart, use_kernel=use_kernel, mf=mf)


def _solve_packed_core(A, b, lam, Lf, tol, x0, *, maxit, restart,
                       use_kernel, mf=None):
    """FISTA from ``x0`` whose init is the full step with beta = 0,
    z_prev = x0 and no lane frozen (the restart signal there is
    ``-||x - z||^2 <= 0``, so no spurious reset).  Returns
    ``(xs, iters, done)``; ``x0`` is not modified."""
    B = A.shape[0]
    dtype = A.dtype
    gamma = 1.0 / _per_lane(Lf, B, A)
    thr = gamma * _per_lane(lam, B, A)
    zeros = torch.zeros((B,), dtype=dtype, device=A.device)
    if use_kernel:
        x, z_prev, res0, _ = fused_fista_full_step(
            A, b, x0.clone(), x0.clone(), zeros, gamma, thr, zeros,
            restart=restart)
    else:
        x, z_prev, res0, _ = reference_fista_full_step(
            A, b, x0, x0, zeros, gamma, thr, zeros, restart=restart)
    t1 = torch.full((B,), _PHI, dtype=dtype, device=A.device)
    iters0 = torch.ones((B,), dtype=torch.int32, device=A.device)
    beta_const = None
    if mf is not None:
        beta1, beta_const = _mf_beta_pair(gamma, mf, dtype)
        # the first extrapolation takes beta1 (see solve_lasso_batch)
        x = z_prev + beta1[:, None] * (z_prev - x0)
    body = _make_fista_body(A, b, gamma, thr, tol, use_kernel=use_kernel,
                            restart=restart, beta_const=beta_const)
    return _run_loop(body, (x, z_prev, t1, res0 / gamma <= tol, iters0),
                     maxit)


@lane_parallel
def solve_lasso_batch_packed_tail(A, b, lam, Lf, tol, maxit=2000, k1=192,
                                  tail=64, restart=True, use_kernel=True):
    """Two-phase batched FISTA, the main path's entry point.

    Same contract as
    ``proxtpu.kernels.lasso.solve_lasso_batch_packed_tail``:

    1. :func:`solve_lasso_batch_packed` runs ``k1`` iterations over every
       lane;
    2. if at most ``tail`` lanes are unconverged, the ``tail`` slowest lanes
       (unconverged first, by a stable argsort of the done mask) continue,
       warm-started, at width ``tail`` through :func:`solve_lasso_batch`;
       otherwise all lanes continue warm-started at full width;
    3. the results are scattered back.  Fill lanes that were already done
       keep their certified phase-1 solution.

    The branch is chosen on the host from one count.  Reported counts are
    ``k1 + phase 2`` for continued lanes.  ``use_kernel=False`` runs the
    plain route.  Returns ``(xs (B, N), iters (B,), done (B,))``."""
    _real_operands(A, b)
    B, M, N = A.shape
    if not 0 < tail <= B:
        raise ValueError(f"tail must be in (0, {B}], got {tail}")
    k1 = min(k1, maxit)  # a small maxit caps phase 1, not the reverse
    lam = _per_lane(lam, B, A)
    Lf = _per_lane(Lf, B, A)
    xs1, it1, dn1 = solve_lasso_batch_packed(
        A, b, lam, Lf, tol, maxit=k1, restart=restart, use_kernel=use_kernel)
    if k1 >= maxit:
        return xs1, it1, dn1
    if B - int(dn1.sum().item()) > tail:
        xs2, it2, dn2 = solve_lasso_batch_packed(
            A, b, lam, Lf, tol, maxit=maxit - k1, restart=restart, x0=xs1,
            use_kernel=use_kernel)
        return (torch.where(dn1[:, None], xs1, xs2),
                torch.where(dn1, it1, it1 + it2), dn1 | dn2)
    # unconverged lanes first; ties keep their order, as in JAX
    idx = torch.argsort(dn1.to(torch.int32), stable=True)[:tail]
    was_done = dn1[idx]
    xs2, it2, dn2 = solve_lasso_batch(
        A[idx], b[idx], lam[idx], Lf[idx], tol, maxit=maxit - k1,
        restart=restart, x0=xs1[idx], use_kernel=use_kernel)
    # keep the CERTIFIED phase-1 solution of fill lanes that were already
    # done: phase 2's first step may re-check an at-threshold residual just
    # above tol, and must not replace a certified iterate
    xs2 = torch.where(was_done[:, None], xs1[idx], xs2)
    xs = xs1.index_copy(0, idx, xs2)
    iters = it1.index_add(0, idx, torch.where(was_done, 0, it2))
    done = dn1.index_copy(0, idx, was_done | dn2)
    return xs, iters, done


@lane_parallel
def solve_lasso_batch_blocked(A, b, lam, Lf, tol, maxit=2000, iter_block=8,
                              restart=False, x0=None, use_kernel=True):
    """Batched FISTA with K-step iteration blocking, K = ``iter_block``.

    Same contract as ``proxtpu.kernels.lasso.solve_lasso_batch_blocked``:
    one FB step, then :func:`fused_fista_k_steps` runs K iterations per
    launch, restart (if on) inside the inner loop.  The trajectory is
    :func:`solve_lasso_batch`'s; the stopping criterion is only sampled
    every K iterations, so counts are upper bounds (a lane whose residual
    dips below tol between samples runs on) and are clamped to ``maxit``.
    ``use_kernel=False`` runs the plain route.  Returns
    ``(xs (B, N), iters (B,) int32, done (B,) bool)``."""
    _real_operands(A, b, x0)
    B, M, N = A.shape
    dtype = A.dtype
    gamma = 1.0 / _per_lane(Lf, B, A)
    thr = gamma * _per_lane(lam, B, A)
    K = int(iter_block)
    x0 = _x0_or_zeros(x0, B, N, A)
    fb = fused_fb_prox_grad if use_kernel else reference_fb_prox_grad
    z0, res0 = fb(A, b, x0, gamma, thr)
    t1 = torch.full((B,), _PHI, dtype=dtype, device=A.device)
    iters0 = torch.ones((B,), dtype=torch.int32, device=A.device)

    def body(k, state):
        x, z_prev, t, done, iters = state
        dm = done.to(dtype)
        if use_kernel:
            x, z_prev, t, res = fused_fista_k_steps(
                A, b, x, z_prev, t, gamma, thr, dm, K=K, restart=restart)
        else:
            x, z_prev, t, res = reference_fista_k_steps(
                A, b, x, z_prev, t, gamma, thr, dm, K=K, restart=restart)
        iters = torch.where(done, iters, k)
        return x, z_prev, t, done | (res / gamma <= tol), iters

    # x and z_prev start equal but are separate buffers: the kernel updates
    # both in place
    state, k = run_host_loop(
        body, (z0.clone(), z0, t1, res0 / gamma <= tol, iters0),
        lambda s: s[3], maxit, k_step=K)
    _, z, _, done, iters = state
    # the loop moves K iterations at a time from k = 1, so an unconverged
    # lane may run up to maxit + K - 1 steps; its report is clamped
    return z, torch.clamp(torch.where(done, iters, k), max=maxit), done


@lane_parallel
def solve_lasso_batch_compacting(A, b, lam, Lf, tol, maxit=1000,
                                 use_kernel=True, restart=False, segment=64,
                                 min_batch=32, x0=None):
    """Batched FISTA with lane compaction of the convergence tail.

    Same contract as ``proxtpu.kernels.lasso.solve_lasso_batch_compacting``:
    the per-lane trajectory, stopping rule and counts of
    :func:`solve_lasso_batch` (the loop body is shared); solutions are
    equal to the last bit wherever a lane's sums do not depend on the batch
    size, as the kernels' do not.  Every ``segment`` iterations the host
    reads the done flags once; where at most half the batch is live, the
    live lanes are gathered on the device (``index_select``) down to the
    next power of two, at least ``min_batch``, padded with copies of lane 0
    marked done (frozen), so that the tail reads only the live lanes' A.
    The finished lanes' results go into buffers on A's device.  Returns
    ``(xs (B, N), iters (B,) int32, done (B,) bool)``."""
    _real_operands(A, b, x0)
    B, M, N = A.shape
    dtype, dev = A.dtype, A.device
    segment = max(1, int(segment))  # segment <= 0 would spin forever
    gamma = 1.0 / _per_lane(Lf, B, A)
    thr = gamma * _per_lane(lam, B, A)
    step = fused_fb_prox_grad if use_kernel else reference_fb_prox_grad
    z0, res0 = step(A, b, _x0_or_zeros(x0, B, N, A), gamma, thr)
    t0 = torch.ones((B,), dtype=dtype, device=dev)
    ops = (A, b, gamma, thr)         # the live lanes' operands
    # x and z_prev start equal but are separate buffers: the kernel updates
    # both in place
    state = (z0.clone(), z0, (1 + torch.sqrt(1 + 4 * t0 * t0)) / 2,
             res0 / gamma <= tol,
             torch.ones((B,), dtype=torch.int32, device=dev))
    idx = torch.arange(B)            # live lane -> original lane, on the host
    live = B                         # real lanes among the first `live`
    out_z = torch.zeros((B, N), dtype=dtype, device=dev)
    out_it = torch.zeros((B,), dtype=torch.int32, device=dev)
    out_done = torch.zeros((B,), dtype=torch.bool, device=dev)

    def flush(lanes, done):
        """Copy the results of the live lanes ``lanes`` (host indices) out."""
        orig = idx[lanes].to(dev)
        lanes = lanes.to(dev)
        out_z.index_copy_(0, orig, state[1].index_select(0, lanes))
        out_it.index_copy_(0, orig, state[4].index_select(0, lanes))
        out_done.index_copy_(0, orig, done)

    k = 1
    while k < maxit:
        body = _make_fista_body(*ops, tol, use_kernel=use_kernel,
                                restart=restart)
        state, k = run_host_loop(body, state, lambda s: s[3],
                                 min(k + segment, maxit), k=k)
        done_h = state[3][:live].cpu()   # the host's one sync a segment
        active = torch.nonzero(~done_h).squeeze(1)
        if active.numel() == 0:
            break
        target = max(min_batch, 1 << (active.numel() - 1).bit_length())
        if target < ops[0].shape[0]:
            finished = torch.nonzero(done_h).squeeze(1)
            flush(finished, torch.ones(finished.numel(), dtype=torch.bool,
                                       device=dev))
            pad = target - active.numel()
            sel = torch.cat([active, torch.zeros(pad, dtype=torch.long)]
                            ).to(dev)
            ops = tuple(t.index_select(0, sel) for t in ops)
            x, z_prev, t, _, iters = state
            done = torch.cat([torch.zeros(active.numel(), dtype=torch.bool),
                              torch.ones(pad, dtype=torch.bool)]).to(dev)
            state = (x.index_select(0, sel), z_prev.index_select(0, sel),
                     t.index_select(0, sel), done,
                     iters.index_select(0, sel))
            idx = idx[active]
            live = active.numel()
    # everything still live, converged or stopped at maxit
    flush(torch.arange(live), state[3][:live])
    # solve_lasso_batch's report: unconverged lanes ran to min(maxit, k)
    return out_z, torch.where(out_done, out_it, min(maxit, k)), out_done


def solve_lasso_multirhs(A, Bmat, lam, Lf, tol, maxit=2000, iter_block=1,
                         restart=False, x0=None, lam2=None):
    """Batched FISTA for many lasso instances sharing one design matrix,

        min_x  ||A x_i - b_i||^2 / 2 + lam_i ||x_i||_1,   i = 1..B,

    as ``proxtpu.kernels.lasso.solve_lasso_multirhs``: A (M, N), ``Bmat``
    (B, M), ``lam`` scalar or (B,), ``Lf`` a scalar; ``lam2`` (scalar or
    (B,)) the elastic-net ridge, divided in the prox as
    ``ElasticNet.prox`` does; ``x0`` warm-starts.  A step is two matrix
    products, ``X A^T`` and ``R A``, through ``torch.matmul`` in full
    float32 (it raises where TF32 is allowed); the reference computes them
    outside any kernel too.  ``iter_block`` K runs K steps between the
    convergence tests, which are then sampled every K iterations (counts
    are upper bounds, clamped to ``maxit``), and tests the restart only on
    a block's last step; K = 1 is the textbook per-step solve.  Same
    stopping rule and freezing as :func:`solve_lasso_batch`.

    Placed arguments (DTensors) run as GSPMD runs the reference's placed
    arrays (:func:`~proxtpu_torch.parallel.sharded_ops.localize_multirhs`):
    lanes over a dp axis each rank solves its own; A in row stripes over a
    tp axis makes ``R A`` a partial sum that one all-reduce over tp a step
    makes whole, and every rank of a tp group then holds the same bits.
    Returns ``(xs (B, N), iters (B,) int32, done (B,) bool)``, placed as
    the lanes came in."""
    A, Bmat, (lam, Lf, x0, lam2), group, lanes = localize_multirhs(
        A, Bmat, (lam, Lf, x0, lam2))
    out = _solve_multirhs(((A, Bmat),), lam, Lf, tol, maxit=maxit,
                          iter_block=iter_block, restart=restart, x0=x0,
                          lam2=lam2, group=group)
    return out if lanes is None else place_lanes(out, *lanes)


def _solve_multirhs(stripes, lam, Lf, tol, maxit=2000, iter_block=1,
                    restart=False, x0=None, lam2=None, group=None):
    """:func:`solve_lasso_multirhs` on local tensors.  ``stripes`` is
    ``((A_1, B_1), ...)``: row stripes of A (M_i, N) with the matching
    columns of the right-hand sides (B, M_i); a step's ``R A`` is the sum
    of the stripes' ``(X A_i^T - B_i) A_i`` in order (one stripe: the
    plain product), then over ``group`` by one
    :func:`~proxtpu_torch.parallel.sharded_ops.all_reduce` of the (B, N)
    product where ``group`` is given.  Nothing else needs a collective:
    ``res``, the restart test, ``t`` and ``done`` come from X and Z, which
    every rank of the group holds whole."""
    require_full_f32_matmul()
    _real_operands(*(t for stripe in stripes for t in stripe), x0)
    A0, B0 = stripes[0]
    B, N = B0.shape[0], A0.shape[1]
    dtype = A0.dtype
    gamma = 1.0 / torch.as_tensor(Lf, dtype=dtype, device=A0.device)
    thr = gamma * _per_lane(lam, B, A0)
    shrink = None if lam2 is None else 1.0 + gamma * _per_lane(lam2, B, A0)
    K = int(iter_block)
    if K < 1:
        raise ValueError(f"iter_block must be >= 1, got {iter_block}")

    def step(X):
        G = None
        for A, Bmat in stripes:
            part = torch.matmul(torch.matmul(X, A.t()) - Bmat, A)
            G = part if G is None else G + part
        if group is not None:
            G = all_reduce(G, group)
        Z = _soft_threshold(X - gamma * G, thr[:, None])
        if shrink is not None:
            Z = Z / shrink[:, None]
        return Z, torch.amax(torch.abs(X - Z), dim=1)

    def body(k, state):
        x, z_prev, t, done, iters = state
        xn, zn, tn = x, z_prev, t
        for j in range(K):
            z, res = step(xn)
            if restart and j == K - 1:
                # reset t before the coefficient is drawn (immediate
                # restart), on the block's last step only
                rs = torch.sum((xn - z) * (z - zn), dim=1)
                tn = torch.where(rs > 0, torch.ones_like(tn), tn)
            t_new = (1 + torch.sqrt(1 + 4 * tn * tn)) / 2
            beta = ((tn - 1) / t_new)[:, None]
            xn, zn, tn = z + beta * (z - zn), z, t_new
        keep = done[:, None]
        return (torch.where(keep, x, xn), torch.where(keep, z_prev, zn),
                torch.where(done, t, tn), done | (res / gamma <= tol),
                torch.where(done, iters, k))

    z0, res0 = step(_x0_or_zeros(x0, B, N, A0))
    t0 = torch.ones((B,), dtype=dtype, device=A0.device)
    state, k = run_host_loop(
        body, (z0, z0, (1 + torch.sqrt(1 + 4 * t0 * t0)) / 2,
               res0 / gamma <= tol,
               torch.ones((B,), dtype=torch.int32, device=A0.device)),
        lambda s: s[3], maxit, k_step=K)
    _, z, _, done, iters = state
    return z, torch.clamp(torch.where(done, iters, k), max=maxit), done


@lane_parallel
def solve_lasso_batch_mixed(A, b, lam, Lf, tol, maxit=1000, warm_tol=None,
                            warm_maxit=None, use_kernel=True,
                            warm_dtype=torch.bfloat16, restart=False):
    """Two-stage batched FISTA: a warm start on A stored in ``warm_dtype``,
    then the float32 polish, as
    ``proxtpu.kernels.lasso.solve_lasso_batch_mixed``.

    Stage 1 iterates on ``A.to(warm_dtype)`` (float32 arithmetic on each
    entry cast up: only the storage narrows, and the one-step kernels'
    bfloat16 instances read half the bytes) until ``res / gamma <=
    warm_tol`` (default ``max(30 tol, 1e-2)``; the bf16 operator moves the
    fixed point by about its relative error), at most ``warm_maxit - 1``
    steps after the init step.  Stage 2 takes an FB step at the float32 A
    from the last prox point, then FISTA from a fresh momentum to ``tol``:
    the stopping criterion of :func:`solve_lasso_batch`.  Counts add both
    stages.  The kernels take A in bfloat16 or float32 only, so
    ``use_kernel`` with another ``warm_dtype`` raises; the plain route
    (``use_kernel=False``) computes at ``A.to(warm_dtype).to(A.dtype)``.
    Returns ``(xs (B, N), iters (B,) int32, done (B,) bool)``."""
    _real_operands(A, b)
    B, M, N = A.shape
    dtype, dev = A.dtype, A.device
    if use_kernel and warm_dtype not in STEP_A_DTYPES:
        raise TypeError(f"warm_dtype {warm_dtype}: the kernels take A in "
                        f"float32 or bfloat16")
    if warm_tol is None:
        warm_tol = max(tol * 30.0, 1e-2)
    if warm_maxit is None:
        warm_maxit = maxit
    gamma = 1.0 / _per_lane(Lf, B, A)
    thr = gamma * _per_lane(lam, B, A)
    A_warm = A.to(warm_dtype)
    if not use_kernel:
        A_warm = A_warm.to(dtype)  # the operator the plain route steps on
    step = fused_fb_prox_grad if use_kernel else reference_fb_prox_grad

    def stage(A_, x_init, stop_tol, stage_maxit, k0, iters0, done0):
        """FISTA from x = z_prev = ``x_init``, t = 1, iterations ``k0 + 1``
        to at most ``k0 + stage_maxit``.  Returns ``(k, z, iters, done)``
        with ``k`` the reference's: its loop stops at the iteration that
        leaves every lane done."""
        body = _make_fista_body(A_, b, gamma, thr, stop_tol,
                                use_kernel=use_kernel, restart=restart)
        state, k = run_host_loop(
            body, (x_init.clone(), x_init,
                   torch.ones((B,), dtype=dtype, device=dev), done0, iters0),
            lambda s: s[3], k0 + stage_maxit, k=k0)
        _, z, _, done, iters = state
        if bool(done.all()):
            # the host tests all-done every few iterations; the last lane
            # to finish set its count to the iteration that ended the loop
            k = max(k0, int(iters.max()))
        return k, z, torch.where(done, iters, k), done

    # stage 1: the warm operator to warm_tol; the init FB step counts as
    # iteration 1, as in solve_lasso_batch
    z0, res0 = step(A_warm, b, torch.zeros((B, N), dtype=dtype, device=dev),
                    gamma, thr)
    k1, z1, it1, _ = stage(A_warm, z0, warm_tol, warm_maxit - 1, 1,
                           torch.ones((B,), dtype=torch.int32, device=dev),
                           res0 / gamma <= warm_tol)
    # stage 2: the float32 polish from z1, the last prox point; lanes
    # already under tol at the float32 operator finish in this one step
    z2, res2 = step(A, b, z1, gamma, thr)
    done2 = res2 / gamma <= tol
    k2 = k1 + 1
    _, z, iters, done = stage(A, z2, tol, maxit, k2,
                              torch.where(done2, k2, it1), done2)
    return z, torch.clamp(iters, max=maxit + warm_maxit), done
