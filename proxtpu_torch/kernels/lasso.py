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
block of K.  Its kernel streams a lane's A once per inner step through a
ring of row tiles in shared memory and, where the batch leaves SMs idle,
serves a lane by a cluster of thread blocks; the launch plan is chosen here
on the host (:func:`k_steps_plan`).

The TPU's lane-packed layout (``pack_lasso_batch``) is not ported: it only
strips the 128-lane padding of the TPU's tiles, and a row on the card has
none.  ``solve_lasso_batch_packed`` keeps its signature and results and runs
the natural layout through the full-step kernel.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..utils.host_loop import run_host_loop
from ..utils.precision import require_full_f32_matmul
from . import _build

# t after a restart: the simple t-sequence one step from t = 1
_PHI = (1 + math.sqrt(5.0)) / 2


def _soft_threshold(y, thr):
    return torch.sign(y) * torch.clamp(torch.abs(y) - thr, min=0.0)


def reference_fb_prox_grad(A, b, x, gamma, thr, shrink=None):
    """Plain version of the FB step (two reads of A).

    Args: A (B, M, N), b (B, M), x (B, N); gamma, thr (B,) per-lane step and
    soft-threshold level; ``shrink`` (B,) optional elastic-net prox
    denominator ``1 + gamma*lam2`` (divided, bit-matching
    ``ElasticNet.prox``).  Returns ``(z (B, N), res_inf (B,))``."""
    require_full_f32_matmul()
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


def _check_operands(A, b, vectors, scalars, smem_bytes=None):
    """Raise unless the kernels take these operands: float32, contiguous,
    on A's CUDA device, A (B, M, N), b (B, M), ``vectors`` (B, N),
    ``scalars`` (B,), and a block's shared memory holds ``smem_bytes``
    (default: one row of N plus r, the one-step kernels' need)."""
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
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes float32")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if smem_bytes is None:
        smem_bytes = (N + M) * 4
    _build.check_shared_bytes(smem_bytes, A.device)


def _ptr(t):
    return None if t is None else t.data_ptr()


def fused_fb_prox_grad(A, b, x, gamma, thr, shrink=None):
    """One FB step for the batch (see :func:`reference_fb_prox_grad`),
    through the ``fb_step`` kernel for CUDA tensors.  Returns
    ``(z (B, N), res_inf (B,))``."""
    if A.device.type == "cpu":
        return reference_fb_prox_grad(A, b, x, gamma, thr, shrink)
    scalars = [("gamma", gamma), ("thr", thr)]
    if shrink is not None:
        scalars.append(("shrink", shrink))
    _check_operands(A, b, [("x", x)], scalars)
    B, M, N = A.shape
    z = torch.empty_like(x)
    res = torch.empty(B, dtype=x.dtype, device=x.device)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.library().proxtpu_fb_step(
            A.data_ptr(), b.data_ptr(), x.data_ptr(), gamma.data_ptr(),
            thr.data_ptr(), _ptr(shrink), z.data_ptr(), res.data_ptr(),
            B, M, N, ctypes.c_void_p(stream))
    _build.check(err, "fb_step")
    fused_fb_prox_grad.launches += 1
    return z, res


fused_fb_prox_grad.launches = 0


def fused_fista_full_step(A, b, x, z_prev, beta, gamma, thr, done_mask,
                          shrink=None, restart=False):
    """One full FISTA iteration for the batch (see
    :func:`reference_fista_full_step`), through the ``fista_step`` kernel
    for CUDA tensors.

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
    scalars = [("beta", beta), ("gamma", gamma), ("thr", thr),
               ("done_mask", done_mask)]
    if shrink is not None:
        scalars.append(("shrink", shrink))
    _check_operands(A, b, [("x", x), ("z_prev", z_prev)], scalars)
    B, M, N = A.shape
    res = torch.empty(B, dtype=x.dtype, device=x.device)
    rs = torch.empty_like(res)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.library().proxtpu_fista_step(
            A.data_ptr(), b.data_ptr(), x.data_ptr(), z_prev.data_ptr(),
            beta.data_ptr(), gamma.data_ptr(), thr.data_ptr(),
            done_mask.data_ptr(), _ptr(shrink), res.data_ptr(),
            rs.data_ptr(), B, M, N, int(restart), ctypes.c_void_p(stream))
    _build.check(err, "fista_step")
    fused_fista_full_step.launches += 1
    return x, z_prev, res, rs


fused_fista_full_step.launches = 0


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
# a stage of the ring holds full rows, about this many bytes of them: each
# tile costs a block barrier and the latency of one row's dot product, so
# few tall tiles beat many short ones, and three stages of 64 KB (one in
# use, two in flight) fill a block's 227 KB.  Below three stages a refill
# by ordinary stores could meet its own reader.
_STAGE_BYTES = 64 * 1024
_STAGES = 3
# rows of a tile where no ring fits and the tiles are read in place
_DIRECT_ROWS = 8


def _round_up(v, to):
    return -(-v // to) * to


def cluster_plan(B, M, sms):
    """Thread blocks per lane, C: the largest of 8, 4, 2, 1 such that the
    B * C blocks fit the ``sms`` SMs in one wave and every block gets at
    least ``MIN_SLAB_ROWS`` of the lane's M rows."""
    for C in CLUSTER_SIZES:
        if C == 1 or (B * C <= sms and M // C >= MIN_SLAB_ROWS):
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


def ring_plan(M, N, C, limit):
    """``(R, S)``: rows per tile and stages of the ring of a block that owns
    ``ceil(M / C)`` rows of N floats, within ``limit`` bytes of shared
    memory.  Three stages of about ``_STAGE_BYTES``, or of fewer rows where
    those do not fit; ``S == 0`` where not even three one-row stages fit."""
    R = max(1, min(-(-M // C), _STAGE_BYTES // (N * 4)))
    while k_steps_shared_bytes(M, N, C, R, _STAGES) > limit:
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


def _check_not_ported(step_mult):
    if step_mult != 1.0:
        raise NotImplementedError(
            "step_mult != 1 (over-relaxed FISTA) is not ported yet: "
            "ROADMAP.md queue 1, item 2(a), 'step_mult'")


def _check_mf(mf, restart, lam2):
    if mf is not None and restart:
        raise ValueError(
            "restart needs the t-recursion; mf>0 uses a constant "
            "extrapolation coefficient (restart would be a no-op)")
    if mf is not None and lam2 is not None:
        raise ValueError(
            "lam2 (elastic net) composes with restart only; the mf "
            "analysis was validated for the pure-l1 prox")


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


def solve_lasso_batch(A, b, lam, Lf, tol, maxit=1000, use_kernel=True,
                      restart=False, x0=None, mf=None, step_mult=1.0,
                      lam2=None):
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
    after that; it excludes ``restart`` and ``lam2``.  ``step_mult != 1``
    is not ported yet and raises :class:`NotImplementedError`.

    Returns ``(xs (B, N), iters (B,) int32, done (B,) bool)``."""
    _check_not_ported(step_mult)
    _check_mf(mf, restart, lam2)
    B, M, N = A.shape
    dtype = A.dtype
    lam = _per_lane(lam, B, A)
    gamma = 1.0 / _per_lane(Lf, B, A)
    thr = gamma * lam
    shrink = None if lam2 is None else 1.0 + gamma * _per_lane(lam2, B, A)
    step = fused_fb_prox_grad if use_kernel else reference_fb_prox_grad
    x0 = (torch.zeros((B, N), dtype=dtype, device=A.device) if x0 is None
          else torch.as_tensor(x0, dtype=dtype, device=A.device).reshape(B, N))
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
    mf > 0 variant)."""
    dtype = A.dtype

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
    _, z, _, done, iters = state
    return z, torch.where(done, iters, k), done


def solve_lasso_batch_packed(A, b, lam, Lf, tol, maxit=1000, restart=False,
                             x0=None, pack=None, mf=None, step_mult=1.0,
                             lam2=None, use_kernel=True):
    """Batched FISTA, the bulk solver of the main path.

    Same signature and results as
    ``proxtpu.kernels.lasso.solve_lasso_batch_packed``.  ``pack`` is checked
    (it must divide B) but selects no layout: the packing exists only to
    strip the TPU's lane padding, so the natural layout runs through the
    full-step kernel.  ``use_kernel=False`` runs the plain route (it takes
    the place of the JAX ``interpret`` flag).  ``mf`` as in
    :func:`solve_lasso_batch`."""
    _check_mf(mf, restart, lam2)
    _check_not_ported(step_mult)
    B, M, N = A.shape
    if pack is not None and not (pack >= 1 and B % pack == 0):
        raise ValueError(f"pack must be a positive divisor of B={B}, "
                         f"got {pack}")
    if lam2 is not None:
        return solve_lasso_batch(A, b, lam, Lf, tol, maxit=maxit,
                                 use_kernel=use_kernel, restart=restart,
                                 x0=x0, lam2=lam2)
    x0 = (torch.zeros((B, N), dtype=A.dtype, device=A.device) if x0 is None
          else torch.as_tensor(x0, dtype=A.dtype, device=A.device)
          .reshape(B, N))
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
    B, M, N = A.shape
    dtype = A.dtype
    gamma = 1.0 / _per_lane(Lf, B, A)
    thr = gamma * _per_lane(lam, B, A)
    K = int(iter_block)
    x0 = (torch.zeros((B, N), dtype=dtype, device=A.device) if x0 is None
          else torch.as_tensor(x0, dtype=dtype, device=A.device)
          .reshape(B, N))
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
