"""Kernel-route dispatch for batched solves (counterpart of
``match_kernel_solver`` and ``match_tv_solver`` in
``proxtpu/kernels/dispatch.py``).

The generic driver runs any algorithm on any problem; the batched lasso
FISTA, box-QP projected-gradient and TV-denoising Chambolle-Pock problems
have kernel solvers.  :func:`match_kernel_solver` and
:func:`match_tv_solver` recognise those problems structurally (factory,
function classes, options at their defaults) and return a runner, or
``None`` when the problem does not match exactly: the caller then takes the
generic driver.  Dispatch changes how a solve runs, never what it returns:
the same fixed points and stopping rule; per-lane counts within +-1 (the
f32 last-bit boundary), and up to ``iter_block - 1`` more on the blocked
routes, whose counts are upper bounds.

Routing reads shapes and dtypes only, never the device: the device decides
only whether each kernel wrapper launches its kernel (CUDA) or runs its
plain version (CPU).  The reference's rules are kept, with two changes:

* float32 below the 1 MB-per-lane blocked threshold always takes a kernel
  route.  The reference sent small problems to XLA because XLA's batched
  matmul beat its kernel on a v5e (``dispatch.py:668-676``, ``:767-771``),
  a measurement of that chip, not a semantic rule.
* The shared-A leg (one A, many right-hand sides: ``solve_lasso_multirhs``)
  runs one step per convergence test (K = 1) on every device; the
  reference blocks K steps on a TPU only (``dispatch.py:627``), a choice of
  that chip's trip cost.

A problem that holds an operand in row stripes over a tp mesh axis (the dp
x tp composition, after ``lane_parallel(stripes=True)`` has localized it)
takes the shared-A leg (one all-reduce over tp a step), the flat PANOC,
ZeroFPR, PANOCplus and adaptive FB / FISTA machines (their operator's and
gradient's sums over tp inside each oracle round), the flat DRLS leg (a
least squares f in row stripes: its prox sums over tp) or the generic
driver.  The stacked-A lasso and box-QP legs and the TV matcher decline
it.
"""

from __future__ import annotations

import torch

from ..parallel.sharded_ops import holds_row_stripes
from ..utils.tracing import span
from ..utils.tree import real_dtype_of
# problems per packed row (lasso.py): decides, as in the reference, which
# problems take the packed solver, and its layout
from .lasso import _pack_count

# the blocked routes' threshold: bytes of A (or Q) per lane
BLOCKED_LANE_BYTES = 1 << 20
# packed route: at most this many bytes of A per group of `pack` lanes
PACKED_GROUP_BYTES = 4 << 20


def _number(v, device):
    """``v`` as a tensor: a tensor as it is, a Python or numpy number in
    float64, so that a float64 problem keeps all its digits (the JAX
    package's ``jnp.asarray`` under x64)."""
    if isinstance(v, torch.Tensor):
        return v.to(device)
    return torch.as_tensor(v, dtype=torch.float64, device=device)


def _scalar_or_vec(v, B, dtype, device):
    """A scalar or (B,) parameter as a (B,) tensor, or None."""
    t = _number(v, device)
    if t.dim() == 0:
        return torch.full((B,), float(t), dtype=dtype, device=device)
    if tuple(t.shape) == (B,):
        return t.to(dtype)
    return None


def _restart_of(seq):
    """True for ``AdaptiveRestartSequence`` around the default t-recursion,
    False for no sequence, None for any other sequence."""
    if seq is None:
        return False
    from ..accel.nesterov import (
        AdaptiveNesterovSequence,
        AdaptiveRestartSequence,
        FixedNesterovSequence,
    )

    inner = getattr(seq, "sequence", None)
    if isinstance(seq, AdaptiveRestartSequence) and (
            isinstance(inner, FixedNesterovSequence)
            or (isinstance(inner, AdaptiveNesterovSequence)
                and float(inner.m) == 0.0)):
        return True
    return None


def _all_zero(v):
    return not bool(torch.as_tensor(v).any())


def match_tv_solver(factory, kwargs, *, tol, maxit, stop=None, solution=None,
                    iter_block=8):
    """``run() -> ((xbar, ybar), iters, done)`` for batched TV denoising by
    Chambolle-Pock (:func:`proxtpu_torch.kernels.tv.solve_tv_batch`), or
    ``None``.

    Recognised: ``make_chambolle_pock_iteration`` (or AFBA / Vu-Condat with
    ``theta = 2`` and ``f``, ``l`` at their Chambolle-Pock defaults) with
    ``g = SqrDistance(b)`` over stacked (B, H, W) images, ``h = NormL21(lam,
    axis=0)`` with a scalar or (B,) ``lam``, ``L = Grad2DOperator((H, W))``,
    zero ``x0`` (B, H, W) and ``y0`` (B, 2, H, W), relaxation ``lam = 1`` and
    default, scalar or (B,) stepsizes.  Anything else returns ``None``.

    The runner returns the generic driver's solution structure and stopping
    rule; per-image counts are upper bounds with up to ``iter_block - 1``
    of sampling slack.  float32 takes the kernel route, float64 the plain
    step."""
    if stop is not None or solution is not None or holds_row_stripes(
            kwargs):
        return None
    name = getattr(factory, "__name__", "")
    if name != "make_chambolle_pock_iteration":
        if name not in ("make_afba_iteration", "make_vu_condat_iteration"):
            return None
        # plain AFBA must reduce to the Chambolle-Pock configuration
        from ..prox.base import IndZero, Zero

        if name == "make_afba_iteration":
            try:
                if float(kwargs.get("theta", 1.0)) != 2.0:
                    return None
            except (TypeError, ValueError):
                return None
        f, l = kwargs.get("f"), kwargs.get("l")
        if f is not None and not isinstance(f, Zero):
            return None
        if l is not None and not isinstance(l, IndZero):
            return None
    for k in ("beta_f", "beta_l"):
        v = kwargs.get(k)
        if v is not None and float(v) != 0.0:
            return None
    try:
        if float(kwargs.get("lam", 1.0)) != 1.0:
            return None
    except (TypeError, ValueError):
        return None

    from ..ops.linops import Grad2DOperator
    from ..prox.functions import NormL21, SqrDistance

    g, h, L = kwargs.get("g"), kwargs.get("h"), kwargs.get("L")
    if not isinstance(g, SqrDistance) or not isinstance(h, NormL21):
        return None
    if not isinstance(L, Grad2DOperator):
        return None
    if int(h.axis) != 0:
        return None
    b = torch.as_tensor(g.b)
    if b.dim() != 3 or b.is_complex():
        return None
    B, H, W = b.shape
    if tuple(L.shape) != (H, W):
        return None
    x0, y0 = kwargs.get("x0"), kwargs.get("y0")
    if x0 is None or y0 is None:
        return None
    x0, y0 = torch.as_tensor(x0), torch.as_tensor(y0)
    if (tuple(x0.shape) != (B, H, W) or tuple(y0.shape) != (B, 2, H, W)
            or x0.is_complex() or y0.is_complex()):
        return None
    if not (_all_zero(x0) and _all_zero(y0)):
        return None

    lam = h.lam
    if tuple(torch.as_tensor(lam).shape) not in ((), (B,)):
        return None
    gamma1, gamma2 = kwargs.get("gamma1"), kwargs.get("gamma2")
    if kwargs.get("gamma") is not None:
        try:
            gamma1, gamma2 = kwargs["gamma"]
        except (TypeError, ValueError):
            return None
    for gv in (gamma1, gamma2):
        if gv is not None and tuple(torch.as_tensor(gv).shape) not in (
                (), (B,)):
            return None

    from .tv import solve_tv_batch

    # the kernel takes float32; float64 takes the plain step
    use_kernel = b.dtype == torch.float32

    return lambda: solve_tv_batch(
        b, lam, tol, maxit=maxit, iter_block=iter_block, gamma1=gamma1,
        gamma2=gamma2, use_kernel=use_kernel, return_dual=True)


def _match_multirhs(A, b, f, g_l1, g_lam2, kwargs, x0, x0_pass, mf,
                    restart, tol, maxit, group=None):
    """The shared-A leg of :func:`match_kernel_solver`: A (M, N) shared by
    the B lanes of b (B, M) -> :func:`~.lasso.solve_lasso_multirhs` at
    K = 1, or ``None``.  It needs a scalar step (``Lf`` or ``gamma``), a
    scalar or (B,) l1 weight (and ridge), x0 (B, N) and no ``mf``; float64
    takes it too, since no hand-written kernel runs.  With ``group`` (a
    ``RowShardedLeastSquaresLoss``), A and b are this rank's row stripe
    and the solver's core sums each step's ``R A`` over ``group``."""
    B = b.shape[0]
    if not bool((torch.as_tensor(getattr(f, "lam", 1.0)) == 1.0).all()):
        return None
    lam = _scalar_or_vec(g_l1, B, A.dtype, A.device)
    lam2 = (None if g_lam2 is None
            else _scalar_or_vec(g_lam2, B, A.dtype, A.device))
    if g_lam2 is not None and lam2 is None:
        return None
    Lf, gamma = kwargs.get("Lf"), kwargs.get("gamma")
    if gamma is not None:
        gamma = _number(gamma, A.device)
        Lfs = 1.0 / gamma if gamma.dim() == 0 else None
    elif Lf is not None:
        Lf = _number(Lf, A.device)
        Lfs = Lf if Lf.dim() == 0 else None
    else:
        Lfs = None
    if lam is None or Lfs is None:
        return None
    if tuple(x0.shape) != (B, A.shape[1]) or mf is not None:
        return None

    from . import lasso

    if group is not None:
        return lambda: lasso._solve_multirhs(
            ((A, b),), lam, Lfs, tol, maxit=maxit, iter_block=1,
            restart=restart, x0=x0_pass, lam2=lam2, group=group)
    return lambda: lasso.solve_lasso_multirhs(
        A, b, lam, Lfs, tol, maxit=maxit, iter_block=1, restart=restart,
        x0=x0_pass, lam2=lam2)


def match_kernel_solver(factory, kwargs, *, tol, maxit, stop=None,
                        solution=None, iter_block=8):
    """``run() -> (xs, iters, done)`` for a kernel-route problem, or
    ``None``.

    Recognised:

    * ``make_fast_forward_backward_iteration`` + ``LeastSquaresLoss`` or
      ``LeastSquares`` (stacked A (B, M, N), b (B, M), lam = 1) +
      ``NormL1`` or ``ElasticNet`` + a fixed step (``Lf`` or ``gamma``) +
      x0 + the default sequence or adaptive restart around it, optionally
      a scalar ``mf > 0``  ->  the lasso solvers;
    * the same with one A (M, N) for every lane (b (B, M), or b (M,) of a
      ``Shared`` f broadcast to x0's lanes), a scalar step and no ``mf``
      ->  :func:`~.lasso.solve_lasso_multirhs` at K = 1; a ``Shared`` f in
      row stripes over tp (``RowShardedLeastSquaresLoss``) -> the same
      solver on the stripe, one all-reduce over tp a step;
    * ``make_forward_backward_iteration`` + ``Quadratic`` (stacked Q, q) +
      ``IndBox`` (finite scalar bounds) + a fixed step  ->  the box-QP
      solvers.
    """
    if stop is not None or solution is not None:
        return None
    if kwargs.get("adaptive"):
        return None
    seq = kwargs.get("extrapolation_sequence")
    restart = _restart_of(seq)
    if restart is None:
        return None
    # mf > 0 (a scalar) rides the lasso kernels as a constant coefficient;
    # an array-valued mf takes the generic driver
    mf_raw = kwargs.get("mf", 0.0)
    if mf_raw is not None and torch.as_tensor(mf_raw).dim() != 0:
        return None
    mf = 0.0 if mf_raw is None else float(mf_raw)
    mf = mf if mf > 0.0 else None
    if mf is not None and seq is not None:
        return None
    x0 = kwargs.get("x0")
    if x0 is None:
        return None
    x0 = torch.as_tensor(x0)
    if x0.is_complex():
        return None  # the kernel legs solve real problems only
    with span("sync.x0_any"):
        x0_pass = x0 if bool(x0.any()) else None

    from ..utils.shared import Shared

    f, g = kwargs.get("f"), kwargs.get("g")
    name = getattr(factory, "__name__", "")

    if name == "make_fast_forward_backward_iteration":
        from ..prox.functions import (
            ElasticNet,
            LeastSquares,
            LeastSquaresLoss,
            NormL1,
        )

        from ..parallel.sharded_ops import RowShardedLeastSquaresLoss

        if isinstance(f, Shared):
            f = f.value
        if isinstance(g, Shared):
            g = g.value
        group = getattr(f, "group", None)
        if not isinstance(f, (LeastSquares, LeastSquaresLoss,
                              RowShardedLeastSquaresLoss)):
            return None
        if holds_row_stripes({k: v for k, v in kwargs.items() if k != "f"}):
            return None  # stripes elsewhere than in a shared-A f
        if isinstance(g, ElasticNet):
            g_l1, g_lam2 = g.mu, g.lam
        elif isinstance(g, NormL1):
            g_l1, g_lam2 = g.lam, None
        else:
            return None
        if g_lam2 is not None and mf is not None:
            return None
        A, b = torch.as_tensor(f.A), torch.as_tensor(f.b)
        if A.is_complex() or b.is_complex():
            return None
        if A.dim() == 2 and b.dim() == 1:
            # a Shared f (the regularisation path): one (A, b) for every
            # lane, lam per lane; b is broadcast to x0's lanes
            if x0.dim() == 0:
                return None
            b = b.expand(x0.shape[0], b.shape[0])
        if A.dim() == 2 and b.dim() == 2:
            return _match_multirhs(A, b, f, g_l1, g_lam2, kwargs, x0, x0_pass,
                                   mf, restart, tol, maxit, group)
        if group is not None:
            return None  # the stacked-A leg takes no row stripes
        if A.dim() != 3 or b.dim() != 2 or A.shape[0] != b.shape[0]:
            return None
        B = A.shape[0]
        if not bool((torch.as_tensor(getattr(f, "lam", 1.0)) == 1.0).all()):
            return None
        lam = _scalar_or_vec(g_l1, B, A.dtype, A.device)
        if lam is None:
            return None
        lam2 = (None if g_lam2 is None
                else _scalar_or_vec(g_lam2, B, A.dtype, A.device))
        if g_lam2 is not None and lam2 is None:
            return None
        Lf, gamma = kwargs.get("Lf"), kwargs.get("gamma")
        if gamma is not None:
            Lfv = _scalar_or_vec(gamma, B, A.dtype, A.device)
            Lfv = None if Lfv is None else 1.0 / Lfv
        elif Lf is not None:
            Lfv = _scalar_or_vec(Lf, B, A.dtype, A.device)
        else:
            return None  # a fixed-step solve needs an explicit stepsize
        if Lfv is None:
            return None
        if tuple(x0.shape) != (A.shape[0], A.shape[2]):
            return None

        from . import lasso

        lane_bytes = A.shape[1] * A.shape[2] * A.element_size()
        pack = _pack_count(A.shape[2], B)
        packable = pack > 1 and pack * lane_bytes <= PACKED_GROUP_BYTES
        # the kernels take float32; float64 takes the plain route
        f32 = A.dtype == torch.float32

        def run():
            if (f32 and lane_bytes >= BLOCKED_LANE_BYTES and mf is None
                    and lam2 is None):
                return lasso.solve_lasso_batch_blocked(
                    A, b, lam, Lfv, tol, maxit=maxit, iter_block=iter_block,
                    restart=restart, x0=x0_pass)
            if f32 and packable and lam2 is None:
                return lasso.solve_lasso_batch_packed(
                    A, b, lam, Lfv, tol, maxit=maxit, restart=restart,
                    x0=x0_pass, mf=mf)
            return lasso.solve_lasso_batch(
                A, b, lam, Lfv, tol, maxit=maxit, use_kernel=f32,
                restart=restart, x0=x0_pass, mf=mf, lam2=lam2)

        return run

    if name == "make_forward_backward_iteration":
        from ..prox.functions import IndBox, Quadratic

        if seq is not None or mf is not None:
            return None  # plain FB has no momentum to restart or tune
        if holds_row_stripes(kwargs):
            return None  # the box-QP leg takes no row stripes
        if not isinstance(f, Quadratic) or not isinstance(g, IndBox):
            return None
        Q, q = torch.as_tensor(f.Q), torch.as_tensor(f.q)
        if Q.is_complex() or q.is_complex():
            return None
        if Q.dim() != 3 or q.dim() != 2 or Q.shape[1] != Q.shape[2]:
            return None
        B = Q.shape[0]
        lo, hi = torch.as_tensor(g.low), torch.as_tensor(g.high)
        if lo.dim() != 0 or hi.dim() != 0 or not (
                bool(torch.isfinite(lo)) and bool(torch.isfinite(hi))):
            return None
        lo, hi = float(lo), float(hi)
        gamma, Lf = kwargs.get("gamma"), kwargs.get("Lf")
        if gamma is not None:
            gv = _scalar_or_vec(gamma, B, Q.dtype, Q.device)
        elif Lf is not None:
            Lfv = _scalar_or_vec(Lf, B, Q.dtype, Q.device)
            gv = None if Lfv is None else 1.0 / Lfv
        else:
            return None
        if gv is None:
            return None
        Lip = 0.95 / gv  # the solvers set gamma = 0.95 / Lip per lane
        if tuple(x0.shape) != tuple(q.shape):
            return None

        from . import box_qp

        blocked = Q.shape[1] ** 2 * Q.element_size() >= BLOCKED_LANE_BYTES
        f32 = Q.dtype == torch.float32

        def run():
            if f32 and blocked:
                return box_qp.solve_box_qp_batch_blocked(
                    Q, q, lo, hi, Lip, tol, maxit=maxit,
                    iter_block=iter_block, x0=x0_pass)
            return box_qp.solve_box_qp_batch(
                Q, q, lo, hi, Lip, tol, maxit=maxit, use_kernel=f32,
                x0=x0_pass)

        return run

    return None


def _lanes_ok(tree, B):
    """Every tensor of ``tree`` not under a ``Shared`` marker carries the
    batch axis B first."""
    from ..utils.shared import lane_arrays

    return all(l.dim() > 0 and l.shape[0] == B for l in lane_arrays(tree))


def match_flat_adaptive(factory, kwargs, *, tol, maxit, stop=None,
                        solution=None, check_every=1):
    """``run() -> (z, iters, done)`` for batched *adaptive* FB / FISTA on
    the flattened trial/commit machine
    (:mod:`proxtpu_torch.parallel.adaptive_batch`: one oracle evaluation
    per trip instead of ``backtrack_limit`` masked trials per iteration),
    or ``None``.  ``check_every`` trips run between the host's tests
    (``BatchedAlgorithm`` passes 8 unless it was given one); the counts do
    not depend on it.  A ``Shared`` least squares in row stripes over tp
    (``RowShardedLeastSquaresLoss``) sums its gradient over tp once a
    trip."""
    if stop is not None or solution is not None:
        return None
    name = getattr(factory, "__name__", "")
    accel = name == "make_fast_forward_backward_iteration"
    if not accel and name != "make_forward_backward_iteration":
        return None
    gamma, Lf = kwargs.get("gamma"), kwargs.get("Lf")
    adaptive = kwargs.get("adaptive")
    if adaptive is None:
        adaptive = gamma is None and Lf is None
    if not adaptive:
        return None
    if "backtrack_limit" in kwargs:
        # a gamma search the caller cut short: only the generic driver
        # honours it
        return None
    if kwargs.get("extrapolation_sequence") is not None:
        return None
    x0 = kwargs.get("x0")
    f, g = kwargs.get("f"), kwargs.get("g")
    if x0 is None or f is None or g is None:
        return None
    x0 = torch.as_tensor(x0)
    if x0.dim() != 2:
        return None
    B = x0.shape[0]
    if not _lanes_ok((f, g), B):
        return None

    # the steps in the real dtype of x0 (complex iterates keep real
    # gammas); a mis-shaped gamma or Lf takes the generic driver
    R = real_dtype_of(x0)
    gamma0 = None
    if gamma is not None:
        gamma0 = _scalar_or_vec(gamma, B, R, x0.device)
        if gamma0 is None:
            return None
    elif Lf is not None:
        Lfv = _scalar_or_vec(Lf, B, R, x0.device)
        if Lfv is None:
            return None
        gamma0 = 1.0 / Lfv

    from ..parallel import adaptive_batch

    run_fn = (adaptive_batch.batched_adaptive_fista if accel
              else adaptive_batch.batched_adaptive_fb)
    opts = dict(
        maxit=maxit, gamma0=gamma0,
        minimum_gamma=float(kwargs.get("minimum_gamma", 1e-7)),
        reduce_gamma=float(kwargs.get("reduce_gamma", 0.5)),
        increase_gamma=float(kwargs.get("increase_gamma", 1.0)),
        check_every=int(check_every))
    if accel:
        # a per-lane mf has no flat route
        mf_val = kwargs.get("mf", 0.0)
        if mf_val is not None and torch.as_tensor(mf_val).dim() != 0:
            return None
        opts["mf"] = float(mf_val or 0.0)

    return lambda: run_fn(f, g, x0, tol, **opts)


_FLAT_LS = {
    "make_panoc_iteration": "batched_panoc",
    "make_zerofpr_iteration": "batched_zerofpr",
    "make_drls_iteration": "batched_drls",
    "make_panocplus_iteration": "batched_panocplus",
}


def _directions(kwargs):
    """The quasi-Newton or null direction of ``kwargs`` (L-BFGS(5) by
    default), or ``None`` for any other style."""
    from ..accel.base import NO_ACCELERATION, QUASI_NEWTON
    from ..accel.lbfgs import LBFGS

    directions = kwargs.get("directions")
    if directions is None:
        directions = LBFGS(5)
    if getattr(directions, "style", None) not in (QUASI_NEWTON,
                                                  NO_ACCELERATION):
        return None
    return directions


def match_flat_linesearch(factory, kwargs, *, tol, maxit, stop=None,
                          solution=None, check_every=None):
    """``run() -> (z, iters, done)`` for batched PANOC, ZeroFPR, PANOCplus
    (fixed or adaptive step) and DRLS on the flattened trial/commit
    machines (:mod:`proxtpu_torch.parallel.flat_ls`: one oracle evaluation
    per trip instead of ``max_backtracks`` masked trials per iteration),
    or ``None``.  ``check_every=None`` picks 8 for adaptive PANOC and 1
    elsewhere, as the JAX package; the counts do not depend on it.  A
    ``Shared`` operator in row stripes over tp
    (``RowShardedMatrixOperator``: whole rows out of ``matvec``) costs two
    all-reduces over tp an oracle round; DRLS takes only a least squares
    f in row stripes (see :func:`_match_flat_drls`)."""
    if stop is not None or solution is not None:
        return None
    name = getattr(factory, "__name__", "")
    if name not in _FLAT_LS:
        return None
    gamma, Lf = kwargs.get("gamma"), kwargs.get("Lf")
    if name == "make_drls_iteration":
        return _match_flat_drls(kwargs, tol=tol, maxit=maxit,
                                check_every=check_every or 1)
    panocplus = name == "make_panocplus_iteration"
    adaptive = kwargs.get("adaptive")
    if adaptive is None:
        # the factory's rule: gamma from Lf first, then adaptive when no
        # gamma is left
        adaptive = gamma is None and Lf is None
    adaptive = bool(adaptive)
    if not panocplus and not adaptive and gamma is None and Lf is None:
        # adaptive=False with no step: the driver runs a FIXED gamma at
        # the initial Lipschitz estimate, which only the generic driver does
        return None
    if adaptive and "backtrack_limit" in kwargs:
        # a gamma search the caller cut short commits steps that may not
        # be accepted; the flat machines always search to acceptance
        return None
    x0 = kwargs.get("x0")
    f, g = kwargs.get("f"), kwargs.get("g")
    if x0 is None or f is None or g is None:
        return None
    x0 = torch.as_tensor(x0)
    if x0.dim() != 2:
        return None
    B = x0.shape[0]
    if not _lanes_ok((f, g), B):
        return None
    directions = _directions(kwargs)
    if directions is None:
        return None

    # the operator: None -> identity; a (B, m, n) tensor or a
    # MatrixOperator holding one -> stacked products; a Shared operator or
    # an (m, n) tensor -> one product shared by the lanes; else out
    from ..ops.linops import IdentityOperator, MatrixOperator, as_linop
    from ..utils.shared import Shared

    A = kwargs.get("A")
    if A is None:
        Aop = IdentityOperator()
    elif isinstance(A, Shared):
        inner = as_linop(A).value
        if not hasattr(inner, "matvec"):
            return None
        Aop = Shared(inner)
    else:
        arr = A.A if isinstance(A, MatrixOperator) else A
        if not isinstance(arr, torch.Tensor):
            return None
        if arr.dim() == 2:
            # a 2-D matrix is lane-invariant (a lane's A is 2-D here)
            Aop = Shared(MatrixOperator(arr))
        elif arr.dim() == 3 and arr.shape[0] == B:
            Aop = MatrixOperator(arr)
        else:
            return None

    alpha = float(kwargs.get("alpha", 0.95))
    beta = float(kwargs.get("beta", 0.5))
    # the factory's gamma = alpha / Lf, per lane, in x0's real dtype
    R = real_dtype_of(x0)
    if gamma is not None:
        gamma_v = torch.as_tensor(gamma, dtype=R, device=x0.device).expand(B)
    elif Lf is not None:
        gamma_v = torch.as_tensor(alpha, dtype=R, device=x0.device) / (
            torch.as_tensor(Lf, dtype=R, device=x0.device).expand(B))
    else:
        gamma_v = None  # PANOCplus only: estimated per lane in the run

    from .. import parallel as _par

    runner = getattr(_par, _FLAT_LS[name])
    max_backtracks = int(kwargs.get("max_backtracks", 20))
    extra = {}
    if panocplus:
        extra = dict(adaptive=adaptive or gamma_v is None,
                     minimum_gamma=float(kwargs.get("minimum_gamma", 1e-7)))
    elif adaptive:
        extra = dict(adaptive=True,
                     minimum_gamma=float(kwargs.get("minimum_gamma", 1e-7)))
        if gamma_v is None:
            # the driver's cold start: a per-lane Lipschitz lower bound
            extra["estimate_gamma"] = True
            gamma_v = torch.ones(B, dtype=R, device=x0.device)

    if check_every is None:
        check_every = 8 if (name == "make_panoc_iteration"
                            and extra.get("adaptive")) else 1
    return lambda: runner(
        f, Aop, g, x0, gamma_v, tol, maxit=maxit, alpha=alpha, beta=beta,
        max_backtracks=max_backtracks, directions=directions,
        check_every=int(check_every), **extra)


def _match_flat_drls(kwargs, *, tol, maxit, check_every=1):
    """The DRLS leg of :func:`match_flat_linesearch` (no operator; f has a
    prox; gamma and c per lane by the factory's own helpers,
    ``drls.jl:11-22``).  Of the operands in row stripes it takes only a
    ``Shared`` f that is a least squares with its prox
    (``RowShardedLeastSquares``: its prox sums over tp, three all-reduces
    where A is wide, one where it is tall); any other stripes decline,
    since DRLS needs ``prox_f``."""
    from ..parallel.sharded_ops import RowShardedLeastSquares
    from ..utils.shared import Shared

    x0, f, g = kwargs.get("x0"), kwargs.get("f"), kwargs.get("g")
    if x0 is None or f is None or g is None:
        return None
    if holds_row_stripes({k: v for k, v in kwargs.items() if k != "f"}) or (
            holds_row_stripes(f) and not (
                isinstance(f, Shared)
                and isinstance(f.value, RowShardedLeastSquares))):
        return None
    x0 = torch.as_tensor(x0)
    if x0.dim() != 2:
        return None
    B = x0.shape[0]
    if not _lanes_ok((f, g), B):
        return None
    directions = _directions(kwargs)
    if directions is None:
        return None

    mf = kwargs.get("mf")
    if mf is not None and torch.as_tensor(mf).dim() != 0:
        return None  # per-lane strong convexity: the generic driver
    mf = None if mf is None else float(mf)
    gamma, Lf, c = kwargs.get("gamma"), kwargs.get("Lf"), kwargs.get("c")
    if gamma is None and Lf is None and (mf is None or mf <= 0):
        return None
    alpha = float(kwargs.get("alpha", 0.95))
    beta = float(kwargs.get("beta", 0.5))
    lam = kwargs.get("lambda_")
    if lam is None:
        lam = kwargs.get("lam", 1.0)

    R, dev = real_dtype_of(x0), x0.device

    def vec(v):
        return torch.as_tensor(v, dtype=R, device=dev).expand(B)

    lam_v = vec(lam)
    # the factory's helpers, so that the formulas cannot drift
    from ..algorithms.drls import drls_C, drls_default_gamma

    needs_lf = Lf is None and (mf is None or mf <= 0)
    Lf_v = None if Lf is None else vec(Lf)
    if gamma is None:
        if needs_lf:
            return None  # the factory could not derive gamma without Lf
        gamma_v = vec(drls_default_gamma(f, mf, Lf_v, alpha, lam_v))
    else:
        gamma_v = vec(gamma)
    if c is None:
        if needs_lf:
            return None  # the factory could not derive c without Lf
        c_v = beta * drls_C(f, mf, Lf_v, gamma_v, lam_v)
    else:
        c_v = vec(c)
    dre_sign = 1 if (mf is None or mf <= 0) else -1
    max_backtracks = int(kwargs.get("max_backtracks", 20))

    from .. import parallel as _par

    return lambda: _par.batched_drls(
        f, g, x0, gamma_v, lam_v, c_v, tol, maxit=maxit,
        max_backtracks=max_backtracks, directions=directions,
        dre_sign=dre_sign, check_every=int(check_every))
