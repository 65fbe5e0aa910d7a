"""Scenario batching: many problem instances advanced in lockstep
(counterpart of the generic driver and ``BatchedAlgorithm`` of
``proxtpu/parallel/batch.py``).

A batched iteration is one iteration object whose tensors carry a leading
batch axis (what a factory returns when called with stacked problem data).
``torch.func.vmap`` maps its ``init``, ``step`` and stopping criterion over
the lanes.  Converged lanes freeze (a ``torch.where`` select: inside the
mapped functions no tensor may steer Python control flow), and per-lane
iteration counts are returned: exactly what running each problem alone
would give.
"""

from __future__ import annotations

import inspect
import math

import torch

from ..utils.host_loop import run_host_loop
from ..utils.shared import unwrap_shared
from ..utils.tree import flatten, tree_leaves, tree_map


def _lane_axes(leaves, spec, B):
    """``in_dims`` of the iteration's tensors: 0 for a tensor with the
    batch axis; None for one under a ``Shared`` marker, a rank-0
    hyperparameter, or a tensor whose leading dim is not B (lane-invariant,
    as ``broadcast_hyperparams`` wraps it in the JAX package)."""
    return [None if (shared or l.dim() == 0 or l.shape[0] != B) else 0
            for l, shared in zip(leaves, spec.shared)]


def _batch_size(iteration):
    x0 = getattr(iteration, "x0", None)
    leaves = tree_leaves(x0) if x0 is not None else []
    if not leaves or leaves[0].dim() == 0:
        leaves = [l for l in flatten(iteration)[0] if l.dim() > 0]
    return leaves[0].shape[0]


def _lane_finite(state, B):
    """(B,) bool: every floating leaf of the lane's state is finite."""
    ok = torch.ones(B, dtype=torch.bool, device=tree_leaves(state)[0].device)
    for leaf in tree_leaves(state):
        if leaf.is_floating_point() or leaf.is_complex():
            ok = ok & torch.isfinite(leaf).reshape(B, -1).all(dim=1)
    return ok


def _freeze(done, old, new):
    """Per-lane select: lanes with done=True keep their old state."""
    return tree_map(
        lambda o, n: torch.where(
            done.reshape(done.shape + (1,) * (n.dim() - 1)), o, n),
        old, new)


def batched_run_loop(iteration, maxit, tol, stop=None, solution=None,
                     check_every=1, verbose=False, freq=100,
                     halt_nonfinite=False):
    """Run a batched iteration until every lane converges or ``maxit``.

    Returns ``(solutions, iters, done)``: ``iters[i]`` is the iteration at
    which lane i converged (the ``maxit`` cap applies), the single-problem
    driver's count.  ``check_every=K`` runs K steps between the host's
    all-done tests; every step is masked on the per-lane ``done`` flags,
    so counts and solutions do not depend on K (the JAX package's exact
    masked K-block): K sets only how often the host waits on the device.
    ``verbose`` prints the converged-lane count every ``freq`` iterations.
    ``halt_nonfinite``: a lane whose state turns non-finite is frozen at
    its last finite iterate, reported ``done=False`` with the iteration it
    died at, and no longer holds the batch to ``maxit``."""
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    stop = stop or (lambda it, tol, s: it.default_stopping_criterion(tol, s))
    solution = solution or (lambda it, s: it.default_solution(s))
    B = _batch_size(iteration)
    leaves, spec = flatten(iteration)
    axes = _lane_axes(leaves, spec, B)

    def lane(fn):
        return lambda lv, *args: fn(unwrap_shared(spec.unflatten(lv)), *args)

    vinit = torch.func.vmap(lane(lambda it: it.init()), in_dims=(axes,))
    vstep = torch.func.vmap(lane(lambda it, s: it.step(s)),
                            in_dims=(axes, 0))
    vstop = torch.func.vmap(lane(lambda it, s: stop(it, tol, s)),
                            in_dims=(axes, 0))
    vsol = torch.func.vmap(lane(solution), in_dims=(axes, 0))

    def body(k, carry):
        state, done, dead, iters = carry
        frozen = done | dead
        new = _freeze(frozen, state, vstep(leaves, state))
        if halt_nonfinite:
            # a lane that turned non-finite dies and rolls back to its last
            # finite state
            newly_dead = ~frozen & ~_lane_finite(new, B)
            dead = dead | newly_dead
            new = _freeze(newly_dead, state, new)
        iters = torch.where(frozen, iters, k)
        done = done | (vstop(leaves, new) & ~dead)
        if verbose and k % freq == 0:
            print(f"{k:6d} | {int(done.sum()):6d}/{B} lanes converged")
        return new, done, dead, iters

    state = vinit(leaves)
    done = vstop(leaves, state)
    dead = torch.zeros_like(done)
    if halt_nonfinite:
        dead = ~_lane_finite(state, B)
    iters = torch.ones(B, dtype=torch.int32, device=done.device)
    (state, done, dead, iters), k = run_host_loop(
        body, (state, done, dead, iters), lambda c: c[1] | c[2], maxit,
        check_every=check_every)
    iters = torch.clamp(torch.where(done | dead, iters, k), max=maxit)
    return vsol(leaves, state), iters, done


def _default_backtrack_limit(kwargs):
    """Trip budget of the masked step search: enough halvings to reach
    acceptance or the ``minimum_gamma`` floor, ``ceil(log2(gamma0 /
    minimum_gamma))`` + 4, and never below 32 (as the JAX package)."""
    min_g = float(kwargs.get("minimum_gamma") or 1e-7)
    g0 = None
    if kwargs.get("gamma") is not None:
        g0 = float(torch.as_tensor(kwargs["gamma"]).max())
    elif kwargs.get("Lf") is not None:
        g0 = 1.0 / float(torch.as_tensor(kwargs["Lf"]).min())
    if g0 is None or g0 <= 0 or min_g <= 0:
        return 32
    return max(32, int(math.ceil(math.log2(max(g0 / min_g, 1.0)))) + 4)


class BatchedAlgorithm:
    """Batched counterpart of
    :class:`~proxtpu_torch.algorithms.core.IterativeAlgorithm`.

    Construct from an iteration factory, call with stacked problem kwargs
    (leading batch axis on every tensor)::

        solver = BatchedAlgorithm(make_fast_forward_backward_iteration,
                                  maxit=1000, tol=1e-6)
        xs, iters, done = solver(x0=X0, f=LeastSquaresLoss(A, b),
                                 g=NormL1(lam), Lf=Lfs)

    ``use_kernels="auto"`` (default) routes the shapes that
    :func:`~proxtpu_torch.kernels.dispatch.match_kernel_solver` and
    :func:`~proxtpu_torch.kernels.dispatch.match_tv_solver` recognise
    (batched lasso FISTA, batched box-QP projected gradient, batched TV
    denoising by Chambolle-Pock, options at their defaults) to the kernel
    solvers; then adaptive FB / FISTA
    (:func:`~proxtpu_torch.kernels.dispatch.match_flat_adaptive`) and
    PANOC, ZeroFPR, PANOCplus, DRLS
    (:func:`~proxtpu_torch.kernels.dispatch.match_flat_linesearch`) to the
    flat trial/commit machines; anything else runs the generic driver,
    :func:`batched_run_loop`.  ``use_kernels=False`` forces the generic
    driver.  ``verbose`` and ``halt_nonfinite`` also force it (the other
    routes have neither)."""

    def __init__(self, iteration_factory, *, maxit, tol, stop=None,
                 solution=None, use_kernels="auto", check_every=None,
                 verbose=False, freq=100, halt_nonfinite=False, **kwargs):
        self.iteration_factory = iteration_factory
        self.maxit = maxit
        self.tol = tol
        self.stop = stop
        self.solution = solution
        self.use_kernels = use_kernels
        # steps between the generic driver's all-done tests; blocking is
        # exact (masked), None = 8 as in the JAX package
        self.check_every = check_every
        self.verbose = verbose
        self.freq = freq
        self.halt_nonfinite = halt_nonfinite
        self.kwargs = kwargs

    def _inject_backtrack_limit(self, merged):
        """Default ``backtrack_limit`` in ``merged`` (in place) where the
        factory takes one and the caller did not set it: under vmap the
        step search must be the masked loop with a fixed number of
        trips."""
        if "backtrack_limit" not in merged:
            params = inspect.signature(self.iteration_factory).parameters
            if "backtrack_limit" in params:
                merged["backtrack_limit"] = _default_backtrack_limit(merged)

    def __call__(self, **kwargs):
        merged = {**self.kwargs, **kwargs}
        # a kwarg the factory does not take must not be dropped by a
        # structural matcher: skip the kernel routes so that the factory
        # raises its own TypeError
        params = inspect.signature(self.iteration_factory).parameters
        has_var_kw = any(p.kind is inspect.Parameter.VAR_KEYWORD
                         for p in params.values())
        unknown = not has_var_kw and any(k not in params for k in merged)
        if (self.use_kernels and not unknown and not self.verbose
                and not self.halt_nonfinite):
            from ..kernels.dispatch import (
                match_flat_adaptive,
                match_flat_linesearch,
                match_kernel_solver,
                match_tv_solver,
            )

            for match, extra in (
                    (match_kernel_solver, {}), (match_tv_solver, {}),
                    # the flat machines' counts do not depend on the block
                    # of trips between host tests; 8 for the adaptive
                    # FB / FISTA machine, the matcher's choice otherwise
                    (match_flat_adaptive,
                     dict(check_every=self.check_every or 8)),
                    (match_flat_linesearch,
                     dict(check_every=self.check_every))):
                run = match(
                    self.iteration_factory, merged, tol=self.tol,
                    maxit=self.maxit, stop=self.stop, solution=self.solution,
                    **extra)
                if run is not None:
                    return run()
        # injected after the match, so that a matcher sees backtrack_limit
        # only when the caller set it
        self._inject_backtrack_limit(merged)
        iteration = self.iteration_factory(**merged)
        return batched_run_loop(
            iteration, self.maxit, self.tol, stop=self.stop,
            solution=self.solution, check_every=self.check_every or 8,
            verbose=self.verbose, freq=self.freq,
            halt_nonfinite=self.halt_nonfinite)
