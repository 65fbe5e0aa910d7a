"""Precision warm start: solve cheaply in float32, polish to tolerance in
float64 (counterpart of ``proxtpu/parallel/warm.py``).

Stage 1 runs the batched solve in float32 to a tolerance float32 can reach
(``warm_tol``, default 1.2e-5); stage 2 runs the SAME algorithm in the
request dtype from the warm iterate and polishes to ``tol``.  Stage 2 is an
ordinary fresh solve: its momentum and line-search state start from
scratch.  The final stopping test is stage 2's, in the request dtype, so
the answer meets the same criterion as a cold solve at the same tolerance.

On the card, stage 1 of a stacked-A lasso by FISTA goes through
``match_kernel_solver`` to the float32 kernels (``fb_step``,
``fista_step``); the float64 polish takes the plain routes.  Nothing falls
back silently: a kernel that fails fails the solve.
"""

from __future__ import annotations

import torch

from ..utils.tree import flatten, tree_map
from .batch import BatchedAlgorithm

__all__ = ["cast_problem", "WarmStartedAlgorithm",
           "WarmStartedBatchedAlgorithm"]


def cast_problem(tree, dtype=torch.float32):
    """Cast every floating and complex tensor of a problem tree to the
    narrow dtype (float -> ``dtype``, complex -> its complex counterpart).

    Integer and boolean tensors (index arrays, flags) and every value that
    is not a tensor pass through untouched; ``Shared`` markers stay, so a
    shared operand is cast in place and keeps its lane-invariant marking."""
    complex_dtype = (torch.complex64 if dtype == torch.float32
                     else torch.complex128)

    def cast(leaf):
        if leaf.is_complex():
            return leaf.to(complex_dtype)
        if leaf.is_floating_point():
            return leaf.to(dtype)
        return leaf

    leaves, spec = flatten(tree)
    return spec.unflatten([cast(l) for l in leaves])


class WarmStartedBatchedAlgorithm:
    """Two-stage batched solver: a float32 warm start, a polish in the
    request dtype.

    The construction and call contract of :class:`BatchedAlgorithm`::

        solver = WarmStartedBatchedAlgorithm(
            make_fast_forward_backward_iteration,
            maxit=20000, tol=1e-6, warm_tol=1e-4)
        xs, iters, done = solver(x0=x0_f64, f=Shared(f), g=g, Lf=Lf)

    Stage 1 solves ``cast_problem(kwargs, float32)`` to ``warm_tol``
    (bounded by ``warm_maxit``; lanes that reach it enter stage 2 from
    wherever they got); stage 2 solves the original-dtype problem from the
    stage-1 solution as ``x0``.  ``iters`` is each lane's total over both
    stages; ``done`` is stage 2's.  The stage-1 solution must have the
    shape of ``x0`` (true of the forward-backward family, whose default
    solution is the iterate itself).  A lane whose stage-1 solution is not
    finite (an overflowed cast, a diverged float32 solve) starts stage 2
    from the cold ``x0``: correctness never depends on the warm stage.
    """

    def __init__(self, iteration_factory, *, maxit, tol, warm_tol=1.2e-5,
                 warm_maxit=None, warm_dtype=torch.float32, stop=None,
                 solution=None, use_kernels=True, check_every=None,
                 verbose=False, freq=100, **kwargs):
        self.warm = BatchedAlgorithm(
            iteration_factory,
            maxit=maxit if warm_maxit is None else warm_maxit,
            tol=warm_tol, stop=stop, solution=solution,
            use_kernels=use_kernels, check_every=check_every,
            verbose=verbose, freq=freq, **cast_problem(kwargs, warm_dtype))
        self.polish = BatchedAlgorithm(
            iteration_factory, maxit=maxit, tol=tol, stop=stop,
            solution=solution, use_kernels=use_kernels,
            check_every=check_every, verbose=verbose, freq=freq, **kwargs)
        self.warm_dtype = warm_dtype

    def __call__(self, x0, **kwargs):
        xs_warm, it1, _done1 = self.warm(
            x0=cast_problem(x0, self.warm_dtype),
            **cast_problem(kwargs, self.warm_dtype))

        # the warm solution leaf by leaf in x0's dtypes, each lane whose
        # warm solution is not finite replaced by the cold x0
        def take_warm(w, o):
            o = torch.as_tensor(o)
            w = w.to(o.dtype)
            ok = torch.isfinite(w.reshape(w.shape[0], -1)).all(dim=1)
            ok = ok.reshape(ok.shape + (1,) * (w.dim() - 1))
            return torch.where(ok, w, o.expand(w.shape))

        x1 = tree_map(take_warm, xs_warm, x0)
        xs, it2, done = self.polish(x0=x1, **kwargs)
        return xs, it1 + it2, done


class WarmStartedAlgorithm:
    """Single-problem counterpart of :class:`WarmStartedBatchedAlgorithm`:
    a float32 warm stage, a polish in the request dtype, the same stopping
    test.

    Takes the solver FACTORY (``pt.ZeroFPR``, ``pt.FastForwardBackward``,
    ...) and the driver's options::

        solver = WarmStartedAlgorithm(pt.ZeroFPR, maxit=5000, tol=1e-6)
        x, it = solver(x0=x0_f64, f=f, g=g, Lf=Lf)

    The count returned is the two stages' total; the solution must have the
    shape of ``x0``."""

    def __init__(self, solver_factory, *, maxit, tol, warm_tol=1.2e-5,
                 warm_maxit=None, warm_dtype=torch.float32, **opts):
        # problem kwargs given at construction reach the warm stage
        # narrowed too; cast_problem leaves options that are not tensors
        # untouched
        self.warm = solver_factory(
            maxit=maxit if warm_maxit is None else warm_maxit,
            tol=warm_tol, **cast_problem(opts, warm_dtype))
        self.polish = solver_factory(maxit=maxit, tol=tol, **opts)
        self.warm_dtype = warm_dtype

    def __call__(self, x0, **problem):
        xw, it1 = self.warm(x0=cast_problem(x0, self.warm_dtype),
                            **cast_problem(problem, self.warm_dtype))
        x1 = tree_map(lambda w, o: w.to(torch.as_tensor(o).dtype), xw, x0)
        x, it2 = self.polish(x0=x1, **problem)
        return x, it1 + it2
