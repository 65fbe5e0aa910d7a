"""Forward-backward splitting (proximal gradient) with a fixed or adaptive
step (counterpart of ``proxtpu/algorithms/forward_backward.py``).

    minimize f(x) + g(x),   f smooth.

One ``value_and_gradient`` and one ``prox`` per iteration, with optional
Armijo backtracking; stopping criterion ``||res||_inf / gamma <= tol``.
"""

from __future__ import annotations

from typing import NamedTuple

from ..ops.linops import IdentityOperator
from ..prox.base import Zero, prox, proxclass, value_and_gradient
from ..utils.fb_tools import backtrack_stepsize, \
    lower_bound_smoothness_constant
from ..utils.tree import tree_inf_norm, tree_leaves, tree_map, tree_sub
from .common import astree, real_dtype, rscalar
from .core import IterativeAlgorithm


class ForwardBackwardState(NamedTuple):
    x: object
    f_x: object
    grad_f_x: object
    gamma: object
    y: object
    z: object
    g_z: object
    res: object


def _display(k, s):
    crit = tree_inf_norm(s.res) / s.gamma
    print(f"{k:5d} | {float(s.gamma):.3e} | {float(crit):.3e}")


@proxclass(meta_fields=("adaptive", "backtrack_limit"))
class ForwardBackwardIteration:
    f: object
    g: object
    x0: object
    gamma: object
    minimum_gamma: object
    reduce_gamma: object
    increase_gamma: object
    adaptive: bool
    backtrack_limit: object = None  # None: search on the host; int: masked

    def init(self):
        x = self.x0
        f_x, grad_f_x = value_and_gradient(self.f, x)
        if self.gamma is None:
            gamma = 1 / lower_bound_smoothness_constant(
                self.f, IdentityOperator(), x, grad_f_x)
        else:
            gamma = self.gamma
        y = tree_map(lambda xl, gl: xl - gamma * gl, x, grad_f_x)
        z, g_z = prox(self.g, y, gamma)
        return ForwardBackwardState(x, f_x, grad_f_x, gamma, y, z, g_z,
                                    tree_sub(x, z))

    def step(self, s):
        if self.adaptive:
            bt = backtrack_stepsize(
                s.gamma * self.increase_gamma, self.f, IdentityOperator(),
                self.g, s.x, s.f_x, s.grad_f_x, s.y, s.z, s.g_z, s.res,
                minimum_gamma=self.minimum_gamma,
                reduce_gamma=self.reduce_gamma,
                max_backtracks=self.backtrack_limit)
            x, f_x, grad_f_x, gamma = bt.z, bt.f_Az, bt.grad_f_Az, bt.gamma
        else:
            x = s.z
            f_x, grad_f_x = value_and_gradient(self.f, x)
            gamma = s.gamma
        y = tree_map(lambda xl, gl: xl - gamma * gl, x, grad_f_x)
        z, g_z = prox(self.g, y, gamma)
        return ForwardBackwardState(x, f_x, grad_f_x, gamma, y, z, g_z,
                                    tree_sub(x, z))

    def default_stopping_criterion(self, tol, s):
        return tree_inf_norm(s.res) / s.gamma <= tol

    def default_solution(self, s):
        return s.z

    def default_display(self, k, s):
        _display(k, s)


def make_forward_backward_iteration(*, x0, f=Zero(), g=Zero(), Lf=None,
                                    gamma=None, adaptive=None,
                                    minimum_gamma=1e-7, reduce_gamma=0.5,
                                    increase_gamma=1.0,
                                    backtrack_limit=None):
    x0 = astree(x0)
    R = real_dtype(x0)
    dev = tree_leaves(x0)[0].device
    if gamma is None and Lf is not None:
        gamma = 1 / rscalar(Lf, R, dev)
    if adaptive is None:
        adaptive = gamma is None
    return ForwardBackwardIteration(
        f=f, g=g, x0=x0, gamma=rscalar(gamma, R, dev),
        minimum_gamma=rscalar(minimum_gamma, R, dev),
        reduce_gamma=rscalar(reduce_gamma, R, dev),
        increase_gamma=rscalar(increase_gamma, R, dev),
        adaptive=bool(adaptive),
        backtrack_limit=(None if backtrack_limit is None
                         else int(backtrack_limit)))


def ForwardBackward(*, maxit=10_000, tol=1e-8, stop=None, solution=None,
                    verbose=False, freq=100, display=None, **kwargs):
    """The forward-backward solver (two-stage kwargs use)."""
    return IterativeAlgorithm(
        make_forward_backward_iteration, maxit=maxit, tol=tol, stop=stop,
        solution=solution, verbose=verbose, freq=freq, display=display,
        **kwargs)


ProximalGradientIteration = ForwardBackwardIteration
ProximalGradient = ForwardBackward
