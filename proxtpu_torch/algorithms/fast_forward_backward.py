"""Accelerated forward-backward splitting, FISTA (counterpart of
``proxtpu/algorithms/fast_forward_backward.py``).

    minimize f(x) + g(x),   f convex smooth.

The FB step plus the extrapolation ``x = z + beta (z - z_prev)`` with a
pluggable coefficient sequence; the default is the stepsize-fed
``AdaptiveNesterovSequence(mf)``.
"""

from __future__ import annotations

from typing import NamedTuple

from ..accel.nesterov import AdaptiveNesterovSequence
from ..ops.linops import IdentityOperator
from ..prox.base import Zero, prox, proxclass, value_and_gradient
from ..utils.fb_tools import backtrack_stepsize, \
    lower_bound_smoothness_constant
from ..utils.tree import tree_inf_norm, tree_leaves, tree_map, tree_sub, \
    tree_vdot_real
from .common import astree, real_dtype, rscalar
from .core import IterativeAlgorithm
from .forward_backward import _display


class FastForwardBackwardState(NamedTuple):
    x: object
    f_x: object
    grad_f_x: object
    gamma: object
    y: object
    z: object
    g_z: object
    res: object
    z_prev: object
    seq_state: object


@proxclass(meta_fields=("adaptive", "extrapolation", "backtrack_limit"))
class FastForwardBackwardIteration:
    f: object
    g: object
    x0: object
    gamma: object
    minimum_gamma: object
    reduce_gamma: object
    increase_gamma: object
    adaptive: bool
    extrapolation: object  # the coefficient sequence
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
        return FastForwardBackwardState(
            x, f_x, grad_f_x, gamma, y, z, g_z, tree_sub(x, z), x,
            self.extrapolation.init_state(x))

    def step(self, s):
        if self.adaptive:
            bt = backtrack_stepsize(
                s.gamma * self.increase_gamma, self.f, IdentityOperator(),
                self.g, s.x, s.f_x, s.grad_f_x, s.y, s.z, s.g_z, s.res,
                minimum_gamma=self.minimum_gamma,
                reduce_gamma=self.reduce_gamma,
                max_backtracks=self.backtrack_limit)
            gamma, z = bt.gamma, bt.z
        else:
            gamma, z = s.gamma, s.z

        if getattr(self.extrapolation, "restart_aware", False):
            # O'Donoghue-Candès signal: the momentum points against the
            # gradient mapping -> reset the sequence
            rs = tree_vdot_real(tree_sub(s.x, z), tree_sub(z, s.z_prev))
            beta, seq_state = self.extrapolation.next_coeff(
                s.seq_state, gamma, restart=rs)
        else:
            beta, seq_state = self.extrapolation.next_coeff(s.seq_state,
                                                            gamma)
        x = tree_map(lambda zl, zp: zl + beta * (zl - zp), z, s.z_prev)
        z_prev = z

        f_x, grad_f_x = value_and_gradient(self.f, x)
        y = tree_map(lambda xl, gl: xl - gamma * gl, x, grad_f_x)
        z, g_z = prox(self.g, y, gamma)
        return FastForwardBackwardState(
            x, f_x, grad_f_x, gamma, y, z, g_z, tree_sub(x, z), z_prev,
            seq_state)

    def default_stopping_criterion(self, tol, s):
        return tree_inf_norm(s.res) / s.gamma <= tol

    def default_solution(self, s):
        return s.z

    def default_display(self, k, s):
        _display(k, s)


def make_fast_forward_backward_iteration(
        *, x0, f=Zero(), g=Zero(), mf=0.0, Lf=None, gamma=None,
        adaptive=None, minimum_gamma=1e-7, reduce_gamma=0.5,
        increase_gamma=1.0, extrapolation_sequence=None,
        backtrack_limit=None):
    x0 = astree(x0)
    R = real_dtype(x0)
    dev = tree_leaves(x0)[0].device
    if gamma is None and Lf is not None:
        gamma = 1 / rscalar(Lf, R, dev)
    if adaptive is None:
        adaptive = gamma is None
    extrapolation = (extrapolation_sequence
                     if extrapolation_sequence is not None
                     else AdaptiveNesterovSequence(float(mf)))
    return FastForwardBackwardIteration(
        f=f, g=g, x0=x0, gamma=rscalar(gamma, R, dev),
        minimum_gamma=rscalar(minimum_gamma, R, dev),
        reduce_gamma=rscalar(reduce_gamma, R, dev),
        increase_gamma=rscalar(increase_gamma, R, dev),
        adaptive=bool(adaptive), extrapolation=extrapolation,
        backtrack_limit=(None if backtrack_limit is None
                         else int(backtrack_limit)))


def FastForwardBackward(*, maxit=10_000, tol=1e-8, stop=None, solution=None,
                        verbose=False, freq=100, display=None, **kwargs):
    """The accelerated (FISTA) forward-backward solver with pluggable
    extrapolation sequences."""
    return IterativeAlgorithm(
        make_fast_forward_backward_iteration, maxit=maxit, tol=tol,
        stop=stop, solution=solution, verbose=verbose, freq=freq,
        display=display, **kwargs)


FastProximalGradientIteration = FastForwardBackwardIteration
FastProximalGradient = FastForwardBackward
