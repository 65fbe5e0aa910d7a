"""ZeroFPR: quasi-Newton line search on the fixed-point residual
(counterpart of ``proxtpu/algorithms/zerofpr.py``).

    minimize f(Ax) + g(x),   f smooth (nonconvex allowed), A linear.

A forward-backward step to ``xbar``, an L-BFGS direction on the residual
at ``xbar``, and a tau line search on the FBE from ``xbar``
(``x = xbar + tau d``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..accel.lbfgs import LBFGS
from ..ops.linops import as_linop
from ..prox.base import Zero, prox, proxclass, value_and_gradient
from ..utils.fb_tools import backtrack_stepsize, f_model
from ..utils.loops import bounded_while
from ..utils.tree import (
    eps_of,
    tree_inf_norm,
    tree_map,
    tree_norm_sq,
    tree_sub,
    tree_where,
)
from .common import astree, ls_scalars
from .core import IterativeAlgorithm
from .fbs_common import (
    forward_backward_init,
    next_direction,
    reset_direction_if,
    update_direction,
)
from .panoc import ls_display


class ZeroFPRState(NamedTuple):
    x: object
    Ax: object
    f_Ax: torch.Tensor
    grad_f_Ax: object
    At_grad_f_Ax: object
    gamma: torch.Tensor
    y: object
    xbar: object
    g_xbar: torch.Tensor
    res: object
    dstate: object
    tau: torch.Tensor
    xbar_prev: object
    res_xbar_prev: object
    is_prev_set: torch.Tensor


class _Trial(NamedTuple):
    x: object
    Ax: object
    f_Ax: torch.Tensor
    grad_f_Ax: object
    At_grad_f_Ax: object
    y: object
    xbar: object
    g_xbar: torch.Tensor
    res: object
    FBE: torch.Tensor


@proxclass(meta_fields=("adaptive", "max_backtracks", "directions", "backtrack_limit"))
class ZeroFPRIteration:
    f: object
    A: object
    g: object
    x0: object
    alpha: object
    beta: object
    gamma: object
    minimum_gamma: object
    adaptive: bool
    max_backtracks: int
    directions: object
    backtrack_limit: object = None  # None: searches on the host; int: masked

    def init(self):
        x, Ax, f_Ax, grad, At_grad, gamma, y, xbar, g_xbar, res = \
            forward_backward_init(self.f, self.A, self.g, self.x0,
                                  self.gamma, self.alpha)
        return ZeroFPRState(
            x, Ax, f_Ax, grad, At_grad, gamma, y, xbar, g_xbar, res,
            self.directions.init_state(x), torch.zeros_like(gamma), xbar,
            res, torch.zeros((), dtype=torch.bool, device=gamma.device))

    def step(self, s):
        eps = eps_of(s.x)

        if self.adaptive:
            bt = backtrack_stepsize(
                s.gamma, self.f, self.A, self.g, s.x, s.f_Ax, s.At_grad_f_Ax,
                s.y, s.xbar, s.g_xbar, s.res, alpha=self.alpha,
                minimum_gamma=self.minimum_gamma,
                max_backtracks=self.backtrack_limit)
            gamma, g_xbar, xbar, res = bt.gamma, bt.g_z, bt.z, bt.res
            Axbar, grad_f_Axbar, f_Axbar_upp = bt.Az, bt.grad_f_Az, \
                bt.f_Az_upp
            dstate = reset_direction_if(self.directions, s.dstate,
                                        gamma != s.gamma)
        else:
            gamma, g_xbar, xbar, res = s.gamma, s.g_xbar, s.xbar, s.res
            Axbar = self.A.matvec(xbar)
            _, grad_f_Axbar = value_and_gradient(self.f, Axbar)
            f_Axbar_upp = f_model(s.f_Ax, s.At_grad_f_Ax, res,
                                  self.alpha / gamma)
            dstate = s.dstate

        FBE_x = f_Axbar_upp + g_xbar

        # the residual at xbar
        At_grad_f_Axbar = self.A.rmatvec(grad_f_Axbar)
        y2 = tree_map(lambda xl, gl: xl - gamma * gl, xbar, At_grad_f_Axbar)
        xbarbar, _ = prox(self.g, y2, gamma)
        res_xbar = tree_sub(xbar, xbarbar)

        # the metric's update deferred to the xbar / res_xbar differences
        dstate_upd = update_direction(
            self.directions, dstate, tree_sub(xbar, s.xbar_prev),
            tree_sub(res_xbar, s.res_xbar_prev))
        dstate = tree_where(s.is_prev_set, dstate_upd, dstate)

        d = next_direction(self.directions, dstate, res_xbar, res)

        Ad = self.A.matvec(d)
        sigma = self.beta * (0.5 / gamma) * (1 - self.alpha)
        tol = 10 * eps * (1 + torch.abs(FBE_x))
        threshold = FBE_x - sigma * tree_norm_sq(res) + tol

        def trial(tau):
            x = tree_map(lambda bl, dl: bl + tau * dl, xbar, d)
            Ax = tree_map(lambda bl, dl: bl + tau * dl, Axbar, Ad)
            f_Ax, grad_f_Ax = value_and_gradient(self.f, Ax)
            At_grad_f_Ax = self.A.rmatvec(grad_f_Ax)
            y = tree_map(lambda xl, gl: xl - gamma * gl, x, At_grad_f_Ax)
            xb, g_xb = prox(self.g, y, gamma)
            r = tree_sub(x, xb)
            FBE = f_model(f_Ax, At_grad_f_Ax, r, self.alpha / gamma) + g_xb
            return _Trial(x, Ax, f_Ax, grad_f_Ax, At_grad_f_Ax, y, xb, g_xb,
                          r, FBE)

        def cond(c):
            k, _, t = c
            return (t.FBE > threshold) & (k < self.max_backtracks)

        def body(c):
            k, tau, _ = c
            tau = torch.where(k >= self.max_backtracks - 1,
                              torch.zeros_like(tau), tau / 2)
            return (k + 1, tau, trial(tau))

        one = torch.ones_like(gamma)
        _, tau, t = bounded_while(
            cond, body,
            (torch.ones((), dtype=torch.int32, device=gamma.device), one,
             trial(one)),
            None if self.backtrack_limit is None else self.max_backtracks)

        return ZeroFPRState(
            t.x, t.Ax, t.f_Ax, t.grad_f_Ax, t.At_grad_f_Ax, gamma, t.y,
            t.xbar, t.g_xbar, t.res, dstate, tau, xbar, res_xbar,
            torch.ones((), dtype=torch.bool, device=gamma.device))

    def default_stopping_criterion(self, tol, s):
        return tree_inf_norm(s.res) / s.gamma <= tol

    def default_solution(self, s):
        return s.xbar

    def default_display(self, k, s):
        ls_display(k, s)


def make_zerofpr_iteration(*, x0, f=Zero(), A=None, g=Zero(), alpha=0.95,
                           beta=0.5, Lf=None, gamma=None, adaptive=None,
                           minimum_gamma=1e-7, max_backtracks=20,
                           backtrack_limit=None, directions=LBFGS(5)):
    x0 = astree(x0)
    kw = ls_scalars(x0, alpha, beta, Lf, gamma, adaptive, minimum_gamma,
                    max_backtracks, backtrack_limit)
    return ZeroFPRIteration(f=f, A=as_linop(A), g=g, x0=x0,
                            directions=directions, **kw)


def ZeroFPR(*, maxit=1_000, tol=1e-8, stop=None, solution=None,
            verbose=False, freq=10, display=None, **kwargs):
    """ZeroFPR solver: quasi-Newton steps on the fixed-point residual with
    an FBE line search."""
    return IterativeAlgorithm(
        make_zerofpr_iteration, maxit=maxit, tol=tol, stop=stop,
        solution=solution, verbose=verbose, freq=freq, display=display,
        **kwargs)
