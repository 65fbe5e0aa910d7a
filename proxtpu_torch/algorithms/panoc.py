"""PANOC: proximal averaged Newton-type method with a line search on the
forward-backward envelope (counterpart of ``proxtpu/algorithms/panoc.py``).

    minimize f(Ax) + g(x),   f smooth, A linear.

The hybrid update ``x = tau (x + d) + (1 - tau) z`` is backtracked on the
sufficient decrease ``FBE <= FBE_x - sigma ||res||^2``, with an L-BFGS
direction by default and, when ``is_generalized_quadratic(f)``, the
quadratic interpolation of f along the segment (no matvec per trial).
``A z`` and the interpolation coefficients belong to the segment, not to a
trial: they are computed at the first trial that needs them and reused.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..accel.lbfgs import LBFGS
from ..ops.linops import as_linop
from ..prox.base import Zero, is_generalized_quadratic, prox, proxclass, \
    value_and_gradient
from ..utils.fb_tools import backtrack_stepsize, f_model
from ..utils.loops import bounded_while
from ..utils.tree import (
    eps_of,
    tree_add,
    tree_inf_norm,
    tree_lincomb,
    tree_map,
    tree_norm_sq,
    tree_sub,
    tree_vdot_real,
)
from .common import astree, ls_scalars
from .core import IterativeAlgorithm
from .fbs_common import (
    forward_backward_init,
    next_direction,
    reset_direction_if,
    update_direction,
)


class PANOCState(NamedTuple):
    x: object
    Ax: object
    f_Ax: torch.Tensor
    grad_f_Ax: object
    At_grad_f_Ax: object
    gamma: torch.Tensor
    y: object
    z: object
    g_z: torch.Tensor
    res: object
    dstate: object
    tau: torch.Tensor


class _TauCarry(NamedTuple):
    k: torch.Tensor
    tau: torch.Tensor
    x: object
    Ax: object
    f_Ax: torch.Tensor
    grad_f_Ax: object
    At_grad_f_Ax: object
    y: object
    z: object
    g_z: torch.Tensor
    res: object
    FBE_new: torch.Tensor


def ls_display(k, s):
    crit = tree_inf_norm(s.res) / s.gamma
    print(f"{k:5d} | {float(s.gamma):.3e} | {float(crit):.3e} | "
          f"{float(s.tau):.3e}")


@proxclass(meta_fields=("adaptive", "max_backtracks", "directions", "backtrack_limit"))
class PANOCIteration:
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
        x, Ax, f_Ax, grad, At_grad, gamma, y, z, g_z, res = \
            forward_backward_init(self.f, self.A, self.g, self.x0,
                                  self.gamma, self.alpha)
        return PANOCState(x, Ax, f_Ax, grad, At_grad, gamma, y, z, g_z, res,
                          self.directions.init_state(x),
                          torch.zeros_like(gamma))

    def step(self, s):
        eps = eps_of(s.x)
        quad = is_generalized_quadratic(self.f)

        # gamma backtracking (adaptive) or the quadratic model (fixed)
        if self.adaptive:
            bt = backtrack_stepsize(
                s.gamma, self.f, self.A, self.g, s.x, s.f_Ax, s.At_grad_f_Ax,
                s.y, s.z, s.g_z, s.res, alpha=self.alpha,
                minimum_gamma=self.minimum_gamma,
                max_backtracks=self.backtrack_limit)
            gamma, z, g_z, res = bt.gamma, bt.z, bt.g_z, bt.res
            f_Az_upp = bt.f_Az_upp
            dstate = reset_direction_if(self.directions, s.dstate,
                                        gamma != s.gamma)
        else:
            gamma, z, g_z, res = s.gamma, s.z, s.g_z, s.res
            f_Az_upp = f_model(s.f_Ax, s.At_grad_f_Ax, res,
                               self.alpha / gamma)
            dstate = s.dstate

        FBE_x = f_Az_upp + g_z

        # direction and the full trial step (one matvec pair)
        d = next_direction(self.directions, dstate, res, res)
        x_prev, res_prev = s.x, res
        Ad = self.A.matvec(d)
        x_d = tree_add(s.x, d)
        Ax_d = tree_add(s.Ax, Ad)
        f_Ax_d, grad_f_Ax_d = value_and_gradient(self.f, Ax_d)
        At_grad_f_Ax_d = self.A.rmatvec(grad_f_Ax_d)

        sigma = self.beta * (0.5 / gamma) * (1 - self.alpha)
        tol = 10 * eps * (1 + torch.abs(FBE_x))
        threshold = FBE_x - sigma * tree_norm_sq(res) + tol

        y1 = tree_map(lambda xl, gl: xl - gamma * gl, x_d, At_grad_f_Ax_d)
        z1, g_z1 = prox(self.g, y1, gamma)
        res1 = tree_sub(x_d, z1)
        FBE_new = f_model(f_Ax_d, At_grad_f_Ax_d, res1,
                          self.alpha / gamma) + g_z1

        # the segment's other end, z: A z and f there, once
        @functools.cache
        def seg_end():
            if self.adaptive:
                return bt.Az, bt.f_Az, bt.grad_f_Az
            Az = self.A.matvec(z)
            if not quad:
                return Az, None, None
            return (Az,) + tuple(value_and_gradient(self.f, Az))

        @functools.cache
        def interpolation():
            # f(A x(tau)) = a tau^2 + b tau + c along the segment
            Az, f_Az, grad_f_Az = seg_end()
            b = (tree_vdot_real(Ax_d, grad_f_Az)
                 - tree_vdot_real(Az, grad_f_Az))
            return self.A.rmatvec(grad_f_Az), f_Ax_d - b - f_Az, b, f_Az

        def cond(c):
            return (c.k <= self.max_backtracks) & (c.FBE_new > threshold)

        def body(c):
            Az, f_Az, grad_f_Az = seg_end()
            tau = torch.where(c.k >= self.max_backtracks,
                              torch.zeros_like(c.tau), c.tau / 2)
            x = tree_lincomb(tau, x_d, 1 - tau, z)
            Ax = tree_lincomb(tau, Ax_d, 1 - tau, Az)
            if quad:
                At_grad_f_Az, a, b, cc = interpolation()
                f_Ax = a * tau**2 + b * tau + cc
                grad_f_Ax = tree_lincomb(tau, grad_f_Ax_d, 1 - tau,
                                         grad_f_Az)
                At_grad_f_Ax = tree_lincomb(tau, At_grad_f_Ax_d, 1 - tau,
                                            At_grad_f_Az)
            else:
                f_Ax, grad_f_Ax = value_and_gradient(self.f, Ax)
                At_grad_f_Ax = self.A.rmatvec(grad_f_Ax)
            y = tree_map(lambda xl, gl: xl - gamma * gl, x, At_grad_f_Ax)
            zt, g_zt = prox(self.g, y, gamma)
            rest = tree_sub(x, zt)
            FBE = f_model(f_Ax, At_grad_f_Ax, rest, self.alpha / gamma) \
                + g_zt
            return _TauCarry(c.k + 1, tau, x, Ax, f_Ax, grad_f_Ax,
                             At_grad_f_Ax, y, zt, g_zt, rest, FBE)

        carry = _TauCarry(
            torch.ones((), dtype=torch.int32, device=gamma.device),
            torch.ones_like(gamma), x_d, Ax_d, f_Ax_d, grad_f_Ax_d,
            At_grad_f_Ax_d, y1, z1, g_z1, res1, FBE_new)
        # backtrack_limit also makes the tau search masked, with
        # max_backtracks trips
        out = bounded_while(
            cond, body, carry,
            None if self.backtrack_limit is None else self.max_backtracks)

        dstate = update_direction(self.directions, dstate,
                                  tree_sub(out.x, x_prev),
                                  tree_sub(out.res, res_prev))
        return PANOCState(out.x, out.Ax, out.f_Ax, out.grad_f_Ax,
                          out.At_grad_f_Ax, gamma, out.y, out.z, out.g_z,
                          out.res, dstate, out.tau)

    def default_stopping_criterion(self, tol, s):
        return tree_inf_norm(s.res) / s.gamma <= tol

    def default_solution(self, s):
        return s.z

    def default_display(self, k, s):
        ls_display(k, s)


def make_panoc_iteration(*, x0, f=Zero(), A=None, g=Zero(), alpha=0.95,
                         beta=0.5, Lf=None, gamma=None, adaptive=None,
                         minimum_gamma=1e-7, max_backtracks=20,
                         backtrack_limit=None, directions=LBFGS(5)):
    x0 = astree(x0)
    kw = ls_scalars(x0, alpha, beta, Lf, gamma, adaptive, minimum_gamma,
                    max_backtracks, backtrack_limit)
    return PANOCIteration(f=f, A=as_linop(A), g=g, x0=x0,
                          directions=directions, **kw)


def PANOC(*, maxit=1_000, tol=1e-8, stop=None, solution=None, verbose=False,
          freq=10, display=None, **kwargs):
    """PANOC solver: quasi-Newton directions with an FBE line search."""
    return IterativeAlgorithm(
        make_panoc_iteration, maxit=maxit, tol=tol, stop=stop,
        solution=solution, verbose=verbose, freq=freq, display=display,
        **kwargs)
