"""PANOCplus: PANOC for locally smooth f, with the gamma backtracking inside
the tau line search (counterpart of ``proxtpu/algorithms/panocplus.py``).

    minimize f(Ax) + g(x),   f locally smooth, A linear.

One loop carries the reference's ``can_update_direction`` / ``continue``
control flow as boolean flags; every decision in its body is a select, so
the same body runs on the host and masked under ``torch.func.vmap``.  The
stopping criterion is on the gradient-corrected residual.
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
    tree_add,
    tree_inf_norm,
    tree_map,
    tree_norm_sq,
    tree_sub,
    tree_where,
)
from .common import astree, ls_scalars
from .core import IterativeAlgorithm
from .fbs_common import forward_backward_init, next_direction, \
    update_direction
from .panoc import ls_display

_INT32_MAX = 2**31 - 1


class PANOCplusState(NamedTuple):
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
    At_grad_f_Az: object
    dstate: object
    tau: torch.Tensor


class _LSCarry(NamedTuple):
    done: torch.Tensor
    can_update_direction: torch.Tensor
    tau: torch.Tensor
    tau_backtracks: torch.Tensor
    trips_left: torch.Tensor
    gamma: torch.Tensor
    d: object
    x: object
    Ax: object
    f_Ax: torch.Tensor
    grad_f_Ax: object
    At_grad_f_Ax: object
    y: object
    z: object
    g_z: torch.Tensor
    res: object
    At_grad_f_Az: object
    dstate: object


@proxclass(meta_fields=("adaptive", "max_backtracks", "directions", "backtrack_limit"))
class PANOCplusIteration:
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
        if self.adaptive:
            bt = backtrack_stepsize(
                gamma, self.f, self.A, self.g, x, f_Ax, At_grad, y, z, g_z,
                res, alpha=self.alpha, minimum_gamma=self.minimum_gamma,
                max_backtracks=self.backtrack_limit)
            gamma, y, z, g_z, res = bt.gamma, bt.y, bt.z, bt.g_z, bt.res
            grad_f_Az = bt.grad_f_Az
        else:
            _, grad_f_Az = value_and_gradient(self.f, self.A.matvec(z))
        return PANOCplusState(
            x, Ax, f_Ax, grad, At_grad, gamma, y, z, g_z, res,
            self.A.rmatvec(grad_f_Az), self.directions.init_state(x),
            torch.zeros_like(gamma))

    def step(self, s):
        eps = eps_of(s.x)
        x_prev, res_prev = s.x, s.res
        zero, one = torch.zeros_like(s.gamma), torch.ones_like(s.gamma)
        i0 = torch.zeros((), dtype=torch.int32, device=s.gamma.device)
        bounded = self.backtrack_limit is not None

        FBE_x = f_model(s.f_Ax, s.At_grad_f_Ax, s.res,
                        self.alpha / s.gamma) + s.g_z
        sigma = self.beta * (0.5 / s.gamma) * (1 - self.alpha)
        tol_fbe = 10 * eps * (1 + torch.abs(FBE_x))
        threshold = FBE_x - sigma * tree_norm_sq(s.res) + tol_fbe

        def body(c):
            # the trial point: a fresh direction or the tau interpolation
            d_new = next_direction(self.directions, c.dstate, res_prev,
                                   res_prev)
            d = tree_where(c.can_update_direction, d_new, c.d)
            tau = torch.where(c.can_update_direction, one, c.tau)
            x_interp = tree_map(
                lambda xp, rp, dl: (1 - tau) * (xp - rp) + tau * (xp + dl),
                x_prev, res_prev, d)
            x = tree_where(c.can_update_direction, tree_add(x_prev, d),
                           x_interp)
            tau_backtracks = torch.where(c.can_update_direction, i0,
                                         c.tau_backtracks + 1)

            Ax = self.A.matvec(x)
            f_Ax, grad_f_Ax = value_and_gradient(self.f, Ax)
            At_grad_f_Ax = self.A.rmatvec(grad_f_Ax)
            y = tree_map(lambda xl, gl: xl - c.gamma * gl, x, At_grad_f_Ax)
            z, g_z = prox(self.g, y, c.gamma)
            res = tree_sub(x, z)
            f_Az_upp = f_model(f_Ax, At_grad_f_Ax, res, self.alpha / c.gamma)

            Az = self.A.matvec(z)
            f_Az, grad_f_Az = value_and_gradient(self.f, Az)
            At_grad_f_Az = self.A.rmatvec(grad_f_Az)

            if self.adaptive:
                tol = 10 * eps * (1 + torch.abs(f_Az))
                shrink = (f_Az > f_Az_upp + tol) & (c.gamma
                                                    >= self.minimum_gamma)
            else:
                shrink = torch.zeros_like(c.done)

            FBE_new = f_Az_upp + g_z
            finish = (FBE_new <= threshold) | (tau_backtracks
                                               >= self.max_backtracks)
            tau_next = torch.where(tau_backtracks >= self.max_backtracks - 1,
                                   zero, tau / 2)
            tau_out = torch.where(shrink | finish, tau, tau_next)
            trips_left = c.trips_left - 1
            if bounded:
                # the trip budget can undercount pathological interleavings
                # of gamma and tau halvings: rather than commit a rejected
                # trial, the last budgeted trip evaluates the plain FB point
                # (tau = 0) and commits it, with no shrink on that trip, so
                # the committed state stays consistent with its gamma
                shrink = shrink & (trips_left > 0)
                done = (~shrink & finish) | (trips_left <= 0)
                tau_out = torch.where((trips_left <= 1) & ~done, zero,
                                      tau_out)
                can_update_direction = shrink & (trips_left > 1)
            else:
                done = ~shrink & finish
                can_update_direction = shrink
            gamma = torch.where(shrink, c.gamma * 0.5, c.gamma)
            dstate = tree_where(shrink, self.directions.reset(c.dstate),
                                c.dstate)
            return _LSCarry(done, can_update_direction, tau_out,
                            tau_backtracks, trips_left, gamma, d, x, Ax,
                            f_Ax, grad_f_Ax, At_grad_f_Ax, y, z, g_z, res,
                            At_grad_f_Az, dstate)

        # masked: max_backtracks tau halvings plus the gamma halvings of the
        # interleaved search (bounded by backtrack_limit)
        cap = (self.max_backtracks + self.backtrack_limit + 2 if bounded
               else None)
        carry0 = _LSCarry(
            done=torch.zeros((), dtype=torch.bool, device=s.gamma.device),
            can_update_direction=torch.ones((), dtype=torch.bool,
                                            device=s.gamma.device),
            tau=one, tau_backtracks=i0,
            trips_left=torch.full((), _INT32_MAX if cap is None else cap,
                                  dtype=torch.int32, device=s.gamma.device),
            gamma=s.gamma, d=s.res,  # d: overwritten on the first trip
            x=s.x, Ax=s.Ax, f_Ax=s.f_Ax, grad_f_Ax=s.grad_f_Ax,
            At_grad_f_Ax=s.At_grad_f_Ax, y=s.y, z=s.z, g_z=s.g_z, res=s.res,
            At_grad_f_Az=s.At_grad_f_Az, dstate=s.dstate)
        out = bounded_while(lambda c: ~c.done, body, carry0, cap)

        dstate = update_direction(self.directions, out.dstate,
                                  tree_sub(out.x, x_prev),
                                  tree_sub(out.res, res_prev))
        return PANOCplusState(
            out.x, out.Ax, out.f_Ax, out.grad_f_Ax, out.At_grad_f_Ax,
            out.gamma, out.y, out.z, out.g_z, out.res, out.At_grad_f_Az,
            dstate, out.tau)

    def default_stopping_criterion(self, tol, s):
        # ||res / gamma - A^T grad f(Ax) + A^T grad f(Az)||_inf
        v = tree_map(lambda r, gx, gz: r / s.gamma - gx + gz, s.res,
                     s.At_grad_f_Ax, s.At_grad_f_Az)
        return tree_inf_norm(v) <= tol

    def default_solution(self, s):
        return s.z

    def default_display(self, k, s):
        ls_display(k, s)


def make_panocplus_iteration(*, x0, f=Zero(), A=None, g=Zero(), alpha=0.95,
                             beta=0.5, Lf=None, gamma=None, adaptive=None,
                             minimum_gamma=1e-7, max_backtracks=20,
                             backtrack_limit=None, directions=LBFGS(5)):
    x0 = astree(x0)
    kw = ls_scalars(x0, alpha, beta, Lf, gamma, adaptive, minimum_gamma,
                    max_backtracks, backtrack_limit)
    # the reference backtracks whenever gamma is estimated, even with
    # adaptive=False
    kw["adaptive"] = kw["adaptive"] or kw["gamma"] is None
    return PANOCplusIteration(f=f, A=as_linop(A), g=g, x0=x0,
                              directions=directions, **kw)


def PANOCplus(*, maxit=1_000, tol=1e-8, stop=None, solution=None,
              verbose=False, freq=10, display=None, **kwargs):
    """PANOCplus solver: PANOC for locally smooth f, the gamma backtracking
    inside the tau search."""
    return IterativeAlgorithm(
        make_panocplus_iteration, maxit=maxit, tol=tol, stop=stop,
        solution=solution, verbose=verbose, freq=freq, display=display,
        **kwargs)
