"""DRLS: Douglas-Rachford line search with pluggable directions
(counterpart of ``proxtpu/algorithms/drls.py``).

    minimize f(x) + g(x),   f smooth with an accessible prox.

A line search on the Douglas-Rachford envelope (DRE) with L-BFGS, Broyden,
Anderson, Nesterov or no-acceleration directions; for a generalized
quadratic f the prox is affine in its argument, so u and f(u) are
interpolated along the segment (the segment's other end is computed at the
first trial that needs it).  ``dre_sign`` flips the merit for strongly
convex f.  The default gamma and decrease constant follow
``drls_default_gamma`` / ``drls_C`` from f's convexity trait.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..accel.base import NESTEROV, QUASI_NEWTON
from ..accel.lbfgs import LBFGS
from ..prox.base import Zero, is_convex, is_generalized_quadratic, prox, \
    proxclass
from ..utils.loops import bounded_while
from ..utils.tree import (
    tree_add,
    tree_dot,
    tree_inf_norm,
    tree_lincomb,
    tree_map,
    tree_neg,
    tree_norm_sq,
    tree_sub,
    tree_vdot_real,
)
from .common import astree, device_of, real_dtype, rscalar
from .core import IterativeAlgorithm
from .panoc import ls_display


def _over(num, den):
    """num / den as a true division also where den is a tensor (torch
    computes a number over a tensor as a reciprocal times the number)."""
    if isinstance(den, torch.Tensor):
        return torch.as_tensor(num, dtype=den.dtype, device=den.device) / den
    return num / den


def drls_default_gamma(f, mf, Lf, alpha, lam):
    if mf is not None and mf > 0:
        return _over(1, alpha * mf)
    if is_convex(f):
        return _over(alpha, Lf)
    return _over(alpha * (2 - lam), 2 * Lf)


def drls_C(f, mf, Lf, gamma, lam):
    a = gamma * Lf if (mf is None or mf <= 0) else _over(1, gamma * mf)
    if not is_convex(f):
        m = 1
    elif isinstance(a, torch.Tensor):  # per-lane Lf or gamma
        m = torch.clamp(a - lam / 2, min=0)
    else:
        m = max(a - lam / 2, 0)
    return _over(lam, (1 + a) ** 2) * ((2 - lam) / 2 - a * m)


def _dre(f_u, g_v, x, u, res, gamma):
    """The Douglas-Rachford envelope; the reference's dot product of (x - u)
    and res is unconjugated."""
    dot = torch.real(tree_dot(tree_sub(x, u), res))
    return f_u + g_v - dot / gamma + tree_norm_sq(res) / (2 * gamma)


class DRLSState(NamedTuple):
    x: object
    u: object
    v: object
    w: object
    res: object
    xbar: object
    gamma: torch.Tensor
    f_u: torch.Tensor
    g_v: torch.Tensor
    dstate: object
    tau: torch.Tensor
    xbar_prev: object


class _TauCarry(NamedTuple):
    k: torch.Tensor
    tau: torch.Tensor
    x: object
    u: object
    v: object
    w: object
    res: object
    xbar: object
    f_u: torch.Tensor
    g_v: torch.Tensor
    dre: torch.Tensor


@proxclass(meta_fields=("max_backtracks", "directions", "dre_sign", "backtrack_limit"))
class DRLSIteration:
    f: object
    g: object
    x0: object
    lam: object
    c: object
    gamma: object
    max_backtracks: int
    directions: object
    dre_sign: int
    backtrack_limit: object = None  # None: tau search on the host; int: masked

    def _split(self, x, gamma, u=None, f_u=None):
        """The DR pieces at x: u = prox_f(x), w = 2u - x, v = prox_g(w),
        res = u - v, xbar = x - lam res (u and f(u) given, or computed)."""
        if u is None:
            u, f_u = prox(self.f, x, gamma)
        w = tree_map(lambda ul, xl: 2 * ul - xl, u, x)
        v, g_v = prox(self.g, w, gamma)
        res = tree_sub(u, v)
        xbar = tree_map(lambda xl, rl: xl - self.lam * rl, x, res)
        return u, f_u, w, v, g_v, res, xbar

    def init(self):
        x = self.x0
        u, f_u, w, v, g_v, res, xbar = self._split(x, self.gamma)
        gamma = torch.as_tensor(self.gamma)
        return DRLSState(x, u, v, w, res, xbar, gamma, f_u, g_v,
                         self.directions.init_state(x),
                         torch.zeros_like(gamma), xbar)

    def _direction(self, s):
        style = self.directions.style
        if style == QUASI_NEWTON:
            return tree_neg(self.directions.apply(s.dstate, s.res)), s.dstate
        if style == NESTEROV:
            beta, dstate = self.directions.next_coeff(s.dstate, s.gamma)
            d = tree_map(lambda xb, xbp, xl: beta * (xb - xbp) + (xb - xl),
                         s.xbar, s.xbar_prev, s.x)
            return d, dstate
        return tree_sub(s.xbar, s.x), s.dstate

    def step(self, s):
        quad = is_generalized_quadratic(self.f)
        gamma = s.gamma

        DRE_curr = _dre(s.f_u, s.g_v, s.x, s.u, s.res, gamma)
        threshold = (self.dre_sign * DRE_curr
                     - self.c / gamma * tree_norm_sq(s.res))

        d, dstate = self._direction(s)
        x_d = tree_add(s.x, d)
        xbar_prev, res_prev = s.xbar, s.res

        # the full step (tau = 1)
        u1, f_u1, w, v, g_v, res, xbar = self._split(x_d, gamma)
        if self.directions.style == QUASI_NEWTON:
            dstate = self.directions.update(dstate, d,
                                            tree_sub(res, res_prev))

        @functools.cache
        def interpolation():
            # prox_f is affine along the segment: u(tau) between u1 and
            # u0 = prox_f(xbar_prev), f(u(tau)) = a tau^2 + b tau + c
            u0, c_val = prox(self.f, xbar_prev, gamma)
            b = tree_vdot_real(tree_sub(xbar_prev, x_d),
                               tree_sub(xbar_prev, u0)) / gamma
            return u0, f_u1 - b - c_val, b, c_val

        def cond(c):
            return ((c.k <= self.max_backtracks)
                    & (self.dre_sign * c.dre > threshold))

        def body(c):
            tau = torch.where(c.k >= self.max_backtracks,
                              torch.zeros_like(c.tau), c.tau / 2)
            x = tree_lincomb(tau, x_d, 1 - tau, xbar_prev)
            if quad:
                u0, a, b, cc = interpolation()
                u, f_u, w, v, g_v, res, xbar = self._split(
                    x, gamma, tree_lincomb(tau, u1, 1 - tau, u0),
                    a * tau**2 + b * tau + cc)
            else:
                u, f_u, w, v, g_v, res, xbar = self._split(x, gamma)
            return _TauCarry(c.k + 1, tau, x, u, v, w, res, xbar, f_u, g_v,
                             _dre(f_u, g_v, x, u, res, gamma))

        carry = _TauCarry(
            torch.ones((), dtype=torch.int32, device=gamma.device),
            torch.ones_like(gamma), x_d, u1, v, w, res, xbar, f_u1, g_v,
            _dre(f_u1, g_v, x_d, u1, res, gamma))
        out = bounded_while(
            cond, body, carry,
            None if self.backtrack_limit is None else self.max_backtracks)

        return DRLSState(out.x, out.u, out.v, out.w, out.res, out.xbar,
                         gamma, out.f_u, out.g_v, dstate, out.tau, xbar_prev)

    def default_stopping_criterion(self, tol, s):
        return tree_inf_norm(s.res) / s.gamma <= tol

    def default_solution(self, s):
        return s.v

    def default_display(self, k, s):
        ls_display(k, s)


def make_drls_iteration(*, x0, f=Zero(), g=Zero(), alpha=0.95, beta=0.5,
                        lam=1.0, lambda_=None, mf=None, Lf=None, gamma=None,
                        c=None, max_backtracks=20, directions=LBFGS(5),
                        backtrack_limit=None):
    x0 = astree(x0)
    R, dev = real_dtype(x0), device_of(x0)
    if lambda_ is not None:
        lam = lambda_
    if gamma is None:
        gamma = drls_default_gamma(f, mf, Lf, alpha, lam)
    if c is None:
        c = beta * drls_C(f, mf, Lf, gamma, lam)
    dre_sign = 1 if (mf is None or mf <= 0) else -1
    return DRLSIteration(
        f=f, g=g, x0=x0, lam=rscalar(lam, R, dev), c=rscalar(c, R, dev),
        gamma=rscalar(gamma, R, dev), max_backtracks=int(max_backtracks),
        directions=directions, dre_sign=dre_sign,
        backtrack_limit=(None if backtrack_limit is None
                         else int(backtrack_limit)))


def DRLS(*, maxit=1_000, tol=1e-8, stop=None, solution=None, verbose=False,
         freq=10, display=None, **kwargs):
    """Douglas-Rachford line-search solver (DRE merit and directions)."""
    return IterativeAlgorithm(
        make_drls_iteration, maxit=maxit, tol=tol, stop=stop,
        solution=solution, verbose=verbose, freq=freq, display=display,
        **kwargs)
