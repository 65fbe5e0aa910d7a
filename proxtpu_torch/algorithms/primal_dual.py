"""Primal-dual splitting: AFBA, Vu-Condat, Chambolle-Pock (counterpart of
``proxtpu/algorithms/primal_dual.py``; Latafat-Patrinos Algorithm 3).

    minimize f(x) + g(x) + (h box l)(L x),
    f smooth, l strongly convex (so l* is smooth), L linear.

Per iteration two applications of ``L``, two of its adjoint, two proxes and
one gradient, with the theta/mu-parameterised correction steps.  The
default-stepsize engine carries the full theta/mu case analysis.
"""

from __future__ import annotations

import math
from typing import NamedTuple

from ..ops.linops import IdentityOperator, ZeroOperator, as_linop
from ..prox.base import (
    IndZero,
    Zero,
    convex_conjugate,
    prox,
    proxclass,
    value_and_gradient,
)
from ..utils.tree import tree_inf_norm, tree_leaves, tree_map, tree_sub
from .common import astree, real_dtype, rscalar
from .core import IterativeAlgorithm


class AFBAState(NamedTuple):
    x: object
    y: object
    xbar: object
    ybar: object
    FPR_x: object
    FPR_y: object


@proxclass
class AFBAIteration:
    f: object
    g: object
    hconj: object  # convex conjugate of h (prox oracle)
    lconj: object  # convex conjugate of l (smooth oracle)
    L: object
    x0: object
    y0: object
    theta: object
    mu: object
    lam: object
    gamma1: object
    gamma2: object

    def _update(self, x, y):
        g1, g2 = self.gamma1, self.gamma2
        th, mu, lam = self.theta, self.mu, self.lam

        # xbar-update
        _, gradf = value_and_gradient(self.f, x)
        Lt_y = self.L.rmatvec(y)
        temp_x = tree_map(
            lambda xl, ll, gl: xl - g1 * (ll + gl), x, Lt_y, gradf)
        xbar, _ = prox(self.g, temp_x, g1)

        # ybar-update
        _, gradl = value_and_gradient(self.lconj, y)
        mid = tree_map(lambda bl, xl: th * bl + (1 - th) * xl, xbar, x)
        L_mid = self.L.matvec(mid)
        temp_y = tree_map(
            lambda yl, ll, gl: yl + g2 * (ll - gl), y, L_mid, gradl)
        ybar, _ = prox(self.hconj, temp_y, g2)

        FPR_x = tree_sub(xbar, x)
        FPR_y = tree_sub(ybar, y)

        # corrected x and y updates
        corr_x = self.L.rmatvec(FPR_y)
        x_new = tree_map(
            lambda xl, fl, cl: xl + lam * (fl - mu * (2 - th) * g1 * cl),
            x, FPR_x, corr_x)
        corr_y = self.L.matvec(FPR_x)
        y_new = tree_map(
            lambda yl, fl, cl: yl + lam * (fl + (1 - mu) * (2 - th) * g2 * cl),
            y, FPR_y, corr_y)
        return AFBAState(x_new, y_new, xbar, ybar, FPR_x, FPR_y)

    def init(self):
        return self._update(self.x0, self.y0)

    def step(self, s):
        return self._update(s.x, s.y)

    def default_stopping_criterion(self, tol, s):
        return tree_inf_norm(s.FPR_x) + tree_inf_norm(s.FPR_y) <= tol

    def default_solution(self, s):
        return (s.xbar, s.ybar)

    def default_display(self, k, s):
        crit = tree_inf_norm(s.FPR_x) + tree_inf_norm(s.FPR_y)
        print(f"{k:6d} | {float(crit):.4e}")


def afba_default_stepsizes(L, h, theta, mu, beta_f, beta_l, x_like=None):
    """The theta/mu case analysis of the default stepsizes.  All inputs
    are Python scalars, resolved when the iteration is made; ``opnorm``
    comes from the operator protocol."""
    if isinstance(h, Zero):
        return 1.99 / beta_f, 1.0

    par, par2 = 5.0, 100.0
    alpha = 1.0
    nmL = float(L.opnorm())
    isa = lambda a, b: math.isclose(a, b, rel_tol=math.sqrt(2.2e-16))

    if isa(theta, 2):  # Vu-Condat
        if nmL > par * max(beta_l, beta_f):
            alpha = 1.0
        elif beta_f > par * beta_l:
            alpha = par2 * nmL / beta_f
        elif beta_l > par * beta_f:
            alpha = beta_l / (par2 * nmL)
        gamma1 = 1.0 / (beta_f / 2 + nmL / alpha)
        gamma2 = 0.99 / (beta_l / 2 + nmL * alpha)
    elif isa(theta, 1) and isa(mu, 1):  # SPCA
        if nmL > par2 * beta_l:
            alpha = 1.0
        elif beta_l > par * beta_f:
            alpha = beta_l / (par2 * nmL)
        gamma1 = 1.99 / beta_f if beta_f > 0 else alpha / nmL
        gamma2 = 0.99 / (beta_l / 2 + gamma1 * nmL**2)
    elif isa(theta, 0) and isa(mu, 1):  # PPCA
        temp = 3.0
        if isa(beta_f, 0):
            nmL *= math.sqrt(temp)
            alpha = 1.0 if nmL > par * beta_l else beta_l / (par2 * nmL)
            gamma1 = 1.0 / (beta_f / 2 + nmL / alpha)
            gamma2 = 0.99 / (beta_l / 2 + nmL * alpha)
        else:
            if nmL > par * max(beta_l, beta_f):
                alpha = 1.0
            elif beta_f > par * beta_l:
                alpha = par2 * nmL / beta_f
            elif beta_l > par * beta_f:
                alpha = beta_l / (par2 * nmL)
            xi = 1 + 2 * nmL / (nmL + alpha * beta_f / 2)
            gamma1 = 1.0 / (beta_f / 2 + nmL / alpha)
            gamma2 = 0.99 / (beta_l / 2 + xi * nmL * alpha)
    elif isa(mu, 0):  # SDCA & PDCA
        temp = theta**2 - 3 * theta + 3
        if isa(beta_l, 0):
            nmL *= math.sqrt(temp)
            alpha = 1.0 if nmL > par * beta_f else par2 * nmL / beta_f
            gamma1 = 1.0 / (beta_f / 2 + nmL / alpha)
            gamma2 = 0.99 / (beta_l / 2 + nmL * alpha)
        else:
            if nmL > par * max(beta_l, beta_f):
                alpha = 1.0
            elif beta_f > par * beta_l:
                alpha = par2 * nmL / beta_f
            elif beta_l > par * beta_f:
                alpha = beta_l / (par2 * nmL)
            eta = 1 + (temp - 1) * alpha * nmL / (alpha * nmL + beta_l / 2)
            gamma1 = 1.0 / (beta_f / 2 + eta * nmL / alpha)
            gamma2 = 0.99 / (beta_l / 2 + nmL * alpha)
    elif isa(theta, 0) and isa(mu, 0.5):  # PPDCA
        if isa(beta_l, 0) or isa(beta_f, 0):
            if nmL > par * max(beta_l, beta_f):
                alpha = 1.0
            elif beta_f > par * beta_l:
                alpha = par2 * nmL / beta_f
            elif beta_l > par * beta_f:
                alpha = beta_l / (par2 * nmL)
        else:
            alpha = math.sqrt(beta_l / beta_f) / 2
        gamma1 = 1.0 / (beta_f / 2 + nmL / alpha)
        gamma2 = 0.99 / (beta_l / 2 + nmL * alpha)
    else:
        raise ValueError("this choice of theta and mu is not supported!")

    return gamma1, gamma2


def make_afba_iteration(*, x0, y0, f=None, g=None, h=None, l=None, L=None,
                        beta_f=None, beta_l=None, theta=1.0, mu=1.0,
                        lam=1.0, gamma=None, gamma1=None, gamma2=None):
    f = Zero() if f is None else f
    g = Zero() if g is None else g
    h = Zero() if h is None else h
    l = IndZero() if l is None else l
    x0, y0 = astree(x0), astree(y0)
    R = real_dtype(x0)
    dev = tree_leaves(x0)[0].device

    if L is None:
        L = ZeroOperator() if isinstance(h, Zero) else IdentityOperator()
    else:
        L = as_linop(L)
    if beta_f is None:
        if not isinstance(f, Zero):
            raise ValueError(
                "argument beta_f must be specified together with f")
        beta_f = 0.0
    if beta_l is None:
        if not isinstance(l, IndZero):
            raise ValueError(
                "argument beta_l must be specified together with l")
        beta_l = 0.0

    if gamma is not None:
        gamma1, gamma2 = gamma
    if gamma1 is None or gamma2 is None:
        if lam != 1:
            raise ValueError(
                "if lam != 1, then you need to provide stepsizes manually")
        gamma1, gamma2 = afba_default_stepsizes(
            L, h, float(theta), float(mu), float(beta_f), float(beta_l))

    lconj = convex_conjugate(l)
    if not (hasattr(lconj, "value_and_gradient") or isinstance(lconj, Zero)):
        raise ValueError(
            "the conjugate of l must expose a smooth oracle "
            "(value_and_gradient); pass a strongly convex l with a known "
            "conjugate, e.g. IndZero or SqrNormL2")

    return AFBAIteration(
        f=f, g=g, hconj=convex_conjugate(h), lconj=lconj, L=L, x0=x0, y0=y0,
        theta=rscalar(theta, R, dev), mu=rscalar(mu, R, dev),
        lam=rscalar(lam, R, dev), gamma1=rscalar(gamma1, R, dev),
        gamma2=rscalar(gamma2, R, dev))


def make_vu_condat_iteration(**kwargs):
    """Vu-Condat = AFBA with theta = 2."""
    if "theta" in kwargs:
        raise ValueError(
            "theta=2 defines Vu-Condat; to run a different AFBA "
            "parametrization use AFBA(theta=...) directly")
    return make_afba_iteration(**kwargs, theta=2.0)


def make_chambolle_pock_iteration(**kwargs):
    """Chambolle-Pock = AFBA with theta = 2, f = 0, l = Ind{0}."""
    for key in ("theta", "f", "l"):
        if key in kwargs:
            raise ValueError(
                f"{key} is fixed by the Chambolle-Pock parametrization "
                "(theta=2, f=0, l=Ind{0}); to override it use "
                "AFBA(...) directly")
    return make_afba_iteration(**kwargs, theta=2.0, f=Zero(), l=IndZero())


def AFBA(*, maxit=10_000, tol=1e-5, stop=None, solution=None, verbose=False,
         freq=100, display=None, **kwargs):
    """The AFBA solver (default tol 1e-5)."""
    return IterativeAlgorithm(
        make_afba_iteration, maxit=maxit, tol=tol, stop=stop,
        solution=solution, verbose=verbose, freq=freq, display=display,
        **kwargs)


def VuCondat(**kwargs):
    """The Vu-Condat primal-dual solver.  theta is pinned to 2 by the
    guarded factory: a call-time ``theta=...`` raises instead of changing
    which algorithm runs."""
    alg = AFBA(**kwargs)
    alg.iteration_factory = make_vu_condat_iteration
    return alg


def ChambollePock(**kwargs):
    """The Chambolle-Pock primal-dual solver.  theta, f and l are pinned by
    the guarded factory: supplying them at construction or call time raises
    instead of running another AFBA variant under this name."""
    alg = AFBA(**kwargs)
    alg.iteration_factory = make_chambolle_pock_iteration
    return alg
