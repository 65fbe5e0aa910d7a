"""Li-Lin accelerated proximal gradient for nonconvex problems (counterpart
of ``proxtpu/algorithms/li_lin.py``; Li & Lin, NIPS 2015, Algorithm 2).

    minimize f(x) + g(x),   f smooth, possibly nonconvex.

An extrapolated forward-backward step monitored against a nonmonotone
moving average ``F_average`` (eta = 0.8, delta = 1e-3).  When the monitor
fails, a plain forward-backward step from ``x`` is computed and the better
of the two points is kept.  For one problem the monitor is tested on the
host, so the plain step is paid only when it fails (the reference's
``lax.cond``).  The batched drivers set ``select_branches``: both branches
are computed and each lane selects its own, which is what ``lax.cond``
becomes under ``vmap``, and the form that runs under ``torch.func.vmap``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..prox.base import Zero, prox, proxclass, value_and_gradient
from ..utils.tree import (
    tree_inf_norm,
    tree_map,
    tree_norm_sq,
    tree_sub,
    tree_where,
)
from .common import astree, device_of, real_dtype, rscalar
from .core import IterativeAlgorithm


class LiLinState(NamedTuple):
    x: object
    y: object
    f_y: torch.Tensor
    grad_f_y: object
    gamma: torch.Tensor
    z: object
    g_z: torch.Tensor
    res: object
    theta: torch.Tensor
    F_average: torch.Tensor
    q: torch.Tensor


@proxclass(meta_fields=("theta_restart",))
class LiLinIteration:
    f: object
    g: object
    x0: object
    gamma: object
    delta: object
    eta: object
    theta_restart: bool = False
    # set by the batched drivers: both branches and a per-lane select, no
    # test on the host
    select_branches: bool = False

    def _forward_backward(self, y, gamma):
        f_y, grad_f_y = value_and_gradient(self.f, y)
        z, g_z = prox(self.g, tree_map(lambda yl, gl: yl - gamma * gl, y,
                                       grad_f_y), gamma)
        return f_y, grad_f_y, z, g_z

    def init(self):
        y = self.x0
        f_y, grad_f_y, z, g_z = self._forward_backward(y, self.gamma)
        Fy = f_y + self.g(y)
        one = torch.ones_like(self.gamma)
        return LiLinState(self.x0, y, f_y, grad_f_y, self.gamma, z, g_z,
                          tree_sub(y, z), one, Fy.to(one.dtype), one)

    def step(self, s):
        Fz = self.f(s.z) + s.g_z
        # NaN-safe orientation: a NaN Fz fails the monitor and takes the
        # monitored branch, whose plain FB step from x recovers a finite
        # iterate (the reference's `Fz <= thresh`)
        monitor_ok = Fz <= s.F_average - self.delta * tree_norm_sq(s.res)
        theta = s.theta
        if self.theta_restart:
            # off by default, no counterpart in the reference: a monitor
            # failure resets the extrapolation sequence (theta = 1)
            theta = torch.where(monitor_ok, theta, torch.ones_like(theta))
        theta1 = (1 + torch.sqrt(1 + 4 * theta**2)) / 2
        w1 = (theta - 1) / theta1  # the case-1 extrapolation weight
        y1 = tree_map(lambda zl, xl: zl + w1 * (zl - xl), s.z, s.x)

        fast = (y1, s.z, Fz.to(theta.dtype))
        if self.select_branches:
            monitored = self._monitored(s, Fz, theta, theta1, w1, y1)
            y, x_new, Fx = (tree_where(monitor_ok, a, b)
                            for a, b in zip(fast, monitored))
        elif bool(monitor_ok):
            y, x_new, Fx = fast
        else:
            y, x_new, Fx = self._monitored(s, Fz, theta, theta1, w1, y1)

        f_y, grad_f_y, z, g_z = self._forward_backward(y, s.gamma)
        q1 = self.eta * s.q + 1
        F_average = (self.eta * s.q * s.F_average + Fx) / q1
        return LiLinState(x_new, y, f_y, grad_f_y, s.gamma, z, g_z,
                          tree_sub(y, z), theta1, F_average, q1)

    def _monitored(self, s, Fz, theta, theta1, w1, y1):
        """The branch taken when the monitor fails: the plain FB step from
        x (case 2) and the better of the two points."""
        _, _, v, g_v = self._forward_backward(s.x, s.gamma)
        Fv = self.f(v) + g_v
        case1 = Fz <= Fv
        w2 = theta / theta1
        y2 = tree_map(
            lambda zl, vl, xl: zl + w2 * (zl - vl) + w1 * (vl - xl),
            s.z, v, s.x)
        return (tree_where(case1, y1, y2), tree_where(case1, s.z, v),
                torch.where(case1, Fz, Fv).to(theta.dtype))

    def default_stopping_criterion(self, tol, s):
        return tree_inf_norm(s.res) / s.gamma <= tol

    def default_solution(self, s):
        return s.z

    def default_display(self, k, s):
        crit = tree_inf_norm(s.res) / s.gamma
        print(f"{k:5d} | {float(s.gamma):.3e} | {float(crit):.3e}")


def make_li_lin_iteration(*, x0, f=Zero(), g=Zero(), Lf=None, gamma=None,
                          delta=1e-3, eta=0.8, theta_restart=False):
    x0 = astree(x0)
    R, dev = real_dtype(x0), device_of(x0)
    if gamma is None:
        if Lf is None:
            raise ValueError("You must specify either Lf or gamma")
        gamma = 1 / rscalar(Lf, R, dev)
    if not bool(torch.isfinite(f(x0) + g(x0))):
        raise ValueError("initial point must be feasible")
    return LiLinIteration(f=f, g=g, x0=x0, gamma=rscalar(gamma, R, dev),
                          delta=rscalar(delta, R, dev),
                          eta=rscalar(eta, R, dev),
                          theta_restart=bool(theta_restart))


def LiLin(*, maxit=10_000, tol=1e-8, stop=None, solution=None,
          verbose=False, freq=100, display=None, **kwargs):
    """Li-Lin nonconvex accelerated proximal-gradient solver.
    ``theta_restart=True`` (off by default, no counterpart in the
    reference) resets the extrapolation sequence on monitor failures."""
    return IterativeAlgorithm(
        make_li_lin_iteration, maxit=maxit, tol=tol, stop=stop,
        solution=solution, verbose=verbose, freq=freq, display=display,
        **kwargs)
