"""Davis-Yin three-operator splitting (counterpart of
``proxtpu/algorithms/davis_yin.py``).

    minimize f(x) + g(x) + h(x),   f smooth, g and h with accessible proxes.

Two proxes and one gradient per iteration with relaxation ``lam``; the
stopping criterion is ``||res||_inf <= tol``.
"""

from __future__ import annotations

from typing import NamedTuple

from ..prox.base import Zero, prox, proxclass, value_and_gradient
from ..utils.tree import tree_inf_norm, tree_map, tree_sub
from .common import astree, device_of, real_dtype, rscalar
from .core import IterativeAlgorithm


class DavisYinState(NamedTuple):
    z: object
    xg: object
    grad_f_xg: object
    xh: object
    res: object


@proxclass
class DavisYinIteration:
    f: object
    g: object
    h: object
    x0: object
    lam: object
    gamma: object

    def _update(self, z):
        xg, _ = prox(self.g, z, self.gamma)
        _, grad_f_xg = value_and_gradient(self.f, xg)
        z_half = tree_map(lambda xgl, zl, gl: 2 * xgl - zl - self.gamma * gl,
                          xg, z, grad_f_xg)
        xh, _ = prox(self.h, z_half, self.gamma)
        res = tree_sub(xh, xg)
        z_new = tree_map(lambda zl, rl: zl + self.lam * rl, z, res)
        return DavisYinState(z_new, xg, grad_f_xg, xh, res)

    def init(self):
        return self._update(self.x0)

    def step(self, s):
        return self._update(s.z)

    def default_stopping_criterion(self, tol, s):
        return tree_inf_norm(s.res) <= tol

    def default_solution(self, s):
        return s.xh

    def default_display(self, k, s):
        print(f"{k:5d} | {float(tree_inf_norm(s.res)):.3e}")


def make_davis_yin_iteration(*, x0, f=Zero(), g=Zero(), h=Zero(), lam=1.0,
                             Lf=None, gamma=None):
    x0 = astree(x0)
    R, dev = real_dtype(x0), device_of(x0)
    if gamma is None:
        if Lf is None:
            raise ValueError("You must specify either Lf or gamma")
        gamma = 1 / rscalar(Lf, R, dev)
    return DavisYinIteration(f=f, g=g, h=h, x0=x0, lam=rscalar(lam, R, dev),
                             gamma=rscalar(gamma, R, dev))


def DavisYin(*, maxit=10_000, tol=1e-8, stop=None, solution=None,
             verbose=False, freq=100, display=None, **kwargs):
    """Davis-Yin splitting solver."""
    return IterativeAlgorithm(
        make_davis_yin_iteration, maxit=maxit, tol=tol, stop=stop,
        solution=solution, verbose=verbose, freq=freq, display=display,
        **kwargs)
