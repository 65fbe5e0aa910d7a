"""Douglas-Rachford splitting (counterpart of
``proxtpu/algorithms/douglas_rachford.py``).

    minimize f(x) + g(x),   both with an accessible prox.

Two proxes and three vector updates per iteration; ``gamma`` is required.
"""

from __future__ import annotations

from typing import NamedTuple

from ..prox.base import Zero, prox, proxclass
from ..utils.tree import tree_inf_norm, tree_map, tree_sub, tree_zeros_like
from .common import astree, device_of, real_dtype, rscalar
from .core import IterativeAlgorithm


class DouglasRachfordState(NamedTuple):
    x: object
    y: object
    z: object
    res: object


@proxclass
class DouglasRachfordIteration:
    f: object
    g: object
    x0: object
    gamma: object

    def init(self):
        return self.step(DouglasRachfordState(
            self.x0, self.x0, self.x0, tree_zeros_like(self.x0)))

    def step(self, s):
        y, _ = prox(self.f, s.x, self.gamma)
        r = tree_map(lambda yl, xl: 2 * yl - xl, y, s.x)
        z, _ = prox(self.g, r, self.gamma)
        res = tree_sub(y, z)
        return DouglasRachfordState(tree_sub(s.x, res), y, z, res)

    def default_stopping_criterion(self, tol, s):
        return tree_inf_norm(s.res) / self.gamma <= tol

    def default_solution(self, s):
        return s.y

    def default_display(self, k, s):
        crit = tree_inf_norm(s.res) / self.gamma
        print(f"{k:5d} | {float(crit):.3e}")


def make_douglas_rachford_iteration(*, x0, f=Zero(), g=Zero(), gamma):
    x0 = astree(x0)
    return DouglasRachfordIteration(
        f=f, g=g, x0=x0, gamma=rscalar(gamma, real_dtype(x0), device_of(x0)))


def DouglasRachford(*, maxit=1_000, tol=1e-8, stop=None, solution=None,
                    verbose=False, freq=100, display=None, **kwargs):
    """Douglas-Rachford splitting solver for two nonsmooth terms
    (``gamma`` is required)."""
    return IterativeAlgorithm(
        make_douglas_rachford_iteration, maxit=maxit, tol=tol, stop=stop,
        solution=solution, verbose=verbose, freq=freq, display=display,
        **kwargs)
