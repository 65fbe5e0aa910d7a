"""Prox-function combinators (counterpart of
``proxtpu/prox/combinators.py``): so far the conjugate, which the
primal-dual solvers take through ``convex_conjugate``, and the sliced
separable sum of the linear-programming formulations."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..utils.tree import tree_map, tree_scale, tree_vdot_real


@dataclass(frozen=True)
class Conjugate:
    """Convex conjugate f*; its prox through the Moreau decomposition:

        prox_{gamma f*}(x) = x - gamma * prox_{f/gamma}(x/gamma)

    The value at the prox point is the Fenchel equality at the maximiser:
    f*(z) = <z, u> - f(u) with u = prox_{f/gamma}(x/gamma)."""

    f: object

    is_convex = True  # a conjugate is always convex

    @property
    def is_generalized_quadratic(self):
        return getattr(self.f, "is_generalized_quadratic", False)

    def prox(self, x, gamma):
        u, f_u = self.f.prox(tree_scale(1 / gamma, x), 1 / gamma)
        z = tree_map(lambda xl, ul: xl - gamma * ul, x, u)
        return z, tree_vdot_real(z, u) - f_u


@dataclass(frozen=True)
class SlicedSeparableSum:
    """g(x) = sum_i g_i(x[a_i:b_i]) on a flat vector; ``slices`` is a tuple
    of fixed (start, stop) pairs."""

    fs: tuple
    slices: tuple

    @property
    def is_convex(self):
        return all(getattr(f, "is_convex", False) for f in self.fs)

    @property
    def is_generalized_quadratic(self):
        return all(getattr(f, "is_generalized_quadratic", False)
                   for f in self.fs)

    def __call__(self, x):
        vals = [f(x[a:b]) for f, (a, b) in zip(self.fs, self.slices)]
        return sum(vals[1:], vals[0])

    def prox(self, x, gamma):
        outs = [f.prox(x[a:b], gamma) for f, (a, b) in zip(self.fs,
                                                            self.slices)]
        vals = [v for _, v in outs]
        return torch.cat([z for z, _ in outs]), sum(vals[1:], vals[0])
