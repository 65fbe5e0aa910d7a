"""Prox-function combinators (counterpart of
``proxtpu/prox/combinators.py``): so far the conjugate only, which the
primal-dual solvers take through ``convex_conjugate``."""

from __future__ import annotations

from dataclasses import dataclass

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
