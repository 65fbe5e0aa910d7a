"""Prox-function combinators (counterpart of
``proxtpu/prox/combinators.py``): the conjugate, separable sums over tuple
iterates and slices, scaling and affine precomposition, the Moreau
envelope, linear tilts, quadratic regularisation, the pointwise minimum and
the smooth sum."""

from __future__ import annotations

import torch

from ..utils.tree import tree_map, tree_scale, tree_sub, tree_vdot_real, \
    tree_where
from .base import proxclass, value_and_gradient


def _as(p, like):
    """A number or tensor in ``like``'s dtype (``jnp.asarray(p,
    like.dtype)``); a number stays a number."""
    if isinstance(p, torch.Tensor):
        return p.to(like.dtype)
    return p


def _conj(a):
    return a.conj() if isinstance(a, torch.Tensor) else a.conjugate()


def _traits_of(attr):
    """A property that passes ``f``'s trait through."""
    return property(lambda self: getattr(self.f, attr, False))


def _all_of(attr):
    """A property true where every term of ``fs`` has the trait."""
    return property(lambda self: all(getattr(f, attr, False)
                                     for f in self.fs))


@proxclass
class Conjugate:
    """Convex conjugate f*; its prox through the Moreau decomposition:

        prox_{gamma f*}(x) = x - gamma * prox_{f/gamma}(x/gamma)

    The value at the prox point is the Fenchel equality at the maximiser:
    f*(z) = <z, u> - f(u) with u = prox_{f/gamma}(x/gamma)."""

    f: object

    is_convex = True  # a conjugate is always convex
    is_generalized_quadratic = _traits_of("is_generalized_quadratic")

    def prox(self, x, gamma):
        u, f_u = self.f.prox(tree_scale(1 / gamma, x), 1 / gamma)
        z = tree_map(lambda xl, ul: xl - gamma * ul, x, u)
        return z, tree_vdot_real(z, u) - f_u


@proxclass
class SeparableSum:
    """g(x1, ..., xk) = g1(x1) + ... + gk(xk) over a tuple iterate."""

    fs: tuple

    is_convex = _all_of("is_convex")
    is_generalized_quadratic = _all_of("is_generalized_quadratic")

    def __call__(self, x):
        vals = [f(xi) for f, xi in zip(self.fs, x)]
        return sum(vals[1:], vals[0])

    def prox(self, x, gamma):
        outs = [f.prox(xi, gamma) for f, xi in zip(self.fs, x)]
        vals = [v for _, v in outs]
        return tuple(z for z, _ in outs), sum(vals[1:], vals[0])


@proxclass(meta_fields=("slices",))
class SlicedSeparableSum:
    """g(x) = sum_i g_i(x[a_i:b_i]) on a flat vector; ``slices`` is a tuple
    of fixed (start, stop) pairs."""

    fs: tuple
    slices: tuple

    is_convex = _all_of("is_convex")
    is_generalized_quadratic = _all_of("is_generalized_quadratic")

    def __call__(self, x):
        vals = [f(x[a:b]) for f, (a, b) in zip(self.fs, self.slices)]
        return sum(vals[1:], vals[0])

    def prox(self, x, gamma):
        outs = [f.prox(x[a:b], gamma) for f, (a, b) in zip(self.fs,
                                                            self.slices)]
        vals = [v for _, v in outs]
        return torch.cat([z for z, _ in outs]), sum(vals[1:], vals[0])


@proxclass
class Postcompose:
    """g(x) = a * f(x) + b; prox_{gamma g} = prox_{(a gamma) f}."""

    f: object
    a: object = 1.0
    b: object = 0.0

    is_convex = _traits_of("is_convex")
    is_generalized_quadratic = _traits_of("is_generalized_quadratic")

    def __call__(self, x):
        return self.a * self.f(x) + self.b

    def value_and_gradient(self, x):
        v, g = value_and_gradient(self.f, x)
        return self.a * v + self.b, tree_scale(self.a, g)

    def prox(self, x, gamma):
        z, f_z = self.f.prox(x, gamma * self.a)
        return z, self.a * f_z + self.b


@proxclass
class Precompose:
    """g(x) = f(L x + b) for a linear map with L L* = mu I, mu > 0
    (orthogonal maps, scaled identities, tight frames); then

        prox_{gamma g}(x) = x + (1/mu) L*(prox_{mu gamma f}(Lx + b) - Lx - b)

    ``L`` is anything :func:`~proxtpu_torch.ops.linops.as_linop` takes (a
    2-D tensor or an operator); ``b`` a number or a tensor like ``L x``.
    The tight-frame condition is the caller's contract (not checked)."""

    f: object
    L: object
    mu: object = 1.0
    b: object = 0.0

    is_convex = _traits_of("is_convex")  # affine maps keep convexity
    is_generalized_quadratic = _traits_of("is_generalized_quadratic")

    def _op(self):
        from ..ops.linops import as_linop

        return as_linop(self.L)

    def _affine(self, x):
        return tree_map(lambda l: l + self.b, self._op().matvec(x))

    def __call__(self, x):
        return self.f(self._affine(x))

    def value_and_gradient(self, x):
        v, gy = value_and_gradient(self.f, self._affine(x))
        return v, self._op().rmatvec(gy)

    def prox(self, x, gamma):
        y = self._affine(x)
        z, f_z = self.f.prox(y, self.mu * gamma)
        d = self._op().rmatvec(tree_sub(z, y))
        return tree_map(lambda xl, dl: xl + dl / self.mu, x, d), f_z


@proxclass
class MoreauEnvelope:
    """The Moreau envelope f^gamma(x) = min_z f(z) + ||z - x||^2 / (2
    gamma), smooth with gradient (x - prox_{gamma f}(x)) / gamma."""

    f: object
    gamma: object = 1.0

    is_convex = True
    is_generalized_quadratic = False

    def value_and_gradient(self, x):
        z, f_z = self.f.prox(x, self.gamma)
        d = tree_sub(x, z)
        val = f_z + tree_vdot_real(d, d) / (2 * self.gamma)
        return val, tree_scale(1 / self.gamma, d)

    def __call__(self, x):
        return self.value_and_gradient(x)[0]


@proxclass
class Tilt:
    """g(x) = f(x) + Re<a, x> + b, a linear tilt of f; the prox shifts the
    argument, prox_{gamma g}(x) = prox_{gamma f}(x - gamma a).  ``a``
    matches the iterate's structure.  Graphical lasso takes the prox of
    tr(S X) - logdet(X) as ``Tilt(NegLogDet(1.0), S)``."""

    f: object
    a: object
    b: object = 0.0

    is_convex = _traits_of("is_convex")
    is_generalized_quadratic = _traits_of("is_generalized_quadratic")

    def _lin(self, z):
        return tree_vdot_real(self.a, z) + self.b

    def __call__(self, x):
        return self.f(x) + self._lin(x)

    def value_and_gradient(self, x):
        v, g = value_and_gradient(self.f, x)
        return v + self._lin(x), tree_map(lambda gl, al: gl + _as(al, gl),
                                          g, self.a)

    def prox(self, x, gamma):
        y = tree_map(lambda xl, al: xl - gamma * _as(al, xl), x, self.a)
        z, f_z = self.f.prox(y, gamma)
        return z, f_z + self._lin(z)


@proxclass
class Regularize:
    """g(x) = f(x) + (rho/2) ||x - a||^2; the prox reduces to f's:

        prox_{gamma g}(x) = prox_{gamma' f}((x + gamma rho a) / (1 + gamma
        rho)),  gamma' = gamma / (1 + gamma rho)"""

    f: object
    rho: object = 1.0
    a: object = 0.0

    is_convex = _traits_of("is_convex")
    is_generalized_quadratic = _traits_of("is_generalized_quadratic")

    def _quad(self, z):
        d = tree_map(lambda zl: zl - _as(self.a, zl), z)
        return (self.rho / 2) * tree_vdot_real(d, d)

    def __call__(self, x):
        return self.f(x) + self._quad(x)

    def value_and_gradient(self, x):
        v, g = value_and_gradient(self.f, x)
        grad = tree_map(lambda gl, xl: gl + self.rho * (xl - _as(self.a, xl)),
                        g, x)
        return v + self._quad(x), grad

    def prox(self, x, gamma):
        den = 1 + gamma * self.rho
        y = tree_map(lambda xl: (xl + gamma * self.rho * _as(self.a, xl))
                     / den, x)
        z, f_z = self.f.prox(y, gamma / den)
        return z, f_z + self._quad(z)


@proxclass
class PointwiseMinimum:
    """g(x) = min_i f_i(x), e.g. the indicator of a union of sets
    (nonconvex).  The prox takes, among z_i = prox_{gamma f_i}(x), the one
    of least f_i(z_i) + ||z_i - x||^2 / (2 gamma); ties go to the earliest
    f_i."""

    fs: tuple

    def __post_init__(self):
        if not self.fs:
            raise ValueError("PointwiseMinimum needs at least one term")

    is_convex = False
    is_generalized_quadratic = False

    def __call__(self, x):
        out = self.fs[0](x)
        for f in self.fs[1:]:
            out = torch.minimum(out, f(x))
        return out

    def prox(self, x, gamma):
        def objective(z, v):
            d = tree_sub(z, x)
            return v + tree_vdot_real(d, d) / (2 * gamma)

        best_z, best_v = self.fs[0].prox(x, gamma)
        best_obj = objective(best_z, best_v)
        for f in self.fs[1:]:
            z, v = f.prox(x, gamma)
            obj = objective(z, v)
            take = obj < best_obj
            best_z = tree_where(take, z, best_z)
            best_v = torch.where(take, v, best_v)
            best_obj = torch.minimum(obj, best_obj)
        return best_z, best_v


@proxclass
class PrecomposeDiagonal:
    """g(x) = f(a .* x + b) for an elementwise nonzero scaling ``a`` and a
    shift ``b``, with f separable; the prox decouples per coordinate,

        prox_{gamma g}(x) = (prox_{gamma |a|^2 f}(a x + b) - b) / a,

    so f's prox must take an array gamma (every separable function here
    does).  Both conditions are the caller's contract."""

    f: object
    a: object
    b: object = 0.0

    is_convex = _traits_of("is_convex")
    is_generalized_quadratic = _traits_of("is_generalized_quadratic")

    def _affine(self, x):
        return tree_map(lambda xl: self.a * xl + self.b, x)

    def __call__(self, x):
        return self.f(self._affine(x))

    def value_and_gradient(self, x):
        v, gy = value_and_gradient(self.f, self._affine(x))
        return v, tree_map(lambda gl: _conj(self.a) * gl, gy)

    def prox(self, x, gamma):
        z, f_z = self.f.prox(self._affine(x), gamma * abs(self.a) ** 2)
        return tree_map(lambda zl: (zl - self.b) / self.a, z), f_z


@proxclass
class Sum:
    """g(x) = sum_i f_i(x) as a smooth term only (the sum of proxes is not
    the prox of the sum): value and gradient, no prox."""

    fs: tuple

    def __post_init__(self):
        if not self.fs:
            raise ValueError("Sum needs at least one term")

    is_convex = _all_of("is_convex")
    is_generalized_quadratic = _all_of("is_generalized_quadratic")

    def __call__(self, x):
        out = self.fs[0](x)
        for f in self.fs[1:]:
            out = out + f(x)
        return out

    def value_and_gradient(self, x):
        v, g = value_and_gradient(self.fs[0], x)
        for f in self.fs[1:]:
            vi, gi = value_and_gradient(f, x)
            v = v + vi
            g = tree_map(torch.add, g, gi)
        return v, g
