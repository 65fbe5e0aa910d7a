"""Proximable and smooth functions (counterpart of a subset of
``proxtpu/prox/functions.py``): the terms the lasso, elastic-net and box-QP
routes take.  Each is a frozen dataclass whose tensor fields are the problem
data; a batch of functions is one object whose tensors carry a leading
batch axis, mapped lane by lane by the batched driver.  Every formula is
the JAX package's, so that float64 trajectories agree.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..utils.precision import pdot, pmatvec
from ..utils.tree import real_dtype_of, tree_leaves, tree_map, \
    tree_vdot_real
from .base import _rzero


def _rparam(p, x):
    """A parameter in the iterate's real dtype, on its device."""
    R = real_dtype_of(x)
    if isinstance(p, torch.Tensor):
        return p.to(R)
    return torch.tensor(p, dtype=R, device=tree_leaves(x)[0].device)


def _soft_threshold(x, thr):
    """Complex-safe soft-thresholding (prox of the l1 norm), the JAX
    package's formula."""
    absx = torch.abs(x)
    scale = torch.clamp(absx - thr, min=0) / torch.where(
        absx == 0, torch.ones_like(absx), absx)
    return x * scale.to(x.dtype)


def _vdot_real(a, b):
    return torch.real(torch.sum(a.conj() * b))


@dataclass(frozen=True)
class NormL1:
    """f(x) = lam * ||x||_1; ``lam`` may be an array of per-entry weights
    broadcasting against a single-tensor iterate."""

    lam: object = 1.0

    is_convex = True
    is_generalized_quadratic = False

    def __call__(self, x):
        lam = _rparam(self.lam, x)
        if lam.dim():
            (leaf,) = tree_leaves(x)
            return torch.sum(lam * torch.abs(leaf))
        return lam * sum(torch.sum(torch.abs(l)) for l in tree_leaves(x))

    def prox(self, x, gamma):
        lam = _rparam(self.lam, x)
        z = tree_map(lambda l: _soft_threshold(l, gamma * lam), x)
        return z, self(z)


@dataclass(frozen=True)
class SqrNormL2:
    """f(x) = lam/2 * ||x||^2, smooth and proximable."""

    lam: object = 1.0

    is_convex = True
    is_generalized_quadratic = True

    def __call__(self, x):
        return _rparam(self.lam, x) / 2 * tree_vdot_real(x, x)

    def value_and_gradient(self, x):
        lam = _rparam(self.lam, x)
        return self(x), tree_map(lambda l: lam * l, x)

    def prox(self, x, gamma):
        scale = 1 / (1 + gamma * _rparam(self.lam, x))
        z = tree_map(lambda l: scale * l, x)
        return z, self(z)


@dataclass(frozen=True)
class ElasticNet:
    """f(x) = mu*||x||_1 + lam/2*||x||^2."""

    mu: object = 1.0
    lam: object = 1.0

    is_convex = True
    is_generalized_quadratic = False

    def __call__(self, x):
        l1 = sum(torch.sum(torch.abs(l)) for l in tree_leaves(x))
        mu, lam = _rparam(self.mu, x), _rparam(self.lam, x)
        return mu * l1 + lam / 2 * tree_vdot_real(x, x)

    def prox(self, x, gamma):
        mu, lam = _rparam(self.mu, x), _rparam(self.lam, x)
        z = tree_map(
            lambda l: _soft_threshold(l, gamma * mu) / (1 + gamma * lam), x)
        return z, self(z)


@dataclass(frozen=True)
class IndBox:
    """Indicator of the box {low <= x <= high} (real dtypes)."""

    low: object
    high: object

    is_convex = True
    is_generalized_quadratic = False

    def __call__(self, x):
        ok = torch.ones((), dtype=torch.bool,
                        device=tree_leaves(x)[0].device)
        for l in tree_leaves(x):
            ok = ok & torch.all(l >= self.low) & torch.all(l <= self.high)
        zero = _rzero(x)
        return torch.where(ok, zero, torch.full_like(zero, float("inf")))

    def prox(self, x, gamma):
        z = tree_map(lambda l: torch.clamp(l, self.low, self.high), x)
        return z, _rzero(x)


@dataclass(frozen=True)
class LeastSquares:
    """f(x) = lam/2 * ||A x - b||^2, smooth and proximable.

    The prox solves (I + c A^H A) z = x + c A^H b with c = lam*gamma
    through an eigendecomposition of the smaller Gram matrix made once
    (Woodbury when A is wide).  Build it with :func:`make_least_squares`.
    """

    A: object
    b: object
    lam: object
    U: object  # eigenvectors of the smaller Gram matrix
    s: object  # its eigenvalues
    Atb: object
    wide: bool  # m < n: the Woodbury path

    is_convex = True
    is_generalized_quadratic = True

    def __call__(self, x):
        r = pdot(self.A, x) - self.b
        return _rparam(self.lam, x) / 2 * _vdot_real(r, r)

    def value_and_gradient(self, x):
        r = pdot(self.A, x) - self.b
        lam = _rparam(self.lam, x)
        return lam / 2 * _vdot_real(r, r), lam * pdot(self.A.mH, r)

    def prox(self, x, gamma):
        c = _rparam(self.lam, x) * gamma
        rhs = x + c * self.Atb
        if self.wide:
            # (I + c A^H A)^{-1} v = v - c A^H (I + c A A^H)^{-1} A v
            w = pdot(self.A, rhs)
            w = pdot(self.U, (pdot(self.U.mH, w) / (1 + c * self.s))
                     .to(w.dtype))
            z = rhs - c * pdot(self.A.mH, w)
        else:
            z = pdot(self.U, (pdot(self.U.mH, rhs) / (1 + c * self.s))
                     .to(rhs.dtype))
        return z, self(z)


def make_least_squares(A, b, lam=1.0):
    A = torch.as_tensor(A)
    b = torch.as_tensor(b)
    m, n = A.shape
    wide = m < n
    gram = pdot(A, A.mH) if wide else pdot(A.mH, A)
    s, U = torch.linalg.eigh(gram)
    return LeastSquares(A, b, lam, U, s, pdot(A.mH, b), wide)


@dataclass(frozen=True)
class LeastSquaresLoss:
    """f(x) = lam/2 ||A x - b||^2 as a smooth-only oracle (no prox, nothing
    factorised): the batched form the FB family needs."""

    A: object
    b: object
    lam: object = 1.0

    is_convex = True
    is_generalized_quadratic = True

    def __call__(self, x):
        r = pdot(self.A, x) - self.b
        return _rparam(self.lam, x) / 2 * _vdot_real(r, r)

    def value_and_gradient(self, x):
        r = pdot(self.A, x) - self.b
        lam = _rparam(self.lam, x)
        return lam / 2 * _vdot_real(r, r), lam * pdot(self.A.mH, r)


@dataclass(frozen=True)
class Quadratic:
    """f(x) = x'Qx/2 + q'x with a hand-written gradient; Q may be
    indefinite (the nonconvex box-QP family)."""

    Q: object
    q: object

    is_convex = False
    is_generalized_quadratic = True

    def __call__(self, x):
        return (_vdot_real(x, pmatvec(self.Q, x)) / 2
                + tree_vdot_real(self.q, x))

    def value_and_gradient(self, x):
        Qx = pmatvec(self.Q, x)
        val = _vdot_real(x, Qx) / 2 + tree_vdot_real(self.q, x)
        return val, Qx + self.q
