"""Proximable and smooth functions (counterpart of
``proxtpu/prox/functions.py``, every function of it).  Each is a frozen
dataclass whose tensor fields are the problem data; a batch of functions
is one object whose tensors carry a leading batch axis, mapped lane by lane
by the batched driver.  Every formula is the JAX package's, so that
float64 trajectories agree, but the capped-simplex projection's (see
:func:`_capped_simplex_proj`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..utils.loops import vmap_while
from ..utils.precision import pdot, pmatvec
from ..utils.tree import real_dtype_of, tree_inf_norm, tree_leaves, \
    tree_map, tree_norm, tree_scale, tree_sub, tree_vdot_real
from .base import _rzero, proxclass, value_and_gradient


def _rparam(p, x):
    """A parameter in the iterate's real dtype, on its device.  A number
    becomes a tensor by a fill on the device, not a copy from the host,
    which on a GPU would wait for the device at every call."""
    R = real_dtype_of(x)
    if isinstance(p, torch.Tensor):
        return p.to(R)
    return torch.full((), p, dtype=R, device=tree_leaves(x)[0].device)


def _soft_threshold(x, thr):
    """Complex-safe soft-thresholding (prox of the l1 norm), the JAX
    package's formula."""
    absx = torch.abs(x)
    scale = torch.clamp(absx - thr, min=0) / torch.where(
        absx == 0, torch.ones_like(absx), absx)
    return x * scale.to(x.dtype)


def _vdot_real(a, b):
    return torch.real(torch.sum(a.conj() * b))


@proxclass
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


@proxclass(meta_fields=("axis",))
class NormL21:
    """f(Y) = lam * sum_j ||Y[:, j]||_2, the isotropic group l2,1 norm over
    ``axis`` (group soft-thresholding prox).  With Y the (2, H, W)
    forward-difference field of
    :class:`~proxtpu_torch.ops.linops.Grad2DOperator`, ``NormL21(lam,
    axis=0)`` is isotropic total variation.  ``axis`` is fixed, not data."""

    lam: object = 1.0
    axis: int = 0

    is_convex = True
    is_generalized_quadratic = False

    def __call__(self, Y):
        nrm = torch.sqrt(torch.sum(torch.abs(Y) ** 2, dim=self.axis))
        return _rparam(self.lam, Y) * torch.sum(nrm)

    def prox(self, Y, gamma):
        lam = _rparam(self.lam, Y)
        nrm = torch.sqrt(torch.sum(torch.abs(Y) ** 2, dim=self.axis,
                                   keepdim=True))
        scale = torch.clamp(
            1 - gamma * lam / torch.where(nrm == 0, torch.ones_like(nrm),
                                          nrm), min=0)
        Z = Y * scale.to(Y.dtype)
        return Z, self(Z)


@proxclass
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


@proxclass
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


@proxclass
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
        return _indicator(ok, x)

    def prox(self, x, gamma):
        z = tree_map(lambda l: torch.clamp(l, self.low, self.high), x)
        return z, _rzero(x)


@proxclass
class Linear:
    """f(x) = <c, x>."""

    c: object

    is_convex = True
    is_generalized_quadratic = True

    def __call__(self, x):
        return tree_vdot_real(self.c, x)

    def value_and_gradient(self, x):
        return self(x), self.c

    def prox(self, x, gamma):
        z = tree_map(lambda xl, cl: xl - gamma * cl, x, self.c)
        return z, self(z)


def IndNonnegative():
    """Indicator of the nonnegative orthant."""
    return IndBox(0.0, float("inf"))


def _indicator(ok, x):
    zero = _rzero(x)
    return torch.where(ok, zero, torch.full_like(zero, float("inf")))


@proxclass
class IndPoint:
    """Indicator of the singleton {p}."""

    p: object

    is_convex = True
    is_generalized_quadratic = True

    def __call__(self, x):
        return _indicator(tree_inf_norm(tree_sub(x, self.p)) == 0, x)

    def prox(self, x, gamma):
        return self.p, _rzero(x)


@proxclass
class IndAffine:
    """Indicator of {x : Ax = b}; its prox is the affine projection through
    the Cholesky factor of A A^H, made once by :func:`make_ind_affine`."""

    A: object
    b: object
    chol: object

    is_convex = True
    is_generalized_quadratic = True

    def __call__(self, x):
        eps = torch.finfo(real_dtype_of(x)).eps
        feas = torch.amax(torch.abs(pdot(self.A, x) - self.b)) <= 1e3 * eps
        return _indicator(feas, x)

    def prox(self, x, gamma):
        resid = pdot(self.A, x) - self.b
        w = torch.cholesky_solve(resid.unsqueeze(-1), self.chol).squeeze(-1)
        return x - pdot(self.A.mH, w), _rzero(x)


def make_ind_affine(A, b):
    A = torch.as_tensor(A)
    b = torch.as_tensor(b)
    return IndAffine(A, b, torch.linalg.cholesky(pdot(A, A.mH)))


@proxclass(meta_fields=("wide",))
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
    """The Gram matrix is factored in double precision and the factors are
    kept in A's dtype: the prox is only as exact as the eigen-pairs.  With
    single-precision factors, DRLS's float32 answer on ``lasso_medium``
    rechecked at 5.6e-3 on an H100, against the JAX package's 2.8e-4 on
    the CPU.

    On DTensors in row stripes over one mesh axis (the JAX package's
    spelling of the tp layout) the factors are made from the stripes
    (:func:`~proxtpu_torch.parallel.sharded_ops.least_squares_on_stripes`).
    """
    from ..parallel import sharded_ops

    if sharded_ops._is_dtensor(A) or sharded_ops._is_dtensor(b):
        return sharded_ops.least_squares_on_stripes(A, b, lam)
    A = torch.as_tensor(A)
    b = torch.as_tensor(b)
    m, n = A.shape
    wide = m < n
    Ad = A.to(torch.complex128 if A.is_complex() else torch.float64)
    gram = pdot(Ad, Ad.mH) if wide else pdot(Ad.mH, Ad)
    s, U = torch.linalg.eigh(gram)
    return LeastSquares(A, b, lam, U.to(A.dtype), s.to(real_dtype_of(A)),
                        pdot(A.mH, b), wide)


@proxclass
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


@proxclass
class Translate:
    """g(x) = f(x + t)."""

    f: object
    t: object

    @property
    def is_convex(self):
        return getattr(self.f, "is_convex", False)

    @property
    def is_generalized_quadratic(self):
        return getattr(self.f, "is_generalized_quadratic", False)

    def __call__(self, x):
        return self.f(tree_map(torch.add, x, self.t))

    def value_and_gradient(self, x):
        return value_and_gradient(self.f, tree_map(torch.add, x, self.t))

    def prox(self, x, gamma):
        z_shift, f_z = self.f.prox(tree_map(torch.add, x, self.t), gamma)
        return tree_map(torch.sub, z_shift, self.t), f_z


@proxclass
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


@proxclass
class SqrDistance:
    """f(x) = ||x - b||^2 / 2, smooth and proximable."""

    b: object

    is_convex = True
    is_generalized_quadratic = True

    def __call__(self, x):
        d = tree_sub(x, self.b)
        return tree_vdot_real(d, d) / 2

    def value_and_gradient(self, x):
        d = tree_sub(x, self.b)
        return tree_vdot_real(d, d) / 2, d

    def prox(self, x, gamma):
        z = tree_map(lambda xl, bl: (xl + gamma * bl) / (1 + gamma), x,
                     self.b)
        return z, self(z)


# ---------------------------------------------------------------------------
# the rest of the JAX package's catalogue: helpers


def _leaf(x):
    """The single tensor of a one-leaf iterate."""
    (leaf,) = tree_leaves(x)
    return leaf


def _like(x, z):
    """``z`` in the place of the single leaf of ``x``."""
    return tree_map(lambda _: z, x)


def _max_abs0(t):
    """``jnp.max(jnp.abs(t), initial=0.0)``: 0 for an empty ``t``."""
    if t.numel() == 0:
        return torch.zeros((), dtype=t.abs().dtype, device=t.device)
    return torch.amax(torch.abs(t))


def _one_where_zero(t):
    return torch.where(t == 0, torch.ones_like(t), t)


def _big(like):
    """``log(finfo(dtype).max) * 0.98`` in ``like``'s dtype, on its device:
    the clip that keeps ``exp`` finite."""
    return torch.full((), torch.finfo(like.dtype).max, dtype=like.dtype,
                      device=like.device).log() * 0.98


def _inf_like(x):
    return torch.full_like(_rzero(x), float("inf"))


# ---------------------------------------------------------------------------
# norms, losses and closed-form projections


@proxclass
class NormL2:
    """f(x) = lam * ||x||_2 (block soft-thresholding prox)."""

    lam: object = 1.0

    is_convex = True
    is_generalized_quadratic = False

    def __call__(self, x):
        return _rparam(self.lam, x) * tree_norm(x)

    def prox(self, x, gamma):
        nrm = tree_norm(x)
        lam = _rparam(self.lam, x)
        scale = torch.clamp(1 - gamma * lam / _one_where_zero(nrm), min=0)
        z = tree_scale(scale, x)
        return z, self(z)


_WIDER = {torch.float32: torch.float64, torch.complex64: torch.complex128}


def _singular(X, fn=None, floor=None):
    """``(U diag(fn(s)) V^H, s)`` of the thin SVD ``X = U diag(s) V^H``
    (s descending, in X's real dtype); ``fn=None`` returns ``(None, s)``.
    The one way ``NuclearNorm``, ``IndStiefel`` and ``IndRank`` (and their
    values) decompose X.

    On the CPU it is ``torch.linalg.svd`` (LAPACK) in X's dtype.  On the
    card a float32 or complex64 X is decomposed in float64 or complex128
    and the result cast back: cuSOLVER's default float32 driver is about
    ten times less accurate than LAPACK in float32, enough to hold robust
    PCA at its cap (PERF.md, the table of SVD ways;
    ``tools/svd_ways.py``).  Where ``fn`` vanishes at and under ``floor``
    (the nuclear norm's shrinkage) the card takes the Gram form instead:
    a batched ``eigh`` of ``X^H X`` (or ``X X^H``) gives V and s^2, and
    ``Z = X V diag(fn(s) / s) V^H``; every singular value under the floor
    drops out, so the small ones, which the Gram matrix resolves poorly,
    never matter.  It needs no U and is the fastest of the ways measured."""
    wide = _WIDER.get(X.dtype) if X.device.type != "cpu" else None
    R = real_dtype_of(X)
    if wide is not None and fn is not None and floor is not None:
        Z, s = _gram_form(X.to(wide), fn, floor)
        return Z.to(X.dtype), s.to(R)
    Xw = X if wide is None else X.to(wide)
    if fn is None:
        return None, torch.linalg.svdvals(Xw).to(R)
    U, s, Vh = torch.linalg.svd(Xw, full_matrices=False)
    Z = pdot(U * fn(s).unsqueeze(-2).to(U.dtype), Vh)
    return Z.to(X.dtype), s.to(R)


def _gram_form(X, fn, floor):
    """``(X V diag(fn(s) / s) V^H, s)`` from ``eigh`` of the smaller Gram
    matrix of X (``X^H X``, or ``X X^H`` for a wide X, whose eigenvectors
    are then U and the product is taken from the left); the singular values
    at or under ``floor`` get 0."""
    tall = X.shape[-2] >= X.shape[-1]
    w, V = torch.linalg.eigh(pdot(X.mH, X) if tall else pdot(X, X.mH))
    s = torch.sqrt(torch.clamp(w, min=0)).flip(-1)
    V = V.flip(-1)
    big = s > floor
    scale = torch.where(big, fn(s) / torch.where(big, s, 1), 0)
    P = pdot(V * scale.unsqueeze(-2).to(V.dtype), V.mH)
    return (pdot(X, P) if tall else pdot(P, X)), s


@proxclass
class NuclearNorm:
    """f(X) = lam * ||X||_* (sum of singular values); the prox
    soft-thresholds the singular values (:func:`_singular`; X is a 2-D
    leaf).  The SVD's signs and order of singular vectors do not change
    U diag(s') V^H."""

    lam: object = 1.0

    is_convex = True
    is_generalized_quadratic = False

    def __call__(self, X):
        return _rparam(self.lam, X) * torch.sum(_singular(X)[1])

    def prox(self, X, gamma):
        lam = _rparam(self.lam, X)
        t = gamma * lam
        Z, s = _singular(X, lambda s: torch.clamp(s - t, min=0), floor=t)
        return Z, lam * torch.sum(torch.clamp(s - t, min=0))


def _softplus(v):
    """``jax.nn.softplus``: log(1 + e^v) as ``logaddexp(v, 0)`` at every v
    (``torch.nn.functional.softplus`` returns v itself above its
    threshold, a few 1e-9 off in float64)."""
    return torch.logaddexp(v, torch.zeros_like(v))


@proxclass
class LogisticLoss:
    """f(u) = scale * sum(softplus(-u)): the logistic loss with all-one
    labels; gradient scale * (sigmoid(u) - 1)."""

    scale: object = 1.0

    is_convex = True
    is_generalized_quadratic = False

    def __call__(self, u):
        scale = _rparam(self.scale, u)
        return scale * sum(torch.sum(_softplus(-l)) for l in tree_leaves(u))

    def value_and_gradient(self, u):
        scale = _rparam(self.scale, u)
        grad = tree_map(lambda l: scale * (torch.sigmoid(l) - 1), u)
        return self(u), grad


@proxclass
class HuberLoss:
    """f(x) = mu * (||x||^2/2 if ||x|| <= rho else rho(||x|| - rho/2)):
    smooth with a hand gradient, and proximable."""

    rho: object = 1.0
    mu: object = 1.0

    is_convex = True
    is_generalized_quadratic = False

    def _value(self, nrm, rho, mu):
        return mu * torch.where(nrm <= rho, nrm * nrm / 2,
                                rho * (nrm - rho / 2))

    def __call__(self, x):
        rho, mu = _rparam(self.rho, x), _rparam(self.mu, x)
        return self._value(tree_norm(x), rho, mu)

    def value_and_gradient(self, x):
        rho, mu = _rparam(self.rho, x), _rparam(self.mu, x)
        nrm = tree_norm(x)
        scale = mu * torch.where(nrm <= rho, torch.ones_like(nrm),
                                 rho / torch.maximum(nrm, rho))
        return self._value(nrm, rho, mu), tree_scale(scale, x)

    def prox(self, x, gamma):
        rho, mu = _rparam(self.rho, x), _rparam(self.mu, x)
        nrm = tree_norm(x)
        c = gamma * mu
        # quadratic region: shrink by 1/(1+c); linear region: radial step
        scale = torch.where(nrm <= rho * (1 + c), 1 / (1 + c),
                            1 - c * rho / torch.maximum(nrm, rho * (1 + c)))
        z = tree_scale(scale, x)
        return z, self(z)


@proxclass
class IndSimplex:
    """Indicator of the simplex {x >= 0, sum x = a}; the prox is the
    sorted-threshold projection (one sort, one cumulative sum; a single
    flat vector)."""

    a: object = 1.0

    is_convex = True
    is_generalized_quadratic = False

    def __call__(self, x):
        R = real_dtype_of(x)
        a = _rparam(self.a, x)
        eps = torch.finfo(R).eps
        leaves = tree_leaves(x)
        s = sum(torch.sum(l) for l in leaves)
        ok = torch.ones((), dtype=torch.bool, device=leaves[0].device)
        for l in leaves:
            ok = ok & torch.all(l >= -1e3 * eps)
        ok = ok & (torch.abs(s - a) <= 1e3 * eps * (1 + a))
        return _indicator(ok, x)

    def prox(self, x, gamma):
        leaf = _leaf(x)
        a = _rparam(self.a, leaf)
        n = leaf.shape[-1]
        u = torch.sort(leaf, descending=True).values
        css = torch.cumsum(u, -1) - a
        ks = torch.arange(1, n + 1, dtype=leaf.dtype, device=leaf.device)
        k = torch.sum((u - css / ks > 0).to(torch.int64), -1, keepdim=True)
        tau = torch.gather(css, -1, k - 1) / k.to(leaf.dtype)
        return _like(x, torch.clamp(leaf - tau, min=0)), _rzero(x)


@proxclass
class IndBallL2:
    """Indicator of the l2 ball {||x|| <= r}; the prox scales radially."""

    r: object = 1.0

    is_convex = True
    is_generalized_quadratic = False

    def __call__(self, x):
        r = _rparam(self.r, x)
        eps = torch.finfo(real_dtype_of(x)).eps
        return _indicator(tree_norm(x) <= r * (1 + 1e3 * eps), x)

    def prox(self, x, gamma):
        r = _rparam(self.r, x)
        nrm = tree_norm(x)
        scale = torch.where(nrm > r, r / torch.maximum(nrm, r),
                            torch.ones_like(nrm))
        return tree_scale(scale, x), _rzero(x)


@proxclass
class IndBallL1:
    """Indicator of the l1 ball {||x||_1 <= r}; projection through the
    simplex projection of |x|, the phase kept (``sgn``: x/|x| for complex
    x)."""

    r: object = 1.0

    is_convex = True
    is_generalized_quadratic = False

    def __call__(self, x):
        r = _rparam(self.r, x)
        eps = torch.finfo(real_dtype_of(x)).eps
        l1 = sum(torch.sum(torch.abs(l)) for l in tree_leaves(x))
        return _indicator(l1 <= r * (1 + 1e3 * eps), x)

    def prox(self, x, gamma):
        leaf = _leaf(x)
        r = _rparam(self.r, leaf)
        absx = torch.abs(leaf)
        inside = torch.sum(absx) <= r
        proj, _ = IndSimplex(r).prox(absx, gamma)
        z = torch.where(inside, leaf, torch.sgn(leaf) * proj)
        return _like(x, z), _rzero(x)


@proxclass
class SumPositive:
    """f(x) = sum(max(x, 0)); the prox shifts the positive entries down by
    gamma."""

    is_convex = True
    is_generalized_quadratic = False

    def __call__(self, x):
        return sum(torch.sum(torch.clamp(l, min=0)) for l in tree_leaves(x))

    def prox(self, x, gamma):
        z = tree_map(lambda l: torch.where(l > gamma, l - gamma,
                                           torch.clamp(l, max=0)), x)
        return z, self(z)


@proxclass
class NormL0:
    """f(x) = lam * ||x||_0 (nonconvex); the prox keeps the entries with
    |x_i| > sqrt(2 gamma lam)."""

    lam: object = 1.0

    is_convex = False
    is_generalized_quadratic = False

    def __call__(self, x):
        lam = _rparam(self.lam, x)
        R = real_dtype_of(x)
        return lam * sum(torch.sum((torch.abs(l) > 0).to(R))
                         for l in tree_leaves(x))

    def prox(self, x, gamma):
        thr = torch.sqrt(2 * gamma * _rparam(self.lam, x))
        z = tree_map(lambda l: torch.where(torch.abs(l) > thr, l,
                                           torch.zeros_like(l)), x)
        return z, self(z)


@proxclass
class HingeLoss:
    """f(x) = mu * sum_i max(0, 1 - y_i x_i), labels y in {-1, +1}; the
    separable prox: with v = y x, u = v where v >= 1, else
    min(v + mu gamma, 1); z = y u."""

    y: object
    mu: object = 1.0

    is_convex = True
    is_generalized_quadratic = False

    def __call__(self, x):
        mu = _rparam(self.mu, x)
        return mu * sum(
            torch.sum(torch.clamp(1 - yl * xl, min=0))
            for yl, xl in zip(tree_leaves(self.y), tree_leaves(x)))

    def prox(self, x, gamma):
        mu = _rparam(self.mu, x)

        def one(yl, xl):
            v = yl * xl
            return yl * torch.where(v >= 1, v,
                                    torch.clamp(v + mu * gamma, max=1))

        z = tree_map(one, self.y, x)
        return z, self(z)


@proxclass
class IndBallLinf:
    """Indicator of the l-inf ball {max_i |x_i| <= r}; the prox moves each
    entry onto the radius-r disk (complex-safe)."""

    r: object = 1.0

    is_convex = True
    is_generalized_quadratic = False

    def __call__(self, x):
        r = _rparam(self.r, x)
        eps = torch.finfo(real_dtype_of(x)).eps
        ok = torch.ones((), dtype=torch.bool,
                        device=tree_leaves(x)[0].device)
        for l in tree_leaves(x):
            # one-ULP projection roundoff stays feasible
            ok = ok & torch.all(torch.abs(l) <= r * (1 + 10 * eps))
        return _indicator(ok, x)

    def prox(self, x, gamma):
        r = _rparam(self.r, x)

        def clipd(l):
            scale = torch.clamp(r / _one_where_zero(torch.abs(l)), max=1.0)
            return l * scale.to(l.dtype)

        return tree_map(clipd, x), _rzero(x)


@proxclass
class NormLinf:
    """f(x) = lam * max_i |x_i|; the prox by the Moreau decomposition
    against the l1-ball projection, x - P_{B1(gamma lam)}(x)
    (complex-safe; a single leaf)."""

    lam: object = 1.0

    is_convex = True
    is_generalized_quadratic = False

    def __call__(self, x):
        return _rparam(self.lam, x) * tree_inf_norm(x)

    def prox(self, x, gamma):
        leaf = _leaf(x)
        lam = _rparam(self.lam, leaf)
        gamma = _rparam(gamma, leaf)
        p, _ = IndBallL1(gamma * lam).prox(leaf, gamma)
        zt = _like(x, leaf - p)
        return zt, self(zt)


@proxclass
class IndHalfspace:
    """Indicator of {<a, x> <= b} (real dtypes); the prox is the affine
    projection x - max(0, (<a,x> - b)/||a||^2) a."""

    a: object
    b: object = 0.0

    is_convex = True
    is_generalized_quadratic = False

    def __call__(self, x):
        b = _rparam(self.b, x)
        eps = torch.finfo(real_dtype_of(x)).eps
        slack = 100 * eps * (1 + torch.abs(b))
        return _indicator(tree_vdot_real(self.a, x) <= b + slack, x)

    def prox(self, x, gamma):
        b = _rparam(self.b, x)
        dot = tree_vdot_real(self.a, x)
        asq = tree_vdot_real(self.a, self.a)
        t = torch.clamp((dot - b) / _one_where_zero(asq), min=0)
        z = tree_map(lambda xl, al: xl - t * al, x, self.a)
        return z, _rzero(x)


@proxclass
class IndSphereL2:
    """Indicator of the l2 sphere {||x|| = r} (nonconvex); the prox scales
    radially, and 0 goes to r e_1 with e_1 in the first leaf only (a
    multi-leaf iterate lands on the sphere)."""

    r: object = 1.0

    is_convex = False
    is_generalized_quadratic = False

    def __call__(self, x):
        r = _rparam(self.r, x)
        eps = torch.finfo(real_dtype_of(x)).eps
        return _indicator(torch.abs(tree_norm(x) - r) <= 100 * eps * (1 + r),
                          x)

    def prox(self, x, gamma):
        r = _rparam(self.r, x)
        nrm = tree_norm(x)
        z = tree_map(lambda l: (r / _one_where_zero(nrm)).to(l.dtype) * l, x)
        fixed = []
        for i, l in enumerate(tree_leaves(z)):
            if i == 0:
                e1 = torch.zeros(l.numel(), dtype=l.dtype, device=l.device)
                e1[0] = 1
                fixed.append(torch.where(nrm == 0,
                                         r.to(l.dtype) * e1.reshape(l.shape),
                                         l))
            else:
                fixed.append(torch.where(nrm == 0, torch.zeros_like(l), l))
        it = iter(fixed)
        return tree_map(lambda _: next(it), z), _rzero(x)


@proxclass
class LogBarrier:
    """f(x) = -mu * sum_i log(x_i) on x > 0; the prox per coordinate
    z = (x + sqrt(x^2 + 4 gamma mu)) / 2."""

    mu: object = 1.0

    is_convex = True
    is_generalized_quadratic = False

    def __call__(self, x):
        mu = _rparam(self.mu, x)
        leaves = tree_leaves(x)
        ok = torch.ones((), dtype=torch.bool, device=leaves[0].device)
        val = _rzero(x)
        for l in leaves:
            ok = ok & torch.all(l > 0)
            val = val - mu * torch.sum(torch.log(
                torch.where(l > 0, l, torch.ones_like(l))))
        return torch.where(ok, val, _inf_like(x))

    def value_and_gradient(self, x):
        mu = _rparam(self.mu, x)
        return self(x), tree_map(lambda l: -mu / l, x)

    def prox(self, x, gamma):
        mu = _rparam(self.mu, x)
        z = tree_map(lambda l: (l + torch.sqrt(l * l + 4 * gamma * mu)) / 2,
                     x)
        return z, self(z)


@proxclass
class IndSOC:
    """Indicator of the second-order cone {(t, x) : ||x|| <= t} on a flat
    vector whose first entry is t; closed-form projection (real, one
    leaf)."""

    is_convex = True
    is_generalized_quadratic = False

    def __call__(self, x):
        leaf = _leaf(x)
        eps = torch.finfo(real_dtype_of(leaf)).eps
        nrm = torch.sqrt(torch.sum(leaf[1:] * leaf[1:]))
        return _indicator(nrm <= leaf[0] * (1 + 10 * eps) + 10 * eps, x)

    def prox(self, x, gamma):
        leaf = _leaf(x)
        t, v = leaf[0], leaf[1:]
        nrm = torch.sqrt(torch.sum(v * v))
        alpha = (t + nrm) / 2
        z_mid = torch.cat([alpha.unsqueeze(0),
                           alpha / _one_where_zero(nrm) * v])
        z = torch.where(nrm <= t, leaf,
                        torch.where(nrm <= -t, torch.zeros_like(leaf), z_mid))
        return _like(x, z), _rzero(x)


@proxclass
class NormL1plusL2:
    """f(x) = lam1 ||x||_1 + lam2 ||x||_2; the prox is the l2 block
    shrink after the l1 soft threshold (complex-safe)."""

    lam1: object = 1.0
    lam2: object = 1.0

    is_convex = True
    is_generalized_quadratic = False

    def __call__(self, x):
        lam1, lam2 = _rparam(self.lam1, x), _rparam(self.lam2, x)
        leaves = tree_leaves(x)
        l1 = sum(torch.sum(torch.abs(l)) for l in leaves)
        sq = sum(torch.sum(torch.abs(l) ** 2) for l in leaves)
        return lam1 * l1 + lam2 * torch.sqrt(sq)

    def prox(self, x, gamma):
        lam1 = _rparam(self.lam1, x)
        u = tree_map(lambda l: _soft_threshold(l, gamma * lam1), x)
        z, _ = NormL2(self.lam2).prox(u, gamma)
        return z, self(z)


@proxclass(meta_fields=("k",))
class IndBallL0:
    """Indicator of {||x||_0 <= k} (nonconvex); the prox keeps the k
    largest magnitudes, ties to the lower index (stable sort).  One leaf;
    ``k`` is fixed."""

    k: int = 1

    is_convex = False
    is_generalized_quadratic = False

    def __call__(self, x):
        return _indicator(torch.sum(torch.abs(_leaf(x)) > 0) <= self.k, x)

    def prox(self, x, gamma):
        leaf = _leaf(x)
        flat = leaf.reshape(-1)
        order = torch.argsort(-torch.abs(flat), stable=True)
        keep = torch.zeros(flat.shape, dtype=torch.bool,
                           device=flat.device).scatter(0, order[:self.k],
                                                       True)
        z = torch.where(keep, flat, torch.zeros_like(flat))
        return _like(x, z.reshape(leaf.shape)), _rzero(x)


@proxclass
class DistL2:
    """f(x) = lam * dist_C(x) for a convex set C given by an indicator with
    an exact projection; the prox moves toward the projection by
    min(1, gamma lam / dist) of the way."""

    ind: object
    lam: object = 1.0

    @property
    def is_convex(self):
        return getattr(self.ind, "is_convex", False)

    is_generalized_quadratic = False

    def _proj_dist(self, x):
        p, _ = self.ind.prox(x, 1.0)
        d = tree_sub(x, p)
        return p, torch.sqrt(tree_vdot_real(d, d))

    def __call__(self, x):
        return _rparam(self.lam, x) * self._proj_dist(x)[1]

    def prox(self, x, gamma):
        lam = _rparam(self.lam, x)
        gamma = _rparam(gamma, x)
        p, d = self._proj_dist(x)
        step = torch.clamp(gamma * lam / _one_where_zero(d), max=1.0)
        z = tree_map(lambda xl, pl: xl + step.to(xl.dtype) * (pl - xl), x, p)
        return z, lam * torch.clamp(d - gamma * lam, min=0)


@proxclass
class SqrHingeLoss:
    """f(x) = mu * sum_i max(0, 1 - y_i x_i)^2: smooth, and proximable in
    closed form for any y (active coordinates solve
    (1 + 2 mu gamma y^2) z = x + 2 mu gamma y)."""

    y: object
    mu: object = 1.0

    is_convex = True
    is_generalized_quadratic = False

    def __call__(self, x):
        mu = _rparam(self.mu, x)
        return mu * sum(
            torch.sum(torch.clamp(1 - yl * xl, min=0) ** 2)
            for yl, xl in zip(tree_leaves(self.y), tree_leaves(x)))

    def value_and_gradient(self, x):
        mu = _rparam(self.mu, x)
        g = tree_map(
            lambda yl, xl: -2 * mu * yl * torch.clamp(1 - yl * xl, min=0),
            self.y, x)
        return self(x), g

    def prox(self, x, gamma):
        mu = _rparam(self.mu, x)

        def one(yl, xl):
            zl = (xl + 2 * mu * gamma * yl) / (1 + 2 * mu * gamma * yl * yl)
            return torch.where(yl * xl >= 1, xl, zl)

        z = tree_map(one, self.y, x)
        return z, self(z)


def _clip(v, lo, hi):
    """``jnp.clip``: min(max(v, lo), hi); each bound a number or a
    tensor (a number makes no tensor: these run in inner loops)."""
    return torch.clamp(torch.clamp(v, min=lo), max=hi)


def _capped_simplex_proj(y, cap, total):
    """Projection of the flat vector y onto {0 <= s <= cap, sum s = total}:
    s = clip(y - tau, 0, cap) at the tau where
    phi(tau) = sum_i clip(y_i - tau, 0, cap) equals ``total``.

    phi is continuous, piecewise linear and non-increasing, with its
    breakpoints at the y_i and y_i - cap.  The JAX package finds tau by 100
    halvings of [min(y) - cap, max(y)]; the port computes phi at the 2n
    breakpoints at once (y sorted, prefix sums, ``searchsorted``), takes the
    segment where phi crosses ``total`` and solves for tau on it.  The
    projection is the same to rounding, in some 40 tensor operations
    instead of 900: under ``torch.func.vmap`` on the card each operation
    costs host time (``python -m proxtpu_torch.tools.families`` times
    min-CVaR's Chambolle-Pock iteration both ways)."""
    n = y.shape[-1]
    ys = torch.sort(y).values
    csum = F.pad(torch.cumsum(ys, -1), (1, 0))  # sums of the i smallest

    def phi(tau):
        # y_i <= tau: 0; y_i >= tau + cap: cap; in between: y_i - tau
        lo = torch.searchsorted(ys, tau, right=True)
        hi = torch.searchsorted(ys, tau + cap)
        return (cap * (n - hi) + csum.gather(-1, hi) - csum.gather(-1, lo)
                - tau * (hi - lo))

    t = torch.sort(torch.cat([ys - cap, ys], -1)).values
    s = phi(t)  # non-increasing along t
    j = torch.clamp(torch.sum(s >= total, -1, keepdim=True) - 1, 0, 2 * n - 2)
    seg = torch.cat([j, j + 1], -1)
    (t_lo, t_hi), (s_lo, s_hi) = t.gather(-1, seg).unbind(-1), \
        s.gather(-1, seg).unbind(-1)
    drop = s_lo - s_hi  # (active entries) * (t_hi - t_lo)
    tau = t_lo + (s_lo - total) * (t_hi - t_lo) / torch.where(
        drop > 0, drop, torch.ones_like(drop))
    return _clip(y - tau.unsqueeze(-1), 0.0, cap)


@proxclass(meta_fields=("k",))
class IndCappedSimplex:
    """Indicator of {0 <= x <= cap, sum x = k cap}; projection by the clip
    threshold (:func:`_capped_simplex_proj`).  One
    real leaf; ``k`` is fixed and must lie in 1..size."""

    k: int = 1
    cap: object = 1.0

    is_convex = True
    is_generalized_quadratic = False

    def _check_k(self, leaf):
        if not 1 <= self.k <= leaf.numel():
            raise ValueError(
                f"IndCappedSimplex(k={self.k}) on a size-{leaf.numel()} "
                "iterate: the set {0<=x<=cap, sum x = k*cap} is empty "
                "unless 1 <= k <= size")

    def __call__(self, x):
        leaf = _leaf(x)
        self._check_k(leaf)
        cap = _rparam(self.cap, leaf)
        eps = torch.finfo(real_dtype_of(leaf)).eps
        tol = 1e3 * eps * (1 + self.k) * torch.clamp(cap, min=1)
        ok = (torch.all(leaf >= -tol) & torch.all(leaf <= cap + tol)
              & (torch.abs(torch.sum(leaf) - self.k * cap)
                 <= tol * leaf.numel()))
        return _indicator(ok, x)

    def prox(self, x, gamma):
        leaf = _leaf(x)
        self._check_k(leaf)
        cap = _rparam(self.cap, leaf)
        z = _capped_simplex_proj(leaf.reshape(-1), cap, self.k * cap)
        return _like(x, z.reshape(leaf.shape)), _rzero(x)


@proxclass(meta_fields=("k",))
class SumLargest:
    """f(x) = lam * (sum of the k largest entries of x); the prox by the
    Moreau decomposition against the capped simplex,
    x - P_{0 <= s <= gamma lam, sum s = gamma lam k}(x).  One real leaf;
    ``k`` is fixed.  k = 1 is :func:`Maximum`."""

    k: int = 1
    lam: object = 1.0

    is_convex = True
    is_generalized_quadratic = False

    def __call__(self, x):
        leaf = _leaf(x)
        top = torch.topk(leaf.reshape(-1), self.k).values
        return _rparam(self.lam, leaf) * torch.sum(top)

    def prox(self, x, gamma):
        leaf = _leaf(x)
        if not 1 <= self.k <= leaf.numel():
            raise ValueError(
                f"SumLargest(k={self.k}) on a size-{leaf.numel()} iterate: "
                "need 1 <= k <= size")
        c = _rparam(gamma, leaf) * _rparam(self.lam, leaf)
        p = _capped_simplex_proj(leaf.reshape(-1), c, c * self.k)
        zt = _like(x, (leaf.reshape(-1) - p).reshape(leaf.shape))
        return zt, self(zt)


def Maximum(lam=1.0):
    """f(x) = lam * max(x): :class:`SumLargest` with k = 1."""
    return SumLargest(1, lam)


@proxclass
class CubeNormL2:
    """f(x) = lam * ||x||_2^3; the prox shrinks radially to
    s = 2r / (1 + sqrt(1 + 12 lam gamma r)), r = ||x||."""

    lam: object = 1.0

    is_convex = True
    is_generalized_quadratic = False

    def __call__(self, x):
        lam = _rparam(self.lam, _leaf(x))
        return lam * torch.sqrt(tree_vdot_real(x, x)) ** 3

    def prox(self, x, gamma):
        leaf = _leaf(x)
        lam = _rparam(self.lam, leaf)
        gamma = _rparam(gamma, leaf)
        r = torch.sqrt(tree_vdot_real(x, x))
        s = 2 * r / (1 + torch.sqrt(1 + 12 * lam * gamma * r))
        scale = torch.where(r == 0, torch.zeros_like(r),
                            s / _one_where_zero(r))
        z = tree_map(lambda l: l * scale.to(l.dtype), x)
        return z, lam * s ** 3


@proxclass
class IndBinary:
    """Indicator of {low, high}^n (nonconvex); the prox snaps each entry
    to the nearer value, ties to ``low``."""

    low: object = 0.0
    high: object = 1.0

    is_convex = False
    is_generalized_quadratic = False

    def __call__(self, x):
        leaf = _leaf(x)
        lo, hi = _rparam(self.low, leaf), _rparam(self.high, leaf)
        return _indicator(torch.all((leaf == lo) | (leaf == hi)), x)

    def prox(self, x, gamma):
        def snap(l):
            lo = _rparam(self.low, l).to(l.dtype)
            hi = _rparam(self.high, l).to(l.dtype)
            return torch.where(torch.abs(l - hi) < torch.abs(l - lo),
                               hi, lo)

        return tree_map(snap, x), _rzero(x)


@proxclass
class CrossEntropy:
    """f(x) = -mean(b log x + (1 - b) log(1 - x)) on (0, 1)^n: smooth,
    differentiated automatically; no prox."""

    b: object

    is_convex = True
    is_generalized_quadratic = False

    def __call__(self, x):
        leaf = _leaf(x)
        b = _rparam(self.b, leaf)
        return -torch.mean(b * torch.log(leaf)
                           + (1 - b) * torch.log1p(-leaf))


@proxclass
class NegEntropy:
    """f(x) = lam * sum_i x_i log x_i on x >= 0; the prox solves
    lam (log z + 1) + (z - x) / gamma = 0 per coordinate by 20 Newton
    steps on t = log z from t0 = log(max(x, gamma lam)) (a fixed loop)."""

    lam: object = 1.0

    is_convex = True
    is_generalized_quadratic = False

    def __call__(self, x):
        leaf = _leaf(x)
        lam = _rparam(self.lam, leaf)
        safe = torch.clamp(leaf, min=torch.finfo(leaf.dtype).tiny)
        val = lam * torch.sum(torch.where(leaf > 0, leaf * torch.log(safe),
                                          torch.zeros_like(leaf)))
        return torch.where(torch.all(leaf >= 0), val, _inf_like(x))

    def prox(self, x, gamma):
        leaf = _leaf(x)
        c = _rparam(gamma, leaf) * _rparam(self.lam, leaf)
        t = torch.log(torch.clamp(torch.maximum(leaf, c),
                                  min=torch.finfo(leaf.dtype).tiny))
        for _ in range(20):
            et = torch.exp(t)
            t = t - (c * (t + 1) + et - leaf) / (c + et)
        zt = _like(x, torch.exp(t).to(leaf.dtype))
        return zt, self(zt)


@proxclass
class IndFree:
    """Indicator of the whole space: zero everywhere, prox the identity."""

    is_convex = True
    is_generalized_quadratic = True

    def __call__(self, x):
        return _rzero(x)

    def value_and_gradient(self, x):
        return _rzero(x), tree_map(torch.zeros_like, x)

    def prox(self, x, gamma):
        return x, _rzero(x)


def IndNonpositive():
    """Indicator of the nonpositive orthant."""
    return IndBox(-float("inf"), 0.0)


@proxclass
class IndHyperslab:
    """Indicator of {lo <= <a, x> <= hi}; the prox projects along a."""

    a: object
    lo: object = -float("inf")
    hi: object = float("inf")

    is_convex = True
    is_generalized_quadratic = False

    def __call__(self, x):
        dot = tree_vdot_real(self.a, x)
        eps = torch.finfo(real_dtype_of(x)).eps
        lo, hi = _rparam(self.lo, x), _rparam(self.hi, x)
        # slack from the point's own scale (a one-sided slab has an
        # infinite bound)
        slack = 100 * eps * (1 + torch.abs(dot))
        return _indicator((dot >= lo - slack) & (dot <= hi + slack), x)

    def prox(self, x, gamma):
        dot = tree_vdot_real(self.a, x)
        asq = tree_vdot_real(self.a, self.a)
        t = (dot - _clip(dot, _rparam(self.lo, x), _rparam(self.hi, x))) \
            / _one_where_zero(asq)
        z = tree_map(lambda xl, al: xl - (t * al).to(xl.dtype), x, self.a)
        return z, _rzero(x)


# ---------------------------------------------------------------------------
# matrix functions: eigendecompositions and SVDs of 2-D leaves


@proxclass
class IndPSD:
    """Indicator of the positive-semidefinite cone (a symmetric 2-D leaf);
    the prox clamps the negative eigenvalues (``torch.linalg.eigh``)."""

    is_convex = True
    is_generalized_quadratic = False

    def __call__(self, X):
        w = torch.linalg.eigvalsh((X + X.mH) / 2)
        eps = torch.finfo(real_dtype_of(X)).eps
        tol = 100 * eps * torch.clamp(torch.amax(torch.abs(w)), min=1.0)
        return _indicator(torch.amin(w) >= -tol, X)

    def prox(self, X, gamma):
        w, V = torch.linalg.eigh((X + X.mH) / 2)
        wpos = torch.clamp(w, min=0)
        return pdot(V * wpos.unsqueeze(-2).to(V.dtype), V.mH), _rzero(X)


@proxclass
class NegLogDet:
    """f(X) = -mu * logdet(X) on symmetric positive-definite 2-D leaves
    (+inf outside); the prox maps each eigenvalue w of the symmetrised
    input to (w + sqrt(w^2 + 4 gamma mu)) / 2 (``torch.linalg.eigh``), so
    it lands in the PD cone from any symmetric matrix."""

    mu: object = 1.0

    is_convex = True
    is_generalized_quadratic = False

    def __call__(self, X):
        w = torch.linalg.eigvalsh((X + X.mH) / 2)
        mu = _rparam(self.mu, X)
        safe = torch.clamp(w, min=torch.finfo(w.dtype).tiny)
        val = -mu * torch.sum(torch.log(safe))
        return torch.where(torch.amin(w) > 0, val, _inf_like(X))

    def prox(self, X, gamma):
        w, V = torch.linalg.eigh((X + X.mH) / 2)
        mu = _rparam(self.mu, X)
        z = (w + torch.sqrt(w * w + 4 * _rparam(gamma, X) * mu)) / 2
        Z = pdot(V * z.unsqueeze(-2).to(V.dtype), V.mH)
        return Z, -mu * torch.sum(torch.log(z))


@proxclass
class IndStiefel:
    """Indicator of {X : X^H X = I} (nonconvex, 2-D leaf, n >= p); the prox
    is the polar factor U V^H of the thin SVD."""

    is_convex = False
    is_generalized_quadratic = False

    def __call__(self, X):
        G = pdot(X.mH, X)
        eye = torch.eye(G.shape[-1], dtype=G.dtype, device=G.device)
        eps = torch.finfo(real_dtype_of(X)).eps
        return _indicator(torch.amax(torch.abs(G - eye))
                          <= 100 * eps * max(1, X.shape[-2]), X)

    def prox(self, X, gamma):
        Z, _ = _singular(X, torch.ones_like)
        return Z, _rzero(X)


@proxclass(meta_fields=("k",))
class IndRank:
    """Indicator of {X : rank(X) <= k} (nonconvex, 2-D leaf); the prox keeps
    the top k singular values (Eckart-Young).  ``k`` is fixed; where the
    k-th and (k+1)-th singular values tie, the kept subspace is the SVD's
    choice."""

    k: int = 1

    is_convex = False
    is_generalized_quadratic = False

    def __call__(self, X):
        _, s = _singular(X)
        eps = torch.finfo(real_dtype_of(X)).eps
        tail = torch.sum(torch.abs(s[..., self.k:]))
        return _indicator(tail <= 100 * eps * max(X.shape[-2:])
                          * (1 + torch.amax(s)), X)

    def prox(self, X, gamma):
        def top_k(s):
            keep = torch.arange(s.shape[-1], device=s.device) < self.k
            return torch.where(keep, s, torch.zeros_like(s))

        Z, _ = _singular(X, top_k)
        return Z, _rzero(X)


# the rank-ball indicator under ProximalOperators.jl's name
IndBallRank = IndRank


@proxclass
class IndGraph:
    """Indicator of the graph {(x, y) : y = A x} on a tuple iterate (x, y);
    the projection u = (I + A^H A)^{-1} (x + A^H y), v = A u through the
    upper Cholesky factor of I + A^H A, made once at construction (the
    JAX package's ``cho_factor``, ``lower=False``)."""

    A: object
    chol: object = None

    is_convex = True
    is_generalized_quadratic = True

    def __post_init__(self):
        if self.chol is None:
            A = torch.as_tensor(self.A)
            eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
            object.__setattr__(self, "chol", torch.linalg.cholesky(
                eye + pdot(A.mH, A), upper=True))

    def __call__(self, xy):
        x, y = xy
        r = tree_inf_norm(tree_sub((pmatvec(self.A, x),), (y,)))
        eps = torch.finfo(real_dtype_of(x)).eps
        scale = 1 + tree_inf_norm((x, y))
        return _indicator(r <= 100 * eps * scale * self.A.shape[-1], x)

    def prox(self, xy, gamma):
        x, y = xy
        rhs = x + pmatvec(self.A.mH, y)
        u = torch.cholesky_solve(rhs.unsqueeze(-1), self.chol,
                                 upper=True).squeeze(-1)
        return (u, pmatvec(self.A, u)), _rzero(x)


# ---------------------------------------------------------------------------
# the exponential cone


def _expcone_project(V):
    """Euclidean projection of each row of V (..., 3) onto the exponential
    cone K = cl{(x, y, z) : y > 0, y exp(x/y) <= z}: the JAX package's
    candidate selection, vectorised over the rows.

    The candidates are v itself, 0, the 2-D face (min(x,0), 0, max(z,0))
    and its underflow neighbour (min(x,0), max(y,0), max(z,0)), and up to
    four roots of the curved-boundary KKT equation h(alpha) = 0, bracketed
    on a 513-point grid over [-40, 40] (the first four sign changes) and
    bisected 90 steps (a fixed loop), each with two reconstructions of z;
    the feasible one nearest v wins (first on ties)."""
    dtype = V.dtype
    big = _big(V)

    def exp_safe(a):
        return torch.exp(torch.clamp(a, -big, big))

    v1, v2, v3 = (V[..., i:i + 1] for i in range(3))

    def h_and_mu(a):
        E = exp_safe(a)
        mu = (v1 - a * v2) / (E * (1 - a + a * a))
        return (v2 - mu * E * (1 - a)) * E - mu - v3, mu, E

    grid = torch.linspace(-40.0, 40.0, 513, dtype=dtype, device=V.device)
    vals = h_and_mu(grid)[0]
    flip = vals[..., :-1] * vals[..., 1:] <= 0
    # the first four sign changes, 0 where there are fewer
    # (jnp.flatnonzero(size=4, fill_value=0))
    rank = torch.cumsum(flip.to(torch.int64), -1)
    idx = torch.stack([
        torch.where(torch.any(sel, -1), torch.argmax(sel.to(torch.int64), -1),
                    torch.zeros_like(sel[..., 0], dtype=torch.int64))
        for sel in (flip & (rank == j) for j in range(1, 5))], -1)
    lo, hi = grid[idx], grid[idx + 1]
    f_lo = h_and_mu(lo)[0]
    for _ in range(90):
        mid = (lo + hi) / 2
        f_mid = h_and_mu(mid)[0]
        keep_lo = f_lo * f_mid <= 0
        lo, hi, f_lo = (torch.where(keep_lo, lo, mid),
                        torch.where(keep_lo, mid, hi),
                        torch.where(keep_lo, f_lo, f_mid))
    a = (lo + hi) / 2
    _, mu, E = h_and_mu(a)
    rx = v1 - mu * E
    ry = v2 - mu * E * (1 - a)
    # two reconstructions of z per bracket: the KKT value (exact distance,
    # may sit a few eps outside K) and the boundary-forced one (feasible
    # by construction); the selection keeps whichever is feasible and
    # closer
    rz_kkt = v3 + mu
    ry_pos = ry > 0
    rz_forced = torch.where(
        ry_pos, ry * exp_safe(rx / torch.where(ry_pos, ry,
                                               torch.ones_like(ry))),
        rz_kkt)
    zero = torch.zeros_like(v1)
    cands = torch.cat([
        V.unsqueeze(-2),
        torch.zeros_like(V).unsqueeze(-2),
        torch.cat([torch.minimum(v1, zero), zero,
                   torch.maximum(v3, zero)], -1).unsqueeze(-2),
        torch.cat([torch.minimum(v1, zero), torch.maximum(v2, zero),
                   torch.maximum(v3, zero)], -1).unsqueeze(-2),
        torch.stack([rx, ry, rz_kkt], -1),
        torch.stack([rx, ry, rz_forced], -1),
    ], -2)  # (..., 12, 3)
    eps = torch.finfo(dtype).eps
    tol = (100 * eps * (1 + torch.sqrt(torch.sum(V * V, -1)))).unsqueeze(-1)
    cy = cands[..., 1]
    cy_pos = cy > 0
    cy_safe = torch.where(cy_pos, cy, torch.ones_like(cy))
    viol_pos = torch.clamp(cy_safe * exp_safe(cands[..., 0] / cy_safe)
                           - cands[..., 2], min=0)
    viol = torch.where(cy_pos, viol_pos, torch.maximum(
        torch.maximum(cands[..., 0], -cands[..., 2]), -cy))
    # a curved-boundary root needs a multiplier mu >= 0
    mu_ok = torch.cat([torch.ones_like(mu[..., :4], dtype=torch.bool),
                       mu >= 0, mu >= 0], -1)
    feasible = (viol <= tol) & (cy >= -tol) & mu_ok
    diff = cands - V.unsqueeze(-2)
    dist = torch.where(feasible, torch.sqrt(torch.sum(diff * diff, -1)),
                       torch.full_like(cy, float("inf")))
    best = torch.argmin(dist, -1)
    z = torch.gather(cands, -2, best[..., None, None].expand(
        *best.shape, 1, 3)).squeeze(-2)
    return torch.stack([z[..., 0], torch.clamp(z[..., 1], min=0),
                        z[..., 2]], -1)


@proxclass
class IndExpPrimal:
    """Indicator of the exponential cone cl{(x,y,z) : y > 0,
    y exp(x/y) <= z}; one leaf whose trailing dimension is 3, the leading
    ones vectorised (:func:`_expcone_project`)."""

    is_convex = True
    is_generalized_quadratic = False

    def _viol(self, leaf):
        big = _big(leaf)
        x, y, z = leaf[..., 0], leaf[..., 1], leaf[..., 2]
        ypos = y > 0
        ysafe = torch.where(ypos, y, torch.ones_like(y))
        vpos = torch.clamp(
            ysafe * torch.exp(torch.clamp(x / ysafe, -big, big)) - z, min=0)
        vface = torch.maximum(torch.maximum(x, -z), -y)
        return torch.where(ypos, vpos, vface)

    def __call__(self, x):
        leaf = _leaf(x)
        eps = torch.finfo(real_dtype_of(leaf)).eps
        scale = 1 + torch.amax(torch.abs(leaf))
        return _indicator(torch.amax(self._viol(leaf)) <= 100 * eps * scale,
                          x)

    def prox(self, x, gamma):
        leaf = _leaf(x)
        out = _expcone_project(leaf.reshape(-1, 3)).reshape(leaf.shape)
        return _like(x, out), _rzero(leaf)


@proxclass
class IndExpDual:
    """Indicator of the dual exponential cone; projection by the Moreau
    identity P_{K*}(x) = x + P_K(-x).  Trailing dimension 3."""

    is_convex = True
    is_generalized_quadratic = False

    def __call__(self, x):
        leaf = _leaf(x)
        flat = leaf.reshape(-1, 3)
        proj = flat + _expcone_project(-flat)
        eps = torch.finfo(real_dtype_of(leaf)).eps
        scale = 1 + torch.amax(torch.abs(leaf))
        return _indicator(torch.amax(torch.abs(proj - flat))
                          <= 100 * math.sqrt(eps) * scale, x)

    def prox(self, x, gamma):
        leaf = _leaf(x)
        flat = leaf.reshape(-1, 3)
        out = (flat + _expcone_project(-flat)).reshape(leaf.shape)
        return _like(x, out), _rzero(leaf)


# ---------------------------------------------------------------------------
# functions whose prox is an inner loop that ends on a tolerance


def _fista_restart_step(u, w, t, u_new, R, restart):
    """The dual FISTA update with the O'Donoghue-Candes gradient-scheme
    restart: ``(t_new, w_new)`` from the previous iterate ``u``, the
    extrapolated point ``w`` and the new iterate ``u_new``."""
    one = torch.ones((), dtype=R, device=u.device)
    if restart:
        do_r = torch.sum((w - u_new) * (u_new - u)) > 0
        t = torch.where(do_r, one, t)
    t_new = (1 + torch.sqrt(1 + 4 * t * t)) / 2
    beta = (t - 1) / t_new
    if restart:
        beta = torch.where(do_r, torch.zeros_like(beta), beta)
    return t_new, u_new + beta * (u_new - u)


@proxclass(meta_fields=("maxit",))
class IndPolyhedral:
    """Indicator of {x : lo <= A x <= hi} (equality rows lo_i = hi_i,
    one-sided rows +-inf).  The prox solves the dual of the projection QP,
    min_y ||A^H y||^2 / 2 - <y, A x> + sigma_[lo,hi](y), by FISTA with
    gradient restart (step 1/L, L = ||A||^2 by 20 power steps from a fixed
    non-uniform start, the Frobenius bound where that collapses) and
    returns x - A^H y.  The loop ends on the dual forward-backward residual
    ``max|y_new - w| / step <= tol (1 + max|A x|)`` (tol floored at
    50 eps) or at ``maxit`` trips.

    Loop form (:func:`~proxtpu_torch.utils.loops.vmap_while`): on one
    problem a host loop that stops when the residual test passes; under
    ``torch.func.vmap`` (x, A, lo or hi batched) ``maxit`` masked trips,
    the result of JAX's vmapped ``while_loop``."""

    A: object
    lo: object
    hi: object
    tol: object = 1e-9
    maxit: int = 2000

    is_convex = True
    is_generalized_quadratic = False

    def _bounds(self, leaf):
        return _rparam(self.lo, leaf), _rparam(self.hi, leaf)

    def __call__(self, x):
        leaf = _leaf(x)
        lo, hi = self._bounds(leaf)
        r = pmatvec(self.A, leaf)
        eps = torch.finfo(real_dtype_of(leaf)).eps
        scale = 1 + torch.amax(torch.abs(r))
        # 10x the inner tol: the dual solver's primal violation lands at
        # the tol scale
        slack = 10 * torch.clamp(_rparam(self.tol, leaf), min=100 * eps) \
            * scale
        return _indicator(torch.all(r >= lo - slack)
                          & torch.all(r <= hi + slack), x)

    def prox(self, x, gamma):
        leaf = _leaf(x)
        R = real_dtype_of(leaf)
        A = self.A
        lo, hi = self._bounds(leaf)
        eps = torch.finfo(R).eps
        tiny = torch.finfo(R).tiny
        tol = torch.clamp(_rparam(self.tol, leaf), min=50 * eps)
        Ax = pmatvec(A, leaf)
        atol = tol * (1 + torch.amax(torch.abs(Ax)))

        # ||A||_2^2 by power iteration on A^H A from a fixed, non-uniform
        # start (all-ones lies in the null space of difference matrices);
        # where it still collapses, the Frobenius bound
        n_cols = A.shape[-1]
        v = torch.cos(torch.arange(n_cols, dtype=R, device=leaf.device)
                      * 1.7 + 0.3)
        v = v / torch.linalg.vector_norm(v)
        for _ in range(20):
            w = pmatvec(A.mH, pmatvec(A, v))
            v = w / torch.clamp(torch.linalg.vector_norm(w), min=tiny)
        L_pow = torch.linalg.vector_norm(pmatvec(A, v)) ** 2 * 1.05
        fro2 = torch.sum(torch.abs(A) ** 2)
        step = 1 / (torch.where(L_pow > eps * fro2, L_pow, fro2) + tiny)

        def sigma_prox(v, s):
            # Moreau: the prox of s * the support function of [lo, hi]
            return v - s * _clip(v / s, lo, hi)

        def cond(c):
            _, _, _, k, res = c
            return (k < self.maxit) & (res > atol)

        def body(c):
            y, w, t, k, _ = c
            g = pmatvec(A, pmatvec(A.mH, w) - leaf)
            y_new = sigma_prox(w - step * g, step)
            res = _max_abs0(y_new - w) / step
            t_new, w_new = _fista_restart_step(y, w, t, y_new, R, True)
            return y_new, w_new, t_new, k + 1, res

        y0 = torch.zeros(A.shape[-2], dtype=leaf.dtype, device=leaf.device)
        init = (y0, y0, torch.ones((), dtype=R, device=leaf.device),
                torch.zeros((), dtype=torch.int32, device=leaf.device),
                torch.full((), float("inf"), dtype=R, device=leaf.device))
        y = vmap_while(cond, body, init, self.maxit, (leaf, A, lo, hi))[0]
        return _like(x, leaf - pmatvec(A.mH, y)), _rzero(x)


def _tv1d_Dt(u):
    """D^T u for the forward differences D: length n from n - 1."""
    return F.pad(u, (1, 0)) - F.pad(u, (0, 1))


def _tv1d_dual(leaf, thr, tol, maxit, restart):
    """The dual FGP loop of :class:`TotalVariation1D` on one signal:
    ``(u, k)``, the dual iterate and the trips it took."""
    R = real_dtype_of(leaf)
    quarter = torch.tensor(0.25, dtype=R, device=leaf.device)

    def cond(c):
        _, _, _, k, delta = c
        return (k < maxit) & (delta > tol)

    def body(c):
        u, w, t, k, _ = c
        g = torch.diff(_tv1d_Dt(w) - leaf)
        u_new = torch.clamp(w - quarter * g, -thr, thr)
        t_new, w_new = _fista_restart_step(u, w, t, u_new, R, restart)
        return u_new, w_new, t_new, k + 1, _max_abs0(u_new - u)

    u0 = torch.zeros(leaf.shape[0] - 1, dtype=leaf.dtype, device=leaf.device)
    init = (u0, u0, torch.ones((), dtype=R, device=leaf.device),
            torch.zeros((), dtype=torch.int32, device=leaf.device),
            torch.full((), float("inf"), dtype=R, device=leaf.device))
    u, _, _, k, _ = vmap_while(cond, body, init, maxit, (leaf, thr))
    return u, k


@proxclass(meta_fields=("maxit", "restart"))
class TotalVariation1D:
    """f(x) = lam * sum_i |x_{i+1} - x_i|, the 1-D total variation.  The
    prox solves the dual denoising problem
    min_{|u| <= gamma lam} ||D^T u - x||^2 / 2 by FISTA (step 1/4, with
    gradient restart when ``restart``) and returns x - D^T u; the loop
    ends when the dual iterate moves by at most tol (1 + max|x|) (tol
    floored at 10 eps) or after ``maxit`` trips (:meth:`dual`).

    Loop form (:func:`~proxtpu_torch.utils.loops.vmap_while`): on one
    signal a host loop that stops when the test passes; under
    ``torch.func.vmap`` (the signal or lam batched) ``maxit`` masked
    trips for every lane, the result of JAX's vmapped ``while_loop``,
    whatever trips the lanes need."""

    lam: object = 1.0
    tol: object = 1e-10
    maxit: int = 2000
    restart: bool = True

    is_convex = True
    is_generalized_quadratic = False

    def __call__(self, x):
        leaf = _leaf(x)
        return _rparam(self.lam, leaf) * torch.sum(torch.abs(
            torch.diff(leaf)))

    def dual(self, x, gamma):
        """``(u, k)``: the dual iterate of the prox at ``gamma`` and the
        trips its loop took (each lane's own count also under vmap, where
        every lane pays ``maxit`` trips)."""
        leaf = _leaf(x)
        thr = _rparam(self.lam, leaf) * _rparam(gamma, leaf)
        eps = torch.finfo(real_dtype_of(leaf)).eps
        tol = torch.clamp(_rparam(self.tol, leaf), min=10 * eps) * (
            1 + torch.amax(torch.abs(leaf)))
        return _tv1d_dual(leaf, thr, tol, self.maxit, self.restart)

    def prox(self, x, gamma):
        leaf = _leaf(x)
        zt = _like(x, leaf - _tv1d_Dt(self.dual(x, gamma)[0]))
        return zt, self(zt)
