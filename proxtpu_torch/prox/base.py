"""Function-oracle protocol (counterpart of ``proxtpu/prox/base.py``).

The solvers are written against two oracles:

* ``prox(f, x, gamma) -> (z, f_z)``: the proximal mapping and the value
  there;
* ``value_and_gradient(f, x) -> (f_x, grad_f_x)``: the smooth-term oracle.

Functions are frozen dataclasses made by :func:`proxclass`, as in the JAX
package.  :func:`proxtpu_torch.utils.tree.flatten` opens any dataclass:
tensor fields are the problem data, mapped by the batched driver.  The
fields a class names in ``meta_fields`` are static, part of its structure:
problems that differ in one do not stack.  Traits are class attributes.

Complex gradients: ``torch.func`` already returns the conjugate-Wirtinger
gradient that the reference's Zygote returns, so unlike the JAX package the
port does not conjugate.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import torch

from ..utils.tree import real_dtype_of, tree_inf_norm, tree_leaves, \
    tree_zeros_like


def proxclass(cls=None, *, meta_fields=()):
    """Decorator: a frozen dataclass whose fields in ``meta_fields`` are
    static (counterpart of ``proxtpu.prox.base.proxclass``).

    The class is what ``dataclass(frozen=True)`` makes; the names are kept
    in its ``_meta_fields``.  A static field is part of the structure, not
    data: :func:`~proxtpu_torch.parallel.stack_iterations` refuses problems
    that differ in one, where it stacks a number in any other field into a
    lane tensor."""
    if cls is None:
        return partial(proxclass, meta_fields=meta_fields)
    cls = dataclasses.dataclass(frozen=True)(cls)
    unknown = set(meta_fields) - {f.name for f in dataclasses.fields(cls)}
    if unknown:
        raise ValueError(f"{cls.__name__} has no fields {sorted(unknown)}")
    cls._meta_fields = tuple(meta_fields)
    return cls


def is_convex(f) -> bool:
    return bool(getattr(f, "is_convex", False))


def is_generalized_quadratic(f) -> bool:
    return bool(getattr(f, "is_generalized_quadratic", False))


def is_smooth(f) -> bool:
    return hasattr(f, "value_and_gradient") or callable(f)


def prox(g, x, gamma):
    """Proximal mapping argmin_z g(z) + ||z - x||^2 / (2 gamma); returns
    ``(z, g_z)``."""
    return g.prox(x, gamma)


def value_and_gradient(f, x):
    """Value and gradient of a smooth term: ``f.value_and_gradient(x)``
    where the object has a hand-written oracle, else automatic
    differentiation through ``torch.func.grad_and_value`` (which composes
    with ``torch.func.vmap``)."""
    vag = getattr(f, "value_and_gradient", None)
    if vag is not None:
        return vag(x)
    grad, val = torch.func.grad_and_value(f)(x)
    return val, grad


def _rzero(x):
    return torch.zeros((), dtype=real_dtype_of(x),
                       device=tree_leaves(x)[0].device)


@proxclass
class Zero:
    """The identically-zero function; its prox is the identity."""

    is_convex = True
    is_generalized_quadratic = True

    def __call__(self, x):
        return _rzero(x)

    def value_and_gradient(self, x):
        return self(x), tree_zeros_like(x)

    def prox(self, x, gamma):
        return x, self(x)


@proxclass
class IndZero:
    """Indicator of the singleton {0}; its prox maps everything to 0."""

    is_convex = True
    is_generalized_quadratic = True

    def __call__(self, x):
        zero = _rzero(x)
        return torch.where(tree_inf_norm(x) == 0, zero,
                           torch.full_like(zero, float("inf")))

    def prox(self, x, gamma):
        return tree_zeros_like(x), _rzero(x)


@proxclass(meta_fields=("fn",))
class AutoDifferentiable:
    """A plain callable as a smooth term, differentiated by
    ``torch.func.grad_and_value`` (its gradient already has the reference's
    convention for complex inputs: no conjugation)."""

    fn: object

    def __call__(self, x):
        return self.fn(x)

    def value_and_gradient(self, x):
        grad, val = torch.func.grad_and_value(self.fn)(x)
        return val, grad


def convex_conjugate(f):
    """Convex conjugate f*(y) = sup_x <y, x> - f(x).

    ``Zero`` and ``IndZero`` are conjugate to each other; a ``Conjugate``
    unwraps; ``SqrNormL2(lam)`` maps to ``SqrNormL2(1 / lam)``, which keeps
    the conjugate smooth, as AFBA requires of l*.  Anything else is wrapped
    in :class:`~proxtpu_torch.prox.combinators.Conjugate`, whose prox goes
    through the Moreau decomposition."""
    if isinstance(f, Zero):
        return IndZero()
    if isinstance(f, IndZero):
        return Zero()
    from .combinators import Conjugate
    from .functions import SqrNormL2

    if isinstance(f, Conjugate):
        return f.f
    if isinstance(f, SqrNormL2):
        return SqrNormL2(1 / f.lam)
    return Conjugate(f)
