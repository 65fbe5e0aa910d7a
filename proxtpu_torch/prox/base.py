"""Function-oracle protocol (counterpart of ``proxtpu/prox/base.py``).

The solvers are written against two oracles:

* ``prox(f, x, gamma) -> (z, f_z)``: the proximal mapping and the value
  there;
* ``value_and_gradient(f, x) -> (f_x, grad_f_x)``: the smooth-term oracle.

Functions are plain frozen dataclasses (the JAX package's ``proxclass``
registers them as pytrees; here :func:`proxtpu_torch.utils.tree.flatten`
opens any frozen dataclass).  Tensor fields are the problem data, mapped by
the batched driver; other fields are fixed.  Traits are class attributes.

Complex gradients: ``torch.func`` already returns the conjugate-Wirtinger
gradient that the reference's Zygote returns, so unlike the JAX package the
port does not conjugate.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..utils.tree import real_dtype_of, tree_inf_norm, tree_leaves, \
    tree_zeros_like


def is_convex(f) -> bool:
    return bool(getattr(f, "is_convex", False))


def is_generalized_quadratic(f) -> bool:
    return bool(getattr(f, "is_generalized_quadratic", False))


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


@dataclass(frozen=True)
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


@dataclass(frozen=True)
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
