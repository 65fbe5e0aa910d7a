"""Lane-invariant (shared) problem data for batched solves (counterpart of
``proxtpu/utils/shared.py``).

``Shared(obj)`` marks a problem object as identical across batch lanes.
Attribute access and calls delegate to the wrapped value, so every oracle
works unchanged, and the batched driver maps the tensors under it with
``in_dims=None``: one operand for the whole batch instead of B copies.
"""

from __future__ import annotations

import dataclasses

from .tree import _children, flatten

__all__ = ["Shared", "batch_axes", "unwrap_shared", "lane_arrays"]


class Shared:
    """Mark a problem object as identical across batch lanes.

    Wrap a whole function or operator object: ``Shared(LeastSquaresLoss(A,
    b))``.  Attribute access and calls delegate to the wrapped value.
    """

    __slots__ = ("value",)

    def __init__(self, value):
        object.__setattr__(self, "value", value)

    def __getattr__(self, name):
        if name in ("value", "__setstate__", "__getstate__"):
            raise AttributeError(name)
        return getattr(object.__getattribute__(self, "value"), name)

    def __call__(self, *args, **kwargs):
        return object.__getattribute__(self, "value")(*args, **kwargs)

    def __repr__(self):
        return f"Shared({object.__getattribute__(self, 'value')!r})"


def batch_axes(tree, axis=0):
    """``torch.func.vmap`` ``in_dims`` for the tensors of
    :func:`~proxtpu_torch.utils.tree.flatten`: ``None`` for a tensor under
    a :class:`Shared` marker, ``axis`` for every other one."""
    _, spec = flatten(tree)
    return [None if s else axis for s in spec.shared]


def map_shared(tree, fn):
    """``tree`` with every Shared subtree ``Shared(v)`` (the outermost in
    each branch) replaced by ``fn(v)``."""
    if isinstance(tree, Shared):
        return fn(object.__getattribute__(tree, "value"))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: map_shared(getattr(tree, f.name), fn)
            for f in dataclasses.fields(tree)})
    node = None if tree is None else _children(tree)
    if node is None:
        return tree
    children, rebuild = node
    return rebuild([map_shared(c, fn) for c in children])


def shared_values(tree):
    """The value of every Shared subtree of ``tree`` (the outermost in
    each branch)."""
    values = []
    map_shared(tree, lambda v: values.append(v) or v)
    return values


def unwrap_shared(tree):
    """Strip every :class:`Shared` wrapper (the outermost in each branch),
    returning the plain object as a single lane of a shared problem sees
    it."""
    return map_shared(tree, lambda value: value)


def lane_arrays(tree):
    """The tensors of ``tree`` that carry a batch axis (those NOT under a
    :class:`Shared` marker): what the dispatch matchers check."""
    leaves, spec = flatten(tree)
    return [l for l, s in zip(leaves, spec.shared) if not s]
