"""Vector-space operations over nested iterates (counterpart of
``proxtpu/utils/tree.py``).

The JAX package writes every algorithm against pytree helpers so that an
iterate may be a structure of arrays.  The port keeps the same helpers over
tensors nested in tuples (named or not), lists and dicts; ``None`` is an
empty subtree, as in JAX.  Inner products follow the reference's
``real(dot(a, b))`` convention: the first argument is conjugated and the
real part kept.

:func:`flatten` goes further and also opens frozen dataclasses (the prox
functions, operators and iteration objects) and
:class:`~proxtpu_torch.utils.shared.Shared` markers, so
that a batched driver can map every tensor of an iteration object with
``torch.func.vmap``.
"""

from __future__ import annotations

import dataclasses

import torch


def _children(tree):
    """``(children, rebuild)`` for a container node, or ``None`` for a
    leaf.  ``rebuild(children)`` makes a node of the same kind."""
    if isinstance(tree, tuple):
        if hasattr(tree, "_fields"):  # namedtuple
            return list(tree), lambda cs: type(tree)(*cs)
        return list(tree), tuple
    if isinstance(tree, list):
        return list(tree), list
    if isinstance(tree, dict):
        keys = list(tree)
        return [tree[k] for k in keys], lambda cs: dict(zip(keys, cs))
    return None


def tree_leaves(tree):
    """The tensors of ``tree`` in a fixed order (``None`` holds none)."""
    if tree is None:
        return []
    node = _children(tree)
    if node is None:
        return [tree]
    return [leaf for c in node[0] for leaf in tree_leaves(c)]


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leaf by leaf over trees of one structure."""
    if tree is None:
        return None
    node = _children(tree)
    if node is None:
        return fn(tree, *rest)
    children, rebuild = node
    rest_children = [_children(r)[0] for r in rest]
    return rebuild([tree_map(fn, c, *(rc[i] for rc in rest_children))
                    for i, c in enumerate(children)])


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_scale(alpha, a):
    """alpha * a for a scalar ``alpha`` (a number or a rank-0 tensor)."""
    return tree_map(lambda l: alpha * l, a)


def tree_zeros_like(a):
    return tree_map(torch.zeros_like, a)


def tree_where(pred, a, b):
    """Select between whole trees on a scalar (or broadcasting) ``pred``."""
    return tree_map(lambda x, y: torch.where(pred, x, y), a, b)


def _vdot(x, y):
    return torch.sum(x.conj() * y)


def tree_vdot_real(a, b):
    """real(<a, b>) with ``a`` conjugated: the reference's inner product."""
    leaves = tree_leaves(tree_map(_vdot, a, b))
    return torch.real(sum(leaves[1:], leaves[0]))


def tree_norm_sq(a):
    return tree_vdot_real(a, a)


def tree_inf_norm(a):
    """max_i |a_i| over all leaves (``norm(x, Inf)`` in the reference)."""
    leaves = [torch.amax(torch.abs(l)) for l in tree_leaves(a)]
    out = leaves[0]
    for l in leaves[1:]:
        out = torch.maximum(out, l)
    return out


def tree_size(a):
    return sum(l.numel() for l in tree_leaves(a))


def real_dtype_of(a):
    """The real floating dtype underlying a tree's leaves."""
    dtype = tree_leaves(a)[0].dtype
    return dtype.to_real() if dtype.is_complex else dtype


def eps_of(a):
    """Machine epsilon of the real dtype underlying ``a``."""
    return torch.finfo(real_dtype_of(a)).eps


# ---------------------------------------------------------------------------
# flattening whole problem objects


class TreeSpec:
    """The structure :func:`flatten` took apart: ``unflatten(leaves)``
    rebuilds it, ``shared[i]`` says whether leaf ``i`` lies under a
    ``Shared`` marker."""

    def __init__(self, build, shared):
        self._build = build
        self.shared = shared

    def unflatten(self, leaves):
        return self._build(iter(leaves))


def flatten(tree):
    """``(tensors, spec)`` for a tree of tensors, containers, frozen
    dataclasses and ``Shared`` markers.  Every other value (floats,
    flags, strategy objects without tensors) is kept as it is in ``spec``."""
    from .shared import Shared

    leaves, shared = [], []

    def walk(node, under_shared):
        if isinstance(node, torch.Tensor):
            leaves.append(node)
            shared.append(under_shared)
            return lambda it: next(it)
        if isinstance(node, Shared):
            inner = walk(object.__getattribute__(node, "value"), True)
            return lambda it: Shared(inner(it))
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            names = [f.name for f in dataclasses.fields(node)]
            parts = [walk(getattr(node, n), under_shared) for n in names]
            return lambda it: dataclasses.replace(
                node, **{n: p(it) for n, p in zip(names, parts)})
        kids = None if node is None else _children(node)
        if kids is None:
            return lambda it: node
        children, rebuild = kids
        parts = [walk(c, under_shared) for c in children]
        return lambda it: rebuild([p(it) for p in parts])

    build = walk(tree, False)
    return leaves, TreeSpec(build, shared)
