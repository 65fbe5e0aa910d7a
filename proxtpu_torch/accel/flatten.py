"""A tree of tensors as one vector and back (counterpart of
``proxtpu/accel/flatten.py``), for the strategies that keep dense
n-dimensional buffers (Anderson, Broyden)."""

from __future__ import annotations

import torch

from ..utils.tree import tree_leaves, tree_map


def flatten_like(x):
    """``(flat, spec)``: the leaves of ``x`` raveled and concatenated;
    ``spec`` rebuilds the tree in :func:`unflatten_like`."""
    leaves = tree_leaves(x)
    flat = torch.cat([l.reshape(-1) for l in leaves])
    return flat, (x, [l.numel() for l in leaves])


def unflatten_like(flat, spec):
    template, sizes = spec
    parts = iter(torch.split(flat, sizes))
    return tree_map(lambda l: next(parts).reshape(l.shape), template)
