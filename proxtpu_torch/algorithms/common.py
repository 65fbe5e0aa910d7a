"""Helpers for the iteration factories (counterpart of
``proxtpu/algorithms/common.py``): tensors from the caller's values, and
hyperparameters cast to the iterate's real dtype on its device."""

from __future__ import annotations

import torch

from ..utils.tree import real_dtype_of, tree_map


def astree(x0):
    return tree_map(torch.as_tensor, x0)


def rscalar(v, R, device):
    """A hyperparameter in the iterate's real dtype ``R`` on ``device``
    (``None`` stays ``None``)."""
    if v is None:
        return None
    return torch.as_tensor(v, dtype=R, device=device)


def real_dtype(x0):
    return real_dtype_of(x0)
