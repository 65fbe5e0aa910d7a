"""Helpers for the iteration factories (counterpart of
``proxtpu/algorithms/common.py``): tensors from the caller's values, and
hyperparameters cast to the iterate's real dtype on its device."""

from __future__ import annotations

import torch

from ..utils.tree import real_dtype_of, tree_leaves, tree_map


def astree(x0):
    return tree_map(torch.as_tensor, x0)


def rscalar(v, R, device):
    """A hyperparameter in the iterate's real dtype ``R`` on ``device``
    (``None`` stays ``None``)."""
    if v is None:
        return None
    return torch.as_tensor(v, dtype=R, device=device)


def resolve_gamma(gamma, Lf, scale=1.0):
    """``gamma = scale / Lf`` when only ``Lf`` is given (a Python or numpy
    ``Lf`` in float64, as the JAX package's under x64); ``None`` when
    neither is."""
    if gamma is not None:
        return gamma
    if Lf is not None:
        Lf = Lf if isinstance(Lf, torch.Tensor) else torch.as_tensor(
            Lf, dtype=torch.float64)
        return torch.as_tensor(scale, dtype=Lf.dtype, device=Lf.device) / Lf
    return None


def real_dtype(x0):
    return real_dtype_of(x0)


def device_of(x0):
    return tree_leaves(x0)[0].device


def ls_scalars(x0, alpha, beta, Lf, gamma, adaptive, minimum_gamma,
               max_backtracks, backtrack_limit):
    """The scalar fields of the ZeroFPR / PANOC / PANOCplus iterations:
    ``gamma = alpha / Lf`` when only ``Lf`` is given (in the iterate's real
    dtype), ``adaptive`` when gamma is left to be estimated."""
    R, dev = real_dtype(x0), device_of(x0)
    if gamma is None and Lf is not None:
        gamma = rscalar(alpha, R, dev) / rscalar(Lf, R, dev)
    if adaptive is None:
        adaptive = gamma is None
    return dict(
        alpha=rscalar(alpha, R, dev), beta=rscalar(beta, R, dev),
        gamma=rscalar(gamma, R, dev),
        minimum_gamma=rscalar(minimum_gamma, R, dev),
        adaptive=bool(adaptive), max_backtracks=int(max_backtracks),
        backtrack_limit=(None if backtrack_limit is None
                         else int(backtrack_limit)))
