"""Carry problems from numpy (or JAX arrays and the JAX package's prox
objects) into the port.  Nothing here imports JAX: arrays are read through
``np.asarray``, objects by their class name and fields."""

from __future__ import annotations

import numpy as np
import torch


def _per_lane(name, v, B):
    if v.shape not in ((), (B,)):
        raise ValueError(f"{name} must be a scalar or ({B},), got shape "
                         f"{v.shape}")
    return np.broadcast_to(v, (B,))


def _tensors(arrays, device):
    return tuple(torch.tensor(np.ascontiguousarray(v), device=device)
                 for v in arrays)


def problems_from_numpy(As, bs, lams, Lfs, device):
    """Stacked lasso problems as contiguous float32 tensors on ``device``.

    ``As`` (B, M, N), ``bs`` (B, M), ``lams`` and ``Lfs`` (B,) or scalars
    (broadcast to (B,)): the arrays both packages consume; JAX arrays are
    taken through ``np.asarray``.  ``device`` is required: nothing is moved
    to a device the caller did not name.  Returns ``(A, b, lam, Lf)``."""
    As, bs, lams, Lfs = (np.asarray(v, dtype=np.float32)
                         for v in (As, bs, lams, Lfs))
    if As.ndim != 3:
        raise ValueError(f"As must be (B, M, N), got shape {As.shape}")
    B, M, N = As.shape
    if bs.shape != (B, M):
        raise ValueError(f"bs must be {(B, M)}, got shape {bs.shape}")
    return _tensors([As, bs, _per_lane("lams", lams, B),
                     _per_lane("Lfs", Lfs, B)], device)


def box_qp_from_numpy(Qs, qs, lo, hi, Lips, device):
    """Stacked box QPs as contiguous float32 tensors on ``device``.

    ``Qs`` (B, n, n), ``qs`` (B, n); ``lo``, ``hi`` and ``Lips`` (B,) or
    scalars (broadcast to (B,)), in the argument order of
    ``solve_box_qp_batch``.  Returns ``(Q, q, lo, hi, Lip)``."""
    Qs, qs, lo, hi, Lips = (np.asarray(v, dtype=np.float32)
                            for v in (Qs, qs, lo, hi, Lips))
    if Qs.ndim != 3 or Qs.shape[1] != Qs.shape[2]:
        raise ValueError(f"Qs must be (B, n, n), got shape {Qs.shape}")
    B, n, _ = Qs.shape
    if qs.shape != (B, n):
        raise ValueError(f"qs must be {(B, n)}, got shape {qs.shape}")
    return _tensors([Qs, qs, _per_lane("lo", lo, B), _per_lane("hi", hi, B),
                     _per_lane("Lips", Lips, B)], device)


def tv_from_numpy(b, lam, device):
    """Stacked TV-denoising problems as contiguous float32 tensors on
    ``device``: ``b`` (B, H, W) noisy images, ``lam`` a scalar or (B,)
    (broadcast to (B,)).  Returns ``(b, lam)``, the operands of
    ``solve_tv_batch``."""
    b, lam = (np.asarray(v, dtype=np.float32) for v in (b, lam))
    if b.ndim != 3:
        raise ValueError(f"b must be (B, H, W), got shape {b.shape}")
    return _tensors([b, _per_lane("lam", lam, b.shape[0])], device)


# the fields each carried class is rebuilt from, in constructor order
_PROX_FIELDS = {
    "Zero": (),
    "IndZero": (),
    "LeastSquaresLoss": ("A", "b", "lam"),
    "LeastSquares": ("A", "b", "lam", "U", "s", "Atb", "wide"),
    "NormL1": ("lam",),
    "ElasticNet": ("mu", "lam"),
    "Quadratic": ("Q", "q"),
    "IndBox": ("low", "high"),
    "SqrNormL2": ("lam",),
    "SqrDistance": ("b",),
    "NormL21": ("lam", "axis"),
    "Translate": ("f", "t"),
}
_LINOP_FIELDS = {
    "IdentityOperator": (),
    "ZeroOperator": (),
    "MatrixOperator": ("A",),
    "Grad2DOperator": ("shape",),
}


def _field(v, device):
    """Python scalars, flags and shapes stay as they are; a nested function
    object is carried over; arrays become tensors of the same dtype on
    ``device``."""
    if v is None or isinstance(v, (bool, int, float)):
        return v
    if isinstance(v, tuple) and all(isinstance(n, int) for n in v):
        return v
    if type(v).__name__ in _PROX_FIELDS:
        return prox_from_jax(v, device)
    return torch.tensor(np.array(v), device=device)


def prox_from_jax(obj, device):
    """The port's counterpart of one of the JAX package's function objects
    (``Zero``, ``IndZero``, ``LeastSquaresLoss``, ``LeastSquares``,
    ``NormL1``, ``ElasticNet``, ``Quadratic``, ``IndBox``, ``SqrNormL2``,
    ``SqrDistance``, ``NormL21``, ``Translate`` around one of them, or any of
    them inside ``Shared``),
    its arrays on ``device`` in their own dtype.  Stacked (batched) objects
    carry over as they are."""
    from .prox import base, functions
    from .utils.shared import Shared

    name = type(obj).__name__
    if name == "Shared":
        return Shared(prox_from_jax(object.__getattribute__(obj, "value"),
                                    device))
    if name not in _PROX_FIELDS:
        raise TypeError(f"no port counterpart for {type(obj).__module__}."
                        f"{name}; carried: {sorted(_PROX_FIELDS)}")
    cls = getattr(functions, name, None) or getattr(base, name)
    return cls(*(_field(getattr(obj, k), device)
                 for k in _PROX_FIELDS[name]))


def linop_from_jax(obj, device):
    """The port's counterpart of one of the JAX package's operators
    (``IdentityOperator``, ``ZeroOperator``, ``MatrixOperator``,
    ``Grad2DOperator``, or one inside ``Shared``), read by class name and
    fields; a bare array becomes a tensor on ``device``, which
    ``as_linop`` turns into a ``MatrixOperator``."""
    from .ops import linops
    from .utils.shared import Shared

    name = type(obj).__name__
    if name == "Shared":
        return Shared(linop_from_jax(object.__getattribute__(obj, "value"),
                                     device))
    if name in _LINOP_FIELDS:
        return getattr(linops, name)(
            *(_field(getattr(obj, k), device) for k in _LINOP_FIELDS[name]))
    if hasattr(obj, "matvec"):
        raise TypeError(f"no port counterpart for {type(obj).__module__}."
                        f"{name}; carried: {sorted(_LINOP_FIELDS)}")
    return torch.tensor(np.array(obj), device=device)
