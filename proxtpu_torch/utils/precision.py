"""Matmul precision policy of the port (counterpart of
``proxtpu/utils/precision.py``).

The JAX package pins ``Precision.HIGHEST`` because the solvers' fixed-point
iterations stall around 1e-3 at reduced matmul precision.  On an NVIDIA card
the reduced mode is TF32 (about three decimal digits), so the port's plain
matmuls must run in full float32.  The port does not change PyTorch's global
settings: :func:`require_full_f32_matmul` raises when they allow TF32, and
the plain steps call it before their matmuls, as do :func:`pdot` and
:func:`pmatvec`, through which every dense matvec of the library goes.
PyTorch's defaults (``allow_tf32 = False``, precision ``"highest"``) pass.
"""

from __future__ import annotations

import torch


def require_full_f32_matmul():
    """Raise unless float32 matmuls run in full float32 (no TF32)."""
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "float32 matmuls may run in TF32 (torch.backends.cuda.matmul."
            "allow_tf32 is True or torch.get_float32_matmul_precision() is "
            "not 'highest'); the solvers need full float32 to converge")


def pdot(a, b):
    """``a @ b`` in full float32 (raises where TF32 is allowed)."""
    require_full_f32_matmul()
    return torch.matmul(a, b)


def pmatvec(a, x):
    """Matvec with matching leading batch dims: ``a[..., i, j] x[..., j] ->
    y[..., i]`` when ``x`` has one dim fewer than ``a`` (a vector or a
    stack of vectors), plain ``matmul`` otherwise (matrix iterates), as
    ``proxtpu.utils.precision.pmatvec``."""
    require_full_f32_matmul()
    if x.dim() >= a.dim():
        return torch.matmul(a, x)
    return torch.matmul(a, x.unsqueeze(-1)).squeeze(-1)
