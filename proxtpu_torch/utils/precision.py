"""Matmul precision policy of the port (counterpart of
``proxtpu/utils/precision.py``).

The JAX package pins ``Precision.HIGHEST`` because the solvers' fixed-point
iterations stall around 1e-3 at reduced matmul precision, and lets a user
lower it library-wide with :func:`set_matmul_precision`.  The port keeps
the same switch, read at every product by :func:`pdot`, :func:`pmatvec`
and :func:`peinsum` (through which every dense matvec of the library and
``kernels/tv.py::mxu_cp_step`` go), so no cached object holds an old
setting.  On the card, for float32 operands:

* ``"highest"`` (the default): IEEE float32.  PyTorch's global settings are
  left alone, and :func:`require_full_f32_matmul` raises where they allow
  TF32 (PyTorch's defaults, ``allow_tf32 = False`` and precision
  ``"highest"``, pass);
* ``"high"``: TF32 (JAX's alias ``"tensorfloat32"``): the product runs with
  ``torch.set_float32_matmul_precision("high")``, and the caller's setting
  is put back after it;
* ``"default"``: bfloat16 inputs, float32 accumulation (JAX's alias
  ``"bfloat16"``, the TPU's one pass): both operands are rounded to
  bfloat16 and multiplied as at ``"high"``.  A bfloat16 value is exact in
  TF32 and the product of two is exact in float32, so the sum is the one
  of bfloat16 inputs in float32.

Other dtypes, and every tensor on the CPU, take the plain product at every
setting: on the CPU the three settings give the same bits, as the JAX
package's do there.  The hand-written kernels and the plain steps of the
kernel solvers do not read the setting: they stay in full float32, as the
JAX package pins ``HIGHEST`` in its own.  The switch is process-wide and,
at a reduced setting, flips PyTorch's float32 precision for the length of
one product: another thread's float32 products in that window take TF32.
"""

from __future__ import annotations

import torch

_NAMES = ("default", "high", "highest")
_PRECISION = "highest"


def set_matmul_precision(precision):
    """Set the library-wide matmul precision (``"default"``, ``"high"`` or
    ``"highest"``, or what :func:`get_matmul_precision` returned).  Returns
    the previous setting."""
    global _PRECISION
    if precision not in _NAMES:
        raise ValueError(f"matmul precision {precision!r} is not one of "
                         f"{_NAMES}")
    prev, _PRECISION = _PRECISION, precision
    return prev


def get_matmul_precision():
    return _PRECISION


def require_full_f32_matmul():
    """Raise unless float32 matmuls run in full float32 (no TF32)."""
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "float32 matmuls may run in TF32 (torch.backends.cuda.matmul."
            "allow_tf32 is True or torch.get_float32_matmul_precision() is "
            "not 'highest'); the solvers need full float32 to converge")


def _at_precision(product, *operands):
    """``product(*operands)`` at the library precision."""
    precision = _PRECISION
    if precision == "highest":
        require_full_f32_matmul()
        return product(*operands)
    if not all(t.is_cuda and t.dtype == torch.float32 for t in operands):
        return product(*operands)
    if precision == "default":
        operands = [t.to(torch.bfloat16).to(torch.float32) for t in operands]
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        return product(*operands)
    finally:
        torch.set_float32_matmul_precision(saved)


def pdot(a, b):
    """``a @ b`` at the library precision."""
    return _at_precision(torch.matmul, a, b)


def _matvec(a, x):
    if x.dim() >= a.dim():
        return torch.matmul(a, x)
    return torch.matmul(a, x.unsqueeze(-1)).squeeze(-1)


def pmatvec(a, x):
    """Matvec with matching leading batch dims: ``a[..., i, j] x[..., j] ->
    y[..., i]`` when ``x`` has one dim fewer than ``a`` (a vector or a
    stack of vectors), plain ``matmul`` otherwise (matrix iterates), as
    ``proxtpu.utils.precision.pmatvec``; at the library precision."""
    return _at_precision(_matvec, a, x)


def peinsum(equation, a, b):
    """``torch.einsum(equation, a, b)`` at the library precision (the JAX
    package's ``jnp.einsum(..., precision=get_matmul_precision())``)."""
    return _at_precision(lambda a, b: torch.einsum(equation, a, b), a, b)
