"""Linear operators (counterpart of the identity, zero, dense and 2-D
gradient operators of ``proxtpu/ops/linops.py``): ``matvec(x)`` is A x,
``rmatvec(y)`` is A^H y, ``opnorm()`` is ||A||_2."""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..utils.precision import pdot
from ..utils.tree import tree_zeros_like


@dataclass(frozen=True)
class IdentityOperator:
    """A = I, on any iterate."""

    def matvec(self, x):
        return x

    def rmatvec(self, y):
        return y

    def opnorm(self):
        return 1.0


@dataclass(frozen=True)
class ZeroOperator:
    """A = 0 (AFBA's default ``L`` when h is ``Zero``)."""

    def matvec(self, x):
        return tree_zeros_like(x)

    def rmatvec(self, y):
        return tree_zeros_like(y)

    def opnorm(self):
        return 0.0


@dataclass(frozen=True)
class MatrixOperator:
    """A dense matrix."""

    A: object

    def matvec(self, x):
        return pdot(self.A, x)

    def rmatvec(self, y):
        return pdot(self.A.mH, y)

    def opnorm(self):
        return torch.linalg.matrix_norm(self.A, 2)


@dataclass(frozen=True)
class Grad2DOperator:
    """Discrete 2-D gradient (forward differences, Neumann boundary).

    Maps an (H, W) image to a (2, H, W) field of (dx, dy) differences; the
    ``L`` of TV denoising by Chambolle-Pock.  ||L||^2 <= 8.  ``shape`` is
    fixed, not data."""

    shape: tuple

    def matvec(self, x):
        dx = torch.diff(x, dim=0, append=x[-1:, :])
        dy = torch.diff(x, dim=1, append=x[:, -1:])
        return torch.stack([dx, dy])

    def rmatvec(self, y):
        # negative divergence: the last row of dx and the last column of dy
        # count as 0, and the backward difference takes 0 before the first
        dx, dy = y[0], y[1]
        dx = torch.cat([dx[:-1, :], torch.zeros_like(dx[-1:, :])], dim=0)
        dy = torch.cat([dy[:, :-1], torch.zeros_like(dy[:, -1:])], dim=1)
        div_x = torch.diff(dx, dim=0, prepend=torch.zeros_like(dx[:1, :]))
        div_y = torch.diff(dy, dim=1, prepend=torch.zeros_like(dy[:, :1]))
        return -(div_x + div_y)

    def opnorm(self):
        return math.sqrt(8.0)


def as_linop(A):
    """``None``, a tensor or an operator as an operator.  A
    :class:`~proxtpu_torch.utils.shared.Shared` operand stays marked, so
    that a batched driver still sees it as lane-invariant."""
    from ..utils.shared import Shared

    if isinstance(A, Shared):
        return Shared(as_linop(object.__getattribute__(A, "value")))
    if A is None:
        return IdentityOperator()
    if hasattr(A, "matvec"):
        return A
    if hasattr(A, "shape"):
        return MatrixOperator(torch.as_tensor(A))
    return A
