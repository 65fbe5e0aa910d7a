"""Linear operators (counterpart of the identity and dense operators of
``proxtpu/ops/linops.py``): ``matvec(x)`` is A x, ``rmatvec(y)`` is A^H y,
``opnorm()`` is ||A||_2."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..utils.precision import pdot


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
class MatrixOperator:
    """A dense matrix."""

    A: object

    def matvec(self, x):
        return pdot(self.A, x)

    def rmatvec(self, y):
        return pdot(self.A.mH, y)

    def opnorm(self):
        return torch.linalg.matrix_norm(self.A, 2)
