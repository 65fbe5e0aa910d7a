"""Linear operators of the port (counterpart of ``proxtpu.ops``)."""

from .linops import IdentityOperator, MatrixOperator

__all__ = ["IdentityOperator", "MatrixOperator"]
