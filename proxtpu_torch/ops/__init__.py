"""Linear operators of the port (counterpart of ``proxtpu.ops``)."""

from .linops import (
    Grad2DOperator,
    IdentityOperator,
    MatrixOperator,
    ZeroOperator,
    as_linop,
)

__all__ = ["Grad2DOperator", "IdentityOperator", "MatrixOperator",
           "ZeroOperator", "as_linop"]
