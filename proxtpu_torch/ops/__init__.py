"""Linear operators of the port (counterpart of ``proxtpu.ops``)."""

from .linops import (
    Grad2DOperator,
    IdentityOperator,
    MatrixOperator,
    VStackOperator,
    ZeroOperator,
    as_linop,
    power_iteration_opnorm,
)

__all__ = ["IdentityOperator", "ZeroOperator", "MatrixOperator",
           "VStackOperator", "Grad2DOperator", "as_linop",
           "power_iteration_opnorm"]
