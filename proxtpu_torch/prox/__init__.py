"""Function-oracle protocol and the prox functions the port's routes take
(counterpart of ``proxtpu.prox``)."""

from .base import (
    IndZero,
    Zero,
    is_convex,
    is_generalized_quadratic,
    prox,
    value_and_gradient,
)
from .functions import (
    ElasticNet,
    IndBox,
    LeastSquares,
    LeastSquaresLoss,
    NormL1,
    Quadratic,
    SqrNormL2,
    make_least_squares,
)

__all__ = [
    "IndZero", "Zero", "is_convex", "is_generalized_quadratic", "prox",
    "value_and_gradient", "ElasticNet", "IndBox", "LeastSquares",
    "LeastSquaresLoss", "NormL1", "Quadratic", "SqrNormL2",
    "make_least_squares",
]
