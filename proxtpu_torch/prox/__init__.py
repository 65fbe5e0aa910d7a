"""Function-oracle protocol and the prox functions the port's routes take
(counterpart of ``proxtpu.prox``)."""

from .base import (
    IndZero,
    Zero,
    convex_conjugate,
    is_convex,
    is_generalized_quadratic,
    prox,
    value_and_gradient,
)
from .combinators import Conjugate
from .functions import (
    ElasticNet,
    IndBox,
    LeastSquares,
    LeastSquaresLoss,
    NormL1,
    NormL21,
    Quadratic,
    SqrDistance,
    SqrNormL2,
    Translate,
    make_least_squares,
)

__all__ = [
    "IndZero", "Zero", "convex_conjugate", "Conjugate", "is_convex",
    "is_generalized_quadratic", "prox", "value_and_gradient", "ElasticNet",
    "IndBox", "LeastSquares", "LeastSquaresLoss", "NormL1", "NormL21", "Quadratic", "SqrDistance",
    "SqrNormL2", "Translate", "make_least_squares",
]
