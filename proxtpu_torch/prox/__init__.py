"""Function-oracle protocol and the prox functions the port's routes take
(counterpart of ``proxtpu.prox``)."""

from .base import (
    AutoDifferentiable,
    IndZero,
    Zero,
    convex_conjugate,
    is_convex,
    is_generalized_quadratic,
    is_smooth,
    prox,
    value_and_gradient,
)
from .combinators import Conjugate, SlicedSeparableSum
from .functions import (
    ElasticNet,
    IndAffine,
    IndBox,
    IndNonnegative,
    IndPoint,
    LeastSquares,
    LeastSquaresLoss,
    Linear,
    NormL1,
    NormL21,
    Quadratic,
    SqrDistance,
    SqrNormL2,
    Translate,
    make_ind_affine,
    make_least_squares,
)

__all__ = [
    "AutoDifferentiable", "IndZero", "Zero", "convex_conjugate",
    "Conjugate", "SlicedSeparableSum", "is_convex",
    "is_generalized_quadratic", "is_smooth", "prox", "value_and_gradient",
    "ElasticNet", "IndAffine", "IndBox", "IndNonnegative", "IndPoint",
    "LeastSquares", "LeastSquaresLoss", "Linear", "NormL1", "NormL21",
    "Quadratic", "SqrDistance", "SqrNormL2", "Translate", "make_ind_affine",
    "make_least_squares",
]
