"""Acceleration strategies of the port (counterpart of ``proxtpu.accel``):
L-BFGS, Anderson, Broyden, no acceleration and the Nesterov coefficient
sequences."""

from .anderson import AndersonAcceleration
from .base import NESTEROV, NO_ACCELERATION, QUASI_NEWTON, acceleration_style
from .broyden import Broyden
from .lbfgs import LBFGS
from .nesterov import (
    AdaptiveNesterovSequence,
    AdaptiveRestartSequence,
    ConstantNesterovSequence,
    FixedNesterovSequence,
    NesterovExtrapolation,
    SimpleNesterovSequence,
)
from .noaccel import NoAcceleration

__all__ = [
    "LBFGS", "AndersonAcceleration", "Broyden", "NoAcceleration",
    "NesterovExtrapolation", "FixedNesterovSequence",
    "SimpleNesterovSequence", "ConstantNesterovSequence",
    "AdaptiveNesterovSequence", "AdaptiveRestartSequence",
    "acceleration_style", "QUASI_NEWTON", "NESTEROV", "NO_ACCELERATION",
]
