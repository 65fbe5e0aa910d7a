"""Acceleration strategies of the port (counterpart of ``proxtpu.accel``):
the Nesterov coefficient sequences."""

from .nesterov import (
    AdaptiveNesterovSequence,
    AdaptiveRestartSequence,
    ConstantNesterovSequence,
    FixedNesterovSequence,
    NesterovExtrapolation,
    SimpleNesterovSequence,
)

__all__ = [
    "AdaptiveNesterovSequence", "AdaptiveRestartSequence",
    "ConstantNesterovSequence", "FixedNesterovSequence",
    "NesterovExtrapolation", "SimpleNesterovSequence",
]
