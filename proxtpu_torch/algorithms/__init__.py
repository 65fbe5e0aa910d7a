"""Solvers of the port (counterpart of ``proxtpu.algorithms``): the
generic driver and the forward-backward family."""

from .core import IterativeAlgorithm, run_loop
from .fast_forward_backward import (
    FastForwardBackward,
    FastForwardBackwardIteration,
    FastProximalGradient,
    make_fast_forward_backward_iteration,
)
from .forward_backward import (
    ForwardBackward,
    ForwardBackwardIteration,
    ProximalGradient,
    make_forward_backward_iteration,
)

__all__ = [
    "IterativeAlgorithm", "run_loop", "FastForwardBackward",
    "FastForwardBackwardIteration", "FastProximalGradient",
    "make_fast_forward_backward_iteration", "ForwardBackward",
    "ForwardBackwardIteration", "ProximalGradient",
    "make_forward_backward_iteration",
]
