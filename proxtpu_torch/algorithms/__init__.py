"""Solvers of the port (counterpart of ``proxtpu.algorithms``): the
generic driver, the forward-backward family and the primal-dual family."""

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
from .primal_dual import (
    AFBA,
    AFBAIteration,
    ChambollePock,
    VuCondat,
    afba_default_stepsizes,
    make_afba_iteration,
    make_chambolle_pock_iteration,
    make_vu_condat_iteration,
)

__all__ = [
    "IterativeAlgorithm", "run_loop", "FastForwardBackward",
    "FastForwardBackwardIteration", "FastProximalGradient",
    "make_fast_forward_backward_iteration", "ForwardBackward",
    "ForwardBackwardIteration", "ProximalGradient",
    "make_forward_backward_iteration", "AFBA", "AFBAIteration",
    "ChambollePock", "VuCondat", "afba_default_stepsizes",
    "make_afba_iteration", "make_chambolle_pock_iteration",
    "make_vu_condat_iteration",
]
