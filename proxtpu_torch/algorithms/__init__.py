"""Solvers of the port (counterpart of ``proxtpu.algorithms``): the
generic driver, the forward-backward family, the line-search family
(ZeroFPR, PANOC, PANOCplus, DRLS), Douglas-Rachford, Davis-Yin, Li-Lin,
SFISTA and the primal-dual family."""

from .core import (
    IterativeAlgorithm,
    RecordedTrace,
    run_loop,
    run_loop_recorded,
    states,
)
from .davis_yin import DavisYin, DavisYinIteration, make_davis_yin_iteration
from .douglas_rachford import (
    DouglasRachford,
    DouglasRachfordIteration,
    make_douglas_rachford_iteration,
)
from .drls import DRLS, DRLSIteration, make_drls_iteration
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
from .li_lin import LiLin, LiLinIteration, make_li_lin_iteration
from .panoc import PANOC, PANOCIteration, make_panoc_iteration
from .panocplus import PANOCplus, PANOCplusIteration, make_panocplus_iteration
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
from .sfista import SFISTA, SFISTAIteration, make_sfista_iteration
from .zerofpr import ZeroFPR, ZeroFPRIteration, make_zerofpr_iteration

__all__ = [
    "IterativeAlgorithm", "RecordedTrace", "run_loop", "run_loop_recorded",
    "states",
    "ForwardBackward", "ForwardBackwardIteration", "ProximalGradient",
    "make_forward_backward_iteration",
    "FastForwardBackward", "FastForwardBackwardIteration",
    "FastProximalGradient", "make_fast_forward_backward_iteration",
    "PANOC", "PANOCIteration", "make_panoc_iteration",
    "ZeroFPR", "ZeroFPRIteration", "make_zerofpr_iteration",
    "PANOCplus", "PANOCplusIteration", "make_panocplus_iteration",
    "DouglasRachford", "DouglasRachfordIteration",
    "make_douglas_rachford_iteration",
    "DRLS", "DRLSIteration", "make_drls_iteration",
    "DavisYin", "DavisYinIteration", "make_davis_yin_iteration",
    "LiLin", "LiLinIteration", "make_li_lin_iteration",
    "SFISTA", "SFISTAIteration", "make_sfista_iteration",
    "AFBA", "AFBAIteration", "make_afba_iteration",
    "VuCondat", "make_vu_condat_iteration",
    "ChambollePock", "make_chambolle_pock_iteration",
    "afba_default_stepsizes",
]
