"""proxtpu_torch: the PyTorch / CUDA port of proxtpu for NVIDIA Hopper.

The JAX package ``proxtpu`` stays the reference; this package mirrors its
module paths and function names, so each counterpart is found under the same
name.  It imports ``torch`` and never ``jax``.  Its hot steps are CUDA
kernels written by hand for ``sm_90a`` (``proxtpu_torch/csrc``), built with
``nvcc`` at first use; importing the package builds and loads nothing.

* :mod:`proxtpu_torch.algorithms` — FB, FISTA and the primal-dual family
  (AFBA, Vu-Condat, Chambolle-Pock) with the generic driver
* :mod:`proxtpu_torch.prox`       — the oracle protocol and prox functions
* :mod:`proxtpu_torch.accel`      — Nesterov coefficient sequences
* :mod:`proxtpu_torch.ops`        — identity, zero, dense and 2-D gradient
  operators
* :mod:`proxtpu_torch.kernels`    — batched lasso, box-QP and TV-denoising
  solvers, their kernels, the read-floor probe and the kernel-route dispatch
* :mod:`proxtpu_torch.parallel`   — ``BatchedAlgorithm``, the batched
  driver, pipelined dispatch of batched solves
* :mod:`proxtpu_torch.convert`    — problems from numpy and from the JAX
  package's objects into tensors
* :mod:`proxtpu_torch.utils`      — precision policy, tree operations,
  shared-lane markers, the FB toolkit
"""

from . import accel, algorithms, convert, kernels, ops, parallel, prox, utils
from .accel import (
    AdaptiveNesterovSequence,
    AdaptiveRestartSequence,
    ConstantNesterovSequence,
    FixedNesterovSequence,
    NesterovExtrapolation,
    SimpleNesterovSequence,
)
from .algorithms import (
    AFBA,
    AFBAIteration,
    ChambollePock,
    FastForwardBackward,
    ForwardBackward,
    IterativeAlgorithm,
    VuCondat,
    afba_default_stepsizes,
    make_afba_iteration,
    make_chambolle_pock_iteration,
    make_fast_forward_backward_iteration,
    make_forward_backward_iteration,
    make_vu_condat_iteration,
)
from .convert import (
    box_qp_from_numpy,
    linop_from_jax,
    problems_from_numpy,
    prox_from_jax,
    tv_from_numpy,
)
from .prox.base import convex_conjugate
from .parallel import BatchedAlgorithm
from .utils.shared import Shared

__all__ = [
    "accel", "algorithms", "convert", "kernels", "ops", "parallel", "prox",
    "utils", "AdaptiveNesterovSequence", "AdaptiveRestartSequence",
    "ConstantNesterovSequence", "FixedNesterovSequence",
    "NesterovExtrapolation", "SimpleNesterovSequence", "FastForwardBackward",
    "ForwardBackward", "IterativeAlgorithm",
    "make_fast_forward_backward_iteration",
    "make_forward_backward_iteration", "AFBA", "AFBAIteration",
    "ChambollePock", "VuCondat", "afba_default_stepsizes",
    "make_afba_iteration", "make_chambolle_pock_iteration",
    "make_vu_condat_iteration", "convex_conjugate", "box_qp_from_numpy",
    "linop_from_jax", "problems_from_numpy", "prox_from_jax",
    "tv_from_numpy", "BatchedAlgorithm", "Shared",
]
