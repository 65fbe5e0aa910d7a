"""proxtpu_torch: the PyTorch / CUDA port of proxtpu for NVIDIA Hopper.

The JAX package ``proxtpu`` stays the reference; this package mirrors its
module paths and function names, so each counterpart is found under the same
name.  It imports ``torch`` and never ``jax``.  Its hot steps are CUDA
kernels written by hand for ``sm_90a`` (``proxtpu_torch/csrc``), built with
``nvcc`` at first use; importing the package builds and loads nothing.

* :mod:`proxtpu_torch.algorithms` — FB and FISTA with the generic driver
* :mod:`proxtpu_torch.prox`       — the oracle protocol and prox functions
* :mod:`proxtpu_torch.accel`      — Nesterov coefficient sequences
* :mod:`proxtpu_torch.ops`        — identity and dense operators
* :mod:`proxtpu_torch.kernels`    — batched lasso and box-QP solvers, their
  kernels, and the kernel-route dispatch
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
    FastForwardBackward,
    ForwardBackward,
    IterativeAlgorithm,
    make_fast_forward_backward_iteration,
    make_forward_backward_iteration,
)
from .convert import box_qp_from_numpy, problems_from_numpy, prox_from_jax
from .parallel import BatchedAlgorithm
from .utils.shared import Shared

__all__ = [
    "accel", "algorithms", "convert", "kernels", "ops", "parallel", "prox",
    "utils", "AdaptiveNesterovSequence", "AdaptiveRestartSequence",
    "ConstantNesterovSequence", "FixedNesterovSequence",
    "NesterovExtrapolation", "SimpleNesterovSequence", "FastForwardBackward",
    "ForwardBackward", "IterativeAlgorithm",
    "make_fast_forward_backward_iteration",
    "make_forward_backward_iteration", "box_qp_from_numpy",
    "problems_from_numpy", "prox_from_jax", "BatchedAlgorithm", "Shared",
]
