"""proxtpu_torch: the PyTorch / CUDA port of proxtpu for NVIDIA Hopper.

The JAX package ``proxtpu`` stays the reference; this package mirrors its
module paths and function names, so each counterpart is found under the same
name.  It imports ``torch`` and never ``jax``.  Its hot steps are CUDA
kernels written by hand for ``sm_90a`` (``proxtpu_torch/csrc``), built with
``nvcc`` at first use; importing the package builds and loads nothing.

* :mod:`proxtpu_torch.algorithms` — the reference's solver suite (FB,
  FISTA, ZeroFPR, PANOC, PANOCplus, Douglas-Rachford, DRLS, Davis-Yin,
  Li-Lin, SFISTA, AFBA, Vu-Condat, Chambolle-Pock) with the generic driver,
  its recording, resume and ``states``
* :mod:`proxtpu_torch.prox`       — the oracle protocol and prox functions
* :mod:`proxtpu_torch.accel`      — L-BFGS, Anderson, Broyden and the
  Nesterov coefficient sequences
* :mod:`proxtpu_torch.ops`        — identity, zero, dense, stacked and 2-D
  gradient operators
* :mod:`proxtpu_torch.kernels`    — batched lasso, box-QP and TV-denoising
  solvers, their kernels, the read-floor probe and the kernel-route dispatch
* :mod:`proxtpu_torch.parallel`   — ``BatchedAlgorithm``, the batched
  drivers (recorded, segmented, compacting), pipelined dispatch of
  batched solves
* :mod:`proxtpu_torch.convert`    — problems from numpy and from the JAX
  package's objects into tensors
* :mod:`proxtpu_torch.utils`      — tree operations, iteration tools,
  checkpoints, profiling, the matmul precision switch
  (``set_matmul_precision``), shared-lane markers, the FB toolkit
"""

from . import accel, algorithms, convert, kernels, ops, parallel, prox, utils
from .accel import (
    LBFGS,
    AdaptiveNesterovSequence,
    AdaptiveRestartSequence,
    AndersonAcceleration,
    Broyden,
    ConstantNesterovSequence,
    FixedNesterovSequence,
    NesterovExtrapolation,
    NoAcceleration,
    SimpleNesterovSequence,
)
from .algorithms import *  # noqa: F401,F403
from .algorithms import __all__ as _algorithms
from .convert import (
    box_qp_from_numpy,
    direction_from_jax,
    linop_from_jax,
    problems_from_numpy,
    prox_from_jax,
    tv_from_numpy,
)
from .prox.base import (
    AutoDifferentiable,
    IndZero,
    Zero,
    convex_conjugate,
    value_and_gradient,
)
from .parallel import BatchedAlgorithm
from .utils.fb_tools import (
    backtrack_stepsize,
    f_model,
    lower_bound_smoothness_constant,
)
from .utils.precision import get_matmul_precision, set_matmul_precision
from .utils.shared import Shared

__version__ = "0.5.0"

__all__ = [
    "accel", "algorithms", "convert", "kernels", "ops", "parallel", "prox",
    "utils", "LBFGS", "AdaptiveNesterovSequence", "AdaptiveRestartSequence",
    "AndersonAcceleration", "Broyden", "ConstantNesterovSequence",
    "FixedNesterovSequence", "NesterovExtrapolation", "NoAcceleration",
    "SimpleNesterovSequence", *_algorithms, "AutoDifferentiable", "IndZero",
    "Zero", "convex_conjugate", "value_and_gradient",
    "box_qp_from_numpy", "direction_from_jax", "linop_from_jax",
    "problems_from_numpy", "prox_from_jax", "tv_from_numpy",
    "BatchedAlgorithm", "Shared", "backtrack_stepsize", "f_model",
    "lower_bound_smoothness_constant", "get_matmul_precision",
    "set_matmul_precision",
]
