"""proxtpu_torch: the PyTorch / CUDA port of proxtpu for NVIDIA Hopper.

The JAX package ``proxtpu`` stays the reference; this package mirrors its
module paths and function names, so each counterpart is found under the same
name.  It imports ``torch`` and never ``jax``.  Its hot steps are CUDA
kernels written by hand for ``sm_90a`` (``proxtpu_torch/csrc``), built with
``nvcc`` at first use; importing the package builds and loads nothing.

* :mod:`proxtpu_torch.kernels`  — batched lasso FISTA solvers and their
  kernels
* :mod:`proxtpu_torch.parallel` — pipelined dispatch of batched solves
* :mod:`proxtpu_torch.convert`  — problems from numpy into tensors
* :mod:`proxtpu_torch.utils`    — the float32 matmul precision policy
"""

from . import convert, kernels, parallel, utils
from .convert import problems_from_numpy

__all__ = ["convert", "kernels", "parallel", "utils", "problems_from_numpy"]
