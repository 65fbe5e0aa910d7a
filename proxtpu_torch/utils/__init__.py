"""Utilities of the port: tree operations, iteration tools, checkpoints,
profiling, the precision policy, shared-lane markers and the
forward-backward toolkit."""

from . import checkpoint, iteration_tools, profiling, tree
from .precision import get_matmul_precision, pdot, pmatvec, \
    require_full_f32_matmul, set_matmul_precision
from .shared import Shared

__all__ = ["tree", "iteration_tools", "checkpoint", "profiling", "pdot",
           "pmatvec", "require_full_f32_matmul", "set_matmul_precision",
           "get_matmul_precision", "Shared"]
