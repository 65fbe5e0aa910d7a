"""Utilities of the port: precision policy, tree operations, shared-lane
markers and the forward-backward toolkit."""

from .precision import pdot, pmatvec, require_full_f32_matmul
from .shared import Shared

__all__ = ["pdot", "pmatvec", "require_full_f32_matmul", "Shared"]
