"""Utilities of the port."""

from .precision import require_full_f32_matmul

__all__ = ["require_full_f32_matmul"]
