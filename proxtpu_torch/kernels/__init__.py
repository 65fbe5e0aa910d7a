"""Batched lasso solvers with hand-written Hopper kernels (counterpart of
``proxtpu.kernels``).  Kernels are built at first launch, not at import."""

from .lasso import (
    fused_fb_prox_grad,
    fused_fista_full_step,
    reference_fb_prox_grad,
    reference_fista_full_step,
    solve_lasso_batch,
    solve_lasso_batch_packed,
    solve_lasso_batch_packed_tail,
)

__all__ = [
    "fused_fb_prox_grad", "fused_fista_full_step", "reference_fb_prox_grad",
    "reference_fista_full_step", "solve_lasso_batch",
    "solve_lasso_batch_packed", "solve_lasso_batch_packed_tail",
]
