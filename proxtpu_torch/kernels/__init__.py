"""Batched lasso and box-QP solvers with hand-written Hopper kernels
(counterpart of ``proxtpu.kernels``).  Kernels are built at first launch,
not at import."""

from .box_qp import (
    fused_pg_box_k_steps,
    fused_pg_box_step,
    reference_pg_box_k_steps,
    reference_pg_box_step,
    solve_box_qp_batch,
    solve_box_qp_batch_blocked,
)
from .lasso import (
    fused_fb_prox_grad,
    fused_fista_full_step,
    fused_fista_k_steps,
    reference_fb_prox_grad,
    reference_fista_full_step,
    reference_fista_k_steps,
    solve_lasso_batch,
    solve_lasso_batch_blocked,
    solve_lasso_batch_packed,
    solve_lasso_batch_packed_tail,
)

__all__ = [
    "fused_pg_box_k_steps", "fused_pg_box_step", "reference_pg_box_k_steps",
    "reference_pg_box_step", "solve_box_qp_batch",
    "solve_box_qp_batch_blocked", "fused_fb_prox_grad",
    "fused_fista_full_step", "fused_fista_k_steps", "reference_fb_prox_grad",
    "reference_fista_full_step", "reference_fista_k_steps",
    "solve_lasso_batch", "solve_lasso_batch_blocked",
    "solve_lasso_batch_packed", "solve_lasso_batch_packed_tail",
]
