"""Batched lasso, box-QP and TV-denoising solvers with hand-written Hopper
kernels, and the read-floor probe (counterpart of ``proxtpu.kernels``).
Kernels are built at first launch, not at import."""

from .box_qp import (
    fused_pg_box_k_steps,
    fused_pg_box_step,
    reference_pg_box_k_steps,
    reference_pg_box_step,
    solve_box_qp_batch,
    solve_box_qp_batch_blocked,
)
from .probe import read_reduce, reference_read_reduce
from .tv import (
    default_tv_stepsizes,
    fused_cp_k_steps,
    mxu_cp_step,
    reference_cp_k_steps,
    reference_cp_step,
    solve_tv_batch,
)
from .lasso import (
    fused_fb_prox_grad,
    fused_fista_full_step,
    fused_fista_k_steps,
    fused_fista_packed_step,
    pack_lasso_batch,
    reference_fb_prox_grad,
    reference_fista_full_step,
    reference_fista_k_steps,
    reference_fista_packed_step,
    solve_lasso_batch,
    solve_lasso_batch_blocked,
    solve_lasso_batch_compacting,
    solve_lasso_batch_mixed,
    solve_lasso_batch_packed,
    solve_lasso_batch_packed_tail,
    solve_lasso_multirhs,
)

__all__ = [
    "fused_pg_box_k_steps", "fused_pg_box_step", "reference_pg_box_k_steps",
    "reference_pg_box_step", "solve_box_qp_batch",
    "solve_box_qp_batch_blocked", "fused_fb_prox_grad",
    "fused_fista_full_step", "fused_fista_k_steps", "fused_fista_packed_step",
    "pack_lasso_batch", "reference_fb_prox_grad", "reference_fista_full_step",
    "reference_fista_k_steps", "reference_fista_packed_step",
    "solve_lasso_batch", "solve_lasso_batch_blocked",
    "solve_lasso_batch_compacting", "solve_lasso_batch_mixed",
    "solve_lasso_batch_packed", "solve_lasso_batch_packed_tail",
    "solve_lasso_multirhs",
    "read_reduce", "reference_read_reduce", "default_tv_stepsizes",
    "fused_cp_k_steps", "mxu_cp_step", "reference_cp_k_steps",
    "reference_cp_step", "solve_tv_batch",
]
