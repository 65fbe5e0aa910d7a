"""The library entry: ``BatchedAlgorithm`` over
``make_fast_forward_backward_iteration`` on ``LeastSquaresLoss(A, b)`` and
``NormL1(lam)`` from ``x0 = 0`` with the step ``1 / Lf``.

``use_kernels="auto"`` lets ``match_kernel_solver`` choose the solver;
``reference`` is FISTA without restart whose convergence test is sampled
every ``iter_block`` iterations, the semantics of the blocked solver that
the dispatch takes for lanes of ``BLOCKED_LANE_BYTES`` or more (the
configuration states ``iter_block``).
"""

from __future__ import annotations

import torch

from .. import reference as ref

# the launch counters of the wrappers this entry drives, and the kernel
# each counts (the traced run compares them with the trace's records)
COUNTED_KERNELS = {
    "fused_fb_prox_grad.launches": "fb_step_kernel",
    "fused_fista_full_step.launches": "fista_step_kernel",
    "fused_fista_k_steps.launches": "fista_k_steps_kernel",
}


def program(config):
    import proxtpu_torch as pt
    from proxtpu_torch.prox import LeastSquaresLoss, NormL1

    s = config["solver"]
    solver = pt.BatchedAlgorithm(pt.make_fast_forward_backward_iteration,
                                 maxit=s["maxit"], tol=s["tol"],
                                 use_kernels="auto")

    def solve(batch):
        A, b, lam, Lf = batch
        x0 = torch.zeros((A.shape[0], A.shape[2]), dtype=A.dtype,
                         device=A.device)
        return solver(x0=x0, f=LeastSquaresLoss(A, b), g=NormL1(lam), Lf=Lf)

    return solve


def reference(config, prec="exact", dtype=torch.float64):
    s = config["solver"]

    def solve(batch):
        A, b, lam, Lf = batch
        return ref.fista(A, b, lam, Lf, s["tol"], s["maxit"],
                         K=s["iter_block"], prec=prec, dtype=dtype)

    return solve
