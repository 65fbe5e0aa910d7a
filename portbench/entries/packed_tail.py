"""The main path's entry: ``solve_lasso_batch_packed_tail``.

``program`` is the system under test; ``reference`` the plain version of
the same schedule (:func:`portbench.reference.packed_tail`), which imports
nothing of the program.
"""

from __future__ import annotations

import torch

from .. import reference as ref

# the launch counters of the wrappers this entry drives, and the kernel
# each counts (the traced run compares them with the trace's records)
COUNTED_KERNELS = {
    "fused_fb_prox_grad.launches": "fb_step_kernel",
    "fused_fista_full_step.launches": "fista_step_kernel",
    "fused_fista_packed_step.launches": "fista_packed_step_kernel",
}


def program(config):
    from proxtpu_torch.kernels.lasso import solve_lasso_batch_packed_tail

    s = config["solver"]

    def solve(batch):
        A, b, lam, Lf = batch
        return solve_lasso_batch_packed_tail(
            A, b, lam, Lf, s["tol"], maxit=s["maxit"], k1=s["k1"],
            tail=s["tail"], restart=s["restart"])

    return solve


def reference(config, prec="exact", dtype=torch.float64):
    s = config["solver"]

    def solve(batch):
        A, b, lam, Lf = batch
        return ref.packed_tail(A, b, lam, Lf, s["tol"], s["maxit"],
                               k1=s["k1"], tail=s["tail"],
                               restart=s["restart"], prec=prec, dtype=dtype)

    return solve
