"""Example: a full lasso regularization path in one batched solve.

The port of ``examples/lasso_path.py``: sweep lambda over 64 log-spaced
values and solve every point of the path at once (one batched FISTA drive
with the design matrix ``Shared`` by every lane), then the same path
through the shared-A solver ``solve_lasso_multirhs`` (two matrix products
a step for the whole path).  float32.

    python -m proxtpu_torch.examples.lasso_path
"""

import numpy as np
import torch

from ..algorithms import make_fast_forward_backward_iteration
from ..kernels import solve_lasso_multirhs
from ..parallel import Shared, batched_run_loop
from ..prox import LeastSquaresLoss, NormL1
from . import device_of


def main(verbose=False, device="cuda"):
    dev = device_of(device)
    rng = np.random.default_rng(0)
    m, n, k = 100, 200, 10
    A_np = (rng.standard_normal((m, n)) / np.sqrt(m)).astype(np.float32)
    x_true = np.zeros(n, np.float32)
    x_true[rng.choice(n, k, replace=False)] = rng.standard_normal(k)
    noise = rng.standard_normal(m).astype(np.float32)
    A = torch.tensor(A_np, device=dev)
    b = A @ torch.tensor(x_true, device=dev) + 0.01 * torch.tensor(
        noise, device=dev)

    lam_max = float(torch.max(torch.abs(A.T @ b)))
    lams = torch.tensor(
        np.geomspace(lam_max, 1e-3 * lam_max, 64).astype(np.float32),
        device=dev)
    Lf = float(np.linalg.norm(A_np, 2) ** 2)
    B = lams.shape[0]

    # the data is identical across the path, so it is Shared: one matrix
    # product a step carries every lane
    iteration = make_fast_forward_backward_iteration(
        x0=torch.zeros(B, n, device=dev),
        f=Shared(LeastSquaresLoss(A, b)),
        g=NormL1(lams),
        gamma=torch.full((B,), 1.0 / Lf, device=dev),
    )
    xs, iters, done = batched_run_loop(iteration, maxit=5000, tol=1e-5)
    nnz = torch.sum(torch.abs(xs) > 1e-6, dim=1)

    if verbose:
        print(f"{'lambda':>12} {'nnz':>5} {'iters':>6}")
        for i in range(0, B, 8):
            print(f"{float(lams[i]):12.5f} {int(nnz[i]):5d} "
                  f"{int(iters[i]):6d}")
        print(f"all converged: {bool(torch.all(done))}")

    # every path point shares the same design matrix: the shared-A solver
    Bmat = b.expand(B, m)
    xs2, iters2, done2 = solve_lasso_multirhs(A, Bmat, lams, Lf, 1e-5,
                                              maxit=5000)
    gap = float(torch.max(torch.abs(xs2 - xs)))
    if verbose:
        print(f"multirhs path: converged={bool(torch.all(done2))}, "
              f"matches vmapped path: {gap < 1e-3}")
    return {
        "lams": lams.cpu().numpy(), "xs": xs.cpu().numpy(),
        "iterations": iters.cpu().numpy(), "done": done.cpu().numpy(),
        "nnz": nnz.cpu().numpy(), "xs_multirhs": xs2.cpu().numpy(),
        "iterations_multirhs": iters2.cpu().numpy(),
        "done_multirhs": done2.cpu().numpy(), "multirhs_gap": gap,
        "agree": gap < 1e-3,
    }


if __name__ == "__main__":
    main(verbose=True)
