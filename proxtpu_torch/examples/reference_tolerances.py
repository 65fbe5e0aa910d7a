"""Example: reference-grade tolerances (1e-6 .. 1e-8), warm-started.

The port of ``examples/reference_tolerances.py``: a 16-point lasso path
solved to tol 1e-8 by ``WarmStartedBatchedAlgorithm`` (a float32 stage to
the float32 noise floor, then the float64 polish from the warm iterate
under the same stopping criterion, with adaptive restart at tol <= 1e-8),
every point's residual recomputed in float64 on the host.

    python -m proxtpu_torch.examples.reference_tolerances
"""

import numpy as np
import torch

from ..accel import AdaptiveRestartSequence
from ..algorithms import make_fast_forward_backward_iteration
from ..parallel import Shared, WarmStartedBatchedAlgorithm
from ..prox import LeastSquaresLoss, NormL1
from . import device_of


def main(m=40, n=80, path_points=16, tol=1e-8, verbose=False,
         device="cuda"):
    dev = device_of(device)
    rng = np.random.default_rng(0)
    A64 = rng.standard_normal((m, n)) / np.sqrt(m)
    b64 = rng.standard_normal(m)
    A, b = torch.tensor(A64, device=dev), torch.tensor(b64, device=dev)
    lam_max = float(np.max(np.abs(A64.T @ b64)))
    lams = torch.tensor(
        np.geomspace(0.5 * lam_max, 0.02 * lam_max, path_points),
        device=dev)
    Lf = float(np.linalg.norm(A64, 2) ** 2)

    # at tol <= 1e-8, adaptive restart caps the slow lanes' momentum
    # oscillation; at 1e-6 leave it off
    restart = (dict(extrapolation_sequence=AdaptiveRestartSequence())
               if tol <= 1e-8 else {})
    solver = WarmStartedBatchedAlgorithm(
        make_fast_forward_backward_iteration,
        maxit=100_000, tol=tol, use_kernels=False, **restart,
    )
    xs, iters, done = solver(
        x0=torch.zeros(path_points, n, dtype=torch.float64, device=dev),
        f=Shared(LeastSquaresLoss(A, b)), g=NormL1(lams), Lf=Lf,
    )
    assert bool(torch.all(done)), "every path point must converge"

    # recompute the stopping quantity on the host: each solution must
    # satisfy the float64 criterion
    xs = xs.cpu().numpy()
    lams = lams.cpu().numpy()
    gam = 1.0 / Lf
    worst = 0.0
    for i in range(path_points):
        x = xs[i]
        y = x - gam * (A64.T @ (A64 @ x - b64))
        z = np.sign(y) * np.maximum(np.abs(y) - gam * float(lams[i]), 0.0)
        worst = max(worst, float(np.max(np.abs(x - z)) / gam))
    nnz = np.sum(np.abs(xs) > 10 * tol, axis=1)
    iters = iters.cpu().numpy()

    if verbose:
        print(f"solved {path_points}-point lasso path to tol={tol:g} in f64")
        print(f"per-lane iterations (warm stage included): "
              f"{iters.min()}..{iters.max()}")
        print(f"worst recomputed residual: {worst:.2e} (tol {tol:g})")
        print(f"support sizes along the path: {nnz.tolist()}")
    return {"iters": iters, "worst_residual": worst, "nnz": nnz, "xs": xs}


if __name__ == "__main__":
    main(verbose=True)
