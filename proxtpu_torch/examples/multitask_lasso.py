"""Example: multi-task (group) lasso — joint row-sparse recovery.

min_X  1/2 ||A X - B||_F^2 + lam * sum_i ||X[i, :]||_2

The port of ``examples/multitask_lasso.py``: T regression tasks share the
design matrix A and the active feature set; the l2,1 penalty couples them
so features switch on and off jointly.  The iterate is the whole (n, T)
coefficient matrix, and FISTA runs on it unchanged.  float32.

    python -m proxtpu_torch.examples.multitask_lasso
"""

import numpy as np
import torch

from ..algorithms import FastForwardBackward
from ..prox import LeastSquaresLoss, NormL21
from . import device_of


def main(verbose=False, device="cuda"):
    dev = device_of(device)
    rng = np.random.default_rng(0)
    m, n, T, k = 80, 160, 6, 8
    A_np = (rng.standard_normal((m, n)) / np.sqrt(m)).astype(np.float32)
    support = np.sort(rng.choice(n, k, replace=False))
    X_true = np.zeros((n, T), np.float32)
    X_true[support] = rng.standard_normal((k, T)) + np.sign(
        rng.standard_normal((k, 1))
    ) * 2.0
    B_np = A_np @ X_true + 0.01 * rng.standard_normal((m, T)).astype(
        np.float32)
    A, B = torch.tensor(A_np, device=dev), torch.tensor(B_np, device=dev)

    lam = 0.1 * float(torch.max(torch.linalg.norm(A.T @ B, dim=1)))
    Lf = float(np.linalg.norm(A_np, 2) ** 2)

    solver = FastForwardBackward(tol=1e-6, maxit=20_000)
    X, it = solver(
        x0=torch.zeros(n, T, device=dev),
        f=LeastSquaresLoss(A, B),
        g=NormL21(lam, axis=1),   # rows are the groups: joint selection
        Lf=Lf,
    )

    X = X.cpu().numpy()
    row_norms = np.linalg.norm(X, axis=1)
    selected = np.sort(np.nonzero(row_norms > 0.1)[0])
    if verbose:
        print(f"iterations: {int(it)}")
        print(f"true support: {support.tolist()}")
        print(f"selected    : {selected.tolist()}")
        resid = float(np.linalg.norm(A_np @ X - B_np)
                      / np.linalg.norm(B_np))
        print(f"relative residual: {resid:.4f}")
    return {
        "iterations": int(it),
        "support": support,
        "selected": selected,
        "X": X,
    }


if __name__ == "__main__":
    main(verbose=True)
