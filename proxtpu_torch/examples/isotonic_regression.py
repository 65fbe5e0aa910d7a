"""Example: isotonic (monotone) regression via the polyhedral projection.

    minimize  1/2 ||A x - b||^2   subject to  x_1 <= x_2 <= ... <= x_n

The port of ``examples/isotonic_regression.py``: the monotonicity
constraints are the polyhedron {D x >= 0} of the forward-difference matrix
D (``IndPolyhedral``); with A = I this is classical isotonic regression,
with a general A shape-constrained least squares.  float64.

    python -m proxtpu_torch.examples.isotonic_regression
"""

import numpy as np
import torch

from ..algorithms import FastForwardBackward, ForwardBackward
from ..prox import IndPolyhedral, make_least_squares
from . import device_of


def main(verbose=False, device="cuda"):
    dev = device_of(device)

    def t(a):
        return torch.tensor(a, device=dev)

    rng = np.random.default_rng(0)
    n = 40
    truth = np.sort(np.cumsum(rng.standard_normal(n) * 0.3))
    y = truth + 0.5 * rng.standard_normal(n)

    D = np.zeros((n - 1, n))
    for i in range(n - 1):
        D[i, i], D[i, i + 1] = -1.0, 1.0
    mono = IndPolyhedral(t(D), t(np.zeros(n - 1)), t(np.full(n - 1, np.inf)))

    # A = I: classical isotonic regression
    x, it = ForwardBackward(tol=1e-8, maxit=5000)(
        x0=t(np.zeros(n)),
        f=make_least_squares(t(np.eye(n)), t(y)),
        g=mono,
        Lf=1.0,
    )
    x = x.cpu().numpy()

    # shape-constrained least squares: a general design matrix
    m = 60
    A = rng.standard_normal((m, n)) / np.sqrt(m)
    b = A @ truth + 0.1 * rng.standard_normal(m)
    Lf = float(np.linalg.norm(A, 2) ** 2)
    xg, itg = FastForwardBackward(tol=1e-8, maxit=10000)(
        x0=t(np.zeros(n)),
        f=make_least_squares(t(A), t(b)),
        g=mono,
        Lf=Lf,
    )
    xg = xg.cpu().numpy()

    out = {
        "iterations": int(it),
        "iterations_general": int(itg),
        "monotone": bool(np.all(np.diff(x) >= -1e-7)),
        "monotone_general": bool(np.all(np.diff(xg) >= -1e-7)),
        "mse_vs_truth": float(np.mean((x - truth) ** 2)),
        "mse_noisy": float(np.mean((y - truth) ** 2)),
    }
    if verbose:
        print(f"isotonic fit:  {out['iterations']} iterations, "
              f"monotone={out['monotone']}")
        print(f"general A fit: {out['iterations_general']} iterations, "
              f"monotone={out['monotone_general']}")
        print(f"MSE noisy {out['mse_noisy']:.4f} -> isotonic "
              f"{out['mse_vs_truth']:.4f}")
    return out


if __name__ == "__main__":
    main(verbose=True)
