"""Example: compare solver convergence curves with on-device recording.

The port of ``examples/convergence_curves.py``: one lasso instance, three
solvers (FISTA, PANOC, ZeroFPR), the fixed-point residual
``||x - z||_inf / gamma`` recorded every iteration into buffers on the
device (``run_recorded``), then the curves side by side.  float64, as the
script's numpy data.

    python -m proxtpu_torch.examples.convergence_curves
"""

import numpy as np
import torch

from ..algorithms import PANOC, FastForwardBackward, ZeroFPR
from ..prox import NormL1, make_least_squares
from ..utils.tree import tree_inf_norm
from . import device_of

TOL = 1e-5
MAXIT = 1000


def residual(iteration, k, state):
    return tree_inf_norm(state.res) / state.gamma


def main(verbose=False, device="cuda"):
    dev = device_of(device)
    rng = np.random.default_rng(3)
    m, n = 60, 120
    A_np = rng.standard_normal((m, n)) / np.sqrt(m)
    b_np = rng.standard_normal(m)
    A, b = torch.tensor(A_np, device=dev), torch.tensor(b_np, device=dev)
    lam = 0.1 * float(np.max(np.abs(A_np.T @ b_np)))
    Lf = float(np.linalg.norm(A_np, 2) ** 2)
    problem = dict(
        x0=torch.zeros(n, dtype=A.dtype, device=dev),
        f=make_least_squares(A, b), g=NormL1(lam), Lf=Lf,
    )

    solvers = {
        "FISTA": FastForwardBackward(tol=TOL, maxit=MAXIT),
        "PANOC": PANOC(tol=TOL, maxit=MAXIT),
        "ZeroFPR": ZeroFPR(tol=TOL, maxit=MAXIT),
    }
    out = {}
    for name, solver in solvers.items():
        x, it, tr = solver.run_recorded(residual, **problem)
        out[name] = dict(x=x.cpu().numpy(), it=int(it),
                         curve=tr.valid().cpu().numpy())

    # all solvers agree on the minimizer
    ref = out["FISTA"]["x"]
    for name, r in out.items():
        gap = float(np.max(np.abs(r["x"] - ref)))
        assert gap < 2e-3, f"{name} disagrees with FISTA by {gap}"

    if verbose:
        ks = [1, 2, 5, 10, 20, 50, 100, 200, 500, MAXIT]
        print(f"{'iter':>6} | " + " | ".join(f"{s:>10}" for s in out))
        for k in ks:
            row = []
            for r in out.values():
                c = r["curve"]
                row.append(f"{c[k - 1]:10.2e}" if k <= len(c) else " " * 10)
            print(f"{k:>6} | " + " | ".join(row))
        print("iterations to tol=%g: " % TOL
              + ", ".join(f"{s}={r['it']}" for s, r in out.items()))
    return out


if __name__ == "__main__":
    main(verbose=True)
