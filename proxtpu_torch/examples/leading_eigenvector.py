"""Example: leading eigenvector as sphere-constrained nonconvex PANOC.

max_x  x' Q x / 2   s.t. ||x|| = 1
  ==  min_x  f(x) = -x' Q x / 2  +  IndSphereL2(1)(x)

The port of ``examples/leading_eigenvector.py``: the sphere is nonconvex,
its prox is the radial projection, and the fixed points of the FB map are
the eigenvectors; descent from a generic start selects the leading one.
float64.

    python -m proxtpu_torch.examples.leading_eigenvector
"""

import numpy as np
import torch

from ..algorithms import PANOC
from ..prox import IndSphereL2, Quadratic
from . import device_of


def main(verbose=False, device="cuda"):
    dev = device_of(device)
    rng = np.random.default_rng(5)
    n = 64
    S = rng.standard_normal((n, n))
    Q_np = (S + S.T) / 2
    Q = torch.tensor(Q_np, device=dev)

    w, V = np.linalg.eigh(Q_np)
    Lf = float(np.max(np.abs(w)))

    x0 = torch.tensor(rng.standard_normal(n), device=dev)
    x0 = x0 / torch.linalg.norm(x0)

    x, it = PANOC(tol=1e-10, maxit=2000)(
        x0=x0, f=Quadratic(-Q, torch.zeros(n, dtype=Q.dtype, device=dev)),
        g=IndSphereL2(1.0), Lf=Lf, adaptive=False,
    )

    rayleigh = float(x @ (Q @ x))
    v_top = V[:, -1]
    align = abs(float(x.cpu().numpy() @ v_top))
    if verbose:
        print(f"iterations: {int(it)}")
        print(f"Rayleigh quotient: {rayleigh:.10f}  (lam_max {w[-1]:.10f})")
        print(f"|<x, v_max>| = {align:.10f}")
    return {"iterations": int(it), "rayleigh": rayleigh,
            "lam_max": float(w[-1]), "align": align}


if __name__ == "__main__":
    main(verbose=True)
