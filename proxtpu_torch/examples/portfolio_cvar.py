"""Example: minimum-CVaR portfolio via Chambolle-Pock.

    min_w  CVaR_k(-R w)     s.t.  w >= 0,  sum w = 1

The port of ``examples/portfolio_cvar.py``: CVaR_k (the mean of the k
largest scenario losses) is ``SumLargest(k, 1/k)`` composed with L = -R,
and the simplex is ``IndSimplex(1)``; Chambolle-Pock needs only their
proxes.  float64.

    python -m proxtpu_torch.examples.portfolio_cvar
"""

import numpy as np
import torch

from ..algorithms import ChambollePock
from ..prox import IndSimplex, SumLargest
from . import device_of


def cvar(losses, k):
    """Average of the k largest scenario losses (numpy, for reporting)."""
    return float(np.mean(np.sort(np.asarray(losses))[-k:]))


def main(verbose=False, device="cuda"):
    dev = device_of(device)
    rng = np.random.default_rng(12)
    S, n, k = 250, 8, 25  # 250 scenarios, 8 assets, CVaR over worst 10%

    # factor model: asset returns = exposures @ factors + idiosyncratic
    expo = rng.standard_normal((n, 3)) * 0.5
    factors = rng.standard_normal((S, 3))
    mu = np.linspace(0.08, 0.01, n)
    R = (mu[None, :] + factors @ expo.T * 0.1
         + 0.05 * rng.standard_normal((S, n)))
    R = R.astype(np.float64)

    L = torch.tensor(-R, device=dev)  # losses per scenario
    opnorm = float(np.linalg.norm(-R, 2))
    gam = 0.9 / opnorm

    # gamma1 * gamma2 * ||L||^2 < 1 is the Chambolle-Pock stepsize condition
    w, it = ChambollePock(maxit=50_000, tol=1e-6)(
        x0=torch.full((n,), 1.0 / n, dtype=L.dtype, device=dev),
        y0=torch.zeros(S, dtype=L.dtype, device=dev),
        g=IndSimplex(1.0),
        h=SumLargest(k, 1.0 / k),
        L=L,
        gamma1=gam, gamma2=gam,
    )
    w_np = (w[0] if isinstance(w, tuple) else w).cpu().numpy()

    cvar_opt = cvar(-R @ w_np, k)
    cvar_eq = cvar(-R @ (np.ones(n) / n), k)
    if verbose:
        print(f"converged in {int(it)} iterations")
        print("weights:", np.round(w_np, 4))
        print(f"CVaR(10%): optimized {cvar_opt:.4f}  vs equal-weight "
              f"{cvar_eq:.4f}")

    return {
        "weights": w_np,
        "iterations": int(it),
        "cvar_opt": cvar_opt,
        "cvar_equal_weight": cvar_eq,
        "R": R,
        "k": k,
    }


if __name__ == "__main__":
    main(verbose=True)
