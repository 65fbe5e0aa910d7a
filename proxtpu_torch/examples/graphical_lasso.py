"""Example: graphical lasso — sparse inverse covariance estimation.

    minimize_{Theta > 0}  tr(S Theta) - logdet(Theta) + lam * ||Theta||_1,off

The port of ``examples/graphical_lasso.py``: Douglas-Rachford over a matrix
iterate with f = Tilt(NegLogDet(1), S) (its prox diagonalizes by ``eigh``
and keeps every iterate positive definite) and g = NormL1(lam * (1 - I))
(off-diagonal soft-thresholding); the lam path is one
``torch.func.vmap`` of a fixed 500-step drive.  float64.

    python -m proxtpu_torch.examples.graphical_lasso
"""

import numpy as np
import torch

from ..algorithms import DouglasRachford, DouglasRachfordIteration
from ..prox import NegLogDet, NormL1, Tilt
from . import device_of


def make_problem(n=20, density=0.1, seed=0):
    """Sparse SPD precision matrix and its exact covariance (numpy)."""
    rng = np.random.default_rng(seed)
    P = np.zeros((n, n))
    idx = rng.random((n, n)) < density
    vals = rng.uniform(0.3, 0.8, (n, n)) * np.sign(rng.standard_normal((n, n)))
    P[idx] = vals[idx]
    P = (P + P.T) / 2
    np.fill_diagonal(P, np.abs(P).sum(axis=1) + 0.5)
    S = np.linalg.inv(P)
    return P, (S + S.T) / 2


def solve_glasso(S, lam, gamma=2.0, tol=1e-8, maxit=3000):
    n = S.shape[0]
    eye = torch.eye(n, dtype=S.dtype, device=S.device)
    f = Tilt(NegLogDet(1.0), S)
    g = NormL1(lam * (1.0 - eye))
    return DouglasRachford(gamma=gamma, tol=tol, maxit=maxit)(
        x0=eye, f=f, g=g
    )


def solve_glasso_path(S, lams, gamma=2.0, iters=500):
    """One vmapped DR drive over the whole lam path (fixed iteration
    budget; per-lam convergence is checked by the caller via KKT)."""
    n = S.shape[0]
    eye = torch.eye(n, dtype=S.dtype, device=S.device)

    def run(lam):
        it = DouglasRachfordIteration(
            f=Tilt(NegLogDet(1.0), S),
            g=NormL1(lam * (1.0 - eye)),
            x0=eye,
            gamma=torch.as_tensor(gamma, dtype=S.dtype, device=S.device),
        )
        s = it.init()
        for _ in range(iters):
            s = it.step(s)
        return s.y

    return torch.func.vmap(run)(lams)


def main(verbose=False, device="cuda"):
    dev = device_of(device)
    P, S_np = make_problem()
    S = torch.tensor(S_np, device=dev)
    n = S.shape[0]
    off = ~np.eye(n, dtype=bool)
    true_edges = off & (np.abs(P) > 1e-12)

    lams = np.geomspace(0.005, 0.3, 16)
    thetas = solve_glasso_path(S, torch.tensor(lams, device=dev))
    thetas = thetas.cpu().numpy()

    rows = []
    for i, lam in enumerate(lams):
        T = (thetas[i] + thetas[i].T) / 2
        est_edges = off & (np.abs(T) > 1e-5)
        tp = int((est_edges & true_edges).sum())
        fp = int((est_edges & ~true_edges).sum())
        rows.append((float(lam), int(est_edges.sum()) // 2, tp, fp))
        if verbose:
            print(
                f"lam={lam:8.4f}  edges={rows[-1][1]:3d}  "
                f"true-pos={tp // 2:3d}  false-pos={fp // 2:3d}"
            )

    # single solve at a moderate lam, with the KKT certificate
    lam = 0.05
    theta, it = solve_glasso(S, lam)
    theta = theta.cpu().numpy()
    T = (theta + theta.T) / 2
    G = S_np - np.linalg.inv(T)
    kkt_diag = float(np.max(np.abs(G[np.eye(n, dtype=bool)])))
    nz = off & (np.abs(T) > 1e-6)
    kkt_nz = (float(np.max(np.abs(G[nz] + lam * np.sign(T[nz]))))
              if nz.any() else 0.0)
    kkt_z = float(np.max(np.abs(G[off & ~nz]))) if (off & ~nz).any() else 0.0

    if verbose:
        print(
            f"\nlam={lam}: {int(it)} DR iterations, "
            f"KKT diag {kkt_diag:.2e} | nonzero {kkt_nz:.2e} | "
            f"zero-bound {kkt_z:.3f} <= lam={lam}"
        )

    return {
        "iterations": int(it),
        "kkt_diag": kkt_diag,
        "kkt_nz": kkt_nz,
        "kkt_zero_bound_ok": kkt_z <= lam + 1e-6,
        "path": rows,
        "min_eig": float(np.linalg.eigvalsh(T).min()),
    }


if __name__ == "__main__":
    main(verbose=True)
