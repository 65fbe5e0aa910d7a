"""Example: robust PCA — split a matrix into low-rank + sparse parts.

min_{L,S}  1/2 ||L + S - M||_F^2 + lam_L ||L||_* + lam_S ||S||_1

The port of ``examples/robust_pca.py``: a tuple iterate (L, S) under the
three-term Davis-Yin splitting, a smooth coupling term with a hand-written
``value_and_gradient``, and ``SeparableSum`` routing each prox to its block
(nuclear-norm SVD shrinkage on L, soft-thresholding on S).  float32, the
script's size, seed and cap.

    python -m proxtpu_torch.examples.robust_pca
"""

from dataclasses import dataclass

import numpy as np
import torch

from ..algorithms import DavisYin
from ..prox import NormL1, NuclearNorm, SeparableSum, Zero
from . import device_of


@dataclass(frozen=True)
class CouplingLoss:
    """f(L, S) = 1/2 ||L + S - M||_F^2 with a hand gradient (Lf = 2)."""

    M: object

    is_convex = True
    is_generalized_quadratic = True

    def __call__(self, x):
        L, S = x
        r = L + S - self.M
        return torch.sum(r * r) / 2

    def value_and_gradient(self, x):
        L, S = x
        r = L + S - self.M
        return torch.sum(r * r) / 2, (r, r)


def problem(device):
    """The script's data: ``(M, L_true, mask, r)`` with M on ``device``."""
    rng = np.random.default_rng(0)
    m, n, r, p_sparse = 60, 50, 4, 0.05
    U = rng.standard_normal((m, r)) / np.sqrt(m)
    V = rng.standard_normal((r, n))
    L_true = (U @ V).astype(np.float32) * 3.0
    S_true = np.zeros((m, n), np.float32)
    mask = rng.random((m, n)) < p_sparse
    S_true[mask] = 2.0 * np.sign(rng.standard_normal(mask.sum()))
    return torch.tensor(L_true + S_true, device=device), L_true, mask, r


def main(verbose=False, device="cuda"):
    dev = device_of(device)
    M, L_true, mask, r = problem(dev)
    m, n = M.shape

    lam_L = 0.25
    lam_S = 0.06
    g = SeparableSum((NuclearNorm(lam_L), Zero()))   # low-rank block
    h = SeparableSum((Zero(), NormL1(lam_S)))        # sparse block

    solver = DavisYin(tol=1e-6, maxit=5000)
    (L, S), it = solver(
        x0=(torch.zeros(m, n, device=dev), torch.zeros(m, n, device=dev)),
        f=CouplingLoss(M), g=g, h=h, Lf=2.0,
    )

    L, S = L.cpu().numpy(), S.cpu().numpy()
    sv = np.linalg.svd(L, compute_uv=False)
    # true singular values are >= 16, the largest shrinkage leak ~0.3
    rank = int((sv > 0.05 * sv[0]).sum())
    supp_hat = np.abs(S) > 0.2
    tp = (supp_hat & mask).sum()
    if verbose:
        print(f"iterations: {int(it)}")
        print(f"recovered rank: {rank} (true {r})")
        print(f"sparse support: {supp_hat.sum()} nonzeros, "
              f"{tp}/{mask.sum()} true corruptions hit")
        rel = float(np.linalg.norm(L - L_true) / np.linalg.norm(L_true))
        print(f"relative low-rank error: {rel:.4f}")
    return {
        "iterations": int(it), "rank": rank, "true_rank": r,
        "support_hat": supp_hat, "support_true": mask,
        "L": L, "S": S,
    }


if __name__ == "__main__":
    main(verbose=True)
