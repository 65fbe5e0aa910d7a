"""Example: a soft-margin SVM regularization path in one batched solve.

min_x (1/m) sum_i max(0, 1 - y_i <a_i, x>) + lam/2 ||x||^2

The port of ``examples/svm_path.py``: the hinge term is composed with the
data matrix, so each solve is a primal-dual (Chambolle-Pock, AFBA with
theta = 2) run; the lam sweep is one ``BatchedAlgorithm`` drive with the
data ``Shared`` by every lane.  float32.

    python -m proxtpu_torch.examples.svm_path
"""

import numpy as np
import torch

from ..algorithms.primal_dual import make_afba_iteration
from ..parallel import BatchedAlgorithm, Shared
from ..prox import HingeLoss, SqrNormL2
from . import device_of


def main(verbose=False, device="cuda"):
    dev = device_of(device)
    rng = np.random.default_rng(0)
    m, n, B = 200, 50, 16
    w_true = rng.standard_normal(n)
    A_np = (rng.standard_normal((m, n)) / np.sqrt(n)).astype(np.float32)
    y_np = np.sign(A_np @ w_true + 0.2 * rng.standard_normal(m)).astype(
        np.float32)
    A, y = torch.tensor(A_np, device=dev), torch.tensor(y_np, device=dev)

    lams = torch.tensor(np.geomspace(1e-3, 1.0, B).astype(np.float32),
                        device=dev)
    opnorm = float(np.linalg.norm(A_np, 2))
    gam = torch.full((B,), 0.9 / opnorm, device=dev)

    solver = BatchedAlgorithm(
        make_afba_iteration, maxit=50_000, tol=1e-4, use_kernels=False
    )
    (xs, _ys), iters, done = solver(
        x0=torch.zeros(B, n, device=dev),
        y0=torch.zeros(B, m, device=dev),
        g=SqrNormL2(lams),                    # per-lane ridge strength
        h=Shared(HingeLoss(y, 1.0 / m)),      # one dataset, all lanes
        L=Shared(A),
        theta=2.0, gamma1=gam, gamma2=gam,    # Chambolle-Pock stepsizes
    )

    xs = xs.cpu().numpy()
    margins = y_np[None, :] * (xs @ A_np.T)
    acc = (margins > 0).mean(axis=1)
    norms = np.linalg.norm(xs, axis=1)
    if verbose:
        print(f"{'lam':>10} | {'iters':>6} | {'|x|':>8} | train acc")
        for i in range(B):
            print(f"{float(lams[i]):10.4f} | {int(iters[i]):6d} | "
                  f"{norms[i]:8.3f} | {acc[i]:.3f}")
    done = done.cpu().numpy()
    assert bool(done.all())
    return {"lams": lams.cpu().numpy(), "xs": xs,
            "iterations": iters.cpu().numpy(), "done": done,
            "norms": norms, "train_acc": acc}


if __name__ == "__main__":
    main(verbose=True)
