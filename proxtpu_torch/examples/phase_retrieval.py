"""Example: Gaussian phase retrieval — complex, nonconvex, quasi-Newton.

min_x  f(x) = 1/(4m) * sum_i (|<a_i, x>|^2 - b_i)^2      (x complex)

The port of ``examples/phase_retrieval.py``: a complex signal recovered from
intensities, the gradient of the real-valued loss by automatic
differentiation (``AutoDifferentiable``), a spectral initialization, and
adaptive ZeroFPR against fixed-step gradient descent.  complex128.

    python -m proxtpu_torch.examples.phase_retrieval
"""

import numpy as np
import torch

from ..algorithms import ForwardBackward, ZeroFPR
from ..prox import AutoDifferentiable
from . import device_of


def phase_dist(x, x_true):
    """Distance up to global phase: min_phi ||x - e^{i phi} x_true||."""
    inner = np.vdot(np.asarray(x_true), np.asarray(x))
    phase = inner / max(abs(inner), 1e-30)
    return float(np.linalg.norm(np.asarray(x) - phase * np.asarray(x_true)))


def main(verbose=False, device="cuda"):
    dev = device_of(device)
    rng = np.random.default_rng(3)
    n, m = 32, 6 * 32
    x_true = ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
              / np.sqrt(2))
    A = (rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n)))
    A /= np.sqrt(2)
    b = np.abs(A @ x_true) ** 2
    A_t = torch.tensor(A, dtype=torch.complex128, device=dev)
    b_t = torch.tensor(b, dtype=torch.float64, device=dev)

    def intensity_loss(x):
        r = torch.abs(A_t @ x) ** 2 - b_t
        return torch.sum(r * r) / (4 * m)

    f = AutoDifferentiable(intensity_loss)

    # spectral initialization: leading eigenvector of (1/m) sum b_i a_i a_i^H,
    # scaled to the signal energy sqrt(mean(b))
    Y = (A.conj().T * b) @ A / m
    w, V = np.linalg.eigh(Y)
    x0_np = V[:, -1] * np.sqrt(b.mean())
    x0 = torch.tensor(x0_np, dtype=torch.complex128, device=dev)
    gamma0 = 1.0 / (6.0 * float(w[-1]))  # local curvature scale near init

    x, it = ZeroFPR(tol=1e-9, maxit=2000)(
        x0=x0, f=f, adaptive=True, gamma=gamma0,
    )
    x_gd, it_gd = ForwardBackward(tol=1e-9, maxit=20_000)(
        x0=x0, f=f, Lf=6.0 * float(w[-1]),
    )
    x, x_gd = x.cpu().numpy(), x_gd.cpu().numpy()

    d0 = phase_dist(x0_np, x_true)
    d = phase_dist(x, x_true)
    rel = d / np.linalg.norm(x_true)
    if verbose:
        print(f"spectral-init distance: {d0:.4f}")
        print(f"ZeroFPR (adaptive, L-BFGS): {int(it)} iterations, "
              f"distance {d:.2e} (relative {rel:.2e})")
        print(f"gradient descent (fixed step): {int(it_gd)} iterations, "
              f"distance {phase_dist(x_gd, x_true):.2e}")
    return {
        "iterations": int(it), "iterations_gd": int(it_gd),
        "rel_error": rel, "init_dist": d0,
    }


if __name__ == "__main__":
    main(verbose=True)
