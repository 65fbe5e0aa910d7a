"""Example: total-variation image denoising with Chambolle-Pock.

    minimize  1/2 ||x - y||^2 + lam * ||grad x||_{2,1}

The port of ``examples/tv_denoise.py``, with the implicit 2-D
forward-difference operator ``Grad2DOperator`` (no dense matrix; the
default stepsizes use its norm bound ||L||^2 <= 8).  float64, as the
script's numpy image.

    python -m proxtpu_torch.examples.tv_denoise
"""

import numpy as np
import torch

from ..algorithms import ChambollePock
from ..ops.linops import Grad2DOperator
from ..prox import NormL21, SqrDistance
from . import device_of


def main(verbose=False, device="cuda"):
    dev = device_of(device)
    rng = np.random.default_rng(0)
    H = W = 64
    clean = np.zeros((H, W))
    clean[16:48, 16:48] = 1.0
    clean[32:, :] += 0.5
    noisy_np = clean + 0.15 * rng.standard_normal((H, W))
    noisy = torch.tensor(noisy_np, device=dev)

    L = Grad2DOperator((H, W))
    solver = ChambollePock(tol=1e-5, maxit=20_000)
    (x, _), it = solver(
        x0=torch.zeros_like(noisy),
        y0=torch.zeros(2, H, W, dtype=noisy.dtype, device=dev),
        g=SqrDistance(noisy),
        h=NormL21(0.12, axis=0),
        L=L,
    )
    x = x.cpu().numpy()

    def psnr(u):
        mse = float(np.mean((u - clean) ** 2))
        return float(10 * np.log10(np.max(clean) ** 2 / mse))

    out = {"iterations": int(it), "x": x, "psnr_noisy": psnr(noisy_np),
           "psnr_denoised": psnr(x)}
    if verbose:
        print(f"converged in {it} iterations")
        print(f"PSNR noisy:    {out['psnr_noisy']:6.2f} dB")
        print(f"PSNR denoised: {out['psnr_denoised']:6.2f} dB")
    return out


if __name__ == "__main__":
    main(verbose=True)
