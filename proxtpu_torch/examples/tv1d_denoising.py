"""Example: batched 1-D total-variation denoising with the TV prox.

    minimize  1/2 ||x - y||^2 + lam * sum_i |x_{i+1} - x_i|

The port of ``examples/tv1d_denoising.py``: the solution is one prox
evaluation, ``TotalVariation1D(lam).prox(y, 1.0)``, and a batch of 64
signals denoises as one ``torch.func.vmap`` call of it.  float64.

    python -m proxtpu_torch.examples.tv1d_denoising
"""

import numpy as np
import torch

from ..prox import TotalVariation1D
from . import device_of


def main(verbose=False, device="cuda"):
    dev = device_of(device)
    rng = np.random.default_rng(0)
    B, N, pieces = 64, 512, 8
    steps = np.cumsum(rng.standard_normal((B, pieces)), axis=1)
    clean = np.repeat(steps, N // pieces, axis=1)
    noisy = clean + 0.3 * rng.standard_normal((B, N))

    tv = TotalVariation1D(0.3)
    denoise = torch.func.vmap(lambda y: tv.prox(y, 1.0)[0])
    x = denoise(torch.tensor(noisy, device=dev)).cpu().numpy()

    def snr(u):
        return 10 * np.log10(np.mean(clean**2) / np.mean((u - clean) ** 2))

    out = {"snr_noisy": snr(noisy), "snr_denoised": snr(x)}
    if verbose:
        print(f"batch of {B} signals, length {N}")
        print(f"SNR noisy:    {out['snr_noisy']:6.2f} dB")
        print(f"SNR denoised: {out['snr_denoised']:6.2f} dB")
    return out


if __name__ == "__main__":
    main(verbose=True)
