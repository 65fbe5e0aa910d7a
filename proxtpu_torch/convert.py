"""Carry batched lasso problems from numpy (or JAX arrays) into the port."""

from __future__ import annotations

import numpy as np
import torch


def problems_from_numpy(As, bs, lams, Lfs, device):
    """Stacked lasso problems as contiguous float32 tensors on ``device``.

    ``As`` (B, M, N), ``bs`` (B, M), ``lams`` and ``Lfs`` (B,) or scalars
    (broadcast to (B,)): the arrays both packages consume; JAX arrays are
    taken through ``np.asarray``.  ``device`` is required: nothing is moved
    to a device the caller did not name.  Returns ``(A, b, lam, Lf)``."""
    As, bs, lams, Lfs = (np.asarray(v, dtype=np.float32)
                         for v in (As, bs, lams, Lfs))
    if As.ndim != 3:
        raise ValueError(f"As must be (B, M, N), got shape {As.shape}")
    B, M, N = As.shape
    if bs.shape != (B, M):
        raise ValueError(f"bs must be {(B, M)}, got shape {bs.shape}")
    out = [As, bs]
    for name, v in (("lams", lams), ("Lfs", Lfs)):
        if v.shape not in ((), (B,)):
            raise ValueError(f"{name} must be a scalar or ({B},), got "
                             f"shape {v.shape}")
        out.append(np.broadcast_to(v, (B,)))
    return tuple(torch.tensor(np.ascontiguousarray(v), device=device)
                 for v in out)
