"""The port's one way to decompose a matrix for the SVD proxes
(``proxtpu_torch.prox.functions._singular``): on the CPU it is
``torch.linalg.svd`` exactly, so ``NuclearNorm``, ``IndStiefel`` and
``IndRank`` (and their values) keep the bits they had; the Gram form that
the card takes for the nuclear norm's shrinkage is the SVD's result in
float64 (checked here on the CPU, where the helper itself never takes it).
On the card the helper is measured by ``proxtpu_torch/tools/svd_ways.py``
and checked by ``chip_smoke.py``'s examples phase."""

import numpy as np
import pytest
import torch

from proxtpu_torch.prox import functions as fns

DTYPES = [torch.float32, torch.float64, torch.complex64, torch.complex128]


def _matrix(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal(shape)
    if dtype.is_complex:
        X = X + 1j * rng.standard_normal(shape)
    return torch.tensor(X).to(dtype)


@pytest.mark.parametrize("shape", [(12, 9), (7, 11), (3, 10, 6)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_helper_is_torch_linalg_svd(shape, dtype):
    X = _matrix(shape, dtype)
    U, s, Vh = torch.linalg.svd(X, full_matrices=False)
    t = 0.4

    def shrink(v):
        return torch.clamp(v - t, min=0)

    Z, s1 = fns._singular(X, shrink, floor=t)
    assert torch.equal(s1, s)
    assert torch.equal(Z, torch.matmul(
        U * shrink(s).unsqueeze(-2).to(U.dtype), Vh))
    _, s2 = fns._singular(X)
    assert torch.equal(s2, torch.linalg.svdvals(X))

    # the three proxes and their values, as they were written on the SVD
    lam = torch.tensor(0.8, dtype=s.dtype)
    Z, v = fns.NuclearNorm(0.8).prox(X, 0.5)
    s_thr = torch.clamp(s - 0.5 * lam, min=0)
    assert torch.equal(Z, torch.matmul(U * s_thr.unsqueeze(-2).to(U.dtype),
                                       Vh))
    assert torch.equal(v, lam * torch.sum(s_thr))
    assert torch.equal(fns.NuclearNorm(0.8)(X),
                       lam * torch.sum(torch.linalg.svdvals(X)))
    Z, _ = fns.IndRank(2).prox(X, 1.0)
    keep = torch.arange(s.shape[-1]) < 2
    s_k = torch.where(keep, s, torch.zeros_like(s))
    assert torch.equal(Z, torch.matmul(U * s_k.unsqueeze(-2).to(U.dtype),
                                       Vh))
    if X.dim() == 2 and X.shape[0] >= X.shape[1]:
        Z, _ = fns.IndStiefel().prox(X, 1.0)
        assert torch.equal(Z, torch.matmul(U, Vh))


@pytest.mark.parametrize("shape", [(12, 9), (7, 11), (4, 60, 50)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
def test_gram_form_is_the_svd(shape, dtype):
    X = _matrix(shape, dtype, seed=1)
    t = torch.tensor(1.5, dtype=dtype.to_real())

    def shrink(v):
        return torch.clamp(v - t, min=0)

    U, s, Vh = torch.linalg.svd(X, full_matrices=False)
    want = torch.matmul(U * shrink(s).unsqueeze(-2).to(U.dtype), Vh)
    Z, s1 = fns._gram_form(X, shrink, t)
    assert Z.shape == X.shape and s1.shape == s.shape
    assert float((Z - want).abs().max()) <= 1e-12
    big = s > t
    assert float((s1 - s)[big].abs().max()) <= 1e-12
    # every singular value at or under the floor drops out
    P = torch.linalg.svd(Z, full_matrices=False)[1]
    assert int((P > 1e-9).sum()) == int(big.sum())
