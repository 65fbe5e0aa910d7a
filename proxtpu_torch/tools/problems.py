"""The problem generators of the JAX package's harness, one copy in the
port (numpy only, so a test can feed both packages the same arrays).

``bench.gen_problems(batch)``, ``benchmarks/kernel_sweep.py::gen(batch,
m, n)`` and ``benchmarks/scaling.py::gen_problems(batch, m, n)`` are one
generator at different arguments: :func:`lasso_problems` gives their arrays
byte for byte (``tests/test_torch_problems.py``).  :func:`box_qp_problems`
is the nonconvex box-QP family of ``benchmarks/families_bench.py``,
:func:`shared_lasso_problem` the lambda path of
``benchmarks/shared_bench.py``.
"""

from __future__ import annotations

import numpy as np

# the flagship workload (bench.py): 256 lasso problems of 200 x 400
M, N = 200, 400
BATCH = 256


def lasso_problems(batch, m=M, n=N, dtype=np.float32, seed=0):
    """``(As, bs, lams, Lfs)``: ``batch`` lassos with A (m, n) standard
    normal over sqrt(m), b standard normal, ``lam = 0.1 ||A^T b||_inf`` and
    ``Lf = ||A||_2^2``, from ``numpy.random.default_rng(seed)``."""
    As, bs, lams = lasso_data(batch, m, n, dtype, seed)
    Lfs = np.array([np.linalg.norm(As[i], 2) ** 2 for i in range(batch)],
                   dtype=dtype)
    return As, bs, lams, Lfs


def lasso_data(batch, m=M, n=N, dtype=np.float32, seed=0):
    """``(As, bs, lams)`` of :func:`lasso_problems`, without the norms (one
    SVD a lane on the host, most of the generator's time at thousands of
    lanes)."""
    rng = np.random.default_rng(seed)
    As = rng.standard_normal((batch, m, n))
    As /= np.sqrt(m)  # in place: the same bits as a new array, one pass
    As = As.astype(dtype, copy=False)
    bs = rng.standard_normal((batch, m)).astype(dtype)
    lams = (0.1 * np.max(np.abs(np.einsum("bmn,bm->bn", As, bs)), axis=1)
            ).astype(dtype)
    return As, bs, lams


def shared_lasso_problem(batch=BATCH, m=M, n=N, dtype=np.float32, seed=0):
    """The shared-A lasso path of ``benchmarks/shared_bench.py:43-60``:
    ``(A, b, lams, Lf)``, one A (m, n) and one b, ``batch`` lambdas
    log-spaced from 0.02 to 0.5 lambda_max, ``Lf = ||A||_2^2``."""
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((m, n)) / np.sqrt(m)).astype(dtype)
    b = rng.standard_normal(m).astype(dtype)
    lam_max = float(np.max(np.abs(A.T @ b)))
    lams = (lam_max * np.logspace(np.log10(0.02), np.log10(0.5), batch)
            ).astype(dtype)
    return A, b, lams, float(np.linalg.norm(A, 2) ** 2)


def box_qp_problems(B, n, seed):
    """The nonconvex box-QP family (benchmarks/families_bench.py:123-133):
    Q = U diag(eig) U^T with U from a QR and eig uniform in [-1, 1], q
    standard normal, gamma = 0.95 / max|eig|.  Returns float32 ``(Qs, qs,
    gammas)``."""
    rng = np.random.default_rng(seed)
    Qs = np.empty((B, n, n), np.float32)
    gammas = np.empty((B,), np.float32)
    for i in range(B):
        U, _ = np.linalg.qr(rng.standard_normal((n, n)))
        eig = 2 * rng.random(n) - 1
        Qs[i] = (U * eig) @ U.T
        gammas[i] = 0.95 / np.max(np.abs(eig))
    qs = rng.standard_normal((B, n)).astype(np.float32)
    return Qs, qs, gammas
