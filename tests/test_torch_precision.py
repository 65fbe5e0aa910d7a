"""The matmul precision switch of the port (``proxtpu_torch.utils.precision``)
against the JAX package's, on the CPU.

``set_matmul_precision`` returns the previous setting and
``get_matmul_precision`` the current one as the JAX package's do, compared
by name.  On the CPU every setting gives the bits of ``"highest"`` in both
packages (the JAX package's setting changes no bit there), so at each
setting ``pdot``, ``pmatvec``, ``mxu_cp_step`` and a FISTA solve on the
generic driver give the port's ``"highest"`` bits, and agree with the JAX
package at the same setting: float64 within 1e-12 (products) and equal
counts with solutions within 1e-9 (the solve), float32 within 2e-6 (the TV
step, as ``tests/test_torch_tv.py``).  PyTorch's process-wide float32
flags are untouched by every call; at ``"highest"`` the guard still raises
where they allow TF32, and the plain steps of the kernel solvers raise at
every setting.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import proxtpu as pa
import proxtpu_torch as pt
from proxtpu.algorithms import (
    make_fast_forward_backward_iteration as j_make_fista,
)
from proxtpu.kernels import tv as jtv
from proxtpu.parallel import BatchedAlgorithm as JBatchedAlgorithm
from proxtpu.prox import LeastSquaresLoss as JLeastSquaresLoss
from proxtpu.prox import NormL1 as JNormL1
from proxtpu.utils import precision as jprec
from proxtpu_torch.algorithms import make_fast_forward_backward_iteration
from proxtpu_torch.kernels import lasso as tl
from proxtpu_torch.kernels import tv as ttv
from proxtpu_torch.parallel import BatchedAlgorithm
from proxtpu_torch.prox import LeastSquaresLoss, NormL1
from proxtpu_torch.utils import precision as tprec

SETTINGS = ("default", "high", "highest")
B, M, N = 6, 20, 40
TOL = 1e-7


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the solves are loops of small operations, which
    more threads slow down where the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _highest_after():
    """Every test leaves both packages at ``"highest"``."""
    yield
    pt.set_matmul_precision("highest")
    if pa.get_matmul_precision() != jprec._NAMES["highest"]:
        pa.set_matmul_precision("highest")


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision())


def _both(setting):
    pt.set_matmul_precision(setting)
    if pa.get_matmul_precision() != jprec._NAMES[setting]:
        pa.set_matmul_precision(setting)  # drops JAX's caches


def test_round_trip_matches_the_jax_packages():
    assert pt.get_matmul_precision() == "highest"
    assert pa.get_matmul_precision().name.lower() == "highest"
    for setting in ("default", "high", "high", "highest", "default",
                    "highest"):
        prev_t = pt.set_matmul_precision(setting)
        prev_j = pa.set_matmul_precision(setting)
        assert prev_t == prev_j.name.lower()
        assert pt.get_matmul_precision() == setting
        assert pa.get_matmul_precision().name.lower() == setting
    # what the getter returned sets it back
    prev = pt.set_matmul_precision("default")
    assert pt.set_matmul_precision(prev) == "default"
    assert pt.get_matmul_precision() == prev == "highest"


def test_the_names_import_where_the_jax_packages_do():
    from proxtpu_torch import utils

    for name in ("set_matmul_precision", "get_matmul_precision"):
        assert getattr(utils, name) is getattr(tprec, name)
        assert getattr(pt, name) is getattr(tprec, name)
    with pytest.raises(ValueError, match="not one of"):
        pt.set_matmul_precision("bfloat16")
    assert pt.get_matmul_precision() == "highest"


def _operands(dtype):
    rng = np.random.default_rng(4)
    A = rng.standard_normal((B, M, N)).astype(dtype)
    x = rng.standard_normal((B, N)).astype(dtype)
    X = rng.standard_normal((B, N, 3)).astype(dtype)
    y = rng.standard_normal(N).astype(dtype)
    return A, x, X, y


def _products(mod, A, x, X, y):
    return (mod.pdot(A[0], y), mod.pdot(A, X), mod.pmatvec(A, x),
            mod.pmatvec(A, X))


@pytest.mark.parametrize("dtype, atol", [(np.float64, 1e-12),
                                         (np.float32, 1e-5)])
@pytest.mark.parametrize("setting", SETTINGS)
def test_pdot_and_pmatvec_at_every_setting(setting, dtype, atol):
    ops = _operands(dtype)
    want_t = _products(tprec, *(torch.tensor(a) for a in ops))
    want_j = _products(jprec, *(jnp.asarray(a) for a in ops))
    _both(setting)
    before = _flags()
    got_t = _products(tprec, *(torch.tensor(a) for a in ops))
    got_j = _products(jprec, *(jnp.asarray(a) for a in ops))
    assert _flags() == before
    for gt, wt, gj, wj in zip(got_t, want_t, got_j, want_j):
        assert torch.equal(gt, wt)
        np.testing.assert_array_equal(np.asarray(gj), np.asarray(wj))
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=0,
                                   atol=atol)


def _tv_operands():
    rng = np.random.default_rng(7)
    b = rng.standard_normal((3, 12, 16)).astype(np.float32)
    x, yx, yy = (s * rng.standard_normal((3, 12, 16)).astype(np.float32)
                 for s in (1.0, 0.1, 0.1))
    g1, g2 = ttv.default_tv_stepsizes()
    return (b, x, yx, yy, np.full(3, g1, np.float32),
            np.full(3, g2, np.float32), np.full(3, 0.12, np.float32))


@pytest.mark.parametrize("setting", SETTINGS)
def test_mxu_cp_step_at_every_setting(setting):
    ops = _tv_operands()
    want_t = ttv.mxu_cp_step(*(torch.tensor(a) for a in ops))
    want_j = jtv.mxu_cp_step(*(jnp.asarray(a) for a in ops))
    _both(setting)
    before = _flags()
    got_t = ttv.mxu_cp_step(*(torch.tensor(a) for a in ops))
    got_j = jtv.mxu_cp_step(*(jnp.asarray(a) for a in ops))
    assert _flags() == before
    for gt, wt, gj, wj in zip(got_t, want_t, got_j, want_j):
        assert torch.equal(gt, wt)
        np.testing.assert_array_equal(np.asarray(gj), np.asarray(wj))
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=0,
                                   atol=2e-6)


def _lasso():
    rng = np.random.default_rng(11)
    A = rng.standard_normal((B, M, N)) / np.sqrt(M)
    b = rng.standard_normal((B, M))
    lam = 0.1 * np.abs(np.einsum("bmn,bm->bn", A, b)).max(axis=1)
    Lf = np.array([np.linalg.norm(a, 2) ** 2 for a in A])
    return A, b, lam, Lf


def _solve_port(A, b, lam, Lf):
    return BatchedAlgorithm(make_fast_forward_backward_iteration,
                            maxit=3000, tol=TOL, use_kernels=False)(
        x0=torch.zeros(B, N, dtype=torch.float64),
        f=LeastSquaresLoss(torch.tensor(A), torch.tensor(b)),
        g=NormL1(torch.tensor(lam)), Lf=torch.tensor(Lf))


def _solve_jax(A, b, lam, Lf):
    return JBatchedAlgorithm(j_make_fista, maxit=3000, tol=TOL,
                             use_kernels=False)(
        x0=jnp.zeros((B, N)), f=JLeastSquaresLoss(jnp.asarray(A),
                                                  jnp.asarray(b)),
        g=JNormL1(jnp.asarray(lam)), Lf=jnp.asarray(Lf))


@pytest.fixture(scope="module")
def highest():
    """The lasso and the port's solve of it at ``"highest"``."""
    data = _lasso()
    return data, _solve_port(*data)


@pytest.mark.parametrize("setting", SETTINGS)
def test_generic_fista_at_every_setting(setting, highest):
    data, (xs_h, it_h, _) = highest
    _both(setting)
    before = _flags()
    xs, iters, done = _solve_port(*data)
    assert _flags() == before
    xs_j, iters_j, done_j = _solve_jax(*data)
    assert bool(done.all()) and bool(np.asarray(done_j).all())
    assert torch.equal(xs, xs_h) and torch.equal(iters, it_h)
    np.testing.assert_array_equal(iters.numpy(), np.asarray(iters_j))
    np.testing.assert_allclose(xs.numpy(), np.asarray(xs_j), rtol=0,
                               atol=1e-9)


def test_the_guard_at_highest_and_the_plain_steps_at_every_setting():
    """With TF32 allowed by PyTorch: ``pdot`` raises at ``"highest"`` as
    before and follows the setting at the other two; the plain steps of
    the kernel solvers keep full float32, so they raise at every setting.
    The flag is the caller's after each call."""
    a, x = torch.ones(3, 4), torch.ones(4)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for setting in SETTINGS:
            pt.set_matmul_precision(setting)
            if setting == "highest":
                with pytest.raises(RuntimeError, match="TF32"):
                    tprec.pdot(a, x)
            else:
                assert torch.equal(tprec.pdot(a, x), torch.full((3,), 4.))
            with pytest.raises(RuntimeError, match="TF32"):
                tl.solve_lasso_multirhs(torch.eye(3), torch.ones(2, 3), 0.1,
                                        1.0, 1e-5)
            assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert _flags() == (False, "highest")
