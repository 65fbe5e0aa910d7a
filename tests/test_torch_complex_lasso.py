"""A complex lasso through ``BatchedAlgorithm``'s default route, on the
port and on the JAX package, on the CPU.

The kernel legs of ``match_kernel_solver`` (stacked A, shared A, box QP) and
``match_tv_solver`` solve real problems only: a complex A, b, x0 (or Q, q,
TV image) sends the problem to the generic driver.  So, in complex128, the
default route is bit-equal to ``use_kernels=False`` and its counts are the
JAX package's ``use_kernels=False`` counts (the JAX package's own kernel
legs do not answer a complex lasso).  A direct call of a batched lasso
solver on complex tensors raises ``ValueError`` naming the dtype.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import proxtpu as pa
import proxtpu_torch as pt
from proxtpu.prox import LeastSquaresLoss as JLeastSquaresLoss
from proxtpu.prox import NormL1 as JNormL1
from proxtpu.prox import make_least_squares as jmake_least_squares
from proxtpu_torch.kernels import dispatch as td
from proxtpu_torch.kernels import lasso as tl
from proxtpu_torch.prox import (
    IndBox,
    LeastSquaresLoss,
    NormL1,
    NormL21,
    Quadratic,
    SqrDistance,
    make_least_squares,
)

B, M, N = 4, 24, 32
TOL, MAXIT = 1e-8, 20_000


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Long loops of small operations: one thread (where the suite's
    workers share the cores, more threads contend)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(dtype=np.complex128):
    """B complex lassos of M x N, their l1 weights and Lipschitz constants
    (numpy rng 3)."""
    rng = np.random.default_rng(3)
    A = ((rng.standard_normal((B, M, N)) + 1j * rng.standard_normal(
        (B, M, N))) / np.sqrt(2 * M)).astype(dtype)
    b = ((rng.standard_normal((B, M)) + 1j * rng.standard_normal((B, M)))
         / np.sqrt(2)).astype(dtype)
    lam = 0.1 * np.max(np.abs(np.einsum("bmn,bm->bn", A.conj(), b)), axis=1)
    Lf = np.array([np.linalg.norm(a, 2) ** 2 for a in A])
    return A, b, lam, Lf


def _port_stacked(use_kernels):
    A, b, lam, Lf = _problem()
    return pt.BatchedAlgorithm(
        pt.make_fast_forward_backward_iteration, maxit=MAXIT, tol=TOL,
        use_kernels=use_kernels)(
        x0=torch.zeros(B, N, dtype=torch.complex128),
        f=LeastSquaresLoss(torch.tensor(A), torch.tensor(b)),
        g=NormL1(torch.tensor(lam)), Lf=torch.tensor(Lf))


def _port_shared(use_kernels):
    A, b, lam, _ = _problem()
    A0, b0 = torch.tensor(A[0]), torch.tensor(b[0])
    Lf0 = float(np.linalg.norm(A[0], 2) ** 2)
    return pt.BatchedAlgorithm(
        pt.make_fast_forward_backward_iteration, maxit=MAXIT, tol=TOL,
        use_kernels=use_kernels)(
        x0=torch.zeros(B, N, dtype=torch.complex128),
        f=pt.Shared(make_least_squares(A0, b0)),
        g=NormL1(torch.tensor(lam)), Lf=Lf0)


def _jax_stacked():
    A, b, lam, Lf = _problem()
    return pa.parallel.BatchedAlgorithm(
        pa.make_fast_forward_backward_iteration, maxit=MAXIT, tol=TOL,
        use_kernels=False)(
        x0=jnp.zeros((B, N), jnp.complex128),
        f=JLeastSquaresLoss(jnp.asarray(A), jnp.asarray(b)),
        g=JNormL1(jnp.asarray(lam)), Lf=jnp.asarray(Lf))


def _jax_shared():
    A, b, lam, _ = _problem()
    Lf0 = float(np.linalg.norm(A[0], 2) ** 2)
    return pa.parallel.BatchedAlgorithm(
        pa.make_fast_forward_backward_iteration, maxit=MAXIT, tol=TOL,
        use_kernels=False)(
        x0=jnp.zeros((B, N), jnp.complex128),
        f=pa.parallel.Shared(jmake_least_squares(jnp.asarray(A[0]),
                                                 jnp.asarray(b[0]))),
        g=JNormL1(jnp.asarray(lam)), Lf=Lf0)


@pytest.mark.parametrize("leg", ["stacked", "shared"])
def test_default_route_is_the_generic_driver(leg):
    port, ref = {"stacked": (_port_stacked, _jax_stacked),
                 "shared": (_port_shared, _jax_shared)}[leg]
    x_d, it_d, done_d = port(True)
    x_g, it_g, done_g = port(False)
    assert torch.equal(x_d, x_g) and torch.equal(it_d, it_g)
    assert torch.equal(done_d, done_g) and bool(done_d.all())
    x_j, it_j, done_j = ref()
    assert np.asarray(done_j).all()
    np.testing.assert_array_equal(it_d.numpy(), np.asarray(it_j))
    np.testing.assert_allclose(x_d.numpy(), np.asarray(x_j), rtol=0,
                               atol=1e-9)


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_kernel_legs_decline_complex(dtype):
    A, b, lam, Lf = (torch.tensor(v) for v in _problem())
    A, b = A.to(dtype), b.to(dtype)
    real = dtype.to_real()
    x0 = torch.zeros(B, N, dtype=dtype)
    lasso = dict(x0=x0, f=LeastSquaresLoss(A, b), g=NormL1(lam.to(real)),
                 Lf=Lf.to(real))
    assert td.match_kernel_solver(pt.make_fast_forward_backward_iteration,
                                  lasso, tol=TOL, maxit=MAXIT) is None
    shared = dict(x0=x0, f=pt.Shared(LeastSquaresLoss(A[0], b[0])),
                  g=NormL1(lam.to(real)), Lf=float(Lf[0]))
    assert td.match_kernel_solver(pt.make_fast_forward_backward_iteration,
                                  shared, tol=TOL, maxit=MAXIT) is None
    # a real A with a complex x0 is declined too
    real_lasso = dict(lasso, f=LeastSquaresLoss(A.real.contiguous(),
                                                b.real.contiguous()))
    assert td.match_kernel_solver(pt.make_fast_forward_backward_iteration,
                                  real_lasso, tol=TOL, maxit=MAXIT) is None
    Q = torch.eye(N, dtype=dtype).expand(B, N, N).contiguous()
    box = dict(x0=x0, f=Quadratic(Q, torch.ones(B, N, dtype=dtype)),
               g=IndBox(-1.0, 1.0), gamma=0.5)
    assert td.match_kernel_solver(pt.make_forward_backward_iteration, box,
                                  tol=TOL, maxit=MAXIT) is None
    tv = dict(x0=torch.zeros(B, 6, 5, dtype=dtype),
              y0=torch.zeros(B, 2, 6, 5, dtype=dtype),
              g=SqrDistance(torch.ones(B, 6, 5, dtype=dtype)),
              h=NormL21(0.1, axis=0), L=pt.ops.Grad2DOperator((6, 5)))
    assert td.match_tv_solver(pt.make_chambolle_pock_iteration, tv, tol=TOL,
                              maxit=MAXIT) is None
    # the same problems in the real dtype still take their legs
    real_tv = dict(tv, x0=tv["x0"].real, y0=tv["y0"].real,
                   g=SqrDistance(torch.ones(B, 6, 5, dtype=real)))
    assert td.match_tv_solver(pt.make_chambolle_pock_iteration, real_tv,
                              tol=TOL, maxit=MAXIT) is not None
    assert td.match_kernel_solver(
        pt.make_fast_forward_backward_iteration,
        dict(real_lasso, x0=x0.real), tol=TOL, maxit=MAXIT) is not None


SOLVERS = {
    "solve_lasso_batch": lambda A, b, lam, Lf: tl.solve_lasso_batch(
        A, b, lam, Lf, TOL),
    "solve_lasso_batch_packed": lambda A, b, lam, Lf:
        tl.solve_lasso_batch_packed(A, b, lam, Lf, TOL),
    "solve_lasso_batch_packed_tail": lambda A, b, lam, Lf:
        tl.solve_lasso_batch_packed_tail(A, b, lam, Lf, TOL, tail=2),
    "solve_lasso_batch_blocked": lambda A, b, lam, Lf:
        tl.solve_lasso_batch_blocked(A, b, lam, Lf, TOL),
    "solve_lasso_batch_compacting": lambda A, b, lam, Lf:
        tl.solve_lasso_batch_compacting(A, b, lam, Lf, TOL),
    "solve_lasso_batch_mixed": lambda A, b, lam, Lf:
        tl.solve_lasso_batch_mixed(A, b, lam, Lf, TOL, use_kernel=False),
    "solve_lasso_multirhs": lambda A, b, lam, Lf: tl.solve_lasso_multirhs(
        A[0], b, lam, float(Lf[0]), TOL),
}


@pytest.mark.parametrize("name", sorted(SOLVERS))
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_direct_solver_raises_on_complex(name, dtype):
    A, b, lam, Lf = (torch.tensor(v) for v in _problem())
    with pytest.raises(ValueError, match=str(dtype)):
        SOLVERS[name](A.to(dtype), b.to(dtype), lam.to(dtype.to_real()),
                      Lf.to(dtype.to_real()))
