"""The linear program of ``tests/test_linear_programs.py`` on the port, on
the CPU: Davis-Yin (``make_ind_affine``), AFBA, Vu-Condat and
Chambolle-Pock (``Linear``, ``IndNonnegative``, ``IndPoint``,
``SlicedSeparableSum``) in float32 and float64, held to the reference's
feasibility and complementarity oracle at 1000 * tol (tol = 100 eps).
"""

import numpy as np
import pytest
import torch

import proxtpu_torch as pt
from proxtpu_torch.prox import combinators as tc
from proxtpu_torch.prox import functions as tf
from test_linear_programs import A_LP, B_LP, C_LP, X_STAR, \
    assert_lp_solution


def _t(a, dtype):
    return torch.tensor(np.asarray(a).astype(dtype))


M_LP, N_LP = A_LP.shape


def _lp(dtype):
    A, b, c = _t(A_LP, dtype), _t(B_LP, dtype), _t(C_LP, dtype)
    return A, b, c, 100 * float(np.finfo(dtype).eps)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("solver", ["AFBA", "VuCondat"])
def test_lp_primal_dual(dtype, solver):
    A, b, c, tol = _lp(dtype)
    (x, y), it = getattr(pt, solver)(tol=tol, maxit=100_000)(
        x0=torch.zeros(N_LP, dtype=A.dtype),
        y0=torch.zeros(M_LP, dtype=A.dtype), f=tf.Linear(c),
        g=tf.IndNonnegative(), h=tf.IndPoint(b), L=A, beta_f=0)
    assert x.dtype == A.dtype and it <= 100_000
    assert_lp_solution(C_LP, A_LP, B_LP, x.numpy(), y.numpy(), 1000 * tol)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_lp_chambolle_pock(dtype):
    A, b, c, tol = _lp(dtype)
    L = torch.cat([A, torch.eye(N_LP, dtype=A.dtype)])
    h = tc.SlicedSeparableSum((tf.IndPoint(b), tf.IndNonnegative()),
                              ((0, M_LP), (M_LP, M_LP + N_LP)))
    (x, y), it = pt.ChambollePock(tol=tol, maxit=100_000)(
        x0=torch.zeros(N_LP, dtype=A.dtype),
        y0=torch.zeros(M_LP + N_LP, dtype=A.dtype), g=tf.Linear(c), h=h,
        L=L)
    assert it <= 100_000
    assert_lp_solution(C_LP, A_LP, B_LP, x.numpy(), y.numpy()[:M_LP],
                       1000 * tol)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_lp_davis_yin(dtype):
    A, b, c, tol = _lp(dtype)
    x, it = pt.DavisYin(gamma=1.0, tol=tol, maxit=100_000)(
        x0=torch.zeros(N_LP, dtype=A.dtype), f=tf.Linear(c),
        g=tf.IndNonnegative(), h=tf.make_ind_affine(A, b))
    assert it <= 100_000
    assert np.linalg.norm(x.numpy() - X_STAR) <= 100 * tol
