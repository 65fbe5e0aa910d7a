"""The prox functions of the port that decompose a matrix (SVD, eigh,
Cholesky), the exponential cone and the two inner-loop proxes
(``IndPolyhedral``, ``TotalVariation1D``) against the JAX package's, on the
CPU.

Same numpy inputs through both, the port's object carried over by
``prox_from_jax``: within 1e-9 in float64 (the decompositions, the
bisection, the inner loops with the same trip counts) and 1e-5 in float32.
Singular values and eigenvalues are kept distinct, so the signs and order
of the singular vectors (free to differ between LAPACK builds) do not
matter.  The inner loops' two forms, the host loop and the masked trips
that run under ``torch.func.vmap``, agree bit for bit on one problem, and
the vmapped form gives JAX's vmapped ``while_loop``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import proxtpu_torch as pt
from proxtpu.prox import base as jbase
from proxtpu.prox import functions as jf
from proxtpu_torch.prox import functions as tf
from proxtpu_torch.utils import loops
from test_torch_prox_functions import check_pair


def _spectrum(rng, m, n, s):
    """An m x n matrix with singular values ``s``."""
    U, _ = np.linalg.qr(rng.standard_normal((m, m)))
    V, _ = np.linalg.qr(rng.standard_normal((n, n)))
    S = np.zeros((m, n))
    S[:len(s), :len(s)] = np.diag(s)
    return U @ S @ V.T


def _sym(rng, w):
    Q, _ = np.linalg.qr(rng.standard_normal((len(w), len(w))))
    return (Q * w) @ Q.T


def _expcone_points(rng):
    # inside, in the polar cone, near the faces and generic points
    return [rng.standard_normal((6, 3)),
            np.array([[0.3, 1.2, 2.0], [-1.0, -0.5, -0.2], [-3.0, 0.0, 0.5],
                      [2.0, 0.1, 0.2], [-0.5, 2.0, -1.0], [0.0, 0.0, 0.0]])]


def _poly(rng, d):
    A = rng.standard_normal((3, 6))
    lo = np.array([-0.3, 0.2, -np.inf])
    hi = np.array([0.4, 0.2, 0.1])
    return jf.IndPolyhedral(jnp.asarray(A, d), jnp.asarray(lo, d),
                            jnp.asarray(hi, d))


def _signal(rng, n=40):
    return np.repeat(rng.standard_normal(5), n // 5) \
        + 0.3 * rng.standard_normal(n)


CASES = {
    "NuclearNorm": (lambda r, d: jf.NuclearNorm(0.6), lambda r: [
        _spectrum(r, 6, 4, [3.0, 1.7, 0.9, 0.2]),
        _spectrum(r, 4, 6, [2.5, 0.4, 0.3, 0.1])]),
    "NegLogDet": (lambda r, d: jf.NegLogDet(0.7), lambda r: [
        _sym(r, [0.3, 0.9, 1.4, 2.2, 3.1]),
        _sym(r, [-1.2, -0.4, 0.5, 1.0, 2.0])]),
    "IndPSD": (lambda r, d: jf.IndPSD(), lambda r: [
        _sym(r, [-1.2, -0.4, 0.5, 1.0, 2.0]),
        _sym(r, [0.1, 0.4, 0.5, 1.0, 2.0])]),
    "IndStiefel": (lambda r, d: jf.IndStiefel(), lambda r: [
        _spectrum(r, 6, 3, [2.0, 1.1, 0.3])]),
    "IndRank": (lambda r, d: jf.IndRank(2), lambda r: [
        _spectrum(r, 5, 4, [3.0, 2.0, 0.7, 0.2])]),
    "IndBallRank": (lambda r, d: jf.IndBallRank(1), lambda r: [
        _spectrum(r, 4, 5, [3.0, 2.0, 0.7, 0.2])]),
    "IndExpPrimal": (lambda r, d: jf.IndExpPrimal(), _expcone_points),
    "IndExpDual": (lambda r, d: jf.IndExpDual(), _expcone_points),
    "IndPolyhedral": (_poly, lambda r: [r.standard_normal(6),
                                        0.01 * r.standard_normal(6)]),
    "TotalVariation1D": (lambda r, d: jf.TotalVariation1D(0.3),
                         lambda r: [_signal(r), 0 * _signal(r)]),
    "TotalVariation1D-plain": (
        lambda r, d: jf.TotalVariation1D(0.2, restart=False),
        lambda r: [_signal(r)]),
}
GAMMAS = (1.0, 0.6)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", list(CASES))
def test_function_matches_jax(name, dtype):
    make, inputs = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    f_j = make(rng, getattr(jnp, dtype))
    f_t = pt.prox_from_jax(f_j, "cpu")
    assert type(f_t).__name__ == type(f_j).__name__
    assert pt.prox.is_convex(f_t) == jbase.is_convex(f_j)
    tol = 1e-9 if dtype == "float64" else 1e-5
    for i, x in enumerate(inputs(rng)):
        # in float32 the cone's curved-boundary root is as exact as the
        # float32 bisection: at (0.5, -2, 1) the JAX package's float32
        # projection lies 5.0e-5 from its float64 one, the port's 1.2e-6;
        # the port's float32 is held to the JAX package's float64 answer
        ref = x if name.startswith("IndExp") and dtype == "float32" else None
        check_pair(f_j, f_t, x.astype(dtype), GAMMAS[i % 2], tol, x_jax=ref)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_ind_graph_matches_jax(dtype):
    rng = np.random.default_rng(5)
    A = rng.standard_normal((3, 5)).astype(dtype)
    f_j = jf.IndGraph(jnp.asarray(A))
    f_t = pt.prox_from_jax(f_j, "cpu")
    # the port makes its own factor, the JAX package's upper triangle
    np.testing.assert_allclose(f_t.chol.numpy(), np.asarray(f_j.chol),
                               atol=1e-12 if dtype == "float64" else 1e-5)
    tol = 1e-10 if dtype == "float64" else 1e-5
    x, y = rng.standard_normal(5).astype(dtype), \
        rng.standard_normal(3).astype(dtype)
    (u_j, v_j), _ = f_j.prox((jnp.asarray(x), jnp.asarray(y)), 1.0)
    (u_t, v_t), val = f_t.prox((torch.tensor(x), torch.tensor(y)), 1.0)
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), atol=tol)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=tol)
    assert float(val) == 0 and float(f_t((u_t, v_t))) == 0
    assert float(f_t((torch.tensor(x), torch.tensor(y)))) == float(
        f_j((jnp.asarray(x), jnp.asarray(y)))) == float("inf")
    assert pt.prox.is_generalized_quadratic(f_t)


def _masked(monkeypatch):
    """Make every inner loop run its masked form (the one vmap runs) on one
    problem."""
    monkeypatch.setattr(tf, "vmap_while", lambda c, b, i, maxit, inputs:
                        loops.bounded_while(c, b, i, maxit))


@pytest.mark.parametrize("restart", [True, False])
def test_tv1d_masked_and_host_forms_agree_bit_for_bit(restart, monkeypatch):
    rng = np.random.default_rng(11)
    x = torch.tensor(_signal(rng))
    f = pt.prox.TotalVariation1D(0.3, restart=restart)
    z_h, v_h = f.prox(x, 1.0)
    _masked(monkeypatch)
    z_m, v_m = f.prox(x, 1.0)
    assert torch.equal(z_h, z_m) and torch.equal(v_h, v_m)


def test_polyhedral_masked_and_host_forms_agree_bit_for_bit(monkeypatch):
    rng = np.random.default_rng(12)
    f = pt.prox_from_jax(_poly(rng, jnp.float64), "cpu")
    x = torch.tensor(rng.standard_normal(6))
    z_h, _ = f.prox(x, 1.0)
    _masked(monkeypatch)
    z_m, _ = f.prox(x, 1.0)
    assert torch.equal(z_h, z_m)


def test_tv1d_trips_and_the_vmapped_form():
    """Under torch.func.vmap every lane pays maxit trips and gets JAX's
    vmapped answer; ``dual`` reports each lane's own trip count, the
    count the host loop runs."""
    rng = np.random.default_rng(13)
    Y = np.stack([_signal(rng) for _ in range(4)])
    f_j = jf.TotalVariation1D(0.3)
    z_j, v_j = jax.vmap(lambda y: f_j.prox(y, 1.0))(jnp.asarray(Y))
    f_t = pt.prox.TotalVariation1D(0.3)
    Yt = torch.tensor(Y)
    z_t, v_t = torch.func.vmap(lambda y: f_t.prox(y, 1.0))(Yt)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), atol=1e-9)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=1e-9)
    _, ks = torch.func.vmap(lambda y: f_t.dual(y, 1.0))(Yt)
    for i in range(4):
        _, k = f_t.dual(Yt[i], 1.0)
        assert int(ks[i]) == int(k) and 0 < int(k) < 2000
        torch.testing.assert_close(z_t[i], f_t.prox(Yt[i], 1.0)[0],
                                   rtol=0, atol=1e-13)


def test_polyhedral_vmapped_matches_jax():
    rng = np.random.default_rng(14)
    f_j = _poly(rng, jnp.float64)
    X = rng.standard_normal((3, 6))
    z_j, _ = jax.vmap(lambda x: f_j.prox(x, 1.0))(jnp.asarray(X))
    f_t = pt.prox_from_jax(f_j, "cpu")
    z_t, _ = torch.func.vmap(lambda x: f_t.prox(x, 1.0))(torch.tensor(X))
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), atol=1e-9)


def test_host_loop_under_vmap_raises_rather_than_switching():
    """A loop the caller forces to the host form cannot run under vmap: it
    raises instead of running another form."""
    def cond(c):
        return c < 3

    with pytest.raises(RuntimeError):
        torch.func.vmap(lambda x: loops.bounded_while(
            cond, lambda c: c + 1, x, None))(torch.zeros(2))
    out = torch.func.vmap(lambda x: loops.vmap_while(
        cond, lambda c: c + 1, x, 10, x))(torch.tensor([0.0, 2.0, 5.0]))
    assert out.tolist() == [3.0, 3.0, 5.0]


def test_matrix_functions_under_vmap():
    """The decompositions under torch.func.vmap (the batched driver's
    form): each lane as alone."""
    rng = np.random.default_rng(15)
    X = torch.tensor(np.stack([_sym(rng, [-0.5, 0.3, 1.0, 2.0])
                               for _ in range(3)]))
    for f in (pt.prox.NegLogDet(0.5), pt.prox.IndPSD(),
              pt.prox.NuclearNorm(0.4), pt.prox.IndRank(2)):
        z, v = torch.func.vmap(lambda x: f.prox(x, 0.8))(X)
        for i in range(3):
            zi, vi = f.prox(X[i], 0.8)
            torch.testing.assert_close(z[i], zi, rtol=0, atol=1e-12)
            torch.testing.assert_close(v[i], vi, rtol=0, atol=1e-12)
