"""The closed-form and bisection prox functions of the port against the
JAX package's, on the CPU.

Each function is built in the JAX package and carried over with
``prox_from_jax``; the same numpy inputs (from a seed) go through both, and
the value, the prox and its value and, where the JAX class has one,
``value_and_gradient`` agree: within 1e-10 in float64 for the closed forms,
1e-9 for the capped-simplex projections (the JAX package bisects 100 times,
the port solves for the threshold on the crossing segment) and the 20
Newton steps of ``NegEntropy``, 1e-5 in float32 and, where the JAX tests
take it (``NormLinf``, ``IndBallLinf``), in complex64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import proxtpu as pa
import proxtpu_torch as pt
from proxtpu.prox import base as jbase
from proxtpu.prox import functions as jf

N = 9
GAMMAS = (0.7, 1.9)


def _vec(rng, n=N):
    return rng.standard_normal(n)


def _pos(rng, n=N):
    return 0.2 + rng.random(n) * 2


def _unit(rng, n=N):
    return 0.05 + 0.9 * rng.random(n)


def _labels(rng, n=N):
    return np.where(rng.random(n) < 0.5, -1.0, 1.0)


def _soc(rng):
    v = rng.standard_normal(N)
    return [v, np.concatenate([[np.linalg.norm(v[1:]) + 0.5], v[1:]]),
            np.concatenate([[-np.linalg.norm(v[1:]) - 0.5], v[1:]])]


def _distinct(rng):
    # distinct values: ties would leave top-k / sorts free to differ
    return [rng.permutation(np.linspace(-2, 2, N)) + 0.01 * rng.random(N)
            for _ in range(2)]


# name: (JAX object from (rng, dtype), inputs from rng, tolerance class)
CASES = {
    "NormL2": (lambda r, d: jf.NormL2(0.6), lambda r: [_vec(r), 0 * _vec(r)],
               "closed"),
    "HuberLoss": (lambda r, d: jf.HuberLoss(1.3, 0.8),
                  lambda r: [_vec(r), 0.1 * _vec(r)], "closed"),
    "LogisticLoss": (lambda r, d: jf.LogisticLoss(0.9),
                     lambda r: [3 * _vec(r), 30 * _vec(r)], "closed"),
    "IndSimplex": (lambda r, d: jf.IndSimplex(1.5),
                   lambda r: [_vec(r), _pos(r) / N], "closed"),
    "IndBallL2": (lambda r, d: jf.IndBallL2(0.8),
                  lambda r: [_vec(r), 0.1 * _vec(r)], "closed"),
    "IndBallL1": (lambda r, d: jf.IndBallL1(1.1),
                  lambda r: [_vec(r), 0.05 * _vec(r)], "closed"),
    "SumPositive": (lambda r, d: jf.SumPositive(), lambda r: [_vec(r)],
                    "closed"),
    "NormL0": (lambda r, d: jf.NormL0(0.3), lambda r: [_vec(r)], "closed"),
    "HingeLoss": (lambda r, d: jf.HingeLoss(jnp.asarray(_labels(r), d), 0.7),
                  lambda r: [_vec(r), 2 * _vec(r)], "closed"),
    "IndBallLinf": (lambda r, d: jf.IndBallLinf(0.7), lambda r: [_vec(r)],
                    "closed"),
    "NormLinf": (lambda r, d: jf.NormLinf(0.8), lambda r: [_vec(r)],
                 "closed"),
    "IndHalfspace": (lambda r, d: jf.IndHalfspace(jnp.asarray(_vec(r), d),
                                                  0.3),
                     lambda r: [_vec(r), -_vec(r)], "closed"),
    "IndSphereL2": (lambda r, d: jf.IndSphereL2(1.7),
                    lambda r: [_vec(r), 0 * _vec(r)], "closed"),
    "LogBarrier": (lambda r, d: jf.LogBarrier(0.6),
                   lambda r: [_pos(r), _vec(r)], "closed"),
    "IndSOC": (lambda r, d: jf.IndSOC(), _soc, "closed"),
    "NormL1plusL2": (lambda r, d: jf.NormL1plusL2(0.3, 0.5),
                     lambda r: [_vec(r)], "closed"),
    "IndBallL0": (lambda r, d: jf.IndBallL0(3), _distinct, "closed"),
    "DistL2": (lambda r, d: jf.DistL2(jf.IndBallL2(0.5), 0.9),
               lambda r: [_vec(r), 0.01 * _vec(r)], "closed"),
    "SqrHingeLoss": (lambda r, d: jf.SqrHingeLoss(
        jnp.asarray(_labels(r) * (0.5 + r.random(N)), d), 0.4),
        lambda r: [_vec(r)], "closed"),
    "CubeNormL2": (lambda r, d: jf.CubeNormL2(0.7),
                   lambda r: [_vec(r), 0 * _vec(r)], "closed"),
    "IndBinary": (lambda r, d: jf.IndBinary(-0.5, 1.0),
                  lambda r: [_vec(r), np.array([-0.5, 1.0] * 4 + [1.0])],
                  "closed"),
    "CrossEntropy": (lambda r, d: jf.CrossEntropy(jnp.asarray(_unit(r), d)),
                     lambda r: [_unit(r)], "closed"),
    "IndFree": (lambda r, d: jf.IndFree(), lambda r: [_vec(r)], "closed"),
    "IndNonpositive": (lambda r, d: jf.IndNonpositive(),
                       lambda r: [_vec(r), -_pos(r)], "closed"),
    "IndHyperslab": (lambda r, d: jf.IndHyperslab(jnp.asarray(_vec(r), d),
                                                  -0.4, 0.6),
                     lambda r: [3 * _vec(r), 0.01 * _vec(r)], "closed"),
    "IndHyperslab-one-sided": (
        lambda r, d: jf.IndHyperslab(jnp.asarray(_vec(r), d), hi=0.2),
        lambda r: [3 * _vec(r), -3 * _vec(r)], "closed"),
    "NegEntropy": (lambda r, d: jf.NegEntropy(0.8),
                   lambda r: [_vec(r), _pos(r)], "iterative"),
    "IndCappedSimplex": (lambda r, d: jf.IndCappedSimplex(3, 0.4),
                         lambda r: [_vec(r), 2 * _vec(r)], "iterative"),
    "SumLargest": (lambda r, d: jf.SumLargest(4, 0.6), _distinct,
                   "iterative"),
    "Maximum": (lambda r, d: jf.Maximum(1.2), _distinct, "iterative"),
}
COMPLEX = {"NormLinf", "IndBallLinf"}
TOL = {("float64", "closed"): 1e-10, ("float64", "iterative"): 1e-9}


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(t, j, tol):
    if isinstance(t, tuple):  # a tuple iterate, leaf by leaf
        assert isinstance(j, tuple) and len(t) == len(j)
        for tl, jl in zip(t, j):
            _close(tl, jl, tol)
        return
    t, j = _np(t), _np(j)
    if np.all(np.isinf(j)):
        assert np.all(np.isinf(t)) and np.all(np.sign(t) == np.sign(j))
        return
    np.testing.assert_allclose(t, j, rtol=tol, atol=tol)


def check_pair(f_j, f_t, x, gamma, tol, x_jax=None):
    """Value, prox and prox value, and value_and_gradient where the JAX
    class has it, of the two packages on one numpy input ``x`` (the JAX
    package's on ``x_jax`` where given)."""
    def tree(fn, a):
        return tuple(fn(e) for e in a) if isinstance(a, tuple) else fn(a)

    xj = tree(jnp.asarray, x if x_jax is None else x_jax)
    xt = tree(lambda e: torch.tensor(np.asarray(e)), x)
    if callable(f_j):
        _close(f_t(xt), f_j(xj), tol)
    if hasattr(f_j, "prox"):
        z_j, v_j = f_j.prox(xj, gamma)
        z_t, v_t = pt.prox.prox(f_t, xt, gamma)
        assert tree(lambda e: e.dtype, z_t) == tree(lambda e: e.dtype, xt)
        _close(z_t, z_j, tol)
        _close(v_t, v_j, tol)
    if hasattr(f_j, "value_and_gradient") or not hasattr(f_j, "prox"):
        v_j, g_j = pa.value_and_gradient(f_j, xj)
        v_t, g_t = pt.prox.value_and_gradient(f_t, xt)
        _close(v_t, v_j, tol)
        _close(g_t, g_j, tol)


_PARAMS = [(name, dtype) for name in CASES
           for dtype in ("float64", "float32")
           + (("complex64",) if name in COMPLEX else ())]


@pytest.mark.parametrize("name,dtype", _PARAMS)
def test_function_matches_jax(name, dtype):
    make, inputs, kind = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    real = "float32" if dtype == "complex64" else dtype
    f_j = make(rng, getattr(jnp, real))
    f_t = pt.prox_from_jax(f_j, "cpu")
    assert type(f_t).__name__ == type(f_j).__name__
    assert pt.prox.is_convex(f_t) == jbase.is_convex(f_j)
    assert (pt.prox.is_generalized_quadratic(f_t)
            == jbase.is_generalized_quadratic(f_j))
    tol = TOL.get((dtype, kind), 1e-5)
    for i, x in enumerate(inputs(rng)):
        if dtype == "complex64":
            x = x + 1j * rng.standard_normal(x.shape)
        check_pair(f_j, f_t, x.astype(dtype), GAMMAS[i % 2], tol)


def test_prox_output_is_feasible():
    """The indicator convention: an indicator's value at its own prox output
    is 0 (returned 0, and f(z) finite)."""
    rng = np.random.default_rng(0)
    for name, (make, inputs, _) in CASES.items():
        f_t = pt.prox_from_jax(make(rng, jnp.float64), "cpu")
        if not name.startswith("Ind"):
            continue
        for x in inputs(rng):
            z, v = f_t.prox(torch.tensor(x), 1.0)
            assert float(v) == 0.0 and float(f_t(z)) == 0.0, name


def test_sphere_multi_leaf_zero_convention():
    f = pt.prox.IndSphereL2(2.0)
    z, v = f.prox((torch.zeros(6, dtype=torch.float64),
                   torch.zeros(6, dtype=torch.float64)), 1.0)
    assert float(torch.sqrt(sum(torch.sum(l * l) for l in z))) \
        == pytest.approx(2.0, rel=1e-12)
    assert float(f(z)) == 0.0 and float(z[0][0]) == 2.0
    assert float(torch.max(torch.abs(z[1]))) == 0.0


def test_softplus_is_jax_softplus_above_the_torch_threshold():
    """jax.nn.softplus is logaddexp(x, 0) everywhere; torch's softplus
    returns x itself above 20, about 2e-9 off in float64."""
    import jax

    x = np.linspace(15.0, 40.0, 26)
    f_t = pt.prox.LogisticLoss(1.0)
    got = [float(f_t(torch.tensor([-v]))) for v in x]
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=0)


@pytest.mark.parametrize("name", ["IndCappedSimplex", "SumLargest"])
def test_k_out_of_range_raises(name):
    f = getattr(pt.prox, name)(k=12)
    with pytest.raises(ValueError, match="1 <= k <= size"):
        f.prox(torch.zeros(5, dtype=torch.float64), 1.0)


def test_vmap_matches_one_by_one():
    """Under torch.func.vmap (the batched driver's form) each function
    gives what it gives one problem at a time."""
    rng = np.random.default_rng(7)
    X = torch.tensor(rng.standard_normal((4, N)))
    lams = torch.tensor(0.2 + rng.random(4))
    for f in (pt.prox.IndSimplex(1.0), pt.prox.SumLargest(3, 0.5),
              pt.prox.NormLinf(0.8), pt.prox.IndBallL0(2),
              pt.prox.HingeLoss(torch.tensor(_labels(rng)), 0.5)):
        z, v = torch.func.vmap(lambda x: f.prox(x, 0.9))(X)
        for i in range(4):
            zi, vi = f.prox(X[i], 0.9)
            torch.testing.assert_close(z[i], zi, rtol=0, atol=1e-15)
            torch.testing.assert_close(v[i], vi, rtol=0, atol=1e-14)
    z, _ = torch.func.vmap(lambda x, lam: pt.prox.NormL2(lam).prox(x, 0.9))(
        X, lams)
    for i in range(4):
        torch.testing.assert_close(
            z[i], pt.prox.NormL2(lams[i]).prox(X[i], 0.9)[0], rtol=0,
            atol=1e-15)


@pytest.mark.parametrize("kind", ["generic", "ties", "flat", "k=n", "cap=0"])
def test_capped_simplex_threshold_matches_the_bisection(kind):
    """The port's threshold on the crossing segment against the JAX
    package's 100 halvings, where phi has ties, a flat stretch at the
    total (k entries a cap above the rest), k = n, and cap = 0."""
    import jax

    from proxtpu.prox.functions import _capped_simplex_proj
    from proxtpu_torch.prox.functions import _capped_simplex_proj as exact

    bisect = jax.jit(_capped_simplex_proj)

    rng = np.random.default_rng(21)
    n = 24  # one shape: the JAX function compiles once per dtype
    for _ in range(10):
        k = n if kind == "k=n" else int(rng.integers(1, n + 1))
        cap = 0.0 if kind == "cap=0" else float(rng.choice([0.1, 0.7, 3.0]))
        y = rng.standard_normal(n)
        if kind == "ties":
            y = np.round(y, 1)
        if kind == "flat":
            y = np.concatenate([np.full(k, 5.0), rng.standard_normal(n - k)
                                - 5.0])
        for dtype, tol in (("float64", 1e-12), ("float32", 1e-5)):
            z_j = np.asarray(bisect(jnp.asarray(y, dtype),
                                    jnp.asarray(cap, dtype),
                                    jnp.asarray(k * cap, dtype)))
            c = torch.tensor(cap, dtype=getattr(torch, dtype))
            z_t = exact(torch.tensor(y.astype(dtype)), c, k * c).numpy()
            np.testing.assert_allclose(z_t, z_j, rtol=0, atol=tol)
            assert abs(z_t.sum() - k * cap) <= 1e3 * tol * (1 + k * cap)
