"""The port's prox combinators, its prox namespace, ``tree_vdot`` and
``prox_from_jax`` on nested objects, against the JAX package,
on the CPU.

Each combinator is built in the JAX package around functions of the
library and carried over with ``prox_from_jax``; the same numpy inputs go
through both and value, prox, prox value and ``value_and_gradient`` agree
within 1e-10 in float64 (1e-9 where a decomposition is inside) and 1e-5 in
float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import proxtpu as pa
import proxtpu_torch as pt
from proxtpu.ops import linops as jl
from proxtpu.prox import base as jbase
from proxtpu.prox import combinators as jc
from proxtpu.prox import functions as jf
from proxtpu.utils import tree as jtree
from proxtpu_torch.utils import tree as ttree
from test_torch_prox_functions import check_pair

N = 6


def _orth(rng, n=N):
    return np.linalg.qr(rng.standard_normal((n, n)))[0]


def _pd(rng, n=4):
    B = rng.standard_normal((n, n))
    return B @ B.T + n * np.eye(n)


def _a(rng, d, n=N):
    return jnp.asarray(rng.standard_normal(n), d)


# name: (JAX object from (rng, dtype), inputs from rng, tolerance)
CASES = {
    "Conjugate": (lambda r, d: jc.Conjugate(jf.NormL1(0.4)),
                  lambda r: [3 * r.standard_normal(N)], 1e-10),
    "SeparableSum": (
        lambda r, d: jc.SeparableSum((jf.NormL1(0.3), jf.IndBox(-0.5, 0.5),
                                      jf.SqrNormL2(0.7))),
        lambda r: [(r.standard_normal(3), r.standard_normal(4),
                    r.standard_normal(2))], 1e-10),
    "SlicedSeparableSum": (
        lambda r, d: jc.SlicedSeparableSum(
            (jf.NormL1(0.3), jf.IndSimplex(1.0)), ((0, 2), (2, N))),
        lambda r: [r.standard_normal(N)], 1e-10),
    "Postcompose": (lambda r, d: jc.Postcompose(jf.NormL1(0.4), 2.0, 0.3),
                    lambda r: [r.standard_normal(N)], 1e-10),
    "Postcompose-smooth": (
        lambda r, d: jc.Postcompose(jf.SqrNormL2(0.7), 1.5, -0.2),
        lambda r: [r.standard_normal(N)], 1e-10),
    "Precompose": (
        lambda r, d: jc.Precompose(jf.NormL1(0.5),
                                   jnp.asarray(_orth(r), d), 1.0,
                                   _a(r, d)),
        lambda r: [r.standard_normal(N)], 1e-10),
    "Precompose-operator": (
        lambda r, d: jc.Precompose(
            jf.SqrDistance(_a(r, d)),
            jl.MatrixOperator(jnp.asarray(2 * _orth(r), d)), 4.0, 0.1),
        lambda r: [r.standard_normal(N)], 1e-10),
    "MoreauEnvelope": (lambda r, d: jc.MoreauEnvelope(jf.NormL1(0.6), 0.8),
                       lambda r: [r.standard_normal(N)], 1e-10),
    "Tilt": (lambda r, d: jc.Tilt(jf.SqrNormL2(0.5), _a(r, d), 0.2),
             lambda r: [r.standard_normal(N)], 1e-10),
    "Tilt-NegLogDet": (
        lambda r, d: jc.Tilt(jf.NegLogDet(1.0),
                             jnp.asarray(np.linalg.inv(_pd(r)), d)),
        lambda r: [_pd(r)], 1e-9),
    "Regularize": (lambda r, d: jc.Regularize(jf.NormL1(0.3), 0.9,
                                              _a(r, d)),
                   lambda r: [r.standard_normal(N)], 1e-10),
    "Regularize-smooth": (
        lambda r, d: jc.Regularize(jf.SqrNormL2(1.0), 0.5, 0.1),
        lambda r: [r.standard_normal(N)], 1e-10),
    "PointwiseMinimum": (
        lambda r, d: jc.PointwiseMinimum((jf.IndBallL2(0.5),
                                          jf.IndPoint(_a(r, d)))),
        lambda r: [r.standard_normal(N), 0.1 * r.standard_normal(N)], 1e-10),
    "PointwiseMinimum-functions": (
        lambda r, d: jc.PointwiseMinimum((jf.NormL1(0.2), jf.SqrNormL2(0.6),
                                          jf.NormL2(0.9))),
        lambda r: [r.standard_normal(N), 5 * r.standard_normal(N)], 1e-10),
    "PrecomposeDiagonal": (
        lambda r, d: jc.PrecomposeDiagonal(
            jf.NormL1(0.4), jnp.asarray(0.5 + r.random(N), d), _a(r, d)),
        lambda r: [r.standard_normal(N)], 1e-10),
    "PrecomposeDiagonal-smooth": (
        lambda r, d: jc.PrecomposeDiagonal(jf.SqrNormL2(0.5), 2.0, 0.0),
        lambda r: [r.standard_normal(N)], 1e-10),
    "Sum": (lambda r, d: jc.Sum((jf.SqrNormL2(0.5), jf.LogisticLoss(1.0),
                                 jf.SqrDistance(_a(r, d)))),
            lambda r: [r.standard_normal(N)], 1e-10),
}


def _cast(x, dtype):
    if isinstance(x, tuple):
        return tuple(e.astype(dtype) for e in x)
    return x.astype(dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", list(CASES))
def test_combinator_matches_jax(name, dtype):
    make, inputs, tol64 = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    f_j = make(rng, getattr(jnp, dtype))
    f_t = pt.prox_from_jax(f_j, "cpu")
    assert type(f_t).__name__ == type(f_j).__name__
    assert pt.prox.is_convex(f_t) == jbase.is_convex(f_j)
    assert (pt.prox.is_generalized_quadratic(f_t)
            == jbase.is_generalized_quadratic(f_j))
    tol = tol64 if dtype == "float64" else 1e-5
    for i, x in enumerate(inputs(rng)):
        check_pair(f_j, f_t, _cast(x, dtype), (0.7, 1.3)[i % 2], tol)


def test_prox_namespace_is_the_jax_packages():
    import importlib

    j = importlib.import_module("proxtpu.prox")
    t = importlib.import_module("proxtpu_torch.prox")
    assert j.__all__ == t.__all__
    for name in t.__all__:
        assert callable(getattr(t, name)), name


@pytest.mark.parametrize("name", ["Sum", "PointwiseMinimum"])
def test_empty_combinators_rejected(name):
    with pytest.raises(ValueError, match="at least one term"):
        getattr(pt.prox, name)(())


def test_traits_follow_the_terms():
    P = pt.prox
    assert P.Sum((P.SqrNormL2(), P.NormL1())).is_convex
    assert not P.Sum((P.SqrNormL2(), P.NormL0())).is_convex
    assert P.SeparableSum((P.SqrNormL2(), P.IndFree())) \
        .is_generalized_quadratic
    assert not P.Tilt(P.NormL0(), 1.0).is_convex
    assert not P.PointwiseMinimum((P.SqrNormL2(),)).is_convex
    assert P.Conjugate(P.SqrNormL2()).is_generalized_quadratic


def test_nested_objects_carry_over():
    """prox_from_jax carries nested objects whole, inside Shared too."""
    rng = np.random.default_rng(3)
    S = np.linalg.inv(_pd(rng))
    A = rng.standard_normal((3, 5))
    objs = [
        jc.Tilt(jf.NegLogDet(1.0), jnp.asarray(S)),
        pa.Shared(jf.NormL1(jnp.asarray(0.05 * (1 - np.eye(4))))),
        jc.SeparableSum((jf.IndGraph(jnp.asarray(A)), jf.NormL2(0.3))),
        jc.PointwiseMinimum((jf.IndBallL1(0.4), jf.IndSphereL2(2.0))),
        jc.Precompose(jf.IndBallLinf(0.3), jl.IdentityOperator(), 1.0, 0.2),
        jf.DistL2(jf.IndSimplex(1.0), 0.5),
        jc.Conjugate(jf.Translate(jf.LogisticLoss(1.0),
                                  jnp.asarray(rng.standard_normal(4)))),
    ]
    xs = [_pd(rng), rng.standard_normal((4, 4)),
          ((rng.standard_normal(5), rng.standard_normal(3)),
           rng.standard_normal(4)),
          rng.standard_normal(4), rng.standard_normal(4),
          rng.standard_normal(4), rng.standard_normal(4)]
    for obj, x in zip(objs, xs):
        t = pt.prox_from_jax(obj, "cpu")
        if isinstance(obj, pa.Shared):
            assert isinstance(t, pt.Shared)
            obj, t = obj.value, object.__getattribute__(t, "value")
        if isinstance(obj, jc.Conjugate):
            continue  # LogisticLoss has no prox: carried, not proxed
        z_j, _ = obj.prox(jtree.tree_map(jnp.asarray, x), 0.6)
        z_t, _ = t.prox(ttree.tree_map(torch.tensor, x), 0.6)
        for zt, zj in zip(ttree.tree_leaves(z_t), jtree.jax.tree.leaves(z_j)):
            np.testing.assert_allclose(zt.numpy(), np.asarray(zj), atol=1e-9)


def test_tree_vdot():
    rng = np.random.default_rng(4)
    a = (rng.standard_normal(3) + 1j * rng.standard_normal(3),
         rng.standard_normal((2, 2)))
    b = (rng.standard_normal(3) - 2j * rng.standard_normal(3),
         rng.standard_normal((2, 2)))
    ta = ttree.tree_map(torch.tensor, a)
    tb = ttree.tree_map(torch.tensor, b)
    ja = jtree.tree_map(jnp.asarray, a)
    jb = jtree.tree_map(jnp.asarray, b)

    def same(t, j):
        for tl, jl_ in zip(ttree.tree_leaves(t), jtree.jax.tree.leaves(j)):
            np.testing.assert_allclose(np.asarray(tl), np.asarray(jl_),
                                       atol=1e-14)

    same(ttree.tree_vdot(ta, tb), jtree.tree_vdot(ja, jb))
    same(ttree.tree_vdot_real(ta, tb), jtree.tree_vdot_real(ja, jb))
