"""Batched line searches on the port against its single solves and the JAX
reference, on the CPU in float64.

``BatchedAlgorithm(PANOC | ZeroFPR | PANOCplus | DRLS, use_kernels=
False)`` on the six problems of ``tests/test_batch.py`` (a least-squares
f with A = I, ``Lf`` given, and with the adaptive step): the generic
driver maps the steps under ``torch.func.vmap`` with the masked searches
injected and every lane converges.  Under vmap a matvec is one batched
product (``bmm``), whose sums add in another order than the single
problem's ``gemv``, and a line search's acceptance tests sit near
equality once a solve converges, so a late decision can flip: counts
within 2 of the single solves and of the JAX package's batched run, and
solutions within 1e-6 (the solve's own tolerance is 1e-6).  (The JAX
package computes each lane of a batched product as it computes a single
one, so its batched and single counts agree exactly.)  The masked searches
alone, where the arithmetic is the host search's, are held exactly in
``tests/test_torch_linesearch.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import proxtpu as pa
import proxtpu_torch as pt
from proxtpu.parallel import batch_problems, batched_run_loop
from proxtpu.prox import functions as jf
from proxtpu_torch.prox import functions as tf

TOL = 1e-6


def _problems(B=6, m=8, n=12):
    """``tests/test_batch.py``'s random lassos (rng k for problem k)."""
    out = []
    for k in range(B):
        rng = np.random.default_rng(k)
        A = rng.standard_normal((m, n))
        b = rng.standard_normal(m)
        out.append((A, b, 0.1 * float(np.max(np.abs(A.T @ b))),
                    float(np.linalg.norm(A, 2) ** 2)))
    return out


def _stack(objs):
    """One function object whose tensor fields stack those of ``objs``."""
    first = objs[0]
    return dataclasses.replace(first, **{
        f.name: torch.stack([getattr(o, f.name) for o in objs])
        for f in dataclasses.fields(first)
        if isinstance(getattr(first, f.name), torch.Tensor)})


_FACTORIES = {
    "PANOC": pt.make_panoc_iteration,
    "ZeroFPR": pt.make_zerofpr_iteration,
    "PANOCplus": pt.make_panocplus_iteration,
    "DRLS": pt.make_drls_iteration,
}


def _lane_kwargs(lib, A, b, lam, Lf, with_lf):
    if lib == "jax":
        kw = dict(x0=jnp.zeros(A.shape[1]), g=jf.NormL1(lam),
                  f=jf.make_least_squares(jnp.asarray(A), jnp.asarray(b)))
    else:
        kw = dict(x0=torch.zeros(A.shape[1], dtype=torch.float64),
                  g=tf.NormL1(lam),
                  f=tf.make_least_squares(torch.tensor(A), torch.tensor(b)))
    return {**kw, "Lf": Lf} if with_lf else kw


# the batched line searches, with the adaptive step where the factory has one
# (DRLS takes Lf for its default gamma)
BATCHED = [(n, w) for n in _FACTORIES for w in (True, False)
           if n != "DRLS" or w]


@pytest.mark.parametrize("name,with_lf", BATCHED)
def test_batched_matches_single_solves_and_jax(name, with_lf):
    probs = _problems()
    lanes = [_lane_kwargs("torch", *p, with_lf) for p in probs]
    kw = dict(x0=torch.stack([l["x0"] for l in lanes]),
              f=_stack([l["f"] for l in lanes]),
              g=tf.NormL1(torch.tensor([p[2] for p in probs])))
    if with_lf:
        kw["Lf"] = torch.tensor([p[3] for p in probs])
    xs, iters, done = pt.BatchedAlgorithm(
        _FACTORIES[name], maxit=2000, tol=TOL, use_kernels=False)(**kw)
    assert bool(done.all())
    for i, lane in enumerate(lanes):
        x, it = getattr(pt, name)(tol=TOL, maxit=2000)(**lane)
        assert abs(int(iters[i]) - it) <= 2, i
        np.testing.assert_allclose(xs[i].numpy(), x.numpy(), rtol=0,
                                   atol=1e-6)
    ref = batched_run_loop(batch_problems(
        getattr(pa.algorithms, _FACTORIES[name].__name__),
        [_lane_kwargs("jax", *p, with_lf) for p in probs]), 2000, TOL)
    assert np.max(np.abs(iters.numpy() - np.asarray(ref[1]))) <= 2
    np.testing.assert_allclose(xs.numpy(), np.asarray(ref[0]), rtol=0,
                               atol=1e-6)
