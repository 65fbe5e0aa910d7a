"""The port's accelerators and bounded loops against the JAX reference, on
the CPU.

Tolerances are normwise, relative to the largest entry of the reference
value.  L-BFGS: the golden directions of ``tests/test_accel.py`` (a fixed
10 x 10 quadratic) and its pytree case, each direction equal to the JAX
package's and to the golden one to 1e-12 in double precision (1e-5 in
single).  Anderson and Broyden: ten accelerated steps on the 5-d
fixed-point problem reach the reference's optimum oracle, and the last
iterate equals the JAX package's to 1e-12 in float64.  In float32 it is held
to 1e-4: on this ill-conditioned problem both packages' float32 iterates
sit further than 1e-5 from the exact optimum, so their roundings part by
more than that.  ``bounded_while`` gives the same
result on the host and masked, and a masked L-BFGS push under
``torch.func.vmap`` equals the pushes made lane by lane.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import proxtpu as pa
import proxtpu_torch as pt
from proxtpu_torch.utils.loops import bounded_while
from test_accel import DIRS_REF, H5, Q10, XS, l5, q10

DTYPES = ["float32", "float64", "complex64", "complex128"]


def _rtol(dtype):
    return 1e-5 if dtype in ("float32", "complex64") else 1e-12


def _t(a, dtype):
    return torch.tensor(np.asarray(a).astype(dtype))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol):
    got, want = _np(got), _np(want).astype(_np(got).dtype)
    assert np.max(np.abs(got - want)) <= rtol * np.max(np.abs(want))


@pytest.mark.parametrize("dtype", DTYPES)
def test_lbfgs_golden_matches_jax(dtype):
    rtol = _rtol(dtype)
    sj, st = pa.LBFGS(3), pt.LBFGS(3)
    Qj, qj = jnp.asarray(Q10.astype(dtype)), jnp.asarray(q10.astype(dtype))
    Qt, qt = _t(Q10, dtype), _t(q10, dtype)
    Hj = sj.init_state(jnp.zeros(10, dtype))
    Ht = st.init_state(torch.zeros(10, dtype=getattr(torch, dtype)))
    xj, xt = jnp.asarray(XS[0].astype(dtype)), _t(XS[0], dtype)
    gj, gt = Qj @ xj + qj, Qt @ xt + qt
    d = -st.apply(Ht, gt)
    _close(d, -sj.apply(Hj, gj), rtol)
    _close(d, DIRS_REF[0], rtol)
    for i in range(1, 5):
        xpj, gpj, xpt, gpt = xj, gj, xt, gt
        xj, xt = jnp.asarray(XS[i].astype(dtype)), _t(XS[i], dtype)
        gj, gt = Qj @ xj + qj, Qt @ xt + qt
        Hj = sj.update(Hj, xj - xpj, gj - gpj)
        Ht = st.update(Ht, xt - xpt, gt - gpt)
        d = st.apply(Ht, -gt)
        _close(d, sj.apply(Hj, -gj), rtol)
        _close(d, DIRS_REF[i], rtol)
    assert int(Ht.currmem) == int(Hj.currmem) == 3
    assert int(Ht.curridx) == int(Hj.curridx)
    Ht = st.reset(Ht)
    np.testing.assert_array_equal(_np(st.apply(Ht, xt)), _np(xt))


@pytest.mark.parametrize("dtype", DTYPES)
def test_lbfgs_pytree_matches_jax(dtype):
    """Structured iterates: a dict of two vectors, as the reference's
    ArrayPartition case."""
    rtol = _rtol(dtype)
    sj, st = pa.LBFGS(3), pt.LBFGS(3)
    Q, q = Q10.astype(dtype), q10.astype(dtype)

    def pair(i, lib):
        x = XS[i].astype(dtype)
        g = Q @ x + q
        if lib == "jax":
            return ({"a": jnp.asarray(x), "b": jnp.asarray(x)},
                    {"a": jnp.asarray(g), "b": jnp.asarray(g)})
        return ({"a": _t(x, dtype), "b": _t(x, dtype)},
                {"a": _t(g, dtype), "b": _t(g, dtype)})

    (xj, gj), (xt, gt) = pair(0, "jax"), pair(0, "torch")
    Hj, Ht = sj.init_state(xj), st.init_state(xt)
    for i in range(5):
        if i:
            (xpj, gpj), (xpt, gpt) = (xj, gj), (xt, gt)
            (xj, gj), (xt, gt) = pair(i, "jax"), pair(i, "torch")
            Hj = sj.update(Hj, jax.tree.map(jnp.subtract, xj, xpj),
                           jax.tree.map(jnp.subtract, gj, gpj))
            Ht = st.update(Ht, {k: xt[k] - xpt[k] for k in xt},
                           {k: gt[k] - gpt[k] for k in gt})
        dj = sj.apply(Hj, jax.tree.map(jnp.negative, gj))
        dt = st.apply(Ht, {k: -v for k, v in gt.items()})
        for part in ("a", "b"):
            _close(dt[part], dj[part], rtol)
            _close(dt[part], DIRS_REF[i], rtol)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kind", ["anderson", "broyden"])
def test_fixed_point_acceleration_matches_jax(dtype, kind):
    """Ten accelerated gradient steps on the 5-d quadratic
    (``tests/test_accel.py``): the last iterate reaches the optimum to
    sqrt(eps) and equals the JAX package's."""
    rtol = 1e-4 if dtype == "float32" else 1e-12
    acc_j = pa.AndersonAcceleration(5) if kind == "anderson" else pa.Broyden()
    acc_t = pt.convert.direction_from_jax(acc_j)
    assert acc_t == (pt.AndersonAcceleration(5) if kind == "anderson"
                     else pt.Broyden())
    Hj, lj = jnp.asarray(H5.astype(dtype)), jnp.asarray(l5.astype(dtype))
    Ht, lt = _t(H5, dtype), _t(l5, dtype)
    xj, xt = jnp.zeros(5, dtype), torch.zeros(5, dtype=getattr(torch, dtype))
    sj, st = acc_j.init_state(xj), acc_t.init_state(xt)
    gj, gt = Hj @ xj + lj, Ht @ xt + lt
    for _ in range(10):
        dj, dt = acc_j.apply(sj, gj), acc_t.apply(st, gt)
        xj, xt = xj - dj, xt - dt
        gpj, gpt = gj, gt
        gj, gt = Hj @ xj + lj, Ht @ xt + lt
        sj = acc_j.update(sj, -dj, gj - gpj)
        st = acc_t.update(st, -dt, gt - gpt)
    _close(xt, xj, rtol)
    x_star = np.linalg.solve(H5, -l5)
    f = lambda x: x @ H5 @ x / 2 + x @ l5  # noqa: E731
    eps = float(np.finfo(dtype).eps)
    assert f(_np(xt).astype(np.float64)) <= f(x_star) + (
        1 + abs(f(x_star))) * np.sqrt(eps)
    st = acc_t.reset(st)
    np.testing.assert_array_equal(_np(acc_t.apply(st, xt)), _np(xt))


def test_anderson_pinv_cutoff_is_jax_default():
    """The port passes JAX's pinv cutoff (10 max(m, n) eps), not torch's
    default: a singular value between the two cutoffs is dropped."""
    from proxtpu_torch.accel.anderson import _pinv

    eps = np.finfo(np.float64).eps
    G = np.diag([1.0, 10 * eps])  # above torch's cutoff, below JAX's
    np.testing.assert_array_equal(_pinv(torch.tensor(G)).numpy(),
                                  np.asarray(jnp.linalg.pinv(G)))
    assert _pinv(torch.tensor(G))[1, 1] == 0


def test_direction_from_jax():
    assert pt.convert.direction_from_jax(pa.LBFGS(7)) == pt.LBFGS(7)
    assert (pt.convert.direction_from_jax(pa.NoAcceleration())
            == pt.NoAcceleration())
    with pytest.raises(TypeError, match="no port counterpart"):
        pt.convert.direction_from_jax(pa.FixedNesterovSequence())


@pytest.mark.parametrize("trips", [8, 6])
def test_bounded_while_host_and_masked_agree(trips):
    """Halving until below a per-lane threshold: under vmap, the masked
    form keeps each lane's own count and value, those of the host loop,
    wherever the search ends within the trips (at 6, lane 3's seventh
    halving is cut)."""
    thr = torch.tensor([0.3, 0.05, 2.0, 0.01], dtype=torch.float64)

    def search(t, max_trips):
        return bounded_while(
            lambda c: c[1] > t,
            lambda c: (c[0] + 1, c[1] / 2),
            (torch.zeros((), dtype=torch.int32),
             torch.ones((), dtype=torch.float64)), max_trips)

    host = [search(t, None) for t in thr]
    assert [int(k) for k, _ in host] == [2, 5, 0, 7]
    k, v = torch.func.vmap(lambda t: search(t, trips))(thr)
    want = [min(int(kh), trips) for kh, _ in host]
    assert k.tolist() == want
    for i in range(4):
        if want[i] == int(host[i][0]):
            assert float(v[i]) == float(host[i][1])


def test_lbfgs_masked_push_under_vmap():
    """Pushes at per-lane slots under vmap (lanes with different fills,
    one rejected pair) equal the pushes made lane by lane, and so do the
    directions."""
    rng = np.random.default_rng(0)
    strat = pt.LBFGS(3)
    B, n = 4, 6
    xs = torch.tensor(rng.standard_normal((B, n)))
    state = torch.func.vmap(strat.init_state)(xs)
    lanes = [strat.init_state(xs[i]) for i in range(B)]
    for step in range(5):
        s = torch.tensor(rng.standard_normal((B, n)))
        y = s + 0.1 * torch.tensor(rng.standard_normal((B, n)))
        # lane 1 skips two pushes (curvature fails), lane 2 every other one
        y[1] = -s[1] if step in (1, 3) else y[1]
        y[2] = -s[2] if step % 2 else y[2]
        state = torch.func.vmap(strat.update)(state, s, y)
        lanes = [strat.update(lanes[i], s[i], y[i]) for i in range(B)]
        d = torch.func.vmap(strat.apply)(state, xs)
        for i in range(B):
            torch.testing.assert_close(d[i], strat.apply(lanes[i], xs[i]),
                                       rtol=1e-13, atol=1e-13)
            assert int(state.curridx[i]) == int(lanes[i].curridx)
            assert int(state.currmem[i]) == int(lanes[i].currmem)
    assert state.currmem.tolist() == [3, 3, 3, 3]
    assert state.curridx.tolist() == [2, 3, 3, 2]


def test_acceleration_style():
    assert pt.accel.acceleration_style(pt.LBFGS()) == pt.accel.QUASI_NEWTON
    assert pt.accel.acceleration_style(
        pt.NesterovExtrapolation()) == pt.accel.NESTEROV
    assert pt.accel.acceleration_style(
        pt.NoAcceleration()) == pt.accel.NO_ACCELERATION
    assert pt.accel.acceleration_style(object()) == pt.accel.NO_ACCELERATION
