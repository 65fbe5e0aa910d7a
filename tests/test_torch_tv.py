"""The port's TV-denoising solver and the read-floor probe against the JAX
reference, on the CPU.

The same numpy images go through ``proxtpu.kernels.tv`` and
``proxtpu_torch.kernels.tv``.  The JAX Pallas kernel runs in interpret mode,
as the JAX package's own tests run it; the port's kernel wrapper runs its
plain version, since the tensors lie on the CPU.  Tolerances are the JAX
tests' own (``tests/test_tv_kernel.py``): one step within 2e-6 of the XLA
step and 5e-6 of the kernel, three steps within 2e-5, solutions within 1e-4
in float32 with counts within one block, and in float64 equal counts and
solutions within 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import proxtpu_torch as pt
from proxtpu.kernels import tv as jtv
from proxtpu_torch.kernels import probe
from proxtpu_torch.kernels import tv as ttv
from proxtpu_torch.ops import Grad2DOperator
from proxtpu_torch.parallel.batch import batched_run_loop
from proxtpu_torch.prox import NormL21, SqrDistance

B, H, W = 4, 16, 24
LAM = 0.12
TOL = 1e-4


def _images(B_, H_, W_, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    clean = np.zeros((B_, H_, W_), np.float32)
    clean[:, H_ // 4: 3 * H_ // 4, W_ // 4: 3 * W_ // 4] = 1.0
    return (clean + 0.15 * rng.standard_normal((B_, H_, W_))
            .astype(np.float32)).astype(dtype)


@pytest.fixture(scope="module")
def noisy():
    return _images(B, H, W)


def _state(seed, scale, shape=(B, H, W)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            (scale * rng.standard_normal(shape)).astype(np.float32),
            (scale * rng.standard_normal(shape)).astype(np.float32))


def _params(n=B, lam=LAM):
    g1, g2 = ttv.default_tv_stepsizes()
    assert (g1, g2) == jtv.default_tv_stepsizes()
    return (np.full(n, g1, np.float32), np.full(n, g2, np.float32),
            np.broadcast_to(np.float32(lam), (n,)).copy())


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(arrays):
    return [torch.tensor(np.asarray(a)) for a in arrays]


def _close(got, want, atol, msg=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol, err_msg=msg)


@pytest.mark.parametrize("lam", [LAM, (0.05, 0.12, 0.2, 0.3)])
def test_reference_step_matches_jax(noisy, lam):
    ops = (noisy, *_state(1, 0.05), *_params(lam=lam))
    want = jtv.reference_cp_step(*_j(ops))
    got = ttv.reference_cp_step(*_t(ops))
    for g, w, name in zip(got, want, ("x", "yx", "yy", "res")):
        _close(g, w, 2e-6, name)


@pytest.mark.parametrize("K,atol", [(1, 5e-6), (3, 2e-5)])
def test_k_steps_match_interpret_kernel(noisy, K, atol):
    """The port's plain K steps (what its wrapper runs on the CPU) against
    the JAX Pallas kernel in interpret mode."""
    ops = (noisy, *_state(1, 0.05), *_params())
    want = jtv.fused_cp_k_steps(*_j(ops), K=K, interpret=True)
    got = ttv.fused_cp_k_steps(*_t(ops), K=K)
    for g, w, name in zip(got, want, ("x", "yx", "yy", "res")):
        _close(g, w, atol, name)


def test_mxu_step_matches_reference_step(noisy):
    ops = (noisy, *_state(7, 0.1), *_params())
    ref = ttv.reference_cp_step(*_t(ops))
    mxu = ttv.mxu_cp_step(*_t(ops))
    want = jtv.mxu_cp_step(*_j(ops))
    for r, m, w, name in zip(ref, mxu, want, ("x", "yx", "yy", "res")):
        _close(m, r, 1e-6, name)
        _close(m, w, 2e-6, name)


def _generic_iteration(noisy_t, lam=LAM, dtype=torch.float32):
    n = noisy_t.shape[0]
    return pt.make_chambolle_pock_iteration(
        x0=torch.zeros((n, H, W), dtype=dtype),
        y0=torch.zeros((n, 2, H, W), dtype=dtype), g=SqrDistance(noisy_t),
        h=NormL21(lam, axis=0), L=Grad2DOperator((H, W)))


def test_reference_step_is_the_generic_update(noisy):
    """The step's algebra is the AFBA theta = 2 update: from (0, 0), one
    and two plain steps equal the generic iteration's init and step."""
    b = torch.tensor(noisy)
    g1, g2, lam = _t(_params())
    zero = torch.zeros_like(b)
    x1, yx1, yy1, res1 = ttv.reference_cp_step(b, zero, zero, zero, g1, g2,
                                               lam)
    x2, yx2, _, _ = ttv.reference_cp_step(b, x1, yx1, yy1, g1, g2, lam)
    for i in range(B):
        it = pt.make_chambolle_pock_iteration(
            x0=zero[i], y0=torch.zeros(2, H, W), g=SqrDistance(b[i]),
            h=NormL21(LAM, axis=0), L=Grad2DOperator((H, W)))
        s1 = it.init()
        s2 = it.step(s1)
        _close(s1.x, x1[i], 2e-6)
        _close(s1.y[0], yx1[i], 2e-6)
        _close(s1.y[1], yy1[i], 2e-6)
        fpr = s1.FPR_x.abs().max() + s1.FPR_y.abs().max()
        assert abs(float(fpr) - float(res1[i])) <= 2e-6
        _close(s2.x, x2[i], 5e-6)
        _close(s2.y[0], yx2[i], 5e-6)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_solve_matches_jax(noisy, dtype, use_kernel):
    """float64: the JAX package's counts exactly and x within 1e-10;
    float32: x within 1e-4, counts within one block."""
    b = noisy.astype(dtype)
    x_j, it_j, d_j = jtv.solve_tv_batch(jnp.asarray(b), LAM, TOL,
                                        use_kernel=False)
    x_t, it_t, d_t = ttv.solve_tv_batch(torch.tensor(b), LAM, TOL,
                                        use_kernel=use_kernel)
    assert bool(d_t.all()) and bool(np.asarray(d_j).all())
    assert x_t.dtype == getattr(torch, dtype) and it_t.dtype == torch.int32
    if dtype == "float64":
        np.testing.assert_array_equal(it_t.numpy(), np.asarray(it_j))
        _close(x_t, x_j, 1e-10)
    else:
        assert int(np.abs(it_t.numpy() - np.asarray(it_j)).max()) <= 8
        _close(x_t, x_j, 1e-4)


def test_per_image_lam(noisy):
    """Each image is denoised with its own lam, as in JAX, and image i of
    the sweep equals a uniform solve at lam_i."""
    lams = np.asarray([0.05, 0.12, 0.2, 0.3], np.float32)
    b = torch.tensor(noisy)
    xs, _, d = ttv.solve_tv_batch(b, torch.tensor(lams), TOL)
    x_j, _, d_j = jtv.solve_tv_batch(jnp.asarray(noisy), jnp.asarray(lams),
                                     TOL, use_kernel=True, interpret=True)
    assert bool(d.all()) and bool(np.asarray(d_j).all())
    _close(xs, x_j, 1e-4)
    for i in (0, 3):
        xi, _, di = ttv.solve_tv_batch(b, float(lams[i]), TOL,
                                       use_kernel=False)
        assert bool(di.all())
        _close(xs[i], xi[i], 1e-5)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_per_image_stepsizes(noisy, use_kernel):
    """Per-image stepsizes: each image runs with its own gamma, on the
    kernel route too (the kernel reads g1, g2 and lam per image)."""
    g1s = np.asarray([0.3, 0.35, 0.3, 0.25], np.float32)
    b = torch.tensor(noisy)
    xs, _, d = ttv.solve_tv_batch(b, LAM, TOL, gamma1=torch.tensor(g1s),
                                  use_kernel=use_kernel)
    x_j, _, _ = jtv.solve_tv_batch(jnp.asarray(noisy), LAM, TOL,
                                   gamma1=jnp.asarray(g1s))
    assert bool(d.all())
    _close(xs, x_j, 1e-4)
    xi, _, di = ttv.solve_tv_batch(b, LAM, TOL, gamma1=float(g1s[1]),
                                   use_kernel=False)
    assert bool(di.all())
    _close(xs[1], xi[1], 1e-5)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_solver_matches_generic_driver(noisy, use_kernel):
    """The reference's cross-path contract: x within 1e-3 of the generic
    driver's, counts an upper bound within one block."""
    b = torch.tensor(noisy)
    (x_g, _), it_g, d_g = batched_run_loop(_generic_iteration(b), 5000, TOL)
    x, it, d = ttv.solve_tv_batch(b, LAM, TOL, maxit=5000, iter_block=8,
                                  use_kernel=use_kernel)
    assert bool(d.all()) and bool(d_g.all())
    _close(x, x_g, 1e-3)
    assert bool((it >= it_g - 1).all()) and bool((it <= it_g + 8).all())


def test_mxu_formulation_solves(noisy):
    b = torch.tensor(noisy)
    roll = ttv.solve_tv_batch(b, LAM, TOL, maxit=4000, use_kernel=False)
    mxu = ttv.solve_tv_batch(b, LAM, TOL, maxit=4000, use_kernel=False,
                             formulation="mxu")
    assert bool(roll[2].all()) and bool(mxu[2].all())
    _close(mxu[0], roll[0], 1e-4)
    assert int((mxu[1] - roll[1]).abs().max()) <= 8
    with pytest.raises(ValueError, match="formulation"):
        ttv.solve_tv_batch(b, LAM, TOL, use_kernel=False, formulation="fft")


@pytest.mark.parametrize("use_kernel", [True, False])
def test_warm_start_and_return_dual(use_kernel):
    """Re-entering from a previous solve's (x, (B, 2, H, W) dual) converges
    at once, the warm start is not written, and the dual is JAX's."""
    rng = np.random.default_rng(3)
    b_np = rng.standard_normal((3, 24, 24)).astype(np.float32)
    b = torch.tensor(b_np)
    (x, y), it, d = ttv.solve_tv_batch(b, 0.15, TOL, maxit=4000,
                                       use_kernel=False, return_dual=True)
    (x_j, y_j), _, _ = jtv.solve_tv_batch(jnp.asarray(b_np), 0.15, TOL,
                                          maxit=4000, use_kernel=False,
                                          return_dual=True)
    assert bool(d.all()) and y.shape == (3, 2, 24, 24)
    _close(x, x_j, 1e-4)
    _close(y, y_j, 1e-3)
    x_keep, y_keep = x.clone(), y.clone()
    (x2, _), it2, d2 = ttv.solve_tv_batch(b, 0.15, TOL, maxit=4000, x0=x,
                                          y0=y, return_dual=True,
                                          use_kernel=use_kernel)
    assert bool(d2.all())
    assert float(it2.float().mean()) <= 0.2 * float(it.float().mean())
    _close(x2, x, 1e-4)
    assert torch.equal(x, x_keep) and torch.equal(y, y_keep)


def test_maxit_caps_counts(noisy):
    x, it, d = ttv.solve_tv_batch(torch.tensor(noisy), LAM, 1e-12, maxit=20)
    x_j, it_j, d_j = jtv.solve_tv_batch(jnp.asarray(noisy), LAM, 1e-12,
                                        maxit=20, use_kernel=False)
    assert not bool(d.any()) and not bool(np.asarray(d_j).any())
    np.testing.assert_array_equal(it.numpy(), np.asarray(it_j))
    assert int(it.max()) == 20


def test_wrapper_freezes_and_writes_out(noisy):
    """done = 0 advances an image, 1 copies its state to the outputs, 2
    leaves the outputs as they are; all report res 0 when frozen."""
    ops = _t((noisy, *_state(2, 0.05), *_params()))
    b, x, yx, yy = ops[:4]
    done = torch.tensor([0.0, 1.0, 2.0, 0.0])
    free = ttv.fused_cp_k_steps(*ops, K=3)
    got = ttv.fused_cp_k_steps(*ops, K=3, done=done)
    for g, f, old in zip(got[:3], free[:3], (x, yx, yy)):
        assert torch.equal(g[[0, 3]], f[[0, 3]])
        assert torch.equal(g[[1, 2]], old[[1, 2]])
    assert torch.equal(got[3] == 0, done != 0)
    out = tuple(torch.empty_like(b) for _ in range(3))
    again = ttv.fused_cp_k_steps(*ops, K=3, done=done, out=out)
    assert all(a is o for a, o in zip(again[:3], out))
    assert all(torch.equal(a, g) for a, g in zip(again, got))
    with pytest.raises(ValueError, match="K must be"):
        ttv.fused_cp_k_steps(*ops, K=0)


@pytest.mark.parametrize("shape,K", [((64, 64), 8), ((256, 256), 8),
                                     ((256, 256), 1), ((33, 21), 8),
                                     ((50, 1000), 8), ((1000, 91), 4)])
def test_tile_plan_fits_shared_memory(shape, K):
    limit = 232448  # one block's shared memory on an H100
    TH, TW = ttv.tile_plan(*shape, K, limit)
    assert 1 <= TH <= shape[0] and 1 <= TW <= shape[1]
    region = min(shape[0], TH + 2 * K) * min(shape[1], TW + 2 * K)
    assert 5 * 4 * region <= limit - 1024
    if 5 * 4 * shape[0] * shape[1] <= limit - 1024:
        assert (TH, TW) == shape
    with pytest.raises(ValueError, match="no room"):
        ttv.tile_plan(4096, 4096, 60, limit)


@pytest.mark.parametrize("K", [1, 2, 8])
def test_tiles_with_a_halo_reproduce_the_image(K):
    """The kernel's tiling, replayed on the CPU: K steps on a tile plus a
    halo of K cells per side, clipped to the image, with the region's edge
    taken as the boundary except for the dual field's own cell (masked at
    the image's edge only), give the tile exactly what K steps on the
    whole image give."""
    Bt, Ht, Wt, TH, TW = 2, 37, 29, 16, 12
    b, (x, yx, yy) = _images(Bt, Ht, Wt, 5), _state(6, 0.1, (Bt, Ht, Wt))
    g1, g2, lam = (float(v[0]) for v in _params(Bt))
    want = ttv.reference_cp_k_steps(
        *_t((b, x, yx, yy)), *_t(_params(Bt)), K=K)
    f = np.float32
    for r0 in range(0, Ht, TH):
        for c0 in range(0, Wt, TW):
            r1, c1 = min(Ht, r0 + TH), min(Wt, c0 + TW)
            e = (slice(None), slice(max(0, r0 - K), min(Ht, r1 + K)),
                 slice(max(0, c0 - K), min(Wt, c1 + K)))
            bs, xs, yxs, yys = (a[e].copy() for a in (b, x, yx, yy))
            rows = np.arange(e[1].start, e[1].stop)[None, :, None]
            cols = np.arange(e[2].start, e[2].stop)[None, None, :]
            for _ in range(K):
                dxm = np.where(rows < Ht - 1, yxs, f(0))
                dym = np.where(cols < Wt - 1, yys, f(0))
                up, left = np.zeros_like(yxs), np.zeros_like(yys)
                up[:, 1:], left[:, :, 1:] = yxs[:, :-1], yys[:, :, :-1]
                t = xs + f(g1) * ((dxm - up) + (dym - left))
                xbar = (t + f(g1) * bs) / (f(1) + f(g1))
                mid = f(2) * xbar - xs
                gx, gy = np.zeros_like(mid), np.zeros_like(mid)
                gx[:, :-1] = mid[:, 1:] - mid[:, :-1]
                gy[:, :, :-1] = mid[:, :, 1:] - mid[:, :, :-1]
                vx, vy = yxs + f(g2) * gx, yys + f(g2) * gy
                nrm = np.sqrt(vx * vx + vy * vy)
                scale = np.where(nrm > f(lam),
                                 f(lam) / np.maximum(nrm, f(1e-30)), f(1))
                xs, yxs, yys = xbar, vx * scale, vy * scale
            tile = (slice(None), slice(r0 - e[1].start, r1 - e[1].start),
                    slice(c0 - e[2].start, c1 - e[2].start))
            for got, w in zip((xs, yxs, yys), want):
                np.testing.assert_allclose(
                    got[tile], w.numpy()[:, r0:r1, c0:c1], rtol=0, atol=1e-6)


def test_tv_from_numpy(noisy):
    b, lam = pt.tv_from_numpy(noisy.astype(np.float64), LAM, device="cpu")
    assert b.dtype == lam.dtype == torch.float32
    assert b.is_contiguous() and tuple(lam.shape) == (B,)
    np.testing.assert_array_equal(b.numpy(), noisy)
    with pytest.raises(ValueError, match=r"\(B, H, W\)"):
        pt.tv_from_numpy(noisy[0], LAM, device="cpu")


@pytest.mark.parametrize("shape", [(256, 200, 400), (64, 512, 1024),
                                   (1024, 64, 128), (256, 128, 128),
                                   (7, 33, 161), (3, 1, 5)])
def test_read_reduce_chunk_plan(shape):
    """The probe's cut of a lane into chunks covers the lane, starts every
    chunk on 16 bytes and yields enough blocks for the card where the lane
    is long enough."""
    n = shape[1] * shape[2]
    S, chunk = probe.chunk_plan(shape[0], n, 132)
    assert S >= 1 and chunk % 4 == 0
    assert S * chunk >= n > (S - 1) * chunk
    if n >= 132 * 8 * 4096:
        assert shape[0] * S >= 132 * 8


@pytest.mark.parametrize("shape", [(256, 200, 400), (64, 512, 1024),
                                   (1024, 64, 128), (256, 128, 128),
                                   (7, 33, 161), (3, 1, 5)])
@pytest.mark.parametrize("sms", [132, 108])
def test_read_reduce_cached_plan_is_the_plan(shape, sms):
    """The plan the wrapper looks up per call is chunk_plan's, the first
    time and from the cache."""
    n = shape[1] * shape[2]
    want = probe.chunk_plan(shape[0], n, sms)
    assert probe.cached_chunk_plan(shape[0], n, sms) == want
    assert probe.cached_chunk_plan(shape[0], n, sms) == want
    assert probe.cached_chunk_plan.cache_info().hits >= 1


def test_read_reduce_out_and_scratch_on_cpu():
    """On the CPU the plain version fills a given ``out`` in place;
    ``scratch`` belongs to the kernel and is not looked at."""
    rng = np.random.default_rng(1)
    A = torch.tensor(rng.standard_normal((5, 7, 9)).astype(np.float32))
    out = torch.empty(5)
    before = probe.read_reduce.launches
    got = probe.read_reduce(A, out=out, scratch=torch.zeros(3))
    assert got is out
    assert torch.equal(out, A.sum(dim=(1, 2)))
    assert probe.read_reduce.launches == before  # the plain version ran


@pytest.mark.parametrize("shape", [(256, 200, 400), (64, 200, 400),
                                   (7, 33, 161), (3, 1, 5)])
def test_read_reduce_chunk_plan_bf16(shape):
    """At 2 bytes an entry every chunk holds a multiple of 8 entries, so
    that a chunk of an aligned lane starts on 16 bytes; the chunks cover
    the lane."""
    n = shape[1] * shape[2]
    S, chunk = probe.chunk_plan(shape[0], n, 132, 2)
    assert S >= 1 and chunk % 8 == 0
    assert S * chunk >= n > (S - 1) * chunk


def test_read_reduce_bf16_on_cpu():
    """A bf16 A is summed in float32 on each entry cast up: the plain
    version's sum, within float32 rounding of the exact sum of the bf16
    values; the float32 instance's counter does not move."""
    rng = np.random.default_rng(2)
    A = torch.tensor(rng.standard_normal((5, 7, 9)).astype(np.float32)).to(
        torch.bfloat16)
    before = (probe.read_reduce.launches, probe.read_reduce.launches_bf16)
    got = probe.read_reduce(A)
    assert got.dtype == torch.float32
    assert torch.equal(got, A.float().sum(dim=(1, 2)))
    exact = A.float().double().numpy().sum(axis=(1, 2))
    np.testing.assert_allclose(got.numpy(), exact, rtol=0, atol=1e-5)
    out = torch.empty(5)
    assert probe.read_reduce(A, out=out) is out and torch.equal(out, got)
    assert (probe.read_reduce.launches,
            probe.read_reduce.launches_bf16) == before


def test_read_reduce_on_cpu():
    rng = np.random.default_rng(0)
    A = torch.tensor(rng.standard_normal((5, 7, 9)).astype(np.float32))
    assert torch.equal(probe.read_reduce(A), A.sum(dim=(1, 2)))
    with pytest.raises(ValueError, match=r"\(B, M, N\)"):
        probe.read_reduce(A[0])
