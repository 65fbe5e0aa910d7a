"""Batched line-search solvers with the search flattened into the outer
loop (counterpart of ``proxtpu/parallel/flat_ls.py``).

Under ``torch.func.vmap`` the line-search family (PANOC, ZeroFPR, DRLS,
PANOCplus) runs its inner search as ``backtrack_limit`` masked trials per
iteration, whatever the lanes need.  These machines flatten the search into
the outer loop instead: every trip makes ONE uniform oracle evaluation per
lane (a forward product, an f evaluation, an adjoint product, a prox), and
each lane either COMMITS its accepted trial (advancing its iterate,
direction state and count, and setting up the tau = 1 trial of its next
iteration) or HALVES tau and tries again.  The product's input is selected
per lane: a committing lane feeds its fresh direction ``d``, a halving lane
the segment's endpoint ``z``, so one batched product serves both.  For a
quadratic f the halving lanes interpolate f and its gradient along the
segment from cached endpoint values, as the single drivers do.

Per lane the machines keep the single drivers' semantics: the same trial
sequence and accept tests, the forced tau = 0 commit after
``max_backtracks`` halvings, the counts (the initial step counts as
iteration 1) and the solutions.  Adaptive steps: PANOCplus searches gamma
inside its tau search (:func:`_flat_panocplus_run`); adaptive PANOC and
ZeroFPR have two-mode machines (a gamma-search mode and a tau-search mode,
one oracle round per trip either way).

Loop control.  The host drives the trips and tests "no lane active, or the
trip cap reached" once per block of ``check_every`` trips (one wait on the
device per test); the cap is a host integer and is honoured exactly.  Every
update of a trip is masked on the lane being active, so trips made after
the last lane finishes change nothing: counts and solutions do not depend
on ``check_every``.  Nothing inside a trip waits on the device.

Iterates are stacked (B, n) tensors; f, g and A are stacked problem
objects (every tensor carries the batch axis, except those under a
:class:`~proxtpu_torch.utils.shared.Shared` marker, which every lane
shares: a shared A is one (B, n) @ (n, m) product a trip, a stacked A one
``bmm``).

Row stripes over a tp mesh axis (``lane_parallel(stripes=True)``, see
:mod:`~proxtpu_torch.parallel.sharded_ops`): a shared ``MatrixOperator``
in row stripes returns whole rows from ``matvec`` (one all-reduce of the
zero-padded (B, m) products) and ends ``rmatvec`` in one (B, n)
all-reduce, so an oracle round costs two collectives and f, its gradient
and the y-space dot products stay local.  Every rank of a tp group holds
the same bits after each collective, so the host's test ends every rank's
loop at the same trip.  DRLS takes a least squares in row stripes
(``RowShardedLeastSquares``), whose prox sums over tp: three all-reduces
a trip where A is wide, one where it is tall.
"""

from __future__ import annotations

import math

import torch

from ..accel.base import NO_ACCELERATION, QUASI_NEWTON
from ..prox.base import is_generalized_quadratic, prox, value_and_gradient
from ..utils.precision import require_full_f32_matmul
from ..utils.shared import batch_axes, unwrap_shared
from ..utils.tree import eps_of, flatten, real_dtype_of, tree_map
from .sharded_ops import lane_parallel


def _bwhere(pred, new, old):
    """Per-lane select over a tree: ``pred`` is (B,), leaves are (B, ...)."""
    def sel(n, o):
        return torch.where(pred.reshape(pred.shape + (1,) * (n.dim() - 1)),
                           n, o)

    return tree_map(sel, new, old)


def _vdot(a, b):
    """Per-lane real(<a, b>) over (B, n) stacks, ``a`` conjugated."""
    if a.is_complex() or b.is_complex():
        return torch.sum(a.conj() * b, dim=1).real
    return torch.sum(a * b, dim=1)


def _norm_sq(a):
    return _vdot(a, a)


def _inf_norm(a):
    return torch.amax(torch.abs(a), dim=1)


def _over(num, den):
    """``num / den`` for a number over a tensor as a true division (torch
    computes ``number / tensor`` as a reciprocal times the number)."""
    return torch.as_tensor(num, dtype=den.dtype, device=den.device) / den


def _f_model(f_x, grad, res, L):
    """Per-lane quadratic model, the formula of ``utils.fb_tools.f_model``."""
    return f_x - _vdot(grad, res) + (L / 2) * _norm_sq(res)


def _check_blocking(check_every, trip_cap):
    """An explicit ``trip_cap`` takes ``check_every = 1``, as in the JAX
    package (whose device loop tests the cap at block boundaries only)."""
    if trip_cap is not None and int(check_every) > 1:
        raise ValueError(
            "check_every > 1 cannot be combined with an explicit trip_cap "
            "(the JAX package tests the cap at block boundaries only); set "
            "one or the other")


def _host_while(active_of, body, s, check_every, cap):
    """Run ``s = body(s)`` while some lane is active and fewer than ``cap``
    trips have run, testing ``active_of(s).any()`` on the host once per
    block of ``check_every`` trips (the only wait on the device)."""
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    trips = 0
    while trips < cap and bool(active_of(s).any()):
        for _ in range(min(check_every, cap - trips)):
            s = body(s)
            trips += 1
    return s


def _live(s, maxit):
    return ~s["done"] & (s["k"] < maxit)


def _lane_map(obj, fn, n_args):
    """``fn(lane_obj, *args)`` mapped over the lanes with
    ``torch.func.vmap``: the tensors of ``obj`` at the batch axis, those
    under a ``Shared`` marker unmapped, every argument at axis 0."""
    leaves, spec = flatten(obj)
    mapped = torch.func.vmap(
        lambda lv, *args: fn(unwrap_shared(spec.unflatten(lv)), *args),
        in_dims=(batch_axes(obj),) + (0,) * n_args)
    return lambda *args: mapped(leaves, *args)


def _make_vmapped(f, A, g, directions):
    vvg = _lane_map(f, value_and_gradient, 1)
    vprox = _lane_map(g, prox, 2)
    vmv = _lane_map(A, lambda a, v: a.matvec(v), 1)
    vrmv = _lane_map(A, lambda a, v: a.rmatvec(v), 1)
    vinit = torch.func.vmap(directions.init_state)
    vupdate = torch.func.vmap(directions.update)
    vapply = torch.func.vmap(directions.apply)
    return vvg, vprox, vmv, vrmv, vinit, vupdate, vapply


def _style(directions):
    """True for a quasi-Newton direction, False for none; raises for any
    other style."""
    qn = directions.style == QUASI_NEWTON
    if not qn and directions.style != NO_ACCELERATION:
        raise ValueError(f"direction style {directions.style!r} not supported")
    return qn


def _estimate_gamma(vvg, vmv, vrmv, x0, gr0, alpha):
    """Per-lane alpha / lower_bound_smoothness_constant (``fb_tools.jl:
    7-19``)."""
    _, gr_eps = vvg(vmv(x0 + 1))
    diff_sq = _norm_sq(vrmv(gr_eps - gr0))
    n = torch.tensor(float(x0.shape[1]), dtype=diff_sq.dtype,
                     device=x0.device)
    return _over(alpha, torch.sqrt(diff_sq) / torch.sqrt(n))


def _flat_panoc_run(f, A, g, x0, gamma, tol, maxit, alpha, beta,
                    max_backtracks, directions, trip_cap=None, check_every=1):
    """Flattened batched fixed-gamma PANOC.

    f, g: stacked function objects; A: stacked operator; x0: (B, n);
    gamma: (B,).  Returns (z, iters, done) with per-lane counts equal to
    the single ``PANOC(gamma=...)`` driver's.
    """
    B, n = x0.shape
    R, dev = gamma.dtype, x0.device
    eps = eps_of(x0)
    quad = is_generalized_quadratic(f)
    qn = _style(directions)
    vvg, vprox, vmv, vrmv, vinit, vupdate, vapply = _make_vmapped(
        f, A, g, directions)

    def vdirection(dstate, v):
        # fbs_common.next_direction: -(H v) for quasi-Newton, -v otherwise
        return -vapply(dstate, v) if qn else -v

    gcol = gamma[:, None]
    sigma = beta * _over(0.5, gamma) * (1 - alpha)
    L = _over(alpha, gamma)

    def fbe_and_thr(f_x, At_grad, res, g_z):
        fbe = _f_model(f_x, At_grad, res, L) + g_z
        thr = fbe - sigma * _norm_sq(res) + 10 * eps * (1 + torch.abs(fbe))
        return fbe, thr

    # --- init: forward_backward_init + the first tau = 1 trial
    # (``panoc.jl:91-109``)
    Ax0 = vmv(x0)
    f0, gr0 = vvg(Ax0)
    Atg0 = vrmv(gr0)
    y0 = x0 - gcol * Atg0
    z0, gz0 = vprox(y0, gamma)
    res0 = x0 - z0
    done0 = _inf_norm(res0) / gamma <= tol

    dstate0 = vinit(x0) if qn else ()
    d0 = vdirection(dstate0, res0)
    _, thr0 = fbe_and_thr(f0, Atg0, res0, gz0)

    Ad0 = vmv(d0)
    x_d0 = x0 + d0
    Ax_d0 = Ax0 + Ad0
    f_d0, gr_d0 = vvg(Ax_d0)
    Atg_d0 = vrmv(gr_d0)
    yT0 = x_d0 - gcol * Atg_d0
    zT0, gzT0 = vprox(yT0, gamma)
    resT0 = x_d0 - zT0
    fbeT0 = _f_model(f_d0, Atg_d0, resT0, L) + gzT0

    zeros_s = torch.zeros(B, dtype=R, device=dev)
    s = dict(
        # search context (tau = 1 endpoint, segment endpoint, quad caches)
        x_d=x_d0, Ax_d=Ax_d0, f_d=f_d0, gr_d=gr_d0, Atg_d=Atg_d0,
        z_b=z0, x_b=x0, res_b=res0, thr=thr0,
        Az=torch.zeros_like(Ax0), f_Az=zeros_s,
        gr_Az=torch.zeros_like(Ax0), Atg_Az=torch.zeros_like(x0),
        a=zeros_s, b=zeros_s, c=zeros_s,
        abc_valid=torch.zeros(B, dtype=torch.bool, device=dev),
        dstate=dstate0,
        # current trial
        tau=torch.ones(B, dtype=R, device=dev),
        bt=torch.ones(B, dtype=torch.int32, device=dev),
        xT=x_d0, AxT=Ax_d0, f_T=f_d0, gr_T=gr_d0, Atg_T=Atg_d0,
        zT=zT0, gzT=gzT0, resT=resT0, fbeT=fbeT0,
        # outputs
        z_sol=z0, k=torch.ones(B, dtype=torch.int32, device=dev),
        done=done0,
    )

    cap = maxit * (max_backtracks + 2) + 4 if trip_cap is None else trip_cap

    def body(s):
        # accept test: FBE decrease, or the forced tau = 0 trial after
        # max_backtracks halvings is committed unconditionally
        # (``panoc.jl:204-250``: cond k <= max_backtracks)
        accept = (s["fbeT"] <= s["thr"]) | (s["bt"] > max_backtracks)
        active = _live(s, maxit)
        commit = accept & active
        ccol = commit[:, None]

        # --- commit-side bookkeeping (masked; no oracle work)
        if qn:
            dstate = _bwhere(commit, vupdate(
                s["dstate"], s["xT"] - s["x_b"], s["resT"] - s["res_b"]),
                s["dstate"])
        else:
            dstate = s["dstate"]
        d_new = vdirection(dstate, s["resT"])
        newly_done = commit & (_inf_norm(s["resT"]) / gamma <= tol)
        _, thr_commit = fbe_and_thr(s["f_T"], s["Atg_T"], s["resT"],
                                    s["gzT"])

        # --- ONE uniform oracle evaluation, inputs selected per lane:
        # committing lanes run the tau = 1 trial of their next iteration,
        # halving lanes materialise Az, f(Az), A^H grad f(Az) on their
        # first halving (cached afterwards) and interpolate
        mv_in = torch.where(ccol, d_new, s["z_b"])
        Av = vmv(mv_in)

        x_d = torch.where(ccol, s["xT"] + d_new, s["x_d"])
        Ax_d = torch.where(ccol, s["AxT"] + Av, s["Ax_d"])
        Az = torch.where(s["abc_valid"][:, None], s["Az"], Av)

        tau = torch.where(
            commit, 1.0,
            torch.where(s["bt"] >= max_backtracks, 0.0, s["tau"] / 2)
        ).to(R)
        bt = torch.where(commit, 1, s["bt"] + 1).to(torch.int32)
        z_b = torch.where(ccol, s["zT"], s["z_b"])
        tcol = tau[:, None]
        xT = torch.where(ccol, x_d, tcol * x_d + (1 - tcol) * z_b)
        AxT = torch.where(ccol, Ax_d, tcol * Ax_d + (1 - tcol) * Az)

        if quad:
            # interpolate f along the segment as the driver does
            # (``panoc.jl:217-237``)
            fin = torch.where(ccol, Ax_d, Az)
            f_val, f_gr = vvg(fin)
            f_d = torch.where(commit, f_val, s["f_d"])
            gr_d = torch.where(ccol, f_gr, s["gr_d"])
            f_Az = torch.where(s["abc_valid"], s["f_Az"], f_val)
            gr_Az = torch.where(s["abc_valid"][:, None], s["gr_Az"], f_gr)
            gin = torch.where(ccol, f_gr, gr_Az)
            Atg = vrmv(gin)
            Atg_d = torch.where(ccol, Atg, s["Atg_d"])
            Atg_Az = torch.where(s["abc_valid"][:, None], s["Atg_Az"], Atg)
            cc = torch.where(s["abc_valid"], s["c"], f_Az)
            bb = torch.where(s["abc_valid"], s["b"],
                             _vdot(Ax_d, gr_Az) - _vdot(Az, gr_Az))
            aa = torch.where(s["abc_valid"], s["a"], f_d - bb - cc)
            f_T = torch.where(commit, f_val, aa * tau ** 2 + bb * tau + cc)
            gr_T = torch.where(ccol, f_gr,
                               tcol * gr_d + (1 - tcol) * gr_Az)
            Atg_T = torch.where(ccol, Atg,
                                tcol * Atg_d + (1 - tcol) * Atg_Az)
            abc_valid = ~commit
        else:
            # non-quadratic f: evaluate at the trial point itself (the
            # committing lanes' tau = 1 point IS their endpoint A(x + d))
            f_val, f_gr = vvg(AxT)
            Atg = vrmv(f_gr)
            f_d = torch.where(commit, f_val, s["f_d"])
            gr_d = torch.where(ccol, f_gr, s["gr_d"])
            Atg_d = torch.where(ccol, Atg, s["Atg_d"])
            f_Az, gr_Az, Atg_Az = s["f_Az"], s["gr_Az"], s["Atg_Az"]
            aa, bb, cc = s["a"], s["b"], s["c"]
            abc_valid = ~commit
            f_T, gr_T, Atg_T = f_val, f_gr, Atg

        yT = xT - gcol * Atg_T
        zT, gzT = vprox(yT, gamma)
        resT = xT - zT
        fbeT = _f_model(f_T, Atg_T, resT, L) + gzT

        new = dict(
            x_d=x_d, Ax_d=Ax_d, f_d=f_d, gr_d=gr_d, Atg_d=Atg_d,
            z_b=z_b,
            x_b=torch.where(ccol, s["xT"], s["x_b"]),
            res_b=torch.where(ccol, s["resT"], s["res_b"]),
            thr=torch.where(commit, thr_commit, s["thr"]),
            Az=Az, f_Az=f_Az, gr_Az=gr_Az, Atg_Az=Atg_Az,
            a=aa, b=bb, c=cc, abc_valid=abc_valid,
            dstate=dstate,
            tau=tau, bt=bt,
            xT=xT, AxT=AxT, f_T=f_T, gr_T=gr_T, Atg_T=Atg_T,
            zT=zT, gzT=gzT, resT=resT, fbeT=fbeT,
            z_sol=torch.where(ccol, s["zT"], s["z_sol"]),
            k=s["k"] + commit.to(torch.int32),
            done=s["done"] | newly_done,
        )
        # freeze inactive lanes entirely (converged or at maxit); done is
        # global bookkeeping and never rolls back
        out = {key: _bwhere(active, val, s[key]) for key, val in new.items()}
        out["done"] = new["done"]
        return out

    s = _host_while(lambda s: _live(s, maxit), body, s, check_every, cap)
    return s["z_sol"], s["k"], s["done"]


def _flat_zerofpr_run(f, A, g, x0, gamma, tol, maxit, alpha, beta,
                      max_backtracks, directions, trip_cap=None,
                      check_every=1):
    """Flattened batched fixed-gamma ZeroFPR.

    Each lane alternates a PREP trip (FB quantities at ``xbar``:
    ``res_xbar``, the deferred quasi-Newton update, the direction ``d``;
    ``zerofpr.jl:181-198``) with TRIAL trips (the FBE line search on
    ``x = xbar + tau d``, ``zerofpr.jl:200-217``); every trip spends one
    uniform oracle slot, the product's input selected per lane (PREP feeds
    ``xbar``, TRIAL feeds ``d``).
    """
    B, n = x0.shape
    R, dev = gamma.dtype, x0.device
    eps = eps_of(x0)
    qn = _style(directions)
    vvg, vprox, vmv, vrmv, vinit, vupdate, vapply = _make_vmapped(
        f, A, g, directions)

    def vdirection(dstate, v_qn, v_fb):
        return -vapply(dstate, v_qn) if qn else -v_fb

    gcol = gamma[:, None]
    sigma = beta * _over(0.5, gamma) * (1 - alpha)
    L = _over(alpha, gamma)

    def thr_of(fbe_x, res):
        return fbe_x - sigma * _norm_sq(res) + 10 * eps * (
            1 + torch.abs(fbe_x))

    # --- init: forward_backward_init at x0 (iteration 1)
    Ax0 = vmv(x0)
    f0, gr0 = vvg(Ax0)
    Atg0 = vrmv(gr0)
    y0 = x0 - gcol * Atg0
    xbar0, gxb0 = vprox(y0, gamma)
    res0 = x0 - xbar0
    done0 = _inf_norm(res0) / gamma <= tol
    fbe_x0 = _f_model(f0, Atg0, res0, L) + gxb0

    dstate0 = vinit(x0) if qn else ()
    s = dict(
        phase_prep=torch.ones(B, dtype=torch.bool, device=dev),
        xbar=xbar0, Axbar=Ax0,  # Axbar a placeholder; PREP recomputes it
        res=res0, thr=thr_of(fbe_x0, res0),
        d=torch.zeros_like(x0),
        tau=torch.ones(B, dtype=R, device=dev),
        bt=torch.ones(B, dtype=torch.int32, device=dev),
        dstate=dstate0,
        xbar_prev=xbar0, res_xbar_prev=res0,
        is_prev_set=torch.zeros(B, dtype=torch.bool, device=dev),
        z_sol=xbar0, k=torch.ones(B, dtype=torch.int32, device=dev),
        done=done0,
    )

    cap = maxit * (max_backtracks + 2) + 4 if trip_cap is None else trip_cap

    def body(s):
        prep = s["phase_prep"]
        active = _live(s, maxit)
        pcol = prep[:, None]
        tcol = s["tau"][:, None]

        # --- one uniform oracle slot
        mv_in = torch.where(pcol, s["xbar"], s["d"])
        Av = vmv(mv_in)
        Axbar = torch.where(pcol, Av, s["Axbar"])
        x_t = s["xbar"] + torch.where(pcol, 0.0, tcol).to(R) * s["d"]
        Ax_t = torch.where(pcol, Av, s["Axbar"] + tcol * Av)
        f_t, gr_t = vvg(Ax_t)
        Atg_t = vrmv(gr_t)
        y_t = x_t - gcol * Atg_t
        z_t, gz_t = vprox(y_t, gamma)
        r_t = x_t - z_t

        # --- PREP outcome: res_xbar, the deferred update, the direction
        # (``zerofpr.jl:188-198``); r_t of a PREP lane IS res_xbar
        if qn:
            dstate = _bwhere(prep & s["is_prev_set"], vupdate(
                s["dstate"], s["xbar"] - s["xbar_prev"],
                r_t - s["res_xbar_prev"]), s["dstate"])
        else:
            dstate = s["dstate"]
        d_new = vdirection(dstate, r_t, s["res"])

        # --- TRIAL outcome: the FBE accept test (``zerofpr.jl:200-217``)
        fbe_t = _f_model(f_t, Atg_t, r_t, L) + gz_t
        trial = ~prep
        accept = trial & ((fbe_t <= s["thr"])
                          | (s["bt"] >= max_backtracks))
        acol = accept[:, None]
        commit = accept & active
        newly_done = commit & (_inf_norm(r_t) / gamma <= tol)
        tau_next = torch.where(s["bt"] >= max_backtracks - 1, 0.0,
                               s["tau"] / 2).to(R)

        new = dict(
            # accept -> PREP next; PREP -> TRIAL next; reject -> TRIAL
            phase_prep=accept,
            xbar=torch.where(acol, z_t, s["xbar"]),
            Axbar=Axbar,
            res=torch.where(acol, r_t, s["res"]),
            thr=torch.where(accept, thr_of(fbe_t, r_t), s["thr"]),
            d=torch.where(pcol, d_new, s["d"]),
            tau=torch.where(prep | accept, 1.0,
                            torch.where(trial, tau_next, s["tau"])).to(R),
            bt=torch.where(prep | accept, 1,
                           torch.where(trial, s["bt"] + 1, s["bt"])
                           ).to(torch.int32),
            dstate=dstate,
            xbar_prev=torch.where(pcol, s["xbar"], s["xbar_prev"]),
            res_xbar_prev=torch.where(pcol, r_t, s["res_xbar_prev"]),
            is_prev_set=s["is_prev_set"] | prep,
            z_sol=torch.where(acol, z_t, s["z_sol"]),
            k=s["k"] + commit.to(torch.int32),
            done=s["done"] | newly_done,
        )
        out = {key: _bwhere(active, val, s[key]) for key, val in new.items()}
        out["done"] = new["done"]
        return out

    s = _host_while(lambda s: _live(s, maxit), body, s, check_every, cap)
    return s["z_sol"], s["k"], s["done"]


def _flat_zerofpr_adaptive_run(f, A, g, x0, gamma, tol, maxit, alpha, beta,
                               max_backtracks, directions, minimum_gamma,
                               estimate_gamma=False, trip_cap=None,
                               check_every=1):
    """Flattened batched ADAPTIVE ZeroFPR (gamma backtracking + tau search).

    Two per-lane modes, one product pair per trip:

    * mode G: the trip evaluates ``f(A xbar)`` for the pending gamma
      candidates and tests the quadratic model (``fb_tools.jl:24-63``); a
      failing lane halves gamma and builds new FB candidates from the
      cached base point (prox only); a passing lane seals the iteration's
      gamma and does the PREP work in the same trip (``zerofpr.jl:
      181-198``), entering mode T at tau = 1;
    * mode T: the fixed machine's TRIAL body (``zerofpr.jl:200-217``); a
      committing lane becomes the next iteration's base point and enters
      mode G again with its trial candidates.
    """
    B, n = x0.shape
    R, dev = gamma.dtype, x0.device
    eps = eps_of(x0)
    qn = _style(directions)
    vvg, vprox, vmv, vrmv, vinit, vupdate, vapply = _make_vmapped(
        f, A, g, directions)
    if qn:
        vreset = torch.func.vmap(directions.reset)

    def vdirection(dstate, v_qn, v_fb):
        return -vapply(dstate, v_qn) if qn else -v_fb

    def fmodel(f_x, At_g, res, gam):
        return _f_model(f_x, At_g, res, _over(alpha, gam))

    # --- init: forward_backward_init at x0 (candidates at gamma0; the
    # first G trip makes the driver's backtrack entry test)
    Ax0 = vmv(x0)
    f0, gr0 = vvg(Ax0)
    Atg0 = vrmv(gr0)
    if estimate_gamma:
        gamma = _estimate_gamma(vvg, vmv, vrmv, x0, gr0, alpha)
    gcol0 = gamma[:, None]
    y0 = x0 - gcol0 * Atg0
    xbar0, gxb0 = vprox(y0, gamma)
    res0 = x0 - xbar0
    done0 = _inf_norm(res0) / gamma <= tol
    upp0 = fmodel(f0, Atg0, res0, gamma)

    dstate0 = vinit(x0) if qn else ()
    s = dict(
        in_g=torch.ones(B, dtype=torch.bool, device=dev),
        # committed base point + caches (gamma candidates derive from it)
        x_b=x0, f_b=f0, Atg_b=Atg0,
        # pending gamma candidates / accepted-iteration quantities
        xbar=xbar0, g_xbar=gxb0, res=res0, upp=upp0,
        gamma=gamma, gamma_prev=gamma,
        Axbar=Ax0,  # valid after a G accept (set from the G trip's product)
        thr=torch.zeros(B, dtype=R, device=dev),
        d=torch.zeros_like(x0),
        tau=torch.ones(B, dtype=R, device=dev),
        bt=torch.ones(B, dtype=torch.int32, device=dev),
        dstate=dstate0,
        xbar_prev=xbar0, res_xbar_prev=res0,
        is_prev_set=torch.zeros(B, dtype=torch.bool, device=dev),
        z_sol=xbar0, k=torch.ones(B, dtype=torch.int32, device=dev),
        done=done0,
    )

    cap = (maxit * (max_backtracks + 3) + 128 if trip_cap is None
           else trip_cap)

    def body(s):
        active = _live(s, maxit)
        gamma = s["gamma"]
        gcol = gamma[:, None]
        in_g = s["in_g"]
        in_t = ~in_g
        gco = in_g[:, None]
        tcol = s["tau"][:, None]

        # --- one uniform oracle round: G feeds xbar, T feeds d
        mv_in = torch.where(gco, s["xbar"], s["d"])
        Av = vmv(mv_in)
        Axbar_g = Av  # for G lanes: A xbar of the pending candidates
        x_t = torch.where(gco, s["xbar"], s["xbar"] + tcol * s["d"])
        Ax_t = torch.where(gco, Av, s["Axbar"] + tcol * Av)
        f_t, gr_t = vvg(Ax_t)
        Atg_t = vrmv(gr_t)
        y_t = x_t - gcol * Atg_t
        z_t, gz_t = vprox(y_t, gamma)
        r_t = x_t - z_t
        # for a G lane: f_t = f(A xbar), z_t = xbarbar, r_t = res_xbar

        # --- G decision (the driver's backtrack accept test)
        slack_g = 10 * eps * (1 + torch.abs(f_t))
        acc_g = (f_t <= s["upp"] + slack_g) | (gamma < minimum_gamma)
        accG = in_g & acc_g & active
        halveG = in_g & ~acc_g & active

        # --- dstate: reset on a gamma change (``zerofpr.jl``, adaptive),
        # then the deferred update with the (xbar, res_xbar) deltas
        if qn:
            dstate = _bwhere(accG & (gamma != s["gamma_prev"]),
                             vreset(s["dstate"]), s["dstate"])
            dstate_upd = vupdate(dstate, s["xbar"] - s["xbar_prev"],
                                 r_t - s["res_xbar_prev"])
            dstate = _bwhere(accG & s["is_prev_set"], dstate_upd, dstate)
        else:
            dstate = s["dstate"]
        d_new = vdirection(dstate, r_t, s["res"])

        sigma = beta * _over(0.5, gamma) * (1 - alpha)
        fbe_x = s["upp"] + s["g_xbar"]
        thr_acc = fbe_x - sigma * _norm_sq(s["res"]) + 10 * eps * (
            1 + torch.abs(fbe_x))

        # halveG lanes: fresh FB candidates at gamma / 2 from the base
        gam_h = gamma * 0.5
        y_h = s["x_b"] - gam_h[:, None] * s["Atg_b"]
        xbar_h, gxb_h = vprox(y_h, gam_h)
        res_h = s["x_b"] - xbar_h
        upp_h = fmodel(s["f_b"], s["Atg_b"], res_h, gam_h)

        # --- T decision (FBE accept; ``zerofpr.jl:200-217``)
        fbe_t = fmodel(f_t, Atg_t, r_t, gamma) + gz_t
        accept = in_t & ((fbe_t <= s["thr"]) | (s["bt"] >= max_backtracks))
        commit = accept & active
        halveT = in_t & ~accept & active
        ccol = commit[:, None]
        newly_done = commit & (_inf_norm(r_t) / gamma <= tol)
        tau_next = torch.where(s["bt"] >= max_backtracks - 1, 0.0,
                               s["tau"] / 2).to(R)

        accGc = accG[:, None]
        halveGc = halveG[:, None]

        new = dict(
            in_g=torch.where(commit, True, torch.where(accG, False, in_g)),
            x_b=torch.where(ccol, x_t, s["x_b"]),
            f_b=torch.where(commit, f_t, s["f_b"]),
            Atg_b=torch.where(ccol, Atg_t, s["Atg_b"]),
            xbar=torch.where(ccol, z_t,
                             torch.where(halveGc, xbar_h, s["xbar"])),
            g_xbar=torch.where(commit, gz_t,
                               torch.where(halveG, gxb_h, s["g_xbar"])),
            res=torch.where(ccol, r_t,
                            torch.where(halveGc, res_h, s["res"])),
            upp=torch.where(commit, fmodel(f_t, Atg_t, r_t, gamma),
                            torch.where(halveG, upp_h, s["upp"])),
            gamma=torch.where(halveG, gam_h, gamma),
            gamma_prev=torch.where(accG, gamma, s["gamma_prev"]),
            Axbar=torch.where(accGc, Axbar_g, s["Axbar"]),
            thr=torch.where(accG, thr_acc, s["thr"]),
            d=torch.where(accGc, d_new, s["d"]),
            tau=torch.where(accG | commit, 1.0,
                            torch.where(halveT, tau_next, s["tau"])).to(R),
            bt=torch.where(accG | commit, 1,
                           torch.where(halveT, s["bt"] + 1, s["bt"])
                           ).to(torch.int32),
            dstate=dstate,
            xbar_prev=torch.where(accGc, s["xbar"], s["xbar_prev"]),
            res_xbar_prev=torch.where(accGc, r_t, s["res_xbar_prev"]),
            is_prev_set=s["is_prev_set"] | accG,
            z_sol=torch.where(ccol, z_t, s["z_sol"]),
            k=s["k"] + commit.to(torch.int32),
            done=s["done"] | newly_done,
        )
        out = {key: _bwhere(active, val, s[key]) for key, val in new.items()}
        out["done"] = new["done"]
        return out

    s = _host_while(lambda s: _live(s, maxit), body, s, check_every, cap)
    return s["z_sol"], s["k"], s["done"]


def _dot_real_unconj(a, b):
    """Per-lane real(sum(a .* b)) WITHOUT conjugation: the reference's DRE
    uses the unconjugated ``dot`` (``drls.jl:90-98``)."""
    d = torch.sum(a * b, dim=1)
    return d.real if d.is_complex() else d


def _flat_panoc_adaptive_run(f, A, g, x0, gamma, tol, maxit, alpha, beta,
                             max_backtracks, directions, minimum_gamma,
                             estimate_gamma=False, trip_cap=None,
                             check_every=1):
    """Flattened batched ADAPTIVE PANOC (gamma backtracking + tau search).

    The driver's step is a gamma search at the iteration's base point
    (``fb_tools.jl:24-63`` via ``panoc.jl:141-163``) followed by the FBE
    tau search.  This machine flattens both into the outer loop with a
    per-lane mode flag:

    * mode G (gamma search): the pending trip holds FB candidates and
      ``f(Az)`` at the gamma under test; a failing lane halves gamma and
      evaluates again; a passing lane seals the iteration's gamma
      (resetting its quasi-Newton state iff gamma changed, ``panoc.jl:
      160-162``), computes its direction and evaluates the tau = 1 trial,
      entering mode T;
    * mode T (tau search): the fixed-gamma machine's trial/commit body; a
      committing lane advances its iterate, updates its direction state and
      evaluates the FIRST gamma trial of its next iteration (``f(Az)`` at
      the incoming gamma), entering mode G again.
    """
    B, n = x0.shape
    R, dev = gamma.dtype, x0.device
    eps = eps_of(x0)
    quad = is_generalized_quadratic(f)
    qn = _style(directions)
    vvg, vprox, vmv, vrmv, vinit, vupdate, vapply = _make_vmapped(
        f, A, g, directions)
    if qn:
        vreset = torch.func.vmap(directions.reset)

    def vdirection(dstate, v):
        return -vapply(dstate, v) if qn else -v

    def fmodel(f_x, At_g, res, gam):
        return _f_model(f_x, At_g, res, _over(alpha, gam))

    # --- init: forward_backward_init at x0 (``panoc.jl:91-109``) and the
    # first gamma trial (the driver's backtrack entry test)
    Ax0 = vmv(x0)
    f0, gr0 = vvg(Ax0)
    Atg0 = vrmv(gr0)
    if estimate_gamma:
        gamma = _estimate_gamma(vvg, vmv, vrmv, x0, gr0, alpha)
    gcol0 = gamma[:, None]
    y0 = x0 - gcol0 * Atg0
    z0, gz0 = vprox(y0, gamma)
    res0 = x0 - z0
    done0 = _inf_norm(res0) / gamma <= tol
    Az0 = vmv(z0)
    f_Az0, gr_Az0 = vvg(Az0)
    upp0 = fmodel(f0, Atg0, res0, gamma)

    dstate0 = vinit(x0) if qn else ()
    zeros_s = torch.zeros(B, dtype=R, device=dev)
    s = dict(
        # accepted-iterate base + its caches (mode G works from these)
        x_b=x0, Ax_b=Ax0, f_b=f0, Atg_b=Atg0,
        z_b=z0, gz_b=gz0, res_b=res0, upp=upp0,
        gamma=gamma, gamma_prev=gamma,
        in_g=torch.ones(B, dtype=torch.bool, device=dev),
        thr=zeros_s,
        # tau-search context (valid in mode T)
        x_d=x0, Ax_d=Ax0, f_d=f0, gr_d=gr0, Atg_d=Atg0,
        Az=Az0, f_Az=f_Az0, gr_Az=gr_Az0,
        At_gz=torch.zeros_like(x0),
        a=zeros_s, b=zeros_s, c=zeros_s,
        abc_valid=torch.zeros(B, dtype=torch.bool, device=dev),
        dstate=dstate0,
        tau=torch.ones(B, dtype=R, device=dev),
        bt=torch.ones(B, dtype=torch.int32, device=dev),
        xT=x0, AxT=Ax0, f_T=f0, gr_T=gr0, Atg_T=Atg0,
        zT=z0, gzT=gz0, resT=res0, fbeT=zeros_s,
        z_sol=z0, k=torch.ones(B, dtype=torch.int32, device=dev),
        done=done0,
    )

    cap = (maxit * (max_backtracks + 3) + 128 if trip_cap is None
           else trip_cap)

    def body(s):
        active = _live(s, maxit)
        gamma = s["gamma"]
        gcol = gamma[:, None]

        # ------------------------------------------------ mode G decision
        slack_g = 10 * eps * (1 + torch.abs(s["f_Az"]))
        acc_g = (s["f_Az"] <= s["upp"] + slack_g) | (gamma < minimum_gamma)
        halveG = s["in_g"] & ~acc_g & active
        accG = s["in_g"] & acc_g & active

        # ------------------------------------------------ mode T decision
        in_t = ~s["in_g"]
        accept_t = (s["fbeT"] <= s["thr"]) | (s["bt"] > max_backtracks)
        commit = in_t & accept_t & active
        halveT = in_t & ~accept_t & active

        # --- direction state: a commit updates it (``panoc.jl:252``), a
        # gamma accept resets it iff gamma changed (``panoc.jl:160-162``)
        if qn:
            dstate = _bwhere(commit, vupdate(
                s["dstate"], s["xT"] - s["x_b"], s["resT"] - s["res_b"]),
                s["dstate"])
            dstate = _bwhere(accG & (gamma != s["gamma_prev"]),
                             vreset(dstate), dstate)
        else:
            dstate = s["dstate"]

        # accG lanes seal this gamma: threshold + direction + tau = 1 trial
        sigma = beta * _over(0.5, gamma) * (1 - alpha)
        fbe_x = s["upp"] + s["gz_b"]
        thr_acc = fbe_x - sigma * _norm_sq(s["res_b"]) + 10 * eps * (
            1 + torch.abs(fbe_x))
        d_new = vdirection(dstate, s["res_b"])

        # halveG lanes: fresh FB candidates at gamma / 2 (prox slot)
        gam_h = gamma * 0.5
        accGc = accG[:, None]
        halveGc = halveG[:, None]
        commitc = commit[:, None]

        # ---------------- the ONE uniform oracle round, inputs per lane:
        # accG -> d (tau = 1 endpoint), halveG -> z at gamma / 2,
        # commit -> zT (next iteration's first gamma trial),
        # halveT -> z_b (lazy Az, the fixed machine's pattern)
        y_h = s["x_b"] - gam_h[:, None] * s["Atg_b"]
        gam_for_prox = torch.where(halveG, gam_h, gamma)
        zh, gzh = vprox(torch.where(halveGc, y_h, s["x_b"]), gam_for_prox)
        res_h = s["x_b"] - zh
        upp_h = fmodel(s["f_b"], s["Atg_b"], res_h, gam_h)

        mv_in = torch.where(
            accGc, d_new,
            torch.where(halveGc, zh,
                        torch.where(commitc, s["zT"], s["z_b"])))
        Av = vmv(mv_in)
        x_d = torch.where(accGc, s["x_b"] + d_new, s["x_d"])
        Ax_d = torch.where(accGc, s["Ax_b"] + Av, s["Ax_d"])

        # Az cache: halveG -> fresh Az(gamma / 2); commit -> Az(zT);
        # halveT without a cache -> materialised now
        need_lazy = halveT & ~s["abc_valid"]
        Az = torch.where((halveG | commit | need_lazy)[:, None], Av, s["Az"])

        tau = torch.where(
            commit | accG, 1.0,
            torch.where(halveT & (s["bt"] >= max_backtracks), 0.0,
                        torch.where(halveT, s["tau"] / 2, s["tau"]))).to(R)
        tcol = tau[:, None]
        z_lin = torch.where(commitc, s["zT"], s["z_b"])
        xT = torch.where(accGc, x_d,
                         torch.where(commitc, s["xT"],
                                     tcol * s["x_d"] + (1 - tcol) * z_lin))
        AxT = torch.where(accGc, Ax_d,
                          torch.where(commitc, s["AxT"],
                                      tcol * s["Ax_d"] + (1 - tcol) * Az))

        if quad:
            fin = torch.where(accGc, Ax_d, Az)
            f_val, f_gr = vvg(fin)
            # update the interpolation cache from what this round evaluated
            f_d = torch.where(accG, f_val, s["f_d"])
            gr_d = torch.where(accGc, f_gr, s["gr_d"])
            f_Az_new = torch.where(accG, s["f_Az"], f_val)
            gr_Az_new = torch.where(accGc, s["gr_Az"], f_gr)
            # adjoint: accG -> at gr(Ax_d); halveT needing interpolation ->
            # at gr_Az (for At_gz); others -> a placeholder (discarded)
            gin = torch.where(accGc, f_gr, gr_Az_new)
            Atg = vrmv(gin)
            Atg_d = torch.where(accGc, Atg, s["Atg_d"])
            At_gz = torch.where(
                (halveT & ~s["abc_valid"])[:, None] | halveGc | commitc,
                torch.where(accGc, s["At_gz"], Atg), s["At_gz"])
            keep = halveT & s["abc_valid"]
            cc = torch.where(keep, s["c"], f_Az_new)
            bb = torch.where(keep, s["b"], _vdot(s["Ax_d"], gr_Az_new)
                             - _vdot(Az, gr_Az_new))
            aa = torch.where(keep, s["a"], s["f_d"] - bb - cc)
            f_T = torch.where(
                accG, f_val,
                torch.where(halveT, aa * tau ** 2 + bb * tau + cc, s["f_T"]))
            gr_T = torch.where(
                accGc, f_gr,
                torch.where(halveT[:, None],
                            tcol * s["gr_d"] + (1 - tcol) * gr_Az_new,
                            s["gr_T"]))
            Atg_T = torch.where(
                accGc, Atg,
                torch.where(halveT[:, None],
                            tcol * s["Atg_d"] + (1 - tcol) * At_gz,
                            s["Atg_T"]))
            abc_valid = halveT | (s["abc_valid"] & in_t)
        else:
            fin = torch.where(accGc, Ax_d,
                              torch.where(halveT[:, None], AxT, Az))
            f_val, f_gr = vvg(fin)
            Atg = vrmv(f_gr)
            f_d = torch.where(accG, f_val, s["f_d"])
            gr_d = torch.where(accGc, f_gr, s["gr_d"])
            Atg_d = torch.where(accGc, Atg, s["Atg_d"])
            f_Az_new = torch.where(halveG | commit, f_val, s["f_Az"])
            gr_Az_new = torch.where((halveG | commit)[:, None], f_gr,
                                    s["gr_Az"])
            f_T = torch.where(accG | halveT, f_val, s["f_T"])
            gr_T = torch.where((accG | halveT)[:, None], f_gr, s["gr_T"])
            Atg_T = torch.where((accG | halveT)[:, None], Atg, s["Atg_T"])
            At_gz = s["At_gz"]
            aa, bb, cc = s["a"], s["b"], s["c"]
            abc_valid = s["abc_valid"]

        # G-mode rounds evaluated f at Az (halveG / commit): record f_Az
        if quad:
            f_Az_final = torch.where(halveG | commit, f_val, f_Az_new)
            gr_Az_final = torch.where((halveG | commit)[:, None], f_gr,
                                      gr_Az_new)
        else:
            f_Az_final, gr_Az_final = f_Az_new, gr_Az_new

        # the tau trial of accG and halveT lanes (the halveG lanes used the
        # first prox; mixed batches pay two elementwise proxes, still one
        # product pair)
        yT = xT - gcol * Atg_T
        zT, gzT = vprox(yT, gamma)
        resT = xT - zT
        fbeT = fmodel(f_T, Atg_T, resT, gamma) + gzT

        # ----------------------------------------- state transitions
        newly_done = commit & (_inf_norm(s["resT"]) / gamma <= tol)
        trial = accG | halveT

        new = dict(
            x_b=torch.where(commitc, s["xT"], s["x_b"]),
            Ax_b=torch.where(commitc, s["AxT"], s["Ax_b"]),
            f_b=torch.where(commit, s["f_T"], s["f_b"]),
            Atg_b=torch.where(commitc, s["Atg_T"], s["Atg_b"]),
            z_b=torch.where(commitc, s["zT"],
                            torch.where(halveGc, zh, s["z_b"])),
            gz_b=torch.where(commit, s["gzT"],
                             torch.where(halveG, gzh, s["gz_b"])),
            res_b=torch.where(commitc, s["resT"],
                              torch.where(halveGc, res_h, s["res_b"])),
            upp=torch.where(commit,
                            fmodel(s["f_T"], s["Atg_T"], s["resT"], gamma),
                            torch.where(halveG, upp_h, s["upp"])),
            gamma=torch.where(halveG, gam_h, gamma),
            gamma_prev=torch.where(accG, gamma, s["gamma_prev"]),
            in_g=torch.where(commit | halveG, True,
                             torch.where(accG, False, s["in_g"])),
            thr=torch.where(accG, thr_acc, s["thr"]),
            x_d=x_d, Ax_d=Ax_d, f_d=f_d, gr_d=gr_d, Atg_d=Atg_d,
            Az=Az, f_Az=f_Az_final, gr_Az=gr_Az_final, At_gz=At_gz,
            a=aa, b=bb, c=cc, abc_valid=abc_valid,
            dstate=dstate,
            tau=tau,
            bt=torch.where(accG, 1,
                           torch.where(halveT, s["bt"] + 1, s["bt"])
                           ).to(torch.int32),
            xT=xT, AxT=AxT, f_T=f_T, gr_T=gr_T, Atg_T=Atg_T,
            zT=torch.where(trial[:, None], zT, s["zT"]),
            gzT=torch.where(trial, gzT, s["gzT"]),
            resT=torch.where(trial[:, None], resT, s["resT"]),
            fbeT=torch.where(trial, fbeT, s["fbeT"]),
            z_sol=torch.where(commitc, s["zT"], s["z_sol"]),
            k=s["k"] + commit.to(torch.int32),
            done=s["done"] | newly_done,
        )
        out = {key: _bwhere(active, val, s[key]) for key, val in new.items()}
        out["done"] = new["done"]
        return out

    s = _host_while(lambda s: _live(s, maxit), body, s, check_every, cap)
    return s["z_sol"], s["k"], s["done"]


def _flat_drls_run(f, g, x0, gamma, lam, c, tol, maxit, max_backtracks,
                   directions, dre_sign, trip_cap=None, check_every=1):
    """Flattened batched DRLS (fixed gamma: DRLS has no adaptive mode).

    Every trip spends one uniform prox_f + prox_g slot per lane: a
    committing lane evaluates the tau = 1 trial of its next iteration
    (prox_f at ``x + d``), a halving lane either evaluates its trial point
    (non-quadratic f) or materialises the interpolation endpoint ``u0 =
    prox_f(xbar_prev)`` on its first halving and interpolates afterwards
    (``drls.jl:172-184``); prox_g at ``2u - x`` runs for every lane.  The
    quasi-Newton update happens on the commit trip with ``(d, res_tau1 -
    res_committed)``: the reference updates at the tau = 1 trial
    (``drls.jl:143-150``), which IS the commit trip here.
    """
    B, n = x0.shape
    R, dev = gamma.dtype, x0.device
    quad = is_generalized_quadratic(f)
    vprox_f = _lane_map(f, prox, 2)
    vprox_g = _lane_map(g, prox, 2)
    qn = _style(directions)
    if qn:
        vinit = torch.func.vmap(directions.init_state)
        vupdate = torch.func.vmap(directions.update)
        vapply = torch.func.vmap(directions.apply)

    gcol = gamma[:, None]
    lcol = lam[:, None]

    def dre_of(f_u, g_v, x, u, res):
        return (f_u + g_v - _dot_real_unconj(x - u, res) / gamma
                + _norm_sq(res) / (2 * gamma))

    def thr_of(dre, res):
        return dre_sign * dre - (c / gamma) * _norm_sq(res)

    def vdirection(dstate, res, xbar, x):
        # ``drls.jl:127-138``: -(H res) for quasi-Newton, xbar - x
        # (= -lam res) for no acceleration
        return -vapply(dstate, res) if qn else xbar - x

    # --- init (iteration 1): DR quantities at x0 (``drls.jl``, init)
    u_i, f_u_i = vprox_f(x0, gamma)
    w_i = 2 * u_i - x0
    v_i, g_v_i = vprox_g(w_i, gamma)
    res_i = u_i - v_i
    xbar_i = x0 - lcol * res_i
    done0 = _inf_norm(res_i) / gamma <= tol
    thr0 = thr_of(dre_of(f_u_i, g_v_i, x0, u_i, res_i), res_i)

    # the first tau = 1 trial (of iteration 2's search)
    dstate0 = vinit(x0) if qn else ()
    d0 = vdirection(dstate0, res_i, xbar_i, x0)
    x_d0 = x0 + d0
    uT0, f_uT0 = vprox_f(x_d0, gamma)
    wT0 = 2 * uT0 - x_d0
    vT0, g_vT0 = vprox_g(wT0, gamma)
    resT0 = uT0 - vT0
    xbarT0 = x_d0 - lcol * resT0
    dreT0 = dre_of(f_uT0, g_vT0, x_d0, uT0, resT0)
    if qn:
        dstate0 = vupdate(dstate0, d0, resT0 - res_i)

    zeros_s = torch.zeros(B, dtype=R, device=dev)
    s = dict(
        # search context
        x_d=x_d0, xbar_b=xbar_i, thr=thr0, f_u1=f_uT0,
        u0=uT0, u1=uT0, a=zeros_s, b=zeros_s, cH=zeros_s,
        abc_valid=torch.zeros(B, dtype=torch.bool, device=dev),
        dstate=dstate0,
        # current trial
        tau=torch.ones(B, dtype=R, device=dev),
        bt=torch.ones(B, dtype=torch.int32, device=dev),
        xT=x_d0, uT=uT0, vT=vT0, resT=resT0, xbarT=xbarT0,
        f_uT=f_uT0, g_vT=g_vT0, dreT=dreT0,
        # outputs
        v_sol=v_i, k=torch.ones(B, dtype=torch.int32, device=dev),
        done=done0,
    )

    cap = maxit * (max_backtracks + 2) + 4 if trip_cap is None else trip_cap

    def body(s):
        accept = (dre_sign * s["dreT"] <= s["thr"]) | (
            s["bt"] > max_backtracks)
        active = _live(s, maxit)
        commit = accept & active
        ccol = commit[:, None]

        # --- commit side (before the oracle): threshold, fresh direction
        thr_c = thr_of(s["dreT"], s["resT"])
        d_new = vdirection(s["dstate"], s["resT"], s["xbarT"], s["xT"])
        x_d_c = s["xT"] + d_new
        newly_done = commit & (_inf_norm(s["resT"]) / gamma <= tol)

        # --- the halving side's trial point
        tau_h = torch.where(s["bt"] >= max_backtracks, 0.0,
                            s["tau"] / 2).to(R)
        tcol = tau_h[:, None]
        x_h = tcol * s["x_d"] + (1 - tcol) * s["xbar_b"]

        # --- ONE uniform prox_f slot (commit: the fresh tau = 1 point;
        # halving, quadratic: the endpoint xbar_prev; halving, otherwise:
        # the trial point itself)
        pf_in = torch.where(ccol, x_d_c, s["xbar_b"] if quad else x_h)
        u_p, f_p = vprox_f(pf_in, gamma)

        if quad:
            avalid = s["abc_valid"]
            u0 = torch.where(avalid[:, None], s["u0"], u_p)
            cH = torch.where(avalid, s["cH"], f_p)
            bb = torch.where(
                avalid, s["b"],
                _vdot(s["xbar_b"] - s["x_d"], s["xbar_b"] - u0) / gamma)
            aa = torch.where(avalid, s["a"], s["f_u1"] - bb - cH)
            u_trial_h = tcol * s["u1"] + (1 - tcol) * u0
            f_trial_h = aa * tau_h ** 2 + bb * tau_h + cH
        else:
            u0, aa, bb, cH = s["u0"], s["a"], s["b"], s["cH"]
            u_trial_h, f_trial_h = u_p, f_p

        uT = torch.where(ccol, u_p, u_trial_h)
        f_uT = torch.where(commit, f_p, f_trial_h)
        xT = torch.where(ccol, x_d_c, x_h)
        wT = 2 * uT - xT
        vT, g_vT = vprox_g(wT, gamma)
        resT = uT - vT
        xbarT = xT - lcol * resT
        dreT = dre_of(f_uT, g_vT, xT, uT, resT)

        if qn:
            dstate = _bwhere(commit, vupdate(s["dstate"], d_new,
                                             resT - s["resT"]), s["dstate"])
        else:
            dstate = s["dstate"]

        new = dict(
            x_d=torch.where(ccol, x_d_c, s["x_d"]),
            xbar_b=torch.where(ccol, s["xbarT"], s["xbar_b"]),
            thr=torch.where(commit, thr_c, s["thr"]),
            f_u1=torch.where(commit, f_p, s["f_u1"]),
            u0=torch.where(ccol, u_p, u0),
            u1=torch.where(ccol, u_p, s["u1"]),
            a=torch.where(commit, 0.0, aa).to(R),
            b=torch.where(commit, 0.0, bb).to(R),
            cH=torch.where(commit, 0.0, cH).to(R),
            abc_valid=(~commit if quad
                       else torch.zeros(B, dtype=torch.bool, device=dev)),
            dstate=dstate,
            tau=torch.where(commit, 1.0, tau_h).to(R),
            bt=torch.where(commit, 1, s["bt"] + 1).to(torch.int32),
            xT=xT, uT=uT, vT=vT, resT=resT, xbarT=xbarT,
            f_uT=f_uT, g_vT=g_vT, dreT=dreT,
            v_sol=torch.where(ccol, s["vT"], s["v_sol"]),
            k=s["k"] + commit.to(torch.int32),
            done=s["done"] | newly_done,
        )
        out = {key: _bwhere(active, val, s[key]) for key, val in new.items()}
        out["done"] = new["done"]
        return out

    s = _host_while(lambda s: _live(s, maxit), body, s, check_every, cap)
    return s["v_sol"], s["k"], s["done"]


def _rvec(v, R, B, device):
    """A scalar or (B,) parameter as a (B,) tensor of dtype ``R``."""
    return torch.as_tensor(v, dtype=R, device=device).expand(B)


@lane_parallel(stripes=True)
def batched_drls(f, g, x0, gamma, lam, c, tol, maxit=1000,
                 max_backtracks=20, directions=None, dre_sign=1,
                 trip_cap=None, check_every=1):
    """Flattened batched DRLS (one prox_f + prox_g per trip; see
    :func:`_flat_drls_run`).

    ``f``, ``g``: stacked function objects (f with a prox); ``x0``: (B, n);
    ``gamma``, ``lam``, ``c``: scalars or (B,).  Returns ``(v, iters,
    done)`` matching the single ``DRLS(...)`` driver.
    """
    from ..accel.lbfgs import LBFGS

    if directions is None:
        directions = LBFGS(5)
    x0 = torch.as_tensor(x0)
    R, B = real_dtype_of(x0), x0.shape[0]
    gamma, lam, c = (_rvec(v, R, B, x0.device) for v in (gamma, lam, c))
    _check_blocking(check_every, trip_cap)
    require_full_f32_matmul()
    return _flat_drls_run(
        f, g, x0, gamma, lam, c, tol, maxit, int(max_backtracks),
        directions, int(dre_sign), trip_cap=trip_cap,
        check_every=int(check_every))


def _flat_panocplus_run(f, A, g, x0, gamma, tol, maxit, alpha, beta,
                        max_backtracks, directions, adaptive, minimum_gamma,
                        estimate_gamma=False, init_backtracks=40,
                        trip_cap=None, check_every=1):
    """Flattened batched PANOCplus, fixed OR adaptive gamma.

    PANOCplus searches gamma *inside* the tau line search
    (``panocplus.jl:168-240``): every trip evaluates ONE trial per lane
    (the forward/adjoint pass at the trial point plus the ``Az`` pass the
    algorithm always needs), then each lane SHRINKS gamma (resetting its
    direction state and starting its search again at tau = 1), COMMITS the
    trial as its next iterate, or HALVES tau.

    The adaptive cold start (the reference's init-time
    ``backtrack_stepsize``, ``panocplus.jl:104``) runs once as
    ``init_backtracks`` masked trials, at init only.
    """
    B, n = x0.shape
    R, dev = gamma.dtype, x0.device
    eps = eps_of(x0)
    qn = _style(directions)
    vvg, vprox, vmv, vrmv, vinit, vupdate, vapply = _make_vmapped(
        f, A, g, directions)
    if qn:
        vreset = torch.func.vmap(directions.reset)

    def vdirection(dstate, v):
        return -vapply(dstate, v) if qn else -v

    def fmodel(f_x, At_g, res, gam):
        return _f_model(f_x, At_g, res, _over(alpha, gam))

    # --- init: forward_backward_init (+ the adaptive gamma search) at x0
    Ax0 = vmv(x0)
    f0, gr0 = vvg(Ax0)
    Atg0 = vrmv(gr0)
    if estimate_gamma:
        # per-lane lower_bound_smoothness_constant (``fb_tools.jl:7-19``)
        gamma = _estimate_gamma(vvg, vmv, vrmv, x0, gr0, alpha)

    def fb_at(gam):
        gc = gam[:, None]
        y = x0 - gc * Atg0
        z, gz = vprox(y, gam)
        res = x0 - z
        upp = fmodel(f0, Atg0, res, gam)
        f_Az, gr_Az = vvg(vmv(z))
        return dict(gamma=gam, z=z, gz=gz, res=res, upp=upp, f_Az=f_Az,
                    gr_Az=gr_Az)

    c0 = fb_at(gamma)
    if adaptive:
        def accepted(c):
            tol_b = 10 * eps * (1 + torch.abs(c["f_Az"]))
            return (c["f_Az"] <= c["upp"] + tol_b) | (
                c["gamma"] < minimum_gamma)

        for _ in range(init_backtracks):
            keep = accepted(c0)
            trial = fb_at(c0["gamma"] * 0.5)
            c0 = {k: _bwhere(keep, c0[k], trial[k]) for k in c0}

    gamma0 = c0["gamma"]
    z0, gz0, res0 = c0["z"], c0["gz"], c0["res"]
    At_gz0 = vrmv(c0["gr_Az"])
    done0 = _inf_norm(res0 / gamma0[:, None] - Atg0 + At_gz0) <= tol
    fbe0 = c0["upp"] + gz0
    sigma0 = beta * _over(0.5, gamma0) * (1 - alpha)
    thr0 = fbe0 - sigma0 * _norm_sq(res0) + 10 * eps * (1 + torch.abs(fbe0))

    dstate0 = vinit(x0) if qn else ()
    s = dict(
        x_b=x0, res_b=res0, thr=thr0, gamma=gamma0, dstate=dstate0,
        d=vdirection(dstate0, res0),
        tau=torch.ones(B, dtype=R, device=dev),
        bt=torch.zeros(B, dtype=torch.int32, device=dev),
        z_sol=z0, k=torch.ones(B, dtype=torch.int32, device=dev),
        done=done0,
    )

    cap = (maxit * (max_backtracks + 2) * (3 if adaptive else 1) + 4
           if trip_cap is None else trip_cap)

    def body(s):
        active = _live(s, maxit)
        gamma = s["gamma"]
        gcol = gamma[:, None]
        tcol = s["tau"][:, None]

        # --- evaluate the pending trial (``panocplus.jl:178-207``)
        x_t = (1 - tcol) * (s["x_b"] - s["res_b"]) + tcol * (
            s["x_b"] + s["d"])
        Ax_t = vmv(x_t)
        f_t, gr_t = vvg(Ax_t)
        Atg_t = vrmv(gr_t)
        y_t = x_t - gcol * Atg_t
        z_t, gz_t = vprox(y_t, gamma)
        res_t = x_t - z_t
        upp_t = fmodel(f_t, Atg_t, res_t, gamma)
        Az_t = vmv(z_t)
        f_Az_t, gr_Az_t = vvg(Az_t)
        At_gz_t = vrmv(gr_Az_t)

        # --- decide: shrink gamma / commit / halve tau
        if adaptive:
            tol_b = 10 * eps * (1 + torch.abs(f_Az_t))
            shrink = (f_Az_t > upp_t + tol_b) & (gamma >= minimum_gamma)
        else:
            shrink = torch.zeros(B, dtype=torch.bool, device=dev)
        fbe_t = upp_t + gz_t
        finish = (fbe_t <= s["thr"]) | (s["bt"] >= max_backtracks)
        commit = ~shrink & finish & active
        shrink = shrink & active
        ccol = commit[:, None]

        if qn:
            dstate = _bwhere(commit, vupdate(
                s["dstate"], x_t - s["x_b"], res_t - s["res_b"]),
                s["dstate"])
            dstate = _bwhere(shrink, vreset(dstate), dstate)
        else:
            dstate = s["dstate"]

        gamma_n = torch.where(shrink, gamma * 0.5, gamma)
        x_b = torch.where(ccol, x_t, s["x_b"])
        res_b = torch.where(ccol, res_t, s["res_b"])
        sigma_n = beta * _over(0.5, gamma_n) * (1 - alpha)
        thr = torch.where(commit, fbe_t - sigma_n * _norm_sq(res_t)
                          + 10 * eps * (1 + torch.abs(fbe_t)), s["thr"])

        fresh = commit | shrink
        d = torch.where(fresh[:, None], vdirection(dstate, res_b), s["d"])
        halve = ~fresh & active
        tau = torch.where(
            fresh, 1.0,
            torch.where(halve & (s["bt"] >= max_backtracks - 1), 0.0,
                        torch.where(halve, s["tau"] / 2, s["tau"]))).to(R)
        bt = torch.where(fresh, 0, torch.where(halve, s["bt"] + 1, s["bt"])
                         ).to(torch.int32)

        newly_done = commit & (
            _inf_norm(res_t / gamma_n[:, None] - Atg_t + At_gz_t) <= tol)

        new = dict(
            x_b=x_b, res_b=res_b, thr=thr, gamma=gamma_n, dstate=dstate,
            d=d, tau=tau, bt=bt,
            z_sol=torch.where(ccol, z_t, s["z_sol"]),
            k=s["k"] + commit.to(torch.int32),
            done=s["done"] | newly_done,
        )
        out = {key: _bwhere(active, val, s[key]) for key, val in new.items()}
        out["done"] = new["done"]
        return out

    s = _host_while(lambda s: _live(s, maxit), body, s, check_every, cap)
    return s["z_sol"], s["k"], s["done"]


@lane_parallel(stripes=True)
def batched_panocplus(f, A, g, x0, gamma, tol, maxit=1000, alpha=0.95,
                      beta=0.5, max_backtracks=20, directions=None,
                      adaptive=False, minimum_gamma=1e-7,
                      init_backtracks=None, trip_cap=None, check_every=1):
    """Flattened batched PANOCplus, fixed or adaptive step (see
    :func:`_flat_panocplus_run`).

    ``gamma``: a scalar or (B,) *initial* steps (for adaptive, the
    search's start), or ``None`` for the per-lane estimate (which makes the
    step adaptive, as the factory does).  Returns ``(z, iters, done)``
    matching the single ``PANOCplus(...)`` driver per lane.
    """
    from ..accel.lbfgs import LBFGS

    if directions is None:
        directions = LBFGS(5)
    x0 = torch.as_tensor(x0)
    R, B = real_dtype_of(x0), x0.shape[0]
    estimate_gamma = gamma is None
    if estimate_gamma:
        adaptive = True  # an estimated gamma makes the step adaptive
        gamma = torch.zeros(B, dtype=R, device=x0.device)  # set in the run
    else:
        gamma = _rvec(gamma, R, B, x0.device)
    if init_backtracks is None:
        if adaptive and not estimate_gamma:
            hi = float(gamma.max())
            init_backtracks = max(2, int(math.ceil(math.log2(
                max(hi, minimum_gamma) / minimum_gamma))) + 2)
        else:
            init_backtracks = 40
    _check_blocking(check_every, trip_cap)
    require_full_f32_matmul()
    return _flat_panocplus_run(
        f, A, g, x0, gamma, tol, maxit, float(alpha), float(beta),
        int(max_backtracks), directions, bool(adaptive),
        torch.as_tensor(minimum_gamma, dtype=R, device=x0.device),
        estimate_gamma=estimate_gamma, init_backtracks=int(init_backtracks),
        trip_cap=trip_cap, check_every=int(check_every))


@lane_parallel(stripes=True)
def batched_zerofpr(f, A, g, x0, gamma, tol, maxit=1000, alpha=0.95,
                    beta=0.5, max_backtracks=20, directions=None,
                    trip_cap=None, check_every=1, adaptive=False,
                    minimum_gamma=1e-7, estimate_gamma=False):
    """Flattened batched ZeroFPR, fixed (default) or adaptive step (one
    oracle evaluation per trip; see :func:`_flat_zerofpr_run` and
    :func:`_flat_zerofpr_adaptive_run`).

    The calling convention of :func:`batched_panoc`; returns ``(xbar,
    iters, done)`` matching ``ZeroFPR(...)`` per lane.
    """
    from ..accel.lbfgs import LBFGS

    if directions is None:
        directions = LBFGS(5)
    x0 = torch.as_tensor(x0)
    R, B = real_dtype_of(x0), x0.shape[0]
    gamma = _rvec(gamma, R, B, x0.device)
    _check_blocking(check_every, trip_cap)
    require_full_f32_matmul()
    if adaptive:
        return _flat_zerofpr_adaptive_run(
            f, A, g, x0, gamma, tol, maxit, float(alpha), float(beta),
            int(max_backtracks), directions,
            torch.as_tensor(minimum_gamma, dtype=R, device=x0.device),
            estimate_gamma=bool(estimate_gamma), trip_cap=trip_cap,
            check_every=int(check_every))
    return _flat_zerofpr_run(
        f, A, g, x0, gamma, tol, maxit, float(alpha), float(beta),
        int(max_backtracks), directions, trip_cap=trip_cap,
        check_every=int(check_every))


@lane_parallel(stripes=True)
def batched_panoc(f, A, g, x0, gamma, tol, maxit=1000, alpha=0.95,
                  beta=0.5, max_backtracks=20, directions=None,
                  trip_cap=None, check_every=1, adaptive=False,
                  minimum_gamma=1e-7, estimate_gamma=False):
    """Flattened batched PANOC, fixed (default) or adaptive step (one
    oracle evaluation per trip; see the module docstring and
    :func:`_flat_panoc_adaptive_run`).

    ``f``, ``g``: stacked function objects; ``A``: a stacked operator;
    ``x0``: (B, n); ``gamma``: scalar or (B,) steps (for adaptive, the
    search's start; ``estimate_gamma=True`` derives it per lane as the
    driver's cold start does).  Returns ``(z, iters, done)`` with per-lane
    counts of accepted iterations equal to the single ``PANOC(...)``
    driver's.
    """
    from ..accel.lbfgs import LBFGS

    if directions is None:
        directions = LBFGS(5)
    x0 = torch.as_tensor(x0)
    R, B = real_dtype_of(x0), x0.shape[0]
    gamma = _rvec(gamma, R, B, x0.device)
    _check_blocking(check_every, trip_cap)
    require_full_f32_matmul()
    if adaptive:
        return _flat_panoc_adaptive_run(
            f, A, g, x0, gamma, tol, maxit, float(alpha), float(beta),
            int(max_backtracks), directions,
            torch.as_tensor(minimum_gamma, dtype=R, device=x0.device),
            estimate_gamma=bool(estimate_gamma), trip_cap=trip_cap,
            check_every=int(check_every))
    return _flat_panoc_run(
        f, A, g, x0, gamma, tol, maxit, float(alpha), float(beta),
        int(max_backtracks), directions, trip_cap=trip_cap,
        check_every=int(check_every))
