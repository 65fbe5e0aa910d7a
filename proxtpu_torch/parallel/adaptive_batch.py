"""Batched adaptive (backtracking) forward-backward and FISTA with the
step search flattened into the outer loop (counterpart of
``proxtpu/parallel/adaptive_batch.py``).

Under ``torch.func.vmap`` the gamma search of an adaptive solver runs as
``backtrack_limit`` masked trials per iteration.  Here every trip makes
exactly one oracle evaluation per lane (one ``value_and_gradient`` and one
``prox``), and each lane either COMMITS an accepted step (advancing its
iterate and its count) or HALVES its step and tries again: the fixed-step
driver's work per accepted iteration plus one evaluation per halving, the
reference's own profile (``fb_tools.jl:24-63``).

Per lane the semantics are the single driver's:

* the accept test ``f(z) <= f_model + 10 eps (1 + |f(z)|)`` with the model
  at the *test* gamma, while the candidates may have been computed at the
  gamma before the increase (the reference's regret rule,
  ``forward_backward.jl:86-123``);
* ``gamma < minimum_gamma`` ends the search (accepted unconditionally);
* the count is the number of *accepted* steps (the driver's ``k``), and
  ``maxit`` bounds them.

The host drives the trips as in :mod:`proxtpu_torch.parallel.flat_ls`
(one test a block of ``check_every`` trips; every update is masked on the
lane being active, so the block size changes nothing).  The trips are
bounded by ``maxit + log(gamma0 / minimum_gamma) / log(1 / reduce_gamma)
+ maxit log(increase_gamma) / log(1 / reduce_gamma)``, a defensive cap.

A ``Shared`` least squares in row stripes over a tp mesh axis
(``lane_parallel(stripes=True)``: ``RowShardedLeastSquaresLoss``) sums
its value and gradient over tp in one all-reduce a trip.
"""

from __future__ import annotations

import math

import torch

from ..prox.base import prox, value_and_gradient
from ..utils.precision import require_full_f32_matmul
from ..utils.tree import eps_of, real_dtype_of
from .flat_ls import _host_while, _lane_map, _live, _rvec
from .sharded_ops import lane_parallel


def _flat_adaptive_run(f, g, x0, gamma0, tol, maxit, accel=False,
                       minimum_gamma=1e-7, reduce_gamma=0.5,
                       increase_gamma=1.0, trip_cap=None, mf=0.0,
                       check_every=1):
    """The flattened machine of FB (``accel=False``) and FISTA
    (``accel=True``: the step-fed ``AdaptiveNesterovSequence(mf)``, the
    driver's default).

    f, g: stacked function objects.  x0: (B, n).  gamma0: (B,).  Returns
    (z, iters, done) like
    :func:`proxtpu_torch.parallel.batch.batched_run_loop`.
    """
    B = x0.shape[0]
    dev = x0.device
    R = gamma0.dtype
    eps = eps_of(x0)

    # Shared-marked f / g map unmapped (lane-invariant data: a shared
    # design matrix makes the batched gradient one matrix product)
    vvg = _lane_map(f, value_and_gradient, 1)
    vprox = _lane_map(g, prox, 2)

    def candidates(x, grad, gamma):
        y = x - gamma[:, None] * grad
        z, g_z = vprox(y, gamma)
        res = x - z
        f_z, grad_z = vvg(z)
        return y, z, g_z, res, f_z, grad_z

    # --- init: ForwardBackwardIteration.init (candidates at gamma0)
    f_x0, grad_x0 = vvg(x0)
    y, z, g_z, res, f_z, grad_z = candidates(x0, grad_x0, gamma0)

    # state: the base point (x, f_x, grad_x), the candidates' quantities,
    # cand_gamma (the gamma they were computed at), test_gamma (the gamma
    # the accept test runs at), FISTA's extras (z_prev and the step-fed
    # AdaptiveNesterovSequence state), the counts
    s = dict(
        x=x0, f_x=f_x0, grad_x=grad_x0,
        y=y, z=z, g_z=g_z, res=res, f_z=f_z, grad_z=grad_z,
        cand_gamma=gamma0, test_gamma=gamma0 * increase_gamma,
        z_prev=x0,
        seq_step=-torch.ones(B, dtype=R, device=dev),
        seq_theta=-torch.ones(B, dtype=R, device=dev),
        k=torch.ones(B, dtype=torch.int32, device=dev),  # init counts as 1
        done=torch.amax(torch.abs(res), dim=1) / gamma0 <= tol,
    )

    if not 0.0 < reduce_gamma < 1.0:
        raise ValueError(f"reduce_gamma must be in (0, 1), got {reduce_gamma}")
    if trip_cap is None:
        # accepted steps + the descent from the largest gamma0 down to
        # minimum_gamma + each accepted step's increase, descended again
        # before the next acceptance; in units of log(1 / reduce_gamma)
        log_red = math.log(1.0 / reduce_gamma)
        gmax = float(gamma0.max())
        n_desc = int(math.ceil(
            max(0.0, math.log(gmax / minimum_gamma)) / log_red)) + 1
        n_incr = int(math.ceil(
            maxit * max(0.0, math.log(increase_gamma)) / log_red))
        cap = maxit + n_desc + n_incr
    else:
        cap = trip_cap

    def body(s):
        # the accept test at test_gamma with the current candidates (which
        # may have been computed at cand_gamma != test_gamma after an
        # increase)
        fpr_sq = torch.sum(torch.abs(s["res"]) ** 2, dim=1)
        if s["grad_x"].is_complex():
            dots = torch.sum((s["grad_x"].conj() * s["res"]).real, dim=1)
        else:
            dots = torch.sum(s["grad_x"] * s["res"], dim=1)
        upp = s["f_x"] - dots + fpr_sq / (2 * s["test_gamma"])
        slack = 10 * eps * (1 + torch.abs(s["f_z"]))
        accept = (s["f_z"] <= upp + slack) | (s["test_gamma"] < minimum_gamma)
        active = _live(s, maxit)
        commit = accept & active
        ccol = commit[:, None]

        # --- committed lanes: advance the base point
        gamma_acc = s["test_gamma"]
        if accel:
            # AdaptiveNesterovSequence(mf).next_coeff fed the accepted
            # gamma, as the driver (``fast_forward_backward.jl:99-104``);
            # mf > 0 gives the strongly convex theta_init = sqrt(mf gamma)
            # (``accel/nesterov.jl:56-103``)
            first = s["seq_step"] < 0
            theta_init = (torch.sqrt(mf * gamma_acc) if mf > 0
                          else torch.ones(B, dtype=R, device=dev))
            theta = torch.where(first, theta_init, s["seq_theta"])
            step_prev = torch.where(first, gamma_acc, s["seq_step"])
            bq = theta ** 2 / step_prev - mf
            delta = bq ** 2 + 4 * theta ** 2 / (step_prev * gamma_acc)
            theta_new = gamma_acc * (-bq + torch.sqrt(delta)) / 2
            beta = (gamma_acc * theta * (1 - theta)
                    / (step_prev * theta_new + gamma_acc * theta ** 2))
            x_acc = s["z"] + beta[:, None] * (s["z"] - s["z_prev"])
            z_prev_new = torch.where(ccol, s["z"], s["z_prev"])
            seq_step_n = torch.where(commit, gamma_acc, s["seq_step"])
            seq_theta_n = torch.where(commit, theta_new, s["seq_theta"])
            f_acc, grad_acc = vvg(x_acc)
        else:
            x_acc = s["z"]
            f_acc, grad_acc = s["f_z"], s["grad_z"]
            z_prev_new = s["z_prev"]
            seq_step_n = s["seq_step"]
            seq_theta_n = s["seq_theta"]

        x_n = torch.where(ccol, x_acc, s["x"])
        f_n = torch.where(commit, f_acc, s["f_x"])
        grad_n = torch.where(ccol, grad_acc, s["grad_x"])

        # the new candidates' gamma: accepted lanes evaluate at gamma_acc
        # and are *tested* next trip at gamma_acc * increase; halving lanes
        # evaluate AND test at test_gamma * reduce
        cand_gamma_n = torch.where(commit, gamma_acc,
                                   s["test_gamma"] * reduce_gamma)
        test_gamma_n = torch.where(commit, gamma_acc * increase_gamma,
                                   s["test_gamma"] * reduce_gamma)

        yn, zn, g_zn, resn, f_zn, grad_zn = candidates(
            x_n, grad_n, cand_gamma_n)
        upd = active[:, None]
        res_n = torch.where(upd, resn, s["res"])

        k_n = s["k"] + commit.to(torch.int32)
        # stopping is tested on the driver's post-step state: the fresh
        # candidates at the accepted gamma (meaningful on commit trips only)
        resnorm = torch.amax(torch.abs(res_n), dim=1)
        newly_done = commit & (resnorm / cand_gamma_n <= tol)

        return dict(
            x=x_n, f_x=f_n, grad_x=grad_n,
            y=torch.where(upd, yn, s["y"]),
            z=torch.where(upd, zn, s["z"]),
            g_z=torch.where(active, g_zn, s["g_z"]),
            res=res_n,
            f_z=torch.where(active, f_zn, s["f_z"]),
            grad_z=torch.where(upd, grad_zn, s["grad_z"]),
            cand_gamma=torch.where(active, cand_gamma_n, s["cand_gamma"]),
            test_gamma=torch.where(active, test_gamma_n, s["test_gamma"]),
            z_prev=z_prev_new, seq_step=seq_step_n, seq_theta=seq_theta_n,
            k=k_n,
            done=s["done"] | newly_done,
        )

    # the body freezes inactive lanes entirely, so the host's blocks of
    # trips change nothing (see flat_ls._host_while)
    s = _host_while(lambda s: _live(s, maxit), body, s, check_every, cap)
    return s["z"], s["k"], s["done"]


@lane_parallel(stripes=True)
def batched_adaptive_fb(f, g, x0, tol, maxit=10_000, gamma0=None,
                        minimum_gamma=1e-7, reduce_gamma=0.5,
                        increase_gamma=1.0, check_every=1):
    """Flattened batched adaptive ForwardBackward.

    ``f``, ``g``: stacked smooth / prox function objects; ``x0``: (B, n);
    ``gamma0``: (B,) starting steps (default: the per-lane finite-difference
    Lipschitz lower bound, the driver's cold start).  Returns ``(z, iters,
    done)`` with per-lane counts of accepted iterations equal to the single
    ``ForwardBackward(adaptive=True)`` driver's.
    """
    require_full_f32_matmul()
    if gamma0 is None:
        gamma0 = _coldstart_gamma(f, x0)
    return _flat_adaptive_run(
        f, g, x0, _rvec(gamma0, real_dtype_of(x0), x0.shape[0], x0.device), tol, maxit, accel=False,
        minimum_gamma=float(minimum_gamma), reduce_gamma=float(reduce_gamma),
        increase_gamma=float(increase_gamma), check_every=int(check_every))


@lane_parallel(stripes=True)
def batched_adaptive_fista(f, g, x0, tol, maxit=10_000, gamma0=None,
                           minimum_gamma=1e-7, reduce_gamma=0.5,
                           increase_gamma=1.0, mf=0.0, check_every=1):
    """Flattened batched adaptive FastForwardBackward (the step-fed
    ``AdaptiveNesterovSequence(mf)`` extrapolation, the driver's default;
    ``mf > 0`` gives the strongly convex sequence).  The contract of
    :func:`batched_adaptive_fb`."""
    require_full_f32_matmul()
    if gamma0 is None:
        gamma0 = _coldstart_gamma(f, x0)
    return _flat_adaptive_run(
        f, g, x0, _rvec(gamma0, real_dtype_of(x0), x0.shape[0], x0.device), tol, maxit, accel=True,
        minimum_gamma=float(minimum_gamma), reduce_gamma=float(reduce_gamma),
        increase_gamma=float(increase_gamma), mf=float(mf),
        check_every=int(check_every))


def _coldstart_gamma(f, x0):
    """Per-lane 1 / lower_bound_smoothness_constant (``fb_tools.jl:7-19``)."""
    from ..ops.linops import IdentityOperator
    from ..utils.fb_tools import lower_bound_smoothness_constant

    def one(fi, x):
        _, grad = value_and_gradient(fi, x)
        return 1.0 / lower_bound_smoothness_constant(
            fi, IdentityOperator(), x, grad)

    return _lane_map(f, one, 1)(x0)
