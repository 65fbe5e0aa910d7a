"""Lasso problems made on the device from the seed.

The distribution of ``proxtpu_torch/tools/problems.py::lasso_data``: A with
standard normal entries over sqrt(M), b standard normal, ``lam = ratio
||A^T b||_inf`` (ratio 0.1 there) and ``Lf = ||A||_2^2``.  Here every
number comes from one ``torch.Generator`` on the device, a whole batch a
call, in float32; ``lam`` is worked out in float64 and ``Lf`` from above in
float64 (:func:`portbench.reference.lipschitz_upper`), then rounded up to
float32, so that ``1 / Lf`` is a safe step.

What the harness asks of a problem module (``portbench/problems/<kind>.py``,
named by a configuration's ``problem.kind``): :func:`make_batches` makes the
batches; :func:`counts` reads the per-lane iteration counts and ``done``
flags out of a solver's answer; :func:`certificate` judges every lane of an
answer against its batch by the plain reference; :func:`iteration_bytes`
and :func:`iteration_flops`, where a roofline reads them.
"""

from __future__ import annotations

import math

import torch

from .. import reference


def make_batches(problem, lanes, count, seed, device):
    """``count`` batches of ``lanes`` problems: a list of ``(A, b, lam,
    Lf)``, float32 on ``device``, the same for the same seed."""
    M, N = problem["M"], problem["N"]
    if problem.get("dtype", "float32") != "float32":
        raise ValueError("the lasso problems are made in float32")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    out = []
    for _ in range(count):
        A = torch.randn((lanes, M, N), generator=gen, device=device)
        A.mul_(1.0 / math.sqrt(M))
        b = torch.randn((lanes, M), generator=gen, device=device)
        out.append((A, b))
    batches = []
    for A, b in out:
        lam = torch.cat([
            torch.amax(torch.abs(torch.bmm(
                b[sl].double().unsqueeze(1), A[sl].double()).squeeze(1)),
                dim=1)
            for sl in reference.chunks(A)]) * problem["lam_ratio"]
        Lf = reference.lipschitz_upper(A)
        batches.append((A, b, lam.float(), reference.f32_at_least(Lf)))
    return batches


def counts(out):
    """``(iters, done)`` of an answer ``(xs, iters, done)``."""
    _, iters, done = out
    return iters, done.bool()


def certificate(batch, out):
    """Every lane's certificate (:func:`portbench.reference.recheck`,
    float64) of the answer ``out`` to ``batch``; an answer that is not a
    number reads as far off as can be.  Returns (B,) float64."""
    A, b, lam, Lf = batch
    return torch.nan_to_num(reference.recheck(A, b, lam, Lf, out[0]),
                            nan=math.inf)


def iteration_bytes(problem):
    """Bytes one FISTA iteration of one lane needs, in float32: A once, b,
    x and z_prev read, x and z written."""
    M, N = problem["M"], problem["N"]
    return 4 * (M * N + M + 4 * N)


def iteration_flops(problem):
    """Floating-point operations of one iteration of one lane: the two
    matrix-vector products, 2 M N each."""
    return 4 * problem["M"] * problem["N"]
