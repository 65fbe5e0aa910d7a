"""Host loop control shared by the port's batched solvers and the generic
batched driver."""

from __future__ import annotations

from .tracing import span

# iterations between the host's all-done checks (see run_host_loop)
CHECK_EVERY = 16


def run_host_loop(body, state, done_of, maxit, k_step=1,
                  check_every=CHECK_EVERY, k=1):
    """Advance ``state = body(k, state)`` from iteration ``k`` (1 unless
    given), ``k`` moving by ``k_step`` per call, until every lane is done or
    ``k >= maxit``.  Returns ``(state, k)``.

    The JAX solvers test ``k < maxit and not all(done)`` on the device
    before every trip of their ``while_loop``.  Here the host tests
    ``all(done_of(state))`` once every ``check_every`` iterations (at
    least once per call of ``body``) and ``k < maxit`` before every call,
    so the loop stops at exactly the same ``k`` when lanes remain; the
    state stays on the device.  The results are those of testing before
    every call: once a lane is done its iterate, carries and count never
    change (frozen lanes are selected out, and counts move only for live
    lanes), so calls made after every lane is done change nothing.  Only
    the returned ``k`` may then run past the reference's.

    Traced (:mod:`.tracing`): ``sync.loop_check`` around each all-done
    test and ``loop.issue`` around the calls between two tests."""
    per_check = max(1, check_every // k_step)
    while k < maxit:
        with span("sync.loop_check"):
            if bool(done_of(state).all()):
                break
        # the calls before the next test: per_check, or fewer to maxit
        n = min(per_check, -(-(maxit - k) // k_step))
        with span("loop.issue", n):
            for _ in range(n):
                k += k_step
                state = body(k, state)
    return state, k
