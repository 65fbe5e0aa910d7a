"""The 90th percentile of the seconds from a call's dispatch into
``stream_solve`` to its fenced result, over every call of the window."""

import statistics


def read(run):
    times = [c.t_done - c.t_dispatch for c in run.calls]
    if len(times) < 2:
        return None
    return statistics.quantiles(times, n=10)[-1]
