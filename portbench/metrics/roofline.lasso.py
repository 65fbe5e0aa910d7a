"""The lasso iterations' share of their roofline, in %.

The work is what the answers needed: over every lane of every call of the
traced window, the iterations the program returned times one iteration's
bytes and operations (``iteration_bytes``, ``iteration_flops`` of the
configuration's problem module).  Its least time is the larger of the
bytes over the card's memory bandwidth and the operations over its float32
rate (``portbench/peaks.json``); the share is that time over the summed
device time of every kernel in the traced window, whatever launched it.
Nothing without a trace, a peak for the card or a lasso problem."""


def read(run):
    p = run.problems
    if (run.trace is None or run.peaks is None or not run.trace["kernel_s"]
            or not hasattr(p, "iteration_bytes")):
        return None
    problem = run.cell.config["problem"]
    iters = sum(int(c.iters.sum()) for c in run.calls)
    least = max(iters * p.iteration_bytes(problem)
                / run.peaks["hbm_bytes_per_s"],
                iters * p.iteration_flops(problem)
                / run.peaks["fp32_flops_per_s"])
    return 100.0 * least / run.trace["kernel_s"]
