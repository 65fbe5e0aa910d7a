"""The device's idle share of the traced window, in %: one minus the union
of every kernel, copy and fill record over the window's length; nothing
where the trace holds no device record (a run without a card)."""


def read(run):
    if run.trace is None or not run.trace["busy_s"]:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
