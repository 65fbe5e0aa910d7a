"""Host syncs a call: the program's ``sync.*`` spans (one a blocking read
of the device) that start in the traced window, over the window's calls;
nothing where the program records no span there."""

from portbench import spans


def read(run):
    window = spans.window_spans(run)
    if window is None or not run.calls:
        return None
    return sum(spans.is_sync(r) for r in window) / len(run.calls)
