"""Microseconds of the host's own time to issue one call of the host
loop's ``body``: the summed self time of the traced window's
``loop.issue`` spans (each less its nested ``sync.*`` and ``host.gc``
spans) over their summed ``n``; nothing where the program records no
such span there."""

from portbench import spans


def read(run):
    window = spans.window_spans(run)
    if window is None:
        return None
    steps = sum(r.n for r in window if r.name == "loop.issue")
    if not steps:
        return None
    own = spans.self_ns(window, "loop.issue",
                        lambda r: spans.is_sync(r) or r.name == "host.gc")
    return sum(own.values()) * 1e-3 / steps
