"""The device's idle share, in %, of the traced window's seconds in which
the program's clock and the profiler's agree: from the end of each of the
program's ``sync.*`` spans to the device's next record while the host is
still inside ``stream.dispatch``, the queue refilling after a blocking
read (``portbench/spans.py::split``); nothing without the program's spans,
a device record or an agreed second."""

from portbench import spans


def read(run):
    parts = spans.split(run)
    if parts is None:
        return None
    return 100.0 * parts["refill"] / parts["window_s"]
