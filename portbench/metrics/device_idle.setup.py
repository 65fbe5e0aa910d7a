"""The device's idle share, in %, of the traced window's seconds in which
the program's clock and the profiler's agree, while the host is inside the
program's ``stream.dispatch`` but outside every ``loop.issue`` span and
every refill after a sync: matching, packing, the first steps, the phase
switch, collections (``portbench/spans.py::split``).  The idle under the
entry less this and ``device_idle.refill`` is the idle while the host
issues the loop's steps.  Nothing without the program's spans, a device
record or an agreed second."""

from portbench import spans


def read(run):
    parts = spans.split(run)
    if parts is None:
        return None
    return 100.0 * parts["setup"] / parts["window_s"]
