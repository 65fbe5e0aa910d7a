"""Certified problems a second: lanes that are done and whose certificate
is within the configuration's gate, over every call of the window, divided
by the time from the window's start to the end of its last call."""


def read(run):
    return sum(c.certified for c in run.calls) / (run.end - run.start)
