"""Seconds from the process's start to the first timed call: imports, the
library's build or load, the problems made on the device, one warm-up
batch."""


def read(run):
    return run.setup_s
