"""Microseconds of the window a kernel launch: the window's seconds over
the launches counted by the program's wrappers (their ``launches``
counters); nothing where no wrapper launched."""


def read(run):
    n = sum(run.launches.values())
    return (run.end - run.start) * 1e6 / n if n else None
