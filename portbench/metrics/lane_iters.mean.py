"""The mean of the iteration counts that the program returned, over every
lane of every call of the window."""


def read(run):
    lanes = sum(len(c.iters) for c in run.calls)
    return sum(int(c.iters.sum()) for c in run.calls) / lanes
