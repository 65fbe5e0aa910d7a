"""The closed-loop pool: the general generator of the ``pool`` mixes.

A mix file (``portbench/traffic/<name>.json``) gives ``lanes`` (problems a
batch), ``pool_batches`` (distinct batches made during set-up and kept on
the device) and ``depth`` (batches the caller keeps dispatched ahead in
``stream_solve``).  One caller sends the pool's batches in the order 0, 1,
..., P - 1, 0, 1, ..., so no batch is solved twice in a row and every seed
gets the same sizes in the same order; only the numbers differ.
"""

from __future__ import annotations


class Pool:
    def __init__(self, batches, depth):
        self.batches = batches
        self.depth = depth

    def index(self, i):
        """The pool batch that the ``i``-th call of the window sends."""
        return i % len(self.batches)


def make(problems, config, traffic, seed, device):
    if traffic["pool_batches"] < 2:
        raise ValueError("a pool needs two batches or more: no batch is "
                         "solved twice in a row")
    batches = problems.make_batches(config["problem"], traffic["lanes"],
                                    traffic["pool_batches"], seed, device)
    return Pool(batches, traffic["depth"])
