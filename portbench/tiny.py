"""The benchmark's cells at sizes a CPU test run holds: the real entries,
configurations and mixes with fewer and smaller problems (the 512 x 1024
cell keeps lanes of 1 MB, so that the dispatch still takes the blocked
leg)."""

from __future__ import annotations

import copy

from . import harness

SIZES = {
    "lasso_200x400.b4096": dict(problem=dict(M=20, N=40),
                                solver=dict(k1=24, tail=4),
                                traffic=dict(lanes=16, pool_batches=2)),
    "lasso_512x1024.b64": dict(problem=dict(M=256, N=1024),
                               solver={}, reference_batches=2,
                               traffic=dict(lanes=4, pool_batches=2)),
}


def cell(workload):
    c = harness.cell(harness.load_manifest(), workload)
    size = SIZES[workload]
    c.config = copy.deepcopy(c.config)
    c.config["problem"].update(size["problem"])
    c.config["solver"].update(size["solver"])
    if "reference_batches" in size:
        c.config["reference_batches"] = size["reference_batches"]
    c.traffic = dict(c.traffic, **size["traffic"])
    return c
