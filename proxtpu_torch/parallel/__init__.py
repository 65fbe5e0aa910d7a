"""Parallel execution of the port (counterpart of ``proxtpu.parallel``):
the batched drivers (plain, recorded, segmented, compacting),
``BatchedAlgorithm``, the flat trial/commit machines
of the line-search and adaptive solvers, the float32 -> float64 warm start
and pipelined dispatch."""

from ..utils.shared import Shared, batch_axes, unwrap_shared
from .adaptive_batch import batched_adaptive_fb, batched_adaptive_fista
from .batch import (
    BatchedAlgorithm,
    batch_problems,
    batched_run_loop,
    batched_run_recorded,
    batched_run_segments,
    broadcast_hyperparams,
    compacting_batched_run,
    stack_iterations,
)
from .flat_ls import (
    batched_drls,
    batched_panoc,
    batched_panocplus,
    batched_zerofpr,
)
from .stream import stream_solve
from .warm import (
    WarmStartedAlgorithm,
    WarmStartedBatchedAlgorithm,
    cast_problem,
)

__all__ = [
    "BatchedAlgorithm", "WarmStartedAlgorithm", "WarmStartedBatchedAlgorithm",
    "cast_problem", "Shared", "batch_axes", "unwrap_shared",
    "batched_adaptive_fb", "batched_adaptive_fista", "batched_drls",
    "batched_panoc", "batched_panocplus", "batched_zerofpr",
    "batch_problems", "batched_run_loop", "batched_run_recorded",
    "batched_run_segments", "broadcast_hyperparams", "compacting_batched_run",
    "stack_iterations", "stream_solve",
]
