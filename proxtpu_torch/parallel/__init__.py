"""Parallel execution of the port (counterpart of ``proxtpu.parallel``):
the batched driver, ``BatchedAlgorithm`` and pipelined dispatch."""

from .batch import BatchedAlgorithm, batched_run_loop
from .stream import stream_solve

__all__ = ["BatchedAlgorithm", "batched_run_loop", "stream_solve"]
