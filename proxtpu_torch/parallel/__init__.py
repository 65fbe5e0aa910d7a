"""Parallel execution of the port (counterpart of ``proxtpu.parallel``)."""

from .stream import stream_solve

__all__ = ["stream_solve"]
