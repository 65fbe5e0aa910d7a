"""The read-floor probe: the per-lane sum of a stacked operator (counterpart
of ``_dma_reduce_kernel`` in ``benchmarks/trip_overhead_bench.py``).

``read_reduce(A)`` returns ``out[l] = sum(A[l])`` for A (B, M, N): the
cheapest function that still reads every byte of A once, so its time at a
step kernel's shape is the measured floor that kernel is judged against,
beside the bound computed from the card's datasheet rate.  The CUDA kernel
``read_reduce`` lives in ``proxtpu_torch/csrc/probe.cu``; the plain version
is ``A.sum(dim=(1, 2))``.  The wrapper runs the plain version for a tensor on
the CPU; for a CUDA tensor it launches the kernel or raises.  It counts its
launches in its ``launches`` attribute.

The kernel's sum does not change from run to run (no atomics; fixed order in
a block, then a lane's partial sums added in order), but its order is not
the plain version's: the two agree to a few ulps of the lane's sum of
absolute values.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# threads of one block of the kernel (probe.cu: kThreads) and resident
# blocks of that size per SM
_THREADS = 256
_BLOCKS_PER_SM = 8
# least entries of one block's chunk: 16 per thread
_MIN_CHUNK = 16 * _THREADS


def reference_read_reduce(A):
    """Plain version: the sum of each lane of A (B, M, N)."""
    return A.sum(dim=(1, 2))


def chunk_plan(B, n, sms):
    """``(S, chunk)``: a lane of n entries is cut into S chunks of ``chunk``
    entries (a multiple of 4, so that every chunk of an aligned lane starts
    on 16 bytes), one block each, so that B * S blocks fill ``sms`` SMs
    without cutting a lane finer than ``_MIN_CHUNK``."""
    want = -(-sms * _BLOCKS_PER_SM // B)
    S = max(1, min(want, n // _MIN_CHUNK))
    chunk = -(-n // S)
    chunk += -chunk % 4
    return -(-n // chunk), chunk


def read_reduce(A):
    """Per-lane sum of A (B, M, N) float32 through the ``read_reduce``
    kernel (see :func:`reference_read_reduce`).  Returns ``out`` (B,)."""
    if A.dim() != 3:
        raise ValueError(f"A must be (B, M, N), got shape {tuple(A.shape)}")
    if A.device.type == "cpu":
        return reference_read_reduce(A)
    if not A.is_cuda:
        raise ValueError(f"A is on {A.device}; the kernel needs a CUDA device")
    if A.dtype != torch.float32:
        raise TypeError(f"A is {A.dtype}; the kernel takes float32")
    if not A.is_contiguous():
        raise ValueError("A must be contiguous")
    B, n = A.shape[0], A.shape[1] * A.shape[2]
    if B == 0 or n == 0:
        raise ValueError(f"A must not be empty, got shape {tuple(A.shape)}")
    sms = torch.cuda.get_device_properties(A.device).multi_processor_count
    S, chunk = chunk_plan(B, n, sms)
    partial = torch.empty((B, S), dtype=A.dtype, device=A.device)
    out = torch.empty(B, dtype=A.dtype, device=A.device)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.library().proxtpu_read_reduce(
            A.data_ptr(), partial.data_ptr(), out.data_ptr(), B, n, S, chunk,
            ctypes.c_void_p(stream))
    _build.check(err, "read_reduce")
    read_reduce.launches += 1
    return out


read_reduce.launches = 0
