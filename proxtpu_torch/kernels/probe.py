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

The kernel's sum does not change from run to run (no atomics on the sum;
fixed order in a block, then a lane's partial sums added in order by the
lane's last block), but its order is not the plain version's: the two agree
to a few ulps of the lane's sum of absolute values.

The probe times reads of a few microseconds, so the wrapper's own work per
call is kept below that: the chunk plan is cached per shape, the kernel's
scratch (partial sums, and the lanes' ticket counters, which the kernel
leaves zero) is allocated once per device, stream and plan, the C entry is
looked up once, and a timing loop may pass ``out=`` and ``scratch=`` back in
so that a call allocates nothing.
"""

from __future__ import annotations

import functools

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


# the plan of a shape, computed once
cached_chunk_plan = functools.lru_cache(maxsize=None)(chunk_plan)


def read_reduce_scratch(A):
    """The kernel's scratch for ``read_reduce(A, scratch=...)`` at A's shape
    and device: B ticket counters (zero, and left zero by every call), then
    B * S partial sums, as one float32 tensor.  Calls that may run at the
    same time (two streams, two CUDA graphs) need a scratch each."""
    B, n = A.shape[0], A.shape[1] * A.shape[2]
    S, _ = cached_chunk_plan(B, n, _build.sm_count(A.device.index))
    return torch.zeros(B * (S + 1), dtype=torch.float32, device=A.device)


@functools.lru_cache(maxsize=None)
def _stream_scratch(device_index, stream, B, S):
    """The scratch of the calls on one stream of one device at one plan.
    Calls on a stream run one after another, so they can share it; calls on
    two streams never do."""
    return torch.zeros(B * (S + 1), dtype=torch.float32,
                       device=torch.device("cuda", device_index))


_entry = None


def _launch(A, out, scratch, B, n, S, chunk):
    global _entry
    if _entry is None:
        _entry = _build.library().proxtpu_read_reduce
    device_index = A.get_device()
    # the stream's handle as an int, without a Stream object around it
    stream = torch._C._cuda_getCurrentRawStream(device_index)
    if scratch is None:
        # a captured call may be replayed beside any other, so it gets a
        # scratch of its own (zeroed inside the graph)
        if torch.cuda.is_current_stream_capturing():
            scratch = read_reduce_scratch(A)
        else:
            scratch = _stream_scratch(device_index, stream, B, S)
    base = scratch.data_ptr()
    err = _entry(A.data_ptr(), base + 4 * B, base, out.data_ptr(), B, n, S,
                 chunk, stream)
    if err:
        _build.check(err, "read_reduce")
    read_reduce.launches += 1
    return out


def read_reduce(A, out=None, scratch=None):
    """Per-lane sum of A (B, M, N) float32 through the ``read_reduce``
    kernel (see :func:`reference_read_reduce`), one launch.  Returns ``out``
    (B,), written in place where given.  ``scratch``, where given, is a
    tensor from :func:`read_reduce_scratch` for this shape."""
    if A.dim() != 3:
        raise ValueError(f"A must be (B, M, N), got shape {tuple(A.shape)}")
    if not A.is_cuda:
        if A.device.type != "cpu":
            raise ValueError(f"A is on {A.device}; the kernel needs a CUDA "
                             f"device")
        want = reference_read_reduce(A)
        return want if out is None else out.copy_(want)
    if A.dtype != torch.float32:
        raise TypeError(f"A is {A.dtype}; the kernel takes float32")
    if not A.is_contiguous():
        raise ValueError("A must be contiguous")
    B, M, N = A.shape
    n = M * N
    if B == 0 or n == 0:
        raise ValueError(f"A must not be empty, got shape {tuple(A.shape)}")
    device_index = A.get_device()
    S, chunk = cached_chunk_plan(B, n, _build.sm_count(device_index))
    if out is None:
        out = A.new_empty(B)
    elif (out.shape != (B,) or out.dtype != A.dtype or out.device != A.device
          or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous ({B},) {A.dtype} tensor "
                         f"on {A.device}")
    if scratch is not None and (
            scratch.numel() != B * (S + 1) or scratch.dtype != torch.float32
            or scratch.device != A.device or not scratch.is_contiguous()):
        raise ValueError(f"scratch must come from read_reduce_scratch(A): "
                         f"{B * (S + 1)} float32 on {A.device}")
    if device_index == torch.cuda.current_device():
        return _launch(A, out, scratch, B, n, S, chunk)
    with torch.cuda.device(device_index):
        return _launch(A, out, scratch, B, n, S, chunk)


read_reduce.launches = 0
