"""Build and load the port's CUDA kernels (``proxtpu_torch/csrc``).

The sources are compiled with ``nvcc`` for ``sm_90a``, one process per
source, all started together, and linked into one shared library with a
plain C interface, loaded through :mod:`ctypes`.  The build happens at
first use, never at import, into ``build/proxtpu_torch/<hash>/`` beside the
package, keyed by a hash of the sources, the headers and the flags, so a
changed file builds anew and an unchanged build is loaded as it is.  A
failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SOURCES = ("lasso_step.cu", "fista_step_bf16.cu", "fb_step_bf16.cu",
            "fista_packed_step.cu", "box_qp_step.cu", "tv_step.cu",
            "probe.cu")
_HEADERS = ("common.cuh", "lasso_step.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    # A, b, x, z_prev, beta, gamma, thr, done, shrink, res, rs, B, M, N,
    # restart, threads, R (rows per tile), S (stages), shared bytes, stream;
    # the _bf16 entry (A in bfloat16) takes the plan's cols (columns a
    # thread in pass 2) and xregs (x in registers) before the stream
    "proxtpu_fista_step": [_P] * 11 + [_I] * 8 + [_P],
    "proxtpu_fista_step_bf16": [_P] * 11 + [_I] * 10 + [_P],
    # Ap, bp, x, z_prev, beta, gamma, thr, done, res, rs (packed layout),
    # B, M, N, pack, restart, threads, R, S, shared bytes, stream
    "proxtpu_fista_packed_step": [_P] * 10 + [_I] * 9 + [_P],
    # A, b, x, gamma, thr, shrink, z, res, B, M, N, threads, R, S, shared
    # bytes, stream; the _bf16 entry as above
    "proxtpu_fb_step": [_P] * 8 + [_I] * 7 + [_P],
    "proxtpu_fb_step_bf16": [_P] * 8 + [_I] * 9 + [_P],
    # fista (else fb), bytes of an entry of A, M, N, threads, R, S, shared
    # bytes, cols, xregs (1 and 0 for float32), out
    "proxtpu_step_blocks_per_sm": [_I] * 10 + [ctypes.POINTER(_I)],
    # A, b, x, z_prev, t, gamma, thr, done, res, B, M, N, K, restart,
    # C (blocks per lane), R (rows per tile), S (stages), shared bytes,
    # stream
    "proxtpu_fista_k_steps": [_P] * 9 + [_I] * 9 + [_P],
    # Q, q, x, gamma, lo, hi, done, res, B, n, K, C (blocks per lane),
    # R (rows per tile), S (stages), shared bytes, stream
    "proxtpu_pg_k_steps": [_P] * 8 + [_I] * 7 + [_P],
    # b, x, yx, yy, g1, g2, lam, done, xo, yxo, yyo, res, B, H, W, K,
    # C (blocks per image), threads, shared bytes, stream
    "proxtpu_cp_k_steps": [_P] * 12 + [_I] * 7 + [_P],
    # H, W, C, threads, shared bytes, out
    "proxtpu_cp_active_clusters": [_I] * 5 + [ctypes.POINTER(_I)],
    # b, x, yx, yy, g1, g2, lam, done, xo, yxo, yyo, res, scratch, B, H, W,
    # K, TH, TW, stream
    "proxtpu_cp_k_steps_halo": [_P] * 13 + [_I] * 6 + [_P],
    # A, partial, counter, out, B, n, S, chunk, stream; A float32, or
    # bfloat16 for the _bf16 entry
    "proxtpu_read_reduce": [_P] * 4 + [_I, _L, _I, _L, _P],
    "proxtpu_read_reduce_bf16": [_P] * 4 + [_I, _L, _I, _L, _P],
    "proxtpu_max_smem_optin": [_I, ctypes.POINTER(_I)],
}


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): the "
                           "port's kernels are built with nvcc")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build_dir():
    """``build/proxtpu_torch/<hash of the sources and flags>/``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _SOURCES + _HEADERS:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    root = _CSRC.parent.parent / "build" / "proxtpu_torch"
    return root / h.hexdigest()[:16]


def _run_all(cmds):
    """Run the commands in parallel; raise with the output of the first
    that fails.  Returns their joined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for cmd, p, log in zip(cmds, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{log}")
    return "".join(logs)


def _compile(out):
    """Compile each source to an object in parallel, then link them into
    ``out``; returns nvcc's output (it carries ``-Xptxas -v``'s registers
    and shared memory per kernel)."""
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmpdir:
        objs = [os.path.join(tmpdir, name + ".o") for name in _SOURCES]
        log = _run_all([[_nvcc(), *NVCC_FLAGS, "-c", "-o", obj,
                         str(_CSRC / name)]
                        for name, obj in zip(_SOURCES, objs)])
        # link under a temporary name, then rename: a concurrent loader
        # never sees a half-written library
        tmp = os.path.join(tmpdir, "lib.so")
        log += _run_all([[_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", tmp,
                          *objs]])
        os.replace(tmp, out)
    (out.parent / "nvcc.log").write_text(log)
    return log


@functools.lru_cache(maxsize=None)
def library():
    """The loaded kernel library, built first if needed."""
    path = build_dir() / "libproxtpu_torch.so"
    if not path.exists():
        _compile(path)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.proxtpu_error_string.argtypes = [ctypes.c_int]
    lib.proxtpu_error_string.restype = ctypes.c_char_p
    return lib


def check(err, what):
    """Raise if a C entry returned a CUDA error."""
    if err != 0:
        msg = library().proxtpu_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")


def check_shared_bytes(nbytes, device):
    """Raise if one block needs more dynamic shared memory than the
    device allows."""
    limit = max_shared_bytes(device.index)
    if nbytes > limit:
        raise ValueError(f"{nbytes} bytes of shared memory per block "
                         f"exceed the device's limit of {limit}")


@functools.lru_cache(maxsize=None)
def max_shared_bytes(device_index):
    """Dynamic shared memory one block may use on this device."""
    out = ctypes.c_int()
    check(library().proxtpu_max_smem_optin(device_index, ctypes.byref(out)),
          "cudaDeviceGetAttribute")
    return out.value


@functools.lru_cache(maxsize=None)
def sm_count(device_index):
    """Streaming multiprocessors of this device."""
    import torch

    return torch.cuda.get_device_properties(device_index).multi_processor_count
