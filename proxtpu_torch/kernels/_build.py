"""Build and load the port's CUDA kernels (``proxtpu_torch/csrc``).

The sources are compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded through :mod:`ctypes`.  The build happens at
first use, never at import, into ``build/proxtpu_torch/<hash>/`` beside the
package, keyed by a hash of the sources and the flags, so a changed source
builds anew and an unchanged one is loaded as it is.  A failed build raises
with the compiler's output.
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
_SOURCES = ("lasso_step.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # A, b, x, z_prev, beta, gamma, thr, done, shrink, res, rs, B, M, N,
    # restart, stream
    "proxtpu_fista_step": [_P] * 11 + [_I] * 4 + [_P],
    # A, b, x, gamma, thr, shrink, z, res, B, M, N, stream
    "proxtpu_fb_step": [_P] * 8 + [_I] * 3 + [_P],
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
    for name in _SOURCES:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    root = _CSRC.parent.parent / "build" / "proxtpu_torch"
    return root / h.hexdigest()[:16]


def _compile(out):
    """Compile the sources into ``out``; returns nvcc's output (it carries
    ``-Xptxas -v``'s registers and shared memory per kernel)."""
    out.parent.mkdir(parents=True, exist_ok=True)
    # build under a temporary name, then rename: a concurrent loader never
    # sees a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *(str(_CSRC / name) for name in _SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
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


@functools.lru_cache(maxsize=None)
def max_shared_bytes(device_index):
    """Dynamic shared memory one block may use on this device."""
    out = ctypes.c_int()
    check(library().proxtpu_max_smem_optin(device_index, ctypes.byref(out)),
          "cudaDeviceGetAttribute")
    return out.value
