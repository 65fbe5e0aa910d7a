"""The port's public surface against the JAX package's: every module of
``proxtpu`` (``pkgutil.walk_packages``) has its counterpart in
``proxtpu_torch`` with every public name (``__all__`` where the module
has one, else the names it defines), but the ones left out on purpose;
``__version__`` and ``algorithms.common.resolve_gamma`` as the JAX
package's."""

import importlib
import inspect
import pkgutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import proxtpu
import proxtpu_torch
from proxtpu.algorithms.common import resolve_gamma as jresolve_gamma
from proxtpu_torch.algorithms.common import resolve_gamma

# left out on purpose (ROADMAP.md, "Left out on purpose"): the TPU packing
# transform and its kernel, and the lane count of the TPU layout
LEFT_OUT = {
    ("kernels.common", "auto_lanes"),
    ("kernels.lasso", "fused_fista_packed_step"),
    ("kernels.lasso", "pack_lasso_batch"),
}


def _modules(package):
    """``{module path below the package: module}`` of every module."""
    mods = {"": package}
    for info in pkgutil.walk_packages(package.__path__,
                                      package.__name__ + "."):
        mods[info.name[len(package.__name__) + 1:]] = importlib.import_module(
            info.name)
    return mods


def _public(mod):
    names = getattr(mod, "__all__", None)
    if names is not None:
        return set(names)
    return {n for n, v in vars(mod).items()
            if not n.startswith("_") and not inspect.ismodule(v)
            and getattr(v, "__module__", None) == mod.__name__}


def test_the_port_lacks_only_what_is_left_out_on_purpose():
    port = _modules(proxtpu_torch)
    missing = set()
    for path, mod in _modules(proxtpu).items():
        other = port.get(path)
        missing |= {(path, n) for n in _public(mod)
                    if other is None or not hasattr(other, n)}
    assert missing == LEFT_OUT


def test_version():
    assert proxtpu_torch.__version__ == proxtpu.__version__


@pytest.mark.parametrize("gamma, Lf, scale", [
    (0.3, 4.0, 1.0), (None, 3.0, 1.0), (None, 7.0, 0.95),
    (None, np.float64(2.5), 2.0), (None, None, 1.0)])
def test_resolve_gamma(gamma, Lf, scale):
    got = resolve_gamma(gamma, Lf, scale)
    want = jresolve_gamma(gamma, Lf, scale)
    if want is None:
        assert got is None
    elif gamma is not None:
        assert got == want
    else:
        assert got.dtype == torch.float64
        assert float(got) == float(jnp.asarray(want))
