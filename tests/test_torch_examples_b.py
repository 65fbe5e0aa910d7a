"""The example scripts on the port (``proxtpu_torch/examples/``) against the
JAX package's (``examples/``), on the CPU: the other six (min-CVaR
portfolio, robust PCA, phase retrieval, isotonic regression, 1-D TV
denoising, sparse linear regression), split by runtime;
``tests/test_torch_examples_a.py`` holds the rest.

Each script's ``main`` runs in both packages on the same numpy inputs
(same seed, dtype, size, tolerance and cap); the JAX script runs as
``tests/test_docs_examples.py`` runs it.  Both results meet the script's
own oracle (``proxtpu_torch.examples.check``), and the port's is held to
the JAX script's at the tolerance of ``tests/torch_examples_jax.py``:
float64 and complex128 scripts equal counts and results within 1e-9,
float32 scripts the bounds stated there.  The JAX counts are
``proxtpu_torch.examples.JAX_ITERATIONS``, which ``chip_smoke.py`` prints
beside the card's.
"""

import functools

import pytest

import torch_examples_jax as tj
from proxtpu_torch import examples

SCRIPTS = ("portfolio_cvar", "robust_pca", "phase_retrieval",
           "isotonic_regression", "tv1d_denoising",
           "sparse_linear_regression")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with tj.one_thread():
        yield


@functools.lru_cache(maxsize=None)
def _jax(name):
    return tj.run(name)


@pytest.mark.parametrize("name", SCRIPTS)
def test_port_meets_the_oracle_and_the_jax_script(name):
    mod = __import__(f"proxtpu_torch.examples.{name}", fromlist=["main"])
    port = mod.main(device="cpu")
    again = mod.main(device="cpu") if name == "multitask_lasso" else None
    examples.check(name, port, again)
    ref = _jax(name)
    examples.check(name, ref)
    tj.compare(name, port, ref)


@pytest.mark.parametrize("name", SCRIPTS)
def test_jax_counts_are_the_constants(name):
    assert examples.iterations(name, _jax(name)) == \
        examples.JAX_ITERATIONS[name]
