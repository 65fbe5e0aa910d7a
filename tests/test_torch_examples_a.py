"""The example scripts on the port (``proxtpu_torch/examples/``) against the
JAX package's (``examples/``), on the CPU: eight of the 14 (SVM path, lasso
path, multi-task lasso, convergence curves, reference tolerances, TV
denoising, leading eigenvector, graphical lasso), split by runtime;
``tests/test_torch_examples_b.py`` holds the rest.

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
import torch

import torch_examples_jax as tj
from proxtpu_torch import examples

SCRIPTS = ("svm_path", "lasso_path", "multitask_lasso", "convergence_curves",
           "reference_tolerances", "tv_denoise", "leading_eigenvector",
           "graphical_lasso")


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


def test_every_script_is_ported_and_tested():
    import os

    from test_torch_examples_b import SCRIPTS as REST

    here = os.path.join(tj.ROOT, "examples")
    scripts = {f[:-3] for f in os.listdir(here) if f.endswith(".py")}
    assert scripts == set(examples.SCRIPTS) == set(SCRIPTS) | set(REST)
    assert set(examples.JAX_ITERATIONS) == scripts
    for name in scripts:
        mod = __import__(f"proxtpu_torch.examples.{name}",
                         fromlist=["main"])
        assert callable(mod.main)


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a card is present")
def test_main_raises_without_a_card():
    from proxtpu_torch.examples import multitask_lasso

    with pytest.raises(RuntimeError, match="no CUDA device"):
        multitask_lasso.main()
