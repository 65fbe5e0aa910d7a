"""``docs/tpu_scaling.md``'s blocks 5, 6 and 12 on the port
(``proxtpu_torch/examples/scaling_guide.py``) against the same blocks
executed under JAX on the 8-device mesh of ``tests/conftest.py``, as
``tests/test_torch_scaling_guide.py`` executes the others.  Block 6's
``...`` is written out as the port fills it: eight blocks of
``big_lasso(m=64, n=16)``'s rows, one a device of that mesh.

The port runs blocks 5 and 6 in this process on a one-rank Gloo group,
and all three on four Gloo ranks in one ``spmd_worker`` (block 12's port,
started first so that the JAX blocks run while it works).  Tolerances, as
``tests/test_torch_multiprocess.py``: exact float64 counts, PANOC within
1e-10, consensus within 1e-9; the consensus runs two all-reduces an
iteration (the mean and the primal residual's max).
"""

import contextlib
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import proxtpu as pa
from proxtpu.parallel import make_mesh
from proxtpu.prox import NormL1, SqrNormL2, Translate, make_least_squares
from proxtpu_torch.examples import SCALING_JAX_ITERATIONS
from proxtpu_torch.examples import scaling_guide as sg
from proxtpu_torch.tools import spmd_worker
import torch_scaling_jax as tj


@pytest.fixture(scope="module")
def ranks():
    """Block 12 on four Gloo ranks running blocks 5, 6 and the dry run,
    started before the JAX blocks run."""
    import concurrent.futures

    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(tj.port, 12)
    yield future
    pool.shutdown()


@pytest.fixture(scope="module")
def tp_mesh():
    return make_mesh((8,), ("tp",))


def _jax_sharded_panoc(tp_mesh):
    A, b, lam, Lf = (jnp.asarray(v) if isinstance(v, np.ndarray) else v
                     for v in spmd_worker.big_lasso())
    ns = tj.run(5, {"pa": pa, "A": A, "x0": jnp.zeros(A.shape[1]),
                   "f": Translate(SqrNormL2(1.0), -b), "g": NormL1(lam),
                   "Lf": Lf})
    return ns["x"], ns["it"]


def _jax_consensus(tp_mesh):
    A, b, lam, _ = spmd_worker.big_lasso(m=64, n=16)
    rows = A.shape[0] // spmd_worker.SCALING_BLOCKS
    blocks = [make_least_squares(jnp.asarray(A[i * rows:(i + 1) * rows]),
                                 jnp.asarray(b[i * rows:(i + 1) * rows]))
              for i in range(spmd_worker.SCALING_BLOCKS)]
    text = re.sub(r"blocks = \[make_least_squares\(A_i, b_i\) for \.\.\.\]"
                  r".*\n", "", tj.block(6))
    ns = tj.run(6, {"blocks": blocks, "mesh": tp_mesh,
                   "make_least_squares": make_least_squares,
                   "x0": jnp.zeros(16), "NormL1": NormL1, "lam": lam}, text)
    return ns["x"], ns["it"]


def test_block_5_sharded_panoc_one_rank(tp_mesh):
    x, it = _jax_sharded_panoc(tp_mesh)
    port = tj.port(5)
    assert port["ranks"] == 1 and port["iterations"] == int(it)
    tj.close(port["x"], x, 1e-10)
    assert SCALING_JAX_ITERATIONS["tpu_scaling.md:5"] == int(it)


def test_block_6_consensus_one_rank(tp_mesh):
    x, it = _jax_consensus(tp_mesh)
    port = tj.port(6)
    assert port["ranks"] == 1 and port["iterations"] == int(it)
    tj.close(port["x"], x, tj.ATOL)
    assert port["all_reduces"] == 2 * port["iterations"]
    assert SCALING_JAX_ITERATIONS["tpu_scaling.md:6"] == int(it)


def test_blocks_5_6_12_on_four_gloo_ranks(ranks, tp_mesh):
    x5, it5 = _jax_sharded_panoc(tp_mesh)
    x6, it6 = _jax_consensus(tp_mesh)
    out = ranks.result()
    assert out["ranks"] == 4
    got = out["outputs"]
    assert int(got["scaling_panoc__it"]) == int(it5)
    tj.close(got["scaling_panoc__x"], x5, 1e-10)
    assert int(got["scaling_consensus__it"]) == int(it6)
    tj.close(got["scaling_consensus__x"], x6, tj.ATOL)
    assert int(got["scaling_consensus__all_reduces"]) == 2 * int(it6)
    assert int(got["dryrun__ran"]) == 4


def test_block_12_text_runs_here(ranks):
    saved = os.environ.get("XLA_FLAGS")
    try:
        tj.run(12, {"os": os, "jax": jax})
        assert os.environ["XLA_FLAGS"].endswith("device_count=8")
    finally:
        with contextlib.suppress(KeyError):
            del os.environ["XLA_FLAGS"]
        if saved is not None:
            os.environ["XLA_FLAGS"] = saved
    assert len(jax.devices()) == 8
    sg.check(("tpu_scaling.md", 12), ranks.result())
