"""Blocks 4 and 8 of ``docs/tpu_scaling.md`` at their own scale on the CPU,
where the JAX blocks themselves miss what their text (block 4) or
``tests/test_warm.py`` (block 8) claims: the numbers the port on the card is
held to instead (``proxtpu_torch/examples/scaling_guide.py::check``), kept
true here.

Block 4 on block 1's first 256 As (``lasso_data(256)``'s As): the JAX block's
50 power iterations miss 0.5% on 95 lanes, by at most
``SCALING_POWER_JAX_WORST``; the port on the same As stays within it.  Block
8 on 256 lambdas over one 200 x 400 A at tol 1e-8: the JAX block's warm
solution lies ``SCALING_WARM_JAX_GAP`` from its cold one, past 50 tol on 120
lanes (the port on the card is held to twice that).
"""

import jax.numpy as jnp
import numpy as np

from proxtpu.algorithms import make_fast_forward_backward_iteration
from proxtpu.parallel import BatchedAlgorithm, Shared
from proxtpu.prox import LeastSquaresLoss, NormL1
from proxtpu_torch.examples import SCALING_POWER_JAX_WORST, \
    SCALING_WARM_JAX_GAP
from proxtpu_torch.examples import scaling_guide as sg
from proxtpu_torch.tools import problems
import torch_scaling_jax as tj


def test_block_4_at_the_blocks_scale_held_to_the_jax_error():
    """Block 1's first 256 As on the card are ``lasso_data(256)``'s: there
    the JAX block misses the text's 0.5% on 95 lanes, by at most
    ``SCALING_POWER_JAX_WORST``, and the port is held to that."""
    As = problems.lasso_data(sg.FLAGSHIP, sg.M, sg.N, np.float64)[0]
    exact = np.linalg.eigvalsh(As @ As.transpose(0, 2, 1))[:, -1]
    jax_err = np.abs(tj.jax_power(jnp.asarray(As)) - exact) / exact
    np.testing.assert_allclose(jax_err.max(), SCALING_POWER_JAX_WORST,
                               rtol=1e-9)
    assert int((jax_err > sg.OPNORM_CLAIM).sum()) == 95
    port = sg.power_iteration("cpu", lanes=sg.FLAGSHIP, source=sg.FLAGSHIP)
    np.testing.assert_allclose(port["Lfs_exact"].numpy(), exact, rtol=1e-12)
    sg.check(("tpu_scaling.md", 4), port)


def test_block_8_at_the_blocks_scale_the_jax_gap():
    """At block 8's own scale (256 lambdas over one 200 x 400 A) the JAX
    block's warm solution is ``SCALING_WARM_JAX_GAP`` from its cold one,
    past ``tests/test_warm.py``'s 50 tol on 120 lanes; the port on the card
    is held to twice that (``scaling_guide.check``)."""
    from proxtpu.parallel import WarmStartedBatchedAlgorithm

    A, b, lams, Lf = problems.shared_lasso_problem(sg.FLAGSHIP, sg.M, sg.N,
                                                   np.float64)
    kw = dict(x0=jnp.zeros((sg.FLAGSHIP, sg.N)),
              f=Shared(LeastSquaresLoss(jnp.asarray(A), jnp.asarray(b))),
              g=NormL1(jnp.asarray(lams)), Lf=Lf)
    xs_w, _, done_w = WarmStartedBatchedAlgorithm(
        make_fast_forward_backward_iteration, maxit=20_000, tol=1e-8)(**kw)
    xs_c, _, done_c = BatchedAlgorithm(
        make_fast_forward_backward_iteration, maxit=20_000, tol=1e-8)(**kw)
    assert bool(np.all(done_w)) and bool(np.all(done_c))
    gap = np.abs(np.asarray(xs_w) - np.asarray(xs_c)).max(axis=1)
    np.testing.assert_allclose(gap.max(), SCALING_WARM_JAX_GAP, rtol=1e-6)
    assert int((gap > 50 * 1e-8).sum()) == 120
