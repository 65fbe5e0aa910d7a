"""``docs/tpu_scaling.md``'s blocks run under JAX on the CPU, and the port's
counterparts (``proxtpu_torch/examples/scaling_guide.py``) at the tests'
sizes, for ``tests/test_torch_scaling_guide*.py``.

:func:`run` executes a block's text, as ``tests/test_torch_guides.py``
executes the other guides' blocks, in a namespace that supplies the names
the text uses; ``text`` replaces it where the test writes out a call the
block leaves as ``...``.  Nothing in the doc changes.
"""

import contextlib
import os
import re

import numpy as np
import torch

from proxtpu_torch.examples import scaling_guide as sg

DOC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "docs", "tpu_scaling.md")
ATOL = 1e-9


@contextlib.contextmanager
def one_thread():
    """One torch thread: the port's blocks are loops of small operations,
    and where the suite's workers share the cores more threads contend
    (block 3's test, bounded adaptive FB, took 225 s in a six-worker run of
    the suite with a thread a core, against 5 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def block(i):
    """The text of block ``i`` (from 1)."""
    return re.findall(r"```python\n(.*?)```", open(DOC).read(), re.S)[i - 1]


def count():
    return len(re.findall(r"```python\n", open(DOC).read()))


def run(i, ns, text=None):
    exec(compile(block(i) if text is None else text, "tpu_scaling.md",
                 "exec"), ns)
    return ns


def port(i):
    """The port's block ``i`` at ``scaling_guide.SMALL``'s size on the CPU,
    held to what its paragraph claims."""
    out = sg.BLOCKS[("tpu_scaling.md", i)](device="cpu", **sg.SMALL[i])
    sg.check(("tpu_scaling.md", i), out)
    return out


def numpy(v):
    return np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)


def close(port_value, ref, atol):
    np.testing.assert_allclose(numpy(port_value), numpy(ref), rtol=0,
                               atol=atol)


def jax_power(As):
    """Block 4's text under JAX on ``As``: each lane's ``||A||_2^2``."""
    import jax
    import jax.numpy as jnp

    return np.asarray(run(4, {"jax": jax, "jnp": jnp, "As": As})["Lfs"])
