"""The JAX package's example scripts (``examples/``) run on the CPU, for the
port's tests (``tests/test_torch_examples_{a,b}.py``).

:func:`run` loads a script by its path, as ``tests/test_docs_examples.py``
does, and calls its ``main``.  Three scripts print their results and return
``None`` (``lasso_path``, ``svm_path``, ``tv_denoise``); for them the solver
calls are wrapped while ``main`` runs and their outputs returned under the
keys of the port's ``main``.  Nothing in the scripts changes.
"""

import contextlib
import importlib.util
import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(name):
    path = os.path.join(ROOT, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def one_thread():
    """One BLAS / OpenMP thread while the scripts run (and one torch
    thread): their solves are long loops of small operations, and where the
    suite's workers share the cores more threads only contend.  The JAX
    package's LAPACK (OpenBLAS) spins its threads: two of its SVD loops at
    once, each with a thread per core, take 25 times as long as one.  One
    small SVD loads that library first, so that the limit reaches it."""
    import jax.numpy as jnp
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:  # the limit is a speed-up, not a condition
        limits = contextlib.nullcontext()
    else:
        jnp.linalg.svd(jnp.eye(2))[1].block_until_ready()
        limits = threadpool_limits(limits=1)
    try:
        with limits:
            yield
    finally:
        torch.set_num_threads(n)


@contextlib.contextmanager
def _patched(obj, name, wrap):
    old = getattr(obj, name)
    setattr(obj, name, wrap(old))
    try:
        yield
    finally:
        setattr(obj, name, old)


def _lasso_path(mod):
    import proxtpu.kernels as jk

    seen = {}

    def loop(fn):
        def wrapped(iteration, **kw):
            out = fn(iteration, **kw)
            seen["lams"] = np.asarray(iteration.g.lam)
            seen["loop"] = out
            return out
        return wrapped

    def multirhs(fn):
        def wrapped(*args, **kw):
            seen["multirhs"] = out = fn(*args, **kw)
            return out
        return wrapped

    with _patched(mod, "batched_run_loop", loop), \
            _patched(jk, "solve_lasso_multirhs", multirhs):
        mod.main()
    xs, iters, done = (np.asarray(v) for v in seen["loop"])
    xs2, iters2, done2 = (np.asarray(v) for v in seen["multirhs"])
    gap = float(np.max(np.abs(xs2 - xs)))
    return {"lams": seen["lams"], "xs": xs, "iterations": iters,
            "done": done, "nnz": np.sum(np.abs(xs) > 1e-6, axis=1),
            "xs_multirhs": xs2, "iterations_multirhs": iters2,
            "done_multirhs": done2, "multirhs_gap": gap, "agree": gap < 1e-3}


def _svm_path(mod):
    seen = {}

    def batched(cls):
        class Recording(cls):
            def __call__(self, **kw):
                seen["lams"] = np.asarray(kw["g"].lam)
                seen["A"] = np.asarray(kw["L"].value)
                seen["y"] = np.asarray(kw["h"].value.y)
                seen["out"] = out = super().__call__(**kw)
                return out
        return Recording

    with _patched(mod, "BatchedAlgorithm", batched):
        mod.main()
    (xs, _), iters, done = seen["out"]
    xs = np.asarray(xs)
    margins = seen["y"][None, :] * (xs @ seen["A"].T)
    return {"lams": seen["lams"], "xs": xs, "iterations": np.asarray(iters),
            "done": np.asarray(done), "norms": np.linalg.norm(xs, axis=1),
            "train_acc": (margins > 0).mean(axis=1)}


def _tv_denoise(mod):
    seen = {}

    def solver(cls):
        def make(**opts):
            inner = cls(**opts)

            def call(**kw):
                seen["b"] = np.asarray(kw["g"].b)
                seen["out"] = out = inner(**kw)
                return out
            return call
        return make

    with _patched(mod.pa, "ChambollePock", solver):
        mod.main()
    (x, _), it = seen["out"]
    x = np.asarray(x)
    clean = np.zeros((64, 64))
    clean[16:48, 16:48] = 1.0
    clean[32:, :] += 0.5

    def psnr(u):
        return float(10 * np.log10(np.max(clean) ** 2
                                   / np.mean((u - clean) ** 2)))

    return {"iterations": int(it), "x": x, "psnr_noisy": psnr(seen["b"]),
            "psnr_denoised": psnr(x)}


PRINTING = {"lasso_path": _lasso_path, "svm_path": _svm_path,
            "tv_denoise": _tv_denoise}


def run(name):
    """The JAX script's results as the port's ``main`` returns them."""
    mod = load(name)
    if name in PRINTING:
        return PRINTING[name](mod)
    return mod.main(verbose=False)



# Per script: (count slack, atol of the results, the result keys held to
# atol, or None for every key).  float64 and complex128 scripts: equal
# counts, results within 1e-9.  float32 scripts (and reference_tolerances,
# whose warm stage is float32): the bounds below, a few times what the CPU
# shows (float32 sums in another order in XLA and in PyTorch part the
# trajectories by a few iterations), beside the oracle on both packages.
# convergence_curves' PANOC is float64 and parts from the JAX package's by
# a few iterations (ROADMAP queue 3, watch item 7: last-bit matmul order
# amplified by L-BFGS); its FISTA and ZeroFPR are held exactly.
TOLERANCE = {
    "lasso_path": (64, 1e-3, ("lams", "xs", "xs_multirhs")),
    "svm_path": (4, 2e-4, ("lams", "xs", "norms")),
    "multitask_lasso": (10, 2e-5, ("X",)),
    "robust_pca": (150, 1e-4, ("L", "S")),
    "reference_tolerances": (64, 1e-5, ("xs",)),
    "convergence_curves": (0, 1e-9, None),
}
F64 = (0, 1e-9, None)
COUNT_KEYS = {"iterations", "iters", "iterations_multirhs", "iterations_gd",
              "iterations_general", "it"}
PANOC_SLACK, PANOC_ATOL = 8, 1e-3


def _walk(port, ref, slack, atol, path):
    if isinstance(port, dict):
        assert set(port) == set(ref), path
        for k in port:
            _walk(port[k], ref[k], slack, atol, f"{path}.{k}")
    elif isinstance(port, (list, tuple)):
        assert len(port) == len(ref), path
        for i, (a, b) in enumerate(zip(port, ref)):
            _walk(a, b, slack, atol, f"{path}[{i}]")
    elif isinstance(port, str):
        assert port == ref, path
    else:
        a, b = np.asarray(port), np.asarray(ref)
        assert a.shape == b.shape, (path, a.shape, b.shape)
        if path.rsplit(".", 1)[-1] in COUNT_KEYS:
            d = np.abs(a.astype(np.int64) - b.astype(np.int64)).max(
                initial=0)
            assert d <= slack, (path, a, b)
        elif a.dtype == bool or a.dtype.kind in "iu":
            assert np.array_equal(a, b), (path, a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=atol,
                                       err_msg=path)


def compare(name, port, ref):
    """Hold the port's result against the JAX script's at ``name``'s
    tolerance."""
    slack, atol, keys = TOLERANCE.get(name, F64)
    if name == "convergence_curves":
        for solver in port:
            p, r = port[solver], ref[solver]
            if solver == "PANOC":
                assert abs(p["it"] - r["it"]) <= PANOC_SLACK
                np.testing.assert_allclose(p["x"], r["x"], rtol=0,
                                           atol=PANOC_ATOL)
            else:
                _walk(p, r, 0, atol, solver)
        return
    if keys is None:
        _walk(port, ref, slack, atol, name)
        return
    for k in keys:
        _walk(port[k], ref[k], slack, atol, f"{name}.{k}")
    from proxtpu_torch.examples import flat_counts, iterations

    got, want = (np.array(flat_counts(iterations(name, out)), np.int64)
                 for out in (port, ref))
    assert got.shape == want.shape
    assert np.abs(got - want).max(initial=0) <= slack, (name, got, want)
