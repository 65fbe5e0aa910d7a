"""The ways to take the SVD of the nuclear-norm prox on the card, side by
side: accuracy, the wall of a batched call, robust PCA's iterations and
matrix completion's wall.

    python -m proxtpu_torch.tools.svd_ways [--ways NAME ...] [--out FILE]

Each way replaces :func:`proxtpu_torch.prox.functions._singular` for its
measurements:

* ``port``: the helper as the package has it;
* ``f32``: ``torch.linalg.svd`` in float32, cuSOLVER's default driver;
* ``f32_gesvd``: the same with ``driver="gesvd"``;
* ``f64``: cast up to float64 on the card, the default driver, cast back;
* ``f64_gesvda``: the same with ``driver="gesvda"`` (cuSOLVER's batched
  approximate driver);
* ``gram64``: where the prox gives a floor (``NuclearNorm``), the float64
  Gram form ``Z = X V diag(max(1 - t / s, 0)) V^H`` from a batched
  ``torch.linalg.eigh`` of ``X^H X`` (no U; every singular value under the
  threshold t drops out); elsewhere ``f64``.

For each way it prints one line: the prox's largest distance from float64
LAPACK on the host at two inputs (``L + S`` of ``examples/robust_pca``'s
last iterate, solved on the CPU, and a normal 60 x 50 from numpy rng 0),
each at robust PCA's threshold (lam 0.25, gamma 1 / 2); the median wall of
one prox of a (64, 64, 48) batch under ``torch.func.vmap`` (matrix
completion's shape); ``examples/robust_pca`` on the card (float32, its
cap of 5000): iterations and wall; matrix completion
(``tools/families.py``, 64 lanes of 64 x 48, float32): seconds a solve
after a warm-up, iterations, lanes done, the held-out error.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from ..prox import functions as fns

LAM, GAMMA = 0.25, 0.5  # robust_pca's NuclearNorm and Davis-Yin's 1 / Lf
BATCH = (64, 64, 48)


def _svd_way(dtype_of, driver=None):
    """``_singular`` by ``torch.linalg.svd`` in ``dtype_of(X.dtype)`` with
    ``driver``, the result cast back."""
    def way(X, fn=None, floor=None):
        R = fns.real_dtype_of(X)
        Xw = X.to(dtype_of(X.dtype))
        if fn is None:
            return None, torch.linalg.svdvals(Xw, driver=driver).to(R)
        U, s, Vh = torch.linalg.svd(Xw, full_matrices=False, driver=driver)
        Z = (U * fn(s).unsqueeze(-2).to(U.dtype)) @ Vh
        return Z.to(X.dtype), s.to(R)
    return way


def _wider(dtype):
    return fns._WIDER.get(dtype, dtype)


def _gram64(X, fn=None, floor=None):
    if fn is None or floor is None:
        return _svd_way(_wider)(X, fn, floor)
    Z, s = fns._gram_form(X.to(_wider(X.dtype)), fn, floor)
    return Z.to(X.dtype), s.to(fns.real_dtype_of(X))


WAYS = {
    "port": None,
    "f32": _svd_way(lambda d: d),
    "f32_gesvd": _svd_way(lambda d: d, "gesvd"),
    "f64": _svd_way(_wider),
    "f64_gesvda": _svd_way(_wider, "gesvda"),
    "gram64": _gram64,
}


class using:
    """Context: the SVD proxes decompose by ``way``."""

    def __init__(self, way):
        self.way = WAYS[way]

    def __enter__(self):
        self.saved = fns._singular
        if self.way is not None:
            fns._singular = self.way
        return self

    def __exit__(self, *exc):
        fns._singular = self.saved


def host_prox(X):
    """The prox in float64 by LAPACK on the host."""
    U, s, Vh = np.linalg.svd(np.asarray(X, np.float64), full_matrices=False)
    return (U * np.maximum(s - GAMMA * LAM, 0)) @ Vh


def inputs():
    """``{name: float32 numpy matrix}``: robust PCA's ``L + S`` (solved on
    the CPU) and a normal 60 x 50."""
    from ..examples import robust_pca

    out = robust_pca.main(device="cpu")
    normal = np.random.default_rng(0).standard_normal((60, 50))
    return {"L + S of robust_pca": (out["L"] + out["S"]).astype(np.float32),
            "a normal 60 x 50": normal.astype(np.float32)}


def prox_error(X, device):
    Z, _ = fns.NuclearNorm(LAM).prox(torch.tensor(X, device=device), GAMMA)
    return float(np.abs(Z.double().cpu().numpy() - host_prox(X)).max())


def batched_ms(device, reps=5):
    X = torch.randn(*BATCH, device=device,
                    generator=torch.Generator(device).manual_seed(0))
    prox = torch.func.vmap(lambda x: fns.NuclearNorm(LAM).prox(x, GAMMA)[0])
    prox(X)
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prox(X)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(walls)


def robust_pca_run(device):
    from ..examples import robust_pca

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = robust_pca.main(device=device)
    torch.cuda.synchronize()
    ok = (out["rank"] == out["true_rank"]
          and np.array_equal(out["support_hat"], out["support_true"]))
    return out["iterations"], time.perf_counter() - t0, ok


def matrix_completion_run(device, data):
    from . import families as fam

    fam.mc_solve(data, device, maxit=4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xs, iters, done = fam.mc_solve(data, device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rel = fam.mc_heldout_error(data, xs.cpu().numpy())
    iters = iters.cpu().numpy()
    return (wall, int(np.median(iters)), int(iters.max()),
            int(done.sum()), float(np.median(rel)))


def measure(way, device, mats, mc_data):
    row = {"way": way}
    with using(way):
        for name, X in mats.items():
            try:
                row[f"error at {name}"] = prox_error(X, device)
            except RuntimeError as e:  # a driver that does not converge
                row[f"error at {name}"] = f"failed: {e}"[:120]
        try:
            row["batched prox ms"] = batched_ms(device)
        except RuntimeError as e:
            row["batched prox ms"] = f"failed: {e}"[:120]
        try:
            it, wall, ok = robust_pca_run(device)
            row.update({"robust_pca iterations": it, "robust_pca s": wall,
                        "robust_pca oracle": ok})
        except RuntimeError as e:
            row["robust_pca iterations"] = f"failed: {e}"[:120]
        try:
            wall, med, mx, done, rel = matrix_completion_run(device, mc_data)
            row.update({"matrix completion s": wall,
                        "matrix completion iterations median": med,
                        "matrix completion iterations max": mx,
                        "matrix completion done": done,
                        "matrix completion held-out median": rel})
        except RuntimeError as e:
            row["matrix completion s"] = f"failed: {e}"[:120]
    return row


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ways", nargs="*", default=list(WAYS))
    p.add_argument("--out", default=None, help="write the rows as JSON")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("svd_ways needs a CUDA device")
    from . import families as fam

    import subprocess

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    mats = inputs()
    mc_data = fam.mc_data()
    rows = []
    for way in args.ways:
        row = measure(way, "cuda", mats, mc_data)
        rows.append(row)
        print(json.dumps(row), f"[{card}]", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
