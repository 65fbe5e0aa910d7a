"""The JAX package's example scripts (``examples/``) and the code blocks of
its guides (``docs/``) on the port.

One module per script, under the script's name, each with
``main(verbose=False, device="cuda")`` that builds the script's numpy inputs
(same seed, dtype, size, tolerance and cap) and returns the dict the
script's ``main`` returns, under the same keys.  It runs on the card unless
``device="cpu"`` is passed; with no card it raises.  Run one as
``python -m proxtpu_torch.examples.<name>``.  :mod:`.guides` holds one
function per Python block of the guides.  Importing a module runs nothing.

Each script's dtype is its numpy data's, as the JAX script's under
``jax_enable_x64`` (which its tests run, and which ``graphical_lasso``,
``reference_tolerances`` and ``phase_retrieval`` switch on themselves):
float64 unless the script casts to float32 (``lasso_path``, ``svm_path``,
``multitask_lasso``, ``robust_pca``).
"""

import numpy as np
import torch

SCRIPTS = (
    "lasso_path", "svm_path", "multitask_lasso", "convergence_curves",
    "reference_tolerances", "tv_denoise", "tv1d_denoising",
    "isotonic_regression", "leading_eigenvector", "graphical_lasso",
    "portfolio_cvar", "phase_retrieval", "robust_pca",
    "sparse_linear_regression",
)

# each script's dtype (reference_tolerances: its float32 stage, then its
# float64 polish)
DTYPES = {name: "float64" for name in SCRIPTS}
DTYPES.update(lasso_path="float32", svm_path="float32",
              multitask_lasso="float32", robust_pca="float32",
              reference_tolerances="float32 -> float64",
              phase_retrieval="complex128")

# The JAX package's iteration counts of each script on the CPU under
# jax_enable_x64 (the dtypes above), which chip_smoke.py prints beside the
# card's; tests/test_torch_examples_{a,b}.py keep them true.  None: one
# prox call, no iteration count.
JAX_ITERATIONS = {
    "lasso_path": {
        "path": [1, 52, 69, 70, 78, 79, 82, 94, 94, 95, 95, 96, 96, 97, 111,
                 112, 119, 120, 120, 121, 121, 112, 114, 115, 116, 106, 107,
                 118, 131, 132, 134, 129, 133, 132, 135, 156, 159, 162, 181,
                 184, 203, 215, 201, 205, 231, 233, 246, 266, 278, 287, 295,
                 329, 328, 384, 393, 402, 383, 427, 454, 506, 513, 529, 516,
                 548],
        "multirhs": [1, 52, 69, 70, 78, 79, 82, 94, 94, 95, 95, 96, 96, 97,
                     111, 112, 119, 120, 120, 121, 121, 112, 114, 115, 116,
                     106, 107, 118, 131, 132, 134, 129, 133, 132, 135, 156,
                     159, 162, 181, 184, 203, 215, 201, 205, 231, 233, 246,
                     266, 278, 287, 295, 329, 328, 384, 393, 402, 383, 427,
                     424, 522, 513, 530, 516, 548],
    },
    "svm_path": [5213, 3372, 2963, 2151, 1616, 1034, 710, 536, 368, 264, 168,
                 108, 69, 45, 30, 20],
    "multitask_lasso": 280,
    "convergence_curves": {"FISTA": 753, "PANOC": 141, "ZeroFPR": 75},
    "reference_tolerances": [87, 105, 115, 145, 194, 215, 286, 251, 247, 290,
                             529, 587, 725, 719, 900, 733],
    "tv_denoise": 3347,
    "tv1d_denoising": None,
    "isotonic_regression": [2, 269],
    "leading_eigenvector": 72,
    "graphical_lasso": 55,
    "portfolio_cvar": 10815,
    "phase_retrieval": [66, 2542],
    "robust_pca": 2357,
    "sparse_linear_regression": 301,
}

# the same for the guides' blocks (``guides.BLOCKS``; getting_started.md's
# block 3 steps a fixed 102 states and counts nothing)
GUIDES_JAX_ITERATIONS = {
    "custom_algorithms.md:1": 204,
    "custom_objectives.md:1": 142,
    "custom_objectives.md:2": 142,
    "custom_objectives.md:3": 67,
    "getting_started.md:1": 142,
    "getting_started.md:2": 358,
    "getting_started.md:4": 142,
    "getting_started.md:5": 1,
    "migrating_from_proximalalgorithms.md:1": 142,
}

# the same for docs/tpu_scaling.md's blocks (``scaling_guide.BLOCKS``) at
# the CPU tests' sizes (``scaling_guide.SMALL``): each lane's count, in
# float64 (blocks 1-3, 8: the warm start's float64 stage) or float32 (9,
# 10: the plain routes; 11: each payload), or one count (5, 6)
SCALING_JAX_ITERATIONS = {
    "tpu_scaling.md:1": [558, 450, 614, 1058, 402, 359, 646, 630],
    "tpu_scaling.md:2": [558, 450, 614, 1058, 402, 359, 646, 630],
    "tpu_scaling.md:3": [127, 129, 113, 193, 138, 83, 103, 111],
    "tpu_scaling.md:5": 56,
    "tpu_scaling.md:6": 520,
    "tpu_scaling.md:8": [846, 895, 675, 843, 483, 438, 365, 232],
    "tpu_scaling.md:9": [221, 227, 118, 191, 297],
    "tpu_scaling.md:10": [503, 266, 240, 189, 207, 145, 133, 70],
    "tpu_scaling.md:11": [
        [187, 103, 102, 68, 76, 81, 91, 46, 186, 103, 100, 66, 76, 88, 84,
         100],
        [52, 52, 96, 128, 102, 96, 138, 54, 97, 67, 109, 125, 54, 61, 91,
         69]],
}

# block 4 on block 1's first 256 As (200 x 400, float64): the JAX block's
# worst relative error of ||A||_2^2 after its 50 power iterations, on the
# CPU (95 of the 256 lanes miss the block's 0.5%)
SCALING_POWER_JAX_WORST = 0.060432152125566914

# block 8 at its own scale (256 lambdas over one 200 x 400 A, float64, tol
# 1e-8): the JAX block's largest gap between its warm and its cold
# solution, on the CPU.  tests/test_warm.py's 50 tol holds at its small
# size; here the JAX package itself passes it on 120 of the 256 lanes
# (the wide A leaves the small-lambda solutions loosely pinned by the
# residual), so the port is held to twice this gap.
SCALING_WARM_JAX_GAP = 0.00011275797477550142


def device_of(device):
    """``torch.device(device)``; a CUDA device with no card raises (an
    example never carries on on the CPU unless asked to)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: run the example on the CPU with "
            "main(device='cpu')")
    return dev


def iterations(name, out):
    """The iteration counts in one script's result (the port's or the JAX
    script's, under the same keys), as :data:`JAX_ITERATIONS` holds
    them; ``None`` for ``tv1d_denoising``, one prox call."""
    if name == "lasso_path":
        return {"path": [int(v) for v in out["iterations"]],
                "multirhs": [int(v) for v in out["iterations_multirhs"]]}
    if name == "svm_path":
        return [int(v) for v in out["iterations"]]
    if name == "reference_tolerances":
        return [int(v) for v in out["iters"]]
    if name == "convergence_curves":
        return {k: int(v["it"]) for k, v in out.items()}
    if name == "isotonic_regression":
        return [int(out["iterations"]), int(out["iterations_general"])]
    if name == "phase_retrieval":
        return [int(out["iterations"]), int(out["iterations_gd"])]
    if name == "tv1d_denoising":
        return None
    return int(out["iterations"])


def flat_counts(counts):
    """The counts of :func:`iterations` as one list of ints (a dict's in
    the order of its sorted keys)."""
    if isinstance(counts, dict):
        return [v for k in sorted(counts) for v in flat_counts(counts[k])]
    if isinstance(counts, (list, tuple)):
        return [int(v) for v in counts]
    return [] if counts is None else [int(counts)]


def check(name, out, again=None):
    """Assert script ``name``'s own oracle on its result ``out`` (the
    assertions of the JAX package's ``tests/test_docs_examples.py``, or, for
    a script that test does not run, the claims the script prints);
    ``again``, a second result of ``multitask_lasso``, must be bit-equal
    to the first."""
    if name == "lasso_path":
        assert out["done"].all() and out["done_multirhs"].all()
        assert out["agree"], out["multirhs_gap"]
    elif name == "svm_path":
        assert out["done"].all()
    elif name == "multitask_lasso":
        assert np.array_equal(out["selected"], out["support"])
        assert out["iterations"] < 2000
        if again is not None:
            assert np.array_equal(out["X"], again["X"])  # deterministic
    elif name == "convergence_curves":
        from .convergence_curves import TOL

        assert out["ZeroFPR"]["it"] < out["FISTA"]["it"]
        assert out["PANOC"]["it"] < out["FISTA"]["it"]
        for r in out.values():
            assert r["curve"][-1] <= TOL
            assert len(r["curve"]) == r["it"]
    elif name == "reference_tolerances":
        assert out["worst_residual"] <= 1.05e-8
        assert out["nnz"][-1] >= out["nnz"][0]
        assert out["xs"].dtype == np.float64
    elif name == "tv_denoise":
        assert out["iterations"] < 20_000
        assert out["psnr_denoised"] > out["psnr_noisy"] + 10.0
    elif name == "tv1d_denoising":
        assert out["snr_denoised"] > out["snr_noisy"] + 6.0
    elif name == "isotonic_regression":
        assert out["monotone"] and out["monotone_general"]
        assert out["mse_vs_truth"] < out["mse_noisy"]
        assert out["iterations"] < 5000
    elif name == "leading_eigenvector":
        assert abs(out["rayleigh"] - out["lam_max"]) <= 1e-8 * (
            1 + abs(out["lam_max"]))
        assert out["align"] > 1 - 1e-6
        assert out["iterations"] < 500
    elif name == "graphical_lasso":
        assert out["iterations"] < 3000
        assert out["kkt_diag"] < 1e-6 and out["kkt_nz"] < 1e-6
        assert out["kkt_zero_bound_ok"]
        assert out["min_eig"] > 0
        assert all(fp == 0 for _, _, _, fp in out["path"])
        assert out["path"][0][1] > out["path"][-1][1] >= 0
    elif name == "portfolio_cvar":
        _check_cvar(out)
    elif name == "phase_retrieval":
        assert out["rel_error"] < 1e-6
        assert out["iterations"] < 200
        assert out["iterations"] < out["iterations_gd"] / 10
    elif name == "robust_pca":
        assert out["rank"] == out["true_rank"]
        assert np.array_equal(out["support_hat"], out["support_true"])
        assert out["iterations"] < 5000
    elif name == "sparse_linear_regression":
        assert out["iterations"] < 10_000
        names = {n for n, _ in out["selected"]}
        assert {"bmi", "s5", "bp"} <= names
        assert 1 <= len(names) <= 9
        assert out["test_mse"] < 1600.0
    else:
        raise KeyError(name)


def _check_cvar(out):
    """Minimum CVaR: on the simplex, better than equal weights, and no
    feasible perturbation (30 from numpy rng 0, projected on the simplex on
    the CPU) improves it."""
    from ..prox import IndSimplex

    w = np.asarray(out["weights"])
    assert out["iterations"] < 50_000
    assert np.all(w >= -1e-8) and abs(np.sum(w) - 1) < 1e-6
    assert out["cvar_opt"] < out["cvar_equal_weight"] - 0.01
    rng = np.random.default_rng(0)
    R, k, n = np.asarray(out["R"]), out["k"], len(w)

    def cvar(ww):
        return float(np.mean(np.sort(-R @ ww)[-k:]))

    def proj(v):
        return IndSimplex(1.0).prox(torch.tensor(v), 1.0)[0].numpy()

    base = cvar(w)
    for _ in range(30):
        p = proj(w + 0.02 * rng.standard_normal(n))
        assert cvar(p) >= base - 1e-6
