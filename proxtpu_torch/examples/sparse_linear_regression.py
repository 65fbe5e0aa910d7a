"""Example: sparse linear regression on the diabetes dataset.

The port of ``examples/sparse_linear_regression.py``: an L1-regularized
standardized linear model fitted to the diabetes table (442 patients x 10
features) with ``FastForwardBackward`` in its default adaptive mode and the
smooth term differentiated by ``AutoDifferentiable``.  The table is read
from ``data/`` (scikit-learn's copy, see ``data/SOURCE``) with numpy, as
``sklearn.datasets.load_diabetes(scaled=False)`` reads it.  float64.

    python -m proxtpu_torch.examples.sparse_linear_regression
"""

import os

import numpy as np
import torch

from ..algorithms import FastForwardBackward
from ..prox import AutoDifferentiable, NormL1
from . import device_of

FEATURE_NAMES = [
    "age", "sex", "bmi", "bp", "s1", "s2", "s3", "s4", "s5", "s6",
]
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def load_diabetes_dataset():
    """The raw (unscaled) diabetes table: ``(data (442, 10), target
    (442,))`` in float64."""
    data = np.loadtxt(os.path.join(DATA, "diabetes_data_raw.csv.gz"))
    target = np.loadtxt(os.path.join(DATA, "diabetes_target.csv.gz"))
    return data.astype(np.float64), target.astype(np.float64)


def mean_squared_error(label, output):
    return torch.mean((output - label) ** 2) / 2


def make_training_loss(training_input, training_label):
    """Standardized linear model: weights act on z-scored features, the
    bias absorbs the feature means."""
    input_loc = torch.mean(training_input, dim=0)
    input_scale = torch.std(training_input, dim=0, correction=0)

    def standardized_linear_model(wb, inputs):
        w_scaled = wb[:-1] / input_scale
        bias = wb[-1] - torch.dot(w_scaled, input_loc)
        return inputs @ w_scaled + bias

    loss = AutoDifferentiable(
        lambda wb: mean_squared_error(
            training_label, standardized_linear_model(wb, training_input)
        )
    )
    return loss, standardized_linear_model


def main(verbose=False, device="cuda"):
    dev = device_of(device)
    data, target = load_diabetes_dataset()
    training_input = torch.tensor(data[:-100], device=dev)
    training_label = torch.tensor(target[:-100], device=dev)
    test_input = torch.tensor(data[-100:], device=dev)
    test_label = torch.tensor(target[-100:], device=dev)
    n_features = training_input.shape[1]

    training_loss, model = make_training_loss(training_input, training_label)
    reg = NormL1(1.0)

    ffb = FastForwardBackward()
    solution, iterations = ffb(
        x0=torch.zeros(n_features + 1, dtype=torch.float64, device=dev),
        f=training_loss, g=reg
    )

    weights = solution[:-1].cpu().numpy()
    selected = [
        (FEATURE_NAMES[i], float(weights[i]))
        for i in np.flatnonzero(np.abs(weights) > 1e-8)
    ]
    test_mse = float(
        mean_squared_error(test_label, model(solution, test_input))
    )
    if verbose:
        print(f"converged in {iterations} iterations")
        print(f"selected {len(selected)}/{n_features} features:")
        for name, w in selected:
            print(f"  {name:>4s}  {w:+.3f}")
        print(f"test MSE: {test_mse:.2f}")
    return dict(
        iterations=iterations,
        selected=selected,
        weights=weights,
        test_mse=test_mse,
    )


if __name__ == "__main__":
    main(verbose=True)
