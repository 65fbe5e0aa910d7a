"""The diabetes table that ``proxtpu_torch/examples/sparse_linear_regression``
reads (``proxtpu_torch/examples/data/``): the same numbers as
``sklearn.datasets.load_diabetes(scaled=False)``, which the JAX script
reads, and the same bytes as scikit-learn's files.  Skipped where
scikit-learn is not installed, as ``tests/test_docs_examples.py`` is."""

import os

import numpy as np
import pytest

from proxtpu_torch.examples import sparse_linear_regression as slr


def test_table_is_load_diabetes():
    datasets = pytest.importorskip("sklearn.datasets")
    want = datasets.load_diabetes(scaled=False)
    data, target = slr.load_diabetes_dataset()
    assert data.shape == (442, 10) and target.shape == (442,)
    assert data.dtype == target.dtype == np.float64
    np.testing.assert_array_equal(data, want.data)
    np.testing.assert_array_equal(target, want.target)


@pytest.mark.parametrize("name", ["diabetes_data_raw.csv.gz",
                                  "diabetes_target.csv.gz"])
def test_files_are_scikit_learns(name):
    datasets = pytest.importorskip("sklearn.datasets")
    theirs = os.path.join(os.path.dirname(datasets.__file__), "data", name)
    with open(theirs, "rb") as a, open(os.path.join(slr.DATA, name),
                                       "rb") as b:
        assert a.read() == b.read()


def test_source_is_named():
    text = open(os.path.join(slr.DATA, "SOURCE")).read()
    assert "scikit-learn 1.9.0" in text and "BSD-3" in text
