"""The roofline's arithmetic: the bytes and operations of one lasso
iteration at both shapes, and the share that ``roofline.lasso`` reads."""

import types

import pytest
import torch

from portbench import harness

lasso = harness.load_module("problems", "lasso")
PEAKS = harness.peaks_for("NVIDIA H100 80GB HBM3")


@pytest.mark.parametrize("M, N, nbytes, flops", [
    (200, 400, 4 * (200 * 400 + 200 + 4 * 400), 4 * 200 * 400),
    (512, 1024, 4 * (512 * 1024 + 512 + 4 * 1024), 4 * 512 * 1024),
])
def test_iteration_bytes_and_flops(M, N, nbytes, flops):
    problem = dict(M=M, N=N)
    assert lasso.iteration_bytes(problem) == nbytes
    assert lasso.iteration_flops(problem) == flops
    # both shapes are bound by the memory, not the float32 rate
    assert (nbytes / PEAKS["hbm_bytes_per_s"]
            > flops / PEAKS["fp32_flops_per_s"])


def test_peaks_are_the_data_sheet():
    assert PEAKS == {"hbm_bytes_per_s": 3.35e12, "fp32_flops_per_s": 6.7e13}


def fake_run(iters, kernel_s, peaks=PEAKS, M=200, N=400):
    calls = [types.SimpleNamespace(iters=torch.tensor(i)) for i in iters]
    cfg = {"problem": {"kind": "lasso", "M": M, "N": N}}
    return types.SimpleNamespace(
        problems=lasso, calls=calls, peaks=peaks,
        cell=types.SimpleNamespace(config=cfg),
        trace=None if kernel_s is None else {"kernel_s": kernel_s})


def test_roofline_share():
    read = harness.load_module("metrics", "roofline.lasso").read
    run = fake_run([[100, 200], [300]], kernel_s=0.001)
    least = 600 * lasso.iteration_bytes(dict(M=200, N=400)) / 3.35e12
    assert read(run) == pytest.approx(100 * least / 0.001)


@pytest.mark.parametrize("kernel_s, peaks", [(None, PEAKS), (0.0, PEAKS),
                                             (0.001, None)])
def test_roofline_reads_nothing_without_a_trace_or_a_peak(kernel_s, peaks):
    read = harness.load_module("metrics", "roofline.lasso").read
    assert read(fake_run([[1]], kernel_s, peaks)) is None
