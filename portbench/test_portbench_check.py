"""What decides ``correct``, driven through a whole run of each cell at a
size the CPU holds (the harness's look for a card is skipped; the timed
path is the program's own, on its plain route): the program passes, and
the control and each fault that a one-chip lasso cell can have fail.

The faults: a step that returns its state unchanged; half of the batch
left out; an answer altered where it is produced.  No cell runs across
chips, so none can leave out an exchange between them."""

import time

import pytest
import torch

from portbench import harness, readings, tiny

CELLS = list(tiny.SIZES)


def run(workload, solve=None):
    cell = tiny.cell(workload)
    return harness.run_cell(cell, 2 ** 31 + 77, 0.0, False, "cpu",
                            time.perf_counter(), solve=solve,
                            calls=cell.traffic["pool_batches"] * 2)


def program(workload):
    cell = tiny.cell(workload)
    return harness.load_module("entries", cell.config["entry"]).program(
        cell.config)


@pytest.mark.parametrize("w", CELLS)
def test_the_program_is_correct(w):
    r = run(w)
    assert r["correct"], r["check"]
    assert list(r)[-1] == "check"
    assert r["attempted"] > 0 and r["failed"] == 0


@pytest.mark.parametrize("w", CELLS)
def test_the_control_is_not(w):
    """The plain reference in float32 with TF32 products, in the
    program's place."""
    r = run(w, solve=readings.control(tiny.cell(w)))
    assert not r["correct"], r["check"]
    assert r["check"]["recheck"]["value"] > r["check"]["recheck"]["limit"]


@pytest.mark.parametrize("w", CELLS)
def test_a_step_that_returns_its_state_unchanged(w, monkeypatch):
    """Each step of the program's plain route hands back the state it was
    given, with a zero residual."""
    from proxtpu_torch.kernels import lasso as pl

    def full_step(A, b, x, z_prev, beta, gamma, thr, done_mask, *a, **k):
        return x.clone(), z_prev.clone(), torch.zeros_like(beta), \
            torch.zeros_like(beta)

    def packed_step(Ap, bp, x, z_prev, beta, *a, **k):
        return x.clone(), z_prev.clone(), torch.zeros_like(beta), \
            torch.zeros_like(beta)

    def k_steps(A, b, x, z_prev, t, *a, **k):
        return x.clone(), z_prev.clone(), t.clone(), torch.zeros_like(t)

    monkeypatch.setattr(pl, "reference_fista_full_step", full_step)
    monkeypatch.setattr(pl, "reference_fista_packed_step", packed_step)
    monkeypatch.setattr(pl, "reference_fista_k_steps", k_steps)
    r = run(w)
    assert not r["correct"], r["check"]


@pytest.mark.parametrize("w", CELLS)
def test_half_of_the_batch_left_out(w):
    """The program solves the first half of the lanes and returns the
    other half as they came in (x0 = 0), counted and done."""
    solve = program(w)

    def half(batch):
        A, b, lam, Lf = batch
        h = A.shape[0] // 2
        xs, it, dn = solve((A[:h], b[:h], lam[:h], Lf[:h]))
        return (torch.cat([xs, torch.zeros_like(xs)]),
                torch.cat([it, torch.ones_like(it)]),
                torch.cat([dn, torch.ones_like(dn)]))

    r = run(w, solve=half)
    assert not r["correct"], r["check"]


@pytest.mark.parametrize("w", CELLS)
def test_an_answer_altered_where_it_is_produced(w):
    """One entry of one lane's answer moves by 1e-3 in one call."""
    solve = program(w)
    calls = []

    def altered(batch):
        xs, it, dn = solve(batch)
        calls.append(1)
        if len(calls) == 3:
            xs = xs.clone()
            xs[1, 2] += 1e-3
        return xs, it, dn

    r = run(w, solve=altered)
    assert not r["correct"], r["check"]
    assert r["check"]["recheck"]["value"] > r["check"]["recheck"]["limit"]


@pytest.mark.parametrize("w", CELLS)
def test_an_answer_that_is_not_a_number(w):
    solve = program(w)

    def nan(batch):
        xs, it, dn = solve(batch)
        xs = xs.clone()
        xs[0, 0] = float("nan")
        return xs, it, dn

    r = run(w, solve=nan)
    assert not r["correct"], r["check"]
