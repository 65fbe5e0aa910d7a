"""Everything is found by its name: a copy of the benchmark gains a cell, a
configuration, a mix with a generator of its own, an entry and a metric
by new files and new entries of ``BENCHMARK.json`` alone, and runs it; so
does a cell of a problem kind that is not a lasso (box QPs, with a problem
module, an entry and a reference of their own); and no run loads JAX or
the JAX package."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from portbench import harness

REPO = harness.ROOT

NEW_FILES = {
    "configs/dummy_cfg.json": json.dumps({
        "name": "dummy_cfg", "source": "a test's own", "reduced": [],
        "problem": {"kind": "lasso", "M": 12, "N": 24, "lam_ratio": 0.1,
                    "dtype": "float32"},
        "entry": "dummy_entry", "solver": {"tol": 1e-5, "maxit": 2000},
        "gate": 1.1e-5, "reference_batches": 1}),
    "traffic/dummy_mix.json": json.dumps({
        "generator": "dummy_gen", "lanes": 8, "pool_batches": 3,
        "depth": 1}),
    "limits/dummy_cell.json": json.dumps({
        "recheck": 3e-4, "iters_gap": 0.2, "done_gap": 0}),
    "generators/dummy_gen.py": textwrap.dedent('''
        """The pool, sent in reverse order."""
        from . import pool


        class Reverse(pool.Pool):
            def index(self, i):
                return len(self.batches) - 1 - i % len(self.batches)


        def make(problems, config, traffic, seed, device):
            p = pool.make(problems, config, traffic, seed, device)
            return Reverse(p.batches, p.depth)
        '''),
    "entries/dummy_entry.py": textwrap.dedent('''
        """The one-step solver, without restart."""
        import torch

        from .. import reference as ref


        def program(config):
            from proxtpu_torch.kernels.lasso import solve_lasso_batch

            s = config["solver"]
            return lambda b: solve_lasso_batch(*b, s["tol"],
                                               maxit=s["maxit"])


        def reference(config, prec="exact", dtype=torch.float64):
            s = config["solver"]
            return lambda b: ref.fista(*b, s["tol"], s["maxit"], prec=prec,
                                       dtype=dtype)
        '''),
    "configs/dummy_qp.json": json.dumps({
        "name": "dummy_qp", "source": "a test's own", "reduced": [],
        "problem": {"kind": "dummy_boxqp", "n": 24},
        "entry": "dummy_qp_entry", "solver": {"tol": 1e-4, "maxit": 5000},
        "gate": 1.1e-4, "reference_batches": 2}),
    "limits/dummy_qp_cell.json": json.dumps({
        "recheck": 1e-3, "iters_gap": 0.2, "done_gap": 0}),
    "problems/dummy_boxqp.py": textwrap.dedent('''
        """Box QPs: min 1/2 x^T Q x + q^T x over lo <= x <= hi, a batch
        (Q, q, lo, hi, Lip); an answer (x, iters, done)."""
        import torch


        def make_batches(problem, lanes, count, seed, device):
            n = problem["n"]
            gen = torch.Generator(device=device)
            gen.manual_seed(int(seed) % (1 << 63))
            out = []
            for _ in range(count):
                G = torch.randn((lanes, n, n), generator=gen,
                                device=device, dtype=torch.float64)
                Q = G.mT @ G / n + 0.1 * torch.eye(n, dtype=torch.float64)
                Lip = torch.linalg.eigvalsh(Q)[:, -1] * (1 + 1e-6)
                q = torch.randn((lanes, n), generator=gen, device=device)
                lo = torch.full((lanes,), -0.5, device=device)
                out.append((Q.float(), q, lo, -lo, Lip.float()))
            return out


        def counts(out):
            return out[1], out[2].bool()


        def step(batch, x):
            Q, q, lo, hi, Lip = (t.double() for t in batch)
            gam = 0.95 / Lip
            g = (Q @ x.double().unsqueeze(2)).squeeze(2) + q
            z = torch.clamp(x.double() - gam[:, None] * g, lo[:, None],
                            hi[:, None])
            return z, torch.amax(torch.abs(x.double() - z), 1) / gam


        def certificate(batch, out):
            return torch.nan_to_num(step(batch, out[0])[1],
                                    nan=float("inf"))
        '''),
    "entries/dummy_qp_entry.py": textwrap.dedent('''
        """The one-step projected gradient on box QPs."""
        import torch

        from ..problems import dummy_boxqp

        COUNTED_KERNELS = {"fused_pg_box_step.launches": "pg_k_steps"}


        def program(config):
            from proxtpu_torch.kernels.box_qp import solve_box_qp_batch

            s = config["solver"]
            return lambda b: solve_box_qp_batch(*b, s["tol"],
                                                maxit=s["maxit"])


        def reference(config, prec="exact", dtype=torch.float64):
            s = config["solver"]

            def solve(batch):
                x = torch.zeros(batch[1].shape, dtype=torch.float64)
                x, res = dummy_boxqp.step(batch, x)
                done = res <= s["tol"]
                iters = torch.ones(done.shape, dtype=torch.int32)
                k = 1
                while k < s["maxit"] and not bool(done.all()):
                    k += 1
                    z, res = dummy_boxqp.step(batch, x)
                    x = torch.where(done[:, None], x, z)
                    iters = torch.where(done, iters, k)
                    done = done | (res <= s["tol"])
                return x, iters, done

            return solve
        '''),
    "metrics/dummy.calls.py": textwrap.dedent('''
        """Calls in the window."""


        def read(run):
            return len(run.calls)
        '''),
}


def copy_with_dummies(tmp_path):
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, text in NEW_FILES.items():
        (tmp_path / "portbench" / rel).write_text(text)
    m = harness.load_manifest()
    m["configs"].append({"name": "dummy_cfg", "source": "a test's own",
                         "file": "portbench/configs/dummy_cfg.json",
                         "reduced": [], "why": "a test"})
    m["configs"].append({"name": "dummy_qp", "source": "a test's own",
                         "file": "portbench/configs/dummy_qp.json",
                         "reduced": [], "why": "a test"})
    m["workloads"].append({"name": "dummy_cell", "config": "dummy_cfg",
                           "traffic": "dummy_mix", "chips": 1,
                           "why": "a test"})
    m["workloads"].append({"name": "dummy_qp_cell", "config": "dummy_qp",
                           "traffic": "dummy_mix", "chips": 1,
                           "why": "a test"})
    m["end_to_end"].append({"name": "dummy.calls", "unit": "calls",
                            "better": "higher", "bound": 0.25,
                            "source": "host_clock",
                            "workloads": ["dummy_cell", "dummy_qp_cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))


SCRIPT = textwrap.dedent('''
    import json, sys, time
    from portbench import harness
    m = harness.load_manifest()
    cell = harness.cell(m, sys.argv[1])
    for k, v in json.loads(sys.argv[2]).items():
        getattr(cell, k).update(v)
    r = harness.run_cell(cell, 2 ** 31 + 3, 0.0, False, "cpu",
                         time.perf_counter(), calls=4)
    print(json.dumps({"here": str(harness.HERE), "result": r,
                      "banned": harness.banned_modules()}))
    ''')


def run_there(root, workload, overrides=None):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(root),
                                                       str(REPO)]))
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", SCRIPT, workload,
                          json.dumps(overrides or {})], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("workload", ["dummy_cell", "dummy_qp_cell"])
def test_a_new_cell_of_new_files_runs_and_nothing_else_changed(tmp_path,
                                                               workload):
    copy_with_dummies(tmp_path)
    got = run_there(tmp_path, workload)
    assert got["here"] == str(tmp_path / "portbench")
    r = got["result"]
    assert r["correct"], r["check"]
    assert r["attempted"] == 4 * 8 and r["failed"] == 0
    assert r["check"]["recheck"]["value"] > 0
    assert r["metrics"]["dummy.calls"]["value"] == 4
    assert set(r["metrics"]) == {"dummy.calls", "problems_per_s",
                                 "batch_s.p90", "setup_s"}
    # the files the benchmark had are the same bytes
    for path in harness.HERE.rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            rel = path.relative_to(harness.HERE)
            assert (tmp_path / "portbench" / rel).read_bytes() == \
                path.read_bytes(), rel


def test_a_run_loads_no_jax_nor_the_jax_package():
    """A whole run of the flagship cell at a small size, in a fresh
    process; then no module of JAX, jaxlib, flax, the JAX package or its
    harness is loaded."""
    got = run_there(REPO, "lasso_200x400.b4096", {
        "config": {"problem": {"kind": "lasso", "M": 20, "N": 40,
                               "lam_ratio": 0.1, "dtype": "float32"},
                   "solver": {"tol": 1e-5, "maxit": 2000, "k1": 24,
                              "tail": 4, "restart": True}},
        "traffic": {"lanes": 16, "pool_batches": 2}})
    assert got["result"]["correct"]
    assert got["banned"] == []


@pytest.mark.parametrize("name, banned", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax.linen", True), ("proxtpu", True), ("proxtpu.kernels", True),
    ("bench", True), ("benchmarks.kernel_sweep", True),
    ("proxtpu_torch", False), ("proxtpu_torch.kernels.lasso", False),
    ("jaxtyping", False), ("benchmark", False), ("portbench", False)])
def test_banned_names_are_compared_whole(name, banned):
    assert (harness.banned_modules({name: None}) == [name]) == banned
