"""The metrics that read the program's own spans, on spans and device
records made up by hand, and once over a traced run of the main path's
entry on the CPU."""

import time
import types

import pytest

from portbench import harness, spans, tiny, trace
from proxtpu_torch.utils import tracing

Span = tracing.Span
U = 1000          # the unit of the made-up times: 1 us, in ns
OFFSET = 7 * U    # the profiler's clock less perf_counter_ns's

# the window is [0, 1000) us; two calls
SPANS = [
    Span(1, "stream.dispatch", 0, 500, None, 1, None),
    Span(2, "loop.issue", 100, 200, 1, 1, 2),
    Span(3, "sync.loop_check", 200, 210, 1, 1, None),
    Span(4, "loop.issue", 210, 300, 1, 1, 3),
    Span(5, "sync.inner", 250, 260, 4, 1, None),
    Span(6, "host.gc", 270, 280, 4, 1, 2),
    Span(7, "sync.phase_count", 300, 320, 1, 1, None),
    Span(9, "stream.dispatch", 600, 900, None, 2, None),
    Span(10, "sync.x0_any", 700, 705, 9, 2, None),
    Span(11, "sync.loop_check", 855, 860, 9, 2, None),
]
# busy on the device (perf_counter's clock, before the offset)
DEVICE = [(50, 150), (230, 255), (265, 290), (330, 480), (640, 702),
          (800, 850)]


def made_up_run(monkeypatch, dropped=(0, -1), records=SPANS, device=DEVICE,
                end=1000):
    scaled = [r._replace(start_ns=r.start_ns * U, end_ns=r.end_ns * U)
              for r in records]
    monkeypatch.setattr(tracing, "records", lambda: scaled)
    monkeypatch.setattr(tracing, "dropped", lambda: dropped)
    recs = [(a * U + OFFSET, b * U + OFFSET, "void k(int)") for a, b in device]
    summary = trace.summarise(recs, OFFSET, end * U + OFFSET, [], [])
    summary["offset_ns"] = OFFSET
    return types.SimpleNamespace(start=0.0, end=end * U * 1e-9,
                                 calls=[None, None], trace=summary)


def read(name, run):
    return harness.load_module("metrics", name).read(run)


def test_host_syncs_a_call(monkeypatch):
    # five sync.* spans over two calls
    assert read("host_syncs.call", made_up_run(monkeypatch)) == 2.5


def test_host_us_a_step_is_self_time_less_nested_syncs(monkeypatch):
    # 100 us, and 90 less a nested sync and a collection of 10 each, over
    # 2 + 3 steps
    got = read("host_us.step", made_up_run(monkeypatch))
    assert got == pytest.approx((100 + 90 - 10 - 10) / 5)


def test_the_idle_under_dispatch_splits_into_refill_issue_and_setup(
        monkeypatch):
    run = made_up_run(monkeypatch)
    parts = spans.split(run)
    # refills: 210 -> 230 (cut by the next record), 260 -> 265, 320 ->
    # 330, 705 -> 800, 860 -> 900 (cut by the dispatch's end)
    assert parts["refill"] == pytest.approx(170e-6)
    # under loop.issue, outside refills: 150 -> 200, 255 -> 260, 290 -> 300
    assert parts["issue"] == pytest.approx(65e-6)
    # the rest of the dispatches' idle: 0 -> 50, 200 -> 210, 300 -> 320,
    # 480 -> 500, 600 -> 640, 702 -> 705, 850 -> 855
    assert parts["setup"] == pytest.approx(153e-6)
    # the three make the idle under the dispatches
    dispatches = [(OFFSET, 500 * U + OFFSET), (600 * U + OFFSET,
                                               900 * U + OFFSET)]
    idle = sum((b - a) * 1e-9 - trace.busy_between(run.trace, a, b)
               for a, b in dispatches)
    assert sum(parts[k] for k in ("refill", "issue", "setup")) == \
        pytest.approx(idle)
    assert read("device_idle.refill", run) == pytest.approx(17.0)
    assert read("device_idle.setup", run) == pytest.approx(15.3)


def test_a_sync_that_ends_inside_a_record_refills_from_its_end(monkeypatch):
    """The clocks' skew: the device's record ends 5 us after the read."""
    device = [(50, 150), (230, 255), (265, 290), (330, 480), (640, 710),
              (800, 850)]
    parts = spans.split(made_up_run(monkeypatch, device=device))
    assert parts["refill"] == pytest.approx((170 - 5) * 1e-6)


# a second second, in which the profiler's clock has moved 300 us away: the
# one sync's end lies 100 us inside the record the device ran before it
LATER = [
    Span(12, "stream.dispatch", 1_000_000, 1_000_900, None, 12, None),
    Span(13, "loop.issue", 1_000_100, 1_000_400, 12, 12, 4),
    Span(14, "sync.loop_check", 1_000_400, 1_000_500, 12, 12, None),
]
LATER_DEVICE = [(1_000_300, 1_000_600), (1_000_700, 1_000_800)]


def test_a_second_whose_sync_ends_lie_inside_records_is_left_out(
        monkeypatch):
    run = made_up_run(monkeypatch, records=SPANS + LATER,
                      device=DEVICE + LATER_DEVICE, end=1_500_000)
    ends, depths, leads = spans.sync_ends(run, spans.window_spans(run))
    assert list(depths) == [0, 0, 0, 0, 0, 100 * U]
    assert list(leads) == [60 * U, 5 * U, 30 * U, 3 * U, 10 * U, 0]
    # the window's first second alone
    assert [(int(a), int(b)) for a, b in zip(*spans.agreed(
        run, spans.window_spans(run)))] == [(OFFSET, 1_000_000 * U + OFFSET)]
    parts = spans.split(run)
    assert parts["window_s"] == pytest.approx(1.0)
    assert parts["refill"] == pytest.approx(170e-6)
    assert parts["issue"] == pytest.approx(65e-6)
    assert parts["setup"] == pytest.approx(153e-6)
    assert read("device_idle.refill", run) == pytest.approx(0.017)
    # the counts read the whole window
    assert read("host_syncs.call", run) == 3.0


def test_a_second_whose_sync_ends_lag_the_device_is_left_out(monkeypatch):
    """The profiler's clock 100 us behind: no sync end lies inside a record,
    but each lies 100 us after the device's last one."""
    late = [r._replace(end_ns=1_000_700) if spans.is_sync(r) else r
            for r in LATER]
    run = made_up_run(monkeypatch, records=SPANS + late,
                      device=DEVICE + [(1_000_300, 1_000_600)],
                      end=1_500_000)
    _, depths, leads = spans.sync_ends(run, spans.window_spans(run))
    assert depths[-1] == 0 and leads[-1] == 100 * U
    assert spans.split(run)["window_s"] == pytest.approx(1.0)


def test_no_second_with_agreeing_clocks_reads_no_idle_share(monkeypatch):
    later = [r._replace(start_ns=r.start_ns - 1_000_000,
                        end_ns=r.end_ns - 1_000_000) for r in LATER]
    device = [(a - 1_000_000, b - 1_000_000) for a, b in LATER_DEVICE]
    run = made_up_run(monkeypatch, records=later, device=device)
    assert spans.split(run) is None
    assert read("device_idle.refill", run) is None
    assert read("device_idle.setup", run) is None
    assert read("host_us.step", run) == pytest.approx(300 / 4)


@pytest.mark.parametrize("name", ["host_syncs.call", "host_us.step",
                                  "device_idle.refill", "device_idle.setup"])
def test_nothing_where_a_record_was_dropped_in_the_window(monkeypatch,
                                                          name):
    assert read(name, made_up_run(monkeypatch, dropped=(1, 40 * U))) is None
    # a record dropped before the window leaves it whole
    before = made_up_run(monkeypatch, dropped=(3, -5 * U))
    assert read(name, before) is not None
    # and a window without spans reads nothing
    assert read(name, made_up_run(monkeypatch, records=[])) is None


def test_no_device_record_reads_no_idle_share(monkeypatch):
    run = made_up_run(monkeypatch, device=[])
    assert read("device_idle.refill", run) is None
    assert read("device_idle.setup", run) is None
    assert read("host_syncs.call", run) == 2.5


def test_a_traced_cpu_run_of_the_main_path_reads_its_spans(monkeypatch):
    runs = []
    measure = harness.measure

    def keep(*args, **kwargs):
        runs.append(measure(*args, **kwargs))
        return runs[-1]

    monkeypatch.setattr(harness, "measure", keep)
    tracing.clear()
    cell = tiny.cell("lasso_200x400.b4096")
    result = harness.run_cell(cell, 2 ** 31 + 91, 0.0, True, "cpu",
                              time.perf_counter(), calls=3)
    assert result["correct"], result["check"]
    metrics = result["metrics"]
    assert metrics["host_syncs.call"]["value"] >= 2
    assert metrics["host_us.step"]["value"] > 0
    # no device record on the CPU
    assert "device_idle.refill" not in metrics
    run = runs[0][0]
    dispatches = [r for r in tracing.records()
                  if r.name == "stream.dispatch"]
    assert len(dispatches) == len(run.calls) == 3
    for c, r in zip(run.calls, dispatches):
        assert c.t_dispatch * 1e9 - 1e3 <= r.start_ns
        assert r.end_ns <= c.t_done * 1e9 + 1e3


CELLS = ["lasso_200x400.b4096", "lasso_512x1024.b64"]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_each_host_sync_of_a_call_on_the_card_has_its_span(card, workload):
    """PyTorch's sync debug mode (``chip_smoke.counting_syncs``) counts
    the host's waits over one warm call of the cell's entry, the stream's
    fence outside it: one ``sync.*`` span each."""
    import torch

    from chip_smoke import counting_syncs

    cell = harness.cell(harness.load_manifest(), workload)
    cfg = cell.config
    problems = harness.load_module("problems", cfg["problem"]["kind"])
    solve = harness.load_module("entries", cfg["entry"]).program(cfg)
    batch, = problems.make_batches(cfg["problem"], cell.traffic["lanes"], 1,
                                   2 ** 31 + 5, card)
    solve(batch)
    torch.cuda.synchronize()
    tracing.clear()
    with trace.Tracer():
        with counting_syncs() as syncs:
            solve(batch)
        torch.cuda.synchronize()
    spans_ = [r for r in tracing.records() if spans.is_sync(r)]
    assert syncs.n == len(spans_) > 0


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_sync_ends_follow_their_copies_in_the_agreed_seconds_on_the_card(
        monkeypatch, card, workload):
    """A 12-s traced window of the cell.  Each ``sync.*`` span holds one
    device-to-host copy (the profiler may lose a record in a thousand).  In
    the seconds that ``spans.agreed`` keeps, at most 1% of the sync ends,
    mapped with the harness's offset, lie more than 20 us before the end of
    the copy nearest them; the window keeps such seconds, and the four
    metrics read."""
    import numpy as np

    runs, copies = [], []
    measure = harness.measure
    device_records = trace.Tracer.device_records

    def keep(*args, **kwargs):
        runs.append(measure(*args, **kwargs))
        return runs[-1]

    def keep_copies(self):
        out = device_records(self)
        copies.extend(e for s, e, n in out if n.startswith("Memcpy DtoH"))
        return out

    monkeypatch.setattr(harness, "measure", keep)
    monkeypatch.setattr(trace.Tracer, "device_records", keep_copies)
    tracing.clear()
    cell = harness.cell(harness.load_manifest(), workload)
    result = harness.run_cell(cell, 2 ** 31 + 17, 12.0, True, str(card),
                              time.perf_counter())
    assert result["correct"], result["check"]
    assert {"host_syncs.call", "host_us.step", "device_idle.refill",
            "device_idle.setup"} <= set(result["metrics"])
    run = runs[0][0]
    window = spans.window_spans(run)
    ends, _, _ = spans.sync_ends(run, window)
    # every sync of the traced block lies in the window: one copy each
    assert len(ends) == sum(map(spans.is_sync, window))
    assert 0 <= len(ends) - len(copies) <= len(ends) // 1000
    copies = np.sort(np.array(copies, np.int64))
    j = np.clip(np.searchsorted(copies, ends), 1, len(copies) - 1)
    nearest = np.where(ends - copies[j - 1] <= copies[j] - ends,
                       copies[j - 1], copies[j])
    lag = ends - nearest
    ok_s, ok_e = spans.agreed(run, window)
    k = np.searchsorted(ok_s, ends, side="right") - 1
    agreed = (k >= 0) & (ends < ok_e[np.clip(k, 0, None)])
    assert agreed.any()
    assert (lag[agreed] < -spans.DEEP_NS).mean() <= spans.SHARE
