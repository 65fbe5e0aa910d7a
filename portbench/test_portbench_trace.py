"""The reduction of a device trace to the traced run's numbers, on records
made up by hand."""

import types

import pytest

from portbench import harness, trace

# ns; the window is [0, 100)
RECORDS = [
    (5, 15, "void fista_packed_step_kernel<512, 1>(float const*, int)"),
    (10, 20, "void fista_packed_step_kernel<512, 1>(float const*, int)"),
    (30, 40, "void at::native::vectorized_elementwise_kernel<4>(int)"),
    (60, 65, "Memcpy DtoH (Device -> Pageable)"),
    (95, 120, "void fista_step_kernel<512, 1, float>(float const*)"),
    (-10, -5, "void before_the_window(int)"),
]
ENTRY = [(0, 50)]
NEXTS = [(0, 70)]


def test_summary():
    s = trace.summarise(RECORDS, 0, 100, ENTRY, NEXTS)
    assert s["window_s"] == pytest.approx(100e-9)
    # union: [5, 20) + [30, 40) + [60, 65) + [95, 100)
    assert s["busy_s"] == pytest.approx(35e-9)
    # kernels: 10 + 10 + 10 + 5, overlaps counted twice; the copy is not
    # a kernel
    assert s["kernel_s"] == pytest.approx(35e-9)
    idle = s["idle_by_span"]
    assert idle["entry"] == pytest.approx(25e-9)
    assert idle["fence"] == pytest.approx(15e-9)
    assert idle["between"] == pytest.approx(25e-9)
    assert sum(idle.values()) == pytest.approx(100e-9 - s["busy_s"])
    assert s["gaps"][0] == ("between", pytest.approx(30e-9))
    assert s["gaps"][1] == ("fence", pytest.approx(20e-9))


def test_lost_records_and_breakdown():
    s = trace.summarise(RECORDS, 0, 100, ENTRY, NEXTS)
    entry = harness.load_module("entries", "packed_tail")
    lost = trace.lost_records(s, {"fused_fista_packed_step.launches": 3,
                                  "fused_fista_full_step.launches": 1,
                                  "read_reduce.launches": 0,
                                  "fused_pg_box_step.launches": 2},
                              entry.COUNTED_KERNELS)
    assert lost == {"fused_fista_packed_step.launches": 1,
                    "fused_fista_full_step.launches": 0}
    b = trace.breakdown(s)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    assert b["device_ops"][0] == [
        "fista_packed_step_kernel<512, 1>(float const*, int)",
        pytest.approx(20e-9)]
    assert [g[0] for g in b["idle_gaps"][:3]] == [
        "idle under entry", "idle under fence", "idle under between"]


@pytest.mark.parametrize("a, b, busy", [(0, 100, 35), (0, 50, 25),
                                        (12, 35, 13), (40, 60, 0),
                                        (62, 97, 5)])
def test_busy_between(a, b, busy):
    s = trace.summarise(RECORDS, 0, 100, ENTRY, NEXTS)
    assert trace.busy_between(s, a, b) == pytest.approx(busy * 1e-9)


def test_an_empty_trace_reads_no_busy_time():
    s = trace.summarise([], 0, 100, ENTRY, NEXTS)
    assert s["busy_s"] == 0.0 and s["kernel_s"] == 0.0
    assert trace.busy_between(s, 0, 100) == 0.0


def test_chunk_lines():
    """The window in chunks: the calls whose result came in each, their
    certified problems and rate, and the device's busy share when traced;
    the last call, at the window's end, falls in the last chunk."""
    calls = [types.SimpleNamespace(t_done=t, certified=10)
             for t in (100.5, 101.0, 104.9, 105.0, 107.0)]
    run = types.SimpleNamespace(start=100.0, end=107.0, calls=calls,
                                trace=None)
    lines = harness.chunk_lines(run)
    assert len(lines) == 2
    assert "3 calls, 30 certified, 6.0/s" in lines[0]
    assert "2 calls, 20 certified, 10.0/s" in lines[1]
    # busy [5, 20) + [30, 40) ns of a window of 100 ns in chunks of 50
    run = types.SimpleNamespace(
        start=0.0, end=100e-9, calls=calls[:0],
        trace=dict(trace.summarise(RECORDS, 0, 100, ENTRY, NEXTS),
                   offset_ns=0))
    lines = harness.chunk_lines(run, seconds=50e-9)
    assert lines[0].endswith("device busy 50.0%")
    assert lines[1].endswith("device busy 20.0%")
