"""``BENCHMARK.json`` against the benchmark's contract: keys, names, units,
limits, files, and which cells report which metric."""

import json
import re

import pytest

from portbench import harness

M = harness.load_manifest()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_.\-/]{1,200}")
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(M)) <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert PATH.fullmatch(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
        assert (harness.ROOT / p).is_dir()
    assert len(M["command"]) <= 32
    for word in M["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word and "\t" not in word
        assert not word.startswith("/") and ".." not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in M["paths"])


def test_run_seconds_fits_the_check_with_24_cells():
    s = M["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def all_names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in M[group]:
            yield e["name"]
    for w in M["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in M["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(all_names())))
def test_names_are_plain(name):
    assert NAME.fullmatch(name), name


def test_names_are_unique():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in M[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for g in ("end_to_end", "per_layer") for m in M[g]]
    assert len(metrics) == len(set(metrics))


def test_configs():
    used = {w["config"] for w in M["workloads"]}
    files = set()
    assert 1 <= len(M["configs"]) <= 24
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in M["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        body = json.loads((harness.ROOT / c["file"]).read_text())
        assert body["source"] == c["source"]
        assert body["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for text in (c["source"], c["why"]):
            assert 1 <= len(text) <= 200 and "\n" not in text


def test_workloads():
    assert 1 <= len(M["workloads"]) <= 24
    pairs = set()
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))


def test_four_chip_share():
    four = sum(w["chips"] == 4 for w in M["workloads"])
    assert four <= max(1, len(M["workloads"]) // 4)


def test_metrics():
    e2e = {m["name"] for m in M["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    assert 1 <= len(M["per_layer"]) <= 128
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower",
                                                             "higher")
        if m["name"].endswith("_roofline") or m["name"].startswith(
                "roofline"):
            assert m["unit"] == "%"


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in M["workloads"]:
        e2e = [m["name"] for m in M["end_to_end"]
               if harness.applies(m, w["name"])]
        layers = [m for m in M["per_layer"] if harness.applies(m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2 and layers


def test_moves_is_reported_wherever_the_metric_is():
    """A per-layer metric's cells each report the end-to-end metric that
    it moves."""
    cells = [w["name"] for w in M["workloads"]]
    for m in M["per_layer"]:
        target = next(e for e in M["end_to_end"] if e["name"] == m["moves"])
        for w in cells:
            if harness.applies(m, w):
                assert harness.applies(target, w), (m["name"], w)
        for w in m.get("workloads", []):
            assert w in cells


def test_layers_name_the_same_layer_the_same_way():
    layers = {m["layer"] for m in M["per_layer"]}
    assert len({la.lower() for la in layers}) == len(layers)


@pytest.mark.parametrize("w", [w["name"] for w in M["workloads"]])
def test_cell_files_are_found(w):
    c = harness.cell(M, w)
    assert set(c.limits) == {"recheck", "iters_gap", "done_gap"}
    for m, _ in c.metrics:
        assert (harness.HERE / "metrics" / f"{m['name']}.py").is_file()
