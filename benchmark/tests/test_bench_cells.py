"""The benchmark's files: every cell, configuration, mix and metric of
BENCHMARK.json found by name; the file within the contract's limits; a
cell added as new files in a copy runs without an edit; the last line's
shape."""

import json
import os
import re

import pytest

from benchmark.core import cells, harness
from benchmark.tests import tiny

SPEC = cells.load_json(os.path.join(tiny.REPO, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELL_NAMES = [w["name"] for w in SPEC["workloads"]]


def test_benchmark_json_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names = [m["name"] for m in metrics] + CELL_NAMES + \
        [c["name"] for c in SPEC["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert set(m["workloads"]) <= set(CELL_NAMES)
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("name", CELL_NAMES)
def test_cell_files_found_by_name(name):
    cell = cells.find(name)
    kind = cell.kind()
    for fn in ("make_inputs", "setup", "window", "release", "check",
               "control"):
        assert callable(getattr(kind, fn))
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    assert cell.check["limits"]
    for m in cell.per_layer:
        assert callable(cell.reader(m["name"]).read)
    moved = {m["name"] for m in cell.end_to_end}
    assert all(m["moves"] in moved for m in cell.per_layer)


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    path = os.path.join(tiny.REPO, config["file"])
    assert config["file"].startswith("benchmark/")
    params = cells.load_json(path)
    for key in config["reduced"]:
        assert key in params and key in params["reduced"]
    assert config["source"].startswith("https://")


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_metric_reader_reads_nothing_from_an_empty_trace(metric):
    cell = cells.find(next(w for w in SPEC["per_layer"]
                           if w["name"] == metric)["workloads"][0])
    from benchmark.reference import geometry
    ctx = harness.Context([], [], 1.0, 0, cell, geometry.derive(cell.config))
    assert cell.reader(metric).read(ctx) is None
    assert ctx.notes


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return tiny.make_copy(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("name", sorted(tiny.CELLS))
def test_added_cell_runs_without_an_edit(copy, name):
    """A cell added as files and entries in a copy runs on the CPU, and its
    result line has the contract's shape, its checks last."""
    for traced in (False, True):
        r = harness.run(name, 2**33 + 5, 0.5, traced, device="cpu",
                        root=copy)
        assert list(r)[-1] == "checks" and r["checks"]
        assert r["correct"] is True, r["checks"]
        assert {"correct", "attempted", "failed", "metrics",
                "device"} <= set(r)
        assert r["attempted"] > 0 and r["failed"] == 0
        assert set(r["device"]) >= {"platform", "kind", "count",
                                    "memory_peak_bytes"}
        cell = cells.find(name, copy)
        if traced:
            assert {"busy_s", "window_s"} <= set(r["device"])
            assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        else:
            assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end}
        for v in r["checks"].values():
            assert set(v) == {"value", "limit"}
        json.dumps(r)
