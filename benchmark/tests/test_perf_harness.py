"""The harness: BENCHMARK.json against its schema, the files it finds
by name, the last line's keys and names, the top-level-name check."""

import json
import os
import re
import sys

import pytest
import torch

import run
from harness import common
from perf_tiny import tiny_cell

BENCH = json.load(open(os.path.join(common.ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_json_keeps_its_schema():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    bench = BENCH
    cells = [w["name"] for w in bench["workloads"]]
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["name"] not in names
        names.add(m["name"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_finds_its_files(cell):
    """A cell's configuration, traffic mix, limits and every metric it
    reports are files found by name."""
    c = common.find_cell(cell)
    assert c.config and run.work_class(c.traffic["loop"]) and c.limits
    assert any(n == "setup_s" for n, _ in c.end_to_end)
    assert len(c.end_to_end) >= 2 and c.per_layer
    for name, _ in c.end_to_end + c.per_layer:
        assert callable(common.metric_reader(name))


def test_a_new_metric_is_a_new_file(tmp_path, monkeypatch):
    """A per-layer metric listed without workloads is read in every cell
    that reports the metric it moves, from metrics/<name>.py."""
    bench = json.loads(json.dumps(BENCH))
    moves = next(n for n, _ in common.find_cell(CELLS[0]).end_to_end
                 if n != "setup_s")
    bench["per_layer"].append({"name": "spans_a_frame", "unit": "spans",
                               "better": "lower", "source": "host_clock",
                               "layer": "engine", "moves": moves})
    c = common.find_cell(CELLS[0], bench)
    assert ("spans_a_frame", "spans") in c.per_layer
    metrics = tmp_path / "metrics"
    metrics.mkdir()
    (metrics / "spans_a_frame.py").write_text(
        "def read(run):\n    return len(run.times)\n")
    monkeypatch.setattr(common, "BENCH_DIR", str(tmp_path))
    assert common.metric_reader("spans_a_frame")(
        common.Run(c, 0.0, 1, 1.0, {}, {})) == 0


@pytest.mark.parametrize("cell", CELLS)
def test_last_line_keys_and_names(cell, tmp_path):
    c = tiny_cell(cell)
    out = run.run_cell(c, 2**31 + 3, 0.5, False, torch.device("cpu"),
                       work_dir=str(tmp_path / "d"))
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] is True and out["attempted"] > 0
    assert set(out["metrics"]) == {n for n, _ in c.end_to_end}
    assert set(out["checks"]) == set(c.limits)
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    json.dumps(out, allow_nan=False)
    assert not os.path.exists(tmp_path / "d")


def test_top_level_names_are_compared_whole(monkeypatch):
    for name in ("lidar_transfer_tpu_torch", "lidar_transfer_tpu_torch.ops",
                 "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert not set(common.jax_modules()) & {
        "lidar_transfer_tpu_torch", "jaxtyping", "flaxen"}
    for name in ("jax", "jaxlib.xla", "flax.linen", "lidar_transfer_tpu.ops"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert common.jax_modules() == ["flax", "jax", "jaxlib",
                                    "lidar_transfer_tpu"]


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    pat = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|flax|"
                     r"lidar_transfer_tpu)(\.|\s|$)", re.M)
    for dirpath, _, files in os.walk(common.BENCH_DIR):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(dirpath, f)).read()
                assert not pat.search(text), f


def test_without_a_card_the_run_prints_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                     "1"]) != 0
    assert "{" not in capsys.readouterr().out


@pytest.mark.parametrize("limits", ["one without a reading", "none"])
def test_a_limit_without_a_reading_is_not_correct(limits, tmp_path):
    """A limits file whose keys the check does not read, or that has no
    key, makes the run not correct."""
    c = tiny_cell(CELLS[-1])
    c.limits = (dict(c.limits, no_such_reading=1.0)
                if limits != "none" else {})
    out = run.run_cell(c, 2**31 + 5, 0.5, False, torch.device("cpu"),
                       work_dir=str(tmp_path / "d"))
    assert out["correct"] is False
    if limits != "none":
        assert out["checks"]["no_such_reading"]["value"] is None
