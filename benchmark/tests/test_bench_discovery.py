"""Every name in BENCHMARK.json leads to its file, and the file is what the
harness takes: configurations, traffic mixes and their loops, limits and
per-layer metric readers."""

import json
import os
import re
from types import SimpleNamespace

import pytest

import harness

SPEC = harness.Spec()
DATA = SPEC.data
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys():
    assert set(DATA) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert DATA["paths"] == ["benchmark"]
    assert 1 <= DATA["run_seconds"] <= 51


@pytest.mark.parametrize("cfg", DATA["configs"], ids=lambda c: c["name"])
def test_config_found(cfg):
    assert NAME.match(cfg["name"]) and cfg["file"].startswith("benchmark/configs/")
    loaded = SPEC.config(cfg["name"])
    assert loaded["name"] == cfg["name"] and loaded["reduced"] == cfg["reduced"]
    assert all(k in loaded for k in cfg["reduced"])
    assert loaded["model"]["type"] == "AnchorDiffAE"


@pytest.mark.parametrize("cell", DATA["workloads"], ids=lambda c: c["name"])
def test_cell_found(cell):
    assert NAME.match(cell["name"]) and cell["chips"] in (1, 4) and len(cell["why"]) <= 200
    traffic = SPEC.traffic(cell["traffic"])
    drv = harness.loop(traffic["loop"])
    assert all(callable(getattr(drv, f)) for f in ("setup", "step", "check"))
    limits = SPEC.limits(cell["name"])
    assert limits and all(isinstance(v, (int, float)) for v in limits.values())
    reported = {m["name"] for m in SPEC.end_to_end(cell["name"])}
    assert "setup_s" in reported and len(reported) >= 2
    assert reported - {"setup_s"} <= set(traffic["rates"])
    assert SPEC.per_layer(cell["name"])


@pytest.mark.parametrize("metric", DATA["per_layer"], ids=lambda m: m["name"])
def test_per_layer_reader_found(metric):
    reader = harness.metric_reader(metric["name"])
    assert callable(reader.read)
    e2e = {m["name"]: m for m in DATA["end_to_end"]}
    assert metric["moves"] in e2e
    for cell in metric["workloads"]:
        assert cell in e2e[metric["moves"]]["workloads"]
    # a reader that finds nothing to read returns nothing
    empty = harness.info_for(SPEC.config(SPEC.cell(metric["workloads"][0])["config"]),
                             SPEC.traffic(SPEC.cell(metric["workloads"][0])["traffic"]), 1.0, {})
    assert reader.read(empty) is None


def test_layers_named_alike():
    layers = {}
    for m in DATA["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_bounds():
    for m in DATA["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert next(m for m in DATA["end_to_end"] if m["name"] == "setup_s")["bound"] == 0.25


def test_new_pieces_found_by_name(tmp_path, monkeypatch):
    """A cell added as files alone: its traffic, loop, limits and metric
    are found by name, with no edit to any file that is there."""
    (tmp_path / "traffic").mkdir()
    (tmp_path / "loops").mkdir()
    (tmp_path / "limits").mkdir()
    (tmp_path / "metrics").mkdir()
    (tmp_path / "traffic" / "later.json").write_text(json.dumps({"loop": "later"}))
    (tmp_path / "loops" / "later.py").write_text(
        "def setup(run): return 1\ndef step(run, st, i): return {}\n"
        "def check(run, st, control=False): return {}, 0\n")
    (tmp_path / "limits" / "gen_chair.later.json").write_text(json.dumps({"x": 1.0}))
    (tmp_path / "metrics" / "later_pct.gen.py").write_text("def read(info): return 42.0\n")
    monkeypatch.setattr(harness, "BENCH", tmp_path)
    assert SPEC.traffic("later") == {"loop": "later"}
    assert harness.loop("later").setup(None) == 1
    assert SPEC.limits("gen_chair.later") == {"x": 1.0}
    assert harness.metric_reader("later_pct.gen").read(SimpleNamespace()) == 42.0
