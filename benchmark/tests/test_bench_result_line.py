"""A whole run on the CPU at a tiny size, the chip's look skipped: the
result object has every key it must, the compared numbers come last."""

import json

import pytest
import torch

import harness
from conftest import TINY_SAMPLE


def run_tiny(tiny, monkeypatch, trace=False, limits=None):
    spec = harness.Spec()
    cfg = tiny()
    monkeypatch.setattr(spec, "config", lambda name: cfg)
    monkeypatch.setattr(harness.Spec, "traffic", staticmethod(lambda name: dict(TINY_SAMPLE)))
    if limits is not None:
        monkeypatch.setattr(harness.Spec, "limits", staticmethod(lambda cell: limits))
    return harness.run_cell(spec, "gen_chair.sample", 2**31 + 99, 0.2, trace,
                            torch.device("cpu"), harness.time.perf_counter())


def test_result_line_shape(tiny, monkeypatch):
    result, checks = run_tiny(tiny, monkeypatch, limits={"gen_rel_l2": 0.05})
    line = json.dumps(harness.plain_json(result))
    back = json.loads(line)
    assert list(back)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(back)[-1] == "checks"
    assert back["correct"] is True and back["failed"] == 0 and back["attempted"] > 0
    assert set(back["metrics"]) == {"gen_shapes_per_s", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in back["metrics"].values())
    assert set(back["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(back["checks"]) == {"gen_rel_l2"} and back["checks"]["gen_rel_l2"]["limit"] == 0.05


def test_traced_line_has_per_layer_metrics_only(tiny, monkeypatch):
    result, _ = run_tiny(tiny, monkeypatch, trace=True)
    # on the CPU no trace is read: only the host-clock metric is there
    assert set(result["metrics"]) == {"gen_mfu"}


def test_judge_refuses_missing_and_non_finite():
    ok, lines = harness.judge({"a": 0.1, "b": float("nan")}, {"a": 0.2, "b": 1.0, "c": 1.0})
    assert not ok and set(lines) == {"a", "b", "c"}
    assert harness.judge({"a": 0.1}, {"a": 0.2})[0]
    assert json.loads(json.dumps(harness.plain_json({"v": float("inf")}))) == {"v": "inf"}


def test_forbidden_modules_by_whole_name():
    assert harness.forbidden_modules(["jax.numpy", "difffacto_torch.ops", "flax"]) == ["flax", "jax"]
    assert harness.forbidden_modules(["difffacto_torch", "jaxtyping"]) == []


def test_idle_gaps_by_host_span():
    events = [("k", 0.0, 10.0), ("k", 20.0, 30.0), ("k", 30.0, 35.0)]
    spans = [("draws", 10e-6, 20e-6)]
    gaps = harness.idle_gaps(events, spans, offset_us=0.0, t_end_us=40.0)
    assert [g[0] for g in gaps] == ["draws", "between spans"]
    assert [g[1] for g in gaps] == pytest.approx([10e-6, 5e-6])
    assert harness.device_busy(events) == 25.0
