"""The per-layer metrics read from the program's recorder
(``difffacto_torch/utils/trace.py``): each, given a traced run's ``info``
and a recorder filled by hand on a clock that the test sets, returns the
number its docstring states; given the ``info`` of a run that was not
traced, it returns nothing even with the recorder full."""

import sys
from types import SimpleNamespace

import pytest

import harness
from difffacto_torch.utils import trace

SPEC = harness.Spec()
NEW = ("prepare_host_ms_per_batch.gen", "starved_step_pct.gen", "emd_rounds_per_pair.val",
       "emd_bids_per_pair.val", "emd_capped_pct.val", "resample_ms_per_protocol.val",
       "evaluate_self_ms_per_protocol.val")


@pytest.fixture
def clock(monkeypatch):
    """The recorder's clock, read as ``now[0]`` and moved by the test."""
    now = [100.0]
    monkeypatch.setattr(trace, "time", SimpleNamespace(perf_counter=lambda: now[0]))
    trace.reset()
    yield now
    trace.reset()


def traced(**counts):
    return SimpleNamespace(traced_s=10.0, traced_counts=counts, counts=counts, window_s=30.0,
                           traced_spans=[], busy_s=9.0, kernels={})


def span(clock, name, seconds, children=(), **attrs):
    """A span of ``seconds`` on the clock, its children (name, seconds)
    inside it one after another from its start."""
    with trace.recording(), trace.span(name, **attrs):
        start = clock[0]
        for child, s in children:
            with trace.span(child):
                clock[0] += s
        clock[0] = start + seconds


def read(name, info):
    return harness.metric_reader(name).read(info)


def test_prepare_host_ms_per_batch(clock):
    for seconds in (0.030, 0.050, 0.040):
        span(clock, "sample_generation", 0.3, [("prepare_generation", seconds)])
    span(clock, "resample", 1.0)  # not read
    assert read("prepare_host_ms_per_batch.gen", traced(batches=4)) == pytest.approx(30.0)


def test_starved_step_pct(clock):
    trace.count("chain.steps", 300)
    trace.count("chain.starved_steps", 6)
    assert read("starved_step_pct.gen", traced(batches=3)) == pytest.approx(2.0)
    trace.reset()
    trace.count("chain.steps", 300)  # no step starved
    assert read("starved_step_pct.gen", traced(batches=3)) == 0.0


def test_emd_work_per_pair(clock):
    trace.count("emd.pairs", 2112)
    trace.defer(lambda: {"emd.pairs": 2000, "emd.rounds": 4_112_000, "emd.bids": 41_120_000,
                         "emd.capped_pairs": 41})
    info = traced(protocols=3)
    assert read("emd_rounds_per_pair.val", info) == pytest.approx(4_112_000 / 4112)
    assert read("emd_bids_per_pair.val", info) == pytest.approx(10_000.0)
    assert read("emd_capped_pct.val", info) == pytest.approx(100 * 41 / 4112)


def test_resample_ms_per_protocol(clock):
    for _ in range(3):
        span(clock, "evaluate_gen", 1.0, [("resample", 0.004), ("resample", 0.002),
                                          ("sweep", 0.5)])
    assert read("resample_ms_per_protocol.val", traced(protocols=3)) == pytest.approx(6.0)


def test_evaluate_self_ms_per_protocol(clock):
    """The roots' wall less their resample and sweep children: other spans
    inside, and children of other spans, are not taken off."""
    span(clock, "evaluate_gen", 1.0, [("resample", 0.1), ("sweep", 0.5), ("sweep", 0.3),
                                      ("other", 0.05)])
    span(clock, "evaluate_gen", 2.0, [("sweep", 1.9)])
    span(clock, "sample_generation", 5.0, [("sweep", 1.0)])
    got = read("evaluate_self_ms_per_protocol.val", traced(protocols=2))
    assert got == pytest.approx(1e3 * (0.1 + 0.1) / 2)


@pytest.mark.parametrize("name", NEW)
def test_nothing_read_without_a_trace(clock, name):
    """Full recorder, but the run was not traced: nothing."""
    for _ in range(2):
        span(clock, "sample_generation", 0.3, [("prepare_generation", 0.05)])
        span(clock, "evaluate_gen", 1.0, [("resample", 0.01), ("sweep", 0.5)])
    for k in ("chain.steps", "chain.starved_steps", "emd.pairs", "emd.rounds", "emd.bids",
              "emd.capped_pairs"):
        trace.count(k, 10)
    cell = SPEC.cell(next(m for m in SPEC.data["per_layer"] if m["name"] == name)
                     ["workloads"][0])
    empty = harness.info_for(SPEC.config(cell["config"]), SPEC.traffic(cell["traffic"]), 1.0,
                             {"batches": 2, "protocols": 2})
    assert read(name, empty) is None
    assert read(name, traced(batches=2, protocols=2)) is not None


@pytest.mark.parametrize("name", NEW)
def test_nothing_read_from_an_empty_recorder(clock, name):
    assert read(name, traced(batches=2, protocols=2)) is None


@pytest.mark.parametrize("name", NEW)
def test_nothing_read_from_a_program_without_the_recorder(clock, monkeypatch, name):
    """A checkout whose program has no recorder: the reader gives nothing and
    raises nothing."""
    import difffacto_torch.utils

    span(clock, "sample_generation", 0.3, [("prepare_generation", 0.05)])
    span(clock, "evaluate_gen", 1.0, [("resample", 0.01)])
    for k in ("chain.steps", "emd.pairs"):
        trace.count(k, 10)
    monkeypatch.delattr(difffacto_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "difffacto_torch.utils.trace", None)
    with pytest.raises(ImportError):
        from difffacto_torch.utils import trace as _  # noqa: F401
    assert read(name, traced(batches=2, protocols=2)) is None


@pytest.mark.parametrize("name", NEW)
def test_listed_for_its_one_cell(name):
    m = next(m for m in SPEC.data["per_layer"] if m["name"] == name)
    assert len(m["workloads"]) == 1 and m["better"] == "lower"
    assert m["source"] == ("program_span" if "_ms_per_" in name else "program_counter")
    assert m["workloads"][0].endswith(".sample" if name.endswith(".gen") else ".val_gen")
