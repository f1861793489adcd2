"""``emd_sinkhorn_mcycles_per_pair.val``: the EMD kernel's Sinkhorn clock
cycles a pair, from the program's recorder. It reads the summed cycles over
the pairs in a traced run, and nothing without a trace, from a recorder
that holds no cycles (a program whose kernel does not count them), or
without a recorder."""

import sys
from types import SimpleNamespace

import pytest

import harness
from difffacto_torch.utils import trace

NAME = "emd_sinkhorn_mcycles_per_pair.val"


@pytest.fixture
def recorder():
    trace.reset()
    yield
    trace.reset()


def traced(seconds=10.0):
    return SimpleNamespace(traced_s=seconds, traced_counts={"protocols": 3}, counts={},
                           window_s=30.0, traced_spans=[], busy_s=9.0, kernels={})


def read(info):
    return harness.metric_reader(NAME).read(info)


def test_cycles_over_pairs(recorder):
    trace.defer(lambda: {"emd.pairs": 2112, "emd.sinkhorn_cycles": 2112 * 160_000_000})
    trace.defer(lambda: {"emd.pairs": 1984, "emd.sinkhorn_cycles": 1984 * 170_000_000})
    assert read(traced()) == pytest.approx((2112 * 160 + 1984 * 170) / 4096)


def test_nothing_without_a_trace(recorder):
    trace.defer(lambda: {"emd.pairs": 10, "emd.sinkhorn_cycles": 10 ** 9})
    assert read(traced(seconds=0.0)) is None


def test_nothing_where_the_kernel_counts_no_cycles(recorder):
    trace.defer(lambda: {"emd.pairs": 2112, "emd.rounds": 6_000_000, "emd.bids": 30_000_000,
                         "emd.capped_pairs": 20})
    assert read(traced()) is None
    trace.reset()
    assert read(traced()) is None


def test_nothing_without_the_recorder(recorder, monkeypatch):
    import difffacto_torch.utils

    trace.defer(lambda: {"emd.pairs": 10, "emd.sinkhorn_cycles": 10 ** 9})
    monkeypatch.delattr(difffacto_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "difffacto_torch.utils.trace", None)
    assert read(traced()) is None


def test_entry():
    m = next(m for m in harness.Spec().data["per_layer"] if m["name"] == NAME)
    assert m == {"name": NAME, "unit": "Mcycles/pair", "better": "lower",
                 "source": "program_counter", "layer": "EMD kernel", "moves": "val_pairs_per_s",
                 "workloads": ["gen_car.val_gen"]}
