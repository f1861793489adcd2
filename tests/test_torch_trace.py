"""The port's recorder (difffacto_torch/utils/trace.py): spans and counters,
when they are recorded, and the spans and counts the generation, the val_gen
protocol, the chain and the eval EMD leave in it. CPU only, at tiny sizes."""

import os
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

torch.set_num_threads(1)

from difffacto_torch import Config, MODELS, build_from_cfg, sample_generation
from difffacto_torch.metrics import eval as ev
from difffacto_torch.ops import emd as te
from difffacto_torch.ops.emd_hybrid import emd_assignment_hybrid_reference
from difffacto_torch.runner import evaluation
from difffacto_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROGRAM_SPANS = {"sample_generation", "prepare_generation", "evaluate_gen", "resample", "sweep"}
T = 3


@pytest.fixture(autouse=True)
def empty_recorder():
    trace.reset()
    yield
    trace.reset()


@pytest.fixture(scope="module")
def model():
    mcfg = Config(os.path.join(ROOT, "configs", "gen_chair.py")).model.dump()
    mcfg.update(npoints=64, num_timesteps=T, ret_traj=False, cimle_sample_num=1)
    mcfg["diffusion"]["net"]["depth"] = 1
    mcfg["encoder"]["part_aligner"]["depth"] = 1
    mcfg["encoder"]["latent_flow_depth"] = 1
    return build_from_cfg(mcfg, MODELS, device="cpu", seed=0)


def generate(model, B=2, seed=0):
    return sample_generation(model, B, valid_id=torch.ones(B, 4),
                             generator=torch.Generator().manual_seed(seed))["pred"]


def clouds(S, n, seed):
    return (np.random.RandomState(seed).rand(S, n, 3) * 2 - 1).astype(np.float32)


def tree(spans):
    """(name, parent's name, attrs) of each span, in the order they opened."""
    return [(s.name, None if s.parent is None else spans[s.parent].name, s.attrs)
            for s in spans]


def test_spans_nest_with_their_parent_on_the_host_clock():
    t0 = time.perf_counter()
    with trace.recording():
        with trace.span("outer", k=1):
            with trace.span("first"):
                with trace.span("inner"):
                    pass
            with trace.span("second"):
                pass
        with trace.span("root"):
            pass
    t1 = time.perf_counter()
    spans = trace.spans()
    assert [(s.name, s.parent, s.attrs) for s in spans] == [
        ("outer", None, {"k": 1}), ("first", 0, {}), ("inner", 1, {}), ("second", 0, {}),
        ("root", None, {})]
    for s in spans:
        assert t0 <= s.start <= s.end <= t1
        if s.parent is not None:
            p = spans[s.parent]
            assert p.start <= s.start and s.end <= p.end
    assert spans[1].end <= spans[3].start and spans[0].end <= spans[4].start


def test_a_span_that_raises_still_closes():
    with trace.recording():
        with pytest.raises(ValueError):
            with trace.span("failing"):
                raise ValueError("inside")
        with trace.span("after"):
            pass
    assert [(s.name, s.parent) for s in trace.spans()] == [("failing", None), ("after", None)]
    assert all(s.end is not None for s in trace.spans())


def test_nothing_is_recorded_with_recording_off(model):
    assert not trace.on()
    assert trace.span("a") is trace.span("b")  # off, a span is one shared no-op
    with trace.span("off"):
        pass
    generate(model)
    evaluation.evaluate_gen(clouds(3, 16, 1), clouds(3, 16, 2), device="cpu")
    assert trace.spans() == []
    assert not any(k.startswith(("chain.", "emd.")) for k in trace.counters())


def test_a_profiler_session_turns_recording_on():
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.on()
        with trace.span("profiled"):
            pass
    assert not trace.on()
    with trace.span("after"):
        pass
    assert [s.name for s in trace.spans()] == ["profiled"]


def test_recording_blocks_nest():
    with trace.recording():
        with trace.recording():
            assert trace.on()
        assert trace.on()
    assert not trace.on()


def test_counters_add_and_deferred_counts_wait_for_the_read():
    trace.count("x")
    trace.count("x", 3)
    trace.count("y", 2)
    called = []
    trace.defer(lambda: called.append(1) or {"x": 10, "z": 1})
    assert called == []
    assert trace.counters() == {"x": 14, "y": 2, "z": 1}
    assert trace.counters() == {"x": 14, "y": 2, "z": 1}  # a deferred count is added once
    assert called == [1]
    trace.reset()
    assert trace.counters() == {} and trace.spans() == []


def test_counters_are_kept_with_recording_off():
    assert not trace.on()
    trace.count("op.launches")
    assert trace.counters() == {"op.launches": 1}


def test_the_chain_counts_its_steps_while_recording(model):
    generate(model)
    assert "chain.steps" not in trace.counters()
    with trace.recording():
        generate(model)
        generate(model)
    counts = trace.counters()
    assert counts["chain.steps"] == 2 * T
    assert "chain.starved_steps" not in counts  # the card's count; none on the CPU


@pytest.mark.parametrize("cap", [10, 300])
def test_eval_emd_work_counts_equal_the_plain_hybrids(monkeypatch, cap):
    """The emd.* counters of the eval EMD against the plain version's own
    rounds and bids; at 10 rounds two of the six pairs reach the cap."""
    monkeypatch.setenv("DIFFFACTO_EMD_IMPL", "hybrid")
    monkeypatch.setenv("DIFFFACTO_EMD_AUCTION_ITERS", str(cap))
    rng = np.random.RandomState(0)
    a = torch.as_tensor(rng.randn(6, 128, 3).astype(np.float32) * 0.3)
    b = torch.as_tensor(rng.randn(6, 128, 3).astype(np.float32) * 0.3)
    te.emd_cost_eval(a[:3], b[:3])  # not recording: not counted
    assert trace.counters() == {}
    with trace.recording():
        te.emd_cost_eval(a[:3], b[:3])
        te.emd_cost_eval(a[3:], b[3:])
    _, rounds, bids = emd_assignment_hybrid_reference(a, b, auction_iters=cap, return_work=True)
    assert trace.counters() == {"emd.pairs": 6, "emd.rounds": int(rounds.sum()),
                                "emd.bids": int(bids.sum()),
                                "emd.capped_pairs": int((rounds >= cap).sum())}
    assert trace.counters()["emd.capped_pairs"] == (2 if cap == 10 else 0)


def test_generation_and_protocol_span_tree(model):
    """sample_generation over prepare_generation; evaluate_gen over its
    sweeps, rr only where the cache misses."""
    cache = {}
    with trace.recording():
        generate(model)
        evaluation.evaluate_gen(clouds(3, 16, 1), clouds(3, 16, 2), ref_self_cache=cache,
                                device="cpu")
        evaluation.evaluate_gen(clouds(3, 16, 3), clouds(3, 16, 2), ref_self_cache=cache,
                                device="cpu")
    protocol = [("evaluate_gen", None, {}), ("sweep", "evaluate_gen", {"block": "rs"})]
    assert tree(trace.spans()) == (
        [("sample_generation", None, {}), ("prepare_generation", "sample_generation", {})]
        + protocol + [("sweep", "evaluate_gen", {"block": "rr"}),
                      ("sweep", "evaluate_gen", {"block": "ss"})]
        + protocol + [("sweep", "evaluate_gen", {"block": "ss"})])
    assert all(s.end is not None for s in trace.spans())


def test_each_resampled_set_is_a_child_span(monkeypatch):
    """Sets of more than 2048 points are FPS-ed each in a ``resample`` span;
    the sweeps are stubbed here, the tree is the protocol's."""
    def fake_pair(a, b, *args, **kw):
        assert a.shape[1] == b.shape[1] == 2048
        return np.ones((len(a), len(b))), np.ones((len(a), len(b)))

    monkeypatch.setattr(ev, "pairwise_cd_emd", fake_pair)
    monkeypatch.setattr(ev, "pairwise_self_cd_emd", lambda p, *a, **kw: fake_pair(p, p))
    with trace.recording():
        evaluation.evaluate_gen(clouds(2, 2080, 1), clouds(2, 2056, 2), device="cpu")
    assert [(n, p, a.get("block")) for n, p, a in tree(trace.spans())] == [
        ("evaluate_gen", None, None), ("resample", "evaluate_gen", None),
        ("resample", "evaluate_gen", None), ("sweep", "evaluate_gen", "rs"),
        ("sweep", "evaluate_gen", "rr"), ("sweep", "evaluate_gen", "ss")]


def test_no_program_span_is_a_profiler_event(model):
    """The spans are the recorder's alone: a profiler's events hold none of
    their names, so they never count as a device's busy time."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        generate(model)
        evaluation.evaluate_gen(clouds(3, 16, 1), clouds(3, 16, 2), device="cpu")
    assert {s.name for s in trace.spans()} == PROGRAM_SPANS - {"resample"}
    names = {e.name for e in prof.events()}
    assert names and not names & PROGRAM_SPANS
