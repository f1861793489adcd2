"""The yardstick's counts against hand counts at both configurations' widths."""

import json
import os

import pytest

import counts

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def model(name):
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        return json.load(f)["model"]


@pytest.mark.parametrize("name, npoints", [("gen_chair", 2048), ("gen_car", 8192)])
def test_trunk_macs_per_token(name, npoints):
    m = model(name)
    assert m["npoints"] == npoints
    # proj_in 13 x 128; per block Wq and Wout 128^2 each, scores and the
    # weighted sum over 4 part tokens 2 x 4 x 128, W1 128 x 1024, W2 512 x 128;
    # proj_out 128 x 3
    block = 2 * 128 * 128 + 2 * 4 * 128 + 128 * 1024 + 512 * 128
    assert counts.trunk_macs_per_token(m) == 13 * 128 + 5 * block + 128 * 3 == 1_154_048


@pytest.mark.parametrize("name, npoints", [("gen_chair", 2048), ("gen_car", 8192)])
def test_generation_flops_per_shape(name, npoints):
    m = model(name)
    denoiser = npoints * 1_154_048 + 5 * 2 * 4 * 522 * 128 + 256 * 2048 + 1024 * 256
    flow = 4 * 14 * (128 * 256 + 256 * 256 + 256 * 256)
    aligner = 4 * (288 * 256 + 5 * (4 * 256 * 256 + 2 * 4 * 256 + 256 * 2048 + 1024 * 256)
                   + 256 * 6)
    assert counts.generation_flops_per_shape(m) == 2.0 * (flow + aligner + 100 * denoiser)


def test_gen_chair_shape_flops_round_figure():
    # 2.31 MFLOP a token a step x 2048 tokens x 100 steps
    assert counts.generation_flops_per_shape(model("gen_chair")) == pytest.approx(4.7345e11,
                                                                                  rel=1e-3)


@pytest.mark.parametrize("name, B", [("gen_chair", 256), ("gen_car", 64)])
def test_trunk_bound(name, B):
    t, by = counts.trunk_bound_s(model(name), B)
    ops = 2.0 * B * model(name)["npoints"] * (13 * 128 + 5 * (2 * 128 * 128 + 2 * 4 * 128
                                                                + 3 * 128 * 512))
    assert by == "operations"
    assert t == pytest.approx(ops / 989e12)
    assert t == pytest.approx(1.223159e-3, rel=1e-5)  # both cells run 524,288 tokens


def test_pair_and_protocol_bounds():
    t, by = counts.pair_bound_s(2048)
    assert by == "operations" and t == pytest.approx(2048 * 2048 * 8 / 67e12)
    m = model("gen_car")
    pairs = 64 * 64 + 64 * 63 // 2
    want = 64 * counts.generation_flops_per_shape(m) / 989e12 + 2 * pairs * t
    assert counts.protocol_bound_s(m, 64, 64, 8192) == pytest.approx(want)
