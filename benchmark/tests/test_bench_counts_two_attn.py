"""The two-attention yardstick (counts_two_attn.py) against counts.py's and
hand counts at gen_chair_two_attn's widths."""

import json
import os

import pytest

import counts
import counts_two_attn

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def model(name):
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        return json.load(f)["model"]


def test_attn1_terms():
    # per block: Wq1 and Wout1 128^2 each, scores and the weighted sum 2 x 4 x 128
    macs, nbytes = counts_two_attn.attn1_terms(model("gen_chair_two_attn"), 128)
    assert macs == 5 * (2 * 128 * 128 + 2 * 4 * 128) == 168_960
    assert nbytes == 5 * (2 * (2 * 128 * 128 + 2 * 128 + 2 * 128 * 4 * 128) + 4 * 128)


@pytest.mark.parametrize("B", [1, 64, 128, 256])
def test_trunk_bound_is_b1s_plus_the_first_attention(B):
    m = model("gen_chair_two_attn")
    flops, nbytes = counts_two_attn.trunk_flops_bytes(m, B)
    bare_flops, bare_bytes = counts_two_attn.trunk_flops_bytes(m, B, attn1=(0, 0))
    macs, extra = counts_two_attn.attn1_terms(m, B)
    assert flops == bare_flops + 2.0 * B * 2048 * macs and nbytes == bare_bytes + extra
    # with the first attention's terms set to zero it is B1's count exactly
    assert counts_two_attn.trunk_bound_s(m, B, attn1=(0, 0)) == counts.trunk_bound_s(m, B)
    assert bare_flops / counts.PEAK_BF16_FLOPS == counts.trunk_bound_s(m, B)[0]


def test_trunk_bound_bytes_side_is_b1s_too():
    # at one token a shape the bytes bound: the zeroed count is B1's there too
    m = dict(model("gen_chair_two_attn"), npoints=1)
    assert counts.trunk_bound_s(m, 1)[1] == "bytes"
    assert counts_two_attn.trunk_bound_s(m, 1, attn1=(0, 0)) == counts.trunk_bound_s(m, 1)


def test_trunk_bound_round_figure():
    t, by = counts_two_attn.trunk_bound_s(model("gen_chair_two_attn"), 128)
    assert by == "operations"
    ops = 2.0 * 128 * 2048 * (13 * 128 + 5 * (4 * 128 * 128 + 4 * 4 * 128 + 3 * 128 * 512))
    assert t == pytest.approx(ops / 989e12) and t == pytest.approx(7.005e-4, rel=1e-3)


def test_generation_flops_per_shape():
    m = model("gen_chair_two_attn")
    per_step = 2048 * 168_960 + 5 * 2 * 4 * 522 * 128
    aligner = 4 * 5 * (4 * 256 * 256 + 2 * 4 * 256)
    assert counts_two_attn.generation_flops_per_shape(m) == (
        counts.generation_flops_per_shape(m) + 2.0 * (aligner + 100 * per_step))
    assert counts_two_attn.generation_flops_per_shape(m) == pytest.approx(5.4296e11, rel=1e-3)
