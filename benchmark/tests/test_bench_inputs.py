"""The general generator: the same seed gives the same inputs, another seed
other ones, for seeds beyond 32 bits too."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import inputs

SEEDS = (7, 2**31 + 12345)


@pytest.mark.parametrize("seed", SEEDS)
def test_draws_repeat_and_differ(seed, tiny):
    model = tiny()["model"]
    a = inputs.draws(seed, 3, 2, model, "cpu")
    b = inputs.draws(seed, 3, 2, model, "cpu")
    c = inputs.draws(seed + 1, 3, 2, model, "cpu")
    d = inputs.draws(seed, 4, 2, model, "cpu")
    assert set(a) == {"z", "cimle_noise", "noise", "step_noise"}
    assert a["step_noise"].shape == (model["num_timesteps"], 2, model["npoints"], 3)
    for k in a:
        assert torch.equal(a[k], b[k])
        assert not torch.equal(a[k], c[k]) and not torch.equal(a[k], d[k])


@pytest.mark.parametrize("seed", SEEDS)
def test_presence_repeats_and_differs(seed):
    a, b = inputs.presence(seed, 0, 256), inputs.presence(seed, 0, 256)
    assert np.array_equal(a, b) and a.shape == (256, 4)
    assert not np.array_equal(a, inputs.presence(seed + 1, 0, 256))
    assert ((a == 0) | (a == 1)).all() and (a.sum(1) >= 2).all()


@pytest.mark.parametrize("seed", SEEDS)
def test_ref_clouds_repeat_and_differ(seed):
    a = inputs.ref_clouds(seed, 3, 512)
    assert np.array_equal(a, inputs.ref_clouds(seed, 3, 512)) and a.shape == (3, 512, 3)
    assert not np.array_equal(a, inputs.ref_clouds(seed + 1, 3, 512))
    assert np.allclose(a.mean(1), 0, atol=1e-5)


@pytest.mark.parametrize("seed", SEEDS)
def test_weights_repeat_and_differ(seed):
    layout = [("net.blocks.0.wq", (128, 128)), ("net.pre_norm.scale", (128,)),
              ("net.proj_in.bias", (128,)), ("enc.bn0.var", (8,))]
    a, b = inputs.weights(layout, seed, "cpu"), inputs.weights(layout, seed, "cpu")
    c = inputs.weights(layout, seed + 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["net.blocks.0.wq"], c["net.blocks.0.wq"])
    assert torch.equal(a["enc.bn0.var"], torch.ones(8))
    assert abs(float(a["net.blocks.0.wq"].std()) - 128**-0.5) < 0.01
    assert abs(float(a["net.pre_norm.scale"].mean()) - 1.0) < 0.02


def test_sub_seeds_are_streams():
    assert inputs.sub_seed(1, "a") != inputs.sub_seed(1, "b") != inputs.sub_seed(2, "a")
    assert 0 <= inputs.sub_seed(2**40, "draws", 0) < 2**63


@pytest.mark.parametrize("seed", SEEDS)
def test_checked_pairs_cover_every_launch(seed):
    """The EMD check draws one pair from every ``check_pair_stride`` pairs of
    a block, so every launch of the sweep (2112 pairs at most) holds five or
    more of them; the same seed draws the same pairs."""
    import harness

    strata = harness.loop("val_gen").strata
    run = SimpleNamespace(seed=seed)
    got = strata(run, 4096, 384, "pairs", "rs")
    assert np.array_equal(got, strata(run, 4096, 384, "pairs", "rs"))
    assert not np.array_equal(got, strata(SimpleNamespace(seed=seed + 1), 4096, 384, "pairs", "rs"))
    assert len(got) == 11 and np.array_equal(got // 384, np.arange(11)) and got.max() < 4096
    for lo in range(0, 4096, 2112):
        assert ((got >= lo) & (got < min(lo + 2112, 4096))).sum() >= 5
    assert len(strata(run, 2016, 384, "pairs", "ss")) == 6
