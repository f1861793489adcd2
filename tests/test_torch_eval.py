"""The port's eval protocol (difffacto_torch/metrics/eval.py, data/dataset_utils.py,
runner/evaluation.py) against the JAX package on the same numpy clouds.

Sizes are small (S, R <= 8, n <= 256) and both sides run the auction EMD on
the CPU. Tolerances: CD-side values rtol 1e-5 (f32 on both sides, the products
sum in another order); EMD-side values rtol 0.03 (the two distance matrices
differ in the last bit, a near-tie may then go to another object, and the
auction is eps-optimal either way); host-side numpy metrics are equal.
"""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp

from difffacto_tpu.data import dataset_utils as jdata
from difffacto_tpu.metrics import eval as je
from difffacto_tpu.metrics.iou import aabb_iou as jax_aabb_iou
from difffacto_tpu.ops.points import fps as jax_fps
from difffacto_torch import Config, MODELS, build_from_cfg
from difffacto_torch.data import dataset_utils as tdata
from difffacto_torch.metrics import eval as te
from difffacto_torch.metrics.iou import aabb_iou
from difffacto_torch.runner import evaluation as trun

CD_RTOL, EMD_RTOL = 1e-5, 0.03
CPU = "cpu"


@pytest.fixture(autouse=True)
def knobs(monkeypatch):
    """300 auction iterations seat 32 points; the JAX sweeps' dispatch sizes
    are set to 1 so that they pad with fewer dummy pairs (values do not depend
    on them)."""
    monkeypatch.setenv("DIFFFACTO_EMD_ITERS", "300")
    monkeypatch.delenv("DIFFFACTO_EMD_IMPL", raising=False)
    monkeypatch.delenv("DIFFFACTO_EVAL_SYMMETRIC", raising=False)
    monkeypatch.setattr(je, "PAIRWISE_SELF_CHUNKS", 1)
    monkeypatch.setattr(je, "PAIRWISE_ROWS", 1)


def clouds(S, n, seed):
    return (np.random.RandomState(seed).rand(S, n, 3) * 2 - 1).astype(np.float32)


def assert_metrics_close(got, want):
    assert got.keys() == want.keys()
    for k in want:
        rtol = EMD_RTOL if "EMD" in k else CD_RTOL
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=1e-9, err_msg=k)


def part_shapes(S, seed, n=256):
    """Shapes of two parts (labels 0 and 1), 128 points each, side by side."""
    rng = np.random.RandomState(seed)
    pts = (rng.rand(S, n, 3) - 0.5).astype(np.float32)
    pts[:, n // 2:, 0] += 0.8
    seg = np.repeat(np.arange(2), n // 2)[None].repeat(S, 0)
    return pts, seg


# ------------------------------------------------------------ host-side numpy
def test_knn_equals_jax():
    rng = np.random.RandomState(0)
    Mxx, Mxy, Myy = rng.rand(6, 6), rng.rand(6, 5), rng.rand(5, 5)
    for kw in (dict(), dict(k=3, sqrt=True), dict(one_way=True)):
        assert te.knn(Mxx, Mxy, Myy, **kw) == je.knn(Mxx, Mxy, Myy, **kw), kw
    # the one_way quirk: the labels are the predictions, so nothing is ever wrong
    assert te.knn(Mxx, Mxy, Myy, one_way=True)["acc"] == 1.0


def test_lgan_mmd_cov_equals_jax():
    d = np.random.RandomState(1).rand(7, 5)
    assert te.lgan_mmd_cov(d) == je.lgan_mmd_cov(d)
    assert te.lgan_mmd_cov(d, thresh=0.05) == je.lgan_mmd_cov(d, thresh=0.05)


def test_jsd_equals_jax():
    a, b = clouds(4, 64, 2) * 0.5, clouds(3, 64, 3) * 0.4
    got = te.jsd_between_point_cloud_sets(a, b, resolution=8)
    assert got == je.jsd_between_point_cloud_sets(a, b, resolution=8)
    assert 0.0 < got < 1.0


def test_aabb_iou_equals_jax():
    rng = np.random.RandomState(4)
    lo_a, lo_b = rng.rand(3), rng.rand(3) + 0.2
    assert aabb_iou(lo_a, lo_a + 1, lo_b, lo_b + 1) == jax_aabb_iou(lo_a, lo_a + 1, lo_b, lo_b + 1)
    assert aabb_iou(lo_a, lo_a + 1, lo_a + 2, lo_a + 3) == (0.0, 0.0)


def test_bbox_normalize_and_part_presence_equal_jax():
    x = clouds(3, 50, 5) * np.array([1.0, 0.3, 2.0], np.float32)
    np.testing.assert_array_equal(tdata.bbox_normalize(x), jdata.bbox_normalize(x))
    assert tdata.shapenet_chair_part_distribution == jdata.shapenet_chair_part_distribution
    for n_class in (4, 6):
        got = tdata.sample_part_presence(np.random.RandomState(6), 40, n_class)
        want = jdata.sample_part_presence(np.random.RandomState(6), 40, n_class)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("metric", ["chamfer", "l2", "iou"])
def test_bbox_metric_equals_jax(metric):
    preds, pseg = part_shapes(3, 7)
    refs, rseg = part_shapes(3, 8)
    got = te.compute_bbox_metric(preds, pseg, refs, rseg, n_class=2, metric=metric)
    want = je.compute_bbox_metric(preds, pseg, refs, rseg, n_class=2, metric=metric)
    assert got == want and len(got) == 6


def test_snapping_metric_equals_jax():
    preds, seg = part_shapes(3, 9)
    for cls in ("Chair", "Airplane", "Lamp"):
        got, want = te.compute_snapping_metric(preds, seg, cls), je.compute_snapping_metric(preds, seg, cls)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_equal(got[k], want[k])  # nan where a part pair is absent
    assert te.compute_snapping_metric(preds, seg, "Lamp") == {}


# ------------------------------------------------------------- pairwise sweeps
def test_pairwise_cd_emd_with_masks_and_a_pad_larger_than_r():
    """R = 3 < batch_size = 4 (modular padding) and masks on both sides."""
    s, r = clouds(5, 32, 10), clouds(3, 32, 11)
    rng = np.random.RandomState(12)
    ms, mr = (rng.rand(5, 32) > 0.3).astype(np.float32), (rng.rand(3, 32) > 0.3).astype(np.float32)
    cd_j, emd_j = je.pairwise_cd_emd(s, r, 4, mask_sample=ms, mask_ref=mr)
    cd_t, emd_t = te.pairwise_cd_emd(s, r, 4, mask_sample=ms, mask_ref=mr, device=CPU)
    assert cd_t.shape == emd_t.shape == (5, 3) and cd_t.dtype == np.float32
    np.testing.assert_allclose(cd_t, cd_j, rtol=CD_RTOL)
    np.testing.assert_allclose(emd_t, emd_j, rtol=EMD_RTOL)
    cd_only, zeros = te.pairwise_cd_emd(s, r, 4, compute_emd=False, device=CPU)
    assert not zeros.any()
    np.testing.assert_allclose(cd_only, je.pairwise_cd_emd(s, r, 4, compute_emd=False)[0], rtol=CD_RTOL)


def test_pairwise_self_is_the_mirrored_triangle():
    x = clouds(5, 32, 13)
    cd_j, emd_j = je.pairwise_self_cd_emd(x, 4)
    cd_t, emd_t = te.pairwise_self_cd_emd(x, 4, device=CPU)
    assert cd_t.dtype == np.float64 and cd_t.shape == (5, 5)
    np.testing.assert_array_equal(cd_t, cd_t.T)
    np.testing.assert_array_equal(np.diag(emd_t), np.zeros(5))
    np.testing.assert_allclose(cd_t, cd_j, rtol=CD_RTOL)
    np.testing.assert_allclose(emd_t, emd_j, rtol=EMD_RTOL)
    one = te.pairwise_self_cd_emd(x[:1], 4, device=CPU)
    assert one[0].shape == (1, 1) and not one[0].any()


def test_one_emd_call_takes_several_chunks_only_for_the_kernel(monkeypatch):
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert te.emd_pairs_per_launch(2048, 32, cpu) == 32
    assert te.emd_pairs_per_launch(2048, 32, cuda) == 32 * te.EMD_CHUNKS_PER_LAUNCH
    assert te.emd_pairs_per_launch(2000, 32, cuda) == 32  # 128 does not divide n: auction
    monkeypatch.setenv("DIFFFACTO_EMD_IMPL", "auction")
    assert te.emd_pairs_per_launch(2048, 32, cuda) == 32


@pytest.mark.parametrize("case", ["plain", "mask", "full_sweep"])
def test_compute_all_metrics_matches_jax(case, monkeypatch):
    gen, ref = clouds(6, 32, 14), clouds(5, 32, 15)
    mask = (np.random.RandomState(16).rand(6, 32) > 0.3).astype(np.float32) if case == "mask" else None
    if case == "full_sweep":
        monkeypatch.setenv("DIFFFACTO_EVAL_SYMMETRIC", "0")
    want = je.compute_all_metrics(gen, ref, batch_size=4, mask=mask)
    got = te.compute_all_metrics(gen, ref, batch_size=4, mask=mask, device=CPU)
    assert len(got) == 12
    assert_metrics_close(got, want)
    for k, v in got.items():
        assert np.isfinite(v)
        if "cov" in k or "acc" in k:
            assert 0.0 <= v <= 1.0


def test_compute_all_metrics_options_match_jax():
    gen, ref = clouds(4, 32, 17), clouds(4, 32, 18)
    for kw in (dict(compute_emd=False), dict(one_way=True)):
        assert_metrics_close(te.compute_all_metrics(gen, ref, 4, device=CPU, **kw),
                             je.compute_all_metrics(gen, ref, 4, **kw))
    # mesh=None is the one-rank sweep (the sharded sweeps: test_torch_metrics_mesh.py)
    assert te.compute_all_metrics(gen, ref, 4, device=CPU, mesh=None) == \
        te.compute_all_metrics(gen, ref, 4, device=CPU)


def test_ref_self_cache_hit_and_miss(monkeypatch):
    gen, ref = clouds(4, 32, 19), clouds(4, 32, 20)
    calls = []
    real = te.pairwise_self_cd_emd
    monkeypatch.setattr(te, "pairwise_self_cd_emd",
                        lambda pts, *a, **k: calls.append(pts.shape) or real(pts, *a, **k))
    cache = {}
    first = te.compute_all_metrics(gen, ref, 4, ref_self_cache=cache, device=CPU)
    assert len(cache) == 1 and len(calls) == 2  # refs and samples
    again = te.compute_all_metrics(gen, ref, 4, ref_self_cache=cache, device=CPU)
    assert again == first and len(cache) == 1 and len(calls) == 3  # hit: samples only
    te.compute_all_metrics(gen, ref + 0.01, 4, ref_self_cache=cache, device=CPU)
    assert len(cache) == 2 and len(calls) == 5  # other refs: miss
    monkeypatch.setenv("DIFFFACTO_EMD_ITERS", "299")
    te.compute_all_metrics(gen, ref, 4, ref_self_cache=cache, device=CPU)
    assert len(cache) == 3  # another knob: miss


def test_emd_cd_paired_matches_jax():
    a, b = clouds(5, 32, 21), clouds(5, 32, 22)
    assert_metrics_close(te.emd_cd_paired(a, b, 4, device=CPU), je.emd_cd_paired(a, b, 4))
    got, want = te.emd_cd_paired(a, b, 4, reduced=False, device=CPU), je.emd_cd_paired(a, b, 4, reduced=False)
    assert got["MMD-CD"].shape == (5,)
    np.testing.assert_allclose(got["MMD-CD"], want["MMD-CD"], rtol=CD_RTOL)
    np.testing.assert_allclose(got["MMD-EMD"], want["MMD-EMD"], rtol=EMD_RTOL)


def test_part_metric_matches_jax(monkeypatch):
    """Parts are padded to 512 points by repetition; 5 auction iterations keep
    the JAX side short (the last one force-assigns on both sides)."""
    monkeypatch.setenv("DIFFFACTO_EMD_ITERS", "5")
    preds, pseg = part_shapes(2, 23)
    refs, rseg = part_shapes(2, 24)
    want = je.compute_part_metric(preds, pseg, refs, rseg, batch_size=2, n_class=2)
    got = te.compute_part_metric(preds, pseg, refs, rseg, batch_size=2, n_class=2, device=CPU)
    assert len(got) == 12 and all(k.startswith("part_weighted_") for k in got)
    assert_metrics_close(got, want)


# ------------------------------------------------------------ dataset dispatch
def batches(n_batches, B, seed, n=256):
    out = []
    for i in range(n_batches):
        pred, pseg = part_shapes(B, seed + 2 * i, n)
        ref, rseg = part_shapes(B, seed + 2 * i + 1, n)
        rng = np.random.RandomState(seed + i)
        out.append(dict(
            pred=pred, pred_seg_mask=pseg, input_ref=ref, ref_seg_mask=rseg,
            present=np.ones((B, 4), np.float32),
            shift=rng.rand(B, 1, 3).astype(np.float32), scale=1 + rng.rand(B, 1, 1).astype(np.float32),
        ))
    return out


@pytest.mark.parametrize("mode", ["gen", "ae", "gen_part"])
def test_evaluate_batches_matches_jax(mode, monkeypatch):
    monkeypatch.setenv("DIFFFACTO_EMD_ITERS", "5" if mode == "gen_part" else "300")
    res = batches(1, 2, 30, n=256) if mode == "gen_part" else batches(2, 2, 30, n=32)
    kw = dict(eval_mode=mode, num_class=2, batch_size=2)
    save_j, want = je.evaluate_batches([dict(r) for r in res], 1, **kw)
    save_t, got = te.evaluate_batches([dict(r) for r in res], 1, device=CPU, **kw)
    assert_metrics_close(got, want)
    assert save_t.keys() == save_j.keys()
    for k in save_j:
        np.testing.assert_array_equal(save_t[k], save_j[k])


def test_evaluate_batches_save_only_and_bad_mode():
    res = batches(2, 2, 40, n=64)
    save_t, m = te.evaluate_batches([dict(r) for r in res], 1, save_only=True, device=CPU)
    save_j, _ = je.evaluate_batches([dict(r) for r in res], 1, save_only=True)
    assert m == dict(l=0) and save_t.keys() == save_j.keys()
    np.testing.assert_array_equal(save_t["pred"], save_j["pred"])
    with pytest.raises(ValueError):
        te.evaluate_batches([dict(r) for r in res], 1, eval_mode="nope", device=CPU)


def test_resample_keeps_the_seg_mask_aligned():
    """The FPS branch of evaluate_batches (clouds of more than 2048 points),
    at 256 -> 64: the JAX package's indices, points and labels."""
    pts, seg = part_shapes(2, 41)
    sub_j, idx_j = jax_fps(jnp.asarray(pts), 64, ret_id=True)
    sub, sub_seg = te._resample(pts, seg, torch.device("cpu"), number=64)
    np.testing.assert_array_equal(sub, np.asarray(sub_j))
    np.testing.assert_array_equal(sub_seg, np.take_along_axis(seg, np.asarray(idx_j), axis=1))


# -------------------------------------------------------------- runner functions
def test_evaluate_gen_matches_the_jax_protocol():
    gen, refs = clouds(3, 16, 42) * np.array([1, 0.5, 2], np.float32), clouds(3, 16, 43)
    want = je.compute_all_metrics(jdata.bbox_normalize(gen), jdata.bbox_normalize(refs), batch_size=32)
    cache = {}
    got = trun.evaluate_gen(gen, refs, ref_self_cache=cache, device=CPU)
    assert_metrics_close(got, want)
    assert len(cache) == 1


def test_generate_samples_draws_presence_from_the_seed(monkeypatch):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    mcfg = Config(os.path.join(root, "configs", "gen_chair.py")).model.dump()
    mcfg.update(npoints=64, num_timesteps=3, ret_traj=False, cimle_sample_num=2)
    mcfg["diffusion"]["net"]["depth"] = 1
    mcfg["encoder"]["part_aligner"]["depth"] = 1
    mcfg["encoder"]["part_aligner"]["noise_scale"] = 1
    mcfg["encoder"]["latent_flow_depth"] = 1
    model = build_from_cfg(mcfg, MODELS, device="cpu", seed=0)
    seen = []
    real = trun.sample_generation
    monkeypatch.setattr(trun, "sample_generation",
                        lambda m, b, **kw: seen.append(kw["valid_id"].numpy()) or real(m, b, **kw))
    gen = trun.generate_samples(model, num_gen=5, batch=2, seed=3)
    assert gen.shape == (5, 64, 3) and gen.dtype == np.float32 and np.isfinite(gen).all()
    rng = np.random.RandomState(3)
    for got, b in zip(seen, (2, 2, 1)):
        np.testing.assert_array_equal(got, jdata.sample_part_presence(rng, b, 4))
    np.testing.assert_array_equal(gen, trun.generate_samples(model, num_gen=5, batch=2, seed=3))
    metrics = trun.generate_samples(model, num_gen=3, batch=3, seed=3, refs=clouds(3, 64, 44))
    assert len(metrics) == 12 and all(np.isfinite(v) for v in metrics.values())
