"""The port's data modules against the JAX package's, on the CPU.

Items, batches and normalisations are numpy on both sides and must agree bit
for bit. The cropping pair runs on torch tensors in the port: at an integer
crop with fixed points it must pick the same points as JAX's; at a crop
range both halves go through furthest point sampling, held index for index
against JAX's ``fps``; the random-direction path is held to its invariants.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difffacto_tpu.data import dataset_utils as jdu
from difffacto_tpu.data.synthetic import SyntheticPart as JaxSyntheticPart
from difffacto_tpu.data.synthetic import SyntheticPartDataset as JaxSyntheticPartDataset
from difffacto_tpu.ops.points import furthest_point_sample as jax_fps_idx
from difffacto_torch.data import dataset_utils as pdu
from difffacto_torch.data.synthetic import SyntheticPart, SyntheticPartDataset
from difffacto_torch.ops.fps import furthest_point_sample_reference

torch.set_num_threads(1)

MODES = ("global_unit", "shape_unit", "shape_canonical", "shape_canonical_bbox", "shape_half",
         "shape_34", "shape_bbox", "none")


def assert_items_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], str):
            assert got[k] == want[k], k
        else:
            g, w = np.asarray(got[k]), np.asarray(want[k])
            assert g.dtype == w.dtype and g.shape == w.shape, k
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("kwargs", [
    dict(npoints=256, size=6, seed=0),
    dict(npoints=300, size=5, seed=1, n_class=3, scale_mode="shape_bbox",
         part_scale_mode="shape_canonical_bbox", clip=False, part_drop_prob=0.5),
], ids=["default", "three-parts-bbox"])
def test_synthetic_items_bit_for_bit(kwargs):
    """Every key of several items, fresh and from the per-index cache, and
    after store_noise (the CIMLE table) replaced the noise field."""
    mine, ref = SyntheticPartDataset(**kwargs), JaxSyntheticPartDataset(**kwargs)
    for idx in (0, 3, 1, 3):
        assert_items_equal(mine[idx], ref[idx])
    rng = np.random.RandomState(2)
    noises = [rng.randn(3, 8).astype(np.float32), rng.randn(2, 8).astype(np.float32)]
    ids = [np.array([0, 3, 4], np.int32), np.array([1, 2], np.int32)]
    mine.store_noise(noises, ids)
    ref.store_noise(noises, ids)
    for idx in range(len(ref)):
        assert_items_equal(mine[idx], ref[idx])
    np.testing.assert_array_equal(mine[3]["noise"], noises[0][1])


@pytest.mark.parametrize("shuffle,drop_last", [(True, False), (True, True), (False, False)])
def test_loader_order_and_len(shuffle, drop_last):
    """Batch order and ``len`` over two epochs (``set_epoch``), with 0 and 1
    workers, against the JAX loader over the same dataset."""
    kw = dict(batch_size=3, npoints=64, size=7, shuffle=shuffle, drop_last=drop_last)
    ref, _ = JaxSyntheticPart(**kw)
    want = {}
    for epoch in (0, 1):
        ref.set_epoch(epoch)
        want[epoch] = list(ref)
    for workers in (0, 1):
        mine, _ = SyntheticPart(**kw)
        mine.num_workers = workers
        assert len(mine) == len(ref) == (2 if drop_last else 3)
        for epoch in (0, 1):
            mine.set_epoch(epoch)
            got = list(mine)
            assert len(got) == len(want[epoch])
            for g, w in zip(got, want[epoch]):
                assert_items_equal(g, w)
    if shuffle:
        assert [int(i) for b in want[0] for i in b["id"]] != [int(i) for b in want[1] for i in b["id"]]


def test_prefetch_thread_raises_the_datasets_error():
    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            if i == 2:
                raise KeyError("item 2")
            return {"x": np.zeros(2, np.float32)}

    loader = pdu.DataLoader(Broken(), batch_size=1, shuffle=False, num_workers=1)
    with pytest.raises(KeyError, match="item 2"):
        list(loader)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("clip", [True, False])
def test_pc_norm_bit_for_bit(mode, clip):
    rng = np.random.RandomState(3)
    stats = {"mean": rng.randn(3).astype(np.float32), "std": np.float32(1.7)}
    for pc in (rng.randn(200, 3).astype(np.float32) * [0.5, 0.004, 2.0],
               np.concatenate([rng.randn(50, 2), np.zeros((50, 1))], 1).astype(np.float32)):
        got = pdu.pc_norm(pc, mode, stats, clip=clip)
        want = jdu.pc_norm(pc, mode, stats, clip=clip)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g, w)


def test_collate():
    items = [{"a": np.full((2, 3), i, np.float32), "id": np.int32(i), "token": f"t{i}",
              "f": 1.5 * i, "other": (i,)} for i in range(3)]
    got, want = pdu.collate(items), jdu.collate(items)
    assert set(got) == set(want)
    for k in ("a", "id", "f"):
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype
    assert got["token"] == want["token"] == ["t0", "t1", "t2"]
    assert got["other"] == want["other"]


def clouds(B, N, seed):
    return np.random.RandomState(seed).randn(B, N, 3).astype(np.float32)


@pytest.mark.parametrize("padding_zeros", [False, True])
def test_separate_point_cloud_fixed_points(padding_zeros):
    """An integer crop with a fixed point: the same partial and missing
    clouds as JAX, exactly."""
    xyz = clouds(3, 512, 4)
    center = np.array([0.3, -0.2, 0.9], np.float32)
    want = jdu.separate_point_cloud(jnp.asarray(xyz), 512, 200, fixed_points=center,
                                    padding_zeros=padding_zeros)
    got = pdu.separate_point_cloud(torch.as_tensor(xyz), 512, 200, fixed_points=center,
                                   padding_zeros=padding_zeros)
    assert got[0].shape == ((3, 512, 3) if padding_zeros else (3, 312, 3))
    assert got[1].shape == (3, 200, 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    full = pdu.separate_point_cloud(torch.as_tensor(xyz), 512, 512)
    assert full[1] is None and torch.equal(full[0], torch.as_tensor(xyz))


def test_separate_point_cloud_crop_range_resamples_like_jax():
    """ShapeNet-55's training crop [2048, 6144) at 8192 points: the count is
    drawn from the host RandomState, both halves go through the plain FPS,
    index for index against JAX's FPS on the same halves."""
    xyz = clouds(2, 8192, 5)
    center = np.array([0.0, 1.0, 0.0], np.float32)
    num_crop = int(np.random.RandomState(11).randint(2048, 6144))
    partial, missing = pdu.separate_point_cloud(
        torch.as_tensor(xyz), 8192, [2048, 6144], fixed_points=center,
        rng=np.random.RandomState(11))
    assert partial.shape == missing.shape == (2, 2048, 3)
    halves = jdu.separate_point_cloud(jnp.asarray(xyz), 8192, num_crop, fixed_points=center)
    for got, half in zip((partial, missing), halves):
        idx = np.asarray(jax_fps_idx(half, 2048))
        np.testing.assert_array_equal(
            furthest_point_sample_reference(torch.as_tensor(np.array(half)), 2048).numpy(), idx)
        np.testing.assert_array_equal(got.numpy(), np.take_along_axis(
            np.asarray(half), idx[..., None].astype(np.int64), axis=1))


def test_separate_point_cloud_random_direction_invariants():
    """A random direction from the generator: a unit vector, the ``crop``
    points nearest to it are ``missing`` and the rest ``partial``; a crop
    range needs the host RandomState."""
    xyz = torch.as_tensor(clouds(2, 300, 6))
    partial, missing = pdu.separate_point_cloud(
        xyz, 300, 120, generator=torch.Generator().manual_seed(9))
    center = torch.randn((2, 1, 3), generator=torch.Generator().manual_seed(9))
    unit = center / center.norm(dim=-1, keepdim=True)
    torch.testing.assert_close(unit.norm(dim=-1), torch.ones(2, 1))
    dist = (xyz - unit).norm(dim=-1)
    for b in range(2):
        near = set(torch.argsort(dist[b], stable=True)[:120].tolist())
        rows = {tuple(p) for p in xyz[b].tolist()}
        miss = {tuple(p) for p in missing[b].tolist()}
        part = {tuple(p) for p in partial[b].tolist()}
        assert miss == {tuple(xyz[b, i].tolist()) for i in near}
        assert part == rows - miss and len(part) == 180
    with pytest.raises(ValueError, match="needs rng"):
        pdu.separate_point_cloud(xyz, 300, [10, 20], generator=torch.Generator())
    with pytest.raises(ValueError, match="torch.Generator"):
        pdu.separate_point_cloud(xyz, 300, 10)


def test_cropping_loader_on_the_cpu():
    """The loader's batches gain partial and missing tensors; a given seed
    and epoch give the same batches."""
    loader, _ = SyntheticPart(batch_size=2, npoints=96, size=4, shuffle=False)
    crop = pdu.CroppingDataLoader(loader, crop=40, seed=3, device="cpu")
    assert len(crop) == 2 and crop.dataset is loader.dataset
    crop.set_epoch(1)
    first, again = list(crop), list(crop)
    for a, b in zip(first, again):
        assert a["partial"].shape == (2, 56, 3) and a["missing"].shape == (2, 40, 3)
        assert torch.equal(a["partial"], b["partial"])
        np.testing.assert_array_equal(a["input"], b["input"])
