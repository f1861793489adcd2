"""The port's ``data/custom.py`` (its ten DATASETS keys) against the JAX
package's, on files the tests write from a numpy seed.

Both are numpy on the host, so every batch of every factory's loader must
equal the JAX loader's bit for bit (``np.array_equal`` on every key, dtypes
equal), read in the same order: each dataset's draws come from one shared
``RandomState``. ``ShapeNet``'s cropping runs on the loader's device in the
port and in XLA in the JAX package: its crop range, its base loader's
batches and, on the CPU, the shapes of what it cuts are held here.
"""

import os
import pickle

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from difffacto_tpu.data import custom as jcustom
from difffacto_tpu.utils.registry import DATASETS as JAX_DATASETS
from difffacto_tpu.utils.registry import build_from_cfg as jax_build
from difffacto_torch.data import custom as pcustom
from difffacto_torch.utils.registry import DATASETS, build_from_cfg
from test_torch_data import assert_items_equal

S, N, K = 10, 300, 4


def both(cfg, epochs=(0,), **port_kw):
    """The port's and the JAX package's loader of ``cfg``: each factory
    returns (loader, None), and every batch of the given epochs is equal."""
    port, psampler = build_from_cfg(dict(cfg), DATASETS, **port_kw)
    ref, jsampler = jax_build(dict(cfg), JAX_DATASETS)
    assert psampler is None and jsampler is None
    assert len(port) == len(ref) > 0
    for epoch in epochs:
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        n = 0
        for got, want in zip(port, ref):
            assert_items_equal(got, want)
            n += 1
        assert n == len(ref)
    return port, ref


def clouds(seed, shapes=S, points=N):
    rng = np.random.RandomState(seed)
    return (rng.randn(shapes, points, 3) * rng.uniform(0.3, 1.0, (shapes, 1, 3))).astype(np.float32)


def part_labels(seed, shapes=S, points=N):
    """Four parts in each shape, with the cases the per-part rules treat
    apart: part 3 absent from shape 1, a straggler part of 4 points in shape
    2 and a part of 5 points (below the 10-point threshold) in shape 3."""
    rng = np.random.RandomState(seed)
    lab = rng.randint(0, 3, (shapes, points)).astype(np.int64)
    lab[0, :40] = lab[4:, :40] = 3
    lab[2, 7:11] = 3
    lab[3, 20:25] = 3
    return lab


@pytest.fixture()
def dump(tmp_path):
    """A generated dump: pred (S, N, 3) and pred_seg_mask (S, N); part 2 of
    shape 5 flat on one axis (std 0: marked absent)."""
    pred, seg = clouds(1), part_labels(2)
    pred[5, seg[5] == 2, 1] = 0.25
    out = {}
    for ext in ("pkl", "npz"):
        path = str(tmp_path / f"dump.{ext}")
        if ext == "pkl":
            with open(path, "wb") as f:
                pickle.dump(dict(pred=pred, pred_seg_mask=seg), f)
        else:
            np.savez(path, pred=pred, pred_seg_mask=seg)
        out[ext] = path
    return out


@pytest.mark.parametrize("ext, key, kw", [
    ("pkl", "data_dir", {}),
    ("npz", "path", {}),
    ("npz", "data_dir", dict(scale_mode="shape_bbox", part_scale_mode="shape_canonical_bbox",
                             clip=False)),
], ids=["pkl", "npz-path", "npz-bbox"])
def test_custom_dataset(dump, ext, key, kw):
    both(dict(type="CustomDataset", batch_size=3, npoints=128, **{key: dump[ext]}, **kw))


def test_custom_dataset_store_noise(dump):
    """store_noise (the CIMLE table) replaces the noise field of the items
    it names, in both packages."""
    kw = dict(npoints=64)
    mine = pcustom.CustomDatasetImpl(dump["npz"], **kw)
    ref = jcustom.CustomDatasetImpl(dump["npz"], **kw)
    rng = np.random.RandomState(3)
    noises = [rng.randn(3, 8).astype(np.float32), rng.randn(2, 8).astype(np.float32)]
    ids = [np.array([0, 3, 4], np.int32), np.array([1, 2], np.int32)]
    mine.store_noise(noises, ids)
    ref.store_noise(noises, ids)
    for idx in (0, 2, 9, 3):
        assert_items_equal(mine[idx], ref[idx])
    np.testing.assert_array_equal(mine[4]["noise"], noises[0][2])


@pytest.fixture()
def packed(tmp_path):
    """Whole clouds as each reader takes them: an npz of points, an npz of
    points and labels, an .npy and a torch.save'd tensor."""
    pts, lab = clouds(4), part_labels(5)
    paths = dict(npz=str(tmp_path / "parts.npz"), labelled=str(tmp_path / "labelled.npz"),
                 npy=str(tmp_path / "parts.npy"), pt=str(tmp_path / "parts.pt"))
    np.savez(paths["npz"], points=pts)
    np.savez(paths["labelled"], points=pts, labels=lab)
    np.save(paths["npy"], pts)
    torch.save(torch.from_numpy(pts), paths["pt"])
    return paths


@pytest.mark.parametrize("src, kw", [
    ("npz", {}), ("npy", dict(scale_mode="shape_unit")), ("pt", {}),
    ("labelled", dict(scale_mode="shape_half", clip=False)),
])
def test_shapenet_parts(packed, src, kw):
    both(dict(type="ShapeNetParts", batch_size=4, path=packed[src], npoints=128, shuffle=True,
              **kw), epochs=(0, 1))


@pytest.mark.parametrize("src", ["npz", "pt"])
def test_shapenet_part_alias(packed, src):
    """The reference's alias: ``root``, no normalization by default, whole
    batches only."""
    port, _ = both(dict(type="ShapeNetPart", batch_size=3, root=packed[src], npoints=96))
    assert port.drop_last and port.dataset.scale_mode is None


def test_partnet(tmp_path):
    pts, lab = clouds(6), part_labels(7)
    for split, sl in (("train", slice(0, 7)), ("test", slice(7, None))):
        np.savez(tmp_path / f"partnet_{split}.npz", points=pts[sl], labels=lab[sl])
    for split in ("train", "test"):
        both(dict(type="Partnet", batch_size=2, root=str(tmp_path), split=split, npoints=128,
                  part_scale_mode="shape_canonical_bbox"), epochs=(0, 2))


def test_partglot_triplet(tmp_path):
    rng = np.random.RandomState(8)
    T, n_seg, npt = 6, 5, 16
    path = str(tmp_path / "packed.npz")
    np.savez(path, gt_geos=rng.randn(T, n_seg, npt, 3), distractor_geos=rng.randn(T, n_seg, npt, 3),
             gt_mask=rng.randint(0, 2, (T, n_seg)), distractor_mask=rng.randint(0, 2, (T, n_seg)),
             texts=rng.randint(0, 40, (T, 12)), part_indicator=rng.randint(0, 2, (T, K)))
    both(dict(type="PartglotTriplet", batch_size=4, path=path), epochs=(0, 1))


# ---------------------------------------------------------------- super-segments
SUPSEG = 128  # points a shape


@pytest.fixture()
def supseg_root(tmp_path):
    rng = np.random.RandomState(9)
    with open(tmp_path / "shapenet_pointcloud_pn_aware.pkl", "wb") as f:
        pickle.dump(clouds(10, points=SUPSEG), f)
    with open(tmp_path / "shapenet_label_pn_aware.pkl", "wb") as f:
        pickle.dump(rng.rand(S, SUPSEG, K).astype(np.float32) * 3.0, f)
    return str(tmp_path)


SUPSEG_FLAGS = {
    "plain": {},
    "augment": dict(augment=True, vertical_only=True, shift_only=False),
    "contrastive": dict(contrastive_learning=True, augment_prob=0.5, vertical_only=True),
    "augment_attn": dict(augment_attn=True),
    "normalize_attn": dict(normalize_attn=True),
    "global_shift": dict(global_shift_prob=0.6, vertical_only=True),
}


@pytest.mark.parametrize("split", ["train", "test", "all"])
@pytest.mark.parametrize("flag", sorted(SUPSEG_FLAGS))
def test_supseg(supseg_root, split, flag):
    """The 80/20 split under each augmentation flag; the test split refuses
    augment and the contrastive triple in both packages."""
    cfg = dict(type="ShapeNetSupSeg", batch_size=3, data_root=supseg_root, split=split,
               **SUPSEG_FLAGS[flag])
    if split == "test" and flag in ("augment", "contrastive"):
        with pytest.raises(AssertionError):
            build_from_cfg(dict(cfg), DATASETS)
        with pytest.raises(AssertionError):
            jax_build(dict(cfg), JAX_DATASETS)
        return
    port, _ = both(cfg, epochs=(0, 1))
    assert len(port.dataset) == {"train": 8, "test": 2, "all": 10}[split]
    item = port.dataset[0]
    assert "global_anchor_mean" in item
    if flag == "contrastive":
        assert item["input"].shape == (3, SUPSEG, 3)


def test_supseg_shift_only_and_alias(supseg_root):
    both(dict(type="ShapeNetSegSuperSegment", batch_size=4, data_root=supseg_root, split="all",
              augment=True, shift_only=True))


def test_supseg_npz_fallback(packed):
    both(dict(type="ShapeNetSupSeg", batch_size=3, path=packed["labelled"], npoints=64,
              scale_mode="shape_bbox"))


@pytest.fixture()
def partglot_root(tmp_path):
    rng = np.random.RandomState(10)
    n_seg, npt = 6, 16
    mask = (rng.rand(S, n_seg) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    with open(tmp_path / "partglot_shapenet_seg_out_pn_aware_raw.pkl", "wb") as f:
        pickle.dump(dict(geos=rng.randn(S, n_seg, npt, 3).astype(np.float32), geos_masks=mask,
                         attn_maps=rng.rand(S, K, n_seg).astype(np.float32)), f)
    return str(tmp_path)


@pytest.mark.parametrize("split, kw", [
    ("train", {}), ("test", {}), ("all", {}), ("train", dict(augment=True)),
    ("all", dict(augment=True, vertical_only=True, scale_mode="shape_half")),
])
def test_supseg_partglot(partglot_root, split, kw):
    port, _ = both(dict(type="ShapeNetSupSegPartglot", batch_size=4, data_root=partglot_root,
                        split=split, **kw), epochs=(0, 1))
    ds = port.dataset
    # geo_mask is sliced with the split, and an item leaves the cache as it was
    num_train = int(S * 0.8)
    assert len(ds.geo_mask) == len(ds.segs_data) == {"train": num_train, "test": S - num_train,
                                                     "all": S}[split]
    before = ds.segs_data.copy()
    first, again = ds[0], ds[0]
    if not kw.get("augment"):
        assert_items_equal(first, again)
    np.testing.assert_array_equal(ds.segs_data, before)


def test_supseg_partglot_refuses_augmented_test_split(partglot_root):
    cfg = dict(type="ShapeNetSegSuperSegmentParglot", batch_size=2, data_root=partglot_root,
               split="test", augment=True)
    with pytest.raises(AssertionError):
        build_from_cfg(dict(cfg), DATASETS)
    with pytest.raises(AssertionError):
        jax_build(dict(cfg), JAX_DATASETS)


def test_supseg_partglot_npz_fallback(packed):
    both(dict(type="ShapeNetSegSuperSegmentParglot", batch_size=3, path=packed["labelled"],
              npoints=64))


# ---------------------------------------------------------------- ShapeNet-55
SN55_POINTS = 96


@pytest.fixture()
def sn55_root(tmp_path):
    """``ShapeNet55/{train,test}.txt`` over ``shapenet_pc``: airplanes of 300
    points (above npoints) and chairs of 60 (below)."""
    root, pc_dir = tmp_path / "ShapeNet55", tmp_path / "shapenet_pc"
    root.mkdir()
    pc_dir.mkdir()
    rng = np.random.RandomState(11)
    names = []
    for tax, n, pts in (("02691156", 4, 300), ("03001627", 3, 60)):
        for i in range(n):
            name = f"{tax}-model{i}.npy"
            np.save(pc_dir / name, (rng.randn(pts, 3) * 0.5).astype(np.float32))
            names.append(name)
    (root / "train.txt").write_text("\n".join(names))
    (root / "test.txt").write_text("\n".join(names[2:6]))
    return str(root)


@pytest.mark.parametrize("split, mode, crop", [
    ("test", "easy", None), ("test", "median", None), ("test", "hard", None),
    ("test", "complete", None), ("train", "median", (0.25, 0.75)), ("train", "hard", 0.5),
])
def test_shapenet55(sn55_root, split, mode, crop):
    """Clouds above npoints (the fixed permutation) and below it (resampled),
    over two epochs (``set_epoch`` reseeds the resampling); the crop range
    of each mode for the test split and of ``crop`` for the others; whole
    batches dropped except in the test split."""
    kw = {} if crop is None else dict(crop=crop)
    cfg = dict(type="ShapeNet", batch_size=2, root=sn55_root, npoints=SN55_POINTS, split=split,
               mode=mode, **kw)
    port = build_from_cfg(dict(cfg), DATASETS, device="cpu")[0]
    ref = jax_build(dict(cfg), JAX_DATASETS)[0]
    assert port.crop == ref.crop
    assert port.loader.drop_last == ref.loader.drop_last == (split != "test")
    assert port.device.type == "cpu"
    for epoch in (0, 3):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        for got, want in zip(port.loader, ref.loader):
            assert_items_equal(got, want)
    if split == "test":
        batch = next(iter(port))
        crop_n = port.crop
        if crop_n == SN55_POINTS:
            assert "missing" not in batch and batch["partial"].shape == (2, SN55_POINTS, 3)
        else:
            assert batch["partial"].shape == (2, SN55_POINTS - crop_n, 3)
            assert batch["missing"].shape == (2, crop_n, 3)
        assert batch["partial"].device.type == "cpu"


def test_shapenet55_categories(sn55_root):
    """The category filter by taxonomy id; an unknown category or an
    unknown id in the split file raises in both packages."""
    for cats, n in ((("all",), 7), (("chair",), 3), (("airplane", "chair"), 7)):
        port = pcustom._ShapeNet55(sn55_root, SN55_POINTS, "train", cats=cats)
        ref = jcustom._ShapeNet55(sn55_root, SN55_POINTS, "train", cats=cats)
        assert len(port) == len(ref) == n
        for i in range(n):
            assert_items_equal(port[i], ref[i])
    for mod in (pcustom, jcustom):
        with pytest.raises(AssertionError):
            mod._ShapeNet55(sn55_root, SN55_POINTS, "train", cats=("spaceship",))
    with open(os.path.join(sn55_root, "val.txt"), "w") as f:
        f.write("99999999-model0.npy\n")
    for mod in (pcustom, jcustom):
        with pytest.raises(KeyError):
            mod._ShapeNet55(sn55_root, SN55_POINTS, "val")


def test_shapenet55_loader_device_is_the_callers(sn55_root):
    """The cropping loader works on the device it is given: the CPU when
    asked, the card by default (which raises where there is none)."""
    cfg = dict(type="ShapeNet", batch_size=2, root=sn55_root, npoints=SN55_POINTS, split="test")
    assert build_from_cfg(dict(cfg), DATASETS, device="cpu")[0].device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            build_from_cfg(dict(cfg), DATASETS)


def test_runner_builds_loaders_on_its_device(sn55_root, tmp_path):
    """A Runner on the CPU gives its device to the DATASETS factories: its
    ShapeNet loaders crop on the CPU."""
    from difffacto_torch import Config
    from difffacto_torch.runner import Runner

    cfg = Config(os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                              "tiny_gen.py"))
    cfg.work_dir = str(tmp_path / "run")
    for split in ("train", "val"):
        cfg.dataset[split] = cfg.dfs(dict(type="ShapeNet", batch_size=2, root=sn55_root,
                                          npoints=SN55_POINTS, split="test"))
    r = Runner(cfg=cfg, device="cpu")
    assert r.train_loader.device.type == r.val_loader.device.type == "cpu"


# ---------------------------------------------------------------- evaluate
@pytest.mark.parametrize("make", [
    lambda mod, p: mod.CustomDatasetImpl(p["npz"], npoints=64),
    lambda mod, p: mod._ArrayPartDataset(np.load(p["npz"])["pred"],
                                         np.load(p["npz"])["pred_seg_mask"], 64, K),
], ids=["custom", "array"])
def test_evaluate_passes_the_jax_arguments_and_the_device(dump, monkeypatch, make):
    """``evaluate`` calls the protocol with the JAX call's arguments (no
    ``using_whole_chair_only``) and the caller's device, the card unless it
    asks for the CPU."""
    from difffacto_torch.metrics import eval as peval
    from difffacto_tpu.metrics import eval as jeval

    seen = {}
    monkeypatch.setattr(peval, "evaluate_batches", lambda *a, **k: seen.setdefault("port", (a, k)))
    monkeypatch.setattr(jeval, "evaluate_batches", lambda *a, **k: seen.setdefault("jax", (a, k)))
    make(pcustom, dump).evaluate(["r"], 1, device="cpu")
    make(jcustom, dump).evaluate(["r"], 1)
    (pa, pk), (ja, jk) = seen["port"], seen["jax"]
    assert pa == ja and pk.pop("device") == "cpu" and pk == jk
    seen.clear()
    make(pcustom, dump).evaluate(["r"], 1)
    assert seen["port"][1]["device"] == "cuda"
