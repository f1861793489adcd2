"""The port's ShapeNet-Part datasets against the JAX package's, on a small
tree of real-format files that the test writes (``build_shapenet_tree``):
split tokens, the text load, the ``.npz`` pack that either package reads,
the straggler relabel and items, bit for bit for the same seed and read
order; and the port's native parser, built under ``build/native/``."""

import os

import numpy as np
import pytest

from difffacto_tpu.data import shapenet_seg as jss
from difffacto_torch import native
from difffacto_torch.data import shapenet_seg as pss
from test_shapenet_format import N_RAW, STRAGGLER_PART, STRAGGLER_TOKEN, SYNSET, build_shapenet_tree
from test_torch_data import assert_items_equal


@pytest.fixture()
def tree(tmp_path):
    return build_shapenet_tree(tmp_path)


@pytest.mark.parametrize("split", ["train", "val", "test", "trainval", "all"])
def test_split_tokens(tree, split):
    assert pss._load_split_tokens(tree, split) == jss._load_split_tokens(tree, split)


@pytest.mark.parametrize("first", ["port", "jax"])
def test_pack_is_shared(tree, first):
    """Whichever package parses the text files first writes the pack; the
    other reads it, and both hold the same clouds, labels and tokens as a
    parse of the text."""
    make = {"port": pss.ShapeNetSegPartDataset, "jax": jss.ShapeNetSegPartDataset}
    a = make[first](tree, npoints=64, split="train")
    assert os.path.exists(a._pack_path())
    b = make["jax" if first == "port" else "port"](tree, npoints=64, split="train")
    assert a.tokens == b.tokens == sorted(["a1f2deadbeef00", STRAGGLER_TOKEN, "c3e4cafe1234aa"])
    for p1, p2, s1, s2 in zip(a._points, b._points, a._segs, b._segs):
        np.testing.assert_array_equal(p1, p2)
        np.testing.assert_array_equal(s1, s2)
        assert p1.dtype == p2.dtype and s1.dtype == s2.dtype == np.int8


@pytest.mark.parametrize("cls,kwargs", [
    ("ShapeNetSegPartDataset", dict(npoints=N_RAW, seed=3)),
    ("ShapeNetSegPartDataset", dict(npoints=128, seed=4, augment=True, dropout_part=0.5,
                                    part_scale_mode="shape_canonical", clip=False)),
    ("ShapeNetSegDataset", dict(npoints=96, seed=5, augment=True)),
], ids=["part", "part-augment-dropout", "whole"])
def test_items_bit_for_bit(tree, cls, kwargs):
    """Items in one read order from both packages, from the text (port) and
    from its pack (JAX), then after store_noise; the straggler relabel keeps
    no part of 1 to 9 points."""
    mine = getattr(pss, cls)(tree, split="train", **kwargs)
    ref = getattr(jss, cls)(tree, split="train", **kwargs)
    order = [1, 0, 2, 1, 1, 2]
    for idx in order:
        assert_items_equal(mine[idx], ref[idx])
    noises, ids = [np.arange(6, dtype=np.float32).reshape(3, 2)], [np.array([2, 0, 1], np.int32)]
    mine.store_noise(noises, ids)
    ref.store_noise(noises, ids)
    assert_items_equal(mine[0], ref[0])
    if cls == "ShapeNetSegPartDataset" and "augment" not in kwargs:
        item = mine[mine.tokens.index(STRAGGLER_TOKEN)]
        counts = np.bincount(item["seg_mask"], minlength=4)
        assert all(c == 0 or c >= 10 for c in counts) and counts[STRAGGLER_PART] == 0


def test_builders_give_the_same_batches(tree):
    kw = dict(batch_size=2, root=tree, npoints=64, split="train", shuffle=True, drop_last=True)
    mine, _ = pss.ShapeNetSegPart(**kw)
    ref, _ = jss.ShapeNetSegPart(**kw)
    assert len(mine) == len(ref) == 1
    for g, w in zip(mine, ref):
        assert_items_equal(g, w)
    mine, _ = pss.ShapeNetSeg(**kw)
    ref, _ = jss.ShapeNetSeg(**kw)
    for g, w in zip(mine, ref):
        assert_items_equal(g, w)


def test_native_parser_matches_loadtxt(tree, tmp_path):
    """The library is built under build/native/ (never beside its source)
    and parses a real-format file and scientific notation as np.loadtxt does."""
    assert native.get_lib() is not None
    lib = native.library_path()
    assert lib.exists() and lib.parent.name == "native" and lib.parent.parent.name == "build"
    assert not list(native.SRC.parent.glob("*.so"))
    path = os.path.join(tree, SYNSET, f"{STRAGGLER_TOKEN}.txt")
    np.testing.assert_array_equal(native.fast_loadtxt(path),
                                  np.loadtxt(path).astype(np.float32))
    sci = str(tmp_path / "sci.txt")
    np.savetxt(sci, np.random.RandomState(1).randn(40, 3) * 1e-5, fmt="%.8e")
    np.testing.assert_allclose(native.fast_loadtxt(sci), np.loadtxt(sci, dtype=np.float32),
                               rtol=1e-6)
