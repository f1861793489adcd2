"""ShapeNet-Part datasets with per-part normalisation.

The port's own copy of ``difffacto_tpu/data/shapenet_seg.py`` (numpy only):
``ShapeNetSegPartDataset``, ``ShapeNetSegDataset`` and their ``ShapeNetSegPart``
and ``ShapeNetSeg`` builders. The text files are parsed once by the port's
native parser (``native/txtparse.cpp``) and packed into
``<root>/packed_<class>_<split>.npz``, in the JAX package's format, so either
package reads the other's pack. Items equal the JAX package's bit for bit for
the same seed and read order.

Item dicts are channel-last: part_shift and part_scale are (K, 3).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from ..utils.registry import DATASETS
from .dataset_utils import DataLoader, pc_norm, seg_classes, shapenet_part_normal_cat_to_id


def _load_split_tokens(root: str, split: str) -> set:
    names = {
        "train": ["shuffled_train_file_list.json"],
        "val": ["shuffled_val_file_list.json"],
        "test": ["shuffled_test_file_list.json"],
        "trainval": ["shuffled_train_file_list.json", "shuffled_val_file_list.json"],
        "all": [
            "shuffled_train_file_list.json",
            "shuffled_val_file_list.json",
            "shuffled_test_file_list.json",
        ],
    }[split]
    toks = set()
    for n in names:
        with open(os.path.join(root, "train_test_split", n)) as f:
            toks |= {str(d.split("/")[2]) for d in json.load(f)}
    return toks


class ShapeNetSegPartDataset:
    """In-memory packed ShapeNet-Part category split."""

    # attn_map/ref_attn_map are exactly eye(K)[seg_mask]: the runner sends
    # the seg masks alone and rebuilds the maps on the device (device_batch).
    attn_from_seg = True

    def __init__(
        self,
        root: str,
        npoints: int,
        split: str,
        class_choice: str = "Chair",
        scale_mode: str = "shape_unit",
        part_scale_mode: Optional[str] = None,
        part_normalize: bool = True,
        eval_mode: str = "ae",
        save_only: bool = False,
        augment: bool = False,
        augment_shift: bool = False,
        augment_scale: bool = False,
        dropout_part: float = 0.0,
        using_whole_chair_only: bool = False,
        clip: bool = True,
        seed: int = 0,
    ):
        self.root = root
        self.npoints = npoints
        self.split = split
        self.class_choice = class_choice
        self.scale_mode = scale_mode
        self.part_scale_mode = part_scale_mode or scale_mode
        self.part_normalize = part_normalize
        self.eval_mode = eval_mode
        self.save_only = save_only
        if augment:
            augment_shift = augment_scale = True
        self.augment_shift = augment_shift
        self.augment_scale = augment_scale
        self.dropout_part = dropout_part
        self.using_whole_chair_only = using_whole_chair_only
        self.clip = clip
        self.num_class = len(seg_classes[class_choice])
        self.seg_base = seg_classes[class_choice][0]
        self._rng = np.random.RandomState(seed)
        self.noises: Dict[int, np.ndarray] = {}

        self._points: List[np.ndarray] = []
        self._segs: List[np.ndarray] = []
        self.tokens: List[str] = []
        self._load()

    # ------------------------------------------------------------------ load
    def _pack_path(self):
        return os.path.join(
            self.root, f"packed_{self.class_choice}_{self.split}.npz"
        )

    def _load(self):
        pack = self._pack_path()
        if os.path.exists(pack):
            z = np.load(pack, allow_pickle=True)
            offsets = z["offsets"]
            pts, segs = z["points"], z["segs"]
            self.tokens = list(z["tokens"])
            for i in range(len(offsets) - 1):
                s, e = offsets[i], offsets[i + 1]
                self._points.append(pts[s:e])
                self._segs.append(segs[s:e])
            return
        cat_dir = os.path.join(self.root, shapenet_part_normal_cat_to_id[self.class_choice])
        toks = _load_split_tokens(self.root, self.split)
        fns = sorted(
            fn for fn in os.listdir(cat_dir) if os.path.splitext(fn)[0] in toks
        )
        from ..native import fast_loadtxt

        for fn in fns:
            data = fast_loadtxt(os.path.join(cat_dir, fn))
            self._points.append(np.ascontiguousarray(data[:, :3]))
            self._segs.append((data[:, -1].astype(np.int32) - self.seg_base).astype(np.int8))
            self.tokens.append(os.path.splitext(fn)[0])
        # one-time pack so the next run skips loadtxt entirely
        try:
            offsets = np.zeros(len(self._points) + 1, np.int64)
            offsets[1:] = np.cumsum([len(p) for p in self._points])
            np.savez_compressed(
                pack,
                points=np.concatenate(self._points) if self._points else np.zeros((0, 3), np.float32),
                segs=np.concatenate(self._segs) if self._segs else np.zeros((0,), np.int8),
                offsets=offsets,
                tokens=np.array(self.tokens),
            )
        except OSError:
            pass

    def __len__(self):
        return len(self._points)

    # --------------------------------------------------------------- CIMLE
    def store_noise(self, all_noises, all_ids):
        """Cache per-sample CIMLE noise keyed by dataset index
        (shapenet_seg.py:185-190)."""
        self.noises = {}
        for noises, ids in zip(all_noises, all_ids):
            for i, idx in enumerate(np.asarray(ids)):
                self.noises[int(idx)] = np.asarray(noises[i])

    # ---------------------------------------------------------------- items
    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        point_set = self._points[index]
        seg_full = self._segs[index].astype(np.int64)
        rng = self._rng
        K = self.num_class

        noise = self.noises.get(index, np.zeros(1, np.float32))
        choice = rng.choice(point_set.shape[0], self.npoints, replace=True)
        ori = point_set[choice]
        seg = seg_full[choice].copy()

        ori, shift, scale = pc_norm(ori, self.scale_mode)
        out = ori.copy() if not self.part_normalize else np.zeros_like(ori)
        present = np.zeros(K, np.float32)
        shifts = np.zeros((K, 3), np.float32)
        scales = np.ones((K, 3), np.float32)

        for i in range(K):
            idx = seg == i
            cnt = int(idx.sum())
            if cnt >= 10:
                part = ori[idx]
                std = part.std(0)
                if np.any(std == 0.0):
                    present[i] = 0
                else:
                    present[i] = 1
                norm_part, pshift, pscale = pc_norm(
                    part, self.part_scale_mode, clip=self.clip
                )
                shifts[i] = pshift[0]
                scales[i] = pscale[0] if pscale.shape[-1] == 3 else pscale[0].repeat(3)
                if self.part_normalize:
                    out[idx] = norm_part
            elif cnt > 0:
                # Relabel stragglers to their nearest neighbor's part
                # (shapenet_seg.py:487-494).
                part_pts = ori[idx]
                rest_pts = ori[~idx]
                rest_seg = seg[~idx]
                d = ((part_pts[:, None] - rest_pts[None]) ** 2).sum(-1)
                seg[idx] = rest_seg[d.argmin(1)]

        onehot = np.eye(K, dtype=np.float32)[seg]
        dp_present = present.copy()
        if self.dropout_part > 0:
            drop = rng.rand(K) < self.dropout_part
            dp_present[drop] = 0

        if self.augment_shift or self.augment_scale:
            rand_scale = (
                rng.rand(1, 3).astype(np.float32) / 2 + 0.7
                if self.augment_scale
                else np.ones((1, 3), np.float32)
            )
            rand_shift = (
                rng.rand(1, 3).astype(np.float32) - 0.5
                if self.augment_shift
                else np.zeros((1, 3), np.float32)
            )
            ori = (ori + rand_shift) * rand_scale
            shift = shift + scale * rand_shift
            scale = rand_scale * scale

        return {
            "present": present,
            "dp_present": dp_present,
            "part_scale": scales,
            "part_shift": shifts,
            "input": out,
            "ref_attn_map": onehot,
            "attn_map": onehot,
            "ref": ori,
            "ref_seg_mask": seg.astype(np.int32),
            "seg_mask": seg.astype(np.int32),
            "shift": shift,
            "scale": scale,
            "id": np.int32(index),
            "token": self.tokens[index],
            "noise": noise.astype(np.float32),
        }

    # ----------------------------------------------------------------- eval
    def evaluate(self, results, save_num_batch, device="cuda"):
        """Dispatch eval by mode."""
        from ..metrics.eval import evaluate_batches

        return evaluate_batches(
            results,
            save_num_batch,
            eval_mode=self.eval_mode,
            save_only=self.save_only,
            num_class=self.num_class,
            class_choice=self.class_choice,
            using_whole_chair_only=self.using_whole_chair_only,
            device=device,
        )


class ShapeNetSegDataset(ShapeNetSegPartDataset):
    """Whole-shape variant, faithful to the reference's ``_ShapeNetSeg``
    (reference shapenet_seg.py:110-286), whose item semantics differ from
    the Parts dataset in four ways: input IS the shape-normalized cloud (no
    per-part canonical normalization), presence is ANY-point (no >=10-point
    threshold and no straggler relabeling), part stats are the raw mean and
    unbiased std of each part (not pc_norm shift/scale), and the augment
    transform divides (``(x - shift) / scale``, shapenet_seg.py:268-273)
    while the Parts variant multiplies — a reference inconsistency kept
    as-is (the shift/scale BOOKKEEPING uses the multiply convention in
    both).
    """

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        point_set = self._points[index]
        seg = self._segs[index].astype(np.int64)
        rng = self._rng
        K = self.num_class

        noise = self.noises.get(index, np.zeros(1, np.float32))
        choice = rng.choice(point_set.shape[0], self.npoints, replace=True)
        pts = point_set[choice]
        seg = seg[choice]

        pts, shift, scale = pc_norm(pts, self.scale_mode)
        present = np.zeros(K, np.float32)
        means = np.zeros((K, 3), np.float32)
        stds = np.ones((K, 3), np.float32)
        for i in range(K):
            idx = seg == i
            cnt = int(idx.sum())
            if cnt > 0:
                present[i] = 1
                part = pts[idx]
                means[i] = part.mean(0)
                # torch .std(0) default is unbiased (ddof=1); a 1-point part
                # yields NaN on both sides (shapenet_seg.py:245-250).
                stds[i] = part.std(0, ddof=1) if cnt > 1 else np.nan

        if self.augment_shift or self.augment_scale:
            rand_scale = (
                rng.rand(1, 3).astype(np.float32) / 2 + 0.7
                if self.augment_scale
                else np.ones((1, 3), np.float32)
            )
            rand_shift = (
                rng.rand(1, 3).astype(np.float32) - 0.5
                if self.augment_shift
                else np.zeros((1, 3), np.float32)
            )
            pts = (pts - rand_shift) / rand_scale
            shift = shift + scale * rand_shift
            scale = rand_scale * scale

        onehot = np.eye(K, dtype=np.float32)[seg]
        return {
            "present": present,
            "part_scale": stds,
            "part_shift": means,
            "input": pts,
            "ref_attn_map": onehot,
            "attn_map": onehot,
            "ref": pts,
            "ref_seg_mask": seg.astype(np.int32),
            "seg_mask": seg.astype(np.int32),
            "shift": shift,
            "scale": scale,
            "id": np.int32(index),
            "token": self.tokens[index],
            "noise": noise.astype(np.float32),
        }


@DATASETS.register_module()
def ShapeNetSeg(
    batch_size,
    root,
    npoints,
    split,
    num_workers=0,
    eval_mode="ae",
    scale_mode="shape_unit",
    distributed=False,
    shuffle=True,
    drop_last=True,
    class_choice="Chair",
    save_only=False,
    augment=False,
    augment_shift=False,
    augment_scale=False,
    **_,
):
    """Whole-shape variant (reference shapenet_seg.py:47-67 / _ShapeNetSeg)."""
    ds = ShapeNetSegDataset(
        root,
        npoints,
        split,
        class_choice=class_choice,
        scale_mode=scale_mode,
        eval_mode=eval_mode,
        save_only=save_only,
        augment=augment,
        augment_shift=augment_shift,
        augment_scale=augment_scale,
    )
    return DataLoader(ds, batch_size=batch_size, shuffle=shuffle, drop_last=drop_last, num_workers=num_workers), None


@DATASETS.register_module()
def ShapeNetSegPart(
    batch_size,
    root,
    npoints,
    split,
    num_workers=0,
    eval_mode="ae",
    scale_mode="shape_unit",
    part_scale_mode=None,
    distributed=False,
    shuffle=True,
    drop_last=True,
    class_choice="Chair",
    save_only=False,
    augment=False,
    augment_shift=False,
    augment_scale=False,
    using_whole_chair_only=False,
    clip=True,
    dropout_part=0.0,
):
    """Factory matching the reference registry entry (shapenet_seg.py:16-40).
    Returns (loader, sampler=None)."""
    ds = ShapeNetSegPartDataset(
        root,
        npoints,
        split,
        class_choice=class_choice,
        scale_mode=scale_mode,
        part_scale_mode=part_scale_mode,
        eval_mode=eval_mode,
        save_only=save_only,
        augment=augment,
        augment_shift=augment_shift,
        augment_scale=augment_scale,
        dropout_part=dropout_part,
        using_whole_chair_only=using_whole_chair_only,
        clip=clip,
    )
    return DataLoader(ds, batch_size=batch_size, shuffle=shuffle, drop_last=drop_last, num_workers=num_workers), None
