"""Datasets over generated results and the other dataset families.

The port's own copy of ``difffacto_tpu/data/custom.py``: numpy on the host,
so every item equals the JAX package's bit for bit for the same files and
seed. ``CustomDataset`` re-serves a dump of generated shapes (``pred``,
``pred_seg_mask``) as model inputs for part mixing; ``ShapeNetParts`` reads
pre-packed (S, N, 3) clouds; ``Partnet`` per-split npz clouds with per-point
labels; ``ShapeNetSupSeg`` and ``ShapeNetSupSegPartglot`` PartGlot's
super-segments; ``PartglotTriplet`` the language games that
``tools/pack_partglot_torch.py`` packs; ``ShapeNetPart`` the reference alias
of ``ShapeNetParts``; ``ShapeNet`` ShapeNet-55's whole clouds for
completion, whose ``CroppingDataLoader`` crops on the loader's device and
resamples with the FPS kernel there. ``evaluate`` runs the protocol's
kernels on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict

import numpy as np
import torch

from ..utils.registry import DATASETS
from .dataset_utils import CroppingDataLoader, DataLoader, pc_norm, shapenet55_id_to_cat


class _PartEvalMixin:
    """The CIMLE noise store and the eval dispatch of this module's datasets
    (each sets eval_mode, save_only, num_class and class_choice). As in the
    JAX package, ``evaluate`` passes no ``using_whole_chair_only``."""

    def store_noise(self, all_noises, all_ids):
        self.noises = {}
        for noises, ids in zip(all_noises, all_ids):
            for i, idx in enumerate(np.asarray(ids)):
                self.noises[int(idx)] = np.asarray(noises[i])

    def evaluate(self, results, save_num_batch, device="cuda"):
        from ..metrics.eval import evaluate_batches

        return evaluate_batches(
            results, save_num_batch, eval_mode=self.eval_mode,
            save_only=self.save_only, num_class=self.num_class,
            class_choice=self.class_choice, device=device,
        )


class CustomDatasetImpl(_PartEvalMixin):
    """A dump of generated shapes (``.pkl`` or ``.npz`` with ``pred`` and
    ``pred_seg_mask``): each item is resampled, shape-normalized, then each
    part canonically normalized (at least 10 points, a part with a zero std
    marked absent, stragglers relabelled to their nearest other point's
    part)."""

    def __init__(self, path: str, npoints: int = 2048, n_class: int = 4,
                 eval_mode: str = "gen", save_only: bool = True,
                 scale_mode: str = "shape_unit",
                 part_scale_mode: str = "shape_canonical", clip: bool = True,
                 seed: int = 0):
        if path.endswith(".pkl") or path.endswith(".pickle"):
            with open(path, "rb") as f:
                data = pickle.load(f)
        else:
            data = dict(np.load(path, allow_pickle=True))
        self.pred = np.asarray(data["pred"], np.float32)
        self.seg = np.asarray(data["pred_seg_mask"], np.int64)
        self.n_class = n_class
        self.num_class = n_class
        self.npoints = npoints
        self.eval_mode = eval_mode
        self.save_only = save_only
        self.scale_mode = scale_mode
        self.part_scale_mode = part_scale_mode
        self.clip = clip
        self.class_choice = "Chair"
        self.using_whole_chair_only = False
        self.noises: Dict[int, np.ndarray] = {}
        self._rng = np.random.RandomState(seed)

    def __len__(self):
        return self.pred.shape[0]

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        K = self.n_class
        choice = self._rng.choice(self.pred[index].shape[0], self.npoints, replace=True)
        ori = self.pred[index][choice]
        seg = self.seg[index][choice].copy()
        ori, shift, scale = pc_norm(ori, self.scale_mode)
        out = np.zeros_like(ori)
        present = np.zeros(K, np.float32)
        shifts = np.zeros((K, 3), np.float32)
        scales = np.ones((K, 3), np.float32)
        for i in range(K):
            idx = seg == i
            if idx.sum() >= 10:
                part = ori[idx]
                present[i] = 0.0 if np.any(part.std(0) == 0.0) else 1.0
                npart, ps, psc = pc_norm(part, self.part_scale_mode, clip=self.clip)
                shifts[i] = ps[0]
                scales[i] = psc[0] if psc.shape[-1] == 3 else psc[0].repeat(3)
                out[idx] = npart
            elif idx.any():
                rest = ori[~idx]
                rest_seg = seg[~idx]
                d = ((ori[idx][:, None] - rest[None]) ** 2).sum(-1)
                seg[idx] = rest_seg[d.argmin(1)]
        onehot = np.eye(K, dtype=np.float32)[seg]
        return {
            "present": present,
            "dp_present": present.copy(),
            "part_scale": scales,
            "part_shift": shifts,
            "input": out,
            "ref": ori,
            "ref_attn_map": onehot,
            "attn_map": onehot,
            "ref_seg_mask": seg.astype(np.int32),
            "seg_mask": seg.astype(np.int32),
            "shift": shift,
            "scale": scale,
            "id": np.int32(index),
            "token": f"custom_{index}",
            "noise": self.noises.get(index, np.zeros(1, np.float32)),
        }


@DATASETS.register_module()
def CustomDataset(batch_size, path=None, data_dir=None, npoints=2048, n_class=4,
                  shuffle=False, drop_last=False, eval_mode="gen", save_only=True,
                  scale_mode="shape_unit", part_scale_mode="shape_canonical",
                  clip=True, distributed=False, **_):
    """``data_dir`` (the reference's name) and ``path`` are aliases."""
    ds = CustomDatasetImpl(
        path or data_dir, npoints, n_class, eval_mode, save_only,
        scale_mode=scale_mode, part_scale_mode=part_scale_mode, clip=clip,
    )
    return DataLoader(ds, batch_size=batch_size, shuffle=shuffle, drop_last=drop_last), None


class _ArrayPartDataset(_PartEvalMixin):
    """(num_shapes, N, 3) points and (num_shapes, N) labels, resampled and
    normalized per shape and per part."""

    def __init__(self, points, labels, npoints, n_class, scale_mode="shape_unit",
                 part_scale_mode="shape_canonical", eval_mode="ae", save_only=False,
                 clip=True, class_choice="Chair"):
        self.points = points
        self.labels = labels
        self.npoints = npoints
        self.n_class = n_class
        self.num_class = n_class
        self.scale_mode = scale_mode
        self.part_scale_mode = part_scale_mode
        self.eval_mode = eval_mode
        self.save_only = save_only
        self.clip = clip
        self.class_choice = class_choice
        self.using_whole_chair_only = False
        self.noises: Dict[int, np.ndarray] = {}
        self._rng = np.random.RandomState(0)

    def __len__(self):
        return self.points.shape[0]

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        pts_full = self.points[index]
        seg_full = self.labels[index].astype(np.int64)
        choice = self._rng.choice(pts_full.shape[0], self.npoints, replace=True)
        ori, seg = pts_full[choice].astype(np.float32), seg_full[choice]
        K = self.n_class
        ori, shift, scale = pc_norm(ori, self.scale_mode)
        out = np.zeros_like(ori)
        present = np.zeros(K, np.float32)
        shifts = np.zeros((K, 3), np.float32)
        scales = np.ones((K, 3), np.float32)
        for i in range(K):
            idx = seg == i
            if idx.sum() >= 10:
                present[i] = 1
                npart, ps, pc_ = pc_norm(ori[idx], self.part_scale_mode, clip=self.clip)
                shifts[i] = ps[0]
                scales[i] = pc_[0] if pc_.shape[-1] == 3 else pc_[0].repeat(3)
                out[idx] = npart
        onehot = np.eye(K, dtype=np.float32)[seg]
        return {
            "present": present,
            "dp_present": present.copy(),
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
            "token": f"shape_{index}",
            "noise": self.noises.get(index, np.zeros(1, np.float32)),
        }


class ShapeNetPartsDataset(_PartEvalMixin):
    """Pre-packed whole clouds: one (S, N, 3) array in an ``.npz``
    (``points``), an ``.npy`` or a ``torch.save``d tensor (read with
    ``weights_only=True``); each item is resampled and normalized
    (``scale_mode=None`` leaves it as it is). No labels."""

    def __init__(self, path, npoints=2048, scale_mode=None, eval_mode="ae",
                 seed=0, _preloaded=None):
        if _preloaded is not None:  # factory already opened the file
            self.data = np.asarray(_preloaded, np.float32)
        elif path.endswith((".npz", ".npy")):
            z = np.load(path, allow_pickle=True)
            self.data = np.asarray(z["points"] if hasattr(z, "files") else z,
                                   np.float32)
        else:
            self.data = torch.load(path, map_location="cpu", weights_only=True).numpy()
        self.npoints = npoints
        self.scale_mode = scale_mode
        self.eval_mode = eval_mode
        self.save_only = False
        self.num_class = 1
        self.class_choice = "Chair"
        self.using_whole_chair_only = False
        self.noises: Dict[int, np.ndarray] = {}
        self._rng = np.random.RandomState(seed)

    def __len__(self):
        return self.data.shape[0]

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        pts = self.data[index]
        choice = self._rng.choice(pts.shape[0], self.npoints, replace=True)
        pts, shift, scale = pc_norm(pts[choice], self.scale_mode)
        return {
            "input": pts,
            "ref": pts,
            "shift": shift,
            "scale": scale,
            "id": np.int32(index),
            "token": f"parts_{index}",
            "noise": self.noises.get(index, np.zeros(1, np.float32)),
        }


@DATASETS.register_module()
def ShapeNetParts(batch_size, path=None, root=None, npoints=2048, n_class=4,
                  shuffle=True, drop_last=False, split="train", eval_mode="ae",
                  save_only=False, distributed=False, **kwargs):
    """Pre-packed whole clouds; an npz with ``labels`` beside ``points``
    goes to the per-part dataset."""
    src = path or root
    z = None
    if src.endswith(".npz"):
        z = np.load(src, allow_pickle=True)
    if z is not None and "labels" in getattr(z, "files", ()):
        ds = _ArrayPartDataset(
            np.asarray(z["points"]), np.asarray(z["labels"]), npoints, n_class,
            eval_mode=eval_mode, save_only=save_only,
            **{k: v for k, v in kwargs.items() if k in (
                "scale_mode", "part_scale_mode", "clip", "class_choice")},
        )
    else:
        pre = None
        if z is not None:
            pre = z["points"] if "points" in getattr(z, "files", ()) else None
        ds = ShapeNetPartsDataset(
            src, npoints=npoints, scale_mode=kwargs.get("scale_mode"),
            eval_mode=eval_mode, _preloaded=pre,
        )
    return DataLoader(ds, batch_size=batch_size, shuffle=shuffle, drop_last=drop_last,
                      num_workers=int(kwargs.get("num_workers", 0))), None


def _augment_parts(rng, pts, seg, n_class, vertical_only=True, shift_only=False):
    """A random shift and scale for each part, drawn from ``rng`` (a numpy
    ``RandomState``)."""
    out = np.zeros_like(pts)
    scales, shifts = [], []
    for i in range(n_class):
        rand_scale = (
            rng.rand(1, 3).astype(np.float32) / 2 + 0.7
            if not shift_only
            else np.ones((1, 3), np.float32)
        )
        rand_shift = rng.rand(1, 3).astype(np.float32) - 0.5
        if vertical_only:
            rand_shift[:, [0, 2]] = 0.0
        scales.append(rand_scale)
        shifts.append(rand_shift)
        idx = seg == i
        out[idx] = (pts[idx] + rand_shift) * rand_scale
    return out, np.concatenate(scales, 0), np.concatenate(shifts, 0)


class SupSegDataset(_PartEvalMixin):
    """PartGlot super-segment shapes: two pickles
    (``shapenet_pointcloud_{part}.pkl`` (S, N, 3) and
    ``shapenet_label_{part}.pkl`` (S, N, n_class) attention maps), an 80/20
    train/test split, statistics over the full set before the split (for
    pc_norm and the ``global_anchor_mean`` key), the segmentation from each
    point's attention argmax, an optional softmax of the attention or noise
    on it, a random global shift, per-part augmentation and a contrastive
    triple (the shape, an augmented positive or the shape again, another
    shape as the negative), stacked as the JAX package stacks it."""

    attn_from_seg = False

    def __init__(self, data_root, split, part="pn_aware", scale_mode="shape_unit",
                 n_class=4, augment=False, contrastive_learning=False,
                 vertical_only=False, eval_mode="ae", shift_only=False,
                 augment_attn=False, normalize_attn=False, augment_prob=0.5,
                 global_shift_prob=0.0, seed=0):
        with open(os.path.join(data_root, f"shapenet_pointcloud_{part}.pkl"), "rb") as f:
            self.segs_data = np.asarray(pickle.load(f), np.float32)
        with open(os.path.join(data_root, f"shapenet_label_{part}.pkl"), "rb") as f:
            self.attn_map = np.asarray(pickle.load(f), np.float32)
        self.scale_mode = scale_mode
        self.n_class = n_class
        self.num_class = n_class
        self.eval_mode = eval_mode
        self.save_only = False
        self.class_choice = "Chair"
        self.using_whole_chair_only = False
        self.augment = augment
        self.contrastive_learning = contrastive_learning
        self.vertical_only = vertical_only
        self.shift_only = shift_only
        self.augment_attn = augment_attn
        self.normalize_attn = normalize_attn
        self.augment_prob = augment_prob
        self.global_shift_prob = global_shift_prob
        self.noises: Dict[int, np.ndarray] = {}
        self._rng = np.random.RandomState(seed)
        self._compute_stats()  # over the full set, before the split
        num_train = int(len(self.segs_data) * 0.8)
        if split == "train":
            self.segs_data = self.segs_data[:num_train]
            self.attn_map = self.attn_map[:num_train]
        elif split == "test":
            assert not (augment or contrastive_learning)
            self.segs_data = self.segs_data[num_train:]
            self.attn_map = self.attn_map[num_train:]

    def _compute_stats(self):
        """The set's mean and std and each part's mean anchor."""
        self.stats = {
            "mean": self.segs_data.reshape(-1, 3).mean(0),
            "std": self.segs_data.reshape(-1).std(),
        }
        part_means = [[] for _ in range(self.n_class)]
        for i in range(self.segs_data.shape[0]):
            seg = self.attn_map[i].argmax(1)
            for j in range(self.n_class):
                part = self.segs_data[i][seg == j]
                if part.shape[0] > 0:
                    part_means[j].append(part.mean(0))
        self.stats["part_means"] = np.stack(
            [np.stack(m, 0).mean(0) for m in part_means], 0
        ).astype(np.float32)

    def __len__(self):
        return len(self.segs_data)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rng = self._rng
        K = self.n_class
        geos, shift, scale = pc_norm(
            self.segs_data[idx].copy(), self.scale_mode, stats=self.stats
        )
        attn = self.attn_map[idx].copy()
        if self.global_shift_prob > 0 and rng.rand() < self.global_shift_prob:
            rand_shift = rng.rand(1, 3).astype(np.float32) - 0.5
            if self.vertical_only:
                rand_shift[:, [0, 2]] = 0.0
            geos = geos + rand_shift
            shift = shift - rand_shift / scale
        if self.normalize_attn:
            e = np.exp(attn - attn.max(1, keepdims=True))
            attn = e / e.sum(1, keepdims=True)
        seg = attn.argmax(1).astype(np.int32)
        if self.augment_attn:
            attn = np.clip(attn + rng.randn(*attn.shape).astype(np.float32) * 0.2 - 0.1,
                           0.0, 1.0)

        out = {
            "ref": geos,
            "attn_map": attn.astype(np.float32),
            "ref_attn_map": attn.astype(np.float32),
            "seg_mask": seg,
            "ref_seg_mask": seg,
            "shift": shift,
            "scale": scale,
            "id": np.int32(idx),
            "token": f"supseg_{idx}",
            "noise": self.noises.get(idx, np.zeros(1, np.float32)),
        }
        if self.augment:
            inp, part_scale, part_shift = _augment_parts(
                rng, geos, seg, K, vertical_only=self.vertical_only,
                shift_only=self.shift_only,
            )
            out.update(input=inp, part_scale=part_scale, part_shift=part_shift)
        elif self.contrastive_learning:
            pos = geos
            if rng.rand() < self.augment_prob:
                pos = _augment_parts(rng, geos, seg, K,
                                     vertical_only=self.vertical_only)[0]
            neg_id = int(rng.randint(0, len(self.segs_data)))
            if neg_id == idx:
                neg_id = (idx + 1) % len(self.segs_data)
            neg, neg_shift, neg_scale = pc_norm(
                self.segs_data[neg_id].copy(), self.scale_mode, stats=self.stats
            )
            neg_attn = self.attn_map[neg_id]
            comb_attn = np.stack([attn, attn, neg_attn], 0).astype(np.float32)
            out.update(
                input=np.stack([geos, pos, neg], 0),
                ref=np.stack([geos, geos, neg], 0),
                attn_map=comb_attn,
                seg_mask=comb_attn.argmax(-1).astype(np.int32),
                shift=np.stack([shift, shift, neg_shift], 0),
                scale=np.stack([scale, scale, neg_scale], 0),
            )
        else:
            out.update(
                input=geos,
                part_scale=np.ones((K, 3), np.float32),
                part_shift=np.zeros((K, 3), np.float32),
            )
        present = np.zeros(K, np.float32)
        present[np.unique(seg)] = 1.0
        out.setdefault("present", present)
        out.setdefault("dp_present", present.copy())
        out["global_anchor_mean"] = (self.stats["part_means"] - shift) / scale
        return out


class SupSegPartglotDataset(_PartEvalMixin):
    """PartGlot's raw super-segment games: one pickle with ``geos`` (S,
    n_seg, npoint, 3), ``geos_masks`` (S, n_seg) and ``attn_maps`` (S,
    n_class, n_seg); only the valid segments are normalized, and each
    segment's part is its attention argmax. Statistics are taken after the
    80/20 split. As in the JAX package, an item leaves the cached array as it
    was (no normalization in place) and ``geo_mask`` is sliced with the
    split."""

    attn_from_seg = False

    def __init__(self, data_root, split, part="pn_aware", scale_mode="shape_unit",
                 n_class=4, augment=False, vertical_only=False, seed=0):
        with open(
            os.path.join(data_root, f"partglot_shapenet_seg_out_{part}_raw.pkl"), "rb"
        ) as f:
            data = pickle.load(f)
        self.segs_data = np.asarray(data["geos"], np.float32)
        self.geo_mask = np.asarray(data["geos_masks"], np.float32)
        self.attn_map = np.asarray(data["attn_maps"], np.float32)
        self.scale_mode = scale_mode
        self.n_class = n_class
        self.num_class = n_class
        self.eval_mode = "ae"
        self.save_only = False
        self.class_choice = "Chair"
        self.using_whole_chair_only = False
        self.augment = augment
        self.vertical_only = vertical_only
        self.noises: Dict[int, np.ndarray] = {}
        self._rng = np.random.RandomState(seed)
        num_train = int(len(self.segs_data) * 0.8)
        sl = slice(None)
        if split == "train":
            sl = slice(None, num_train)
        elif split == "test":
            assert not augment
            sl = slice(num_train, None)
        self.segs_data = self.segs_data[sl]
        self.attn_map = self.attn_map[sl]
        self.geo_mask = self.geo_mask[sl]
        # statistics after the split, unlike SupSegDataset
        self.stats = {
            "mean": self.segs_data.reshape(-1, 3).mean(0),
            "std": self.segs_data.reshape(-1).std(),
        }

    def __len__(self):
        return len(self.segs_data)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        geos = self.segs_data[idx].copy()  # the cache stays as it was
        npoint = geos.shape[1]
        geo_mask = self.geo_mask[idx]
        valid = geo_mask == 1
        part_geos, shift, scale = pc_norm(
            geos[valid].reshape(-1, 3), self.scale_mode, stats=self.stats
        )
        geos[valid] = part_geos.reshape(-1, npoint, 3)
        attn = self.attn_map[idx]
        seg = attn.argmax(0).astype(np.int32)  # (n_seg,) per-segment part id
        out = {
            "input": geos,
            "ref": geos,
            "geo_mask": geo_mask,
            "attn_map": attn,
            "seg_mask": seg,
            "shift": shift,
            "scale": scale,
            "id": np.int32(idx),
            "token": f"partglot_{idx}",
            "noise": self.noises.get(idx, np.zeros(1, np.float32)),
        }
        if self.augment:
            out["input"] = _augment_parts(
                self._rng, geos.reshape(-1, 3),
                np.repeat(seg, npoint), self.n_class,
                vertical_only=self.vertical_only,
            )[0].reshape(geos.shape)
        return out


@DATASETS.register_module()
def ShapeNetSupSeg(batch_size, data_root=None, path=None, split="train",
                   part="pn_aware", npoints=2048, n_class=4, shuffle=True,
                   drop_last=False, eval_mode="ae", save_only=False,
                   distributed=False, **kwargs):
    """Super-segment shapes from ``data_root``'s two pickles, or from one
    ``path`` npz with ``points`` and ``labels`` (the per-part dataset)."""
    if data_root is not None:
        ds = SupSegDataset(
            data_root, split, part=part, n_class=n_class, eval_mode=eval_mode,
            **{k: v for k, v in kwargs.items() if k in (
                "scale_mode", "augment", "contrastive_learning", "vertical_only",
                "shift_only", "augment_attn", "normalize_attn", "augment_prob",
                "global_shift_prob")},
        )
    else:
        z = np.load(path, allow_pickle=True)
        ds = _ArrayPartDataset(
            np.asarray(z["points"]), np.asarray(z["labels"]), npoints, n_class,
            eval_mode=eval_mode, save_only=save_only,
            **{k: v for k, v in kwargs.items() if k in (
                "scale_mode", "part_scale_mode", "clip", "class_choice")},
        )
    return DataLoader(ds, batch_size=batch_size, shuffle=shuffle, drop_last=drop_last,
                      num_workers=int(kwargs.get("num_workers", 0))), None


@DATASETS.register_module()
def ShapeNetSupSegPartglot(batch_size, data_root=None, path=None, split="train",
                           part="pn_aware", n_class=4, shuffle=True,
                           drop_last=False, distributed=False, **kwargs):
    """PartGlot's raw games from ``data_root``, or ``ShapeNetSupSeg``'s npz
    from ``path``."""
    if data_root is not None:
        ds = SupSegPartglotDataset(
            data_root, split, part=part, n_class=n_class,
            **{k: v for k, v in kwargs.items() if k in (
                "scale_mode", "augment", "vertical_only")},
        )
        return DataLoader(ds, batch_size=batch_size, shuffle=shuffle,
                          drop_last=drop_last), None
    return ShapeNetSupSeg(batch_size, path=path, split=split, part=part,
                          n_class=n_class, shuffle=shuffle, drop_last=drop_last,
                          **kwargs)


@DATASETS.register_module()
def Partnet(batch_size, root, npoints=2048, n_class=4, shuffle=True, split="train",
            drop_last=False, eval_mode="ae", save_only=False, distributed=False, **kwargs):
    """PartNet clouds, one npz a split (``partnet_{split}.npz``): points (S,
    N, 3), labels (S, N), as ``tools/process_data_torch.py`` writes them."""
    z = np.load(os.path.join(root, f"partnet_{split}.npz"), allow_pickle=True)
    ds = _ArrayPartDataset(
        np.asarray(z["points"]), np.asarray(z["labels"]), npoints, n_class,
        eval_mode=eval_mode, save_only=save_only,
        **{k: v for k, v in kwargs.items() if k in (
            "scale_mode", "part_scale_mode", "clip", "class_choice")},
    )
    return DataLoader(ds, batch_size=batch_size, shuffle=shuffle, drop_last=drop_last,
                      num_workers=int(kwargs.get("num_workers", 0))), None


class _PartglotTripletDataset:
    """Packed PartGlot language games (``tools/pack_partglot_torch.py``):
    each item is a target and a distractor of super-segment clouds with the
    utterance's token ids and part indicator."""

    def __init__(self, path: str):
        z = np.load(path, allow_pickle=True)
        self.gt = np.asarray(z["gt_geos"], np.float32)
        self.dis = np.asarray(z["distractor_geos"], np.float32)
        self.gt_mask = np.asarray(z["gt_mask"], np.float32)
        self.dis_mask = np.asarray(z["distractor_mask"], np.float32)
        self.texts = np.asarray(z["texts"], np.int32)
        self.part_indicator = np.asarray(z["part_indicator"], np.float32)

    def __len__(self):
        return len(self.gt)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return {
            "gt_geos": self.gt[index],
            "distractor_geos": self.dis[index],
            "gt_mask": self.gt_mask[index],
            "distractor_mask": self.dis_mask[index],
            "text": self.texts[index],
            "part_indicator": self.part_indicator[index],
            "id": np.int32(index),
            "token": f"partglot_{index}",
        }

    def evaluate(self, results, save_num_batch, device="cuda"):
        return {}, {}


@DATASETS.register_module()
def PartglotTriplet(batch_size, path, shuffle=True, drop_last=False,
                    distributed=False, **_):
    ds = _PartglotTripletDataset(path)
    return DataLoader(ds, batch_size=batch_size, shuffle=shuffle, drop_last=drop_last), None


@DATASETS.register_module()
def ShapeNetPart(batch_size, root, npoints, num_workers=0, scale_mode=None,
                 eval_mode="ae", distributed=False, shuffle=True,
                 drop_last=True, n_class=4, **kwargs):
    """``ShapeNetParts`` from ``root``, returning (loader, None) as every
    factory does; ``scale_mode`` is None by default (no normalization)."""
    return ShapeNetParts(
        batch_size, root, npoints=npoints, n_class=n_class, shuffle=shuffle,
        drop_last=drop_last, eval_mode=eval_mode, num_workers=num_workers,
        scale_mode=scale_mode, **kwargs,
    )


class _ShapeNet55(object):
    """ShapeNet-55's whole clouds for completion: ``root/{split}.txt`` lists
    ``taxonomy-model.npy`` files in ``root/../shapenet_pc``; each is an (N,
    3) cloud, cut to ``npoints`` by a fixed ``RandomState(2020)`` permutation
    (or resampled to it where shorter) and normalized."""

    def __init__(self, root, npoints, split, scale_mode="shape_unit", seed=0,
                 cats=("all",)):
        if "all" in cats:
            cats = tuple(shapenet55_id_to_cat.values())
        for cat in cats:
            assert cat in shapenet55_id_to_cat.values(), f"Unknown category {cat!r}"
        list_file = os.path.join(root, f"{split}.txt")
        with open(list_file) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        parent = os.path.dirname(os.path.abspath(root))
        # The category filter by taxonomy id: each line is
        # "<taxonomy_id>-<model_id>.npy"; an unknown id raises (KeyError).
        lines = [
            ln for ln in lines
            if shapenet55_id_to_cat[ln.split("-")[0]] in cats
        ]
        self.files = [os.path.join(parent, "shapenet_pc", ln) for ln in lines]
        self.npoints = npoints
        self.scale_mode = scale_mode
        self._rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.files)

    def set_epoch(self, epoch):
        self._rng = np.random.RandomState(epoch)

    def __getitem__(self, index):
        pts = np.load(self.files[index]).astype(np.float32)
        if pts.shape[0] > self.npoints:
            # the same permutation for every item and epoch
            pts = pts[np.random.RandomState(2020).permutation(pts.shape[0])[: self.npoints]]
        elif pts.shape[0] < self.npoints:
            # resampled, so that batches keep one shape
            pts = pts[self._rng.choice(pts.shape[0], self.npoints, replace=True)]
        pts, shift, scale = pc_norm(pts, self.scale_mode)
        return {
            "input": pts.astype(np.float32),
            "ref": pts.astype(np.float32),
            "seg_mask": np.zeros((self.npoints,), np.int32),
            "ref_seg_mask": np.zeros((self.npoints,), np.int32),
            "present": np.ones((1,), np.float32),
            "shift": shift.astype(np.float32),
            "scale": np.asarray(scale, np.float32),
            "id": np.int64(index),
        }

    def evaluate(self, results, save_num_batch, device="cuda"):
        from ..metrics.eval import evaluate_batches

        return evaluate_batches(results, save_num_batch, eval_mode="ae", device=device)


@DATASETS.register_module()
def ShapeNet(batch_size, root, npoints, split, crop=(0.25, 0.75),
             num_workers=0, scale_mode="shape_unit", mode="median", loss=None,
             distributed=False, shuffle=True, cats=("all",), drop_last=None,
             device="cuda", **kwargs):
    """ShapeNet-55 for completion: whole clouds, and ``partial`` and
    ``missing`` cut from them on ``device`` by ``CroppingDataLoader``. The
    test split crops ``mode``'s share of the points; the others draw a count
    from ``crop``'s range."""
    frac = {"easy": 0.25, "median": 0.5, "hard": 0.75, "complete": 1.0}[mode]
    if split == "test":
        crop_range = int(frac * npoints)
    elif isinstance(crop, (list, tuple)):
        crop_range = [int(crop[0] * npoints), int(crop[1] * npoints)]
    else:
        crop_range = int(float(crop) * npoints)
    ds = _ShapeNet55(root, npoints, split, scale_mode=scale_mode, cats=tuple(cats))
    if drop_last is None:
        drop_last = split != "test"  # never drop eval shapes
    base = DataLoader(ds, batch_size=batch_size, shuffle=shuffle,
                      drop_last=drop_last, num_workers=num_workers)
    return CroppingDataLoader(base, crop_range, device=device), None


# The reference's names of the two super-segment factories.
DATASETS.register_module(name="ShapeNetSegSuperSegment", module=ShapeNetSupSeg)
DATASETS.register_module(
    name="ShapeNetSegSuperSegmentParglot", module=ShapeNetSupSegPartglot
)
