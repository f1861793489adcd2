"""Synthetic part-segmented shapes: the stand-in for ShapeNet-Part.

The port's own copy of ``difffacto_tpu/data/synthetic.py`` (numpy only):
procedural 4-part "chairs" (Gaussian blobs placed like seat, back, legs and
arms) with the item contract of ``ShapeNetSegPartDataset``, so that the whole
train and eval stack runs without the ShapeNet download. Items are built
from the same seeds as the JAX package's and equal them bit for bit.
``SyntheticLanguageDataset`` waits for the language family.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..utils.registry import DATASETS
from .dataset_utils import DataLoader, pc_norm

_PART_CENTERS = np.array(
    [
        [0.0, 0.0, 0.0],  # seat
        [0.0, 0.6, -0.4],  # back
        [0.0, -0.7, 0.0],  # legs
        [0.0, 0.15, 0.45],  # arms
    ],
    np.float32,
)
_PART_SCALES = np.array(
    [
        [0.45, 0.08, 0.45],
        [0.45, 0.45, 0.06],
        [0.35, 0.35, 0.35],
        [0.4, 0.06, 0.06],
    ],
    np.float32,
)


class SyntheticPartDataset:
    # attn_map/ref_attn_map are exactly eye(K)[seg_mask]: the runner sends
    # the seg masks alone and rebuilds the maps on the device (device_batch).
    attn_from_seg = True

    def __init__(
        self,
        npoints: int = 2048,
        size: int = 64,
        n_class: int = 4,
        eval_mode: str = "gen",
        save_only: bool = False,
        part_drop_prob: float = 0.2,
        scale_mode: str = "shape_unit",
        part_scale_mode: str = "shape_canonical",
        clip: bool = True,
        seed: int = 0,
        class_choice: str = "Chair",
        using_whole_chair_only: bool = False,
    ):
        self.npoints = npoints
        self.size = size
        self.n_class = n_class
        self.num_class = n_class
        self.eval_mode = eval_mode
        self.save_only = save_only
        self.scale_mode = scale_mode
        self.part_scale_mode = part_scale_mode
        self.clip = clip
        self.class_choice = class_choice
        self.using_whole_chair_only = using_whole_chair_only
        self.noises: Dict[int, np.ndarray] = {}
        rng = np.random.RandomState(seed)
        # per-shape jitter of part layout + which parts exist (part 4 optional)
        self._jitter = rng.randn(size, n_class, 3).astype(np.float32) * 0.05
        self._sizes = (
            1.0 + rng.randn(size, n_class, 3).astype(np.float32) * 0.15
        ).clip(0.5, 1.5)
        self._has_arm = rng.rand(size) > part_drop_prob
        self._seeds = rng.randint(0, 2**31 - 1, size)
        # Items are deterministic per index (fixed per-shape seeds), so they
        # are cached; only the CIMLE ``noise`` field changes between epochs
        # and is added at return time.
        self._cache: Dict[int, Dict[str, np.ndarray]] = {}

    def __len__(self):
        return self.size

    def store_noise(self, all_noises, all_ids):
        self.noises = {}
        for noises, ids in zip(all_noises, all_ids):
            for i, idx in enumerate(np.asarray(ids)):
                self.noises[int(idx)] = np.asarray(noises[i])

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        cached = self._cache.get(index)
        if cached is not None:
            out = dict(cached)
            noise = self.noises.get(index, np.zeros(1, np.float32))
            out["noise"] = noise.astype(np.float32)
            return out
        K = self.n_class
        rng = np.random.RandomState(self._seeds[index])
        parts = list(range(min(3, K)))
        if K > 3 and self._has_arm[index]:
            parts.append(3)
        counts = np.zeros(K, np.int64)
        share = self.npoints // len(parts)
        for p in parts:
            counts[p] = share
        counts[parts[0]] += self.npoints - counts.sum()

        pts, seg = [], []
        for p in parts:
            c = _PART_CENTERS[p % 4] + self._jitter[index, p]
            s = _PART_SCALES[p % 4] * self._sizes[index, p]
            pts.append(rng.randn(counts[p], 3).astype(np.float32) * s + c)
            seg.append(np.full(counts[p], p, np.int64))
        ori = np.concatenate(pts)
        seg = np.concatenate(seg)
        perm = rng.permutation(self.npoints)
        ori, seg = ori[perm], seg[perm]

        ori, shift, scale = pc_norm(ori, self.scale_mode)
        out = np.zeros_like(ori)
        present = np.zeros(K, np.float32)
        shifts = np.zeros((K, 3), np.float32)
        scales = np.ones((K, 3), np.float32)
        for i in range(K):
            idx = seg == i
            if idx.sum() >= 10:
                present[i] = 1
                norm_part, pshift, pscale = pc_norm(
                    ori[idx], self.part_scale_mode, clip=self.clip
                )
                shifts[i] = pshift[0]
                scales[i] = pscale[0] if pscale.shape[-1] == 3 else pscale[0].repeat(3)
                out[idx] = norm_part

        onehot = np.eye(K, dtype=np.float32)[seg]
        noise = self.noises.get(index, np.zeros(1, np.float32))
        item = {
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
            "token": f"synthetic_{index}",
            "noise": noise.astype(np.float32),
        }
        self._cache[index] = {k: v for k, v in item.items() if k != "noise"}
        return item

    def evaluate(self, results, save_num_batch, device="cuda"):
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


@DATASETS.register_module()
def SyntheticPart(
    batch_size,
    npoints=2048,
    size=64,
    split="train",
    shuffle=True,
    drop_last=False,
    eval_mode="gen",
    save_only=False,
    distributed=False,
    **kwargs,
):
    ds = SyntheticPartDataset(
        npoints=npoints,
        size=size,
        eval_mode=eval_mode,
        save_only=save_only,
        seed=0 if split in ("train", "trainval") else 1,
        **{k: v for k, v in kwargs.items() if k in (
            "n_class", "part_drop_prob", "scale_mode", "part_scale_mode", "clip",
            "class_choice", "using_whole_chair_only")},
    )
    return DataLoader(ds, batch_size=batch_size, shuffle=shuffle, drop_last=drop_last), None
