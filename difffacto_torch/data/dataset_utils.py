"""Dataset helpers: normalisation modes, category tables, collation, loaders,
and the cropping pair of the completion data.

The port's own copy of ``difffacto_tpu/data/dataset_utils.py``. Everything
but the cropping pair is numpy on the host, so items and batches equal the
JAX package's bit for bit. ``separate_point_cloud`` and
``CroppingDataLoader`` run on the loader's device with torch ops, and
resample both halves with ``ops/points.fps`` (the CUDA FPS kernel on the
card). Every draw comes from an explicit ``np.random.RandomState`` or
``torch.Generator``.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device

shapenet_part_normal_cat_to_id = {
    "Airplane": "02691156",
    "Bag": "02773838",
    "Cap": "02954340",
    "Car": "02958343",
    "Chair": "03001627",
    "Earphone": "03261776",
    "Guitar": "03467517",
    "Knife": "03624134",
    "Lamp": "03636649",
    "Laptop": "03642806",
    "Motorbike": "03790512",
    "Mug": "03797390",
    "Pistol": "03948459",
    "Rocket": "04099429",
    "Skateboard": "04225987",
    "Table": "04379243",
}

# ShapeNet-55 taxonomy id -> category name: the completion loader's category
# filter (data/custom.py:_ShapeNet55).
shapenet55_id_to_cat = {
    "02691156": "airplane", "02747177": "trash bin",
    "02773838": "bag", "02801938": "basket",
    "02808440": "bathtub", "02818832": "bed",
    "02828884": "bench", "02843684": "birdhouse",
    "02871439": "bookshelf", "02876657": "bottle",
    "02880940": "bowl", "02924116": "bus",
    "02933112": "cabinet", "02942699": "camera",
    "02946921": "can", "02954340": "cap",
    "02958343": "car", "02992529": "cellphone",
    "03001627": "chair", "03046257": "clock",
    "03085013": "keyboard", "03207941": "dishwasher",
    "03211117": "display", "03261776": "earphone",
    "03325088": "faucet", "03337140": "file cabinet",
    "03467517": "guitar", "03513137": "helmet",
    "03593526": "jar", "03624134": "knife",
    "03636649": "lamp", "03642806": "laptop",
    "03691459": "loudspeaker", "03710193": "mailbox",
    "03759954": "microphone", "03761084": "microwaves",
    "03790512": "motorbike", "03797390": "mug",
    "03928116": "piano", "03938244": "pillow",
    "03948459": "pistol", "03991062": "flowerpot",
    "04004475": "printer", "04074963": "remote",
    "04090263": "rifle", "04099429": "rocket",
    "04225987": "skateboard", "04256520": "sofa",
    "04330267": "stove", "04379243": "table",
    "04401088": "telephone", "04460130": "tower",
    "04468005": "train", "04530566": "watercraft",
    "04554684": "washer",
}

# ShapeNet-Part per-category segmentation label ranges.
seg_classes = {
    "Earphone": [16, 17, 18],
    "Motorbike": [30, 31, 32, 33, 34, 35],
    "Rocket": [41, 42, 43],
    "Car": [8, 9, 10, 11],
    "Laptop": [28, 29],
    "Cap": [6, 7],
    "Skateboard": [44, 45, 46],
    "Mug": [36, 37],
    "Guitar": [19, 20, 21],
    "Bag": [4, 5],
    "Lamp": [24, 25, 26, 27],
    "Table": [47, 48, 49],
    "Airplane": [0, 1, 2, 3],
    "Pistol": [38, 39, 40],
    "Chair": [12, 13, 14, 15],
    "Knife": [22, 23],
}

# Empirical chair part-presence distribution; keys are presence bitstrings
# over the 4 part slots.
shapenet_chair_part_distribution = {
    "1110": 0.7209302325581395,
    "1111": 0.2630199803471995,
    "1101": 0.009498853586636095,
    "1001": 0.00032754667540124465,
    "1100": 0.002947920078611202,
    "0111": 0.0013101867016049786,
    "0110": 0.0016377333770062235,
    "1011": 0.00032754667540124465,
}


def sample_part_presence(rng: np.random.RandomState, num: int, n_class: int = 4) -> np.ndarray:
    """Draw part-presence patterns from the empirical chair distribution.
    Returns (num, n_class) float32 of 0/1."""
    keys = list(shapenet_chair_part_distribution.keys())
    probs = np.array([shapenet_chair_part_distribution[k] for k in keys])
    probs = probs / probs.sum()
    idx = rng.choice(len(keys), size=num, p=probs)
    out = np.array([[int(c) for c in keys[i]] for i in idx], dtype=np.float32)
    if n_class != 4:
        pad = np.ones((num, n_class), np.float32)
        pad[:, :4] = out[:, :n_class]
        return pad
    return out


def pc_norm(
    pc: np.ndarray, scale_mode: str, stats: Optional[dict] = None, clip: bool = True
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Normalise one cloud (N, 3); returns (pc, shift (1, 3), scale (1, 3) or
    (1, 1)), all float32. An unknown mode leaves the cloud as it is."""
    if scale_mode == "global_unit":
        shift = stats["mean"].reshape(1, 3)
        scale = stats["std"].reshape(1, 1)
    elif scale_mode == "shape_unit":
        shift = pc.mean(0).reshape(1, 3)
        scale = pc.flatten().std().reshape(1, 1)
    elif scale_mode == "shape_canonical":
        shift = pc.mean(0).reshape(1, 3)
        scale = pc.std(0).reshape(1, 3)
        if clip:
            scale = scale.clip(1e-2, 1)
        if np.any(scale == 0.0):
            scale[0, scale[0] == 0.0] = 1.0
    elif scale_mode == "shape_canonical_bbox":
        pc_max = pc.max(0).reshape(1, 3)
        pc_min = pc.min(0).reshape(1, 3)
        shift = ((pc_min + pc_max) / 2).reshape(1, 3)
        scale = (pc_max - pc_min).reshape(1, 3) / 2
        if clip:
            scale = scale.clip(1e-2, 1)
        if np.any(scale == 0.0):
            scale[0, scale[0] == 0.0] = 1.0
    elif scale_mode == "shape_half":
        shift = pc.mean(0).reshape(1, 3)
        scale = pc.flatten().std().reshape(1, 1) / 0.5
    elif scale_mode == "shape_34":
        shift = pc.mean(0).reshape(1, 3)
        scale = pc.flatten().std().reshape(1, 1) / 0.75
    elif scale_mode == "shape_bbox":
        pc_max = pc.max(0).reshape(1, 3)
        pc_min = pc.min(0).reshape(1, 3)
        shift = ((pc_min + pc_max) / 2).reshape(1, 3)
        scale = (pc_max - pc_min).max().reshape(1, 1) / 2
    else:
        shift = np.zeros([1, 3])
        scale = np.ones([1, 1])
    pc = (pc - shift) / scale
    return pc.astype(np.float32), shift.astype(np.float32), scale.astype(np.float32)


def bbox_normalize(pc: np.ndarray) -> np.ndarray:
    """Center each cloud on its bounding box and scale by half the box's
    longest side. pc: (B, N, 3)."""
    pc_max = pc.max(axis=1, keepdims=True)
    pc_min = pc.min(axis=1, keepdims=True)
    shift = (pc_min + pc_max) / 2
    scale = (pc_max - pc_min).max(axis=-1, keepdims=True) / 2
    return (pc - shift) / scale


def collate(items: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack arrays and scalars over the items; strings and other values
    become lists."""
    out = {}
    for k in items[0]:
        v0 = items[0][k]
        if isinstance(v0, str):
            out[k] = [it[k] for it in items]
        elif isinstance(v0, np.ndarray) or np.isscalar(v0):
            out[k] = np.stack([np.asarray(it[k]) for it in items])
        else:
            out[k] = [it[k] for it in items]
    return out


def separate_point_cloud(
    xyz: torch.Tensor,
    num_points: int,
    crop,
    fixed_points=None,
    padding_zeros: bool = False,
    rng: Optional[np.random.RandomState] = None,
    generator: Optional[torch.Generator] = None,
):
    """Crop a neighbourhood out of each cloud -> (incomplete, cropped), on the
    device of ``xyz`` (B, num_points, 3).

    Points are ranked by distance to a random unit direction (from
    ``generator``) or to ``fixed_points`` (one of a list, chosen by ``rng``);
    the nearest ``crop`` become the missing region and the rest the partial
    input (with ``padding_zeros``, zeroed in place). A ``[lo, hi)`` crop draws
    one count for the whole batch from ``rng``, and both halves are then
    resampled to 2048 points by furthest point sampling, as in the JAX
    package. The ranking is a stable sort, as ``jnp.argsort`` is.
    """
    from ..ops.points import fps

    B, n, c = xyz.shape
    if n != num_points or c != 3:
        raise ValueError(f"separate_point_cloud: xyz is {tuple(xyz.shape)}, expected "
                         f"(B, {num_points}, 3)")
    if crop == num_points:
        return xyz, None
    resample = isinstance(crop, (list, tuple))
    needs_rng = resample or isinstance(fixed_points, (list, tuple))
    if needs_rng and rng is None:
        raise ValueError("separate_point_cloud: a crop range or a list of fixed points needs rng")
    if resample:
        lo, hi = crop
        num_crop = int(rng.randint(lo, hi))
    else:
        num_crop = int(crop)

    if fixed_points is None:
        if generator is None:
            raise ValueError("separate_point_cloud: a random direction needs a torch.Generator")
        center = torch.randn((B, 1, 3), generator=generator, device=xyz.device)
        center = center / torch.sqrt((center * center).sum(-1, keepdim=True))
    else:
        if isinstance(fixed_points, (list, tuple)):
            fixed_points = fixed_points[int(rng.randint(len(fixed_points)))]
        center = torch.as_tensor(np.asarray(fixed_points, np.float32), device=xyz.device)
        center = center.reshape(1, 1, 3).expand(B, 1, 3)

    diff = xyz - center.to(xyz.dtype)
    dist = torch.sqrt((diff * diff).sum(-1))  # (B, n)
    order = torch.argsort(dist, dim=-1, stable=True)  # nearest first
    if padding_zeros:
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(n, device=xyz.device).expand(B, n))
        input_data = torch.where((rank < num_crop)[..., None], torch.zeros_like(xyz), xyz)
    else:
        keep = order[:, num_crop:]
        input_data = torch.gather(xyz, 1, keep[..., None].expand(-1, -1, 3))
    crop_data = torch.gather(xyz, 1, order[:, :num_crop, None].expand(-1, -1, 3))

    if resample:
        input_data = fps(input_data, 2048)
        crop_data = fps(crop_data, 2048)
    return input_data, crop_data


class CroppingDataLoader:
    """Partial-cloud batches for completion training: each batch of
    ``loader`` gains ``partial`` and ``missing`` (torch tensors on
    ``device``) cut from its ``input`` by :func:`separate_point_cloud`. The
    epoch's draws come from ``np.random.RandomState(seed + epoch)`` (crop
    counts) and a ``torch.Generator`` on ``device`` seeded with
    ``seed + epoch`` (directions)."""

    def __init__(self, loader, crop, fixed_points=None, padding_zeros=False, seed: int = 0,
                 device="cuda"):
        self.loader = loader
        self.crop = crop
        self.fixed_points = fixed_points
        self.padding_zeros = padding_zeros
        self.device = resolve_device(device)
        self._seed = seed
        self._epoch = 0

    @property
    def dataset(self):
        return self.loader.dataset

    def __len__(self):
        return len(self.loader)

    def set_epoch(self, epoch: int):
        self.loader.set_epoch(epoch)
        self._epoch = epoch

    def evaluate(self, results, save_num_batch, device="cuda"):
        return self.loader.evaluate(results, save_num_batch, device)

    def __iter__(self):
        rng = np.random.RandomState(self._seed + self._epoch)
        gen = torch.Generator(device=self.device).manual_seed(self._seed + self._epoch)
        for batch in self.loader:
            pts = torch.as_tensor(np.asarray(batch["input"]), device=self.device)
            partial, missing = separate_point_cloud(
                pts, pts.shape[1], self.crop, fixed_points=self.fixed_points,
                padding_zeros=self.padding_zeros, rng=rng, generator=gen,
            )
            batch = dict(batch)
            batch["partial"] = partial
            if missing is not None:
                batch["missing"] = missing
            yield batch


class DataLoader:
    """Epoch iterator over an indexable dataset with numpy collation, and the
    ``evaluate`` passthrough the runner calls on the loader.

    The order of an epoch is ``np.random.RandomState(seed + epoch)``'s
    shuffle. ``num_workers > 0`` assembles batches in one background thread
    into a queue of depth ``prefetch``: one producer keeps the dataset's
    order-dependent ``RandomState`` stream, so the batches are the same as
    with ``num_workers=0``.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, drop_last: bool = False,
                 seed: int = 0, num_workers: int = 0, prefetch: int = 2, **_):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._epoch = 0
        self._seed = seed
        self.num_workers = num_workers
        self.prefetch = max(1, int(prefetch))

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self._seed + self._epoch).shuffle(order)
        for s in range(0, n, self.batch_size):
            idx = order[s : s + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                return
            yield collate([self.dataset[int(i)] for i in idx])

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.num_workers <= 0:
            yield from self._batches()
            return

        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        end = object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for batch in self._batches():
                    if not put(batch):
                        return
                put(end)
            except Exception as e:  # handed to the consumer, which raises it
                put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is end:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            t.join(timeout=5.0)

    def evaluate(self, results, save_num_batch, device="cuda"):
        return self.dataset.evaluate(results, save_num_batch, device)
