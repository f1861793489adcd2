"""Dataset helpers the eval protocol needs: bbox normalisation and the
part-presence table.

The port's own copy of ``bbox_normalize`` and ``sample_part_presence`` from
``difffacto_tpu/data/dataset_utils.py`` (numpy). The normalisation modes,
the loaders and the datasets come with the data slice.
"""

from __future__ import annotations

import numpy as np

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


def bbox_normalize(pc: np.ndarray) -> np.ndarray:
    """Center each cloud on its bounding box and scale by half the box's
    longest side. pc: (B, N, 3)."""
    pc_max = pc.max(axis=1, keepdims=True)
    pc_min = pc.min(axis=1, keepdims=True)
    shift = (pc_min + pc_max) / 2
    scale = (pc_max - pc_min).max(axis=-1, keepdims=True) / 2
    return (pc - shift) / scale
