"""Everything a run feeds the program, made from ``--seed``.

One general generator, read by every traffic mix: the weights, the part
presence patterns, the chain's draws and the reference clouds. The same
seed and keys give the same inputs on the same device type; the program
gets only what comes out of here, and the plain reference gets the same.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

# The part-presence patterns of ShapeNet's chairs (seat, back, legs, arms)
# and their shares, as the val_gen protocol draws them.
CHAIR_PART_PATTERNS = {
    "1110": 0.7209302325581395,
    "1111": 0.2630199803471995,
    "1101": 0.009498853586636095,
    "1001": 0.00032754667540124465,
    "1100": 0.002947920078611202,
    "0111": 0.0013101867016049786,
    "0110": 0.0016377333770062235,
    "1011": 0.00032754667540124465,
}

# Procedural four-part chairs: seat, back, legs, arms (centre, half extents).
PART_CENTERS = np.array([[0.0, 0.0, 0.0], [0.0, 0.6, -0.4], [0.0, -0.7, 0.0],
                         [0.0, 0.15, 0.45]], np.float32)
PART_SCALES = np.array([[0.45, 0.08, 0.45], [0.45, 0.45, 0.06], [0.35, 0.35, 0.35],
                        [0.4, 0.06, 0.06]], np.float32)


def sub_seed(seed: int, *keys) -> int:
    """A 63-bit seed for one stream of the run's seed: any whole number in,
    one independent stream per key."""
    h = hashlib.sha256(repr((int(seed),) + keys).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def torch_generator(seed: int, device, *keys) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *keys))


def numpy_rng(seed: int, *keys) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, *keys))


def weights(layout, seed: int, device) -> dict:
    """Random float32 weights for ``layout`` [(name, shape)], drawn on
    ``device`` in one call and cut per name (names sorted): kernels
    N(0, 1 / fan_in), class embeddings N(0, 1), scales 1 + N(0, 0.05^2),
    biases N(0, 0.02^2); BatchNorm statistics 0 and 1. The flow prior's
    coupling heads (``dense2`` of each coupling layer), which the published
    model starts at zero so that the inverse stays finite, take a tenth of
    the kernels' scale: at the full scale 14 inverted layers overflow."""
    layout = sorted((name, tuple(shape)) for name, shape in layout)
    total = sum(int(np.prod(shape)) for _, shape in layout)
    flat = torch.randn(total, generator=torch_generator(seed, device, "weights"), device=device)
    out, at = {}, 0
    for name, shape in layout:
        n = int(np.prod(shape))
        r = flat[at:at + n].reshape(shape)
        at += n
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "mean":
            out[name] = torch.zeros(shape, device=device)
        elif leaf == "var":
            out[name] = torch.ones(shape, device=device)
        elif leaf == "class_emb":
            out[name] = r
        elif len(shape) >= 2:
            head = ".flow." in name and name.endswith("dense2.kernel")
            out[name] = r * (0.1 if head else 1.0) * shape[-2] ** -0.5
        elif leaf.endswith("scale"):
            out[name] = 1.0 + 0.05 * r
        else:
            out[name] = 0.02 * r
    return out


def presence(seed: int, key, num: int, n_class: int = 4) -> np.ndarray:
    """(num, n_class) float32 part-presence patterns drawn with the chairs'
    shares."""
    keys = list(CHAIR_PART_PATTERNS)
    p = np.array([CHAIR_PART_PATTERNS[k] for k in keys])
    idx = numpy_rng(seed, "presence", key).choice(len(keys), size=num, p=p / p.sum())
    out = np.array([[int(c) for c in keys[i]] for i in idx], np.float32)
    if n_class != 4:
        pad = np.ones((num, n_class), np.float32)
        pad[:, :min(4, n_class)] = out[:, :n_class]
        out = pad
    return out


def draws(seed: int, key, B: int, model: dict, device) -> dict:
    """The chain's draws for one batch: z (B, K, zdim), cimle_noise (B, 32),
    noise (B, N, 3) = x_T, step_noise (T, B, N, 3)."""
    K, N, T = model["num_anchors"], model["npoints"], model["num_timesteps"]
    zdim = model["encoder"]["encoder"]["zdim"]
    noise_dim = model["encoder"]["part_aligner"].get("noise_dim", 32)
    g = torch_generator(seed, device, "draws", key)
    return dict(z=torch.randn((B, K, zdim), generator=g, device=device),
                cimle_noise=torch.randn((B, noise_dim), generator=g, device=device),
                noise=torch.randn((B, N, 3), generator=g, device=device),
                step_noise=torch.randn((T, B, N, 3), generator=g, device=device))


def ref_clouds(seed: int, num: int, npoints: int, n_class: int = 4) -> np.ndarray:
    """(num, npoints, 3) float32 part-structured clouds: Gaussian blobs placed
    as seat, back, legs and (with probability 0.8) arms, each part's place
    and size jittered, each cloud centred and scaled to unit spread."""
    rng = numpy_rng(seed, "refs")
    out = np.empty((num, npoints, 3), np.float32)
    for i in range(num):
        parts = [0, 1, 2] + ([3] if n_class > 3 and rng.random() > 0.2 else [])
        counts = np.full(len(parts), npoints // len(parts))
        counts[0] += npoints - counts.sum()
        jitter = rng.standard_normal((4, 3)).astype(np.float32) * 0.05
        sizes = np.clip(1.0 + rng.standard_normal((4, 3)).astype(np.float32) * 0.15, 0.5, 1.5)
        pts = np.concatenate([
            rng.standard_normal((c, 3)).astype(np.float32) * PART_SCALES[p] * sizes[p]
            + PART_CENTERS[p] + jitter[p] for p, c in zip(parts, counts)])
        pts = pts[rng.permutation(npoints)]
        pts = pts - pts.mean(0)
        out[i] = pts / pts.std()
    return out
