"""Chamfer distance in plain PyTorch.

The counterpart of ``difffacto_tpu/ops/chamfer.py``. The JAX package leaves
Chamfer to XLA (a matmul-shaped reduction, no Pallas kernel), so the port
leaves it to torch ops: one f32 matmul for the cross term and two ``min``
reductions. ``chamfer_split_tiled`` streams the second cloud in column tiles
to bound memory for large clouds. Gradients flow through ``min`` by autograd.
"""

from __future__ import annotations

import torch

from .points import square_distance


def chamfer_split(x: torch.Tensor, y: torch.Tensor):
    """Bidirectional squared-L2 nearest-neighbour distances.

    x (B, N, 3), y (B, M, 3) -> (dl (B, N), dr (B, M)) with
    dl[i] = min_j |x_i - y_j|^2 and dr[j] = min_i.
    """
    d2 = square_distance(x, y)
    return d2.min(dim=2).values, d2.min(dim=1).values


def chamfer_l2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean bidirectional squared-L2 Chamfer per batch element -> (B,)."""
    dl, dr = chamfer_split(x, y)
    return dl.mean(dim=1) + dr.mean(dim=1)


def chamfer_l1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean bidirectional L2-norm (not squared) Chamfer -> (B,)."""
    dl, dr = chamfer_split(x, y)
    return dl.clamp_min(0.0).sqrt().mean(dim=1) + dr.clamp_min(0.0).sqrt().mean(dim=1)


def chamfer_split_tiled(x: torch.Tensor, y: torch.Tensor, tile: int = 2048):
    """``chamfer_split`` with y streamed in tiles of ``tile`` points.

    Peak memory is O(B * N * tile) instead of O(B * N * M); for the
    8192-point car clouds.
    """
    B, N, _ = x.shape
    M = y.shape[1]
    if M % tile != 0:
        raise ValueError("tile must divide M")
    dl = torch.full((B, N), float("inf"), dtype=torch.float32, device=x.device)
    dr = []
    for s in range(0, M, tile):
        d2 = square_distance(x, y[:, s:s + tile])  # (B, N, tile)
        dl = torch.minimum(dl, d2.min(dim=2).values)
        dr.append(d2.min(dim=1).values)
    return dl, torch.cat(dr, dim=1)


def pairwise_chamfer(sample: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """All-pairs Chamfer matrix between two sets of clouds.

    sample (S, N, 3), ref (R, N, 3) -> (S, R): entry (i, j) is
    mean_min(sample_i -> ref_j) + mean_min(ref_j -> sample_i).
    """
    rows = []
    for s in sample:
        dl, dr = chamfer_split(s[None].expand(ref.shape[0], -1, -1), ref)
        rows.append(dl.mean(dim=1) + dr.mean(dim=1))
    return torch.stack(rows)
