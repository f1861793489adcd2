"""Point-cloud primitive ops: gathers, pairwise distances, furthest point sampling.

The counterpart of ``difffacto_tpu/ops/points.py``: ``gather_points``,
``gather_points_nd``, ``square_distance``, ``furthest_point_sample``,
``fps`` and ``assign_anchor`` for the eval protocol;
``furthest_point_sample_each`` for the data tools' clouds of many lengths; ``ball_query``,
``group_points``, ``three_nn`` and ``three_interpolate`` for PointNet++.
The JAX package computes the last four in XLA, with no Pallas kernel, and
here they are plain PyTorch, keeping the semantics of the original CUDA
extension that the JAX code emulates.

All ops take batch-first tensors and run on the device their inputs lie on.
"""

from __future__ import annotations

import numpy as np
import torch

from .fps import furthest_point_sample


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather features by index: (B, C, N), (B, M) int -> (B, C, M)."""
    B, C, _ = points.shape
    return torch.gather(points, 2, idx.long()[:, None, :].expand(B, C, idx.shape[1]))


def gather_points_nd(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather along the point axis, channel-last: (B, N, C), (B, M) -> (B, M, C)."""
    B, _, C = points.shape
    return torch.gather(points, 1, idx.long()[..., None].expand(B, idx.shape[1], C))


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances: (B, N, 3) x (B, M, 3) -> (B, N, M) in f32.

    ``|x|^2 + |y|^2 - 2 x.y`` with the product as one matmul. The metrics
    depend on exact f32 distances, so the product runs with TF32 off: the
    flag is set here and restored.
    """
    src, dst = src.float(), dst.float()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        xy = torch.matmul(src, dst.transpose(1, 2))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    xx = (src * src).sum(-1)
    yy = (dst * dst).sum(-1)
    return xx[:, :, None] + yy[:, None, :] - 2.0 * xy


def fps(data: torch.Tensor, number: int, ret_id: bool = False):
    """Downsample (B, N, 3) -> (B, number, 3) by furthest point sampling.

    On the card the indices come from the CUDA kernel (``ops/fps.py``)."""
    idx = furthest_point_sample(data, number)
    out = gather_points_nd(data, idx)
    if ret_id:
        return out, idx
    return out


def furthest_point_sample_each(clouds, npoint: int, device) -> list:
    """FPS indices of each of ``clouds`` (numpy (n_i, 3) arrays, n_i varying)
    on ``device``: one launch for each group of clouds of equal length, as
    FPS works cloud by cloud. Returns a list of (npoint,) int64 numpy
    arrays, in the order of ``clouds``."""
    groups = {}
    for i, c in enumerate(clouds):
        groups.setdefault(len(c), []).append(i)
    out = [None] * len(clouds)
    for members in groups.values():
        xyz = torch.as_tensor(np.stack([np.asarray(clouds[i], np.float32) for i in members]),
                              device=device)
        idx = furthest_point_sample(xyz, npoint).cpu().numpy().astype(np.int64)
        for row, i in enumerate(members):
            out[i] = idx[row]
    return out


def ball_query(new_xyz: torch.Tensor, xyz: torch.Tensor, radius: float,
               nsample: int) -> torch.Tensor:
    """Fixed-radius neighbourhoods (``points.py:109-136``): centres (B, S, 3),
    points (B, N, 3) -> (B, S, nsample) int32 indices. The slots take the
    in-ball points (squared distance below radius^2) in index order; the
    slots left empty take the first in-ball index, or 0 where the ball is
    empty."""
    d2 = square_distance(new_xyz, xyz)
    N = xyz.shape[1]
    arange = torch.arange(N, device=xyz.device, dtype=torch.int64)
    cand = torch.where(d2 < radius * radius, arange, N)
    # the nsample smallest candidates, ascending: the in-ball indices in order
    picked = torch.topk(cand, min(nsample, N), dim=-1, largest=False, sorted=True).values
    first = picked[..., :1]
    first = torch.where(first >= N, 0, first)
    return torch.where(picked >= N, first, picked).to(torch.int32)


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-neighbourhood features: (B, C, N), (B, S, K) -> (B, C, S, K)."""
    B, C, _ = points.shape
    S, K = idx.shape[1], idx.shape[2]
    return gather_points(points, idx.reshape(B, S * K)).reshape(B, C, S, K)


def three_nn(unknown: torch.Tensor, known: torch.Tensor):
    """The 3 nearest known points of each unknown one: (B, N, 3), (B, M, 3) ->
    (distances (B, N, 3), indices (B, N, 3) int32), nearest first, ties to
    the lowest index as ``lax.top_k`` takes them (a stable sort: the order of
    ``torch.topk``'s ties is not specified)."""
    d2 = square_distance(unknown, known)
    vals, idx = torch.sort(d2, dim=-1, stable=True)
    return torch.sqrt(vals[..., :3].clamp_min(0.0)), idx[..., :3].to(torch.int32)


def three_interpolate(points: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Weighted 3-NN interpolation: (B, C, M), (B, N, 3), (B, N, 3) -> (B, C, N)."""
    return (group_points(points, idx) * weight[:, None]).sum(-1)


def assign_anchor(data: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Nearest-anchor assignment: (B, N, 3), (B, M, 3) -> (B, N) int32."""
    return square_distance(data, anchors).argmin(dim=-1).to(torch.int32)
