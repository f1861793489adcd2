"""Point-cloud primitive ops: gathers, pairwise distances, furthest point sampling.

The counterpart of ``difffacto_tpu/ops/points.py`` for the eval protocol:
``gather_points``, ``gather_points_nd``, ``square_distance``,
``furthest_point_sample``, ``fps`` and ``assign_anchor``. ``ball_query``,
``group_points``, ``three_nn`` and ``three_interpolate`` come with PointNet++.

All ops take batch-first tensors and run on the device their inputs lie on.
"""

from __future__ import annotations

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


def assign_anchor(data: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Nearest-anchor assignment: (B, N, 3), (B, M, 3) -> (B, N) int32."""
    return square_distance(data, anchors).argmin(dim=-1).to(torch.int32)
