"""3D bounding-box IoU.

The counterpart of ``difffacto_tpu/metrics/iou.py``: the protocol only ever
asks for heading 0 (axis-aligned boxes from per-part quantiles), so the IoU is
computed in closed form, in numpy.
"""

from __future__ import annotations

import numpy as np


def aabb_iou(min_a: np.ndarray, max_a: np.ndarray, min_b: np.ndarray, max_b: np.ndarray):
    """IoU of two axis-aligned 3D boxes given (3,) min/max corners.

    Returns (iou_3d, iou_2d); the 2D footprint is the ground plane spanned by
    axes 0 and 2.
    """
    inter_min = np.maximum(min_a, min_b)
    inter_max = np.minimum(max_a, max_b)
    inter_dims = np.clip(inter_max - inter_min, 0.0, None)
    inter_vol = float(np.prod(inter_dims))
    vol_a = float(np.prod(np.clip(max_a - min_a, 0.0, None)))
    vol_b = float(np.prod(np.clip(max_b - min_b, 0.0, None)))
    union = vol_a + vol_b - inter_vol
    iou3d = inter_vol / union if union > 0 else 0.0

    inter_2d = inter_dims[0] * inter_dims[2]
    area_a = (max_a[0] - min_a[0]) * (max_a[2] - min_a[2])
    area_b = (max_b[0] - min_b[0]) * (max_b[2] - min_b[2])
    union_2d = area_a + area_b - inter_2d
    iou2d = float(inter_2d / union_2d) if union_2d > 0 else 0.0
    return iou3d, iou2d
