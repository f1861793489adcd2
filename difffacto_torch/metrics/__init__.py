from .eval import (
    compute_all_metrics,
    compute_bbox_metric,
    compute_part_metric,
    compute_snapping_metric,
    emd_cd_paired,
    evaluate_batches,
    jsd_between_point_cloud_sets,
    knn,
    lgan_mmd_cov,
    pairwise_cd_emd,
    pairwise_self_cd_emd,
    set_default_eval_mesh,
)
from .iou import aabb_iou
from . import common  # noqa: F401  (registers the METRICS entries)
