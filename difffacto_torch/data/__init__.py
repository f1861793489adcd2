from .dataset_utils import (
    bbox_normalize,
    sample_part_presence,
    shapenet_chair_part_distribution,
)
