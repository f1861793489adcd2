from .dataset_utils import (
    CroppingDataLoader,
    DataLoader,
    bbox_normalize,
    collate,
    pc_norm,
    sample_part_presence,
    seg_classes,
    separate_point_cloud,
    shapenet_chair_part_distribution,
    shapenet55_id_to_cat,
    shapenet_part_normal_cat_to_id,
)
from .custom import CustomDataset, Partnet, ShapeNetParts
from .shapenet_seg import ShapeNetSeg, ShapeNetSegDataset, ShapeNetSegPart, ShapeNetSegPartDataset
from .synthetic import (SyntheticLanguageDataset, SyntheticLanguagePart, SyntheticPart,
                        SyntheticPartDataset)
