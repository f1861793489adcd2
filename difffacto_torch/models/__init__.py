"""Models of the generation and training paths; importing registers them."""

from .aligner import PartAlignerTransformer
from .anchor_diff import (AnchorDiffAE, build_diffusion, decode, ensure_attn_maps,
                          sample_generation, select_best_noise)
from .denoiser import TransformerNet, UNet
from .diffusion import AnchoredDiffusion
from .flow import PerPartFlow
from .pointnet import PointNetV2
from .samplers import Uniform
from .part_encoder import PartEncoderForTransformerDecoder, gather_per_point
