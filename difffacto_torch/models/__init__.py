"""Models of the generation and training paths; importing registers them."""

from .aligner import PartAlignerTransformer
from .anchor_diff import (AnchorDiffAE, build_diffusion, decode, ensure_attn_maps,
                          reconstruct, sample_generation, select_best_noise)
from .denoiser import ConcatSquashDense, PointwiseNet, TransformerNet, UNet
from .diffusion import AnchoredDiffusion
from .diffusion_extra import LDM, LatentDiffusionDrift, PointDiffusion
from .flow import PerPartFlow
from .gan import Discriminator, DiscriminatorcGan, Generator, dis_loss, gen_loss, gradient_penalty
from .language import (LSTM, LatentLanguageFuser, MultiHeadCrossAttention, PartLanguageSelector,
                       ZeroMLP, clip_style_loss, tokenizing, triplet_loss)
from .orchestrators_extra import PDM
from .pointnet import PointNetV2
from .pointnet2 import PointNet2MSG, PointNet2SSG
from .samplers import Uniform
from .part_encoder import PartEncoderForTransformerDecoder, gather_per_point
