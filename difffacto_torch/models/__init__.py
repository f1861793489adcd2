"""Models of the generation and training paths; importing registers them."""

from .aligner import PartAligner, PartAlignerTransformer
from .anchor_diff import (AnchorDiffAE, build_diffusion, decode, ensure_attn_maps,
                          reconstruct, sample_generation, select_best_noise)
from .completion import PCN, CoarsePCN, DiffuCompletion, PCNEncoder
from .decomposers import (ComponentMixer, ComponentMixerV2, PartCodeTransformer,
                          PartCodeTransformerV2)
from .denoiser import (ConcatSquashDense, LDMNet, PointwiseNet, PointwiseNet2, PointwiseNetLatent,
                       TransformerNet, UNet)
from .diffusion import AnchoredDiffusion
from .diffusion_extra import LDM, LatentDiffusionDrift, PointDiffusion
from .editors import (Aligner, AnchorDiffGenSuperSegments, LatentDiffEdit, ParameterTrainer,
                      PartglotClassifier, PartglotFinetune, PartLatentEditor)
from .flow import PerPartFlow
from .gan import Discriminator, DiscriminatorcGan, Generator, dis_loss, gen_loss, gradient_penalty
from .language import (LSTM, LatentLanguageFuser, MultiHeadCrossAttention, PartLanguageSelector,
                       ZeroMLP, clip_style_loss, tokenizing, triplet_loss)
from .orchestrators_extra import PDM, AnchorDiffGenPartglot, AnchoredGeneration
from .pointflow import CNF, ConcatSquashODE, PointFlow
from .pointnet import (PointNet, PointNetV2, PointNetV2VAE, PointNetV2Variant, PointNetV3,
                       PointNetVAE, PointNetVAEBase)
from .pointnet2 import PointNet2MSG, PointNet2SSG
from .samplers import Uniform
from .part_encoder import PartEncoder, PartEncoderForTransformerDecoder, gather_per_point
from .part_encoder_variants import (EncoderWithKLLoss, PartAlignerCIMLE, PartEncoderCIMLE,
                                    PartEncoderForPartnet,
                                    PartEncoderForPartnetAndTransformerDecoder,
                                    PartEncoderForTransformerDecoderCIMLE,
                                    PartEncoderForTransformerDecoderKLLoss,
                                    PartEncoderForTransformerDecoderKLLossCIMLE,
                                    PartEncoderNoMixer, PartEncoderVAE, PartEncoderWithKLLoss,
                                    PartEncodercVAE, PartEncodercVAE2)
from .segmentor import ConditionalBatchNorm1d, PointNetDenseCls
from .supseg_encoders import (MeanVarianceRegressor, PartglotSupSegsEncoderWithCBN,
                              PCNPartEncoder, Pnet2Stage, SupSegsEncoder)
