"""DiffFacto in PyTorch and CUDA for one NVIDIA H100.

The port of the JAX package ``difffacto_tpu`` (which stays as the
reference), slice by slice. Slice 1 is unconditional ``gen_chair``
generation: flow prior -> CIMLE part aligner -> 100-step anchored reverse
diffusion, with the denoiser trunk as a hand-written CUDA kernel
(``csrc/fused_core.cu``). Slice 2 is the eval protocol that scores it: FPS ->
bbox-normalize -> MMD/COV/1-NNA over Chamfer and EMD (``metrics/eval.py``,
``runner/evaluation.py``), with furthest point sampling (``csrc/fps.cu``) and
the Sinkhorn+auction EMD assignment (``csrc/emd_hybrid.cu``) as CUDA kernels.
Slice 3 is the training step (``parallel/``: ``build_optimizer_from_cfg``,
``init_train_state``, ``make_train_step``) with the denoiser's training trunk
as a forward and a backward CUDA kernel (``csrc/fused_core_train.cu``).
Slice 4 is generation with two-attention blocks (``single_attn=False``),
whose fused LayerNorm -> GEGLU feed-forward is a CUDA kernel
(``csrc/fused_ff.cu``), and the ``UNet`` denoiser's forward, whose flat
blocks run one block per launch (a second entry point of ``fused_core.cu``).
Slice 9 is the training loop users run: the datasets and loaders
(``data/``: ``SyntheticPart``, ``ShapeNetSegPart``, ``DataLoader``, and
``CroppingDataLoader``, which crops on the device and resamples by FPS),
checkpoints and loggers (``utils/``), the ``Runner`` (train with the CIMLE
re-cache, val, val_gen, auto-resume) and its command line
(``runner/cli.py``, ``tools/run_net_torch.py``).
The package imports torch, numpy, scipy and yaml, never JAX or the JAX
package. Entry points run on the card (``device="cuda"``) unless the caller
asks for the CPU.
"""

from .config import Config
from .models import AnchorDiffAE, decode, sample_generation, select_best_noise
from .parallel import build_optimizer_from_cfg, init_train_state, make_train_step
from .runner import Runner
from .utils.jax_params import load_jax_params
from .utils.registry import MODELS, build_from_cfg

__version__ = "0.1.0"
