#!/usr/bin/env python3
"""Run the PyTorch port on one CUDA card and check it: gen_chair generation,
the eval protocol that scores what was generated, the gen_chair training
step, gen_chair generation with two-attention blocks beside the UNet
denoiser, the training loop users run (the runner and its CLI),
reconstruction and part-level editing on weights read from a reference
``.pth``, the chain's variants (DDIM, a learned variance with guidance,
t added to x) with the checkpoint-curve scorer, the JAX package's
``.msgpack`` checkpoints, training through two-attention blocks and UNet,
per-part pretraining, multi-GPU, the GAN, language and mixing runners and
the point-diffusion model on PointNet++, AnchorDiffAE's other encoders
with the anchored generators, the latent editors, the super-segment
generator, completion and PointFlow, and the trunk with proj_out fused (the
denoiser's two switches), the datasets of ``data/custom.py`` and the data
tools.

    python3 chip_smoke.py

Phases, each fatal (non-zero exit, no "ok" line):

1. device: a CUDA card is required; prints its name and power limit.
2. build: builds every CUDA source of the four paths (one nvcc each, started
   together) and prints nvcc's and ptxas's versions, the build time and
   ``-Xptxas -v`` (registers, shared memory, spills of every kernel), and the
   counts of wgmma (HGMMA), TMA (UTMALDG), warp-level matrix (HMMA) and global
   reduction (REDG, 4-wide ones apart) instructions in each kernel of the
   trunk's, the training trunk's and the fused FF's binaries (``cuobjdump
   -sass``, function by function; the FF's D = 128 entry is the trunk
   template's Mode::FF, its D = 256 entry the cluster kernel): a kernel
   without HGMMA or UTMALDG fails, as does any HMMA in the training trunk's
   or either FF entry, a backward without 4-wide REDG, or a source under
   ``difffacto_torch/csrc`` that still names WMMA; and the EMD kernel's
   special-function (MUFU) instructions.
3. kernels: each kernel against its plain PyTorch version, with the stated
   tolerance, at the main paths' shapes and at ragged ones: the trunk in
   bf16 (also at the timed B = 256, N = 2048 with parts absent: 4096 tiles,
   31 or 32 for each block of the persistent grid) and its head-less entry
   (at that shape and a ragged N), the training trunk's forward and its backward (dx, dK, dV and the 15
   parameter gradients) at p = 0 and p = 0.2, FPS index for index (at
   shapes where ``ops/fps.py:plan`` picks each cluster size 1, 2, 4 and 8,
   clouds past one block's registers, and 400 clouds of 8192), the EMD assignment by its
   matched cost, the fused LN-GEGLU FF at the denoiser's (T = 256 x 2048,
   D = 128) shape and at T = 384, and at D = 256 at the aligner's T = 1024
   and at T = 100, 128 and 32,768, the one-block kernel at B = 256, N = 2048
   with parts absent and at N = 384.
4. generation: ``configs/gen_chair.py`` at full width (2048 points, T=100,
   denoiser depth 5 at width 128, 4 x 14 flows, aligner depth 5,
   ``cimle_sample_num=1``, bf16), seeded random weights, through
   ``sample_generation`` at batch 16. Launch counts are set to 0 just before
   and read just after: the trunk kernel must run once per step. A batch-1
   run with every draw injected is then held against the same model on the
   CPU, where the trunk is the plain version.
5. timing: generation at batch 256 (1 warm-up, 3 timed runs), the trunk
   kernel and its plain version with CUDA events at the main path's shape,
   the bound; the host-side schedule's tiles for each block and a model (not
   a measurement) of the weight bytes a launch streams from L2; then the
   device's busy and idle share over one generation at batch 16 and one at
   batch 256: busy from ``torch.profiler`` tracing the card alone, against
   the wall time of an unprofiled run of the same generation (no device time
   in the trace fails).
6. eval protocol, full width: 64 generated gen_chair shapes against 64
   seeded reference clouds of 8192 points (the gen_car val shape) through
   ``evaluate_gen``: FPS 8192 -> 2048, bbox-normalize, MMD/COV/1-NNA over CD
   and EMD at n = 2048 (8128 pairs). Launch counts are set to 0 just before
   and read just after; a 2 x 2 corner is recomputed on the CPU by the plain
   versions. Then FPS and the EMD kernel are timed on the protocol's own
   clouds beside their plain versions and bounds, FPS at 64, 32 and 400
   clouds (the 400 v 400 protocol's references), at the plan's cluster size
   and at 1, beside its latency floor (the kernel's steps with no
   distance sweep, ``ops/fps.py:latency_floor_probe``), the EMD kernel at 132 pairs
   (one per SM) and at 32, each also with ``auction_iters=0`` (the Sinkhorn
   and one force-assignment sweep): the split between Sinkhorn and auction.
7. training step, full width: the gen_chair model with ``gen=False``, bf16,
   denoiser dropout 0.2, Adam 2e-3 with LinearLR and ``max_norm=10``, batch
   128 x 2048 points, through ``build_optimizer_from_cfg``,
   ``init_train_state`` and ``make_train_step``. Launch counts are set to 0
   just before and read just after: one forward and one backward launch of the
   training trunk per step. The loss must fall over 20 steps on one batch; a
   step on a batch with a NaN must leave every parameter, moment and BatchNorm
   buffer as it was. Then 3 steps of the stage-2 set-up (``gen=True``, aligner
   noise_scale 50, only the aligner trainable, the CIMLE noise chosen by
   ``select_best_noise`` over 10 candidates) and one more with the flow prior
   weighted, one step at batch 8 against the same model on the CPU with every
   draw injected, and the timing of the step (with its peak memory) and of its
   two kernels, which are first held against the plain version at the step's
   own shape (2048 tiles, about 16 for each block of both persistent grids);
   the forward is timed as the step runs it, saving the activations the
   backward reads. Each bound counts what its kernel is given (the
   backward's, the saved activations); the backward's bound given only the
   Pallas pair's inputs is printed under its own label.
8. two-attention generation and UNet, full width: ``configs/gen_chair.py``
   with ``single_attn=False`` set on the loaded config in the aligner and the
   denoiser. Batch-16 generation (a part absent in every third row) with
   launch counts set to 0 just before and read just after: 100 launches of
   the two-attention trunk's entry (one a step), no fused-FF launch (the
   denoiser's FF is inside the trunk; the aligner's T = 64 takes the unfused
   FF) and no single-attention trunk launch; a batch-1 run with every draw
   injected against the same model on the CPU; generation at batch 256 (1
   warm-up with parts absent in some rows, 2 timed runs, 100 trunk and 5
   fused-FF launches each: the aligner's T = 1024 takes the FF kernel). The
   entry's first launch at batch 16 and in the warm-up (2 and 32 tiles for
   each persistent block, across rows) is held against its plain version on
   the same inputs, and timed on the warm-up's inputs beside its plain
   version and its bound (the ``fused_core_two_attn`` row of the last line).
   Then a UNet forward at B = 256 x 2048 with the gen_chair denoiser's
   widths (3 channels, 8 x 16, depth 5, part tokens (B, 4, 522) with parts
   absent): 5 one-block launches, and at batch 2
   against the CPU. The fused FF and the one-block kernel are timed with CUDA
   events beside their plain versions and bounds; the FF at D = 256 and
   T = 1024, whose launch takes less device time than the wrapper's host
   time, as a CUDA graph of 20 launches.
9. runner, full width: the training loop as a user runs it,
   ``runner/cli.py:main`` on a config whose ``_base_`` is
   ``configs/bench_train_tpu.py`` (gen_chair at full width, SyntheticPart at
   batch 32 x 2048) for 3 epochs: CIMLE caches at epochs 0 and 2, val at
   epoch 3, checkpoints at epochs 2 and 3. Launch counts are set to 0 just
   before each run and read just after: one training forward and backward
   launch per step, 100 trunk launches per generation batch of val and of
   val_gen, EMD launches in both. What the kernels computed there is held
   against their plain versions on the same inputs: the first trunk launch
   of val (batch 32) and of val_gen (batch 64), and the first step's
   training-trunk forward and its 18 gradients under the step's own
   cotangent. Every logged loss is finite and no step is skipped; the CIMLE
   table holds one finite noise of the aligner's width per training shape; a
   second runner on the same work_dir resumes at epoch 3 with every
   parameter, buffer, moment and the step equal bit for bit; one step of it
   is held against a CPU runner resumed from the same checkpoint, on one
   batch with every draw injected and dropout off (both build the model in
   float32, as the JAX Runner does, the card casting to bf16 only at the
   kernels' operands: the flow prior's terms agree to 1e-4 and every module
   computes in float32);
   ``--task val_gen --gen_num 64`` gives 12 finite metrics. Then a
   ``CroppingDataLoader`` over SyntheticPart at 8192 points, batch 32, crop
   [2048, 6144): partial and missing of (32, 2048, 3), each point one of its
   input cloud, 2 FPS launches a batch, each held index for index against
   the plain FPS. Printed: the first epoch's seconds; the median, least and
   most of 12 later epochs at the configuration's log interval and the
   training shapes/s from that median; the cache, val and val_gen seconds; a
   later epoch's device idle share; 5 passes of the loader alone; the peak
   memory.
10. reconstruction and editing, full width: ``configs/gen_chair.py`` (zdim
   256, T = 100, 2048 points, the aligner at D = 256, the 5-block denoiser)
   through a config whose ``_base_`` it is, with SyntheticPart at batch 32
   and ``resume_path`` a reference-layout ``.pth`` written with the torch
   modules of ``tools/reference_layout_torch.py`` and read by
   ``Runner.load``. Paths, each with the launch counts set to 0 just before
   and read just after, and its wall time and device idle share: the
   runner's val of a reconstruction model (the loaded model with
   ``gen=False``: ``cimle_sample_num`` candidates a shape, ``reconstruct``,
   the trajectory kept, the ``ae`` protocol's paired CD and EMD),
   ``reconstruct``, ``--task mixing`` and ``--task interpolation`` through
   ``runner/cli.py:main``, ``combine_latent``, ``interpolate_latent``,
   ``sample_one_part`` (32 shapes x 10 variants, an aligner search over 100
   noises each: 32,000 rows) and ``shape_edit`` (100 Adam steps); then
   ``sample_one_part`` and ``shape_edit`` again with the aligner in its
   two-attention form (``single_attn=False``, seeded; the rest loaded), whose
   FF at D = 256 is the fused FF kernel: 5 launches in the search, 5 in the
   edit's decode and none in its 100 steps under autograd. Each path
   launches the trunk 100 times. The first launch of the trunk, the fused
   FF and the EMD assignment on these paths is held against its plain
   version, and one ``shape_edit`` step's z-gradient on the card (float32)
   against the CPU's. One JSON line then gives every kernel's numbers, with
   its launches in phase 9 (``launches_runner``) and phase 10
   (``launches_editing``).
11. the chain's variants, full width: gen_chair with DDIM (25 quad steps,
   eta 1) at batch 256: launch counts set to 0 just before and read just
   after (25 trunk launches), 3 timed runs (shapes/s, host clock), the idle
   share, and a batch-1 run with every draw injected against the CPU; a
   ``learned_range`` variance (proj_out 128 x 6) with guidance at weight 2,
   batch 256: 200 trunk launches, finite, timed; ``add_t_to_x`` at batch
   256: 100 launches of the trunk's head-less entry, its first launch held
   against the plain version, the entry timed beside its plain version and
   bound; ``tools/eval_ckpt_curve_torch.py --ddim 25`` on phase 9's final
   checkpoint (25 trunk launches, 12 finite metrics). The kernels line lists
   the head-less entry beside the trunk, whose row carries phase 11's
   numbers.
12. the JAX package's checkpoints, two-attention and UNet training,
   per-part pretraining, full width: phase 9's final checkpoint exported to
   the JAX layout (``utils/jax_params.py:export_jax_train_state``) and
   written as ``ckpt_3.msgpack`` (``utils/jax_checkpoint.py``) resumes a
   fresh runner by ``resume_path`` with every parameter, buffer, moment, the
   count and the step equal bit for bit to the ``.pt`` resume (both loads
   timed); ``val_gen --gen_num 64`` from both, launch counts set to 0 just
   before and read just after (100 trunk and 4 EMD launches each), the
   metrics equal (or within the spread of two ``.pt`` runs). gen_chair with
   two-attention blocks, and with the UNet denoiser at phase 8's widths, in
   float32 as the Runner builds it: 3 steps at batch 32 x 2048 on one batch,
   every draw injected, dropout 0, finite with the last loss below the
   first, no kernel launch under autograd, ms a step; one step at batch 4
   against the CPU at phase 9's tolerances. ``--runner pretrain`` through
   ``runner/cli.py:main`` on a config whose ``_base_`` is
   ``configs/bench_train_tpu.py`` (PointwiseNet at its defaults,
   ``pts_per_part`` 512, ``learn_variance`` off as the JAX sampler needs):
   one epoch and val, no kernel launch, finite samples of each part, timed.
13. multi-GPU (``parallel/mesh.py``, ``parallel/axes.py``): prints the card
   count, then runs ranks of this script (``--rank``, a ``FileStore`` under a
   temporary directory): NCCL over ``min(count, 4)`` cards where there are
   several; on one card NCCL at world size 1 through the whole distributed
   path, then 2 ranks sharing the card over gloo with CUDA tensors. Each
   run prints its backend and world size and holds, at full width: 3 dp
   training steps at dropout 0 on one global batch of 32 x 2048, every draw
   injected, against the same ranks' arithmetic done by this process on one
   rank (each slice's loss and gradients from the same statistics, their
   mean, one update: the plain step at world size 1), at phase 9's
   tolerances, with one B2 and one B3 launch a step on each rank; dp
   generation at global batch 16 (timed after one warm-up), every draw
   injected, against the one-rank run within E2E_REL_L2, with 100 B1
   launches on each rank; with two ranks
   or more, sp = 2 generation (the point axis cut in two) held the same way
   and one sp = 2 training step against the one-rank step; the 64 v 64
   protocol on phase 6's clouds with its sweeps dealt to the ranks, equal to
   phase 6's metrics, its B5 launches split across the ranks; then
   ``tools/run_net_torch.py --launcher pytorch`` under
   ``torch.distributed.run`` for 2 epochs of ``configs/bench_train_tpu.py``
   (CIMLE cache, val with its generation and sweeps sharded, a checkpoint),
   its epoch seconds printed with what they are (ranks sharing one card
   measure no scaling). Launch counts are set to 0 before each run and read
   after; the kernels line carries ``launches_multi_gpu``.
14. the last runner families and PDM, full width (gen_chair's zdim 256, 4
   parts, 2048 points, T = 100): ``--runner gan`` through the CLI on a
   config whose ``_base_`` is ``configs/bench_train_tpu.py`` (the JAX
   defaults of ``Generator`` and ``Discriminator``) for one epoch and its
   val (100 trunk launches a val batch, EMD launches, nothing else), then
   one critic and one generator step against a CPU runner resumed from the
   card's checkpoint; ``--runner language --no_eval`` on
   ``SyntheticLanguagePart`` at 2048 points (no kernel launch, every
   parameter outside the language modules bit for bit as it was), then one
   step against the CPU; ``MixingRunner.mixing`` on one val batch of 32
   (100 trunk launches), then ``combine_latent`` on 2 shapes against the
   CPU with every draw injected; ``PDM`` on ``PointNet2SSG(4, 256, 1)`` and
   ``PointwiseNet``: 3 training steps and one predict at batch 32 (2 FPS
   launches a forward pass, 2048 -> 512 and 512 -> 128, each held index for
   index against the plain FPS), one step at batch 4 and a predict of 2
   shapes against the CPU (the steps and the predict are float32 on both
   sides: losses within 1e-4, updates within 1e-2 of the mean update, PDM's
   gradient norm within 1e-3, the predict within 1e-4); a forward pass of ``PointNet2SSG`` and
   ``PointNet2MSG`` timed beside its FPS launches and ball queries. The
   first trunk launch of the GAN's val and of the mixing, and the val's
   first EMD launch, are held against their plain versions. Every kernel's
   entry in the kernels line gains ``launches_gan``, ``launches_language``,
   ``launches_mixing`` and ``launches_pdm``.
15. AnchorDiffAE's other encoders and the anchored generators, full width:
   gen_chair (bf16, T = 100) on ``PartEncoderForTransformerDecoderKLLoss``
   (``include_std``): generation at batch 256 (100 trunk launches, the first
   held against the plain version) and a batch-1 run against the CPU within
   E2E_REL_L2; gen_chair on ``PartEncodercVAE`` (``encode_ref``, float32): 3
   steps at batch 32 x 2048 (one training-trunk forward and backward a step,
   the first held against the plain version, the loss falling) and one step
   at batch 4 against the CPU at phase 9's tolerances. The base
   ``PartEncoder`` (the MLP ``PartAligner``, ``include_z``) with
   ``PointwiseNet`` on bench_train_tpu's model: 64 shapes scored by phase 6's
   protocol against its 64 clouds of 8192 points (1 FPS and the EMD sweeps'
   launches, each held against its plain version), 2 shapes against the CPU.
   ``AnchoredGeneration`` (``PCN``, ``MeanVarianceRegressor``,
   ``ComponentMixer`` with attention and a global code, ``PointwiseNet``) and
   ``AnchorDiffGenPartglot`` (``SupSegsEncoder`` on 50 super-segments of 512
   points): 3 steps at batch 32 (no kernel launch, the loss falling), a
   predict of 64 shapes scored by the protocol, or a predict,
   ``interpolate_latent`` and ``combine_latent``; one step and a predict of 2
   shapes each against the CPU (float32, phase 14's tolerances). One line
   prints the phase's seconds, the step times and every card-against-CPU
   reading beside its constant; every kernel's entry in the kernels line
   gains ``launches_slice15``.
16. The latent editors, the super-segment generator, completion and
   PointFlow at bench_train_tpu's latent widths (latent 256, 4 parts, 2048
   points, T = 100), float32 models. ``LatentDiffEdit``'s own chain and
   ``LDMNet`` sample 256 x 4 x 256 part latents with the edit's 4-token
   context: with two-attention blocks at inner 256 (200 fused-FF launches at
   D = 256, T = 1280, the path's launch and the kernel at that shape held
   against the plain version) and with flat blocks at inner 128 (no launch:
   the one-block kernel's rule refuses a shape's 5 tokens); a 2-row chain
   of each and a 128-row chain through the kernel against the CPU. Three
   steps at batch 32 of ``LatentDiffEdit``, ``PartLatentEditor``,
   ``ParameterTrainer``, ``Aligner`` and ``PartglotFinetune`` (the loss
   falling, no launch) and one step of each at batch 8 (the Aligner 16)
   against the CPU.
   ``AnchorDiffGenSuperSegments`` (PCN, the latent projection with the
   learned scale and a GroupNorm'd post-FF, ComponentMixer, PointwiseNet):
   3 steps, a predict of 64 shapes scored by phase 6's protocol (FPS and
   EMD launches held), ``get_params``, ``combine_latent``,
   ``interpolate_latent`` and ``anchor_drift`` (10 magnitudes) on 4 shapes,
   a step and a 2-shape predict against the CPU. ``PCN`` (8192 points on a
   4 x 4 grid), ``CoarsePCN`` and ``DiffuCompletion`` (2048 points): each on
   a ``CroppingDataLoader`` batch of 32 x 8192 (2 FPS launches, 3 with
   DiffuCompletion's 2048-point target, each held index for index), 3 steps,
   ``reconstruct`` at batch 32, a step at batch 4 against the CPU.
   ``PointFlow`` at the JAX class's defaults: a sample of 32 x 2048, 2 steps
   at batch 16 with the peak memory, a step and a sample against the CPU at
   8 x 32 and 2 x 32 points. One line prints the phase's seconds, the step
   times and every card-against-CPU reading; every kernel's entry gains
   ``launches_slice16``.
17. B1's fused tail, its switches, ``data/custom.py`` and the data tools,
   full width: both tail entries (``fused_core_tail``,
   ``fused_core_headless_tail``: proj_out 128 x 3 inside the trunk) against
   their plain versions at B = 256, N = 2048 with parts absent and at a
   ragged N, timed beside the same entry without the tail and beside that
   entry followed by proj_out, with the bound; gen_chair at batch 256 under
   ``DIFFFACTO_FUSE_TAIL=1`` (100 tail launches, the first held, a batch-1
   run against the CPU) and its shapes/s beside the default's, in turns;
   ``DIFFFACTO_FUSE_HEAD=0`` with and without the tail (100 launches of
   each head-less entry, the first held). ``tools/process_data_torch.py``
   and ``tools/fps_shape_torch.py`` on 32 dense clouds of 10,000 points and
   ``tools/extract_parts_torch.py`` on a dump of 32 of phase 5's shapes,
   each on the card (launch counts read) and with ``--cpu``, the outputs
   equal. All ten DATASETS keys of ``data/custom.py`` built from files the
   phase writes, one batch each; ``ShapeNet`` (32 ShapeNet-55 clouds of
   8192 points) through its cropping loader on the card into 3
   ``DiffuCompletion`` steps (3 FPS launches held index for index); the dump
   through ``CustomDataset`` into ``MixingRunner.mixing`` (100 trunk
   launches, the first held); ``process_data_torch.py``'s npz through
   ``Partnet`` into 2 steps of the gen_chair ``Runner`` at batch 32 (one B2
   and one B3 a step, the first held). The kernels line lists the two tail
   entries, and every entry gains ``launches_slice17``.

The last line is {"ok": true, "device": {...}}.
"""

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16
PEAK_F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
# Square roots and exponentials go through the special-function units: 16 lanes
# an SM against the 128 FMA lanes (2 operations each) behind the f32 peak.
PEAK_SFU_OPS = PEAK_F32_FLOPS / 16
# The EMD Sinkhorn sweep's instructions an element with both exp2s on the
# special-function units, and the further instructions of one exp2 on the FMA
# pipes, from the SASS of its inner loop (tools/sass_diff_torch.py --source
# emd_hybrid: 185 instructions for 16 elements; 218 with 3 of them soft).
SWEEP_INSTRUCTIONS, SWEEP_SOFT_INSTRUCTIONS = 185 / 16, 33 / 3
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
BATCH_CHECK, BATCH_TIMED, WARMUP, ITERS = 16, 256, 1, 3

# The hand-written kernels, by the name of their launch counter in the
# port's recorder (``difffacto_torch/utils/trace.py``: ``<kernel>.launches``).
KERNELS = ("fused_core", "fused_core_headless", "fused_core_tail", "fused_core_headless_tail",
           "fused_trunk_train_fwd", "fused_trunk_train_bwd", "emd_hybrid", "fps", "fused_ff",
           "fused_block", "fused_core_two_attn")
_LAUNCH_ZERO = {}  # each kernel's recorder count where its launches were last set to 0


def kernel_launches(*kernels) -> dict:
    """{kernel: launches since ``zero_launches`` last named it} for
    ``kernels`` (every kernel when none is named), read from the recorder."""
    from difffacto_torch.utils import trace

    now = trace.counters()
    return {k: now.get(f"{k}.launches", 0) - _LAUNCH_ZERO.get(k, 0) for k in kernels or KERNELS}


def zero_launches(*kernels):
    """Count the launches of ``kernels`` (every kernel when none is named) from now."""
    for k, n in kernel_launches(*kernels).items():
        _LAUNCH_ZERO[k] = _LAUNCH_ZERO.get(k, 0) + n


@contextlib.contextmanager
def uncounted(*kernels):
    """Leave the launches of ``kernels`` inside the block out of every later reading."""
    before = kernel_launches(*kernels)
    yield
    for k, n in kernel_launches(*kernels).items():
        _LAUNCH_ZERO[k] = _LAUNCH_ZERO.get(k, 0) + n - before[k]

# bf16 kernel against its bf16 plain version: the two round at the same
# points but sum in another order, so an intermediate may land one bf16 step
# apart and carry through the blocks (see tests/test_torch_gpu.py).
KERNEL_MAX_ABS, KERNEL_MEAN_ABS = 0.125, 1e-3
# The same seeded model on the card and on the CPU with every draw injected:
# the two trunks differ by those bf16 steps in each of the 100 denoiser calls,
# and the chain carries them to the samples. An H100 showed a relative L2
# difference of 5.6e-4; a wrong kernel or chain gives O(1).
E2E_REL_L2 = 5e-3
# Phase 8: the UNet forward at batch 2, card against CPU, relative L2 over
# what the network adds to its input (proj_out is given random weights: it
# starts at zero). bf16 both, the CPU through the plain block. An H100 showed
# 1.5e-2, and on the CPU the same seeded net in bf16 differs from itself in
# f32 by 1.5e-2 too: the hidden state is f32 between the blocks and rounds to
# bf16 at each of the five; a wrong kernel or mask gives O(1).
UNET_REL_L2 = 5e-2
TWO_ATTN_BATCH_TIMED, TWO_ATTN_ITERS, UNET_BATCH = 256, 2, 256
# The EMD kernel sums its Sinkhorn in base 2 with the approximate square root
# and exp of the special-function units, its plain version in base e with
# exact ones and in another order, so a near-tie may go to another object:
# assignments may differ (the share is printed), the matched costs agree
# within 0.5 %. At n = 512 the kernel's cost is held to 1.01 x the Hungarian
# optimum, as the JAX package's tests hold the TPU kernel.
EMD_COST_RTOL, EMD_HUNGARIAN = 0.005, 1.01
# Phase 6: the card's CD against the CPU's (f32 both, another summation order)
# and the card's EMD kernel against the plain hybrid on the CPU (eps-optimal both).
CORNER_CD_RTOL, CORNER_EMD_RTOL = 1e-4, 0.03
EVAL_SHAPES, REF_POINTS, AUCTION_ITERS, CORNER = 64, 8192, 150, 2
# The backward kernel rounds the inputs of its matrix products to bf16, as the
# Pallas kernel does; autograd through the plain version keeps them f32, and
# the atomics sum in another order. An H100 showed relative L2 differences of
# 2e-3 to 9e-3 over dx, dK, dV and the 15 parameter gradients, and a largest
# difference of 1 % of the largest entry; a wrong mask or product gives O(1).
GRAD_REL_L2, GRAD_MAX_REL = 2e-2, 4e-2
KEPT_SHARE_TOL = 0.005
# Phase 7. One step on the card against the same step on the CPU (bf16 both,
# the CPU through the plain trunk), every draw injected.
TRAIN_BATCH, TRAIN_STEPS, TRAIN_WARMUP, TRAIN_TIMED, STEP_CHECK_BATCH = 128, 20, 2, 10, 8
STEP_LOSS_RTOL, STEP_GNORM_RTOL = 2e-2, 5e-2
# Adam's first update is -lr * g / (|g| + eps): lr in size whatever the
# gradient, so two runs differ by up to 2 lr where a tiny gradient changes
# sign. The mean difference is held to a quarter of lr.
STEP_PARAM_MEAN_LR = 0.25
LR = 2e-3

# Phase 15: AnchorDiffAE's other encoders and the anchored generators at
# gen_chair's widths (zdim or latent 256, 4 parts, 2048 points, T = 100).
# (a) gen_chair with its encoder swapped for a transformer-decoder variant:
# generation (P15_GEN_BATCH) with PartEncoderForTransformerDecoderKLLoss
# (include_std), training (phase 12's TRAIN12_* steps and check) with
# PartEncodercVAE (encode_ref). (b) the base PartEncoder with the MLP
# PartAligner, include_z and PointwiseNet on bench_train_tpu's model:
# P15_SHAPES shapes scored by phase 6's protocol. (c) AnchoredGeneration (PCN,
# MeanVarianceRegressor, ComponentMixer with attention and a global code,
# PointwiseNet): P15_STEPS steps at P15_TRAIN_BATCH, then a predict of
# P15_SHAPES shapes scored the same way. (d) AnchorDiffGenPartglot on
# SupSegsEncoder: P15_STEPS steps at P15_TRAIN_BATCH on seeded super-segments
# (P15_NSEG segments of P15_NPOINT points, the (S, n_seg, npoint, 3) layout of
# tools/pack_partglot.py), a predict, an interpolate_latent, a combine_latent.
# Card against CPU: (a)'s generation within E2E_REL_L2 (the bf16 trunk against
# its plain version, as phase 4) and its step within phase 9's STEP_LOSS_RTOL,
# STEP_GNORM_RTOL and RUNNER_UPDATE_REL (float32 models, the card's training
# trunk in bf16); (b), (c) and (d) run no inexact kernel (their denoisers are
# pointwise), so their float32 steps and decodes are held to phase 14's
# P14_* constants, which allow about 20 times what float32 in another
# summation order gave there.
P15_GEN_BATCH, P15_SHAPES, P15_TRAIN_BATCH, P15_STEPS, P15_CHECK = 256, 64, 32, 3, 2
# The steps against the CPU take 8 shapes: the generators' BatchNorm over
# few rows amplifies float32's rounding. On the CPU alone one float32 step of
# AnchoredGeneration is 5.8% from the float64 step in its update over 2
# rows, 0.2% over 4 (on an H100 it read 2.0e-3 of P14_UPDATE_REL's 1e-2
# against the CPU), 0.016% over 8.
P15_CHECK_STEP = 8
P15_NSEG, P15_NPOINT, P15_INTERP_STEPS, P15_T = 50, 512, 10, 100
# The MLP aligner's heads start from N(0, 0.25^2), the reference's init:
# untrained, at zdim 256 its logvar passes float32's exp range, so its fc4
# kernels are scaled by P15_ALIGNER_HEAD before anything runs.
P15_ALIGNER_HEAD = 0.01
# Adam's first updates move every weight by about lr whatever its gradient:
# at gen_chair's LR the seeded MLP stacks of the anchored generators
# (BatchNorm over their batch) overshoot on the second step; their steps
# take P15_LR.
P15_LR = 3e-5
P15_PW = dict(type="PointwiseNet", point_dim=3, residual=False)
P15_DIFF = dict(type="AnchoredDiffusion", net=P15_PW, beta_1=1e-4, beta_T=0.02, k=1.0,
                mode="linear", model_mean_type="epsilon", include_anchors=False, res=False)
P15_ANCHORED = dict(
    type="AnchoredGeneration", encoder=dict(type="PCN", point_dim=7, part_latent_dim=256),
    parameter_regressor=dict(type="MeanVarianceRegressor", latent_dim=256),
    decomposer=dict(type="ComponentMixer", part_latent_dim=256, include_attention=True,
                    include_global_feature=True),
    diffusion=P15_DIFF, sampler=dict(type="Uniform"), num_anchors=4, num_timesteps=P15_T,
    npoints=2048)
P15_PARTGLOT = dict(
    type="AnchorDiffGenPartglot",
    encoder=dict(type="SupSegsEncoder", sup_segs_dim=64, part_latent_dim=256),
    decomposer=dict(type="ComponentMixer", part_latent_dim=256, include_attention=True,
                    include_global_feature=True),
    diffusion=P15_DIFF, sampler=dict(type="Uniform"), num_anchors=4, num_timesteps=P15_T,
    npoints=2048)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def phase(name):
    print(f"== {name}", flush=True)


def cuda_ms(fn, iters):
    """Mean device time of fn() in ms over ``iters`` calls, after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters):
    """Mean device time of fn() in ms over ``iters`` calls captured in one
    CUDA graph and replayed: for kernels shorter than their wrapper's host
    time, where back-to-back launches would time the host."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def trunk_bound_ms(args, out_bytes, in_ch, depth, out_ch=0, attn1=False):
    """The least time for one trunk launch: its operations over the bf16 peak
    against its bytes (inputs read once, output written once) over HBM;
    ``out_ch`` counts a fused proj_out's, ``attn1`` a first attention in
    every block (the two-attention entry: one more attention half)."""
    from difffacto_torch.ops import fused_core as fc

    B, N = args[0].shape[:2]
    half = 2 * fc.D * fc.D + 2 * fc.HEADS * fc.CTX * (fc.D // fc.HEADS)
    macs = (in_ch + out_ch) * fc.D + depth * ((2 if attn1 else 1) * half + 3 * fc.D * fc.FF)
    t_ops = 2.0 * B * N * macs / PEAK_BF16_FLOPS * 1e3
    t_bytes = (sum(a.numel() * a.element_size() for a in args) + out_bytes) / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def device_busy(fn):
    """(wall ms, device-busy ms) of fn(): the wall time of one unprofiled run,
    and the union of the device intervals (kernels, copies) that
    ``torch.profiler``, tracing the card alone, records over a second run of
    the same work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    if busy <= 0:
        fail("torch.profiler traced no device time")
    return wall, busy / 1e3


def trunk_train_bound_ms(ops, B, N, depth, out_bytes):
    """The least time for the training trunk's forward and for its backward,
    each given its own inputs. Per token and block the forward does 2 D^2
    (Wq, Wout) + 3 D FF (W1, W2) MACs and 1024 in the attention to 4 tokens
    (scores, weighted sum), and under autograd writes 2 depth + 1 bf16
    activations a token. The backward reads those activations (each block's
    u and up, the final hidden), so it redoes only Wq, W1 and the attention
    (D^2 + 2 D FF + 1024) before two products for each matrix product (the
    input's gradient and the weight's: 4 D^2 + 6 D FF) and 2048 in the
    attention (d_weights, dV, dq, dK). What the kernel does beyond that is
    its design's cost, not part of the bound. Bytes: every operand once, the
    output and the saved activations (forward) or dy, the saved activations,
    dx and every gradient (backward) once.

    ``bwd_jax_inputs`` is the backward given only the Pallas pair's inputs
    (no saved activations: the whole forward once more), the bound that
    earlier measurements of this kernel were held to."""
    from difffacto_torch.ops import fused_core as fc

    small = 2 * fc.HEADS * fc.CTX * (fc.D // fc.HEADS)
    fwd = 2 * fc.D * fc.D + 3 * fc.D * fc.FF + small
    grads = 4 * fc.D * fc.D + 6 * fc.D * fc.FF + 2 * small
    redo = fc.D * fc.D + 2 * fc.D * fc.FF + small
    in_bytes = sum(a.numel() * a.element_size() for a in ops)
    io = B * N * fc.D * 2
    saved = (2 * depth + 1) * io
    out = {}
    for name, macs, nbytes in (("fwd", fwd, in_bytes + io + saved),
                               ("bwd", redo + grads, in_bytes + saved + 2 * io + out_bytes),
                               ("bwd_jax_inputs", fwd + grads, in_bytes + 2 * io + out_bytes)):
        t_ops = 2.0 * B * N * depth * macs / PEAK_BF16_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        out[name] = (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")
    return out


def example_batch(B, npoints, n_class=4, seed=0):
    """The synthetic training batch of the JAX package's entry point, as numpy
    arrays: four equal parts, Gaussian points, random part shifts and scales."""
    rng = np.random.RandomState(seed)
    seg = np.repeat(np.arange(n_class), npoints // n_class)[None].repeat(B, 0)
    pts = rng.randn(B, npoints, 3).astype(np.float32) * 0.3
    return {
        "input": pts, "ref": pts, "ref_seg_mask": seg.astype(np.int32),
        "seg_mask": seg.astype(np.int32),
        "present": np.ones((B, n_class), np.float32),
        "dp_present": np.ones((B, n_class), np.float32),
        "part_shift": rng.randn(B, n_class, 3).astype(np.float32) * 0.1,
        "part_scale": np.abs(rng.randn(B, n_class, 3)).astype(np.float32) * 0.2 + 0.3,
        "noise": np.zeros((B, 1), np.float32),
    }


def build_train_model(device, stage2=False, dropout=0.2, dtype=torch.bfloat16, net=None,
                      aligner=None, encoder=None):
    """gen_chair (or its stage-2 config) at full width as phase 7 trains it;
    ``net`` replaces the denoiser's keys, ``aligner`` updates the aligner's,
    ``encoder`` the part encoder's."""
    from difffacto_torch import MODELS, Config, build_from_cfg

    name = "train_chair_stage2.py" if stage2 else "gen_chair.py"
    mcfg = Config(os.path.join(ROOT, "configs", name)).model.dump()
    mcfg.update(npoints=2048, ret_traj=False, dtype=dtype)
    if net is not None:
        mcfg["diffusion"]["net"] = dict(net)
    mcfg["encoder"]["part_aligner"].update(aligner or {})
    mcfg["encoder"].update(encoder or {})
    mcfg["diffusion"]["net"]["dropout"] = dropout
    if not stage2:
        mcfg["gen"] = False
        mcfg["encoder"]["gen"] = False
    return build_from_cfg(mcfg, MODELS, device=device, seed=0)


def build_train_optimizer(lr=LR):
    from difffacto_torch.parallel import build_optimizer_from_cfg

    return build_optimizer_from_cfg(
        dict(type="Adam", lr=lr, weight_decay=0.0),
        scheduler_cfg=dict(type="LinearLR", start_lr=2e-3, end_lr=1e-4, start_epoch=4000,
                           end_epoch=8000),
        iters_per_epoch=1, max_norm=10.0)


def to_device(batch, device):
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def ff_bound_ms(args, out_bytes):
    """The fused FF: 24 T D^2 operations (W1, 2 FF = 8 D wide, then W2) over
    the bf16 peak against its bytes (inputs read once, output written once)."""
    T, D = args[0].shape
    t_ops = 24.0 * T * D * D / PEAK_BF16_FLOPS * 1e3
    t_bytes = (sum(a.numel() * a.element_size() for a in args) + out_bytes) / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def block_bound_ms(args, out_bytes):
    """One block: per token 2 D^2 (Wq, Wout) + 12 D^2 (the FF) MACs and
    2 x 8 heads x 4 tokens x 16 in the attention, against its bytes."""
    from difffacto_torch.ops import fused_block as fb

    B, N, D = args[0].shape
    macs = 14 * D * D + 2 * fb.HEADS * fb.CTX * (D // fb.HEADS)
    t_ops = 2.0 * B * N * macs / PEAK_BF16_FLOPS * 1e3
    t_bytes = (sum(a.numel() * a.element_size() for a in args) + out_bytes) / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def ff_operands(D, T, device, seed):
    """fused_ff's operands at width D on ``device``: bf16, b1 and b2 f32."""
    from difffacto_torch.ops import fused_core as fc
    from difffacto_torch.ops import fused_ff as ff

    return fc.operands(ff.example_inputs(T, D, seed), device, torch.bfloat16)


def hold_bf16(name, got, want):
    """Fail unless a bf16 kernel's output agrees with ``want`` (its plain
    version's) within KERNEL_MAX_ABS and KERNEL_MEAN_ABS; returns the largest
    absolute difference."""
    err = (got.float() - want.float()).abs()
    print(f"{name}: max abs err {err.max().item():.4e} (tol {KERNEL_MAX_ABS}), "
          f"mean {err.mean().item():.4e} (tol {KERNEL_MEAN_ABS})")
    if (not torch.isfinite(got.float()).all() or err.max().item() > KERNEL_MAX_ABS
            or err.mean().item() > KERNEL_MEAN_ABS):
        fail(f"{name} disagrees with its plain version")
    return err.max().item()


def hold_train(label, y, g, yr, gr):
    """Fail unless the training trunk's forward y and its 18 gradients g (dx,
    dK, dV, the 15 parameters') agree with the plain version's yr and gr
    within KERNEL_MAX_ABS, KERNEL_MEAN_ABS, GRAD_REL_L2 and GRAD_MAX_REL;
    returns the largest absolute differences."""
    from difffacto_torch.ops import fused_core_train as fct

    grad_names = ["x", "k", "v"] + list(fct.PARAM_NAMES)
    err = (y - yr).abs()
    rels = [((a - b).norm() / b.norm()).item() for a, b in zip(g, gr)]
    maxs = [((a - b).abs().max() / b.abs().max()).item() for a, b in zip(g, gr)]
    worst = max(range(len(rels)), key=rels.__getitem__)
    print(f"fused_trunk_train {label}: forward max abs err "
          f"{err.max().item():.4e} (tol {KERNEL_MAX_ABS}), mean {err.mean().item():.4e} "
          f"(tol {KERNEL_MEAN_ABS}); 18 gradients: relative L2 at most {max(rels):.4e} "
          f"(d{grad_names[worst]}, tol {GRAD_REL_L2}), largest difference over largest entry "
          f"at most {max(maxs):.4e} (tol {GRAD_MAX_REL})")
    ok = all(torch.isfinite(t).all().item() for t in [y] + g)
    if not ok or err.max().item() > KERNEL_MAX_ABS or err.mean().item() > KERNEL_MEAN_ABS:
        fail(f"fused_trunk_train forward disagrees with its plain version at {label}")
    if not max(rels) <= GRAD_REL_L2 or not max(maxs) <= GRAD_MAX_REL:
        fail(f"fused_trunk_train backward disagrees with its plain version at {label}")
    return err.max().item(), max((a - b).abs().max().item() for a, b in zip(g, gr))


def fps_bound_ms(B, N, m):
    """FPS: B (m - 1) N distance updates of 8 f32 operations against reading
    the coordinates and writing the indices once."""
    t_ops = B * (m - 1) * N * 8 / PEAK_F32_FLOPS * 1e3
    t_bytes = (B * N * 12 + B * m * 4) / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def emd_bound_ms(n, bids, sinkhorn_iters=150, rows=None, soft=0.0):
    """EMD assignment: per pair 2 * sinkhorn_iters sweeps of rows * n elements
    for the Sinkhorn, and n elements for each bid this run computed (only
    unassigned rows bid; ``bids`` is the kernel's count per pair, the
    force-assigned rows included). A sweep element is SWEEP_INSTRUCTIONS
    instructions and a square root and an exp2 on the special-function units,
    but for the share ``soft`` of its exp2s that the FMA pipes take in
    SWEEP_SOFT_INSTRUCTIONS more; a bid element 10 instructions and a square
    root. The larger of the dispatch time (an instruction a clock on each of an
    SM's four schedulers: PEAK_F32_FLOPS / 2 a second) and the special-function
    time, against 28 n bytes a pair."""
    rows = n if rows is None else rows
    sink = 2.0 * sinkhorn_iters * rows * n * len(bids)
    auction = float(sum(bids)) * n
    t_dispatch = (sink * (SWEEP_INSTRUCTIONS + soft * SWEEP_SOFT_INSTRUCTIONS) + auction * 10) / (
        PEAK_F32_FLOPS / 2) * 1e3
    t_sfu = (sink * (2 - soft) + auction) / PEAK_SFU_OPS * 1e3
    t_bytes = len(bids) * n * 28 / PEAK_BYTES * 1e3
    return max((t_dispatch, "dispatch"), (t_sfu, "special-function units"), (t_bytes, "bytes"))


def matched_cost(a, b, assign):
    matched = torch.gather(b, 1, assign.long()[..., None].expand(-1, -1, 3))
    return (a - matched).norm(dim=-1).mean(dim=1)


def seeded_clouds(B, N, seed, distinct=None):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, distinct or N, 3).astype(np.float32)
    if distinct:
        x = np.tile(x, (1, N // distinct, 1))
    return torch.as_tensor(x)


def build_model(noise_scale, device, single_attn=True, diffusion=None, net=None):
    """gen_chair at full width, bf16, seeded; ``diffusion`` and ``net`` are
    keys set on the loaded config's diffusion and denoiser."""
    from difffacto_torch import MODELS, Config, build_from_cfg

    mcfg = Config(os.path.join(ROOT, "configs", "gen_chair.py")).model.dump()
    mcfg.update(npoints=2048, ret_traj=False, cimle_sample_num=1, dtype=torch.bfloat16)
    mcfg["encoder"]["part_aligner"].update(noise_scale=noise_scale, single_attn=single_attn)
    mcfg["diffusion"]["net"]["single_attn"] = single_attn
    mcfg["diffusion"].update(diffusion or {})
    mcfg["diffusion"]["net"].update(net or {})
    return build_from_cfg(mcfg, MODELS, device=device, seed=0)


def build_unet(device):
    """UNet at the gen_chair denoiser's widths with seeded weights; proj_out,
    which starts at zero, gets random ones so that the output shows the net."""
    from difffacto_torch.models import UNet
    from difffacto_torch.nn.layers import lecun_normal

    g = torch.Generator().manual_seed(3)
    net = UNet(3, 8, 16, depth=5, prior_dim=522, dtype=torch.bfloat16, device=device,
               generator=g)
    with torch.no_grad():
        net.proj_out.kernel.copy_(lecun_normal((128, 3), g))
    return net


def unet_inputs(B, device, seed):
    """x (B, 2048, 3), t (B,), part tokens (B, 4, 522) and valid_id with a
    part absent in every third row."""
    rng = np.random.RandomState(seed)
    valid = np.ones((B, 4), np.float32)
    valid[::3, 1] = 0.0
    return [torch.as_tensor(a, device=device) for a in (
        rng.randn(B, 2048, 3).astype(np.float32), rng.randint(0, 100, B),
        rng.randn(B, 4, 522).astype(np.float32), valid)]


RUNNER_CONFIG = os.path.join("configs", "bench_train_tpu.py")
# Phase 9: 3 epochs of 2 steps at batch 32, CIMLE caches at epochs 0 and 2,
# val at epoch 3 (its 64 shapes in 2 batches), checkpoints at epochs 2 and 3.
RUNNER_OVERRIDES = dict(max_epoch=3, cimle_cache_interval=2, eval_interval=3,
                        checkpoint_interval=2, log_interval=1)
RUNNER_GEN_NUM = 64
# Later epochs at the configuration's own log interval, timed one by one, and
# passes of the loader alone.
RUNNER_TIMED_EPOCHS, LOADER_PASSES = 12, 5
# One step of the card's runner against the CPU's: both build the model in
# float32, as the JAX Runner does, and the card casts to bf16 only at the
# trunk kernels' operands. The same resumed weights and moments, one loader
# batch, every draw injected, dropout off. The loss dict and grad_norm are
# held to STEP_LOSS_RTOL and STEP_GNORM_RTOL (the trunk's bf16 rounds the
# inputs of its products, a relative 2^-9 each), the mean absolute difference
# of the two updates to a quarter of the CPU's mean absolute update. The flow
# prior's terms (prior_loss, each part's log-density and entropy) run in
# float32 on both and are held to PRIOR_RTOL, far below the 2^-9 relative
# rounding of each operand that a model built in bf16 on the card would
# apply to them. A wrong kernel or schedule gives O(1).
RUNNER_UPDATE_REL, PRIOR_RTOL = 0.25, 1e-4
CROP_POINTS, CROP_BATCH, CROP_SHAPES, CROP_RANGE = 8192, 32, 64, [2048, 6144]


def write_runner_config(work):
    """A config file under ``work`` whose ``_base_`` is RUNNER_CONFIG (by its
    absolute path), with RUNNER_OVERRIDES and a work_dir under ``work``:
    (its path, the keys it sets)."""
    keys = dict(RUNNER_OVERRIDES, work_dir=os.path.join(work, "bench_train"))
    path = os.path.join(work, "bench_train_smoke.py")
    with open(path, "w") as f:
        f.write(f"_base_ = [{os.path.join(ROOT, RUNNER_CONFIG)!r}]\n")
        f.write("".join(f"{k} = {v!r}\n" for k, v in keys.items()))
    return path, keys


def runner_state(r):
    """Every tensor a checkpoint holds, by name: parameters, buffers, Adam's
    moments and count, and the step."""
    names = [n for n, _ in r.model.named_parameters()]
    out = {f"param {n}": p.detach() for n, p in r.model.named_parameters()}
    out.update({f"buffer {n}": b for n, b in r.model.named_buffers()})
    for key in ("mu", "nu"):
        out.update({f"{key} {n}": t for n, t in zip(names, r.state.opt_state[key])})
    out["count"] = r.state.opt_state["count"]
    out["step"] = torch.tensor(r.state.step)
    return out


def core_reference(name, args):
    """fused_core_reference on the arguments of a call of the trunk entry
    ``name``: ``fused_core``'s, or ``fused_core_two_attn``'s with the first
    attention's seven operands between the trunk's and the scale."""
    from difffacto_torch.ops import fused_core as fc

    if name != "fused_core_two_attn":
        return fc.fused_core_reference(*args)
    n = len(fc.example_inputs(1, 1, 1))
    return fc.fused_core_reference(*args[:n], *args[n + 7:], attn1=tuple(args[n:n + 7]))


class KernelRecorder:
    """While entered, wraps each kernel wrapper at its (module, name) site,
    where the model calls it, and keeps the first launch of each at each
    input shape (its inputs and output), so that what a path computed can be
    held against the plain versions afterwards. The training trunk's first
    launch also keeps the cotangent the step gave it and the 18 gradients it
    returned."""

    def __init__(self, *sites):
        self.sites = sites
        self.real = {name: getattr(mod, name) for mod, name in sites}
        self.first, self.train = {}, None

    def __enter__(self):
        for mod, name in self.sites:
            setattr(mod, name, self._train if name == "fused_trunk_train" else self._wrap(name))
        return self

    def __exit__(self, *exc):
        for mod, name in self.sites:
            setattr(mod, name, self.real[name])

    def _wrap(self, name):
        def call(*args, **kwargs):
            out = self.real[name](*args, **kwargs)
            key = (name, tuple(args[0].shape[:2]))
            if key not in self.first:
                keep = lambda a: a.clone() if torch.is_tensor(a) else a
                self.first[key] = ([keep(a) for a in args], dict(kwargs), keep(out))
            return out
        return call

    def _train(self, *args):
        real = self.real["fused_trunk_train"]
        if self.train is not None:
            return real(*args)
        # A view of each input that takes a gradient: its hook sees what this
        # call's backward returns for it, and nothing of later steps.
        args = [a.view_as(a) if torch.is_tensor(a) and a.requires_grad else a for a in args]
        rec = self.train = {"args": [a.detach().clone() if torch.is_tensor(a) else a for a in args],
                            "grads": {}}
        for i, a in enumerate(args):
            if torch.is_tensor(a) and a.requires_grad:
                a.register_hook(lambda g, i=i: rec["grads"].__setitem__(i, g.detach().clone()))
        out = real(*args)
        rec["y"] = out.detach().clone()
        out.register_hook(lambda g: rec.__setitem__("dy", g.detach().clone()))
        return out

    def launches(self, name, label):
        """The kept launches of ``name`` by input shape; fails if there are none."""
        got = sorted((key[1], v) for key, v in self.first.items() if key[0] == name)
        if not got:
            fail(f"{label} recorded no launch of {name}")
        return got

    def hold_core(self, label, name="fused_core"):
        """Fail unless every kept launch of the trunk entry ``name``
        (``fused_core`` or ``fused_core_two_attn``) agrees with
        fused_core_reference on the same inputs (hold_bf16); returns the
        largest difference."""
        err = 0.0
        for (B, N), (args, _, out) in self.launches(name, label):
            with torch.inference_mode():
                want = core_reference(name, args)
            err = max(err, hold_bf16(f"{name} as {label} launched it, B={B} N={N}", out, want))
        return err

    def hold_train(self, label):
        """Fail unless the first training-trunk launch's forward and 18
        gradients agree with the plain version's on the same inputs and
        cotangent (hold_train); returns the largest differences (forward,
        backward)."""
        from difffacto_torch.ops import fused_core_train as fct

        rec = self.train
        grads = [1, 2, 3] + list(range(5, 20))  # x, k, v and the 15 parameters
        if rec is None or "dy" not in rec or sorted(rec["grads"]) != grads:
            fail(f"{label} recorded no whole training-trunk launch")
        seed, x, k, v, mask = rec["args"][:5]
        params, (scale, p) = rec["args"][5:20], rec["args"][20:22]
        leaves = [t.clone().requires_grad_(True) for t in (x, k, v, *params)]
        with torch.enable_grad():
            yr = fct.fused_trunk_train_reference(seed, *leaves[:3], mask, *leaves[3:], scale, p)
            yr.backward(rec["dy"])
        B, N = x.shape[:2]
        return hold_train(
            f"as {label} launched it, B={B} N={N} p={p} (the first step's own cotangent)",
            rec["y"].float(), [rec["grads"][i].float() for i in grads], yr.detach().float(),
            [t.grad.float() for t in leaves])


def runner_step_against_cpu(card, cfg):
    """One step of ``card`` (resumed, on the card) against a CPU runner
    resumed from the same checkpoint, float32 both: one batch of the card
    runner's loader, the diffusion t and noise and the part-code draw
    injected, dropout off in both for the step. Fails beyond the tolerances
    stated at RUNNER_UPDATE_REL; returns what it measured."""
    from difffacto_torch.runner import Runner
    from difffacto_torch.runner.runner import device_batch

    cpu = Runner(cfg=cfg, device="cpu")
    if cpu.state.step != card.state.step or cpu.epoch != card.epoch:
        fail(f"the CPU runner resumed at step {cpu.state.step}, the card's at {card.state.step}")
    batch = next(iter(card.train_loader))
    B, N = np.asarray(batch["ref"]).shape[:2]
    enc = card.model.encoder_mod
    rng = np.random.RandomState(41)
    draws = dict(diffusion_t=rng.randint(0, card.model.num_timesteps, B).astype(np.int64),
                 diffusion_noise=rng.randn(B, N, 3).astype(np.float32),
                 part_code_eps=rng.randn(B, enc.n_class, enc.zdim).astype(np.float32))
    runs = []
    for r in (card, cpu):
        drops = [(m, m.dropout) for m in r.model.modules()
                 if isinstance(getattr(m, "dropout", None), float)]
        for m, _ in drops:
            m.dropout = 0.0
        db = device_batch(batch, r.device, r._slim_train)
        db.update({k: torch.as_tensor(v, device=r.device) for k, v in draws.items()})
        before = [p.detach().clone() for p in r.model.parameters()]
        t0 = time.perf_counter()
        r.state, met = r._step_fn(r.state, db, r.seed + 7919, r.epoch)
        met = {k: float(v) for k, v in met.items()}
        print(f"runner step at batch {B} on {r.device.type}: {time.perf_counter() - t0:.1f} s, "
              + json.dumps({k: round(met[k], 5) for k in ("total_loss", "mse_loss", "fit_loss",
                                                          "prior_loss", "grad_norm")}))
        runs.append((met, [(p.detach() - b).float().cpu()
                           for p, b in zip(r.model.parameters(), before)]))
        for m, p in drops:
            m.dropout = p
    del cpu
    (mc, uc), (mh, uh) = runs
    keys = [k for k in mh if k not in ("grad_norm", "skipped_nonfinite", "kl_weight")]
    rel = {k: abs(mc[k] - mh[k]) / max(abs(mh[k]), 1e-12) for k in keys}
    worst = max(rel, key=rel.get)
    gn = abs(mc["grad_norm"] - mh["grad_norm"]) / mh["grad_norm"]
    diff = torch.cat([(a - b).abs().flatten() for a, b in zip(uc, uh)]).mean().item()
    upd = diff / torch.cat([b.abs().flatten() for b in uh]).mean().item()
    prior = [k for k in keys if k == "prior_loss" or k.startswith(("log_p_part", "entropy"))]
    prior_rel = max(rel[k] for k in prior)
    dtypes = sorted({str(getattr(m, "dtype", None)) for m in card.model.modules()
                     if hasattr(m, "dtype")})
    print(f"card runner against CPU runner (float32 both; module dtypes on the card {dtypes}), "
          f"one step: loss dict off by at most {rel[worst]:.3e} ({worst}, tol {STEP_LOSS_RTOL}), "
          f"the flow prior's {len(prior)} terms by {prior_rel:.3e} (tol {PRIOR_RTOL}), grad_norm "
          f"{mc['grad_norm']:.4f} vs {mh['grad_norm']:.4f} off by {gn:.3e} (tol "
          f"{STEP_GNORM_RTOL}); updates: mean abs difference {upd:.4f} of the mean abs update "
          f"(tol {RUNNER_UPDATE_REL})")
    if mc["skipped_nonfinite"] or mh["skipped_nonfinite"]:
        fail("the runner step against the CPU was skipped as non-finite")
    if not rel[worst] <= STEP_LOSS_RTOL or not gn <= STEP_GNORM_RTOL or not upd <= RUNNER_UPDATE_REL:
        fail("the card's runner step disagrees with the CPU's float32 runner step")
    if len(prior) < 3 or not prior_rel <= PRIOR_RTOL or dtypes != ["None"]:
        fail(f"the card's runner computes the flow prior in another precision than the CPU's "
             f"float32 (module dtypes {dtypes})")
    return dict(loss_rel=rel[worst], grad_norm_rel=gn, update_rel=upd, prior_rel=prior_rel)


def runner_phase(dev, fc, fct, fpsm, eh, ff, fb, keep):
    """Phase 9: the port's training loop as a user runs it, through
    ``runner/cli.py:main`` on ``configs/bench_train_tpu.py``; then the
    cropping loader. Returns the launch counts of each kernel, the largest
    errors of the recorded launches and the times, and the path of the
    final checkpoint, copied into the directory ``keep``."""
    import shutil

    import tempfile
    import warnings

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from difffacto_torch.config import Config, get_cfg
    from difffacto_torch.data import CroppingDataLoader, SyntheticPart
    from difffacto_torch.ops import points
    from difffacto_torch.ops.fps import furthest_point_sample_reference
    from difffacto_torch.runner import Runner
    from difffacto_torch.runner.cli import main as cli_main
    from difffacto_torch.runner.runner import device_batch

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    times = {"train": [], "cache_noise": [], "val": []}
    originals = {name: getattr(Runner, name) for name in times}

    def timed(name):
        def run(self, *a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = originals[name](self, *a, **k)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
            return out
        return run

    counted = ("fused_core", "fused_trunk_train_fwd", "fused_trunk_train_bwd", "fps",
               "emd_hybrid", "fused_ff", "fused_block")

    def zero():
        zero_launches(*counted)

    def read():
        return kernel_launches(*counted)

    from difffacto_torch.models import denoiser

    recorder = KernelRecorder((denoiser, "fused_core"), (denoiser, "fused_trunk_train"))
    with tempfile.TemporaryDirectory() as work:
        cfg_file, keys = write_runner_config(work)
        argv = ["--config-file", cfg_file]
        print(f"{RUNNER_CONFIG} --task train, through a config with _base_ = [{RUNNER_CONFIG}] "
              f"that sets {keys}")
        for name in times:
            setattr(Runner, name, timed(name))
        try:
            with recorder:
                zero()
                t0 = time.perf_counter()
                run = cli_main(argv + ["--task", "train"])
                torch.cuda.synchronize()
                train_wall = time.perf_counter() - t0
                train_counts = read()
        finally:
            for name, fn in originals.items():
                setattr(Runner, name, fn)
        cfg = get_cfg()
        B = int(cfg.dataset.train.batch_size)
        steps = RUNNER_OVERRIDES["max_epoch"] * len(run.train_loader)
        val_batches = len(run.val_loader)
        print(f"train: {train_wall:.2f} s for {steps} steps at batch {B} x "
              f"{cfg.dataset.train.npoints}, launches {train_counts}")
        want = dict(fused_trunk_train_fwd=steps, fused_trunk_train_bwd=steps,
                    fused_core=100 * val_batches)
        if any(train_counts[k] != v for k, v in want.items()) or train_counts["emd_hybrid"] == 0:
            fail(f"the runner's training run launched {train_counts}: expected {want} and "
                 "EMD launches in its val")
        recs = [json.loads(line) for line in open(os.path.join(run.work_dir, "scalars.jsonl"))]
        losses = [r for r in recs if "total_loss" in r]
        if len(losses) != steps or not all(np.isfinite(r["total_loss"]) for r in losses):
            fail(f"logged training losses {[r.get('total_loss') for r in losses]}")
        if any(r["skipped_nonfinite"] != 0 for r in losses):
            fail("a training step was skipped as non-finite")
        print("total_loss by step: " + ", ".join(f"{r['total_loss']:.4f}" for r in losses))
        table = run.train_loader.dataset.noises
        width = run.model.encoder_mod.noise_dim
        if sorted(table) != list(range(len(run.train_loader.dataset))) or not all(
                v.shape == (width,) and np.isfinite(v).all() for v in table.values()):
            fail(f"the CIMLE table holds {len(table)} entries, not one finite noise of width "
                 f"{width} for each of the {len(run.train_loader.dataset)} training shapes")
        val_metrics = [r for r in recs if any(k.endswith("1-NN-CD-acc") for k in r)]
        if len(val_metrics) != 1 or not all(np.isfinite(v) for k, v in val_metrics[0].items()
                                            if "/" in k):
            fail(f"val logged {val_metrics}")
        ckpts = sorted(os.listdir(os.path.join(run.work_dir, "checkpoints")))
        if ckpts != ["ckpt_2.meta.json", "ckpt_2.pt", "ckpt_3.meta.json", "ckpt_3.pt"]:
            fail(f"checkpoints written: {ckpts}")

        # A second runner on the same work_dir resumes at epoch 3, bit for bit.
        zero()
        again = Runner(cfg=cfg, device=dev)
        if again.epoch != 3 or again.state.step != steps:
            fail(f"the second runner resumed at epoch {again.epoch}, step {again.state.step}")
        want_state, got_state = runner_state(run), runner_state(again)
        differ = [k for k in want_state if not torch.equal(want_state[k], got_state[k])]
        if differ or want_state.keys() != got_state.keys():
            fail(f"the resumed runner differs from the one that saved: {differ[:5]}")
        if sorted(again.train_loader.dataset.noises) != sorted(table):
            fail("the resumed runner lost the CIMLE table")
        print(f"resume: epoch {again.epoch}, step {again.state.step}, {len(want_state)} tensors "
              "equal bit for bit")
        del want_state, got_state
        against_cpu = runner_step_against_cpu(again, cfg)

        # Later epochs of the resumed runner at the configuration's own log
        # interval (the host reads the metrics, and so waits for the card,
        # once every that many steps): one to warm up, RUNNER_TIMED_EPOCHS
        # timed one by one (each ends on a synchronize), one traced
        # (device_busy), one for the device operations and the waits a step;
        # then LOADER_PASSES passes of the loader alone (collation and the
        # copies to the card).
        log_every = again.log_interval = Config(os.path.join(ROOT, RUNNER_CONFIG)).log_interval

        def epoch():
            again.train_loader.set_epoch(again.epoch)
            again.train()

        epoch()
        later = []
        for _ in range(RUNNER_TIMED_EPOCHS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            epoch()
            torch.cuda.synchronize()
            later.append(time.perf_counter() - t0)
        wall, busy = device_busy(epoch)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")  # each call that waits for the card warns
                try:
                    epoch()
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
        n_steps = len(again.train_loader)
        ops = sum(e.device_type == DeviceType.CUDA for e in prof.events()) / n_steps
        waits = [w for w in caught if "synchroniz" in str(w.message)]
        syncs = len(waits) / n_steps
        sites = sorted({f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}" for w in waits})
        loads = []
        for _ in range(LOADER_PASSES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b in again.train_loader:
                device_batch(b, dev, again._slim_train)
            torch.cuda.synchronize()
            loads.append(time.perf_counter() - t0)
        print(f"{RUNNER_TIMED_EPOCHS} later epochs of {n_steps} steps at log_interval "
              f"{again.log_interval}: median {np.median(later):.4f} s, min {min(later):.4f}, max "
              f"{max(later):.4f} (each {[round(t, 4) for t in later]}); one more: {wall:.1f} ms "
              f"wall, device busy {busy:.1f} ms, idle {100 * (1 - busy / wall):.1f}%; {ops:.0f} "
              f"device operations and {syncs:.1f} waits for the card a step (at {sites}); the "
              f"loader alone, {LOADER_PASSES} passes: {[round(1e3 * t, 1) for t in loads]} ms")
        del again

        zero()
        t0 = time.perf_counter()
        with recorder:
            metrics = cli_main(argv + ["--task", "val_gen", "--gen_num", str(RUNNER_GEN_NUM)])
            torch.cuda.synchronize()
        val_gen_s = time.perf_counter() - t0
        gen_counts = read()
        print(f"val_gen --gen_num {RUNNER_GEN_NUM}: {val_gen_s:.2f} s (runner built), "
              f"launches {gen_counts}")
        if len(metrics) != 12 or not all(np.isfinite(v) for v in metrics.values()):
            fail(f"val_gen gave {metrics}")
        gen_batches = -(-RUNNER_GEN_NUM // 128)
        if gen_counts["fused_core"] != 100 * gen_batches or gen_counts["emd_hybrid"] == 0:
            fail(f"val_gen launched {gen_counts}: expected {100 * gen_batches} trunk launches "
                 "and EMD launches")
        checkpoint = shutil.copy(os.path.join(run.work_dir, "checkpoints", "ckpt_3.pt"), keep)
        shutil.copy(os.path.join(run.work_dir, "checkpoints", "ckpt_3.meta.json"), keep)
        del run

    # What the trunk and the training trunk computed on the main path, held
    # against their plain versions: the launches of val (batch 32) and of
    # val_gen (batch 64), and the first training step's forward and backward.
    # (The peak memory is the path's: read before, and reset after, the holds.)
    peak = torch.cuda.max_memory_allocated() / 2**30
    core_err = recorder.hold_core("phase 9")
    train_fwd_err, train_bwd_err = recorder.hold_train("phase 9")
    del recorder
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # The cropping loader: ShapeNet-55's training crop at 8192 points. Each
    # FPS call is recorded, to hold its indices against the plain version.
    loader, _ = SyntheticPart(batch_size=CROP_BATCH, npoints=CROP_POINTS, size=CROP_SHAPES)
    crop = CroppingDataLoader(loader, crop=CROP_RANGE, seed=0, device=dev)
    calls = []
    real_fps = points.fps

    def recording_fps(data, number, ret_id=False):
        out, idx = real_fps(data, number, ret_id=True)
        calls.append((data.clone(), idx))
        return (out, idx) if ret_id else out

    points.fps = recording_fps
    try:
        zero()
        t0 = time.perf_counter()
        batches = list(crop)
        torch.cuda.synchronize()
        crop_s = time.perf_counter() - t0
        crop_counts = read()
    finally:
        points.fps = real_fps
    if crop_counts["fps"] != 2 * len(batches) or len(batches) != CROP_SHAPES // CROP_BATCH:
        fail(f"{len(batches)} cropping batches launched {crop_counts}: expected 2 FPS each")
    for b in batches:
        inp = torch.as_tensor(b["input"], device=dev)
        for key in ("partial", "missing"):
            half = b[key]
            if tuple(half.shape) != (CROP_BATCH, 2048, 3):
                fail(f"{key} has shape {tuple(half.shape)}")
            near = torch.cdist(half, inp, compute_mode="donot_use_mm_for_euclid_dist")
            if near.min(-1).values.max().item() != 0.0:
                fail(f"a {key} point is not a point of its input cloud")
    fps_diff = 0
    for data, idx in calls:
        plain = furthest_point_sample_reference(data, 2048)
        fps_diff = max(fps_diff, int((plain != idx).sum().item()))
    if fps_diff:
        fail(f"FPS in the cropping loader differs from the plain version at {fps_diff} indices")
    print(f"cropping loader: {len(batches)} batches of {CROP_BATCH} x {CROP_POINTS}, crop "
          f"{CROP_RANGE}, {crop_s:.2f} s, launches {crop_counts}; {len(calls)} FPS calls equal "
          "the plain version index for index")

    launches = {k: train_counts[k] + gen_counts[k] + crop_counts[k] for k in train_counts}
    peak = max(peak, torch.cuda.max_memory_allocated() / 2**30)
    median = float(np.median(later))
    result = dict(
        launches=launches, core_err=core_err, train_fwd_err=train_fwd_err,
        train_bwd_err=train_bwd_err, epoch_s_first=times["train"][0], epoch_s_later=median,
        epoch_s_later_min=min(later), epoch_s_later_max=max(later),
        shapes_per_s=B * n_steps / median, cache_noise_s=times["cache_noise"],
        val_s=times["val"], val_gen_s=val_gen_s, idle_share=1 - busy / wall,
        later_epoch_ms=wall, device_busy_ms=busy, device_ops_per_step=ops,
        syncs_per_step=syncs, loader_epoch_s=float(np.median(loads)), loader_epoch_s_each=loads,
        peak_gib=peak, crop_s=crop_s, against_cpu=against_cpu, checkpoint=checkpoint,
    )
    print(f"seconds per epoch: first {times['train'][0]:.3f} (log_interval 1), later median "
          f"{median:.4f} over {RUNNER_TIMED_EPOCHS} (log_interval {log_every}, the "
          f"configuration's); training {result['shapes_per_s']:.1f} shapes/s at batch {B} from "
          "that median (host clock, each epoch synchronized)")
    print(f"cache_noise {times['cache_noise']} s, val {times['val']} s, val_gen {val_gen_s:.2f} s, "
          f"peak {peak:.2f} GiB; launches over phase 9 {launches}")
    print(f"phase 9: {time.perf_counter() - t_phase:.1f} s")
    return result


# Phase 10: reconstruction and editing at gen_chair's widths, on weights
# loaded from a reference-layout .pth. The val batch is 32 shapes of 2048
# points; K = cimle_sample_num (1 in gen_chair) noise candidates a shape.
EDIT_CONFIG = os.path.join("configs", "gen_chair.py")
EDIT_BATCH, EDIT_POINTS, EDIT_STEPS, EDIT_SEARCH, EDIT_VARIANTS = 32, 2048, 100, 100, 10
EDIT_GRAD_BATCH = 4
# One shape_edit step's z-gradient, float32 models on the card and on the CPU
# from the same .pth (the gradient runs through PointNet and the aligner, not
# the denoiser), TF32 off: sums in another order only, so the gradients agree
# far below a relative L2 of 1e-3; a wrong kernel path or layout gives O(1).
EDIT_GRAD_REL_L2 = 1e-3
EDIT_EMD_PAIRS = 4  # pairs of the recorded EMD launch held against the plain version


def write_editing_config(work, pth):
    """A config under ``work`` whose ``_base_`` is EDIT_CONFIG by its absolute
    path: SyntheticPart (batch 32 x 2048; gen_chair's ShapeNet is absent) and
    ``resume_path`` the reference-layout .pth. Returns (path, keys set)."""
    ds = dict(type="SyntheticPart", batch_size=EDIT_BATCH, size=EDIT_BATCH, npoints=EDIT_POINTS)
    keys = dict(work_dir=os.path.join(work, "gen_chair_editing"), resume_path=pth,
                dataset=dict(_cover_=True, train=dict(ds, split="train", eval_mode="gen"),
                             val=dict(ds, split="test", shuffle=False, eval_mode="ae")))
    path = os.path.join(work, "gen_chair_editing.py")
    with open(path, "w") as f:
        f.write(f"_base_ = [{os.path.join(ROOT, EDIT_CONFIG)!r}]\n")
        f.write("".join(f"{k} = {v!r}\n" for k, v in keys.items()))
    return path, keys


def hold_editing_launches(recorder):
    """Fail unless the kernels phase 10 launched agree with their plain
    versions. The trunk: each kept launch by hold_bf16. The EMD assignment:
    its first launch's matched cost on its first EDIT_EMD_PAIRS pairs within
    EMD_COST_RTOL. The FF: at each (T, D) the paths gave it, the kernel on
    ff_operands (|4|-scale, where KERNEL_MAX_ABS and KERNEL_MEAN_ABS are set)
    by hold_bf16; the path's own launch is compared and reported beside its
    FF branch, but not held: the two-attention aligner's residual stream
    reaches the hundreds, where one bf16 step (1.0 at 200) is larger than the
    FF branch the kernel adds. Returns the largest differences by kernel
    name and what the path's FF launches showed."""
    from difffacto_torch.ops import fused_ff as ff

    errs = dict(fused_core=recorder.hold_core("phase 10"), fused_ff=0.0)
    ff_path = []
    for (T, D), (args, _, out) in recorder.launches("fused_ln_geglu_ff", "phase 10"):
        ops = ff_operands(D, T, out.device, seed=T)
        with torch.inference_mode():
            got = ff.fused_ln_geglu_ff(*ops)
            errs["fused_ff"] = max(errs["fused_ff"], hold_bf16(
                f"fused_ff at phase 10's T={T} D={D} on |4|-scale operands", got,
                ff.fused_ln_geglu_ff_reference(*ops)))
            want = ff.fused_ln_geglu_ff_reference(*args).float()
            err = (out.float() - want).abs()
            seen = dict(tokens=T, max_abs_err=err.max().item(), mean_abs_err=err.mean().item(),
                        mean_abs_ff_branch=(want - args[0].float()).abs().mean().item(),
                        max_abs_out=want.abs().max().item())
        print(f"fused_ff as phase 10 launched it, T={T} D={D} (reported, not held): max abs err "
              f"{seen['max_abs_err']:.4e}, mean {seen['mean_abs_err']:.4e}; mean |FF branch| "
              f"{seen['mean_abs_ff_branch']:.4e}, largest |output| {seen['max_abs_out']:.4g}")
        if not torch.isfinite(out.float()).all():
            fail(f"fused_ff as phase 10 launched it at T={T} gave non-finite values")
        ff_path.append(seen)
    errs["emd_hybrid"] = hold_emd(recorder, "phase 10")
    return errs, ff_path


def hold_emd(recorder, label):
    """Fail unless the first recorded EMD launch's matched cost on its first
    EDIT_EMD_PAIRS pairs is within EMD_COST_RTOL of its plain version's;
    returns the share of differing indices."""
    from difffacto_torch.ops import emd_hybrid as eh

    (_, n), (args, kw, got) = recorder.launches("emd_assignment_hybrid", label)[0]
    pairs = args[0].shape[0]
    a, b, got = args[0][:EDIT_EMD_PAIRS], args[1][:EDIT_EMD_PAIRS], got[:EDIT_EMD_PAIRS]
    with torch.inference_mode():
        want = eh.emd_assignment_hybrid_reference(a, b, **kw)
    cg, cw = matched_cost(a, b, got), matched_cost(a, b, want)
    rel = ((cg - cw).abs() / cw).max().item()
    share = (got != want).float().mean().item()
    print(f"emd_hybrid as {label} launched it, first {EDIT_EMD_PAIRS} of {pairs} pairs at "
          f"n={n}: matched cost off by {rel:.3e} (tol {EMD_COST_RTOL}), share of differing "
          f"indices {share:.6f}")
    if not rel <= EMD_COST_RTOL:
        fail(f"the EMD launch of {label} disagrees with its plain version")
    return share


def editing_phase(dev, fc, fct, fpsm, eh, ff, fb):
    """Phase 10: reconstruction and editing at gen_chair's widths. Returns
    the launches of each kernel over the phase, the first launches'
    differences and each path's wall time and idle share."""
    import tempfile

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import reference_layout_torch as ref

    from difffacto_torch import MODELS, build_from_cfg
    from difffacto_torch.config import get_cfg, init_cfg
    from difffacto_torch.models import denoiser, reconstruct
    from difffacto_torch.nn import layers
    from difffacto_torch.runner import Runner
    from difffacto_torch.runner import editing
    from difffacto_torch.runner.cli import main as cli_main
    from difffacto_torch.runner.runner import device_batch
    from difffacto_torch.utils.torch_ingest import load_reference_checkpoint

    t_phase = time.perf_counter()
    counters = ("fused_core", "fused_trunk_train_fwd", "fused_trunk_train_bwd", "fps",
                "emd_hybrid", "fused_ff", "fused_block")
    total = {k: 0 for k in counters}
    paths = {}

    def drive(name, fn, expect, idle=True):
        """Run fn with every count set to 0 just before and read just after;
        fail unless the counts are ``expect`` (a value, or a predicate); then
        time it again with device_busy for the idle share."""
        zero_launches(*counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernel_launches(*counters)
        for k, v in counts.items():
            total[k] += v
        bad = {k: (counts[k], want) for k, want in expect.items()
               if not (want(counts[k]) if callable(want) else counts[k] == want)}
        if bad:
            fail(f"phase 10 {name}: launches {counts}, not as expected {bad}")
        paths[name] = dict(s=wall, launches={k: v for k, v in counts.items() if v})
        if idle:
            w, busy = device_busy(fn)
            paths[name].update(idle_share=1 - busy / w, wall_ms=w, busy_ms=busy)
        p = paths[name]
        print(f"{name}: {wall:.2f} s, launches {p['launches']}"
              + (f", idle {100 * p['idle_share']:.1f}% ({p['busy_ms']:.1f} ms busy of "
                 f"{p['wall_ms']:.1f} ms, a second run)" if idle else ""))
        return out

    def finite(name, arrays):
        for k, v in arrays.items():
            if isinstance(v, np.ndarray) and not np.isfinite(v).all():
                fail(f"phase 10 {name}: {k} is not finite")

    recorder = KernelRecorder((denoiser, "fused_core"), (layers, "fused_ln_geglu_ff"),
                              (eh, "emd_assignment_hybrid"))
    with tempfile.TemporaryDirectory() as work, recorder:
        # The reference's layout at full width: PointNetV2 with grouped
        # per-part heads, the 5-block aligner, 4 x 14 flows, the 5-block
        # denoiser; written as the reference saves it, read by Runner.load.
        t0 = time.perf_counter()
        pth = os.path.join(work, "gen_chair_reference_layout.pth")
        ref.save_pth(ref.build_modules(seed=0), pth)
        cfg_file, keys = write_editing_config(work, pth)
        init_cfg(cfg_file)
        cfg = get_cfg()
        runner = Runner(cfg=cfg, device=dev)
        model = runner.model
        print(f"{EDIT_CONFIG} with {sorted(keys)} set: the reference-layout .pth written and "
              f"loaded through Runner.load in {time.perf_counter() - t0:.1f} s "
              f"({os.path.getsize(pth) / 2**20:.1f} MiB)")
        T = model.num_timesteps
        batch = device_batch(next(iter(runner.val_loader)), dev, runner._slim_val)
        B = batch["ref"].shape[0]
        gen = torch.Generator(device=dev).manual_seed(10)

        # Reconstruction: the runner's val of a reconstruction model (the
        # loaded gen_chair with gen=False): cimle_sample_num candidates a
        # shape by select_best_noise, reconstruct, the ae protocol (paired
        # CD and EMD in world coordinates).
        model.gen = False
        metrics = drive("reconstruction val (batch 32, K = cimle_sample_num)", runner.val,
                        dict(fused_core=T, emd_hybrid=lambda n: n > 0), idle=False)
        model.gen = True
        print(f"reconstruction metrics: {metrics}")
        if sorted(metrics) != ["sample/MMD-CD", "sample/MMD-EMD"] or not all(
                np.isfinite(v) for v in metrics.values()):
            fail(f"the reconstruction val gave {metrics}")
        saved = np.load(os.path.join(cfg.work_dir, "val", "sample_0.npz"))
        finite("reconstruction", dict(saved))
        if saved["pred"].shape != (B, EDIT_POINTS, 3):
            fail(f"reconstruction pred {saved['pred'].shape}")
        traj = sorted(int(k[5:]) for k in saved.files if k.startswith("traj_"))
        if traj != list(range(0, T, model.ret_interval)):
            fail(f"reconstruction val kept the steps {traj}")
        noise = torch.randn(B, model.cimle_sample_num, 32, generator=gen, device=dev)
        drive("reconstruct (batch 32)", lambda: reconstruct(
            model, batch, noise=noise, generator=gen), dict(fused_core=T))

        # The CLI tasks, each through its own runner (the .pth loaded again).
        for task, key in (("mixing", "pred_sample_0"), ("interpolation", "interpolate sample 9")):
            out = drive(f"--task {task}", lambda: cli_main(
                ["--config-file", cfg_file, "--task", task, "--part_id", "1"]),
                dict(fused_core=T), idle=False)
            finite(task, out)
            if out[key].shape != (B, EDIT_POINTS, 3):
                fail(f"--task {task}: {key} has shape {out[key].shape}")
        drive("combine_latent (batch 32)", lambda: editing.combine_latent(
            model, batch, generator=gen), dict(fused_core=T))
        drive("interpolate_latent (batch 32 x 10 steps)", lambda: editing.interpolate_latent(
            model, batch, part_id=1, generator=gen), dict(fused_core=T))

        # One part resampled, the aligner searching EDIT_SEARCH noises for each
        # of 32 x EDIT_VARIANTS variants (32,000 rows of 4 part tokens).
        b = editing.ensure_attn_maps(batch)
        with torch.inference_mode():
            codes = model.encode_part_code(b["input"], b["attn_map"], False).float()
        one_part = dict(
            codes=codes.cpu().numpy(), valid_id=b["present"].float().cpu().numpy(),
            gt_mean=b["part_shift"].float().cpu().numpy(),
            gt_logvar=2 * np.log(np.clip(b["part_scale"].float().cpu().numpy(), 1e-3, None)),
            seg_mask=b["ref_seg_mask"].cpu().numpy(), part_id=1,
            sample_num_each=EDIT_VARIANTS, noise_search=EDIT_SEARCH)
        out = drive("sample_one_part (32 x 10 variants, search 100)",
                    lambda: editing.sample_one_part(model, **one_part, generator=gen),
                    dict(fused_core=T, fused_ff=0))
        finite("sample_one_part", out)
        kept = np.repeat(one_part["codes"][:, None, 0], EDIT_VARIANTS, 1)
        if out["pred"].shape != (B, EDIT_VARIANTS, EDIT_POINTS, 3) or not np.allclose(
                out["codes"][:, :, 0], kept, atol=1e-2):
            fail("sample_one_part changed a part it keeps, or its output's shape")

        target = np.zeros((B, 3), np.float32)
        target[:, 1] = 0.5
        out = drive("shape_edit (batch 32, 100 steps)", lambda: editing.shape_edit(
            model, batch, 1, edit_part_mean=target, steps=EDIT_STEPS, generator=gen),
            dict(fused_core=T))
        finite("shape_edit", out)
        edit_loss = out["loss"]

        # The aligner as shipped takes no kernel (single attention, no context:
        # BasicTransformerBlock's unfused math, in both packages). Its
        # two-attention form (single_attn=False, configs/_base_/anchordiff.py:30)
        # runs its FF through B7 at D = 256: the same search and edit with it.
        mcfg = cfg.model.dump()
        loaded = {k: v for k, v in model.state_dict().items()
                  if not k.startswith("encoder_mod.aligner.")}
        for noise_scale in (100, 1):
            two_cfg = dict(mcfg, dtype=torch.bfloat16)
            two_cfg["encoder"] = dict(mcfg["encoder"], part_aligner=dict(
                mcfg["encoder"]["part_aligner"], single_attn=False, noise_scale=noise_scale))
            two = build_from_cfg(two_cfg, MODELS, device=dev, seed=0)
            two.load_state_dict(loaded, strict=False)  # all but the aligner from the .pth
            depth = len(two.encoder_mod.aligner.blocks)
            out = drive(f"sample_one_part, two-attention aligner (noise_scale {noise_scale})",
                        lambda: editing.sample_one_part(two, **one_part, generator=gen),
                        dict(fused_core=T, fused_ff=depth))
            if np.isfinite(out["pred"]).all():
                break
            print(f"two-attention aligner: non-finite samples at noise_scale {noise_scale} with "
                  "seeded weights; lowering it to 1 as phase 8 does")
        else:
            fail("two-attention aligner: non-finite samples")
        finite("sample_one_part, two-attention aligner", out)
        # 100 steps under autograd take the unfused FF (no launch); the
        # decode's aligner call under inference_mode launches it.
        out = drive("shape_edit, two-attention aligner", lambda: editing.shape_edit(
            two, batch, 1, edit_part_mean=target, steps=EDIT_STEPS, generator=gen),
            dict(fused_core=T, fused_ff=depth))
        finite("shape_edit, two-attention aligner", out)
        del two, runner

        # One shape_edit step's z-gradient on the card against the CPU's, both
        # float32, from the same .pth.
        small = {k: v[:EDIT_GRAD_BATCH] for k, v in editing.ensure_attn_maps(batch).items()}
        z0 = torch.randn(EDIT_GRAD_BATCH, 32, generator=torch.Generator().manual_seed(11))
        grads = []
        for where in (dev, torch.device("cpu")):
            m = build_from_cfg(dict(mcfg), MODELS, device=where, seed=0)
            load_reference_checkpoint(pth, m)
            bt = {k: v.to(where) for k, v in small.items()}
            fix = torch.ones(EDIT_GRAD_BATCH, 4, device=where)
            fix[:, 1] = 0
            t0 = time.perf_counter()
            loss, g = editing.edit_loss_and_grad(
                m, z0.to(where), bt["input"], bt["attn_map"], bt["present"].float(),
                bt["part_shift"].float(), bt["part_scale"].float() ** 2, fix, 1,
                torch.as_tensor(target[:EDIT_GRAD_BATCH], device=where))
            grads.append((float(loss), g.float().cpu()))
            print(f"shape_edit z-gradient on {where.type} (float32, batch {EDIT_GRAD_BATCH}): "
                  f"loss {float(loss):.6f}, {time.perf_counter() - t0:.2f} s")
        (lc, gc), (lh, gh) = grads
        grad_rel = ((gc - gh).norm() / gh.norm()).item()
        print(f"shape_edit z-gradient, card against CPU: relative L2 {grad_rel:.3e} (tol "
              f"{EDIT_GRAD_REL_L2}), loss {lc:.6f} vs {lh:.6f}")
        if not np.isfinite(lc) or not grad_rel <= EDIT_GRAD_REL_L2:
            fail("the shape_edit z-gradient on the card disagrees with the CPU's")
    errs, ff_path = hold_editing_launches(recorder)
    # The FF at the search's size (128,000 tokens at D = 256), far past the
    # T = 1024 of phase 8: its launch as recorded, timed with its plain version
    # and its bound.
    ff_args, _, ff_out = recorder.launches("fused_ln_geglu_ff", "phase 10")[-1][1]
    search_ff = dict(tokens=ff_args[0].shape[0],
                     ms=cuda_ms(lambda: ff.fused_ln_geglu_ff(*ff_args), 20),
                     plain_ms=cuda_ms(lambda: ff.fused_ln_geglu_ff_reference(*ff_args), 3))
    search_ff["bound_ms"], search_ff["bound_by"] = ff_bound_ms(
        ff_args, ff_out.numel() * ff_out.element_size())
    print(f"fused_ff at T={search_ff['tokens']} D=256 (the search's launch): "
          f"{search_ff['ms']:.4f} ms, plain {search_ff['plain_ms']:.3f} ms, bound "
          f"{search_ff['bound_ms']:.4f} ms ({search_ff['bound_by']})")
    del recorder, ff_args, ff_out
    torch.cuda.empty_cache()
    print(f"launches over phase 10 {total}; phase 10: {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=total, errs=errs, paths=paths, edit_loss=edit_loss, grad_rel=grad_rel,
                search_ff=search_ff, ff_path=ff_path)


# Phase 11: the chain's variants on gen_chair at full width. DDIM as every
# generation config sets it (configs/_base_/anchordiff.py:83-86): 25 quad
# steps of T = 100, eta 1; a learned_range variance (proj_out 128 x 6) with
# guidance at weight 2, which calls the denoiser twice a step; a denoiser that
# adds t to x, whose trunk is the kernel's head-less entry.
DDIM = dict(ddim_sampling=True, ddim_nsteps=25, ddim_discretize="quad", ddim_eta=1.0)
GUIDED = dict(model_var_type="learned_range", guidance=True, classifier_weight=2.0)


def write_scorer_config(work):
    """A config under ``work`` whose ``_base_`` is RUNNER_CONFIG, as phase 9's
    is, with its own work_dir: what the checkpoint-curve scorer reads."""
    path = os.path.join(work, "bench_train_scorer.py")
    with open(path, "w") as f:
        f.write(f"_base_ = [{os.path.join(ROOT, RUNNER_CONFIG)!r}]\n")
        f.write(f"work_dir = {os.path.join(work, 'scorer')!r}\n")
    return path


def chain_phase(dev, fc, eh, noise_scale, checkpoint):
    """Phase 11: DDIM-25 generation (launches, shapes/s, idle share, a batch-1
    run against the CPU), learned_range with guidance (launches, finite,
    seconds), add_t_to_x generation (head-less launches, its first launch
    held, the entry timed beside its plain version and bound), and the
    checkpoint-curve scorer with --ddim 25 on phase 9's checkpoint."""
    import runpy
    import tempfile

    from difffacto_torch import sample_generation
    from difffacto_torch.models import denoiser

    t_phase = time.perf_counter()
    res = {}

    def generate(model, B, seed):
        return sample_generation(model, B, valid_id=torch.ones(B, 4, device=dev),
                                 generator=torch.Generator(device=dev).manual_seed(seed))["pred"]

    def counted(model, seed):
        zero_launches("fused_core", "fused_core_headless")
        t0 = time.perf_counter()
        pred = generate(model, BATCH_TIMED, seed)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if tuple(pred.shape) != (BATCH_TIMED, 2048, 3) or not torch.isfinite(pred).all():
            fail(f"phase 11 generated {tuple(pred.shape)}, finite: "
                 f"{bool(torch.isfinite(pred).all())}")
        return seconds, kernel_launches("fused_core", "fused_core_headless")

    # DDIM-25, quad, eta 1
    model = build_model(noise_scale, dev, diffusion=DDIM)
    steps = len(model.diff.steps)
    _, counts = counted(model, 3)
    print(f"DDIM {steps} quad steps (t = {model.diff.steps[::-1].tolist()}), batch "
          f"{BATCH_TIMED}: launches {counts}")
    if counts != dict(fused_core=25, fused_core_headless=0):
        fail(f"a DDIM-25 generation launched {counts}, not 25 trunk launches")
    t0 = time.perf_counter()
    for i in range(ITERS):
        generate(model, BATCH_TIMED, 4 + i)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / ITERS
    wall, busy = device_busy(lambda: generate(model, BATCH_TIMED, 9))
    res.update(ddim25_launches=counts["fused_core"], ddim25_s=dt,
               ddim25_shapes_per_s=BATCH_TIMED / dt, ddim25_idle_share=1 - busy / wall)
    print(f"DDIM-25 gen_chair batch {BATCH_TIMED}: {BATCH_TIMED / dt:.2f} shapes/s ({dt:.3f} s a "
          f"batch over {ITERS} runs, host clock); one more: {wall:.1f} ms wall, device busy "
          f"{busy:.1f} ms, idle {100 * (1 - busy / wall):.1f}%")
    rng = np.random.RandomState(11)
    draws = dict(z=rng.randn(1, 4, 256), cimle_noise=rng.randn(1, 32),
                 noise=rng.randn(1, 2048, 3), step_noise=rng.randn(steps, 1, 2048, 3))
    runs = {}
    for label, where, m in (("card", dev, model),
                            ("cpu", "cpu", build_model(noise_scale, "cpu", diffusion=DDIM))):
        d = {k: torch.as_tensor(v, dtype=torch.float32, device=where) for k, v in draws.items()}
        runs[label] = sample_generation(
            m, 1, valid_id=torch.as_tensor([[1, 1, 0, 1]], dtype=torch.float32, device=where),
            **d)["pred"].float().cpu()
    rel = ((runs["card"] - runs["cpu"]).norm() / runs["cpu"].norm()).item()
    print(f"batch-1 DDIM-25 generation, card vs CPU plain trunk, every draw injected: relative "
          f"L2 {rel:.4e} (tol {E2E_REL_L2})")
    if not torch.isfinite(runs["card"]).all() or not rel <= E2E_REL_L2:
        fail("DDIM generation on the card disagrees with the CPU")
    res["ddim25_card_vs_cpu_rel_l2"] = rel
    del model

    # learned_range with guidance: two trunk launches a step, one on a zero context
    model = build_model(noise_scale, dev, diffusion=GUIDED, net=dict(out_channels=6))
    seconds, counts = counted(model, 5)
    print(f"learned_range + guidance (weight 2), batch {BATCH_TIMED}: {seconds:.3f} s "
          f"({BATCH_TIMED / seconds:.2f} shapes/s, host clock), launches {counts}")
    if counts != dict(fused_core=200, fused_core_headless=0):
        fail(f"a guided generation launched {counts}, not 200 trunk launches")
    res.update(guided_launches=counts["fused_core"], guided_s=seconds,
               guided_shapes_per_s=BATCH_TIMED / seconds)
    del model

    # add_t_to_x: h0 + t-embedding through the head-less entry
    model = build_model(noise_scale, dev, net=dict(add_t_to_x=True))
    recorder = KernelRecorder((denoiser, "fused_core_headless"))
    with recorder:
        seconds, counts = counted(model, 6)
    print(f"add_t_to_x, batch {BATCH_TIMED}: {seconds:.3f} s, launches {counts}")
    if counts != dict(fused_core=0, fused_core_headless=100):
        fail(f"an add_t_to_x generation launched {counts}, not 100 head-less launches")
    (B, N), (args, _, got) = recorder.launches("fused_core_headless", "phase 11")[0]
    with torch.inference_mode():
        want = fc.fused_core_reference(args[0], None, None, *args[1:])
    err = hold_bf16(f"fused_core_headless as add_t_to_x launched it, B={B} N={N}", got, want)
    res.update(headless_launches=counts["fused_core_headless"], headless_err=err,
               add_t_to_x_s=seconds)
    del model, recorder, args, got, want

    ops = fc.operands(fc.example_inputs(BATCH_TIMED, 2048, depth=5, in_ch=fc.D, seed=8), dev,
                      torch.bfloat16)
    hl = [ops[0]] + ops[3:]
    bound, by = trunk_bound_ms(hl, BATCH_TIMED * 2048 * fc.D * 2, in_ch=0, depth=5)
    with uncounted("fused_core_headless"):
        ms = cuda_ms(lambda: fc.fused_core_headless(*hl, 0.25), 20)
    plain_ms = cuda_ms(lambda: fc.fused_core_reference(hl[0], None, None, *hl[1:], 0.25), 3)
    res.update(headless_ms=ms, headless_plain_ms=plain_ms, headless_bound_ms=bound,
               headless_bound_by=by)
    print(f"fused_core_headless B={BATCH_TIMED} N=2048: {ms:.3f} ms, bound {bound:.3f} ms ({by}), "
          f"{100 * bound / ms:.1f}% of roofline; plain version {plain_ms:.3f} ms")
    del ops, hl
    torch.cuda.empty_cache()

    # The checkpoint-curve scorer, DDIM-25, on phase 9's final checkpoint
    tool = runpy.run_path(os.path.join(ROOT, "tools", "eval_ckpt_curve_torch.py"),
                          run_name="imported")
    with tempfile.TemporaryDirectory() as work:
        zero_launches("fused_core", "emd_hybrid")
        t0 = time.perf_counter()
        rows = tool["main"](["--config-file", write_scorer_config(work), "--ckpts", checkpoint,
                             "--ddim", "25", "--gen_num", str(RUNNER_GEN_NUM)])
        torch.cuda.synchronize()
        scorer_s = time.perf_counter() - t0
    scorer_launches = kernel_launches("fused_core", "emd_hybrid")
    metrics = {k: v for k, v in rows[0].items() if k not in ("ckpt", "epoch", "steps", "eval_s")}
    print(f"eval_ckpt_curve_torch.py --ddim 25 on {os.path.basename(checkpoint)}: "
          f"{scorer_s:.2f} s with the runner's build, launches fused_core "
          f"{scorer_launches['fused_core']}, emd_hybrid {scorer_launches['emd_hybrid']}")
    if (len(rows) != 1 or rows[0]["steps"] != 25 or len(metrics) != 12
            or not all(np.isfinite(v) for v in metrics.values())):
        fail(f"the scorer gave {rows}")
    if (scorer_launches["fused_core"] != 25 * -(-RUNNER_GEN_NUM // 128)
            or scorer_launches["emd_hybrid"] == 0):
        fail(f"the scorer launched the trunk {scorer_launches['fused_core']} times and EMD "
             f"{scorer_launches['emd_hybrid']}")
    res.update(scorer_s=scorer_s, scorer_row=rows[0])
    print(f"phase 11: {time.perf_counter() - t_phase:.1f} s")
    return res


# Phase 12: the JAX package's checkpoints, two-attention and UNet training and
# per-part pretraining. (a) Phase 9's final checkpoint, exported to the JAX
# layout and written as .msgpack, resumes a fresh runner bit for bit equal to
# the .pt resume; val_gen --gen_num 64 from both (one batch: 100 trunk
# launches, 4 EMD launches). (b, c) TRAIN12_STEPS steps of gen_chair with
# two-attention blocks and with the UNet denoiser (phase 8's widths; its
# part tokens the model's own, 262 wide), float32 as the Runner builds it,
# at batch TRAIN12_BATCH x 2048 on one batch with every draw injected and
# dropout 0: finite, the last loss below the first, no fused FF or
# one-block launch under autograd, one step at TRAIN12_CHECK_BATCH against the
# CPU at phase 9's tolerances (float32 both: BatchNorm over 4 shapes turns no
# bf16 rounding into a change of the fit loss, as it would in phase 7). (d) --runner pretrain through the CLI on
# bench_train_tpu with PointwiseNet at its defaults: one epoch and val, no
# kernel launch.
TRAIN12_BATCH, TRAIN12_STEPS, TRAIN12_CHECK_BATCH, PRETRAIN_PTS = 32, 3, 4, 512
UNET_NET = dict(type="UNet", in_channels=3, n_heads=8, d_head=16, depth=5, embed_dim=128,
                prior_dim=262)


def write_config(work, name, **keys):
    """A config file under ``work`` whose ``_base_`` is RUNNER_CONFIG (by its
    absolute path) and that sets ``keys``."""
    path = os.path.join(work, f"{name}.py")
    with open(path, "w") as f:
        f.write(f"_base_ = [{os.path.join(ROOT, RUNNER_CONFIG)!r}]\n")
        f.write("".join(f"{k} = {v!r}\n" for k, v in keys.items()))
    return path


def msgpack_round_trip(dev, zero, read, checkpoint, work):
    """Phase 12 (a): returns its numbers."""
    from difffacto_torch.config import Config
    from difffacto_torch.runner import Runner
    from difffacto_torch.utils.jax_checkpoint import write_jax_checkpoint
    from difffacto_torch.utils.jax_params import export_jax_train_state

    def build(name, resume):
        cfg = Config(write_config(work, name, **dict(RUNNER_OVERRIDES, resume_path=resume,
                                                     work_dir=os.path.join(work, name))))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = Runner(cfg=cfg, device=dev)
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    r_pt, pt_build_s = build("from_pt", checkpoint)
    with open(checkpoint[: -len(".pt")] + ".meta.json") as f:
        meta = json.load(f)
    t0 = time.perf_counter()
    tree = export_jax_train_state(r_pt.state, r_pt.tx)
    path = write_jax_checkpoint(os.path.join(work, "export"), meta.pop("epoch"), tree, meta)
    export_s = time.perf_counter() - t0
    r_mp, mp_build_s = build("from_msgpack", path)
    loads = {}
    for label, r, ckpt in (("pt", r_pt, checkpoint), ("msgpack", r_mp, path)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.load(ckpt)
        torch.cuda.synchronize()
        loads[label] = time.perf_counter() - t0
    a, b = runner_state(r_pt), runner_state(r_mp)
    differ = [k for k in a if k not in b or not torch.equal(a[k], b[k])]
    print(f"{checkpoint} -> {path} ({os.path.getsize(path) / 2**20:.1f} MiB, exported and written "
          f"in {export_s:.2f} s); runner built with resume_path .pt {pt_build_s:.2f} s, .msgpack "
          f"{mp_build_s:.2f} s; load alone .pt {loads['pt']:.3f} s, .msgpack "
          f"{loads['msgpack']:.3f} s; {len(a)} tensors, {len(differ)} differ")
    if differ or a.keys() != b.keys() or (r_pt.epoch, r_pt.iter) != (r_mp.epoch, r_mp.iter):
        fail(f"the .msgpack resume differs from the .pt resume: {differ[:5]}, epoch "
             f"{r_mp.epoch} vs {r_pt.epoch}")
    if r_mp.train_loader.dataset.noises:
        fail("a .msgpack resume brought a CIMLE table, which the JAX format does not hold")
    metrics, counts, secs = {}, {}, {}
    for label, r in (("pt", r_pt), ("msgpack", r_mp), ("pt again", r_pt)):
        if label == "pt again" and metrics["pt"] == metrics["msgpack"]:
            break
        zero()
        t0 = time.perf_counter()
        metrics[label] = r.generate_samples(num_gen=RUNNER_GEN_NUM)
        torch.cuda.synchronize()
        secs[label], counts[label] = time.perf_counter() - t0, read()
        want = dict({k: 0 for k in counts[label]}, fused_core=100, emd_hybrid=4)
        if counts[label] != want:
            fail(f"val_gen from the {label} resume launched {counts[label]}: expected 100 trunk "
                 "and 4 EMD launches, nothing else")
        if len(metrics[label]) != 12 or not all(np.isfinite(v) for v in metrics[label].values()):
            fail(f"val_gen from the {label} resume gave {metrics[label]}")
    equal = metrics["pt"] == metrics["msgpack"]
    if not equal:
        spread = {k: abs(metrics["pt"][k] - metrics["pt again"][k]) for k in metrics["pt"]}
        off = {k: abs(metrics["pt"][k] - metrics["msgpack"][k]) for k in metrics["pt"]}
        if any(off[k] > spread[k] for k in off):
            fail(f"val_gen from the .msgpack resume {metrics['msgpack']} lies outside the spread "
                 f"of two .pt runs {metrics['pt']}, {metrics['pt again']}")
    print(f"val_gen --gen_num {RUNNER_GEN_NUM}: .pt {secs['pt']:.2f} s, .msgpack "
          f"{secs['msgpack']:.2f} s, launches {counts['msgpack']}; metrics "
          f"{'equal' if equal else 'within the spread of two .pt runs'}: "
          + json.dumps({k: round(v, 5) for k, v in metrics["msgpack"].items()}))
    del r_pt, r_mp
    return dict(load_s=loads["msgpack"], load_pt_s=loads["pt"], build_s=mp_build_s,
                export_s=export_s, val_gen_s=secs["msgpack"], launches=counts["msgpack"],
                metrics_equal=equal)


def train_steps_against_cpu(dev, label, zero, read, launches=None, cvae=False, recorder=None,
                            **model_keys):
    """Phase 12 (b, c), phase 15 (a): TRAIN12_STEPS steps of the float32 model
    on one batch, then one step at TRAIN12_CHECK_BATCH on the card and on the
    CPU. The steps must launch ``launches`` a step (a dict of kernel counts)
    and nothing else; none where it is not given. ``cvae`` injects the
    cVAE encoder's posterior draw; ``recorder`` (a KernelRecorder) is entered
    for the steps."""
    from contextlib import nullcontext

    from difffacto_torch.parallel import init_train_state, make_train_step

    def batch(B, seed):
        rng = np.random.RandomState(seed)
        b = example_batch(B, 2048, seed=seed)
        b.update(diffusion_t=rng.randint(0, 100, (B,)).astype(np.int64),
                 diffusion_noise=rng.randn(B, 2048, 3).astype(np.float32),
                 noise=rng.randn(B, 32).astype(np.float32))
        if cvae:
            b["cvae_eps"] = rng.randn(B, 32).astype(np.float32)
        return b

    model = build_train_model(dev, dropout=0.0, dtype=None, **model_keys)
    tx = build_train_optimizer()
    step, state = make_train_step(model, tx), init_train_state(model, tx)
    data = to_device(batch(TRAIN12_BATCH, 30), dev)
    losses, times = [], []
    zero()
    with recorder or nullcontext():
        for i in range(TRAIN12_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, met = step(state, data, i, 0)
            losses.append(float(met["total_loss"]))
            times.append(1e3 * (time.perf_counter() - t0))
            if float(met["skipped_nonfinite"]):
                fail(f"{label}: step {i} was skipped as non-finite")
    counts = read()
    print(f"{label}, batch {TRAIN12_BATCH} x 2048: total_loss by step "
          f"{[round(v, 4) for v in losses]}, ms a step {[round(t, 1) for t in times]}, "
          f"launches {counts}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"{label}: the loss did not fall over {TRAIN12_STEPS} steps: {losses}")
    if launches is None and any(counts.values()):
        fail(f"{label} launched {counts} under autograd: these blocks train unfused")
    if launches is not None and counts != dict({k: 0 for k in counts}, **{
            k: TRAIN12_STEPS * v for k, v in launches.items()}):
        fail(f"{label} launched {counts}: expected {launches} a step and nothing else")
    del model, state, step, data
    torch.cuda.empty_cache()
    runs = {}
    small = batch(TRAIN12_CHECK_BATCH, 31)
    for label_, where in (("card", dev), ("cpu", "cpu")):
        m = build_train_model(where, dropout=0.0, dtype=None, **model_keys)
        tx = build_train_optimizer()
        before = [p.detach().clone() for p in m.parameters()]
        _, met = make_train_step(m, tx)(init_train_state(m, tx), to_device(small, where), 0, 0)
        runs[label_] = ({k: float(v) for k, v in met.items()},
                        [(p.detach() - b).float().cpu() for p, b in zip(m.parameters(), before)])
        del m
    (mc, uc), (mh, uh) = runs["card"], runs["cpu"]
    rel = max(abs(mc[k] - mh[k]) / max(abs(mh[k]), 1e-12) for k in mh
              if k not in ("grad_norm", "skipped_nonfinite", "kl_weight"))
    gn = abs(mc["grad_norm"] - mh["grad_norm"]) / mh["grad_norm"]
    upd = (torch.cat([(a - b).abs().flatten() for a, b in zip(uc, uh)]).mean()
           / torch.cat([b.abs().flatten() for b in uh]).mean()).item()
    print(f"{label}, one step at batch {TRAIN12_CHECK_BATCH}, card against CPU: loss dict off by "
          f"{rel:.3e} (tol {STEP_LOSS_RTOL}), grad_norm by {gn:.3e} (tol {STEP_GNORM_RTOL}), "
          f"updates by {upd:.4f} of the mean abs update (tol {RUNNER_UPDATE_REL})")
    if not rel <= STEP_LOSS_RTOL or not gn <= STEP_GNORM_RTOL or not upd <= RUNNER_UPDATE_REL:
        fail(f"{label}: the step on the card disagrees with the CPU")
    torch.cuda.empty_cache()
    return dict(losses=losses, step_ms=float(np.median(times[1:])), launches=counts,
                loss_rel=rel, grad_norm_rel=gn, update_rel=upd)


def pretrain_run(dev, zero, read, work):
    """Phase 12 (d): one epoch and val of --runner pretrain through the CLI."""
    from difffacto_torch.runner.cli import main as cli_main

    net = dict(_cover_=True, type="PointwiseNet", context_dim=256)
    keys = dict(max_epoch=1, eval_interval=1, checkpoint_interval=None, cimle_cache_interval=None,
                log_interval=1, pts_per_part=PRETRAIN_PTS, work_dir=os.path.join(work, "pretrain"),
                model=dict(diffusion=dict(learn_variance=False, net=net)))
    cfg = write_config(work, "pretrain", **keys)
    zero()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner = cli_main(["--config-file", cfg, "--runner", "pretrain", "--task", "train"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read()
    recs = [json.loads(line) for line in open(os.path.join(runner.work_dir, "scalars.jsonl"))]
    losses = [r["mse_loss"] for r in recs if "mse_loss" in r]
    samples = np.load(os.path.join(runner.work_dir, "val", "pretrain_samples_1.npz"))
    n_params = sum(p.numel() for p in runner.model.parameters())
    print(f"--runner pretrain: one epoch of {len(losses)} steps and val in {wall:.2f} s (runner "
          f"built), {len(runner.model.net_list)} PointwiseNets, {n_params} parameters, mse_loss "
          f"{[round(v, 4) for v in losses]}, samples {[samples[k].shape for k in samples]}, "
          f"launches {counts}")
    if type(runner).__name__ != "PretrainRunner" or runner.epoch != 1:
        fail(f"--runner pretrain ran {type(runner).__name__} to epoch {runner.epoch}")
    if not losses or not all(np.isfinite(losses)) or any(counts.values()):
        fail(f"--runner pretrain: losses {losses}, launches {counts}")
    if sorted(samples) != [f"part_{i}" for i in range(4)] or not all(
            samples[k].shape == (4, PRETRAIN_PTS, 3) and np.isfinite(samples[k]).all()
            for k in samples):
        fail("--runner pretrain's val wrote no finite (4, 512, 3) samples for each of 4 parts")
    return dict(s=wall, steps=len(losses), launches=counts)


def phase12(dev, fc, fct, fpsm, eh, ff, fb, checkpoint):
    """Phase 12: the JAX package's checkpoints, two-attention and UNet
    training, per-part pretraining; returns each part's numbers."""
    import tempfile

    t_phase = time.perf_counter()

    counted = ("fused_core", "fused_core_headless", "fused_trunk_train_fwd",
               "fused_trunk_train_bwd", "fps", "emd_hybrid", "fused_ff", "fused_block")

    def zero():
        zero_launches(*counted)

    def read():
        return kernel_launches(*counted)

    out = {}
    with tempfile.TemporaryDirectory() as work:
        out["msgpack"] = msgpack_round_trip(dev, zero, read, checkpoint, work)
        out["two_attn"] = train_steps_against_cpu(
            dev, "two-attention training", zero, read, aligner=dict(single_attn=False),
            net=dict(_gen_chair_net(), single_attn=False))
        out["unet"] = train_steps_against_cpu(dev, "UNet training", zero, read, net=UNET_NET)
        out["pretrain"] = pretrain_run(dev, zero, read, work)
    print(f"phase 12: {time.perf_counter() - t_phase:.1f} s")
    return out


def _gen_chair_net():
    from difffacto_torch import Config

    return Config(os.path.join(ROOT, "configs", "gen_chair.py")).model.dump()["diffusion"]["net"]


# Phase 14: the last runner families and PDM at gen_chair's widths (zdim 256,
# 4 parts, 2048 points, T = 100). GAN: --runner gan for one epoch and its val
# through the CLI. Language: --runner language --no_eval on
# SyntheticLanguagePart at 2048 points, LANG_BATCH triplets a step. Mixing:
# MixingRunner.mixing on one val batch of 32. PDM: PointNet2SSG(4, 256, 1) and
# PointwiseNet, PDM_STEPS steps and one predict at PDM_BATCH. Each path is
# held against the same path on the CPU on the same weights with every draw
# injected: the GAN's and the language runner's steps, each from the
# card's Adam state after its epoch, so that an update depends on the
# gradient's size; the mixing of MIX_CHECK shapes (the CPU's trunk given bf16
# operands, as the kernel takes them: within E2E_REL_L2); one PDM step at
# P14_CHECK_BATCH, its gradient norm held too, as Adam's first update is about
# lr * sign(g) whatever the gradient's size; and a PDM predict at MIX_CHECK
# shapes. The steps and the predict run in float32 with no inexact kernel on
# either side; their tolerances are about 20 times their readings on an H100
# (losses 9e-7 to 5.5e-6 relative, updates at most 6e-4 of the mean update,
# the predict 1.5e-7 relative L2).
P14_LOSS_RTOL, P14_UPDATE_REL, P14_GNORM_RTOL, P14_PREDICT_REL_L2 = 1e-4, 1e-2, 1e-3, 1e-4
P14_POINTS = 2048
# Keys a CPU rehearsal sets in the runners' configs to cut them to size
# (the model's, the datasets'); none on the card.
P14_MODEL, P14_DATA = {}, {}
LANG_BATCH, LANG_SIZE = 8, 16
MIX_CHECK = 2
PDM_BATCH, PDM_STEPS, P14_CHECK_BATCH = 32, 3, 4
PDM_CFG = dict(
    type="PDM", encoder=dict(type="PointNet2SSG", additioinal_dim=4, zdim=256, num_anchors=1),
    diffusion=dict(type="PointDiffusion", net=dict(type="PointwiseNet", context_dim=256),
                   beta_1=1e-4, beta_T=0.02, mode="linear"),
    sampler=dict(type="Uniform"), num_timesteps=100, npoints=P14_POINTS)
# PointNet++'s two samples a forward pass (points, samples), and the radii and
# neighbourhood sizes of each level's balls (``models/pointnet2.py``)
SA_FPS = ((P14_POINTS, 512), (512, 128))
SA_BALLS = {"PointNet2SSG": (((0.2, 64),), ((0.4, 64),)),
            "PointNet2MSG": (((0.1, 16), (0.2, 32), (0.4, 128)),
                             ((0.2, 32), (0.4, 64), (0.8, 128)))}


def only(**launches):
    """The launch counts of a path that launches ``launches`` and nothing else."""
    return dict({k: 0 for k in mg_counts()}, **launches)


def timed_methods(cls, names, times):
    """Wrap ``cls``'s methods ``names`` to add their synchronised wall time to
    ``times[name]``; returns the function that puts them back."""
    own = {n: cls.__dict__.get(n) for n in names}
    for n in names:
        fn = getattr(cls, n)

        def run(self, *a, _fn=fn, _n=n, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(self, *a, **k)
            torch.cuda.synchronize()
            times[_n] = times.get(_n, 0.0) + time.perf_counter() - t0
            return out
        setattr(cls, n, run)

    def restore():
        for n, fn in own.items():
            if fn is None:
                delattr(cls, n)
            else:
                setattr(cls, n, fn)
    return restore


def on_cpu(tree):
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: on_cpu(v) for k, v in tree.items()}
    return [on_cpu(v) for v in tree]


def hold_updates(label, card, cpu, gnorms=None):
    """(loss relative difference, updates' mean abs difference over the CPU's
    mean abs update[, gradient norm's relative difference]) of one float32
    step on each side; fails beyond phase 14's tolerances. ``card`` and
    ``cpu`` are (loss dict, updates), ``gnorms`` the (card, CPU) gradient
    norms where the step reports them."""
    (mc, uc), (mh, uh) = card, cpu
    rel = max(abs(mc[k] - mh[k]) / max(abs(mh[k]), 1e-12) for k in mh)
    upd = (torch.cat([(a - b).abs().flatten() for a, b in zip(uc, uh)]).mean()
           / torch.cat([b.abs().flatten() for b in uh]).mean().clamp_min(1e-30)).item()
    held = dict(loss_rel=rel, update_rel=upd)
    text = ""
    if gnorms is not None:
        held["grad_norm_rel"] = abs(gnorms[0] / gnorms[1] - 1)
        text = f", gradient norm by {held['grad_norm_rel']:.3e} (tol {P14_GNORM_RTOL})"
    print(f"{label}, card against CPU: losses off by {rel:.3e} (tol {P14_LOSS_RTOL}), updates "
          f"by {upd:.3e} of the mean abs update (tol {P14_UPDATE_REL}){text}")
    if (not rel <= P14_LOSS_RTOL or not upd <= P14_UPDATE_REL
            or not held.get("grad_norm_rel", 0.0) <= P14_GNORM_RTOL):
        fail(f"{label} on the card disagrees with the CPU")
    return held


def step_on(mods, step):
    """(losses, updates) of ``step()`` (a dict of 0-dim losses) on the
    parameters of the modules ``mods``."""
    before = [p.detach().clone() for m in mods for p in m.parameters()]
    losses = {k: float(v) for k, v in step().items()}
    after = [p.detach() for m in mods for p in m.parameters()]
    return losses, [(a - b).float().cpu() for a, b in zip(after, before)]


def gan_run(dev, work, recorder):
    """Phase 14: --runner gan through the CLI, then one critic and one
    generator step against a CPU runner resumed from the card's checkpoint
    with the card's generator, critic and their Adam states."""
    from difffacto_torch.config import Config
    from difffacto_torch.runner import GanRunner
    from difffacto_torch.runner.cli import main as cli_main

    cfg = write_config(work, "gan", work_dir=os.path.join(work, "gan"), max_epoch=1,
                       eval_interval=1, checkpoint_interval=None, cimle_cache_interval=None,
                       log_interval=1, model=P14_MODEL, dataset=P14_DATA)
    times = {}
    restore = timed_methods(GanRunner, ("train", "val"), times)
    try:
        mg_counts(zero=True)
        t0 = time.perf_counter()
        with recorder:
            runner = cli_main(["--config-file", cfg, "--runner", "gan"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = mg_counts()
    finally:
        restore()
    T, steps = runner.model.num_timesteps, len(runner.train_loader)
    recs = [json.loads(line) for line in open(os.path.join(runner.work_dir, "scalars.jsonl"))]
    losses = [(r["d_loss"], r["g_loss"]) for r in recs if "d_loss" in r]
    val = [r for r in recs if any(k.endswith("1-NN-CD-acc") for k in r)]
    G, D = runner.generator, runner.discriminator
    print(f"--runner gan: {wall:.2f} s (runner built), epoch {times['train']:.3f} s, val "
          f"{times['val']:.2f} s, (d_loss, g_loss) by step {np.round(losses, 4).tolist()}, "
          f"critic input width {D.dense0.kernel.shape[0]}, launches {counts}")
    want = only(fused_core=T * len(runner.val_loader))
    bad = {k: v for k, v in counts.items() if k != "emd_hybrid" and v != want[k]}
    if type(runner) is not GanRunner or runner.epoch != 1 or len(losses) != steps:
        fail(f"--runner gan ran {type(runner).__name__} to epoch {runner.epoch}, {losses}")
    if not np.isfinite(losses).all() or len(val) != 1 or not all(
            np.isfinite(v) for k, v in val[0].items() if "/" in k):
        fail(f"--runner gan: losses {losses}, val {val}")
    if bad or counts["emd_hybrid"] == 0:
        fail(f"--runner gan launched {counts}: expected {T} trunk launches a val batch, EMD "
             "launches in its val and nothing else")
    codes = runner.generate_codes(64, torch.Generator(device=dev).manual_seed(0))
    if tuple(codes.shape) != (64, G.n_class, G.out_dim) or not torch.isfinite(codes).all():
        fail(f"generate_codes gave {tuple(codes.shape)}")
    # one critic and one generator step on each side from the same state
    cpu = GanRunner(cfg=Config(cfg), device="cpu")  # resumes the card's checkpoint
    for name in ("generator", "discriminator"):
        getattr(cpu, name).load_state_dict(on_cpu(getattr(runner, name).state_dict()))
    cpu.d_opt, cpu.g_opt = on_cpu(runner.d_opt), on_cpu(runner.g_opt)
    batch = next(iter(runner.train_loader))
    B = len(batch["ref"])
    rng = np.random.RandomState(140)
    z_d, z_g = (torch.as_tensor(rng.randn(*G.noise_shape(B)), dtype=torch.float32)
                for _ in range(2))
    out = {}
    for label, r, where in (("card", runner, dev), ("cpu", cpu, "cpu")):
        codes, nets = r.real_codes(batch), (r.generator, r.discriminator)
        d = step_on(nets, lambda: {"d_loss": r.d_step(codes, z=z_d.to(where))})
        g = step_on(nets, lambda: {"g_loss": r.g_step(B, z=z_g.to(where))})
        out[label] = (dict(d[0], **g[0]), d[1] + g[1])
    held = hold_updates("--runner gan, one critic and one generator step", out["card"],
                        out["cpu"])
    return dict(launches=counts, s=wall, epoch_s=times["train"], val_s=times["val"], **held)


def language_run(dev, work):
    """Phase 14: --runner language --no_eval through the CLI, every parameter
    outside the language modules bit for bit as it was, then one step against
    a CPU runner resumed from the card's checkpoint."""
    from difffacto_torch.config import Config
    from difffacto_torch.runner import LanguageRunner
    from difffacto_torch.runner.cli import main as cli_main

    data = lambda size, split: dict(_cover_=True, type="SyntheticLanguagePart", split=split,
                                    batch_size=LANG_BATCH, size=size, npoints=P14_POINTS)
    cfg = write_config(work, "language", work_dir=os.path.join(work, "language"), max_epoch=1,
                       checkpoint_interval=None, cimle_cache_interval=None, log_interval=1,
                       model=P14_MODEL,
                       dataset=dict(train=data(LANG_SIZE, "train"), val=data(LANG_BATCH, "test")))
    frozen = {}
    original = LanguageRunner.train

    def train(self):
        frozen.update({n: p.detach().clone() for n, p in self.model.named_parameters()
                       if not n.startswith(("language_enc.", "update_mlp."))})
        return original(self)

    times = {}
    LanguageRunner.train = train
    restore = timed_methods(LanguageRunner, ("train",), times)
    try:
        mg_counts(zero=True)
        t0 = time.perf_counter()
        runner = cli_main(["--config-file", cfg, "--runner", "language", "--no_eval"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = mg_counts()
    finally:
        restore()
        LanguageRunner.train = original
    recs = [json.loads(line) for line in open(os.path.join(runner.work_dir, "scalars.jsonl"))]
    losses = [r["total_loss"] for r in recs if "total_loss" in r]
    moved = [n for n, p in runner.model.named_parameters() if n in frozen
             and not torch.equal(p, frozen[n])]
    print(f"--runner language: {wall:.2f} s (runner built), epoch {times['train']:.3f} s for "
          f"{len(losses)} steps of {LANG_BATCH} triplets x {P14_POINTS} points, total_loss "
          f"{[round(v, 4) for v in losses]}, {len(frozen)} frozen parameters, launches {counts}")
    if type(runner) is not LanguageRunner or runner.epoch != 1 or not losses or not all(
            np.isfinite(losses)):
        fail(f"--runner language ran {type(runner).__name__} to epoch {runner.epoch}: {losses}")
    if moved or any(counts.values()):
        fail(f"--runner language moved {moved[:5]} or launched {counts}")
    cpu = LanguageRunner(cfg=Config(cfg), device="cpu")  # resumes the card's checkpoint
    batch = next(iter(runner.train_loader))
    rng = np.random.RandomState(141)
    B = len(batch["text"])
    zdim = runner.model.encoder["encoder"]["zdim"]
    inject = dict(part_code_eps=rng.randn(B * 3, 4, zdim).astype(np.float32),
                  text_keep=rng.rand(B, batch["text"].shape[1], 100) > 0.5)
    out = {}
    for label, r, where in (("card", runner, dev), ("cpu", cpu, "cpu")):
        db = {k: torch.as_tensor(np.asarray(v), device=where) for k, v in dict(
            batch, **inject).items() if k in inject or k in (
            "input", "ref", "attn_map", "part_indicator", "text")}

        def step(r=r, db=db):
            r.state, metrics = r.language_step(r.state, db, {})
            return {k: v for k, v in metrics.items() if "loss" in k}
        before = {n: p.detach().clone() for n, p in r.model.named_parameters()}
        out[label] = step_on([r.model], step)
        if any(not torch.equal(p, before[n]) for n, p in r.model.named_parameters()
               if n in frozen):
            fail(f"a language step on the {label} moved a parameter outside the language modules")
    held = hold_updates("--runner language, one step", out["card"], out["cpu"])
    return dict(launches=counts, s=wall, epoch_s=times["train"], **held)


def mixing_run(dev, work, recorder):
    """Phase 14: MixingRunner.mixing on one val batch, then combine_latent on
    MIX_CHECK shapes against the CPU with every draw injected."""
    from difffacto_torch.config import Config
    from difffacto_torch.models import denoiser
    from difffacto_torch.runner import MixingRunner
    from difffacto_torch.runner.editing import combine_latent
    from difffacto_torch.runner.runner import device_batch

    cfg = write_config(work, "mixing", work_dir=os.path.join(work, "mixing"), model=P14_MODEL,
                       dataset=dict(P14_DATA, val=dict(dict(size=32), **P14_DATA.get("val", {}))))
    runner = MixingRunner(cfg=Config(cfg), device=dev)
    T, N = runner.model.num_timesteps, runner.model.npoints
    B, nb = len(runner.val_loader.dataset), len(runner.val_loader)
    zdim = runner.model.encoder["encoder"]["zdim"]
    mg_counts(zero=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recorder:
        merged = runner.mixing(seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = mg_counts()
    print(f"MixingRunner.mixing, {nb} val batch(es), {B} shapes: {wall:.2f} s, launches {counts}, "
          f"{sorted(merged)}")
    if counts != only(fused_core=T * nb) or not os.path.exists(
            os.path.join(runner.work_dir, "mixing", "mixing.pkl")):
        fail(f"MixingRunner.mixing launched {counts} (expected {T * nb} trunk launches) or wrote no "
             "mixing.pkl")
    if merged["pred"].shape != (B, N, 3) or not np.isfinite(merged["pred"]).all():
        fail(f"MixingRunner.mixing gave {merged['pred'].shape}")
    batch = {k: v[:MIX_CHECK] for k, v in next(iter(runner.val_loader)).items()}
    rng = np.random.RandomState(142)
    draws = dict(part_code_eps=rng.randn(MIX_CHECK, 4, zdim), perm_seed=3,
                 cimle_noise=rng.randn(MIX_CHECK, 32), x_T=rng.randn(MIX_CHECK, N, 3),
                 step_noise=rng.randn(T, MIX_CHECK, N, 3))
    draws = {k: v.astype(np.float32) if isinstance(v, np.ndarray) else v for k, v in draws.items()}
    cpu = MixingRunner(cfg=Config(cfg), device="cpu")  # the same seeded weights
    real = denoiser.kernel_dtype
    runs = {"card": combine_latent(runner.model, device_batch(batch, dev), **draws)["pred"]}
    denoiser.kernel_dtype = lambda device, dt: torch.bfloat16  # the kernel's operands
    try:
        runs["cpu"] = combine_latent(cpu.model, device_batch(batch, "cpu"), **draws)["pred"]
    finally:
        denoiser.kernel_dtype = real
    rel = float(np.linalg.norm(runs["card"] - runs["cpu"]) / np.linalg.norm(runs["cpu"]))
    print(f"combine_latent on {MIX_CHECK} shapes, card against CPU (bf16 trunk operands both), "
          f"every draw injected: relative L2 {rel:.4e} (tol {E2E_REL_L2})")
    if not np.isfinite(runs["card"]).all() or not rel <= E2E_REL_L2:
        fail("mixing on the card disagrees with the CPU")
    return dict(launches=counts, s=wall, rel_l2=rel)


def pdm_run(dev, recorder):
    """Phase 14: PDM on PointNet2SSG: PDM_STEPS training steps and a predict
    at PDM_BATCH (launch counts, ms a step, seconds a predict), then one
    step and a predict against the CPU."""
    from difffacto_torch import MODELS, build_from_cfg
    from difffacto_torch.data import SyntheticPart
    from difffacto_torch.parallel import init_train_state, make_train_step
    from difffacto_torch.runner.runner import device_batch

    def batch(B, seed):
        loader, _ = SyntheticPart(batch_size=B, npoints=P14_POINTS, size=B, shuffle=False)
        b = next(iter(loader))
        rng = np.random.RandomState(seed)
        b.update(diffusion_t=rng.randint(0, T, (B,)).astype(np.int64),
                 diffusion_noise=rng.randn(B, P14_POINTS, 3).astype(np.float32),
                 encoder_keep=rng.rand(B, 256) > 0.5)
        return b

    def pdm(where):
        return build_from_cfg(dict(PDM_CFG), MODELS, device=where, seed=0)

    T = PDM_CFG["num_timesteps"]

    def on(b, where):
        out = device_batch(b, where)
        out.update({k: torch.as_tensor(b[k], device=where)
                    for k in ("diffusion_t", "diffusion_noise", "encoder_keep")})
        return out

    model = pdm(dev)
    tx = build_train_optimizer()
    step, state = make_train_step(model, tx), init_train_state(model, tx)
    data = on(batch(PDM_BATCH, 143), dev)
    losses, times = [], []
    mg_counts(zero=True)
    with recorder:
        for i in range(PDM_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, met = step(state, data, i, 0)
            losses.append(float(met["total_loss"]))
            times.append(1e3 * (time.perf_counter() - t0))
    train_counts = mg_counts()
    mg_counts(zero=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred = model.predict(data, torch.Generator(device=dev).manual_seed(0))["pred"]
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    predict_counts = mg_counts()
    print(f"PDM (PointNet2SSG + PointwiseNet), batch {PDM_BATCH} x {P14_POINTS}: total_loss by step "
          f"{[round(v, 4) for v in losses]}, ms a step {[round(t, 1) for t in times]}, launches "
          f"{train_counts}; predict (T = {model.num_timesteps}) {predict_s:.3f} s, launches "
          f"{predict_counts}")
    sa = len(SA_FPS)
    if train_counts != only(fps=sa * PDM_STEPS) or predict_counts != only(fps=sa):
        fail(f"PDM launched {train_counts} in training and {predict_counts} in predict: expected "
             f"{sa} FPS launches a forward pass and nothing else")
    if not all(np.isfinite(losses)) or float(met["skipped_nonfinite"]):
        fail(f"PDM training losses {losses}")
    if tuple(pred.shape) != (PDM_BATCH, P14_POINTS, 3) or not torch.isfinite(pred).all():
        fail(f"PDM.predict gave {tuple(pred.shape)}")
    del model, state, step, data
    torch.cuda.empty_cache()
    small = batch(P14_CHECK_BATCH, 144)
    rng = np.random.RandomState(145)
    x_T = torch.as_tensor(rng.randn(MIX_CHECK, P14_POINTS, 3), dtype=torch.float32)
    steps = torch.as_tensor(rng.randn(T, MIX_CHECK, P14_POINTS, 3), dtype=torch.float32)
    runs, preds, gnorms = {}, {}, {}
    for label, where in (("card", dev), ("cpu", "cpu")):
        m = pdm(where)
        tx = build_train_optimizer()
        sub = {k: v[:MIX_CHECK] for k, v in on(small, where).items()}
        preds[label] = m.predict(sub, noise=x_T.to(where),
                                 step_noise=steps.to(where))["pred"].float().cpu()
        s = make_train_step(m, tx)
        st = init_train_state(m, tx)

        def one(s=s, st=st, where=where, label=label):
            met = s(st, on(small, where), 0, 0)[1]
            gnorms[label] = float(met["grad_norm"])
            return {"total_loss": met["total_loss"]}
        runs[label] = step_on([m], one)
        del m
    held = hold_updates(f"PDM, one step at batch {P14_CHECK_BATCH}", runs["card"], runs["cpu"],
                        (gnorms["card"], gnorms["cpu"]))
    rel = ((preds["card"] - preds["cpu"]).norm() / preds["cpu"].norm()).item()
    print(f"PDM.predict on {MIX_CHECK} shapes, card against CPU (float32 both), x_T and the "
          f"steps' draws injected: relative L2 {rel:.4e} (tol {P14_PREDICT_REL_L2})")
    if not rel <= P14_PREDICT_REL_L2:
        fail("PDM.predict on the card disagrees with the CPU")
    return dict(launches={k: train_counts[k] + predict_counts[k] for k in train_counts},
                step_ms=float(np.median(times[1:])), predict_s=predict_s, predict_rel_l2=rel,
                **held)


def pointnet2_times(dev, fpsm):
    """Phase 14: one forward pass of PointNet2SSG and PointNet2MSG (4, 256, 1)
    at PDM_BATCH x P14_POINTS in eval mode, CUDA events over 5 calls, beside the
    time of its FPS launches and of its ball queries at the same shapes; FPS
    at each set abstraction's shape beside its plain version and bound."""
    from difffacto_torch.models import PointNet2MSG, PointNet2SSG
    from difffacto_torch.ops.points import ball_query, fps

    rng = np.random.RandomState(146)
    B = PDM_BATCH
    x = torch.as_tensor(np.concatenate([0.4 * rng.randn(B, P14_POINTS, 3), np.eye(4)[
        rng.randint(0, 4, (B, P14_POINTS))]], -1), dtype=torch.float32, device=dev)
    clouds = {n: x[:, :n, :3].contiguous() for n, _ in SA_FPS}
    centres = {(n, m): fps(clouds[n], m) for n, m in SA_FPS}
    out = {}
    for n, m in SA_FPS:
        ms = cuda_ms(lambda: fpsm.furthest_point_sample(clouds[n], m), 20)
        plain = cuda_ms(lambda: fpsm.furthest_point_sample_reference(clouds[n], m), 2)
        bound, by = fps_bound_ms(B, n, m)
        out[f"{n}_to_{m}"] = dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by)
        print(f"fps at PointNet++'s {B} x {n} -> {m}: {ms:.4f} ms (plain {plain:.3f} ms, bound "
              f"{bound:.4f} ms by {by})")
    fps_ms = sum(v["ms"] for v in out.values())
    for cls in (PointNet2SSG, PointNet2MSG):
        enc = cls(additioinal_dim=4, zdim=256, num_anchors=1, device=dev)
        with torch.inference_mode():
            ms = cuda_ms(lambda: enc(x), 5)
            bq = sum(cuda_ms(lambda: ball_query(centres[(n, m)], clouds[n], r, k), 5)
                     for (n, m), balls in zip(SA_FPS, SA_BALLS[cls.__name__])
                     for r, k in balls)
        out[cls.__name__] = dict(forward_ms=ms, fps_ms=fps_ms, ball_query_ms=bq)
        print(f"{cls.__name__} forward at {B} x {P14_POINTS} x 7: {ms:.3f} ms; its FPS launches "
              f"{fps_ms:.3f} ms ({100 * fps_ms / ms:.1f}%), its ball queries {bq:.3f} ms "
              f"({100 * bq / ms:.1f}%)")
        del enc
    return out


def phase14(dev, fc, fct, fpsm, eh, ff, fb):
    """Phase 14: the GAN, language and mixing runners and PDM on PointNet++;
    returns each path's numbers. The first B1 launch of the GAN's val and of
    the mixing, the GAN val's first EMD launch and PDM's first FPS launch at
    each set abstraction's shape are held against their plain versions."""
    import tempfile

    from difffacto_torch.models import denoiser
    from difffacto_torch.ops import points

    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as work:
        rec = KernelRecorder((denoiser, "fused_core"), (eh, "emd_assignment_hybrid"))
        out["gan"] = gan_run(dev, work, rec)
        out["gan"]["core_err"] = rec.hold_core("--runner gan's val")
        out["gan"]["emd_share"] = hold_emd(rec, "--runner gan's val")
        out["language"] = language_run(dev, work)
        rec = KernelRecorder((denoiser, "fused_core"))
        out["mixing"] = mixing_run(dev, work, rec)
        out["mixing"]["core_err"] = rec.hold_core("MixingRunner.mixing")
    rec = KernelRecorder((points, "furthest_point_sample"))
    out["pdm"] = pdm_run(dev, rec)
    shapes = []
    for (B, N), (args, _, got) in rec.launches("furthest_point_sample", "PDM training"):
        want = fpsm.furthest_point_sample_reference(*args)
        if not torch.equal(got, want):
            fail(f"FPS as PDM launched it, {B} x {N} -> {args[1]}, chose other points than "
                 "its plain version")
        shapes.append(f"{B} x {N} -> {args[1]}")
    print(f"FPS as PDM launched it ({', '.join(shapes)}): index for index its plain version's")
    if len(shapes) != len(SA_FPS):
        fail(f"PDM launched FPS at {shapes}, not at each set abstraction's shape")
    out["pointnet2"] = pointnet2_times(dev, fpsm)
    print(f"phase 14: {time.perf_counter() - t_phase:.1f} s")
    return out


def p15_td_model(where, noise_scale):
    """gen_chair at full width in bf16 on PartEncoderForTransformerDecoderKLLoss
    (the std in its part tokens), seeded."""
    from difffacto_torch import MODELS, Config, build_from_cfg

    mcfg = Config(os.path.join(ROOT, "configs", "gen_chair.py")).model.dump()
    mcfg.update(npoints=2048, ret_traj=False, cimle_sample_num=1, dtype=torch.bfloat16)
    mcfg["encoder"]["part_aligner"].update(noise_scale=noise_scale)
    mcfg["encoder"].update(type="PartEncoderForTransformerDecoderKLLoss", include_std=True)
    return build_from_cfg(mcfg, MODELS, device=where, seed=0)


def p15_base_model(where):
    """bench_train_tpu's model on the base PartEncoder (the MLP aligner,
    include_z: a per-point ctx of 4 x 256 + 6) and PointwiseNet, float32."""
    from difffacto_torch import MODELS, Config, build_from_cfg

    mcfg = Config(os.path.join(ROOT, RUNNER_CONFIG)).model.dump()
    mcfg.update(npoints=2048, ret_traj=False, cimle=False)
    mcfg["encoder"].update(type="PartEncoder", include_z=True, include_part_code=False,
                           include_params=True,
                           part_aligner=dict(type="PartAligner", n_class=4, width=256))
    mcfg["diffusion"]["net"] = dict(P15_PW, context_dim=4 * 256 + 6)
    model = build_from_cfg(mcfg, MODELS, device=where, seed=0)
    with torch.no_grad():
        for head in (model.encoder_mod.aligner.fc4_m, model.encoder_mod.aligner.fc4_v):
            head.kernel.mul_(P15_ALIGNER_HEAD)
    return model


def p15_build(cfg, where):
    from difffacto_torch import MODELS, build_from_cfg

    return build_from_cfg(dict(cfg), MODELS, device=where, seed=0)


def p15_protocol(dev, label, gen, refs):
    """Phase 6's protocol on ``gen`` against ``refs``: launch counts set to 0
    just before and read just after (FPS once for the refs, the EMD sweeps),
    the FPS launch index for index and the first EMD launch by its matched
    cost against their plain versions. Returns the metrics, launches and
    seconds."""
    from difffacto_torch.metrics import eval as ev
    from difffacto_torch.ops import emd_hybrid as eh
    from difffacto_torch.ops import fps as fpsm
    from difffacto_torch.ops import points
    from difffacto_torch.runner.evaluation import evaluate_gen

    S, R = len(gen), len(refs)
    per_launch = ev.emd_pairs_per_launch(2048, 32, torch.device(dev))
    sweeps = (R * S, R * (R - 1) // 2, S * (S - 1) // 2)
    expected = only(fps=1, emd_hybrid=sum(-(-p // per_launch) for p in sweeps))
    rec = KernelRecorder((points, "furthest_point_sample"), (eh, "emd_assignment_hybrid"))
    mg_counts(zero=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with rec:
        metrics = evaluate_gen(gen, refs, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = mg_counts()
    metrics = {k: float(v) for k, v in metrics.items()}
    print(f"{label} scored by phase 6's protocol ({S} v {R}): {wall:.2f} s, launches {counts}, "
          + json.dumps({k: round(v, 4) for k, v in metrics.items()}))
    if counts != expected:
        fail(f"the protocol of {label} launched {counts}, expected {expected}")
    if not all(np.isfinite(v) for v in metrics.values()):
        fail(f"the protocol of {label} gave non-finite metrics")
    for (B, N), (args, _, got) in rec.launches("furthest_point_sample", label):
        if not torch.equal(got, fpsm.furthest_point_sample_reference(*args)):
            fail(f"FPS as the protocol of {label} launched it, {B} x {N}, chose other points "
                 "than its plain version")
    emd_share = hold_emd(rec, f"the protocol of {label}")
    return dict(metrics=metrics, launches=counts, s=wall, emd_share=emd_share)


def p15_steps(dev, label, model, batch_fn, expected, steps=P15_STEPS, batch=P15_TRAIN_BATCH):
    """``steps`` steps of ``model`` on one batch of ``batch`` shapes with its
    draws injected: the loss falls, the launches are ``expected``. Returns
    (losses, ms a step, launches)."""
    from difffacto_torch.parallel import init_train_state, make_train_step

    tx = build_train_optimizer(P15_LR)
    step, state = make_train_step(model, tx), init_train_state(model, tx)
    data = batch_fn(batch, 150, dev)
    losses, times = [], []
    mg_counts(zero=True)
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step(state, data, i, 0)
        losses.append(float(met["total_loss"]))
        times.append(1e3 * (time.perf_counter() - t0))
        if float(met["skipped_nonfinite"]):
            fail(f"{label}: step {i} was skipped as non-finite")
    counts = mg_counts()
    print(f"{label}, batch {batch}, Adam at {P15_LR}: total_loss by step "
          f"{[round(v, 4) for v in losses]}, the last step's "
          + json.dumps({k: round(float(v), 4) for k, v in met.items() if k.endswith("loss")})
          + f", ms a step {[round(t, 1) for t in times]}, launches {counts}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"{label}: the loss did not fall over {steps} steps: {losses}")
    if counts != expected:
        fail(f"{label} launched {counts}, expected {expected}")
    return losses, float(np.median(times[1:])), counts


def p15_step_against_cpu(dev, label, build, batch_fn, batch=P15_CHECK_STEP):
    """One float32 step at ``batch`` shapes of the model ``build(where)`` on
    the card and on the CPU, every draw injected (hold_updates)."""
    from difffacto_torch.parallel import init_train_state, make_train_step

    runs, gnorms = {}, {}
    for key, where in (("card", dev), ("cpu", "cpu")):
        m = build(where)
        tx = build_train_optimizer(P15_LR)
        s, st = make_train_step(m, tx), init_train_state(m, tx)

        def one(s=s, st=st, where=where, key=key):
            met = s(st, batch_fn(batch, 151, where), 0, 0)[1]
            gnorms[key] = float(met["grad_norm"])
            return {"total_loss": met["total_loss"]}
        runs[key] = step_on([m], one)
        del m
    return hold_updates(f"{label}, one step at batch {batch}", runs["card"], runs["cpu"],
                        (gnorms["card"], gnorms["cpu"]))


def p15_rel(label, card, cpu, tol):
    card, cpu = card.float().cpu(), cpu.float().cpu()
    rel = ((card - cpu).norm() / cpu.norm()).item()
    print(f"{label}, card against CPU, every draw injected: relative L2 {rel:.4e} (tol {tol})")
    if not torch.isfinite(card).all() or not rel <= tol:
        fail(f"{label} on the card disagrees with the CPU")
    return rel


def p15_td(dev, noise_scale):
    """(a): generation on the KL-prior TD variant, training on the cVAE."""
    from difffacto_torch import sample_generation
    from difffacto_torch.models import denoiser

    model = p15_td_model(dev, noise_scale)
    T = model.num_timesteps
    rec = KernelRecorder((denoiser, "fused_core"))
    mg_counts(zero=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with rec:
        pred = sample_generation(model, P15_GEN_BATCH, valid_id=torch.ones(P15_GEN_BATCH, 4,
                                                                           device=dev),
                                 generator=torch.Generator(device=dev).manual_seed(0))["pred"]
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts = mg_counts()
    print(f"generation on PartEncoderForTransformerDecoderKLLoss (include_std), batch "
          f"{P15_GEN_BATCH}: {gen_s:.2f} s, launches {counts}")
    if counts != only(fused_core=T) or tuple(pred.shape) != (P15_GEN_BATCH, 2048, 3) or \
            not torch.isfinite(pred).all():
        fail(f"the TD variant's generation launched {counts} (expected {T} trunk launches) or "
             f"gave {tuple(pred.shape)} non-finite samples")
    core_err = rec.hold_core("the TD variant's generation")
    rng = np.random.RandomState(152)
    draws = dict(z=rng.randn(1, 4, 256), cimle_noise=rng.randn(1, 32),
                 noise=rng.randn(1, 2048, 3), step_noise=rng.randn(T, 1, 2048, 3))
    runs = {}
    for where, m in (("card", model), ("cpu", p15_td_model("cpu", noise_scale))):
        d = {k: torch.as_tensor(v, dtype=torch.float32, device=m.device) for k, v in draws.items()}
        runs[where] = sample_generation(
            m, 1, valid_id=torch.as_tensor([[1, 0, 1, 1]], dtype=torch.float32, device=m.device),
            **d)["pred"]
    gen_rel = p15_rel("the TD variant's generation, batch 1", runs["card"], runs["cpu"],
                      E2E_REL_L2)
    del model, runs
    torch.cuda.empty_cache()
    rec = KernelRecorder((denoiser, "fused_trunk_train"))
    train = train_steps_against_cpu(
        dev, "PartEncodercVAE (encode_ref) training", lambda: mg_counts(zero=True), mg_counts,
        launches=dict(fused_trunk_train_fwd=1, fused_trunk_train_bwd=1), cvae=True,
        recorder=rec, encoder=dict(type="PartEncodercVAE", encode_ref=True))
    train_errs = rec.hold_train("the cVAE's first training step")  # (forward, backward)
    launches = {k: counts[k] + train["launches"][k] for k in counts}
    return dict(launches=launches, gen_s=gen_s, core_err=core_err, gen_rel_l2=gen_rel,
                train=train, train_errs=train_errs)


def p15_base(dev, refs):
    """(b): the base PartEncoder's per-point ctx on PointwiseNet, generation
    scored by the protocol; 2 shapes against the CPU."""
    from difffacto_torch import sample_generation
    from difffacto_torch.runner.evaluation import generate_samples

    model = p15_base_model(dev)
    mg_counts(zero=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen = generate_samples(model, num_gen=P15_SHAPES, batch=P15_SHAPES, seed=0)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gen_counts = mg_counts()
    print(f"base PartEncoder + PointwiseNet, {P15_SHAPES} shapes: {gen_s:.2f} s, launches "
          f"{gen_counts}")
    if gen_counts != only() or gen.shape != (P15_SHAPES, 2048, 3) or not np.isfinite(gen).all():
        fail(f"the base encoder's generation launched {gen_counts} or gave {gen.shape} "
             "non-finite samples")
    scored = p15_protocol(dev, "the base encoder's samples", gen, refs)
    rng = np.random.RandomState(153)
    T = model.num_timesteps
    draws = dict(z=rng.randn(P15_CHECK, 4, 256), noise=rng.randn(P15_CHECK, 2048, 3),
                 step_noise=rng.randn(T, P15_CHECK, 2048, 3))
    runs = {}
    for where, m in (("card", model), ("cpu", p15_base_model("cpu"))):
        d = {k: torch.as_tensor(v, dtype=torch.float32, device=m.device) for k, v in draws.items()}
        runs[where] = sample_generation(m, P15_CHECK, **d)["pred"]
    rel = p15_rel(f"the base encoder's generation, {P15_CHECK} shapes", runs["card"],
                  runs["cpu"], P14_PREDICT_REL_L2)
    del model
    torch.cuda.empty_cache()
    return dict(launches=scored["launches"], gen_s=gen_s, rel_l2=rel, scored=scored)


def p15_cloud_batch(B, seed, where):
    """A SyntheticPart batch with the anchored generator's draws injected."""
    from difffacto_torch.data import SyntheticPart
    from difffacto_torch.runner.runner import device_batch

    loader, _ = SyntheticPart(batch_size=B, npoints=2048, size=B, shuffle=False)
    b = next(iter(loader))
    rng = np.random.RandomState(seed)
    out = device_batch(b, where)
    draws = dict(diffusion_t=rng.randint(0, P15_T, (B,)).astype(np.int64),
                 diffusion_noise=rng.randn(B, 2048, 3).astype(np.float32),
                 latent_eps=rng.randn(B, 4, 256).astype(np.float32))
    out.update({k: torch.as_tensor(v, device=where) for k, v in draws.items()})
    return out


def p15_anchored(dev, refs):
    """(c): AnchoredGeneration's steps and a predict scored by the protocol;
    a step and a predict of P15_CHECK shapes against the CPU."""
    model = p15_build(P15_ANCHORED, dev)
    losses, step_ms, train_counts = p15_steps(dev, "AnchoredGeneration", model, p15_cloud_batch,
                                              only())
    batch = p15_cloud_batch(P15_SHAPES, 154, dev)
    mg_counts(zero=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred = model.predict(batch, torch.Generator(device=dev).manual_seed(0))["pred"]
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    counts = mg_counts()
    print(f"AnchoredGeneration.predict, {P15_SHAPES} shapes: {predict_s:.2f} s, launches {counts}")
    if counts != only() or tuple(pred.shape) != (P15_SHAPES, 2048, 3) or \
            not torch.isfinite(pred).all():
        fail(f"AnchoredGeneration.predict launched {counts} or gave {tuple(pred.shape)} "
             "non-finite samples")
    scored = p15_protocol(dev, "AnchoredGeneration's samples", pred.float().cpu().numpy(), refs)
    del model
    torch.cuda.empty_cache()
    held = p15_step_against_cpu(dev, "AnchoredGeneration", lambda w: p15_build(P15_ANCHORED, w),
                                p15_cloud_batch)
    rng = np.random.RandomState(155)
    draws = dict(z=rng.randn(P15_CHECK, 4, 256), noise=rng.randn(P15_CHECK, 2048, 3),
                 step_noise=rng.randn(P15_T, P15_CHECK, 2048, 3))
    runs = {}
    for key, where in (("card", dev), ("cpu", "cpu")):
        m = p15_build(P15_ANCHORED, where)
        d = {k: torch.as_tensor(v, dtype=torch.float32, device=where) for k, v in draws.items()}
        b = {k: batch[k][:P15_CHECK].to(where) for k in ("input", "ref")}
        runs[key] = m.predict(b, **d)["pred"]
        del m
    rel = p15_rel(f"AnchoredGeneration.predict, {P15_CHECK} shapes", runs["card"], runs["cpu"],
                  P14_PREDICT_REL_L2)
    return dict(launches=scored["launches"], losses=losses, step_ms=step_ms,
                predict_s=predict_s, rel_l2=rel, scored=scored, **held)


def p15_seg_batch(B, seed, where):
    """Seeded super-segments, (B, P15_NSEG, P15_NPOINT, 3), the last fifth of
    each shape's segments invalid, each segment given a part, and the
    chain's draws injected."""
    rng = np.random.RandomState(seed)
    x = (0.3 * rng.randn(B, P15_NSEG, P15_NPOINT, 3) + 0.5 * rng.randn(B, P15_NSEG, 1, 3))
    geo = np.ones((B, P15_NSEG), np.float32)
    geo[:, -P15_NSEG // 5:] = 0.0
    b = dict(input=x.astype(np.float32), ref=x.astype(np.float32), geo_mask=geo,
             seg_mask=rng.randint(0, 4, (B, P15_NSEG)).astype(np.int32),
             diffusion_t=rng.randint(0, P15_T, (B * P15_NSEG,)).astype(np.int64),
             diffusion_noise=rng.randn(B * P15_NSEG, P15_NPOINT, 3).astype(np.float32))
    return {k: torch.as_tensor(v, device=where) for k, v in b.items()}


def p15_partglot(dev):
    """(d): AnchorDiffGenPartglot's steps, predict, interpolate_latent and
    combine_latent; a step and a predict of P15_CHECK shapes against the
    CPU."""
    model = p15_build(P15_PARTGLOT, dev)
    losses, step_ms, counts = p15_steps(dev, "AnchorDiffGenPartglot", model, p15_seg_batch,
                                        only())
    batch = p15_seg_batch(P15_TRAIN_BATCH, 156, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    times = {}
    runs = (("predict", (), P15_TRAIN_BATCH), ("interpolate_latent", (0, 1, 2, P15_INTERP_STEPS),
                                               P15_INTERP_STEPS),
            ("combine_latent", ([3, 0, 2, 1],), 1))
    for name, args, rows in runs:
        mg_counts(zero=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = getattr(model, name)(batch, *args, generator=gen)
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        c = mg_counts()
        print(f"AnchorDiffGenPartglot.{name}: {times[name]:.2f} s, launches {c}, pred "
              f"{tuple(out['pred'].shape)}")
        if c != only() or tuple(out["pred"].shape) != (rows, 2048, 3) or \
                not torch.isfinite(out["pred"]).all():
            fail(f"AnchorDiffGenPartglot.{name} launched {c} or gave {tuple(out['pred'].shape)} "
                 "non-finite samples")
    del model
    torch.cuda.empty_cache()
    held = p15_step_against_cpu(dev, "AnchorDiffGenPartglot", lambda w: p15_build(P15_PARTGLOT, w),
                                p15_seg_batch)
    rng = np.random.RandomState(157)
    draws = dict(noise=rng.randn(P15_CHECK, 2048, 3),
                 step_noise=rng.randn(P15_T, P15_CHECK, 2048, 3))
    preds = {}
    for key, where in (("card", dev), ("cpu", "cpu")):
        m = p15_build(P15_PARTGLOT, where)
        d = {k: torch.as_tensor(v, dtype=torch.float32, device=where) for k, v in draws.items()}
        b = {k: batch[k][:P15_CHECK].to(where) for k in ("input", "geo_mask")}
        preds[key] = m.predict(b, **d)["pred"]
        del m
    rel = p15_rel(f"AnchorDiffGenPartglot.predict, {P15_CHECK} shapes", preds["card"],
                  preds["cpu"], P14_PREDICT_REL_L2)
    return dict(launches=counts, losses=losses, step_ms=step_ms, rel_l2=rel,
                **{f"{k}_s": v for k, v in times.items()}, **held)


def phase15(dev, noise_scale, refs):
    """Phase 15: AnchorDiffAE's other encoders and the anchored generators;
    returns each path's numbers and the launches of the whole phase."""
    t_phase = time.perf_counter()
    out = {"td": p15_td(dev, noise_scale), "base": p15_base(dev, refs),
           "anchored": p15_anchored(dev, refs), "partglot": p15_partglot(dev)}
    out["launches"] = {k: sum(out[p]["launches"][k] for p in ("td", "base", "anchored",
                                                                 "partglot"))
                       for k in mg_counts()}
    out["s"] = time.perf_counter() - t_phase
    print("phase 15 readings: " + json.dumps({
        "seconds": round(out["s"], 1),
        "td_generation_s": out["td"]["gen_s"],
        "td_train_step_ms": out["td"]["train"]["step_ms"],
        "anchored_step_ms": out["anchored"]["step_ms"],
        "partglot_step_ms": out["partglot"]["step_ms"],
        "td_generation_rel_l2": [out["td"]["gen_rel_l2"], "E2E_REL_L2", E2E_REL_L2],
        "td_train_loss_rel": [out["td"]["train"]["loss_rel"], "STEP_LOSS_RTOL", STEP_LOSS_RTOL],
        "td_train_grad_norm_rel": [out["td"]["train"]["grad_norm_rel"], "STEP_GNORM_RTOL",
                                   STEP_GNORM_RTOL],
        "td_train_update_rel": [out["td"]["train"]["update_rel"], "RUNNER_UPDATE_REL",
                                RUNNER_UPDATE_REL],
        "base_generation_rel_l2": [out["base"]["rel_l2"], "P14_PREDICT_REL_L2",
                                   P14_PREDICT_REL_L2],
        **{f"{p}_{k}": [out[p][k], c, globals()[c]] for p in ("anchored", "partglot")
           for k, c in (("loss_rel", "P14_LOSS_RTOL"), ("update_rel", "P14_UPDATE_REL"),
                        ("grad_norm_rel", "P14_GNORM_RTOL"), ("rel_l2", "P14_PREDICT_REL_L2"))},
        "launches": out["launches"]}))
    print(f"phase 15: {out['s']:.1f} s")
    return out


# Phase 16: the latent editors, the super-segment generator, completion and
# PointFlow at the flagship's latent widths: latent 256, 4 parts, 2048
# points, T = 100, bench_train_tpu's model (no shipped config uses these
# models). (a) LatentDiffEdit's own chain and LDMNet sample (256, 4, 256)
# part latents with its ctx of 4 tokens (distractor latents and text):
# two-attention blocks at inner 256 (8 x 32, one fused-FF launch a block a
# step at T = 256 x 5) and the flat layout at inner 128 (8 x 16: the
# one-block kernel's rule tiles a shape's 5 tokens, which pick_tile refuses,
# as in the JAX package: no launch); LDMNet's proj_out starts at zero, so
# the sampling paths give it seeded weights (p16_ldm_build) or the chain
# would read none of the blocks. (b) P15_STEPS steps at P15_TRAIN_BATCH
# of each editor model and one step at P15_CHECK_STEP against the CPU.
# (c) AnchorDiffGenSuperSegments (PCN, the latent projection with the
# learned scale and a GroupNorm'd post-FF, ComponentMixer, PointwiseNet):
# steps, a predict of P15_SHAPES shapes scored by phase 6's protocol, its
# other methods on P16_METHOD_SHAPES shapes. (d) PCN, CoarsePCN and
# DiffuCompletion on CroppingDataLoader batches (ShapeNet-55's crop of
# 8192-point clouds: 2 FPS launches a batch, and for DiffuCompletion's
# 2048-point target a third). (e) PointFlow at the JAX class's defaults:
# sample, P16_FLOW_STEPS steps at P16_FLOW_BATCH (PERF.md reckons the bytes
# of a batch: each RK4 step is recomputed in the backward, so one step's
# tangents and activations are live at a time). Card against CPU: the
# fused FF's launch and a P16_CHAIN_CHECK-row chain through it within
# E2E_REL_L2 (bf16 operands against float32); everything else float32 on
# both sides with no inexact kernel, at phase 14's P14_* constants.
P16_T, P16_TEXT, P16_LDM_DEPTH = 100, 64, 2
P16_SAMPLE_BATCH, P16_CHAIN_CHECK, P16_CHECK = 256, 128, 2
P16_METHOD_SHAPES, P16_DRIFT, P16_INTERP_STEPS = 4, 10, 10
P16_CROP_BATCH, P16_COMPLETION_CHECK = 32, 4
# The Aligner's step against the CPU takes 16 shapes: its encoder head's
# BatchNorm over 8 rows leaves float32 itself (CPU against float64 on the
# CPU) 9.1e-4 off in the gradient norm and 5.2e-3 in the update, next to
# P14_GNORM_RTOL and P14_UPDATE_REL (an H100 read 9.09e-4 and 5.16e-3
# against the CPU there); over 16 rows 2.2e-6 and 9.5e-5.
P16_ALIGNER_CHECK = 16
P16_FLOW_BATCH, P16_FLOW_STEPS, P16_FLOW_SAMPLE = 16, 2, 32
# PointFlow's step against the CPU: 4 shapes (its heads' BatchNorm) of 128
# points (its CPU cost grows with the points: 240 ODE evaluations a step)
P16_FLOW_CHECK_BATCH, P16_FLOW_CHECK_POINTS = 4, 128
P16_PLE = dict(type="PartLatentEditor", language_encoder=dict(type="LSTM", text_dim=P16_TEXT),
               latent_language_fuser=dict(type="LatentLanguageFuser", text_dim=P16_TEXT,
                                          part_dim=256),
               pcd_encoder=dict(type="PointNet", zdim=256, point_dim=7), num_part_latent=4,
               text_dim=P16_TEXT, out_dim=256)
P16_ALIGNER = dict(type="Aligner", encoder=dict(type="PointNet", zdim=256, point_dim=7),
                   n_class=4)
P16_FINETUNE = dict(type="PartglotFinetune", editor=P16_PLE, num_part=4)
P16_SUPSEG = dict(
    type="AnchorDiffGenSuperSegments", encoder=dict(type="PCN", point_dim=7, part_latent_dim=256),
    decomposer=dict(type="ComponentMixer", part_latent_dim=256, include_attention=True,
                    include_global_feature=True),
    diffusion=P15_DIFF, sampler=dict(type="Uniform"), num_anchors=4, num_timesteps=P16_T,
    npoints=2048, part_dim=256, project_latent=True, learn_var=True, post_ff=True)
P16_PCN = dict(type="PCN", num_pred=8192, encoder_channel=1024, grid_size=4)
P16_COARSE = dict(type="CoarsePCN", num_anchors=448, encoder_channel=1024)
P16_DC = dict(type="DiffuCompletion",
              diffusion=dict(type="PointDiffusion",
                             net=dict(type="PointwiseNet", point_dim=3, context_dim=512),
                             beta_1=1e-4, beta_T=0.02),
              sampler=dict(type="Uniform"), num_timesteps=P16_T, encoder_channel=512,
              npoints=2048)
P16_FLOW = dict(type="PointFlow", encoder=dict(type="PointNetV2", zdim=128, point_dim=3),
                point_cnf=dict(dims=(256, 256, 256), steps=20),
                latent_cnf=dict(dims=(256, 256), steps=10),
                part_aligner=dict(type="PartAlignerTransformer", in_channels=128,
                                  out_channels=6, n_class=4, n_heads=8, d_head=32, depth=2,
                                  single_attn=True, class_cond=True, add_class_cond=True),
                zdim=128, n_class=4)


def p16_ldm_cfg(single_attn):
    """LatentDiffEdit on PointNet codes with an LDMNet of P16_LDM_DEPTH
    blocks: two-attention at inner 256 (8 x 32) or flat at 128 (8 x 16)."""
    net = dict(type="LDMNet", in_channels=256, out_channels=256, n_heads=8,
               d_head=16 if single_attn else 32, depth=P16_LDM_DEPTH,
               context_dim=256 + P16_TEXT, n_class=4, single_attn=single_attn)
    return dict(type="LatentDiffEdit", encoder=dict(type="PointNet", zdim=256, point_dim=7),
                diffusion=dict(type="LDM", net=net, beta_1=1e-4, beta_T=0.02),
                sampler=dict(type="Uniform"),
                language_encoder=dict(type="LSTM", text_dim=P16_TEXT), num_anchors=4,
                num_timesteps=P16_T)


def p16_ldm_build(cfg, where):
    """The editor of ``cfg`` with its LDMNet's zero-initialised proj_out
    given N(0, 0.05^2) weights from a seeded CPU generator (the same on the
    card and the CPU), so that a chain reads what the blocks compute."""
    model = p15_build(cfg, where)
    kernel = model.net.proj_out.kernel
    with torch.no_grad():
        kernel.copy_(0.05 * torch.randn(kernel.shape, generator=torch.Generator().manual_seed(16)))
    return model


def p16_pt_cfg():
    """ParameterTrainer on bench_train_tpu's part encoder."""
    from difffacto_torch import Config

    enc = Config(os.path.join(ROOT, RUNNER_CONFIG)).model.dump()["encoder"]
    return dict(type="ParameterTrainer", encoder=enc, num_anchors=4, npoints=2048)


def p16_lang_batch(B, seed, where):
    """The target and distractor clouds of SyntheticLanguagePart's triplets
    with their part maps, the prompt and the part it names, and the editors'
    draws injected: the LSTM's dropout keep mask, t and the chain's noise."""
    from difffacto_torch.data import SyntheticLanguagePart

    loader, _ = SyntheticLanguagePart(batch_size=B, npoints=2048, size=B, shuffle=False)
    b = next(iter(loader))
    rng = np.random.RandomState(seed)
    out = dict(target=b["input"][:, 0], distractor=b["input"][:, 2],
               target_attn_map=b["attn_map"][:, 0], distractor_attn_map=b["attn_map"][:, 2],
               part_indicator=b["part_indicator"], text=b["text"],
               text_keep=rng.rand(B, b["text"].shape[1], 100) >= 0.5,
               diffusion_t=rng.randint(0, P16_T, (B,)).astype(np.int64),
               diffusion_noise=rng.randn(B, 4, 256).astype(np.float32))
    return {k: torch.as_tensor(np.ascontiguousarray(v), device=where) for k, v in out.items()}


def p16_cloud_batch(B, seed, where):
    """p15_cloud_batch with the part code's draw and the projection's
    dropout keep mask injected too."""
    out = p15_cloud_batch(B, seed, where)
    rng = np.random.RandomState(seed + 1)
    out["part_code_eps"] = torch.as_tensor(rng.randn(B, 4, 256).astype(np.float32), device=where)
    out["projection_keep"] = torch.as_tensor(rng.rand(B, 4, 256) >= 0.2, device=where)
    return out


def p16_flow_batch(B, seed, where, points=2048):
    """A SyntheticPart batch of ``points`` points with PointFlow's posterior
    draw injected."""
    from difffacto_torch.data import SyntheticPart
    from difffacto_torch.runner.runner import device_batch

    loader, _ = SyntheticPart(batch_size=B, npoints=points, size=B, shuffle=False)
    out = device_batch(next(iter(loader)), where)
    eps = np.random.RandomState(seed).randn(B, 4, 128).astype(np.float32)
    out["latent_eps"] = torch.as_tensor(eps, device=where)
    return out


def p16_sum(*counts):
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def p16_timed(dev, fn):
    """(fn(), seconds, launches) with the counts set to 0 just before."""
    mg_counts(zero=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, mg_counts()


def p16_ctx(model, b):
    """The edit's context: the distractor's part latents and the text
    feature on each of the 4 part tokens, (B, 4, 256 + P16_TEXT)."""
    codes = model.encode_pair(b["target"], b["distractor"], b["target_attn_map"],
                              b["distractor_attn_map"])
    tfeat = model.language_enc(b["text"])[0]
    B = codes.shape[0]
    return torch.cat([codes[:, 1], tfeat[:, None].expand(B, 4, tfeat.shape[-1])], dim=-1)


def p16_sample(model, ctx, **kw):
    """LatentDiffEdit's chain and net over part latents from zero anchors."""
    anchors = torch.zeros(ctx.shape[0], 4, 256, device=ctx.device)
    return model.diff.p_sample_loop(lambda i, ts, c, *a: model.net(i, ts, c, *a), anchors,
                                    ctx=ctx, **kw)["pred"]


def hold_ff_path(rec, label):
    """Fail unless each fused-FF launch the path made agrees with its plain
    version: the kernel at the launch's (T, D) on |4|-scale operands by
    hold_bf16, and the launch itself by hold_bf16's tolerances scaled with
    its largest output over 4 (bf16's rounding grows with the magnitude).
    Returns the largest difference."""
    from difffacto_torch.ops import fused_ff as ff

    err = 0.0
    for (T, D), (args, _, out) in rec.launches("fused_ln_geglu_ff", label):
        with torch.inference_mode():
            ops = ff_operands(D, T, out.device, seed=T)
            err = max(err, hold_bf16(f"fused_ff at {label}'s T={T} D={D} on |4|-scale operands",
                                     ff.fused_ln_geglu_ff(*ops),
                                     ff.fused_ln_geglu_ff_reference(*ops)))
            want = ff.fused_ln_geglu_ff_reference(*args).float()
        diff = (out.float() - want).abs()
        scale = max(1.0, want.abs().max().item() / 4.0)
        print(f"fused_ff as {label} launched it, T={T} D={D}: max abs err "
              f"{diff.max().item():.4e} (tol {KERNEL_MAX_ABS * scale:.4g}), mean "
              f"{diff.mean().item():.4e} (tol {KERNEL_MEAN_ABS * scale:.4g}), largest |output| "
              f"{want.abs().max().item():.4g}")
        if (not torch.isfinite(out.float()).all() or diff.max().item() > KERNEL_MAX_ABS * scale
                or diff.mean().item() > KERNEL_MEAN_ABS * scale):
            fail(f"fused_ff as {label} launched it disagrees with its plain version")
        err = max(err, diff.max().item())
    return err


def p16_ldm(dev):
    """(a): LDMNet sampling in both block layouts; the fused FF's launches
    held; a P16_CHECK-row chain (no kernel on either side) and, through the
    kernel, a P16_CHAIN_CHECK-row chain against the CPU."""
    from difffacto_torch.nn import layers

    out, launches = {}, []
    lang = p16_lang_batch(P16_SAMPLE_BATCH, 160, dev)
    for single in (False, True):
        label = "LDMNet, flat blocks (inner 128)" if single else \
            "LDMNet, two-attention blocks (inner 256)"
        cfg = p16_ldm_cfg(single)
        model = p16_ldm_build(cfg, dev)
        with torch.inference_mode():
            ctx = p16_ctx(model, lang)
        rec = KernelRecorder((layers, "fused_ln_geglu_ff"))
        gen = torch.Generator(device=dev).manual_seed(16)

        def run():
            with rec, torch.inference_mode():
                return p16_sample(model, ctx, generator=gen)
        pred, secs, counts = p16_timed(dev, run)
        expected = only() if single else only(fused_ff=P16_T * P16_LDM_DEPTH)
        print(f"{label}: {P16_SAMPLE_BATCH} x 4 x 256 latents, T = {P16_T}: {secs:.2f} s, "
              f"launches {counts}")
        if counts != expected or tuple(pred.shape) != (P16_SAMPLE_BATCH, 4, 256) or \
                not torch.isfinite(pred).all():
            fail(f"{label} launched {counts} (expected {expected}) or gave non-finite latents")
        launches.append(counts)
        res = dict(s=secs, launches=counts)
        if not single:
            res["ff_err"] = hold_ff_path(rec, label)
        checks = [(P16_CHECK, P14_PREDICT_REL_L2)] + ([] if single else
                                                    [(P16_CHAIN_CHECK, E2E_REL_L2)])
        for rows, tol in checks:
            rng = np.random.RandomState(161 + rows)
            draws = dict(noise=rng.randn(rows, 4, 256), step_noise=rng.randn(P16_T, rows, 4, 256))
            runs = {}
            for key, where in (("card", dev), ("cpu", "cpu")):
                m = model if key == "card" else p16_ldm_build(cfg, "cpu")
                d = {k: torch.as_tensor(v, dtype=torch.float32, device=where)
                     for k, v in draws.items()}
                with torch.inference_mode():
                    runs[key] = p16_sample(m, ctx[:rows].to(where), **d)
            res[f"rel_l2_{rows}_rows"] = p15_rel(f"{label}, a {rows}-row chain", runs["card"],
                                                 runs["cpu"], tol)
        out["flat" if single else "two_attn"] = res
        del model, rec
        torch.cuda.empty_cache()
    out["launches"] = p16_sum(*launches)
    return out


def p16_editors(dev):
    """(b): each editor model's steps and its step against the CPU."""
    out, launches = {}, []
    runs = (("LatentDiffEdit", p16_ldm_cfg(False), p16_lang_batch, P15_CHECK_STEP),
            ("PartLatentEditor", P16_PLE, p16_lang_batch, P15_CHECK_STEP),
            ("ParameterTrainer", p16_pt_cfg(), p16_cloud_batch, P15_CHECK_STEP),
            ("Aligner", P16_ALIGNER, p16_cloud_batch, P16_ALIGNER_CHECK),
            ("PartglotFinetune", P16_FINETUNE, p16_lang_batch, P15_CHECK_STEP))
    for name, cfg, batch_fn, check in runs:
        model = p15_build(cfg, dev)
        losses, step_ms, counts = p15_steps(dev, name, model, batch_fn, only())
        del model
        torch.cuda.empty_cache()
        held = p15_step_against_cpu(dev, name, lambda w, cfg=cfg: p15_build(cfg, w), batch_fn,
                                    batch=check)
        out[name] = dict(losses=losses, step_ms=step_ms, **held)
        launches.append(counts)
    out["launches"] = p16_sum(*launches)
    return out


def p16_supseg(dev, refs):
    """(c): AnchorDiffGenSuperSegments' steps, predict scored by the
    protocol, get_params, combine_latent, interpolate_latent and
    anchor_drift; a step and a predict of P16_CHECK shapes against the CPU."""
    label = "AnchorDiffGenSuperSegments"
    model = p15_build(P16_SUPSEG, dev)
    losses, step_ms, train_counts = p15_steps(dev, label, model, p16_cloud_batch, only())
    batch = p16_cloud_batch(P15_SHAPES, 162, dev)
    gen = torch.Generator(device=dev).manual_seed(16)
    pred, predict_s, counts = p16_timed(dev, lambda: model.predict(batch, gen)["pred"])
    print(f"{label}.predict, {P15_SHAPES} shapes: {predict_s:.2f} s, launches {counts}")
    if counts != only() or tuple(pred.shape) != (P15_SHAPES, 2048, 3) or \
            not torch.isfinite(pred).all():
        fail(f"{label}.predict launched {counts} or gave non-finite samples")
    scored = p15_protocol(dev, f"{label}'s samples", pred.float().cpu().numpy(), refs)
    M = P16_METHOD_SHAPES
    few = {k: v[:M] for k, v in batch.items()
           if torch.is_tensor(v) and v.ndim and v.shape[0] == P15_SHAPES}
    methods = (("get_params", lambda: model.get_params(few)[0], (M, 4, 3)),
               ("combine_latent", lambda: model.combine_latent(few, [3, 0, 2, 1], gen)["pred"],
                (1, 2048, 3)),
               ("interpolate_latent", lambda: model.interpolate_latent(
                   few, 0, 1, 2, P16_INTERP_STEPS, gen)["pred"], (P16_INTERP_STEPS, 2048, 3)),
               ("anchor_drift", lambda: model.anchor_drift(few, P16_DRIFT, generator=gen)["pred"],
                (M, P16_DRIFT, 2048, 3)))
    times = {}
    for name, fn, shape in methods:
        with torch.inference_mode():
            got, times[name], c = p16_timed(dev, fn)
        print(f"{label}.{name} on {M} shapes: {times[name]:.2f} s, launches {c}, "
              f"{tuple(got.shape)}")
        if c != only() or tuple(got.shape) != shape or not torch.isfinite(got).all():
            fail(f"{label}.{name} launched {c} or gave {tuple(got.shape)} non-finite values")
    del model
    torch.cuda.empty_cache()
    held = p15_step_against_cpu(dev, label, lambda w: p15_build(P16_SUPSEG, w), p16_cloud_batch)
    rng = np.random.RandomState(163)
    draws = dict(noise=rng.randn(P16_CHECK, 2048, 3),
                 step_noise=rng.randn(P16_T, P16_CHECK, 2048, 3))
    preds = {}
    for key, where in (("card", dev), ("cpu", "cpu")):
        m = p15_build(P16_SUPSEG, where)
        d = {k: torch.as_tensor(v, dtype=torch.float32, device=where) for k, v in draws.items()}
        preds[key] = m.predict({k: v[:P16_CHECK].to(where) for k, v in few.items()}, **d)["pred"]
        del m
    rel = p15_rel(f"{label}.predict, {P16_CHECK} shapes", preds["card"], preds["cpu"],
                  P14_PREDICT_REL_L2)
    return dict(launches=p16_sum(train_counts, counts, scored["launches"]), losses=losses,
                step_ms=step_ms, predict_s=predict_s, rel_l2=rel, scored=scored,
                **{f"{k}_s": v for k, v in times.items()}, **held)


def p16_crop_batch(dev, seed, gt_points=None):
    """One CroppingDataLoader batch of P16_CROP_BATCH SyntheticPart clouds
    of CROP_POINTS points at CROP_RANGE: (whole clouds, partial clouds of
    2048 points, and with ``gt_points`` the whole clouds' FPS to that many),
    each FPS launch held index for index against the plain version;
    returns the launches and seconds too."""
    from difffacto_torch.data import CroppingDataLoader, SyntheticPart
    from difffacto_torch.ops import fps as fpsm
    from difffacto_torch.ops import points

    loader, _ = SyntheticPart(batch_size=P16_CROP_BATCH, npoints=CROP_POINTS,
                              size=P16_CROP_BATCH, shuffle=False)
    crop = CroppingDataLoader(loader, crop=CROP_RANGE, seed=seed, device=dev)
    rec = KernelRecorder((points, "furthest_point_sample"))

    def run():
        with rec:
            b = next(iter(crop))
            full = torch.as_tensor(b["input"], device=dev)
            gt = points.fps(full, gt_points) if gt_points else full
        return full, b["partial"], gt
    (full, partial, gt), secs, counts = p16_timed(dev, run)
    want = only(fps=3 if gt_points else 2)
    if counts != want or tuple(partial.shape) != (P16_CROP_BATCH, 2048, 3):
        fail(f"a cropping batch launched {counts} (expected {want}) or gave a partial cloud of "
             f"{tuple(partial.shape)}")
    for (B, N), (args, _, got) in rec.launches("furthest_point_sample", "the cropping batch"):
        if not torch.equal(got, fpsm.furthest_point_sample_reference(*args)):
            fail(f"FPS as the cropping batch launched it, {B} x {N}, chose other points than its "
                 "plain version")
    return full, partial, gt, counts, secs


def p16_completion(dev):
    """(d): PCN, CoarsePCN and DiffuCompletion: steps on a cropping batch
    each, DiffuCompletion's reconstruct, a step of each against the CPU."""
    out, launches = {}, []
    for name, cfg in (("PCN", P16_PCN), ("CoarsePCN", P16_COARSE), ("DiffuCompletion", P16_DC)):
        dc = name == "DiffuCompletion"
        full, partial, gt, counts, crop_s = p16_crop_batch(dev, 16, 2048 if dc else None)
        launches.append(counts)

        def batch_fn(B, seed, where, gt=gt, partial=partial, dc=dc):
            b = {"ref": gt[:B].to(where), "input": partial[:B].to(where)}
            if dc:
                rng = np.random.RandomState(seed)
                b["diffusion_t"] = torch.as_tensor(rng.randint(0, P16_T, (B,)), device=where)
                b["diffusion_noise"] = torch.as_tensor(rng.randn(B, 2048, 3).astype(np.float32),
                                                       device=where)
            return b
        model = p15_build(cfg, dev)
        losses, step_ms, c = p15_steps(dev, name, model, batch_fn, only(), batch=P16_CROP_BATCH)
        launches.append(c)
        res = dict(losses=losses, step_ms=step_ms, crop_s=crop_s)
        if dc:
            gen = torch.Generator(device=dev).manual_seed(16)
            pred, res["reconstruct_s"], c = p16_timed(
                dev, lambda: model.reconstruct({"ref": gt, "input": partial}, gen)["pred"])
            print(f"DiffuCompletion.reconstruct, {P16_CROP_BATCH} partial clouds: "
                  f"{res['reconstruct_s']:.2f} s, launches {c}")
            if c != only() or tuple(pred.shape) != (P16_CROP_BATCH, 2048, 3) or \
                    not torch.isfinite(pred).all():
                fail(f"DiffuCompletion.reconstruct launched {c} or gave non-finite clouds")
        del model
        torch.cuda.empty_cache()
        res.update(p15_step_against_cpu(dev, name, lambda w, cfg=cfg: p15_build(cfg, w), batch_fn,
                                        batch=P16_COMPLETION_CHECK))
        out[name] = res
    out["launches"] = p16_sum(*launches)
    return out


def p16_pointflow(dev):
    """(e): PointFlow's sample and steps at the JAX class's defaults, peak
    memory; a step and a sample against the CPU at a small size."""
    model = p15_build(P16_FLOW, dev)
    gen = torch.Generator(device=dev).manual_seed(16)
    (z, pts), sample_s, counts = p16_timed(dev, lambda: model.sample(P16_FLOW_SAMPLE, 2048,
                                                                      generator=gen))
    print(f"PointFlow.sample, {P16_FLOW_SAMPLE} x 2048: {sample_s:.2f} s, launches {counts}")
    if counts != only() or tuple(pts.shape) != (P16_FLOW_SAMPLE, 2048, 3) or \
            not torch.isfinite(pts).all():
        fail(f"PointFlow.sample launched {counts} or gave non-finite points")
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, train_counts = p15_steps(dev, "PointFlow", model, p16_flow_batch, only(),
                                              steps=P16_FLOW_STEPS, batch=P16_FLOW_BATCH)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"PointFlow training at batch {P16_FLOW_BATCH} x 2048: peak {peak:.2f} GiB")
    del model
    torch.cuda.empty_cache()
    small = lambda B, seed, where: p16_flow_batch(B, seed, where, P16_FLOW_CHECK_POINTS)  # noqa: E731
    held = p15_step_against_cpu(dev, "PointFlow", lambda w: p15_build(P16_FLOW, w), small,
                                batch=P16_FLOW_CHECK_BATCH)
    rng = np.random.RandomState(164)
    draws = dict(w=rng.randn(P16_CHECK, 4, 128), y=rng.randn(P16_CHECK, P16_FLOW_CHECK_POINTS, 3))
    runs = {}
    for key, where in (("card", dev), ("cpu", "cpu")):
        m = p15_build(P16_FLOW, where)
        d = {k: torch.as_tensor(v, dtype=torch.float32, device=where) for k, v in draws.items()}
        runs[key] = m.sample(P16_CHECK, P16_FLOW_CHECK_POINTS, **d)[1]
        del m
    rel = p15_rel(f"PointFlow.sample, {P16_CHECK} x {P16_FLOW_CHECK_POINTS}", runs["card"],
                  runs["cpu"], P14_PREDICT_REL_L2)
    return dict(launches=p16_sum(counts, train_counts), sample_s=sample_s, losses=losses,
                step_ms=step_ms, peak_gib=peak, rel_l2=rel, **held)


def phase16(dev, refs):
    """Phase 16: the latent editors, the super-segment generator, completion
    and PointFlow; returns each path's numbers and the launches of the whole
    phase."""
    t_phase = time.perf_counter()
    out = {"ldm": p16_ldm(dev), "editors": p16_editors(dev), "supseg": p16_supseg(dev, refs),
           "completion": p16_completion(dev), "pointflow": p16_pointflow(dev)}
    paths = list(out)
    out["launches"] = p16_sum(*(out[p]["launches"] for p in paths))
    out["s"] = time.perf_counter() - t_phase
    held = {f"{p}.{m}_{k}": out[p][m][k] for p, names in (
        ("editors", ("LatentDiffEdit", "PartLatentEditor", "ParameterTrainer", "Aligner",
                     "PartglotFinetune")),
        ("completion", ("PCN", "CoarsePCN", "DiffuCompletion")))
        for m in names for k in ("loss_rel", "update_rel", "grad_norm_rel")}
    held.update({f"{p}_{k}": out[p][k] for p in ("supseg", "pointflow")
                 for k in ("loss_rel", "update_rel", "grad_norm_rel", "rel_l2")})
    print("phase 16 readings: " + json.dumps({
        "seconds": round(out["s"], 1),
        "ldm_two_attn_s": out["ldm"]["two_attn"]["s"], "ldm_flat_s": out["ldm"]["flat"]["s"],
        "ldm_rel_l2": {k: v for layout in ("two_attn", "flat")
                       for k, v in out["ldm"][layout].items() if k.startswith("rel_l2")},
        "ldm_ff_err": out["ldm"]["two_attn"]["ff_err"],
        "editor_step_ms": {m: out["editors"][m]["step_ms"] for m in out["editors"]
                           if m != "launches"},
        "supseg_step_ms": out["supseg"]["step_ms"], "supseg_predict_s": out["supseg"]["predict_s"],
        "supseg_metrics": out["supseg"]["scored"]["metrics"],
        "completion_step_ms": {m: out["completion"][m]["step_ms"] for m in out["completion"]
                               if m != "launches"},
        "diffu_completion_reconstruct_s": out["completion"]["DiffuCompletion"]["reconstruct_s"],
        "pointflow_sample_s": out["pointflow"]["sample_s"],
        "pointflow_step_ms": out["pointflow"]["step_ms"],
        "pointflow_peak_gib": out["pointflow"]["peak_gib"],
        "held_against_cpu": held, "tolerances": dict(
            P14_LOSS_RTOL=P14_LOSS_RTOL, P14_UPDATE_REL=P14_UPDATE_REL,
            P14_GNORM_RTOL=P14_GNORM_RTOL, P14_PREDICT_REL_L2=P14_PREDICT_REL_L2,
            E2E_REL_L2=E2E_REL_L2),
        "launches": {p: out[p]["launches"] for p in paths}}))
    print(f"phase 16: {out['s']:.1f} s")
    return out


# Phase 17: B1's fused tail and the two switches, data/custom.py's ten
# DATASETS and the data tools. (a) Both tail entries (proj_out 128 x 3 fused)
# against their plain versions at B = 256, N = 2048 with parts absent and at
# a ragged N, timed beside the entry without the tail and beside that entry
# followed by proj_out as the denoiser applies it. (b) gen_chair generation
# under DIFFFACTO_FUSE_TAIL=1 (100 tail launches, the first held), a batch-1
# run against the CPU, and shapes/s with and without the switch in turns
# (default, tail, tail, default, P17_TIMED runs a slot); under
# DIFFFACTO_FUSE_HEAD=0, with and without the tail, 100 launches of the
# head-less entries, the first held. (c) The data tools on files the phase
# writes: process_data_torch.py and fps_shape_torch.py on P17_TOOL_CLOUDS
# dense clouds of P17_TOOL_POINTS points, extract_parts_torch.py on a dump of
# P17_DUMP_SHAPES of phase 5's generated shapes; each on the card and with
# --cpu, the outputs equal. (d) Every DATASETS key of data/custom.py built
# from such files with one batch read; ShapeNet-55 (P17_SN55 clouds of 8192
# points) through its cropping loader into P15_STEPS DiffuCompletion steps
# (its FPS launches held index for index), the gen_chair dump through
# CustomDataset into MixingRunner.mixing (100 trunk launches, the first
# held), process_data_torch.py's npz through Partnet into 2 training steps
# of the gen_chair Runner at batch P17_BATCH (one B2 and one B3 each, the
# first held).
P17_TIMED, P17_TOOL_CLOUDS, P17_TOOL_POINTS, P17_DUMP_SHAPES = 2, 32, 10000, 32
P17_SN55, P17_SN55_POINTS, P17_BATCH, P17_OUT = 32, 8192, 32, 3
P17_READ_BATCH = 8  # the batch of the DATASETS read once and fed to nothing
DATASET_KEYS = ("CustomDataset", "PartglotTriplet", "Partnet", "ShapeNet", "ShapeNetPart",
                "ShapeNetParts", "ShapeNetSegSuperSegment", "ShapeNetSegSuperSegmentParglot",
                "ShapeNetSupSeg", "ShapeNetSupSegPartglot")
TAIL_ENTRIES = ("fused_core_tail", "fused_core_headless_tail")


def switches(head="1", tail=""):
    """Set DIFFFACTO_FUSE_HEAD and DIFFFACTO_FUSE_TAIL (the defaults unset them)."""
    for name, value, default in (("DIFFFACTO_FUSE_HEAD", head, "1"),
                                 ("DIFFFACTO_FUSE_TAIL", tail, "")):
        if value == default:
            os.environ.pop(name, None)
        else:
            os.environ[name] = value


def entry_reference(name, args):
    """The plain version of a recorded launch of ``name`` (the denoiser
    passes every operand, then the scale, by position)."""
    from difffacto_torch.ops import fused_core as fc

    if name == "fused_core_tail":
        return fc.fused_core_reference(*args[:21], args[23], pout_w=args[21], pout_b=args[22])
    if name == "fused_core_headless_tail":
        return fc.fused_core_reference(args[0], None, None, *args[1:19], args[21],
                                       pout_w=args[19], pout_b=args[20])
    if name == "fused_core_headless":
        return fc.fused_core_reference(args[0], None, None, *args[1:])
    return fc.fused_core_reference(*args)


def p17_kernels(dev):
    """(a): each tail entry held and timed; returns their numbers."""
    from difffacto_torch.ops import fused_core as fc

    rng = np.random.RandomState(17)
    pw = torch.as_tensor(rng.randn(fc.D, P17_OUT) * fc.D**-0.5, dtype=torch.bfloat16, device=dev)
    pb = torch.as_tensor(0.1 * rng.randn(P17_OUT), dtype=torch.float32, device=dev)
    mask = np.ones((BATCH_TIMED, 4), np.float32)
    mask[1::3, 1] = mask[BATCH_TIMED - 1, 2] = 0.0
    out = {}
    with uncounted("fused_core", "fused_core_headless", "fused_core_tail",
                   "fused_core_headless_tail"):
        for name, head in (("fused_core_tail", True), ("fused_core_headless_tail", False)):
            err = 0.0
            for B, N, m in ((2, 1000, [[1, 1, 0, 1], [1, 1, 1, 1]]), (BATCH_TIMED, 2048, mask)):
                ops = fc.operands(fc.example_inputs(B, N, depth=5, in_ch=13 if head else fc.D,
                                                    seed=N + head, mask=m), dev, torch.bfloat16)
                if not head:
                    ops = [ops[0]] + ops[3:]
                entry = getattr(fc, name)
                got = entry(*ops, pw, pb, 0.25)
                torch.cuda.synchronize()
                want = entry_reference(name, ops + [pw, pb, 0.25])
                if tuple(got.shape) != (B, N, P17_OUT):
                    fail(f"{name} gave {tuple(got.shape)}")
                err = max(err, hold_bf16(f"{name} B={B} N={N} OUT={P17_OUT}", got, want))
            bare = fc.fused_core if head else fc.fused_core_headless
            pb16 = pb.to(torch.bfloat16)
            runs = {"tail": lambda: entry(*ops, pw, pb, 0.25), "trunk": lambda: bare(*ops, 0.25),
                    "trunk_and_proj_out": lambda: bare(*ops, 0.25) @ pw + pb16}
            times = {k: [] for k in runs}
            for k in ("trunk", "trunk_and_proj_out", "tail", "tail", "trunk_and_proj_out", "trunk"):
                times[k].append(cuda_ms(runs[k], 20))
            ms = {k: float(np.mean(v)) for k, v in times.items()}
            plain_ms = cuda_ms(lambda: entry_reference(name, ops + [pw, pb, 0.25]), 3)
            bound, by = trunk_bound_ms(ops + [pw, pb], BATCH_TIMED * 2048 * P17_OUT * 2,
                                       in_ch=13 if head else 0, depth=5, out_ch=P17_OUT)
            out[name] = dict(max_abs_err=err, ms=ms["tail"], plain_ms=plain_ms, bound_ms=bound,
                             bound_by=by, trunk_ms=ms["trunk"],
                             trunk_and_proj_out_ms=ms["trunk_and_proj_out"])
            print(f"{name} B={BATCH_TIMED} N=2048 OUT={P17_OUT}: {ms['tail']:.3f} ms, bound "
                  f"{bound:.3f} ms ({by}), {100 * bound / ms['tail']:.1f}% of roofline; without "
                  f"the tail {ms['trunk']:.3f} ms, and with proj_out after it "
                  f"{ms['trunk_and_proj_out']:.3f} ms (in turns, 20 launches each); plain "
                  f"version {plain_ms:.3f} ms")
            del ops
    torch.cuda.empty_cache()
    return out


def p17_generation(dev, noise_scale):
    """(b): the switches on gen_chair's generation; returns their numbers."""
    from difffacto_torch import sample_generation
    from difffacto_torch.models import denoiser

    model = build_model(noise_scale, dev)
    T = model.num_timesteps
    res = {}

    def generate(B, seed):
        return sample_generation(model, B, valid_id=torch.ones(B, 4, device=dev),
                                 generator=torch.Generator(device=dev).manual_seed(seed))["pred"]

    try:
        for label, head, tail, name in (("DIFFFACTO_FUSE_TAIL=1", "1", "1", "fused_core_tail"),
                                        ("DIFFFACTO_FUSE_HEAD=0", "0", "", "fused_core_headless"),
                                        ("DIFFFACTO_FUSE_HEAD=0 DIFFFACTO_FUSE_TAIL=1", "0", "1",
                                         "fused_core_headless_tail")):
            switches(head, tail)
            rec = KernelRecorder((denoiser, name))
            with rec:
                pred, secs, counts = p16_timed(dev, lambda: generate(BATCH_TIMED, 17))
            print(f"gen_chair under {label}, batch {BATCH_TIMED}: {secs:.3f} s, launches {counts}")
            if counts != only(**{name: T}) or tuple(pred.shape) != (BATCH_TIMED, 2048, 3) \
                    or not torch.isfinite(pred).all():
                fail(f"generation under {label} launched {counts} (expected {T} of {name}) or "
                     "gave non-finite shapes")
            (B, N), (args, _, got) = rec.launches(name, label)[0]
            with torch.inference_mode():
                want = entry_reference(name, args)
            res[f"{name}_err"] = hold_bf16(f"{name} as generation under {label} launched it, "
                                           f"B={B} N={N}", got, want)
            res[f"{name}_launches"] = counts[name]
            del rec, args, got, want, pred

        # Batch 1 under the tail switch, every draw injected, against the CPU.
        switches("1", "1")
        rng = np.random.RandomState(170)
        draws = dict(z=rng.randn(1, 4, 256), cimle_noise=rng.randn(1, 32),
                     noise=rng.randn(1, 2048, 3), step_noise=rng.randn(T, 1, 2048, 3))
        runs = {}
        for key, where, m in (("card", dev, model), ("cpu", "cpu", build_model(noise_scale, "cpu"))):
            d = {k: torch.as_tensor(v, dtype=torch.float32, device=where) for k, v in draws.items()}
            runs[key] = sample_generation(
                m, 1, valid_id=torch.as_tensor([[1, 0, 1, 1]], dtype=torch.float32, device=where),
                **d)["pred"].float().cpu()
        rel = ((runs["card"] - runs["cpu"]).norm() / runs["cpu"].norm()).item()
        print(f"batch-1 generation under DIFFFACTO_FUSE_TAIL=1, card vs CPU plain trunk with the "
              f"tail: relative L2 {rel:.4e} (tol {E2E_REL_L2})")
        if not torch.isfinite(runs["card"]).all() or not rel <= E2E_REL_L2:
            fail("generation under DIFFFACTO_FUSE_TAIL=1 on the card disagrees with the CPU")
        res["tail_card_vs_cpu_rel_l2"] = rel

        # shapes/s with and without the tail, in turns, after a warm-up of each
        secs = {"default": [], "tail": []}
        for mode in ("default", "tail"):
            switches(tail="1" if mode == "tail" else "")
            generate(BATCH_TIMED, 18)
        for i, mode in enumerate(("default", "tail", "tail", "default")):
            switches(tail="1" if mode == "tail" else "")
            for j in range(P17_TIMED):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                generate(BATCH_TIMED, 19 + i * P17_TIMED + j)
                torch.cuda.synchronize()
                secs[mode].append(time.perf_counter() - t0)
        for mode, s in secs.items():
            res[f"{mode}_shapes_per_s"] = BATCH_TIMED / float(np.mean(s))
            res[f"{mode}_s_each"] = s
        print(f"gen_chair batch {BATCH_TIMED}, in turns (default, tail, tail, default; "
              f"{P17_TIMED} runs a turn): default {res['default_shapes_per_s']:.2f} shapes/s, "
              f"DIFFFACTO_FUSE_TAIL=1 {res['tail_shapes_per_s']:.2f} shapes/s; seconds "
              + json.dumps(secs))
    finally:
        switches()
    del model
    torch.cuda.empty_cache()
    return res


def p17_tools(dev, work, dump):
    """(c): each tool on the card and with --cpu; the outputs equal."""
    import runpy

    rng = np.random.RandomState(171)
    pts = (rng.randn(P17_TOOL_CLOUDS, P17_TOOL_POINTS, 3)
           * rng.uniform(0.3, 1.0, (P17_TOOL_CLOUDS, 1, 3))).astype(np.float32)
    labels = np.argmax(pts @ rng.randn(3, 4).astype(np.float32), -1)  # 4 regions a cloud
    dense = os.path.join(work, "dense.npz")
    np.savez(dense, points=pts, labels=labels)
    parts = np.load(dump)
    lengths = [int((parts["pred_seg_mask"][b] == k).sum()) for k in range(4)
               for b in range(len(parts["pred"]))]
    extract_launches = len({n for n in lengths if n >= 512})
    res = {}
    for tool, args, launches in (
            ("process_data_torch.py", ["--input", dense], 1),
            ("fps_shape_torch.py", ["--input", dense], 1),
            ("extract_parts_torch.py", ["--dump", dump, "--canonical"], extract_launches)):
        main = runpy.run_path(os.path.join(ROOT, "tools", tool), run_name="imported")["main"]
        outs = {}
        for where in ("card", "cpu"):
            path = os.path.join(work, f"{tool}.{where}.npz")
            _, secs, counts = p16_timed(dev, lambda: main(
                args + ["--output", path] + (["--cpu"] if where == "cpu" else [])))
            outs[where] = (dict(np.load(path)), secs, counts)
        (card, card_s, counts), (cpu, cpu_s, cpu_counts) = outs["card"], outs["cpu"]
        same = sorted(card) == sorted(cpu) and all(
            card[k].dtype == cpu[k].dtype and np.array_equal(card[k], cpu[k]) for k in cpu)
        print(f"{tool}: card {card_s:.2f} s (launches {counts}), --cpu {cpu_s:.2f} s, outputs "
              f"{ {k: v.shape for k, v in card.items()} } equal: {same}")
        if not same or counts != only(fps=launches) or cpu_counts != only():
            fail(f"{tool} on the card launched {counts} (expected {launches} FPS) or its output "
                 "differs from --cpu's")
        res[tool] = dict(card_s=card_s, cpu_s=cpu_s, launches=counts)
    res["launches"] = p16_sum(*(r["launches"] for r in res.values()))
    return res, dense


def p17_files(work, dump, packed):
    """The DATASETS' files: ShapeNet-55's list and clouds, the super-segment
    pickles, PartGlot's raw games and its packed triplets (the peer of
    tools/pack_partglot.py as a function of arrays: no h5py here), and
    Partnet's root holding process_data_torch.py's card output."""
    import pickle
    import runpy
    import shutil

    rng = np.random.RandomState(172)
    root = os.path.join(work, "ShapeNet55")
    os.makedirs(root)
    os.makedirs(os.path.join(work, "shapenet_pc"))
    names = [f"03001627-model{i}.npy" for i in range(P17_SN55)]
    for name in names:
        np.save(os.path.join(work, "shapenet_pc", name),
                (rng.randn(P17_SN55_POINTS, 3) * rng.uniform(0.3, 1.0, (1, 3))).astype(np.float32))
    for split in ("train", "test"):
        with open(os.path.join(root, f"{split}.txt"), "w") as f:
            f.write("\n".join(names))
    z = np.load(packed)
    supseg = os.path.join(work, "supseg")
    os.makedirs(supseg)
    attn = np.eye(4, dtype=np.float32)[z["labels"]] + 0.1 * rng.rand(*z["labels"].shape, 4)
    for stem, arr in (("pointcloud", z["points"]), ("label", attn.astype(np.float32))):
        with open(os.path.join(supseg, f"shapenet_{stem}_pn_aware.pkl"), "wb") as f:
            pickle.dump(arr, f)
    S, n_seg, npt = 32, 50, 512
    geos = rng.randn(S, n_seg, npt, 3).astype(np.float32)
    masks = (rng.rand(S, n_seg) > 0.2).astype(np.float32)
    with open(os.path.join(supseg, "partglot_shapenet_seg_out_pn_aware_raw.pkl"), "wb") as f:
        pickle.dump(dict(geos=geos, geos_masks=masks,
                         attn_maps=rng.rand(S, 4, n_seg).astype(np.float32)), f)
    pack = runpy.run_path(os.path.join(ROOT, "tools", "pack_partglot_torch.py"),
                          run_name="imported")["pack"]
    game = dict(text=["a chair with thick legs", "tall back", "wide seat and arms", "nice one"] * 4,
                target_chair=rng.randint(0, 3, 16), chair_a=rng.randint(0, S, 16),
                chair_b=rng.randint(0, S, 16), chair_c=rng.randint(0, S, 16))
    triplets, _ = pack(game, None, geos, masks, part_only=True)
    triplet = os.path.join(work, "triplets.npz")
    np.savez_compressed(triplet, **triplets)
    partnet = os.path.join(work, "partnet")
    os.makedirs(partnet)
    shutil.copyfile(packed, os.path.join(partnet, "partnet_train.npz"))
    return dict(sn55=root, supseg=supseg, triplet=triplet, partnet=partnet, packed=packed,
                dump=dump)


def p17_dataset_cfgs(files):
    B, R = P17_BATCH, P17_READ_BATCH
    return {
        "CustomDataset": dict(batch_size=B, path=files["dump"], npoints=2048),
        "ShapeNetParts": dict(batch_size=R, path=files["packed"], npoints=2048),
        "ShapeNetPart": dict(batch_size=R, root=files["packed"], npoints=2048),
        "Partnet": dict(batch_size=B, root=files["partnet"], npoints=2048),
        "PartglotTriplet": dict(batch_size=R, path=files["triplet"]),
        "ShapeNetSupSeg": dict(batch_size=R, data_root=files["supseg"], split="train",
                               augment=True),
        "ShapeNetSegSuperSegment": dict(batch_size=R, data_root=files["supseg"], split="train",
                                        contrastive_learning=True),
        "ShapeNetSupSegPartglot": dict(batch_size=R, data_root=files["supseg"], split="train"),
        "ShapeNetSegSuperSegmentParglot": dict(batch_size=R, path=files["packed"],
                                               npoints=2048),
        "ShapeNet": dict(batch_size=B, root=files["sn55"], npoints=P17_SN55_POINTS,
                         split="train", crop=(0.25, 0.75)),
    }


def p17_datasets(dev, files):
    """(d), first part: every key built through DATASETS, one batch each."""
    from difffacto_torch.utils.registry import DATASETS, build_from_cfg

    if set(DATASETS._modules) < set(DATASET_KEYS):
        fail(f"DATASETS lacks {sorted(set(DATASET_KEYS) - set(DATASETS._modules))}")
    shapes, loaders = {}, {}
    for key, cfg in p17_dataset_cfgs(files).items():
        t0 = time.perf_counter()
        loader, sampler = build_from_cfg(dict(cfg, type=key), DATASETS, device=dev)
        batch = next(iter(loader.loader if key == "ShapeNet" else loader))
        arrays = {k: np.asarray(v) for k, v in batch.items()
                  if isinstance(v, np.ndarray) and v.dtype != object}
        if sampler is not None or not arrays or not all(
                np.isfinite(a).all() for a in arrays.values() if a.dtype.kind == "f"):
            fail(f"DATASETS {key}: sampler {sampler}, or a batch without finite arrays")
        shapes[key] = {k: list(a.shape) for k, a in sorted(arrays.items())[:4]}
        shapes[key]["s"] = time.perf_counter() - t0
        loaders[key] = loader
    print("DATASETS, one batch each (the first keys' shapes, seconds): " + json.dumps(shapes))
    return loaders


def p17_completion(dev, loader):
    """ShapeNet-55's cropping loader on the card into DiffuCompletion steps."""
    from difffacto_torch.ops import fps as fpsm
    from difffacto_torch.ops import points

    rec = KernelRecorder((points, "furthest_point_sample"))

    def crop():
        with rec:
            b = next(iter(loader))
            full = torch.as_tensor(b["input"], device=dev)
            return b["partial"], points.fps(full, 2048)
    (partial, gt), crop_s, counts = p16_timed(dev, crop)
    if counts != only(fps=3) or tuple(partial.shape) != (P17_BATCH, 2048, 3) \
            or partial.device.type != dev.type:
        fail(f"ShapeNet's cropping batch launched {counts} (expected 3 FPS) or gave "
             f"{tuple(partial.shape)} on {partial.device}")
    for (B, N), (args, _, got) in rec.launches("furthest_point_sample", "ShapeNet's crop"):
        if not torch.equal(got, fpsm.furthest_point_sample_reference(*args)):
            fail(f"FPS as ShapeNet's cropping launched it, {B} x {N}, chose other points")

    def batch_fn(B, seed, where):
        rng = np.random.RandomState(seed)
        return {"ref": gt[:B].to(where), "input": partial[:B].to(where),
                "diffusion_t": torch.as_tensor(rng.randint(0, P16_T, (B,)), device=where),
                "diffusion_noise": torch.as_tensor(rng.randn(B, 2048, 3).astype(np.float32),
                                                   device=where)}
    model = p15_build(P16_DC, dev)
    losses, step_ms, c = p15_steps(dev, "DiffuCompletion on ShapeNet-55's crops", model,
                                   batch_fn, only(), batch=P17_BATCH)
    del model
    torch.cuda.empty_cache()
    return dict(crop_s=crop_s, step_ms=step_ms, losses=losses, launches=p16_sum(counts, c))


def p17_mixing(dev, work, dump):
    """CustomDataset on the gen_chair dump into MixingRunner.mixing."""
    from difffacto_torch.config import Config
    from difffacto_torch.models import denoiser
    from difffacto_torch.runner import MixingRunner

    data = dict(_cover_=True, type="CustomDataset", batch_size=P17_BATCH, path=dump,
                npoints=2048, shuffle=False)
    cfg = write_config(work, "mixing17", work_dir=os.path.join(work, "mixing17"),
                       model=P14_MODEL, dataset=dict(train=data, val=data))
    runner = MixingRunner(cfg=Config(cfg), device=dev)
    rec = KernelRecorder((denoiser, "fused_core"))
    with rec:
        merged, secs, counts = p16_timed(dev, lambda: runner.mixing(seed=17))
    T = runner.model.num_timesteps
    print(f"MixingRunner.mixing on CustomDataset (the gen_chair dump, batch {P17_BATCH}): "
          f"{secs:.2f} s, launches {counts}")
    if counts != only(fused_core=T * len(runner.val_loader)) or \
            merged["pred"].shape != (P17_DUMP_SHAPES, 2048, 3) or \
            not np.isfinite(merged["pred"]).all():
        fail(f"MixingRunner.mixing on CustomDataset launched {counts} or gave "
             f"{merged['pred'].shape}")
    err = rec.hold_core("MixingRunner.mixing on CustomDataset")
    del runner
    torch.cuda.empty_cache()
    return dict(s=secs, core_err=err, launches=counts)


def p17_partnet(dev, work, root):
    """Partnet on process_data_torch.py's npz into 2 steps of the gen_chair Runner."""
    from difffacto_torch.config import Config
    from difffacto_torch.models import denoiser
    from difffacto_torch.runner import Runner

    data = dict(_cover_=True, type="Partnet", batch_size=P17_BATCH, root=root, npoints=2048,
                split="train")
    cfg = write_config(work, "partnet17", work_dir=os.path.join(work, "partnet17"),
                       max_epoch=2, cimle_cache_interval=None, eval_interval=None,
                       checkpoint_interval=None, log_interval=1,
                       dataset=dict(train=data, val=data))
    runner = Runner(cfg=Config(cfg), device=dev)
    rec = KernelRecorder((denoiser, "fused_trunk_train"))

    def two_epochs():
        with rec:
            for _ in range(2):
                runner.train_loader.set_epoch(runner.epoch)
                runner.train()
    _, secs, counts = p16_timed(dev, two_epochs)
    steps = 2 * len(runner.train_loader)
    recs = [json.loads(line) for line in open(os.path.join(runner.work_dir, "scalars.jsonl"))]
    losses = [r["total_loss"] for r in recs if "total_loss" in r]
    print(f"gen_chair Runner on Partnet (process_data_torch.py's npz), {steps} steps at batch "
          f"{P17_BATCH}: {secs:.2f} s, losses {losses}, launches {counts}")
    if counts != only(fused_trunk_train_fwd=steps, fused_trunk_train_bwd=steps) or \
            len(losses) != steps or not np.isfinite(losses).all():
        fail(f"the Runner on Partnet launched {counts} or logged {losses}")
    fwd, bwd = rec.hold_train("the Runner on Partnet")
    del runner
    torch.cuda.empty_cache()
    return dict(s=secs, losses=losses, train_errs=(fwd, bwd), launches=counts)


def phase17(dev, noise_scale, shapes):
    """Phase 17; ``shapes`` holds phase 5's generated shapes (pred,
    pred_seg_mask), of which P17_DUMP_SHAPES are dumped."""
    import tempfile

    t_phase = time.perf_counter()
    out = {"kernels": p17_kernels(dev), "generation": p17_generation(dev, noise_scale)}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as work:
        dump = os.path.join(work, "gen_chair_dump.npz")
        np.savez(dump, **{k: v[:P17_DUMP_SHAPES] for k, v in shapes.items()})
        out["tools"], dense = p17_tools(dev, work, dump)
        files = p17_files(work, dump, os.path.join(work, "process_data_torch.py.card.npz"))
        loaders = p17_datasets(dev, files)
        out["completion"] = p17_completion(dev, loaders["ShapeNet"])
        out["mixing"] = p17_mixing(dev, work, dump)
        out["partnet"] = p17_partnet(dev, work, files["partnet"])
    gen = out["generation"]
    launches = [out[p]["launches"] for p in ("tools", "completion", "mixing", "partnet")]
    launches.append(dict({k: 0 for k in mg_counts()}, **{
        name: gen[f"{name}_launches"] for name in
        ("fused_core_tail", "fused_core_headless", "fused_core_headless_tail")}))
    out["launches"] = p16_sum(*launches)
    out["s"] = time.perf_counter() - t_phase
    print("phase 17 readings: " + json.dumps({
        "seconds": round(out["s"], 1), "kernels": out["kernels"], "generation": gen,
        "tools": {k: v for k, v in out["tools"].items() if k != "launches"},
        "completion_step_ms": out["completion"]["step_ms"],
        "completion_crop_s": out["completion"]["crop_s"], "mixing_s": out["mixing"]["s"],
        "partnet_s": out["partnet"]["s"], "partnet_losses": out["partnet"]["losses"],
        "launches": out["launches"]}, default=float))
    print(f"phase 17: {out['s']:.1f} s")
    return out


# Phase 13. The global batches of the multi-GPU runs; the 3 training steps
# are held at phase 9's tolerances (loss, grad_norm, the mean update) against
# the same arithmetic on one rank, generation within E2E_REL_L2.
MG_TRAIN_BATCH, MG_TRAIN_STEPS, MG_GEN_BATCH, MG_SEED = 32, 3, 16, 1313
MG_RUN_TIMEOUT, MG_CLI_TIMEOUT = 420, 420
MG_CLI_OVERRIDES = dict(max_epoch=2, cimle_cache_interval=2, eval_interval=2,
                        checkpoint_interval=2, log_interval=1)


def mg_train_batch():
    """Phase 13's global training batch, numpy, with the diffusion draws
    injected (the stage-1 model draws nothing else at dropout 0)."""
    b = example_batch(MG_TRAIN_BATCH, 2048, seed=31)
    rng = np.random.RandomState(32)
    b["diffusion_t"] = rng.randint(0, 100, MG_TRAIN_BATCH).astype(np.int64)
    b["diffusion_noise"] = rng.randn(MG_TRAIN_BATCH, 2048, 3).astype(np.float32)
    return b


def mg_gen_draws(device, steps):
    """Every draw of a batch-16 generation: flow latents, the aligner's
    noise, x_T and each step's draw."""
    rng = np.random.RandomState(33)
    B = MG_GEN_BATCH
    d = dict(z=rng.randn(B, 4, 256), cimle_noise=rng.randn(B, 32), noise=rng.randn(B, 2048, 3),
             step_noise=rng.randn(steps, B, 2048, 3))
    valid = np.ones((B, 4), np.float32)
    valid[::3, 1] = 0.0
    out = {k: torch.as_tensor(v, dtype=torch.float32, device=device) for k, v in d.items()}
    out["valid_id"] = torch.as_tensor(valid, device=device)
    return out


def mg_counts(zero=False):
    """Every kernel's launches, set to 0 first with ``zero``."""
    if zero:
        zero_launches()
    return kernel_launches()


def mg_flat(tensors):
    return torch.cat([t.detach().float().reshape(-1) for t in tensors]).cpu()


def mg_train(mesh, steps, dev, reference_world=None):
    """``steps`` training steps at dropout 0 on phase 13's global batch, float32
    as the Runner builds: over ``mesh`` (this rank's slice), or, with
    ``reference_world``, that many ranks' arithmetic in turn on this one
    (each slice's loss and gradients from the same statistics, the means,
    one update). Returns the per-step metrics, ms a step, the parameters
    before and after (flat, on the host)."""
    from difffacto_torch.parallel import init_train_state, make_train_step, replicate, shard_batch
    from difffacto_torch.parallel.train import fold_rng

    model = build_train_model(dev, dropout=0.0, dtype=None)
    if mesh is not None:
        replicate(mesh, model)
    tx = build_train_optimizer()
    step = make_train_step(model, tx, mesh=mesh)
    state = init_train_state(model, tx)
    batch = mg_train_batch()
    before = mg_flat(model.parameters())
    local = to_device(shard_batch(mesh, batch) if mesh is not None else batch, dev)
    metrics, ms = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if reference_world is None:
            state, m = step(state, local, MG_SEED, 0)
        else:
            W = reference_world
            b = MG_TRAIN_BATCH // W
            start = [x.clone() for x in step.buffers]
            parts = []
            for d in range(W):
                for buf, s0 in zip(step.buffers, start):
                    buf.copy_(s0)
                sl = {k: v[d * b:(d + 1) * b] for k, v in local.items()}
                rng = fold_rng(MG_SEED, d) if W > 1 else MG_SEED
                parts.append(step.local(state, sl, rng, 0) + ([x.clone() for x in step.buffers],))
            with torch.no_grad():
                for buf, s0 in zip(step.buffers, [sum(p[3][i] for p in parts) / W
                                                  for i in range(len(start))]):
                    buf.copy_(s0)
            mean_m = {k: sum(p[1][k] for p in parts) / W for k in parts[0][1]}
            state, m = step.apply(state, sum(p[0] for p in parts) / W, mean_m,
                                  [sum(g) / W for g in zip(*(p[2] for p in parts))], start)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        metrics.append({k: float(v) for k, v in m.items()})
    after = mg_flat(model.parameters())
    del model, state, step
    torch.cuda.empty_cache()
    return dict(metrics=metrics, ms=ms, before=before, after=after)


def mg_generate(mesh, dev, noise_scale):
    """Phase 13's batch-16 generation, every draw injected, over ``mesh``
    (None: one rank): (pred on the host, seconds, the chain's steps)."""
    from difffacto_torch import sample_generation

    model = build_model(noise_scale, dev)
    steps = model.num_timesteps
    d = mg_gen_draws(dev, steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred = sample_generation(model, MG_GEN_BATCH, mesh=mesh, **d)["pred"].float()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    del model
    return pred.cpu(), dt, steps


def mg_device(rank):
    """A rank's card: its own where there are enough, else shared."""
    return torch.device("cuda", rank % torch.cuda.device_count())


def mg_digest(t):
    import hashlib

    return hashlib.sha256(t.numpy().tobytes()).hexdigest()[:16]


def multi_gpu_rank(argv):
    """One rank of a phase-13 run: ``--rank R W BACKEND WORKDIR NOISE_SCALE``.
    Writes rank<R>.json (launches, metrics, timings, digests) and, on rank 0,
    rank0.pt (the tensors the parent holds against its one-rank runs)."""
    import torch.distributed as dist

    from difffacto_torch.parallel import make_mesh
    from difffacto_torch.runner.evaluation import evaluate_gen

    rank, world, backend, work, noise_scale = (int(argv[0]), int(argv[1]), argv[2], argv[3],
                                               float(argv[4]))
    dev = mg_device(rank)
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=dist.FileStore(os.path.join(work, "store"), world),
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh()
        out, tensors = dict(rank=rank, world=world, backend=dist.get_backend(), device=str(dev),
                            card=torch.cuda.get_device_name(dev)), {}
        mg_counts(zero=True)
        t = mg_train(mesh, MG_TRAIN_STEPS, dev)
        out["train"] = dict(launches=mg_counts(), metrics=t["metrics"], ms=t["ms"],
                            digest=mg_digest(t["after"]))
        tensors["train_after"] = t["after"]
        mg_generate(mesh, dev, noise_scale)  # warm-up: a new process's first generation
        mg_counts(zero=True)
        pred, dt, steps = mg_generate(mesh, dev, noise_scale)
        out["gen"] = dict(launches=mg_counts(), s=dt, steps=steps, digest=mg_digest(pred))
        tensors["gen"] = pred
        if world % 2 == 0:
            sp = make_mesh(axis_names=("data", "points"), mesh_shape=(world // 2, 2))
            mg_generate(sp, dev, noise_scale)
            mg_counts(zero=True)
            pred, dt, steps = mg_generate(sp, dev, noise_scale)
            out["sp_gen"] = dict(launches=mg_counts(), s=dt, steps=steps, digest=mg_digest(pred))
            tensors["sp_gen"] = pred
            mg_counts(zero=True)
            t = mg_train(sp, 1, dev)
            out["sp_train"] = dict(launches=mg_counts(), metrics=t["metrics"], ms=t["ms"],
                                   digest=mg_digest(t["after"]))
            tensors["sp_train_after"] = t["after"]
        with np.load(os.path.join(work, "protocol.npz")) as f:
            gen, refs = f["gen"], f["refs"]
        mg_counts(zero=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = evaluate_gen(gen, refs, device=dev, mesh=mesh)
        torch.cuda.synchronize()
        out["protocol"] = dict(launches=mg_counts(), s=time.perf_counter() - t0,
                               metrics={k: float(v) for k, v in metrics.items()})
        with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
        if rank == 0:
            torch.save(tensors, os.path.join(work, "rank0.pt"))
    finally:
        dist.destroy_process_group()


def mg_free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mg_cli_run(world, work):
    """``tools/run_net_torch.py --launcher pytorch`` under
    ``torch.distributed.run`` with ``world`` ranks on this node: 2 epochs of
    configs/bench_train_tpu.py. Returns the epoch seconds rank 0 logged."""
    keys = dict(MG_CLI_OVERRIDES, work_dir=os.path.join(work, "cli"))
    cfg = os.path.join(work, "bench_train_mg.py")
    with open(cfg, "w") as f:
        f.write(f"_base_ = [{os.path.join(ROOT, RUNNER_CONFIG)!r}]\n")
        f.write("".join(f"{k} = {v!r}\n" for k, v in keys.items()))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(world),
           "--master_addr", "127.0.0.1", "--master_port", str(mg_free_port()),
           os.path.join(ROOT, "tools", "run_net_torch.py"), "--launcher", "pytorch",
           "--config-file", cfg, "--task", "train"]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=MG_CLI_TIMEOUT,
                              cwd=work)
    except subprocess.TimeoutExpired:
        fail(f"--launcher pytorch with {world} ranks did not finish in {MG_CLI_TIMEOUT} s")
    wall = time.perf_counter() - t0
    text = proc.stdout + proc.stderr
    if proc.returncode != 0:
        print(text[-6000:])
        fail(f"--launcher pytorch with {world} ranks exited {proc.returncode}")
    epochs = [float(line.split("trained in ")[1].split()[0]) for line in text.splitlines()
              if "trained in " in line]
    started = [line.split("] ", 1)[-1] for line in text.splitlines()
               if "[difffacto_torch] rank " in line or "ranks (" in line]
    ckpt = os.path.join(work, "cli", "checkpoints", "ckpt_2.pt")
    if len(epochs) != 2 or not os.path.exists(ckpt) or "validation @ epoch 2" not in text:
        print(text[-6000:])
        fail("--launcher pytorch: expected 2 logged epochs, val at epoch 2 and ckpt_2.pt")
    return dict(epoch_s=epochs, wall_s=wall, started=started)


def multi_gpu_phase(dev, noise_scale, phase6):
    """Phase 13: the runs of the multi-GPU path (see the docstring)."""
    import tempfile

    count = torch.cuda.device_count()
    print(f"torch.cuda.device_count() = {count}")
    runs = [("nccl", min(count, 4))] if count > 1 else [("nccl", 1), ("gloo", 2)]
    torch.cuda.empty_cache()
    refs = {}
    for _, world in runs:  # the one-rank arithmetic of each run, in this process
        if world not in refs:
            refs[world] = mg_train(None, MG_TRAIN_STEPS, dev, reference_world=world)
            if world % 2 == 0:
                refs[f"sp{world}"] = mg_train(None, 1, dev, reference_world=world // 2)
    gen_ref, gen_ref_s, _ = mg_generate(None, dev, noise_scale)
    torch.cuda.empty_cache()
    total = {}
    report = []
    for backend, world in runs:
        label = f"{backend} x{world}" + (" sharing one card" if world > count else "")
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as work:
            np.savez(os.path.join(work, "protocol.npz"), gen=phase6["gen"], refs=phase6["refs"])
            t0 = time.perf_counter()
            procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank",
                                       str(r), str(world), backend, work, str(noise_scale)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                     for r in range(world)]
            outs = []
            for p in procs:
                try:
                    outs.append(p.communicate(timeout=MG_RUN_TIMEOUT)[0])
                except subprocess.TimeoutExpired:
                    for q in procs:
                        q.kill()
                        q.wait()
                    fail(f"phase 13 {label}: a rank did not finish in {MG_RUN_TIMEOUT} s")
            for r, (p, o) in enumerate(zip(procs, outs)):
                if p.returncode != 0:
                    print(o[-6000:])
                    fail(f"phase 13 {label}: rank {r} exited {p.returncode}")
            ranks = [json.load(open(os.path.join(work, f"rank{r}.json"))) for r in range(world)]
            got = torch.load(os.path.join(work, "rank0.pt"))
            wall = time.perf_counter() - t0
            cli = mg_cli_run(world, work)
        print(f"{label}: ranks {[(r['rank'], r['backend'], r['device']) for r in ranks]}, "
              f"{wall:.1f} s")
        row = dict(backend=backend, world=world, label=label, wall_s=wall, cli=cli)

        def hold_train(key, ref, steps):
            """Per step: the loss dict and grad_norm at phase 9's tolerances;
            the parameters' change: mean |difference| within RUNNER_UPDATE_REL
            of the mean |update|."""
            worst = 0.0
            for s in range(steps):
                mine, want = ranks[0][key]["metrics"][s], ref["metrics"][s]
                for k in ("total_loss", "mse_loss", "fit_loss"):
                    worst = max(worst, abs(mine[k] - want[k]) / max(abs(want[k]), 1e-12))
                gn = abs(mine["grad_norm"] - want["grad_norm"]) / want["grad_norm"]
                if mine["skipped_nonfinite"] or gn > STEP_GNORM_RTOL:
                    fail(f"phase 13 {label} {key} step {s}: grad_norm {mine['grad_norm']} vs "
                         f"{want['grad_norm']}")
            upd = ref["after"] - ref["before"]
            diff = (got[f"{key}_after"] - ref["after"]).abs().mean().item()
            rel = diff / upd.abs().mean().item()
            digests = {r[key]["digest"] for r in ranks}
            launches = [(r[key]["launches"]["fused_trunk_train_fwd"],
                         r[key]["launches"]["fused_trunk_train_bwd"]) for r in ranks]
            print(f"  {key}: {steps} steps, loss dict off by at most {worst:.3e} (tol "
                  f"{STEP_LOSS_RTOL}), update difference {rel:.4f} of the mean update (tol "
                  f"{RUNNER_UPDATE_REL}), ms a step {ranks[0][key]['ms']}, B2/B3 launches a "
                  f"rank {launches}, ranks agree: {len(digests) == 1}")
            if worst > STEP_LOSS_RTOL or rel > RUNNER_UPDATE_REL or len(digests) != 1:
                fail(f"phase 13 {label}: {key} disagrees with the one-rank run")
            if any(l != (steps, steps) for l in launches):
                fail(f"phase 13 {label}: {key} launched B2/B3 {launches}, not once a step a rank")
            return dict(loss_rel=worst, update_rel=rel, ms=ranks[0][key]["ms"])

        def hold_gen(key):
            d = (got[key] - gen_ref).norm() / gen_ref.norm()
            launches = [r[key]["launches"]["fused_core"] for r in ranks]
            digests = {r[key]["digest"] for r in ranks}
            print(f"  {key}: batch {MG_GEN_BATCH}, relative L2 to the one-rank run {d:.3e} (tol "
                  f"{E2E_REL_L2}), {ranks[0][key]['s']:.2f} s (one rank {gen_ref_s:.2f} s), B1 "
                  f"launches a rank {launches}, ranks agree: {len(digests) == 1}")
            if not torch.isfinite(got[key]).all() or d > E2E_REL_L2 or len(digests) != 1:
                fail(f"phase 13 {label}: {key} disagrees with the one-rank generation")
            steps = ranks[0][key]["steps"]
            if any(n != steps for n in launches):
                fail(f"phase 13 {label}: {key} launched B1 {launches} times, not {steps} a rank")
            return dict(rel_l2=d.item(), s=ranks[0][key]["s"])

        row["train"] = hold_train("train", refs[world], MG_TRAIN_STEPS)
        row["gen"] = hold_gen("gen")
        if world % 2 == 0:
            row["sp_gen"] = hold_gen("sp_gen")
            row["sp_train"] = hold_train("sp_train", refs[f"sp{world}"], 1)
        m6 = {k: float(v) for k, v in phase6["metrics"].items()}
        emd = [r["protocol"]["launches"]["emd_hybrid"] for r in ranks]
        fps_l = [r["protocol"]["launches"]["fps"] for r in ranks]
        same = all(r["protocol"]["metrics"] == m6 for r in ranks)
        print(f"  protocol 64 v 64: {ranks[0]['protocol']['s']:.2f} s, B5 launches a rank {emd}, "
              f"B4 {fps_l}, equal to phase 6's metrics on every rank: {same}")
        if not same:
            print(json.dumps({"phase6": m6, "rank0": ranks[0]["protocol"]["metrics"]}))
            fail(f"phase 13 {label}: the sharded protocol differs from phase 6's metrics")
        if min(emd) == 0 or min(fps_l) == 0:
            fail(f"phase 13 {label}: a rank launched no B5 or B4 in the protocol")
        row["protocol"] = dict(s=ranks[0]["protocol"]["s"], emd_launches=emd)
        print(f"  --launcher pytorch, {world} rank(s){' sharing one card' if world > count else ''}"
              f": epoch seconds {cli['epoch_s']} ({'ranks sharing one card: no scaling number' if world > count else 'not a scaling number'}), "
              f"{cli['wall_s']:.1f} s with start-up; {cli['started']}")
        for r in ranks:
            for part in ("train", "gen", "sp_gen", "sp_train", "protocol"):
                for k, v in r.get(part, {}).get("launches", {}).items():
                    total[k] = total.get(k, 0) + v
        report.append(row)
    print(json.dumps({"multi_gpu": report}, default=float))
    return total


def main():
    phase("1 device")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.device_count()} card(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    phase("2 build")
    from difffacto_torch.ops import _build
    from difffacto_torch.ops import emd_hybrid as eh
    from difffacto_torch.ops import fps as fpsm
    from difffacto_torch.ops import fused_block as fb
    from difffacto_torch.ops import fused_core as fc
    from difffacto_torch.ops import fused_core_train as fct
    from difffacto_torch.ops import fused_ff as ff

    for tool in ("nvcc", "ptxas"):
        version = subprocess.run([os.path.join(os.path.dirname(_build.nvcc()), tool), "--version"],
                                 capture_output=True, text=True, timeout=60).stdout.strip()
        print(f"{tool}: {version.splitlines()[-1] if version else 'no version'}")
    t0 = time.perf_counter()
    logs = _build.build(["fused_core", "fused_core_train", "fps", "emd_hybrid", "fused_ff"])
    print(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "entry function" in line:
                print(f"  {name}: {line.split('entry function')[1].split(' for ')[0].strip()}")
            if "Used" in line or "spill" in line or "smem" in line:
                print(f"  {name}: {line.strip()}")
    print(f"  fused_core: {fc.smem_bytes()} bytes of dynamic shared memory per block, "
          f"{fc.smem_bytes(True)} with the tail")
    print(f"  fused_core_train: {fct.smem_bytes()} bytes (forward, backward)")
    # Every trunk kernel (B1, B6, B2, B3, and B7: at D = 128 the template's
    # Mode::FF entry in fused_ff, at D = 256 its cluster kernel) is wgmma fed
    # by TMA, each function counted on its own; the backward flushes its
    # weight gradients with 4-wide reductions (REDG ... F32x4 in SASS) and
    # neither the training trunk nor the FF entries hold a warp-level (WMMA)
    # product. No source of the port names WMMA any more.
    for lib in ("fused_core", "fused_core_train", "fused_ff"):
        sass = subprocess.run([os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump"), "-sass",
                               str(_build.library_path(lib))],
                              capture_output=True, text=True, timeout=300).stdout
        funcs = {}
        for part in sass.split("Function : ")[1:]:
            fname, body = part.split("\n", 1)
            ops = {op: body.count(op) for op in ("HGMMA", "HMMA", "UTMALDG", "REDG")}
            ops["REDG x4"] = sum(1 for line in body.splitlines() if "REDG" in line and "x4" in line)
            funcs[fname.strip()] = ops
            print(f"  {lib} SASS {fname.strip()}: {ops}")
        want = {"fused_core": {"fused_core_kernel": 5},
                "fused_core_train": {"fused_core_kernel": 1, "trunk_train_bwd_kernel": 1},
                "fused_ff": {"fused_core_kernel": 1, "ff_wide_kernel": 1}}[lib]
        for kernel, n in want.items():
            if sum(kernel in f for f in funcs) != n:
                fail(f"the binary of {lib} does not hold {n} {kernel}")
        for fname in (f for f in funcs if any(kernel in f for kernel in want)):
            ops = funcs[fname]
            if ops["HGMMA"] == 0 or ops["UTMALDG"] == 0:
                fail(f"{fname} in {lib} holds no wgmma or no TMA load")
            if lib in ("fused_core_train", "fused_ff") and ops["HMMA"]:
                fail(f"{fname} in {lib} still holds warp-level (WMMA) products")
            if "trunk_train_bwd_kernel" in fname and ops["REDG x4"] == 0:
                fail("the training backward flushes no weight gradient with a 4-wide reduction")
    print(f"  fused_ff: {ff.smem_bytes(128)} bytes at D = 128, {ff.smem_bytes(256)} at D = 256")
    csrc = os.path.join(ROOT, "difffacto_torch", "csrc")
    wmma = [f for f in sorted(os.listdir(csrc)) if "wmma" in open(os.path.join(csrc, f)).read().lower()]
    if wmma:
        fail(f"WMMA is still named in {wmma}")
    # The EMD kernel's special-function instructions (its bound counts a square
    # root and an exp on them for each Sinkhorn element), for the record.
    sass = subprocess.run([os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump"), "-sass",
                           str(_build.library_path("emd_hybrid"))],
                          capture_output=True, text=True, timeout=300).stdout
    for part in sass.split("Function : ")[1:]:
        fname, body = part.split("\n", 1)
        mufu = {op: body.count(f"MUFU.{op}") for op in ("EX2", "SQRT", "RSQ", "LG2", "RCP")}
        print(f"  emd_hybrid SASS {fname.strip()}: MUFU {mufu}")

    phase("3 kernels against their plain versions")
    max_err = 0.0
    # Parts absent in some rows, a ragged N, and the batch-16 shape of phase 4.
    # Then the timed shape with parts absent: 4096 tiles, 31 or 32 per block.
    timed_mask = np.ones((BATCH_TIMED, 4), np.float32)
    timed_mask[1, 1] = timed_mask[5, 0] = timed_mask[200, 2] = timed_mask[BATCH_TIMED - 1, 3] = 0.0
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for B, N, mask in ((4, 2048, [[1, 1, 1, 1], [1, 0, 1, 1], [1, 1, 1, 1], [0, 1, 1, 1]]),
                       (2, 1000, [[1, 1, 0, 1], [1, 1, 1, 1]]),
                       (BATCH_CHECK, 2048, None), (BATCH_TIMED, 2048, timed_mask)):
        args = fc.operands(fc.example_inputs(B, N, depth=5, seed=B, mask=mask), dev, torch.bfloat16)
        sched = fc.schedule(B, N, sms)
        got = fc.fused_core(*args, 0.25)
        torch.cuda.synchronize()
        max_err = max(max_err, hold_bf16(
            f"fused_core B={B} N={N} ({sched['total_tiles']} tiles, {sched['grid']} blocks)", got,
            fc.fused_core_reference(*args, 0.25)))
        del args, got

    # The head-less entry (the trunk on h0, add_t_to_x's form) at the timed
    # shape with parts absent and at a ragged N, at B1's tolerance (it is
    # B1's arithmetic after proj_in: an H100 showed max abs 0.0781 at B = 256
    # against B1's 0.0625 there, both means 2.85e-4).
    headless_err = 0.0
    for B, N, mask in ((BATCH_TIMED, 2048, timed_mask), (2, 1000, [[1, 1, 0, 1], [1, 1, 1, 1]])):
        args = fc.operands(fc.example_inputs(B, N, depth=5, in_ch=fc.D, seed=N, mask=mask), dev,
                           torch.bfloat16)
        hl = [args[0]] + args[3:]
        got = fc.fused_core_headless(*hl, 0.25)
        torch.cuda.synchronize()
        headless_err = max(headless_err, hold_bf16(
            f"fused_core_headless B={B} N={N}", got,
            fc.fused_core_reference(hl[0], None, None, *hl[1:], 0.25)))
        del args, hl, got

    # The training trunk: forward and every gradient against the plain version
    # at p = 0 and p = 0.2, with absent parts and a ragged N.
    train_fwd_err = train_bwd_err = 0.0

    for B, N, mask in ((4, 2048, [[1, 1, 1, 1], [1, 0, 1, 1], [1, 1, 1, 1], [0, 1, 1, 1]]),
                       (2, 1000, [[1, 1, 0, 1], [1, 1, 1, 1]])):
        inp = fct.example_inputs(B, N, depth=5, seed=B, mask=mask)
        inp["cot"] = np.random.RandomState(N).randn(B, N, fc.D).astype(np.float32)
        par = fct.example_params(depth=5, seed=N)
        for p in (0.0, 0.2):
            y, g = fct.run_example(fct.fused_trunk_train, inp, par, p, 1234, dev)
            torch.cuda.synchronize()
            yr, gr = fct.run_example(fct.fused_trunk_train_reference, inp, par, p, 1234, dev)
            fe, be = hold_train(f"B={B} N={N} p={p}", y, g, yr, gr)
            train_fwd_err, train_bwd_err = max(train_fwd_err, fe), max(train_bwd_err, be)
        # p = 0.2: the kept share, two seeds differ, one seed repeats bit for bit
        kept = (fct.dropout_mult(1234, B, N, 0, 1, fc.FF, 0.2, dev) > 0).float().mean().item()
        with torch.no_grad():
            x, k, v = (torch.as_tensor(inp[n]).to(dev, torch.bfloat16) for n in ("x", "k", "v"))
            rest = [torch.as_tensor(inp["mask"]).to(dev)] + [
                torch.as_tensor(a).to(dev) for a in par.values()]
            y1, y1b, y2 = (fct.fused_trunk_train(sd, x, k, v, *rest, 0.25, 0.2)
                           for sd in (1234, 1234, 4321))
        print(f"  p=0.2: kept share {kept:.4f} (0.8 +- {KEPT_SHARE_TOL}); same seed repeats: "
              f"{torch.equal(y1, y1b)}; another seed differs in "
              f"{(y1 != y2).float().mean().item():.3f} of the outputs")
        if abs(kept - 0.8) > KEPT_SHARE_TOL or not torch.equal(y1, y1b) or torch.equal(y1, y2):
            fail("fused_trunk_train dropout: kept share, repeatability or seed dependence")
    # At p = 0 the training forward equals fused_core on the same operands
    # (proj_in applied outside for the training trunk).
    core = fc.operands(fc.example_inputs(4, 2048, depth=5, seed=3), dev, torch.bfloat16)
    x13, pin_w, pin_b, k, v, mask, *tail = core
    h0 = (x13.float() @ pin_w.float() + pin_b).to(torch.bfloat16)
    with torch.no_grad():
        y_train = fct.fused_trunk_train(0, h0, k, v, mask, *tail, 0.25, 0.0)
    hold_bf16("fused_trunk_train at p=0 against fused_core", y_train, fc.fused_core(*core, 0.25))

    # The fused LN-GEGLU FF at the two-attention denoiser's shape (batch 256),
    # the aligner's (batch 256) and a smaller T; the one-block kernel at UNet's
    # shape with parts absent and at an N that pick_tile takes.
    ff_err = 0.0
    for D, T in ((128, BATCH_TIMED * 2048), (256, 4 * BATCH_TIMED), (128, 384), (256, 100),
                 (256, 128), (256, 32768)):
        args = ff_operands(D, T, dev, seed=T)
        got = ff.fused_ln_geglu_ff(*args)
        torch.cuda.synchronize()
        ff_err = max(ff_err, hold_bf16(f"fused_ff D={D} T={T}", got, ff.fused_ln_geglu_ff_reference(*args)))
        del args, got
    block_err = 0.0
    for B, N in ((UNET_BATCH, 2048), (4, 384)):
        mask = np.ones((B, fb.CTX), np.float32)
        mask[1, 1] = mask[2, 0] = mask[2, 3] = mask[B - 1, 2] = 0.0
        args = fc.operands(fb.example_inputs(B, N, seed=N, mask=mask), dev, torch.bfloat16)
        got = fb.fused_block(*args, 0.25)
        torch.cuda.synchronize()
        block_err = max(block_err, hold_bf16(f"fused_block B={B} N={N}", got,
                                             fb.fused_block_reference(*args, 0.25)))
        del args, got
    torch.cuda.empty_cache()

    # FPS index for index: the protocol's points (plan: clusters of 4 at 4
    # clouds, of 2 at 64), a ragged N, 16 distinct points repeated to 256
    # (all remaining distances 0: index 0 repeats), a cluster of 8 (one cloud
    # of 16,384), clusters grown to 2 to hold 10,000 points at 70 clouds and
    # 14,528 at 132, and the 400 v 400 protocol's refs.
    fps_diff = 0.0
    fps_clusters = set()
    for B, N, m, distinct in ((4, 8192, 2048, None), (3, 1000, 64, None), (2, 256, 32, 16),
                              (64, 8192, 2048, None), (1, 16384, 512, None),
                              (70, 10000, 64, None), (132, 14528, 128, None),
                              (400, 8192, 2048, None)):
        x = seeded_clouds(B, N, seed=N, distinct=distinct).to(dev)
        pl = fpsm.plan(B, N, sms)
        got = fpsm.furthest_point_sample(x, m)
        torch.cuda.synchronize()
        want = fpsm.furthest_point_sample_reference(x, m)
        share = (got != want).float().mean().item()
        fps_clusters.add(pl["cluster"])
        print(f"fps B={B} N={N} m={m} (cluster {pl['cluster']}, "
              f"{pl['threads']} threads x {pl['points_per_thread']} points): share of differing "
              f"indices {share:.6f} (must be 0)")
        if got.dtype != torch.int32 or tuple(got.shape) != (B, m) or share != 0.0:
            fail(f"fps disagrees with its plain version at B={B} N={N} m={m}")
        fps_diff = max(fps_diff, share)
        del x, got, want
    if fps_clusters != {1, 2, 4, 8}:
        fail(f"the FPS checks met the cluster sizes {sorted(fps_clusters)}, not 1, 2, 4 and 8")

    # EMD assignment: in range, cost against the plain version's, and at
    # n = 512 against the Hungarian optimum. n = 8192 is the variant whose
    # state lies in global memory, held to the plain version like the others
    # (two pairs: the plain version holds several (B, 8192, 8192) matrices).
    emd_diff = 0.0
    for B, n in ((4, 2048), (4, 512), (2, 384), (2, 8192)):
        a = (seeded_clouds(B, n, seed=n) * 0.3).to(dev)
        b = (seeded_clouds(B, n, seed=n + 1) * 0.3).to(dev)
        t0 = time.perf_counter()
        got, rounds, bids, _ = eh.emd_assignment_hybrid(
            a, b, auction_iters=AUCTION_ITERS, return_work=True)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        want, rounds_p, bids_p = eh.emd_assignment_hybrid_reference(
            a, b, auction_iters=AUCTION_ITERS, return_work=True)
        cg, cw = matched_cost(a, b, got), matched_cost(a, b, want)
        share = (got != want).float().mean().item()
        rel = ((cg - cw).abs() / cw).max().item()
        bij = min(got[i].unique().numel() / n for i in range(B))
        print(f"emd_hybrid B={B} n={n}: share of differing indices {share:.6f}, matched cost "
              f"off by {rel:.3e} (tol {EMD_COST_RTOL}), rounds {rounds.tolist()} (plain "
              f"{rounds_p.tolist()}), bids {bids.tolist()} (plain {bids_p.tolist()}), "
              f"bijective share {bij:.4f}, {seconds:.2f} s")
        if got.min().item() < 0 or got.max().item() >= n or not rel <= EMD_COST_RTOL:
            fail(f"emd_hybrid disagrees with its plain version at B={B} n={n}")
        if n == 512:
            from scipy.optimize import linear_sum_assignment

            for i in range(B):
                d = torch.cdist(a[i], b[i]).cpu().numpy()
                ri, ci = linear_sum_assignment(d)
                ratio = cg[i].item() / d[ri, ci].mean()
                print(f"  pair {i}: {ratio:.5f} x the Hungarian optimum (tol {EMD_HUNGARIAN})")
                if ratio > EMD_HUNGARIAN:
                    fail("emd_hybrid is further than 1 % from the optimal matching at n=512")
        emd_diff = max(emd_diff, share)

    phase("4 gen_chair generation, full width")
    from difffacto_torch import sample_generation

    for noise_scale in (100, 1):
        model = build_model(noise_scale, dev)
        valid = torch.ones(BATCH_CHECK, 4, device=dev)
        zero_launches("fused_core")
        out = sample_generation(model, BATCH_CHECK, valid_id=valid,
                                generator=torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        launches = kernel_launches("fused_core")["fused_core"]
        pred = out["pred"]
        if torch.isfinite(pred).all():
            break
        print(f"non-finite samples at aligner noise_scale {noise_scale} with untrained "
              "weights; lowering it to 1 as __graft_entry__.py does")
    else:
        fail("non-finite samples")
    print(f"noise_scale {noise_scale}: pred {tuple(pred.shape)} {pred.dtype}, "
          f"fused_core launches {launches}")
    if tuple(pred.shape) != (BATCH_CHECK, 2048, 3):
        fail(f"pred has shape {tuple(pred.shape)}")
    if launches != model.num_timesteps:
        fail(f"fused_core launched {launches} times in a {model.num_timesteps}-step generation")

    # Batch 1 with every draw injected, against the same seeded model on the
    # CPU, whose trunk is the plain version.
    rng = np.random.RandomState(0)
    draws = dict(
        z=rng.randn(1, 4, 256), cimle_noise=rng.randn(1, 32),
        noise=rng.randn(1, 2048, 3), step_noise=rng.randn(model.num_timesteps, 1, 2048, 3),
    )
    valid1 = [[1, 0, 1, 1]]
    runs = {}
    for where, m in (("cuda", model), ("cpu", build_model(noise_scale, "cpu"))):
        d = {k: torch.as_tensor(v, dtype=torch.float32, device=where) for k, v in draws.items()}
        t0 = time.perf_counter()
        runs[where] = sample_generation(
            m, 1, valid_id=torch.as_tensor(valid1, dtype=torch.float32, device=where), **d
        )["pred"].float().cpu()
        print(f"batch-1 generation on {where}: {time.perf_counter() - t0:.1f} s")
    diff = (runs["cuda"] - runs["cpu"]).abs()
    rel = (diff.norm() / runs["cpu"].norm()).item()
    print(f"card vs CPU plain trunk: max abs {diff.max().item():.4e}, relative L2 {rel:.4e} "
          f"(tol {E2E_REL_L2})")
    if not torch.isfinite(runs["cuda"]).all() or rel > E2E_REL_L2:
        fail("generation on the card disagrees with the CPU plain version")

    phase("5 timing")
    valid = torch.ones(BATCH_TIMED, 4, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    for _ in range(WARMUP):
        sample_generation(model, BATCH_TIMED, valid_id=valid, generator=gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        last = sample_generation(model, BATCH_TIMED, valid_id=valid, generator=gen)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    shapes_per_s = BATCH_TIMED * ITERS / dt
    gen5 = dict(pred=last["pred"].float().cpu().numpy(),
                pred_seg_mask=last["seg_mask"].cpu().numpy().astype(np.int64))
    del last
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"gen_chair batch {BATCH_TIMED}: {shapes_per_s:.2f} shapes/s "
          f"({dt / ITERS:.3f} s per batch), peak memory {peak_gib:.2f} GiB")

    args = fc.operands(fc.example_inputs(BATCH_TIMED, 2048, depth=5, seed=7), dev, torch.bfloat16)
    out_bytes = BATCH_TIMED * 2048 * fc.D * 2
    bound_ms, bound_by = trunk_bound_ms(args, out_bytes, in_ch=13, depth=5)
    kernel_ms = cuda_ms(lambda: fc.fused_core(*args, 0.25), 20)
    plain_ms = cuda_ms(lambda: fc.fused_core_reference(*args, 0.25), 3)
    share = 100 * model.num_timesteps * kernel_ms / (1e3 * dt / ITERS)
    print(f"fused_core B={BATCH_TIMED} N=2048: {kernel_ms:.3f} ms, bound {bound_ms:.3f} ms "
          f"({bound_by}), {100 * bound_ms / kernel_ms:.1f}% of roofline; plain version "
          f"{plain_ms:.3f} ms; 100 launches are {share:.1f}% of a batch's generation time")
    sched = fc.schedule(BATCH_TIMED, 2048, sms)
    # A model of the weight traffic, not a measurement: every tile streams
    # every block's weights (bf16) from L2 once.
    tile_weight_bytes = 5 * (2 * fc.D * fc.D + 3 * fc.D * fc.FF) * 2
    l2_gb = sched["total_tiles"] * tile_weight_bytes / 1e9
    print(f"fused_core schedule (host side): {sched['grid']} blocks over {sched['total_tiles']} "
          f"tiles, at most {sched['tiles_per_block']} a block; modelled weight traffic from L2 "
          f"(not measured) {l2_gb:.3f} GB per launch, {2 * l2_gb:.3f} GB with 64-token tiles")
    idle = {}
    for B in (BATCH_CHECK, BATCH_TIMED):
        vb = torch.ones(B, 4, device=dev)
        wall, busy = device_busy(lambda: sample_generation(
            model, B, valid_id=vb, generator=torch.Generator(device=dev).manual_seed(2)))
        idle[B] = 1.0 - busy / wall
        print(f"generation at batch {B}: {wall:.1f} ms unprofiled, device busy {busy:.1f} ms "
              f"(profiler, card only), idle share {100 * idle[B]:.1f}%")
    trunk = {
        "name": "fused_core", "route": "cuda", "source": "difffacto_torch/csrc/fused_core.cu",
        "replaces": "difffacto_tpu/ops/fused_core.py:33", "launches": launches,
        "max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None, "gen_shapes_per_s": shapes_per_s, "idle_share_batch16": idle[BATCH_CHECK],
        "idle_share_batch256": idle[BATCH_TIMED],
    }

    phase("6 eval protocol, full width")
    from difffacto_torch.data import bbox_normalize
    from difffacto_torch.metrics import eval as ev
    from difffacto_torch.ops.points import fps
    from difffacto_torch.runner.evaluation import evaluate_gen, generate_samples

    S = R = EVAL_SHAPES
    rng = np.random.RandomState(5)
    refs = (rng.randn(R, REF_POINTS, 3) * rng.uniform(0.3, 1.0, (R, 1, 3))).astype(np.float32)
    # What emd_cost_eval is given, timed with CUDA events around each call.
    emd_events = []
    emd_cost_eval = ev.emd_cost_eval

    def timed_emd_cost_eval(*args):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = emd_cost_eval(*args)
        end.record()
        emd_events.append((start, end, args[0].shape[0]))
        return out

    ev.emd_cost_eval = timed_emd_cost_eval
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen = generate_samples(model, num_gen=S, batch=S, seed=0)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    metrics = evaluate_gen(gen, refs)
    torch.cuda.synchronize()
    t_eval = time.perf_counter() - t0
    counts = kernel_launches("fused_core", "fps", "emd_hybrid")
    ev.emd_cost_eval = emd_cost_eval
    phase6 = dict(gen=gen, refs=refs, metrics=metrics)

    per_launch = ev.emd_pairs_per_launch(2048, 32, dev)
    sweeps = (R * S, R * (R - 1) // 2, S * (S - 1) // 2)
    pairs = sum(sweeps)
    expected = dict(fused_core=model.num_timesteps, fps=1,  # the refs, all in one launch
                    emd_hybrid=sum(-(-p // per_launch) for p in sweeps))
    emd_s = sum(s.elapsed_time(e) for s, e, _ in emd_events) / 1e3
    print(f"generated {gen.shape} in {t_gen:.2f} s; protocol over {pairs} pairs at n=2048 "
          f"({per_launch} pairs a launch) in {t_eval:.2f} s: {1e3 * t_eval / pairs:.3f} ms a pair, "
          f"{emd_s:.2f} s ({100 * emd_s / t_eval:.1f}%) inside emd_cost_eval over "
          f"{sum(b for _, _, b in emd_events)} pairs")
    print("emd_cost_eval calls (pairs, ms): "
          + ", ".join(f"({b}, {s.elapsed_time(e):.1f})" for s, e, b in emd_events))
    print(f"launches {counts}, expected {expected}")
    print("metrics " + json.dumps({k: float(v) for k, v in sorted(metrics.items())}))
    if counts != expected:
        fail(f"launch counts {counts} are not the {expected} that the sweep sizes imply")
    if gen.shape != (S, 2048, 3) or not np.isfinite(gen).all():
        fail("generated shapes are not finite (64, 2048, 3)")
    for k, v in metrics.items():
        if not np.isfinite(v) or (("cov" in k or "acc" in k) and not 0.0 <= v <= 1.0):
            fail(f"metric {k} = {v}")
    if len(metrics) != 12:
        fail(f"{len(metrics)} metrics, expected 12")

    # A 2 x 2 corner of the (ref x sample) matrices, on the card and on the
    # CPU, where FPS, CD and the EMD hybrid are the plain versions.
    refs_card = fps(torch.as_tensor(refs[:CORNER], device=dev), 2048).cpu().numpy()
    t0 = time.perf_counter()
    refs_cpu = fps(torch.as_tensor(refs[:CORNER]), 2048).numpy()
    if not np.array_equal(refs_card, refs_cpu):
        fail("FPS on the card and on the CPU chose other points")
    ref_n, gen_n = bbox_normalize(refs_card), bbox_normalize(gen[:CORNER])
    cd_card, emd_card = ev.pairwise_cd_emd(ref_n, gen_n, 32, device=dev)
    os.environ["DIFFFACTO_EMD_IMPL"] = "hybrid"
    try:
        cd_cpu, emd_cpu = ev.pairwise_cd_emd(ref_n, gen_n, 4, device="cpu")
    finally:
        del os.environ["DIFFFACTO_EMD_IMPL"]
    cd_rel = np.abs(cd_card / cd_cpu - 1).max()
    emd_rel = np.abs(emd_card / emd_cpu - 1).max()
    print(f"{CORNER} x {CORNER} corner against the CPU plain path ({time.perf_counter() - t0:.1f} s): CD off by "
          f"{cd_rel:.3e} (tol {CORNER_CD_RTOL}), EMD off by {emd_rel:.3e} (tol {CORNER_EMD_RTOL})")
    if not cd_rel <= CORNER_CD_RTOL or not emd_rel <= CORNER_EMD_RTOL:
        fail("the card's corner of the CD/EMD matrices disagrees with the CPU plain path")

    # FPS and the EMD kernel on the protocol's own clouds.
    # FPS at the protocol's launch (all R clouds), at 32 clouds and at 400
    # (the 400 v 400 protocol's references: the 64 refs and seeded clouds of
    # the same shape), each at the plan's cluster size and at 1, beside the
    # operations bound and the latency floor: the kernel's 2047 steps
    # with no distance sweep.
    x = torch.as_tensor(refs, device=dev)
    rng400 = np.random.RandomState(6)
    more = (rng400.randn(400 - R, REF_POINTS, 3)
            * rng400.uniform(0.3, 1.0, (400 - R, 1, 3))).astype(np.float32)
    x400 = torch.cat([x, torch.as_tensor(more, device=dev)])
    fps_t = {}
    for B, xb in ((R, x), (32, x[:32].contiguous()), (400, x400)):
        pl = fpsm.plan(B, REF_POINTS, sms)
        ms = cuda_ms(lambda: fpsm.furthest_point_sample(xb, 2048), 5)
        ms1 = cuda_ms(lambda: fpsm._launch(xb, 2048, 1), 5)
        floor = cuda_ms(lambda: fpsm.latency_floor_probe(xb, 2048), 5)
        floor1 = cuda_ms(lambda: fpsm.latency_floor_probe(xb, 2048, cluster=1), 5)
        bound, by = fps_bound_ms(B, REF_POINTS, 2048)
        fps_t[B] = dict(ms=ms, ms_c1=ms1, floor=floor, floor_c1=floor1, bound=bound, by=by,
                        cluster=pl["cluster"])
        print(f"fps B={B} N={REF_POINTS} m=2048: {ms:.3f} ms at the plan's cluster of "
              f"{pl['cluster']} ({pl['threads']} threads x {pl['points_per_thread']} points), "
              f"{ms1:.3f} ms at 1; latency floor {floor:.3f} ms (at 1: {floor1:.3f}); "
              f"operations bound {bound:.4f} ms ({by}), {100 * bound / ms:.1f}% of it")
    fps_ms, fps_bound, fps_by = fps_t[R]["ms"], fps_t[R]["bound"], fps_t[R]["by"]
    fps_plain_ms = cuda_ms(lambda: fpsm.furthest_point_sample_reference(x, 2048), 1)
    print(f"fps plain version B={R}: {fps_plain_ms:.1f} ms")
    del x400
    x = x[:32].contiguous()
    refs_n = torch.as_tensor(bbox_normalize(fps(x, 2048).cpu().numpy()), device=dev)
    gens_n = torch.as_tensor(bbox_normalize(gen[:32]), device=dev)
    ii = torch.arange(132, device=dev)
    a132, b132 = refs_n[ii % 32], gens_n[(ii + ii // 32) % 32]
    emd = {}
    for B in (32, 132):
        a, b = a132[:B].contiguous(), b132[:B].contiguous()
        ms = cuda_ms(lambda: eh.emd_assignment_hybrid(a, b, auction_iters=AUCTION_ITERS), 2)
        # The split: with no auction round the kernel runs the Sinkhorn and one
        # force-assignment sweep; the difference is the auction.
        sink_ms = cuda_ms(lambda: eh.emd_assignment_hybrid(a, b, auction_iters=0), 2)
        _, rounds, bids, sinkhorn = eh.emd_assignment_hybrid(
            a, b, auction_iters=AUCTION_ITERS, return_work=True)
        soft = sinkhorn["emd.sweep_soft_terms"] / sinkhorn["emd.sweep_terms"]
        bound, by = emd_bound_ms(2048, bids.tolist(), soft=soft)
        emd[B] = (ms, bound, by, sink_ms)
        print(f"emd_hybrid B={B} n=2048: {ms:.2f} ms ({ms / B:.3f} ms a pair), mean rounds "
              f"{rounds.float().mean().item():.1f}, mean bids {bids.float().mean().item():.0f} "
              f"({100 * bids.float().mean().item() / 2048 / (rounds.float().mean().item() + 1):.1f}% "
              f"of rounds + 1 full sweeps), bound {bound:.3f} ms ({by}, {bound / B:.4f} ms a "
              f"pair), {100 * bound / ms:.1f}% of roofline; split: Sinkhorn and one "
              f"force-assignment sweep {sink_ms:.2f} ms, the auction {ms - sink_ms:.2f} ms "
              f"({100 * (ms - sink_ms) / ms:.1f}%); Sinkhorn "
              f"{sinkhorn['cycles'].double().mean().item() / 1e6:.2f} Mcycles a pair, "
              f"{100 * soft:.1f}% of its terms on the soft exp2")
    emd_plain_ms = cuda_ms(
        lambda: eh.emd_assignment_hybrid_reference(a, b, auction_iters=AUCTION_ITERS), 1)
    print(f"emd_hybrid plain version B=132 n=2048: {emd_plain_ms:.1f} ms")
    del a, b, a132, b132
    torch.cuda.empty_cache()

    phase("7 gen_chair training step, full width")
    from difffacto_torch.models import select_best_noise
    from difffacto_torch.parallel import init_train_state, make_train_step

    del model
    torch.cuda.empty_cache()
    need = ("mse_loss", "fit_loss", "total_loss", "grad_norm")
    tmodel = build_train_model(dev)
    tx = build_train_optimizer()
    state = init_train_state(tmodel, tx)
    step = make_train_step(tmodel, tx)
    batch = to_device(example_batch(TRAIN_BATCH, 2048), dev)
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    history = []
    for i in range(TRAIN_STEPS):
        state, metrics = step(state, batch, 0, 0)
        history.append(metrics)
    torch.cuda.synchronize()
    train_counts = kernel_launches("fused_trunk_train_fwd", "fused_trunk_train_bwd")
    history = [{k: float(v) for k, v in m.items()} for m in history]
    print(f"{TRAIN_STEPS} steps at batch {TRAIN_BATCH} x 2048 in {time.perf_counter() - t0:.2f} s; "
          f"launches {train_counts}; other kernels "
          f"{kernel_launches('fused_core', 'fps', 'emd_hybrid')}")
    for i in (0, 1, 2, TRAIN_STEPS - 1):
        print(f"  step {i}: " + json.dumps({k: round(v, 5) for k, v in sorted(history[i].items())}))
    print("  total_loss by step: " + " ".join(f"{m['total_loss']:.3f}" for m in history))
    if train_counts != dict(fused_trunk_train_fwd=TRAIN_STEPS, fused_trunk_train_bwd=TRAIN_STEPS):
        fail(f"{TRAIN_STEPS} steps launched {train_counts}: expected one forward and one backward each")
    for m in history:
        if any(k not in m or not np.isfinite(m[k]) for k in need) or m["skipped_nonfinite"] != 0.0:
            fail(f"a training step gave {m}")
    if state.step != TRAIN_STEPS or float(state.opt_state["count"]) != TRAIN_STEPS:
        fail("the step count or the optimizer's count is off")
    if not history[-1]["total_loss"] < history[0]["total_loss"]:
        fail(f"total_loss did not fall over {TRAIN_STEPS} steps on one batch")

    # A batch with a NaN: the whole step is skipped, bit for bit.
    def snapshot(st):
        return ([p.detach().clone() for p in tmodel.parameters()]
                + [b.clone() for b in tmodel.buffers()]
                + [t.clone() for key in ("mu", "nu") for t in st.opt_state[key]]
                + [st.opt_state["count"].clone()])

    before = snapshot(state)
    bad = dict(batch)
    bad["ref"] = batch["ref"].clone()
    bad["ref"][3, 17, 1] = float("nan")
    bad["input"] = bad["ref"]
    state, metrics = step(state, bad, 0, 0)
    same = all(torch.equal(a, b) for a, b in zip(before, snapshot(state)))
    print(f"NaN batch: skipped_nonfinite {float(metrics['skipped_nonfinite'])}, state bit-equal "
          f"{same}, step {state.step}")
    if float(metrics["skipped_nonfinite"]) != 1.0 or not same or state.step != TRAIN_STEPS + 1:
        fail("the non-finite guard did not skip the step whole")

    # Timing: the step, then its two kernels at the step's shape.
    for i in range(TRAIN_WARMUP):
        state, _ = step(state, batch, 1, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for i in range(TRAIN_TIMED):
        state, _ = step(state, batch, 2, 0)
    end.record()
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0) / TRAIN_TIMED
    step_ms = start.elapsed_time(end) / TRAIN_TIMED
    train_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"training step batch {TRAIN_BATCH} x 2048: {step_ms:.2f} ms per step by CUDA events "
          f"({host_ms:.2f} ms by the host clock), {1e3 * TRAIN_BATCH / step_ms:.2f} shapes/s, "
          f"peak memory {train_peak_gib:.2f} GiB")
    del state, step, tx, before
    tmodel = None
    torch.cuda.empty_cache()

    # The two kernels at the step's shape (2048 tiles of 128 tokens: every
    # block of both persistent grids walks about 16 of them, the backward
    # reusing its parked gradient and adding many tiles into one dK/dV row),
    # parts absent in some rows: held against the plain version, then timed.
    step_mask = np.ones((TRAIN_BATCH, fc.CTX), np.float32)
    step_mask[1, 1] = step_mask[5, 0] = step_mask[TRAIN_BATCH - 1, 3] = 0.0
    inp = fct.example_inputs(TRAIN_BATCH, 2048, depth=5, seed=11, mask=step_mask)
    par = fct.example_params(depth=5, seed=12)
    x, k, v = (torch.as_tensor(inp[n]).to(dev, torch.bfloat16) for n in ("x", "k", "v"))
    mask = torch.as_tensor(inp["mask"]).to(dev)
    params = [torch.as_tensor(a).to(dev) for a in par.values()]
    ops, seed_t, launch = fct.launch_args(x, k, v, mask, params, 77, 0.25, 0.2)
    dy = torch.randn(TRAIN_BATCH, 2048, fc.D, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(3)).to(torch.bfloat16)
    grad_bytes = 4 * sum(int(np.prod(sh)) for _, sh in fct.grad_sizes(5, TRAIN_BATCH))
    bounds = trunk_train_bound_ms(ops, TRAIN_BATCH, 2048, 5, grad_bytes)

    def plain(backward):
        xr, kr, vr = (t.clone().requires_grad_(backward) for t in (x, k, v))
        pr = [t.clone().requires_grad_(backward) for t in params]
        with torch.set_grad_enabled(backward):
            y = fct.fused_trunk_train_reference(seed_t, xr, kr, vr, mask, *pr, 0.25, 0.2)
            if backward:
                y.backward(dy)
        return y.detach().float(), [t.grad.float() for t in (xr, kr, vr, *pr)] if backward else None

    with uncounted("fused_trunk_train_fwd", "fused_trunk_train_bwd"):
        y_k, acts = fct.launch_forward(ops, seed_t, launch, save=True)
        y_k = y_k.float()
        dx_k, g_k = fct.launch_backward(ops, acts, dy, seed_t, launch)
        torch.cuda.synchronize()
        tiles = launch[0] * 2048 // fct.TILE
        fe, be = hold_train(f"B={TRAIN_BATCH} N=2048 p=0.2 ({tiles} tiles)",
                            y_k, [dx_k.float()] + g_k, *plain(True))
        train_fwd_err, train_bwd_err = max(train_fwd_err, fe), max(train_bwd_err, be)
        del y_k, dx_k, g_k
        # The forward as the step runs it: saving the activations for the backward.
        fwd_ms = cuda_ms(lambda: fct.launch_forward(ops, seed_t, launch, save=True), 10)
        bwd_ms = cuda_ms(lambda: fct.launch_backward(ops, acts, dy, seed_t, launch), 5)

    plain_fwd_ms = cuda_ms(lambda: plain(False), 2)
    plain_bwd_ms = cuda_ms(lambda: plain(True), 2) - plain_fwd_ms
    for name, ms, pms in (("fwd", fwd_ms, plain_fwd_ms), ("bwd", bwd_ms, plain_bwd_ms)):
        b_ms, b_by = bounds[name]
        print(f"fused_trunk_train {name} B={TRAIN_BATCH} N=2048 p=0.2: {ms:.3f} ms, bound "
              f"{b_ms:.3f} ms ({b_by}), {100 * b_ms / ms:.1f}% of roofline; plain version "
              f"{pms:.1f} ms; {100 * ms / step_ms:.1f}% of the training step")
    # The bounds count the saved activations' bytes (written by the forward,
    # read by the backward); the backward's bound given only the Pallas
    # pair's inputs is printed under its own label.
    saved = acts.numel() * acts.element_size()
    jax_bwd = bounds["bwd_jax_inputs"][0]
    print(f"fused_trunk_train bwd: bound given only the Pallas pair's inputs {jax_bwd:.3f} ms, "
          f"{100 * jax_bwd / bwd_ms:.1f}% of it; the saved activations {saved / 1e6:.1f} MB")
    print(f"the pair: {fwd_ms + bwd_ms:.3f} ms against {bounds['fwd'][0] + bounds['bwd'][0]:.3f} "
          f"ms (the two bounds); against {bounds['fwd'][0] + jax_bwd:.3f} ms given only the "
          f"Pallas pair's inputs")
    del x, k, v, params, ops, dy, acts
    torch.cuda.empty_cache()

    # Stage 2: gen=True, aligner noise_scale 50, only the aligner trainable,
    # the CIMLE noise chosen by select_best_noise over 10 candidates.
    smodel = build_train_model(dev, stage2=True)
    if smodel.encoder_mod.aligner.noise_scale != 50 or smodel.encoder_mod.flow is None:
        fail("the stage-2 model is not the stage-2 configuration")
    tx = build_train_optimizer()
    state = init_train_state(smodel, tx)
    step = make_train_step(smodel, tx, trainable_filter=lambda path: "aligner" in path)
    gen2 = torch.Generator(device=dev).manual_seed(9)
    cand, best, selected = select_best_noise(smodel, batch, num=10, generator=gen2)
    sbatch = dict(batch, noise=selected)
    names = [n for n, _ in smodel.named_parameters()]
    p0 = [p.detach().clone() for p in smodel.parameters()]
    for i in range(3):
        state, metrics = step(state, sbatch, 5, 0)
        m = {k: float(v) for k, v in metrics.items()}
        print(f"  stage-2 step {i}: " + json.dumps(
            {k: round(m[k], 5) for k in need + ("prior_loss", "skipped_nonfinite")}))
        if any(not np.isfinite(v) for v in m.values()) or m["skipped_nonfinite"] != 0.0:
            fail(f"a stage-2 step gave {m}")

    def changed_and_moved():
        changed = {n for n, a, b in zip(names, p0, smodel.parameters()) if not torch.equal(a, b)}
        return changed, {n for n, mu in zip(names, state.opt_state["mu"]) if bool((mu != 0).any())}

    changed, moved = changed_and_moved()
    # kl_weight is 0 in this configuration, so the flows' gradient is exactly 0,
    # and the aligner's pre_norm is never applied (a quirk kept): no moments there.
    expect_moved = {n for n in names if ".flow." not in n and "aligner.pre_norm" not in n}
    trainable = {n for n in names if "aligner" in n.split(".") and "pre_norm" not in n}
    print(f"stage 2: candidates {tuple(cand.shape)}, best {best[:8].tolist()}...; "
          f"{len(changed)} of {len(names)} parameters changed (the aligner's {len(trainable)}), "
          f"{len(moved)} have Adam moments (every one with a gradient: {len(expect_moved)})")
    if changed != trainable:
        fail(f"stage 2 changed {sorted(changed ^ trainable)[:5]} against the aligner filter")
    if moved != expect_moved:
        fail(f"stage 2 moments differ from the parameters with a gradient: "
             f"{sorted(moved ^ expect_moved)[:5]}")
    # One more step with the flow prior weighted (the class's default 1e-3): the
    # forward flows' logpx gradient runs at full width. Each coupling layer's
    # s/t head (dense2) starts at zero and the filter keeps it there, so it is
    # the heads that gain moments: nothing flows back through a zero kernel.
    smodel.encoder_mod.kl_weight = 1e-3
    state, metrics = step(state, sbatch, 5, 0)
    m = {k: float(v) for k, v in metrics.items()}
    changed, moved = changed_and_moved()
    with_prior = expect_moved | {n for n in names if ".flow." in n and ".dense2." in n}
    print(f"  stage-2 step with kl_weight 1e-3: " + json.dumps(
        {k: round(m[k], 5) for k in need + ("prior_loss", "skipped_nonfinite")})
        + f"; {len(moved)} of {len(names)} parameters have Adam moments "
        f"(every one with a gradient: {len(with_prior)})")
    if any(not np.isfinite(v) for v in m.values()) or m["skipped_nonfinite"] != 0.0:
        fail(f"the stage-2 step with the prior weighted gave {m}")
    if m["prior_loss"] == 0.0 or changed != trainable or moved != with_prior:
        fail(f"the stage-2 step with the prior weighted: prior_loss {m['prior_loss']}, "
             f"{sorted(changed ^ trainable)[:5]} changed, {sorted(moved ^ with_prior)[:5]} moments")
    del smodel, state, step, tx, p0
    torch.cuda.empty_cache()

    # One step at a small batch on the card and on the CPU: p = 0, t, the
    # diffusion noise and the aligner noise injected. Batch 8, not less: the
    # per-part heads' BatchNorm takes its statistics over the batch, and over 2
    # shapes it turns bf16 rounding into a 3 % change of the fit loss.
    rng = np.random.RandomState(21)
    small = example_batch(STEP_CHECK_BATCH, 2048, seed=4)
    small.update(diffusion_t=rng.randint(0, 100, (STEP_CHECK_BATCH,)).astype(np.int64),
                 diffusion_noise=rng.randn(STEP_CHECK_BATCH, 2048, 3).astype(np.float32),
                 noise=rng.randn(STEP_CHECK_BATCH, 32).astype(np.float32))
    runs = {}
    for where in ("cuda", "cpu"):
        cm = build_train_model(where, dropout=0.0)
        tx = build_train_optimizer()
        t0 = time.perf_counter()
        st, met = make_train_step(cm, tx)(init_train_state(cm, tx), to_device(small, where), 0, 0)
        runs[where] = ({k: float(v) for k, v in met.items()},
                       [p.detach().float().cpu() for p in cm.parameters()])
        print(f"one step at batch {STEP_CHECK_BATCH} on {where}: {time.perf_counter() - t0:.1f} s, "
              + json.dumps({k: round(v, 5) for k, v in sorted(runs[where][0].items())}))
    (mc, pc), (mh, ph) = runs["cuda"], runs["cpu"]
    worst = max(abs(mc[k] - mh[k]) / max(abs(mh[k]), 1e-12) for k in mh
                if k not in ("grad_norm", "skipped_nonfinite", "kl_weight"))
    gn = abs(mc["grad_norm"] - mh["grad_norm"]) / mh["grad_norm"]
    diffs = torch.cat([(a - b).abs().flatten() for a, b in zip(pc, ph)])
    print(f"card vs CPU step: loss dict off by at most {worst:.3e} (tol {STEP_LOSS_RTOL}), "
          f"grad_norm {mc['grad_norm']:.4f} vs {mh['grad_norm']:.4f} off by {gn:.3e} "
          f"(tol {STEP_GNORM_RTOL}); updated parameters: mean abs difference "
          f"{diffs.mean().item() / LR:.4f} lr (tol {STEP_PARAM_MEAN_LR} lr), max "
          f"{diffs.max().item() / LR:.3f} lr (at most 2 lr by construction)")
    if not worst <= STEP_LOSS_RTOL or not gn <= STEP_GNORM_RTOL:
        fail("the training step on the card disagrees with the CPU")
    if not diffs.mean().item() <= STEP_PARAM_MEAN_LR * LR or not diffs.max().item() <= 2.02 * LR:
        fail("the updated parameters on the card disagree with the CPU")
    del runs
    torch.cuda.empty_cache()

    phase("8 two-attention gen_chair generation and UNet, full width")
    t_phase = time.perf_counter()
    from difffacto_torch.models import denoiser

    # The entry's first launch at batch 16 and at batch 256 (a part absent in
    # some rows: tiles of rows with other masks and other K1, V1 on each
    # block's walk, 2 and 32 tiles a block) is kept and held below.
    two_rec = KernelRecorder((denoiser, "fused_core_two_attn"))
    valid = torch.ones(BATCH_CHECK, 4, device=dev)
    valid[1::3, 2] = 0.0
    for noise_scale in (100, 1):
        model = build_model(noise_scale, dev, single_attn=False)
        zero_launches("fused_ff", "fused_core", "fused_block", "fused_core_two_attn")
        with two_rec:
            pred = sample_generation(model, BATCH_CHECK, valid_id=valid,
                                     generator=torch.Generator(device=dev).manual_seed(0))["pred"]
        torch.cuda.synchronize()
        two_counts = kernel_launches("fused_ff", "fused_core", "fused_block", "fused_core_two_attn")
        if torch.isfinite(pred).all():
            break
        two_rec.first.clear()
        print(f"non-finite samples at aligner noise_scale {noise_scale}; lowering it to 1")
    else:
        fail("two-attention generation: non-finite samples")
    depth = len(model.net.blocks)
    expected = dict(fused_ff=0, fused_core=0, fused_block=0,
                    fused_core_two_attn=model.num_timesteps)
    print(f"noise_scale {noise_scale}, batch {BATCH_CHECK}: pred {tuple(pred.shape)}, launches "
          f"{two_counts}, expected {expected} (the aligner's T = {4 * BATCH_CHECK} takes the "
          f"unfused FF)")
    if tuple(pred.shape) != (BATCH_CHECK, 2048, 3):
        fail(f"two-attention generation: pred has shape {tuple(pred.shape)}")
    if two_counts != expected:
        fail(f"two-attention generation launched {two_counts}, expected {expected}")

    rng = np.random.RandomState(1)
    draws = dict(
        z=rng.randn(1, 4, 256), cimle_noise=rng.randn(1, 32),
        noise=rng.randn(1, 2048, 3), step_noise=rng.randn(model.num_timesteps, 1, 2048, 3),
    )
    runs = {}
    for where, m in (("cuda", model), ("cpu", build_model(noise_scale, "cpu", single_attn=False))):
        d = {k: torch.as_tensor(v, dtype=torch.float32, device=where) for k, v in draws.items()}
        t0 = time.perf_counter()
        runs[where] = sample_generation(
            m, 1, valid_id=torch.as_tensor(valid1, dtype=torch.float32, device=where), **d
        )["pred"].float().cpu()
        print(f"two-attention batch-1 generation on {where}: {time.perf_counter() - t0:.1f} s")
    diff = (runs["cuda"] - runs["cpu"]).abs()
    two_rel = (diff.norm() / runs["cpu"].norm()).item()
    print(f"card vs CPU plain trunk: max abs {diff.max().item():.4e}, relative L2 {two_rel:.4e} "
          f"(tol {E2E_REL_L2})")
    if not torch.isfinite(runs["cuda"]).all() or two_rel > E2E_REL_L2:
        fail("two-attention generation on the card disagrees with the CPU plain version")

    valid = torch.ones(TWO_ATTN_BATCH_TIMED, 4, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    warm = valid.clone()
    warm[::5, 0] = warm[2::7, 3] = 0.0
    with two_rec:
        sample_generation(model, TWO_ATTN_BATCH_TIMED, valid_id=warm, generator=gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches("fused_ff", "fused_core_two_attn")
    t0 = time.perf_counter()
    for _ in range(TWO_ATTN_ITERS):
        sample_generation(model, TWO_ATTN_BATCH_TIMED, valid_id=valid, generator=gen)
    torch.cuda.synchronize()
    two_dt = (time.perf_counter() - t0) / TWO_ATTN_ITERS
    timed = kernel_launches("fused_ff", "fused_core_two_attn")
    two_per_gen = timed["fused_ff"] / TWO_ATTN_ITERS
    trunk_per_gen = timed["fused_core_two_attn"] / TWO_ATTN_ITERS
    two_peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"two-attention gen_chair batch {TWO_ATTN_BATCH_TIMED}: "
          f"{TWO_ATTN_BATCH_TIMED / two_dt:.2f} shapes/s ({two_dt:.3f} s per batch), peak memory "
          f"{two_peak:.2f} GiB, {two_per_gen:.0f} fused_ff and {trunk_per_gen:.0f} two-attention "
          f"trunk launches per generation")
    if (two_per_gen, trunk_per_gen) != (depth, model.num_timesteps):
        fail(f"{two_per_gen} fused_ff and {trunk_per_gen} trunk launches per "
             f"batch-{TWO_ATTN_BATCH_TIMED} generation, expected {depth} and "
             f"{model.num_timesteps}")
    del model, runs, pred
    torch.cuda.empty_cache()

    # The entry as the generations launched it, held against its plain
    # version; then timed at batch 256 on the warm-up's recorded inputs,
    # beside its plain version and its bound on those inputs.
    two_err = two_rec.hold_core("phase 8", "fused_core_two_attn")
    kept = dict(two_rec.launches("fused_core_two_attn", "phase 8"))
    if sorted(kept) != [(BATCH_CHECK, 2048), (TWO_ATTN_BATCH_TIMED, 2048)]:
        fail(f"phase 8 kept two-attention trunk launches at {sorted(kept)}")
    targs = kept[(TWO_ATTN_BATCH_TIMED, 2048)][0]
    ops = [a for a in targs if torch.is_tensor(a)]
    with uncounted("fused_core_two_attn"):
        two_ms = cuda_ms(lambda: fc.fused_core_two_attn(*targs), 20)
        with torch.inference_mode():
            two_plain_ms = cuda_ms(lambda: core_reference("fused_core_two_attn", targs), 3)
    two_bound, two_by = trunk_bound_ms(ops, TWO_ATTN_BATCH_TIMED * 2048 * fc.D * 2,
                                       in_ch=ops[0].shape[-1], depth=depth, attn1=True)
    print(f"fused_core_two_attn B={TWO_ATTN_BATCH_TIMED} N=2048 (the warm-up's inputs): "
          f"{two_ms:.3f} ms, bound {two_bound:.3f} ms ({two_by}), "
          f"{100 * two_bound / two_ms:.1f}% of roofline; plain version {two_plain_ms:.3f} ms; "
          f"100 launches are {100 * 100 * two_ms / (1e3 * two_dt):.1f}% of a batch's generation")
    two_attn = {
        "name": "fused_core_two_attn", "route": "cuda",
        "source": "difffacto_torch/csrc/fused_core.cu",
        "replaces": "difffacto_tpu/models/denoiser.py:301-309 (the blocks one by one)",
        "launches": two_counts["fused_core_two_attn"], "max_abs_err": two_err, "ms": two_ms,
        "plain_ms": two_plain_ms, "bound_ms": two_bound, "bound_by": two_by, "library_ms": None,
        "launches_per_generation_batch256": trunk_per_gen,
        "gen_shapes_per_s_batch256": TWO_ATTN_BATCH_TIMED / two_dt,
    }
    del two_rec, kept, targs, ops
    torch.cuda.empty_cache()

    # UNet: one forward at full size, counted; then batch 2 against the CPU.
    unet = build_unet(dev)
    x, t, ctx, vid = unet_inputs(UNET_BATCH, dev, seed=2)
    zero_launches("fused_block")
    with torch.inference_mode():
        y = unet(x, t, ctx, valid_id=vid)
    torch.cuda.synchronize()
    unet_launches = kernel_launches("fused_block")["fused_block"]
    print(f"UNet B={UNET_BATCH} N=2048: out {tuple(y.shape)} {y.dtype}, fused_block launches "
          f"{unet_launches} (expected {len(unet.prior_blocks)})")
    if tuple(y.shape) != (UNET_BATCH, 2048, 3) or not torch.isfinite(y).all():
        fail("UNet output not finite (256, 2048, 3)")
    if unet_launches != len(unet.prior_blocks):
        fail(f"UNet launched fused_block {unet_launches} times, expected {len(unet.prior_blocks)}")
    unet_ms = cuda_ms(torch.inference_mode()(lambda: unet(x, t, ctx, valid_id=vid)), 3)
    del y, x, t, ctx, vid
    ys = {}
    for where, net in (("cuda", unet), ("cpu", build_unet("cpu"))):
        inp = unet_inputs(2, where, seed=4)
        with torch.inference_mode():
            ys[where] = (net(inp[0], inp[1], inp[2], valid_id=inp[3]) - inp[0]).float().cpu()
    unet_rel = ((ys["cuda"] - ys["cpu"]).norm() / ys["cpu"].norm()).item()
    print(f"UNet forward {unet_ms:.2f} ms at B={UNET_BATCH}; card vs CPU at batch 2: relative "
          f"L2 {unet_rel:.4e} of what the net adds (tol {UNET_REL_L2})")
    if not unet_rel <= UNET_REL_L2:
        fail("the UNet forward on the card disagrees with the CPU plain version")
    del unet
    torch.cuda.empty_cache()

    # The two kernels at the main paths' shapes, with their plain versions and bounds.
    args = ff_operands(128, TWO_ATTN_BATCH_TIMED * 2048, dev, seed=5)
    with uncounted("fused_ff"):
        ff_bound, ff_by = ff_bound_ms(args, args[0].numel() * 2)
        ff_ms = cuda_ms(lambda: ff.fused_ln_geglu_ff(*args), 20)
        ff_plain_ms = cuda_ms(lambda: ff.fused_ln_geglu_ff_reference(*args), 3)
        args256 = ff_operands(256, 4 * TWO_ATTN_BATCH_TIMED, dev, seed=6)
        ff_ms_256 = cuda_ms(lambda: ff.fused_ln_geglu_ff(*args256), 20)
        ff_graph_ms_256 = graph_ms(lambda: ff.fused_ln_geglu_ff(*args256), 20)
        ff_plain_ms_256 = cuda_ms(lambda: ff.fused_ln_geglu_ff_reference(*args256), 20)
        ff_bound_256 = ff_bound_ms(args256, args256[0].numel() * 2)[0]
    print(f"fused_ff T={args[0].shape[0]} D=128: {ff_ms:.3f} ms, bound {ff_bound:.3f} ms "
          f"({ff_by}), {100 * ff_bound / ff_ms:.1f}% of roofline; plain version "
          f"{ff_plain_ms:.3f} ms; "
          f"T=1024 D=256: {ff_ms_256:.4f} ms ({ff_graph_ms_256:.4f} as a CUDA graph of 20 "
          f"launches), bound "
          f"{ff_bound_256:.4f} ms, plain version {ff_plain_ms_256:.3f} ms")
    del args, args256
    mask = np.ones((UNET_BATCH, fb.CTX), np.float32)
    mask[::3, 1] = 0.0
    args = fc.operands(fb.example_inputs(UNET_BATCH, 2048, seed=7, mask=mask), dev, torch.bfloat16)
    with uncounted("fused_block"):
        block_bound, block_by = block_bound_ms(args, args[0].numel() * 2)
        block_ms = cuda_ms(lambda: fb.fused_block(*args, 0.25), 20)
        block_plain_ms = cuda_ms(lambda: fb.fused_block_reference(*args, 0.25), 3)
    print(f"fused_block B={UNET_BATCH} N=2048: {block_ms:.3f} ms, bound {block_bound:.3f} ms "
          f"({block_by}), {100 * block_bound / block_ms:.1f}% of roofline; plain version "
          f"{block_plain_ms:.3f} ms; 5 launches are {100 * 5 * block_ms / unet_ms:.1f}% of the "
          f"UNet forward")
    del args
    print(f"phase 8: {time.perf_counter() - t_phase:.1f} s")

    phase("9 runner, full width")
    import tempfile

    kept = tempfile.TemporaryDirectory()
    run9 = runner_phase(dev, fc, fct, fpsm, eh, ff, fb, kept.name)
    on_path = run9["launches"]

    phase("10 reconstruction and editing, full width")
    run10 = editing_phase(dev, fc, fct, fpsm, eh, ff, fb)
    editing_launches = run10["launches"]

    phase("11 DDIM, guidance and the chain's variants, full width")
    run11 = chain_phase(dev, fc, eh, noise_scale, run9["checkpoint"])

    phase("12 JAX checkpoints, two-attention and UNet training, per-part pretraining, "
          "full width")
    run12 = phase12(dev, fc, fct, fpsm, eh, ff, fb, run9["checkpoint"])
    kept.cleanup()

    phase("13 multi-GPU")
    mg_launches = multi_gpu_phase(dev, noise_scale, phase6)

    phase("14 the GAN, language and mixing runners, PDM on PointNet++, full width")
    run14 = phase14(dev, fc, fct, fpsm, eh, ff, fb)
    p14 = {f"launches_{path}": run14[path]["launches"]
           for path in ("gan", "language", "mixing", "pdm")}

    def phase14_launches(name):
        return {k: v[name] for k, v in p14.items()}

    phase("15 AnchorDiffAE's other encoders and the anchored generators, full width")
    run15 = phase15(dev, noise_scale, phase6["refs"])

    def slice15(name):
        return {"launches_slice15": run15["launches"][name]}

    phase("16 the latent editors, the super-segment generator, completion and PointFlow, "
          "full width")
    run16 = phase16(dev, phase6["refs"])

    def slice16(name):
        return {"launches_slice16": run16["launches"][name]}

    phase("17 B1's fused tail and its switches, data/custom.py's DATASETS and the data tools, "
          "full width")
    run17 = phase17(dev, noise_scale, gen5)
    del gen5

    def slice17(name):
        return {"launches_slice17": run17["launches"][name]}

    print(card)
    trunk["launches_runner"] = on_path["fused_core"]
    trunk["launches_editing"] = editing_launches["fused_core"]
    trunk["max_abs_err"] = max(trunk["max_abs_err"], run9["core_err"], run10["errs"]["fused_core"])
    trunk["editing_paths"] = run10["paths"]
    trunk["editing_z_grad_rel_l2"] = run10["grad_rel"]
    trunk.update({k: v for k, v in run11.items() if not k.startswith("headless")})
    trunk["launches_msgpack_val_gen"] = run12["msgpack"]["launches"]["fused_core"]
    trunk["msgpack_load_s"] = run12["msgpack"]["load_s"]
    trunk["pt_load_s"] = run12["msgpack"]["load_pt_s"]
    trunk["launches_pretrain"] = run12["pretrain"]["launches"]["fused_core"]
    trunk["pretrain_epoch_and_val_s"] = run12["pretrain"]["s"]
    trunk["launches_multi_gpu"] = mg_launches["fused_core"]
    trunk.update(phase14_launches("fused_core"), gan_epoch_s=run14["gan"]["epoch_s"],
                 gan_val_s=run14["gan"]["val_s"], language_epoch_s=run14["language"]["epoch_s"],
                 mixing_s=run14["mixing"]["s"])
    trunk["max_abs_err"] = max(trunk["max_abs_err"], run14["gan"]["core_err"],
                               run14["mixing"]["core_err"], run15["td"]["core_err"])
    trunk.update(slice15("fused_core"), slice15_td_generation_s=run15["td"]["gen_s"],
                 slice15_s=run15["s"], **slice16("fused_core"), slice16_s=run16["s"],
                 **slice17("fused_core"), slice17_s=run17["s"])
    trunk["max_abs_err"] = max(trunk["max_abs_err"], run17["mixing"]["core_err"])
    headless = {
        "name": "fused_core_headless", "route": "cuda",
        "source": "difffacto_torch/csrc/fused_core.cu",
        "replaces": "difffacto_tpu/ops/fused_core.py:33", "launches": run11["headless_launches"],
        "max_abs_err": max(headless_err, run11["headless_err"]), "ms": run11["headless_ms"],
        "plain_ms": run11["headless_plain_ms"], "bound_ms": run11["headless_bound_ms"],
        "bound_by": run11["headless_bound_by"], "library_ms": None,
        "launches_multi_gpu": mg_launches["fused_core_headless"],
        **phase14_launches("fused_core_headless"), **slice15("fused_core_headless"),
        **slice16("fused_core_headless"), **slice17("fused_core_headless"),
        "slice17_max_abs_err": run17["generation"]["fused_core_headless_err"],
    }
    p17k, p17g = run17["kernels"], run17["generation"]
    tails = [{
        "name": name, "route": "cuda", "source": "difffacto_torch/csrc/fused_core.cu",
        "replaces": "difffacto_tpu/ops/fused_core.py:33",
        "launches": p17g[f"{name}_launches"],
        "max_abs_err": max(p17k[name]["max_abs_err"], p17g[f"{name}_err"]),
        "ms": p17k[name]["ms"], "plain_ms": p17k[name]["plain_ms"],
        "bound_ms": p17k[name]["bound_ms"], "bound_by": p17k[name]["bound_by"],
        "library_ms": None, "out_channels": P17_OUT,
        "ms_without_tail": p17k[name]["trunk_ms"],
        "ms_without_tail_then_proj_out": p17k[name]["trunk_and_proj_out_ms"],
        "launches_multi_gpu": mg_launches[name], **phase14_launches(name), **slice15(name),
        **slice16(name), **slice17(name),
    } for name in TAIL_ENTRIES]
    tails[0].update(gen_shapes_per_s_default=p17g["default_shapes_per_s"],
                    gen_shapes_per_s_fuse_tail=p17g["tail_shapes_per_s"],
                    gen_card_vs_cpu_rel_l2=p17g["tail_card_vs_cpu_rel_l2"])
    sa = run14["pointnet2"]
    print(json.dumps({"kernels": [trunk, headless, *tails, two_attn, {
        "name": "fps", "route": "cuda", "source": "difffacto_torch/csrc/fps.cu",
        "replaces": "difffacto_tpu/ops/fps_pallas.py:27", "launches": counts["fps"],
        "max_abs_err": fps_diff, "ms": fps_ms, "plain_ms": fps_plain_ms, "bound_ms": fps_bound,
        "bound_by": fps_by, "library_ms": None, "cluster": fps_t[R]["cluster"],
        "ms_cluster_1": fps_t[R]["ms_c1"], "latency_floor_ms": fps_t[R]["floor"],
        "latency_floor_ms_cluster_1": fps_t[R]["floor_c1"], "ms_at_32_clouds": fps_t[32]["ms"],
        "ms_at_32_clouds_cluster_1": fps_t[32]["ms_c1"], "ms_at_400_clouds": fps_t[400]["ms"],
        "bound_ms_at_400_clouds": fps_t[400]["bound"],
        "latency_floor_ms_at_400_clouds": fps_t[400]["floor"],
        "launches_runner": on_path["fps"], "crop_loader_s": run9["crop_s"],
        "launches_editing": editing_launches["fps"], "launches_multi_gpu": mg_launches["fps"],
        **phase14_launches("fps"),
        **{f"{k}_at_sa_{shape}": v for shape in (f"{n}_to_{m}" for n, m in SA_FPS)
           for k, v in sa[shape].items()},
        "pdm_train_step_ms": run14["pdm"]["step_ms"], "pdm_predict_s": run14["pdm"]["predict_s"],
        **slice15("fps"), **slice16("fps"), **slice17("fps"),
        **{f"{cls}_{k}": v for cls in ("PointNet2SSG", "PointNet2MSG") for k, v in sa[cls].items()},
    }, {
        "name": "emd_hybrid", "route": "cuda", "source": "difffacto_torch/csrc/emd_hybrid.cu",
        "replaces": "difffacto_tpu/ops/emd_pallas.py:51", "launches": counts["emd_hybrid"],
        "max_abs_err": max(emd_diff, run10["errs"]["emd_hybrid"]), "ms": emd[132][0],
        "plain_ms": emd_plain_ms,
        "bound_ms": emd[132][1], "bound_by": emd[132][2], "library_ms": None, "pairs": 132,
        "ms_at_132_pairs": emd[132][0], "sinkhorn_ms_at_132_pairs": emd[132][3],
        "auction_ms_at_132_pairs": emd[132][0] - emd[132][3],
        "ms_at_32_pairs": emd[32][0], "bound_ms_at_32_pairs": emd[32][1],
        "sinkhorn_ms_at_32_pairs": emd[32][3], "auction_ms_at_32_pairs": emd[32][0] - emd[32][3],
        "protocol_launches_pairs_ms": [[b, s.elapsed_time(e)] for s, e, b in emd_events],
        "protocol_s": t_eval, "launches_runner": on_path["emd_hybrid"],
        "launches_editing": editing_launches["emd_hybrid"],
        "launches_msgpack_val_gen": run12["msgpack"]["launches"]["emd_hybrid"],
        "launches_multi_gpu": mg_launches["emd_hybrid"], **phase14_launches("emd_hybrid"),
        **slice15("emd_hybrid"), **slice16("emd_hybrid"), **slice17("emd_hybrid"),
    }, {
        "name": "fused_trunk_train_fwd", "route": "cuda",
        "source": "difffacto_torch/csrc/fused_core_train.cu",
        "replaces": "difffacto_tpu/ops/fused_core_train.py:120",
        "launches": train_counts["fused_trunk_train_fwd"],
        "max_abs_err": max(train_fwd_err, run9["train_fwd_err"], run15["td"]["train_errs"][0],
                           run17["partnet"]["train_errs"][0]),
        "ms": fwd_ms, "plain_ms": plain_fwd_ms, "bound_ms": bounds["fwd"][0],
        "bound_by": bounds["fwd"][1], "library_ms": None,
        "launches_runner": on_path["fused_trunk_train_fwd"],
        "launches_editing": editing_launches["fused_trunk_train_fwd"],
        "launches_multi_gpu": mg_launches["fused_trunk_train_fwd"],
        **phase14_launches("fused_trunk_train_fwd"), **slice15("fused_trunk_train_fwd"),
        **slice16("fused_trunk_train_fwd"), **slice17("fused_trunk_train_fwd"),
        "slice15_cvae_train_step_ms": run15["td"]["train"]["step_ms"],
    }, {
        "name": "fused_trunk_train_bwd", "route": "cuda",
        "source": "difffacto_torch/csrc/fused_core_train.cu",
        "replaces": "difffacto_tpu/ops/fused_core_train.py:162",
        "launches": train_counts["fused_trunk_train_bwd"],
        "max_abs_err": max(train_bwd_err, run9["train_bwd_err"], run15["td"]["train_errs"][1],
                           run17["partnet"]["train_errs"][1]),
        "ms": bwd_ms, "plain_ms": plain_bwd_ms, "bound_ms": bounds["bwd"][0],
        "bound_by": bounds["bwd"][1], "library_ms": None,
        "bound_ms_jax_inputs": bounds["bwd_jax_inputs"][0], "train_step_ms": step_ms,
        "train_step_host_ms": host_ms,
        "train_shapes_per_s": 1e3 * TRAIN_BATCH / step_ms, "train_peak_gib": train_peak_gib,
        "launches_runner": on_path["fused_trunk_train_bwd"],
        "launches_editing": editing_launches["fused_trunk_train_bwd"],
        "launches_multi_gpu": mg_launches["fused_trunk_train_bwd"],
        **phase14_launches("fused_trunk_train_bwd"), **slice15("fused_trunk_train_bwd"),
        **slice16("fused_trunk_train_bwd"), **slice17("fused_trunk_train_bwd"),
        "runner_epoch_s_first": run9["epoch_s_first"],
        "runner_epoch_s_later": run9["epoch_s_later"],
        "runner_epoch_s_later_min": run9["epoch_s_later_min"],
        "runner_epoch_s_later_max": run9["epoch_s_later_max"],
        "runner_shapes_per_s": run9["shapes_per_s"], "runner_cache_noise_s": run9["cache_noise_s"],
        "runner_val_s": run9["val_s"], "runner_val_gen_s": run9["val_gen_s"],
        "runner_idle_share": run9["idle_share"], "runner_later_epoch_ms": run9["later_epoch_ms"],
        "runner_device_busy_ms": run9["device_busy_ms"],
        "runner_device_ops_per_step": run9["device_ops_per_step"],
        "runner_syncs_per_step": run9["syncs_per_step"],
        "runner_loader_epoch_s": run9["loader_epoch_s"],
        "runner_loader_epoch_s_each": run9["loader_epoch_s_each"],
        "runner_peak_gib": run9["peak_gib"], "runner_step_against_cpu": run9["against_cpu"],
    }, {
        "name": "fused_block", "route": "cuda", "source": "difffacto_torch/csrc/fused_core.cu",
        "replaces": "difffacto_tpu/ops/fused_block.py:24", "launches": unet_launches,
        "max_abs_err": block_err, "ms": block_ms, "plain_ms": block_plain_ms,
        "bound_ms": block_bound, "bound_by": block_by, "library_ms": None,
        "unet_forward_ms": unet_ms, "launches_runner": on_path["fused_block"],
        "launches_editing": editing_launches["fused_block"],
        "launches_unet_training": run12["unet"]["launches"]["fused_block"],
        "launches_multi_gpu": mg_launches["fused_block"], **phase14_launches("fused_block"),
        **slice15("fused_block"), **slice16("fused_block"), **slice17("fused_block"),
        "unet_train_step_ms": run12["unet"]["step_ms"],
    }, {
        "name": "fused_ff", "route": "cuda", "source": "difffacto_torch/csrc/fused_ff.cu",
        "replaces": "difffacto_tpu/ops/fused_ff.py:26", "launches": two_counts["fused_ff"],
        "max_abs_err": max(ff_err, run10["errs"]["fused_ff"], run16["ldm"]["two_attn"]["ff_err"]),
        "ms": ff_ms,
        "plain_ms": ff_plain_ms, "bound_ms": ff_bound,
        "bound_by": ff_by, "library_ms": None, "ms_at_t1024_d256": ff_ms_256,
        "graph_ms_at_t1024_d256": ff_graph_ms_256,
        "bound_ms_at_t1024_d256": ff_bound_256, "plain_ms_at_t1024_d256": ff_plain_ms_256,
        "two_attn_shapes_per_s": TWO_ATTN_BATCH_TIMED / two_dt, "two_attn_peak_gib": two_peak,
        "launches_runner": on_path["fused_ff"], "launches_editing": editing_launches["fused_ff"],
        "launches_two_attn_training": run12["two_attn"]["launches"]["fused_ff"],
        "two_attn_train_step_ms": run12["two_attn"]["step_ms"],
        "ms_at_search_d256": run10["search_ff"]["ms"],
        "plain_ms_at_search_d256": run10["search_ff"]["plain_ms"],
        "bound_ms_at_search_d256": run10["search_ff"]["bound_ms"],
        "search_tokens": run10["search_ff"]["tokens"],
        "editing_path_launches_reported": run10["ff_path"],
        "launches_multi_gpu": mg_launches["fused_ff"], **phase14_launches("fused_ff"),
        **slice15("fused_ff"), **slice16("fused_ff"), **slice17("fused_ff"),
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        multi_gpu_rank(sys.argv[2:])
    else:
        main()
