#!/usr/bin/env python3
"""Run the PyTorch port on one CUDA card and check it: gen_chair generation,
the eval protocol that scores what was generated, the gen_chair training
step, gen_chair generation with two-attention blocks beside the UNet
denoiser, and the training loop users run (the runner and its CLI).

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
   31 or 32 for each block of the persistent grid), the training trunk's forward and its backward (dx, dK, dV and the 15
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
   denoiser. Batch-16 generation with launch counts set to 0 just before and
   read just after: 500 fused-FF launches (5 blocks x 100 steps; the
   aligner's T = 64 takes the unfused FF) and no trunk launch; a batch-1 run
   with every draw injected against the same model on the CPU; generation at
   batch 256 (1 warm-up, 2 timed runs, 505 fused-FF launches each: the
   aligner's T = 1024 takes the kernel). Then a UNet forward at B = 256 x 2048
   with the gen_chair denoiser's widths (3 channels, 8 x 16, depth 5, part
   tokens (B, 4, 522) with parts absent): 5 one-block launches, and at batch 2
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
   (bf16) is held against a CPU runner (float32) resumed from the same
   checkpoint, on one batch with every draw injected and dropout off;
   ``--task val_gen --gen_num 64`` gives 12 finite metrics. Then a
   ``CroppingDataLoader`` over SyntheticPart at 8192 points, batch 32, crop
   [2048, 6144): partial and missing of (32, 2048, 3), each point one of its
   input cloud, 2 FPS launches a batch, each held index for index against
   the plain FPS. Printed: the first epoch's seconds; the median, least and
   most of 12 later epochs at the configuration's log interval and the
   training shapes/s from that median; the cache, val and val_gen seconds; a
   later epoch's device idle share; 5 passes of the loader alone; the peak
   memory. One JSON line then gives every kernel's numbers, with its
   launches in phase 9 (``launches_runner``).

The last line is {"ok": true, "device": {...}}.
"""

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
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
BATCH_CHECK, BATCH_TIMED, WARMUP, ITERS = 16, 256, 1, 3

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


def trunk_bound_ms(args, out_bytes, in_ch, depth):
    """The least time for one trunk launch: its operations over the bf16 peak
    against its bytes (inputs read once, output written once) over HBM."""
    from difffacto_torch.ops import fused_core as fc

    B, N = args[0].shape[:2]
    macs = in_ch * fc.D + depth * (
        2 * fc.D * fc.D + 2 * fc.HEADS * fc.CTX * (fc.D // fc.HEADS) + 3 * fc.D * fc.FF
    )
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


def build_train_model(device, stage2=False, dropout=0.2):
    from difffacto_torch import MODELS, Config, build_from_cfg

    name = "train_chair_stage2.py" if stage2 else "gen_chair.py"
    mcfg = Config(os.path.join(ROOT, "configs", name)).model.dump()
    mcfg.update(npoints=2048, ret_traj=False, dtype=torch.bfloat16)
    mcfg["diffusion"]["net"]["dropout"] = dropout
    if not stage2:
        mcfg["gen"] = False
        mcfg["encoder"]["gen"] = False
    return build_from_cfg(mcfg, MODELS, device=device, seed=0)


def build_train_optimizer():
    from difffacto_torch.parallel import build_optimizer_from_cfg

    return build_optimizer_from_cfg(
        dict(type="Adam", lr=LR, weight_decay=0.0),
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


def emd_bound_ms(n, bids, sinkhorn_iters=150, rows=None):
    """EMD assignment: per pair 2 * sinkhorn_iters sweeps of rows * n elements
    for the Sinkhorn, and n elements for each bid this run computed (only
    unassigned rows bid; ``bids`` is the kernel's count per pair, the
    force-assigned rows included). An element is a distance (10 f32 operations
    and a square root) and in a Sinkhorn sweep one exp. The larger of the f32
    time and the special-function time, against 28 n bytes a pair."""
    rows = n if rows is None else rows
    sink = 2.0 * sinkhorn_iters * rows * n * len(bids)
    auction = float(sum(bids)) * n
    t_f32 = (sink + auction) * 10 / PEAK_F32_FLOPS * 1e3
    t_sfu = (sink * 2 + auction) / PEAK_SFU_OPS * 1e3
    t_bytes = len(bids) * n * 28 / PEAK_BYTES * 1e3
    t_ops = max(t_f32, t_sfu)
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def matched_cost(a, b, assign):
    matched = torch.gather(b, 1, assign.long()[..., None].expand(-1, -1, 3))
    return (a - matched).norm(dim=-1).mean(dim=1)


def seeded_clouds(B, N, seed, distinct=None):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, distinct or N, 3).astype(np.float32)
    if distinct:
        x = np.tile(x, (1, N // distinct, 1))
    return torch.as_tensor(x)


def build_model(noise_scale, device, single_attn=True):
    from difffacto_torch import MODELS, Config, build_from_cfg

    mcfg = Config(os.path.join(ROOT, "configs", "gen_chair.py")).model.dump()
    mcfg.update(npoints=2048, ret_traj=False, cimle_sample_num=1, dtype=torch.bfloat16)
    mcfg["encoder"]["part_aligner"].update(noise_scale=noise_scale, single_attn=single_attn)
    mcfg["diffusion"]["net"]["single_attn"] = single_attn
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
# One step of the card's runner (bf16, the dtype of the trunk kernels) against
# the CPU's (float32, the precision of the reference configuration): the same
# resumed weights and moments, one loader batch, every draw injected, dropout
# off. The loss dict and grad_norm are held to STEP_LOSS_RTOL and
# STEP_GNORM_RTOL, the mean absolute difference of the two updates to a
# quarter of the CPU's mean absolute update. bf16 rounds the inputs of every
# product (a relative 2^-9 each); a wrong kernel or schedule gives O(1).
RUNNER_UPDATE_REL = 0.25
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


class KernelRecorder:
    """While entered, wraps the two trunk functions where the denoiser calls
    them and records the first trunk launch at each (B, N) (its inputs and
    output) and the first training-trunk launch (its inputs, output, the
    cotangent the step gave it and the 18 gradients it returned), so that
    ``hold`` can hold what the main path computed against the plain versions."""

    def __init__(self):
        from difffacto_torch.models import denoiser

        self.module = denoiser
        self.real_core, self.real_train = denoiser.fused_core, denoiser.fused_trunk_train
        self.core, self.train = {}, None

    def __enter__(self):
        self.module.fused_core, self.module.fused_trunk_train = self._core, self._train
        return self

    def __exit__(self, *exc):
        self.module.fused_core = self.real_core
        self.module.fused_trunk_train = self.real_train

    def _core(self, *args):
        out = self.real_core(*args)
        key = tuple(args[0].shape[:2])
        if key not in self.core:
            self.core[key] = ([a.clone() if torch.is_tensor(a) else a for a in args], out.clone())
        return out

    def _train(self, *args):
        if self.train is not None:
            return self.real_train(*args)
        # A view of each input that takes a gradient: its hook sees what this
        # call's backward returns for it, and nothing of later steps.
        args = [a.view_as(a) if torch.is_tensor(a) and a.requires_grad else a for a in args]
        rec = self.train = {"args": [a.detach().clone() if torch.is_tensor(a) else a for a in args],
                            "grads": {}}
        for i, a in enumerate(args):
            if torch.is_tensor(a) and a.requires_grad:
                a.register_hook(lambda g, i=i: rec["grads"].__setitem__(i, g.detach().clone()))
        out = self.real_train(*args)
        rec["y"] = out.detach().clone()
        out.register_hook(lambda g: rec.__setitem__("dy", g.detach().clone()))
        return out

    def hold(self):
        """Fail unless every recorded launch agrees with its plain version on
        the same inputs (the trunk by hold_bf16, the training trunk's forward
        and 18 gradients by hold_train); returns the largest absolute
        differences (trunk, training forward, training backward)."""
        from difffacto_torch.ops import fused_core as fc
        from difffacto_torch.ops import fused_core_train as fct

        core_err = 0.0
        for (B, N), (args, out) in sorted(self.core.items()):
            with torch.inference_mode():
                want = fc.fused_core_reference(*args)
            core_err = max(core_err, hold_bf16(f"fused_core as phase 9 launched it, B={B} N={N}",
                                               out, want))
        rec = self.train
        grads = [1, 2, 3] + list(range(5, 20))  # x, k, v and the 15 parameters
        if not self.core or rec is None or "dy" not in rec or sorted(rec["grads"]) != grads:
            fail("phase 9 recorded no trunk launch, or no whole training-trunk launch")
        seed, x, k, v, mask = rec["args"][:5]
        params, (scale, p) = rec["args"][5:20], rec["args"][20:22]
        leaves = [t.clone().requires_grad_(True) for t in (x, k, v, *params)]
        with torch.enable_grad():
            yr = fct.fused_trunk_train_reference(seed, *leaves[:3], mask, *leaves[3:], scale, p)
            yr.backward(rec["dy"])
        B, N = x.shape[:2]
        fe, be = hold_train(
            f"as phase 9 launched it, B={B} N={N} p={p} (the first step's own cotangent)",
            rec["y"].float(), [rec["grads"][i].float() for i in grads], yr.detach().float(),
            [t.grad.float() for t in leaves])
        return core_err, fe, be


def runner_step_against_cpu(card, cfg):
    """One step of ``card`` (resumed, on the card, bf16) against a CPU runner
    resumed from the same checkpoint (float32): one batch of the card
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
    print(f"card runner (bf16) against CPU runner (float32), one step: loss dict off by at most "
          f"{rel[worst]:.3e} ({worst}, tol {STEP_LOSS_RTOL}), grad_norm {mc['grad_norm']:.4f} vs "
          f"{mh['grad_norm']:.4f} off by {gn:.3e} (tol {STEP_GNORM_RTOL}); updates: mean abs "
          f"difference {upd:.4f} of the mean abs update (tol {RUNNER_UPDATE_REL})")
    if mc["skipped_nonfinite"] or mh["skipped_nonfinite"]:
        fail("the runner step against the CPU was skipped as non-finite")
    if not rel[worst] <= STEP_LOSS_RTOL or not gn <= STEP_GNORM_RTOL or not upd <= RUNNER_UPDATE_REL:
        fail("the card's runner step disagrees with the CPU's float32 runner step")
    return dict(loss_rel=rel[worst], grad_norm_rel=gn, update_rel=upd)


def runner_phase(dev, fc, fct, fpsm, eh, ff, fb):
    """Phase 9: the port's training loop as a user runs it, through
    ``runner/cli.py:main`` on ``configs/bench_train_tpu.py``; then the
    cropping loader. Returns the launch counts of each kernel, the largest
    errors of the recorded launches and the times."""
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

    def zero():
        fc.launches = fct.launches_fwd = fct.launches_bwd = 0
        fpsm.launches = eh.launches = ff.launches = fb.launches = 0

    def read():
        return dict(fused_core=fc.launches, fused_trunk_train_fwd=fct.launches_fwd,
                    fused_trunk_train_bwd=fct.launches_bwd, fps=fpsm.launches,
                    emd_hybrid=eh.launches, fused_ff=ff.launches, fused_block=fb.launches)

    recorder = KernelRecorder()
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
        del run

    # What the trunk and the training trunk computed on the main path, held
    # against their plain versions: the launches of val (batch 32) and of
    # val_gen (batch 64), and the first training step's forward and backward.
    # (The peak memory is the path's: read before, and reset after, the holds.)
    peak = torch.cuda.max_memory_allocated() / 2**30
    core_err, train_fwd_err, train_bwd_err = recorder.hold()
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
        peak_gib=peak, crop_s=crop_s, against_cpu=against_cpu,
    )
    print(f"seconds per epoch: first {times['train'][0]:.3f} (log_interval 1), later median "
          f"{median:.4f} over {RUNNER_TIMED_EPOCHS} (log_interval {log_every}, the "
          f"configuration's); training {result['shapes_per_s']:.1f} shapes/s at batch {B} from "
          "that median (host clock, each epoch synchronized)")
    print(f"cache_noise {times['cache_noise']} s, val {times['val']} s, val_gen {val_gen_s:.2f} s, "
          f"peak {peak:.2f} GiB; launches over phase 9 {launches}")
    print(f"phase 9: {time.perf_counter() - t_phase:.1f} s")
    return result


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
    print(f"  fused_core: {fc.smem_bytes()} bytes of dynamic shared memory per block")
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
        want = {"fused_core": {"fused_core_kernel": 2},
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
        got, rounds, bids = eh.emd_assignment_hybrid(
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
        fc.launches = 0
        out = sample_generation(model, BATCH_CHECK, valid_id=valid,
                                generator=torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        launches = fc.launches
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
        sample_generation(model, BATCH_TIMED, valid_id=valid, generator=gen)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    shapes_per_s = BATCH_TIMED * ITERS / dt
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
    fc.launches = fpsm.launches = eh.launches = 0
    fct.launches_fwd = fct.launches_bwd = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen = generate_samples(model, num_gen=S, batch=S, seed=0)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    metrics = evaluate_gen(gen, refs)
    torch.cuda.synchronize()
    t_eval = time.perf_counter() - t0
    counts = dict(fused_core=fc.launches, fps=fpsm.launches, emd_hybrid=eh.launches)
    ev.emd_cost_eval = emd_cost_eval

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
        _, rounds, bids = eh.emd_assignment_hybrid(
            a, b, auction_iters=AUCTION_ITERS, return_work=True)
        bound, by = emd_bound_ms(2048, bids.tolist())
        emd[B] = (ms, bound, by, sink_ms)
        print(f"emd_hybrid B={B} n=2048: {ms:.2f} ms ({ms / B:.3f} ms a pair), mean rounds "
              f"{rounds.float().mean().item():.1f}, mean bids {bids.float().mean().item():.0f} "
              f"({100 * bids.float().mean().item() / 2048 / (rounds.float().mean().item() + 1):.1f}% "
              f"of rounds + 1 full sweeps), bound {bound:.3f} ms ({by}, {bound / B:.4f} ms a "
              f"pair), {100 * bound / ms:.1f}% of roofline; split: Sinkhorn and one "
              f"force-assignment sweep {sink_ms:.2f} ms, the auction {ms - sink_ms:.2f} ms "
              f"({100 * (ms - sink_ms) / ms:.1f}%)")
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
    fc.launches = fpsm.launches = eh.launches = 0
    fct.launches_fwd = fct.launches_bwd = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    history = []
    for i in range(TRAIN_STEPS):
        state, metrics = step(state, batch, 0, 0)
        history.append(metrics)
    torch.cuda.synchronize()
    train_counts = dict(fused_trunk_train_fwd=fct.launches_fwd, fused_trunk_train_bwd=fct.launches_bwd)
    history = [{k: float(v) for k, v in m.items()} for m in history]
    print(f"{TRAIN_STEPS} steps at batch {TRAIN_BATCH} x 2048 in {time.perf_counter() - t0:.2f} s; "
          f"launches {train_counts}; other kernels "
          f"{dict(fused_core=fc.launches, fps=fpsm.launches, emd_hybrid=eh.launches)}")
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

    before_f, before_b = fct.launches_fwd, fct.launches_bwd
    y_k, acts = fct.launch_forward(ops, seed_t, launch, save=True)
    y_k = y_k.float()
    dx_k, g_k = fct.launch_backward(ops, acts, dy, seed_t, launch)
    torch.cuda.synchronize()
    fe, be = hold_train(f"B={TRAIN_BATCH} N=2048 p=0.2 ({launch[0] * 2048 // fct.TILE} tiles)",
                        y_k, [dx_k.float()] + g_k, *plain(True))
    train_fwd_err, train_bwd_err = max(train_fwd_err, fe), max(train_bwd_err, be)
    del y_k, dx_k, g_k
    # The forward as the step runs it: saving the activations for the backward.
    fwd_ms = cuda_ms(lambda: fct.launch_forward(ops, seed_t, launch, save=True), 10)
    bwd_ms = cuda_ms(lambda: fct.launch_backward(ops, acts, dy, seed_t, launch), 5)
    fct.launches_fwd, fct.launches_bwd = before_f, before_b

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
    valid = torch.ones(BATCH_CHECK, 4, device=dev)
    for noise_scale in (100, 1):
        model = build_model(noise_scale, dev, single_attn=False)
        ff.launches = fc.launches = fb.launches = 0
        pred = sample_generation(model, BATCH_CHECK, valid_id=valid,
                                 generator=torch.Generator(device=dev).manual_seed(0))["pred"]
        torch.cuda.synchronize()
        two_counts = dict(fused_ff=ff.launches, fused_core=fc.launches, fused_block=fb.launches)
        if torch.isfinite(pred).all():
            break
        print(f"non-finite samples at aligner noise_scale {noise_scale}; lowering it to 1")
    else:
        fail("two-attention generation: non-finite samples")
    depth = len(model.net.blocks)
    expected = dict(fused_ff=depth * model.num_timesteps, fused_core=0, fused_block=0)
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
    print(f"card vs CPU plain FF: max abs {diff.max().item():.4e}, relative L2 {two_rel:.4e} "
          f"(tol {E2E_REL_L2})")
    if not torch.isfinite(runs["cuda"]).all() or two_rel > E2E_REL_L2:
        fail("two-attention generation on the card disagrees with the CPU plain version")

    valid = torch.ones(TWO_ATTN_BATCH_TIMED, 4, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    sample_generation(model, TWO_ATTN_BATCH_TIMED, valid_id=valid, generator=gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ff.launches = 0
    t0 = time.perf_counter()
    for _ in range(TWO_ATTN_ITERS):
        sample_generation(model, TWO_ATTN_BATCH_TIMED, valid_id=valid, generator=gen)
    torch.cuda.synchronize()
    two_dt = (time.perf_counter() - t0) / TWO_ATTN_ITERS
    two_per_gen = ff.launches / TWO_ATTN_ITERS
    two_peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"two-attention gen_chair batch {TWO_ATTN_BATCH_TIMED}: "
          f"{TWO_ATTN_BATCH_TIMED / two_dt:.2f} shapes/s ({two_dt:.3f} s per batch), peak memory "
          f"{two_peak:.2f} GiB, {two_per_gen:.0f} fused_ff launches per generation")
    if two_per_gen != depth * model.num_timesteps + depth:
        fail(f"{two_per_gen} fused_ff launches per batch-{TWO_ATTN_BATCH_TIMED} generation, "
             f"expected {depth * model.num_timesteps + depth}")
    del model, runs, pred
    torch.cuda.empty_cache()

    # UNet: one forward at full size, counted; then batch 2 against the CPU.
    unet = build_unet(dev)
    x, t, ctx, vid = unet_inputs(UNET_BATCH, dev, seed=2)
    fb.launches = 0
    with torch.inference_mode():
        y = unet(x, t, ctx, valid_id=vid)
    torch.cuda.synchronize()
    unet_launches = fb.launches
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
    before = ff.launches
    ff_bound, ff_by = ff_bound_ms(args, args[0].numel() * 2)
    ff_ms = cuda_ms(lambda: ff.fused_ln_geglu_ff(*args), 20)
    ff_plain_ms = cuda_ms(lambda: ff.fused_ln_geglu_ff_reference(*args), 3)
    args256 = ff_operands(256, 4 * TWO_ATTN_BATCH_TIMED, dev, seed=6)
    ff_ms_256 = cuda_ms(lambda: ff.fused_ln_geglu_ff(*args256), 20)
    ff_graph_ms_256 = graph_ms(lambda: ff.fused_ln_geglu_ff(*args256), 20)
    ff_plain_ms_256 = cuda_ms(lambda: ff.fused_ln_geglu_ff_reference(*args256), 20)
    ff_bound_256 = ff_bound_ms(args256, args256[0].numel() * 2)[0]
    ff.launches = before
    print(f"fused_ff T={args[0].shape[0]} D=128: {ff_ms:.3f} ms, bound {ff_bound:.3f} ms "
          f"({ff_by}), {100 * ff_bound / ff_ms:.1f}% of roofline; plain version "
          f"{ff_plain_ms:.3f} ms; 500 launches are "
          f"{100 * 500 * ff_ms / (1e3 * two_dt):.1f}% of a batch's generation; "
          f"T=1024 D=256: {ff_ms_256:.4f} ms ({ff_graph_ms_256:.4f} as a CUDA graph of 20 "
          f"launches), bound "
          f"{ff_bound_256:.4f} ms, plain version {ff_plain_ms_256:.3f} ms")
    del args, args256
    mask = np.ones((UNET_BATCH, fb.CTX), np.float32)
    mask[::3, 1] = 0.0
    args = fc.operands(fb.example_inputs(UNET_BATCH, 2048, seed=7, mask=mask), dev, torch.bfloat16)
    before = fb.launches
    block_bound, block_by = block_bound_ms(args, args[0].numel() * 2)
    block_ms = cuda_ms(lambda: fb.fused_block(*args, 0.25), 20)
    block_plain_ms = cuda_ms(lambda: fb.fused_block_reference(*args, 0.25), 3)
    fb.launches = before
    print(f"fused_block B={UNET_BATCH} N=2048: {block_ms:.3f} ms, bound {block_bound:.3f} ms "
          f"({block_by}), {100 * block_bound / block_ms:.1f}% of roofline; plain version "
          f"{block_plain_ms:.3f} ms; 5 launches are {100 * 5 * block_ms / unet_ms:.1f}% of the "
          f"UNet forward")
    del args
    print(f"phase 8: {time.perf_counter() - t_phase:.1f} s")

    phase("9 runner, full width")
    run9 = runner_phase(dev, fc, fct, fpsm, eh, ff, fb)
    on_path = run9["launches"]

    print(card)
    trunk["launches_runner"] = on_path["fused_core"]
    trunk["max_abs_err"] = max(trunk["max_abs_err"], run9["core_err"])
    print(json.dumps({"kernels": [trunk, {
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
    }, {
        "name": "emd_hybrid", "route": "cuda", "source": "difffacto_torch/csrc/emd_hybrid.cu",
        "replaces": "difffacto_tpu/ops/emd_pallas.py:51", "launches": counts["emd_hybrid"],
        "max_abs_err": emd_diff, "ms": emd[132][0], "plain_ms": emd_plain_ms,
        "bound_ms": emd[132][1], "bound_by": emd[132][2], "library_ms": None, "pairs": 132,
        "ms_at_132_pairs": emd[132][0], "sinkhorn_ms_at_132_pairs": emd[132][3],
        "auction_ms_at_132_pairs": emd[132][0] - emd[132][3],
        "ms_at_32_pairs": emd[32][0], "bound_ms_at_32_pairs": emd[32][1],
        "sinkhorn_ms_at_32_pairs": emd[32][3], "auction_ms_at_32_pairs": emd[32][0] - emd[32][3],
        "protocol_launches_pairs_ms": [[b, s.elapsed_time(e)] for s, e, b in emd_events],
        "protocol_s": t_eval, "launches_runner": on_path["emd_hybrid"],
    }, {
        "name": "fused_trunk_train_fwd", "route": "cuda",
        "source": "difffacto_torch/csrc/fused_core_train.cu",
        "replaces": "difffacto_tpu/ops/fused_core_train.py:120",
        "launches": train_counts["fused_trunk_train_fwd"],
        "max_abs_err": max(train_fwd_err, run9["train_fwd_err"]),
        "ms": fwd_ms, "plain_ms": plain_fwd_ms, "bound_ms": bounds["fwd"][0],
        "bound_by": bounds["fwd"][1], "library_ms": None,
        "launches_runner": on_path["fused_trunk_train_fwd"],
    }, {
        "name": "fused_trunk_train_bwd", "route": "cuda",
        "source": "difffacto_torch/csrc/fused_core_train.cu",
        "replaces": "difffacto_tpu/ops/fused_core_train.py:162",
        "launches": train_counts["fused_trunk_train_bwd"],
        "max_abs_err": max(train_bwd_err, run9["train_bwd_err"]),
        "ms": bwd_ms, "plain_ms": plain_bwd_ms, "bound_ms": bounds["bwd"][0],
        "bound_by": bounds["bwd"][1], "library_ms": None,
        "bound_ms_jax_inputs": bounds["bwd_jax_inputs"][0], "train_step_ms": step_ms,
        "train_step_host_ms": host_ms,
        "train_shapes_per_s": 1e3 * TRAIN_BATCH / step_ms, "train_peak_gib": train_peak_gib,
        "launches_runner": on_path["fused_trunk_train_bwd"],
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
    }, {
        "name": "fused_ff", "route": "cuda", "source": "difffacto_torch/csrc/fused_ff.cu",
        "replaces": "difffacto_tpu/ops/fused_ff.py:26", "launches": two_counts["fused_ff"],
        "max_abs_err": ff_err, "ms": ff_ms, "plain_ms": ff_plain_ms, "bound_ms": ff_bound,
        "bound_by": ff_by, "library_ms": None, "ms_at_t1024_d256": ff_ms_256,
        "graph_ms_at_t1024_d256": ff_graph_ms_256,
        "bound_ms_at_t1024_d256": ff_bound_256, "plain_ms_at_t1024_d256": ff_plain_ms_256,
        "two_attn_shapes_per_s": TWO_ATTN_BATCH_TIMED / two_dt, "two_attn_peak_gib": two_peak,
        "launches_runner": on_path["fused_ff"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
