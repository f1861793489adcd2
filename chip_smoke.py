#!/usr/bin/env python3
"""Run the PyTorch port on one CUDA card and check it: gen_chair generation,
then the eval protocol that scores what was generated.

    python3 chip_smoke.py

Phases, each fatal (non-zero exit, no "ok" line):

1. device: a CUDA card is required; prints its name and power limit.
2. build: builds every CUDA source of the two paths (one nvcc each, started
   together) and prints the build time and ``-Xptxas -v``.
3. kernels: each kernel against its plain PyTorch version, with the stated
   tolerance, at the main paths' shapes and at ragged ones: the trunk in
   bf16, FPS index for index, the EMD assignment by its matched cost.
4. generation: ``configs/gen_chair.py`` at full width (2048 points, T=100,
   denoiser depth 5 at width 128, 4 x 14 flows, aligner depth 5,
   ``cimle_sample_num=1``, bf16), seeded random weights, through
   ``sample_generation`` at batch 16. Launch counts are set to 0 just before
   and read just after: the trunk kernel must run once per step. A batch-1
   run with every draw injected is then held against the same model on the
   CPU, where the trunk is the plain version.
5. timing: generation at batch 256 (1 warm-up, 3 timed runs), the trunk
   kernel and its plain version with CUDA events at the main path's shape,
   and the bound.
6. eval protocol, full width: 64 generated gen_chair shapes against 64
   seeded reference clouds of 8192 points (the gen_car val shape) through
   ``evaluate_gen``: FPS 8192 -> 2048, bbox-normalize, MMD/COV/1-NNA over CD
   and EMD at n = 2048 (8128 pairs). Launch counts are set to 0 just before
   and read just after; a 4 x 4 corner is recomputed on the CPU by the plain
   versions. Then FPS and the EMD kernel are timed on the protocol's own
   clouds beside their plain versions and bounds, and one JSON line gives
   every kernel's numbers.

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
# The EMD kernel and its plain version sum their log-sum-exp in another order,
# so a near-tie may go to another object: assignments may differ (the share is
# printed), the matched costs agree within 0.5 %. At n = 512 the kernel's cost
# is held to 1.01 x the Hungarian optimum, as the JAX package's tests hold the
# TPU kernel.
EMD_COST_RTOL, EMD_HUNGARIAN = 0.005, 1.01
# Phase 6: the card's CD against the CPU's (f32 both, another summation order)
# and the card's EMD kernel against the plain hybrid on the CPU (eps-optimal both).
CORNER_CD_RTOL, CORNER_EMD_RTOL = 1e-4, 0.03
EVAL_SHAPES, REF_POINTS, AUCTION_ITERS = 64, 8192, 150


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


def build_model(noise_scale, device):
    from difffacto_torch import MODELS, Config, build_from_cfg

    mcfg = Config(os.path.join(ROOT, "configs", "gen_chair.py")).model.dump()
    mcfg.update(npoints=2048, ret_traj=False, cimle_sample_num=1, dtype=torch.bfloat16)
    mcfg["encoder"]["part_aligner"]["noise_scale"] = noise_scale
    return build_from_cfg(mcfg, MODELS, device=device, seed=0)


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
    from difffacto_torch.ops import fused_core as fc

    t0 = time.perf_counter()
    logs = _build.build(["fused_core", "fps", "emd_hybrid"])
    print(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line or "smem" in line:
                print(f"  {name}: {line.strip()}")
    print(f"  fused_core: {fc.smem_bytes()} bytes of dynamic shared memory per block")

    phase("3 kernels against their plain versions")
    max_err = 0.0
    # Parts absent in some rows, a ragged N, and the batch-16 shape of phase 4.
    for B, N, mask in ((4, 2048, [[1, 1, 1, 1], [1, 0, 1, 1], [1, 1, 1, 1], [0, 1, 1, 1]]),
                       (2, 1000, [[1, 1, 0, 1], [1, 1, 1, 1]]),
                       (BATCH_CHECK, 2048, None)):
        args = fc.operands(fc.example_inputs(B, N, depth=5, seed=B, mask=mask), dev, torch.bfloat16)
        got = fc.fused_core(*args, 0.25)
        torch.cuda.synchronize()
        want = fc.fused_core_reference(*args, 0.25)
        err = (got.float() - want.float()).abs()
        ok = torch.isfinite(got.float()).all().item()
        print(f"fused_core B={B} N={N}: max abs err {err.max().item():.4e} (tol {KERNEL_MAX_ABS}), "
              f"mean {err.mean().item():.4e} (tol {KERNEL_MEAN_ABS})")
        if not ok or err.max().item() > KERNEL_MAX_ABS or err.mean().item() > KERNEL_MEAN_ABS:
            fail(f"fused_core disagrees with its plain version at B={B} N={N}")
        max_err = max(max_err, err.max().item())

    # FPS index for index: the protocol's shape, a ragged N, and 16 distinct
    # points repeated to 256 (all remaining distances 0: index 0 repeats).
    fps_diff = 0.0
    for B, N, m, distinct in ((4, 8192, 2048, None), (3, 1000, 64, None), (2, 256, 32, 16)):
        x = seeded_clouds(B, N, seed=N, distinct=distinct).to(dev)
        got = fpsm.furthest_point_sample(x, m)
        torch.cuda.synchronize()
        want = fpsm.furthest_point_sample_reference(x, m)
        share = (got != want).float().mean().item()
        print(f"fps B={B} N={N} m={m}: share of differing indices {share:.6f} (must be 0)")
        if got.dtype != torch.int32 or tuple(got.shape) != (B, m) or share != 0.0:
            fail(f"fps disagrees with its plain version at B={B} N={N} m={m}")
        fps_diff = max(fps_diff, share)

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
    trunk = {
        "name": "fused_core", "route": "cuda", "source": "difffacto_torch/csrc/fused_core.cu",
        "replaces": "difffacto_tpu/ops/fused_core.py:33", "launches": launches,
        "max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
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

    # A 4 x 4 corner of the (ref x sample) matrices, on the card and on the
    # CPU, where FPS, CD and the EMD hybrid are the plain versions.
    refs_card = fps(torch.as_tensor(refs[:4], device=dev), 2048).cpu().numpy()
    t0 = time.perf_counter()
    refs_cpu = fps(torch.as_tensor(refs[:4]), 2048).numpy()
    if not np.array_equal(refs_card, refs_cpu):
        fail("FPS on the card and on the CPU chose other points")
    ref_n, gen_n = bbox_normalize(refs_card), bbox_normalize(gen[:4])
    cd_card, emd_card = ev.pairwise_cd_emd(ref_n, gen_n, 32, device=dev)
    os.environ["DIFFFACTO_EMD_IMPL"] = "hybrid"
    try:
        cd_cpu, emd_cpu = ev.pairwise_cd_emd(ref_n, gen_n, 4, device="cpu")
    finally:
        del os.environ["DIFFFACTO_EMD_IMPL"]
    cd_rel = np.abs(cd_card / cd_cpu - 1).max()
    emd_rel = np.abs(emd_card / emd_cpu - 1).max()
    print(f"4 x 4 corner against the CPU plain path ({time.perf_counter() - t0:.1f} s): CD off by "
          f"{cd_rel:.3e} (tol {CORNER_CD_RTOL}), EMD off by {emd_rel:.3e} (tol {CORNER_EMD_RTOL})")
    if not cd_rel <= CORNER_CD_RTOL or not emd_rel <= CORNER_EMD_RTOL:
        fail("the card's corner of the CD/EMD matrices disagrees with the CPU plain path")

    # FPS and the EMD kernel on the protocol's own clouds.
    # FPS at the protocol's launch (all R clouds) and at 32 clouds.
    x = torch.as_tensor(refs, device=dev)
    fps_ms = cuda_ms(lambda: fpsm.furthest_point_sample(x, 2048), 5)
    fps_plain_ms = cuda_ms(lambda: fpsm.furthest_point_sample_reference(x, 2048), 1)
    fps_bound, fps_by = fps_bound_ms(R, REF_POINTS, 2048)
    print(f"fps B={R} N={REF_POINTS} m=2048: {fps_ms:.3f} ms, bound {fps_bound:.4f} ms ({fps_by}; "
          f"2047 dependent steps put a latency floor under it), plain version {fps_plain_ms:.1f} ms")
    x = x[:32].contiguous()
    fps_ms_32 = cuda_ms(lambda: fpsm.furthest_point_sample(x, 2048), 5)
    print(f"fps B=32 N={REF_POINTS} m=2048: {fps_ms_32:.3f} ms, bound "
          f"{fps_bound_ms(32, REF_POINTS, 2048)[0]:.4f} ms")
    refs_n = torch.as_tensor(bbox_normalize(fps(x, 2048).cpu().numpy()), device=dev)
    gens_n = torch.as_tensor(bbox_normalize(gen[:32]), device=dev)
    ii = torch.arange(132, device=dev)
    a132, b132 = refs_n[ii % 32], gens_n[(ii + ii // 32) % 32]
    emd = {}
    for B in (132, 32):
        a, b = a132[:B].contiguous(), b132[:B].contiguous()
        ms = cuda_ms(lambda: eh.emd_assignment_hybrid(a, b, auction_iters=AUCTION_ITERS), 2)
        _, rounds, bids = eh.emd_assignment_hybrid(
            a, b, auction_iters=AUCTION_ITERS, return_work=True)
        bound, by = emd_bound_ms(2048, bids.tolist())
        emd[B] = (ms, bound, by)
        print(f"emd_hybrid B={B} n=2048: {ms:.2f} ms ({ms / B:.3f} ms a pair), mean rounds "
              f"{rounds.float().mean().item():.1f}, mean bids {bids.float().mean().item():.0f} "
              f"({100 * bids.float().mean().item() / 2048 / (rounds.float().mean().item() + 1):.1f}% "
              f"of rounds + 1 full sweeps), bound {bound:.3f} ms ({by}), "
              f"{100 * bound / ms:.1f}% of roofline")
    emd_plain_ms = cuda_ms(
        lambda: eh.emd_assignment_hybrid_reference(a, b, auction_iters=AUCTION_ITERS), 1)
    print(f"emd_hybrid plain version B=32 n=2048: {emd_plain_ms:.1f} ms")

    print(card)
    print(json.dumps({"kernels": [trunk, {
        "name": "fps", "route": "cuda", "source": "difffacto_torch/csrc/fps.cu",
        "replaces": "difffacto_tpu/ops/fps_pallas.py:27", "launches": counts["fps"],
        "max_abs_err": fps_diff, "ms": fps_ms, "plain_ms": fps_plain_ms, "bound_ms": fps_bound,
        "bound_by": fps_by, "library_ms": None, "ms_at_32_clouds": fps_ms_32,
    }, {
        "name": "emd_hybrid", "route": "cuda", "source": "difffacto_torch/csrc/emd_hybrid.cu",
        "replaces": "difffacto_tpu/ops/emd_pallas.py:51", "launches": counts["emd_hybrid"],
        "max_abs_err": emd_diff, "ms": emd[32][0], "plain_ms": emd_plain_ms,
        "bound_ms": emd[32][1], "bound_by": emd[32][2], "library_ms": None,
        "ms_at_132_pairs": emd[132][0], "bound_ms_at_132_pairs": emd[132][1],
        "protocol_launches_pairs_ms": [[b, s.elapsed_time(e)] for s, e, b in emd_events],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
