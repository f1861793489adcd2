#!/usr/bin/env python3
"""Time the EMD assignment kernel and the fused LN-GEGLU FF kernel of one or
more checkouts of the port, in turns, on one card.

    python3 tools/emd_ff_ab_torch.py [--roots ROOT [ROOT ...]] [--order 0,1,1,0]

Each entry of ``--order`` runs one child process that imports
``difffacto_torch`` from that root (its kernels build into the root's own
``build/kernels/``) and prints one JSON line; the default is the checkout the
tool lies in, once. Compare two versions only within one call, in turns:
parent, change, change, parent.

What a child times, with CUDA events after one warm-up:

- the EMD kernel at n = 2048 on 132 pairs (one pair per SM of an H100), on
  32, and on 528 (four a SM, two blocks on an SM at a time, as in the
  protocol's launches of 1984–2112 pairs), each with ``auction_iters=150``
  (the protocol's call) and with
  ``auction_iters=0`` (the Sinkhorn and one force-assignment sweep): the
  difference is the auction. The clouds are seeded Gaussians with random
  axis scales, bbox-normalized as the protocol normalizes its clouds, paired
  as ``chip_smoke.py`` phase 6 pairs its 32 references with its 32 samples;
  the rounds and bids of the full call are printed with them, and the clock
  cycles of a pair's Sinkhorn where the checkout's kernel counts them;
- the EMD kernel at n = 8192 on 132 pairs (its global-workspace variant),
  with ``auction_iters=150``;
- the fused FF at T = 524,288, D = 128 (the two-attention denoiser at batch
  256) and at T = 1024, D = 256 (the aligner).
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cuda_ms(torch, fn, iters):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def clouds(seed, count=32, n=2048):
    rng = np.random.RandomState(seed)
    x = (rng.randn(count, n, 3) * rng.uniform(0.3, 1.0, (count, 1, 3))).astype(np.float32)
    lo, hi = x.min(axis=1, keepdims=True), x.max(axis=1, keepdims=True)
    return (x - (lo + hi) / 2) / ((hi - lo).max(axis=-1, keepdims=True) / 2)


def one(root):
    sys.path.insert(0, root)
    import torch

    from difffacto_torch.ops import _build
    from difffacto_torch.ops import emd_hybrid as eh
    from difffacto_torch.ops import fused_core as fc
    from difffacto_torch.ops import fused_ff as ff

    if not torch.cuda.is_available():
        sys.exit("emd_ff_ab_torch: needs a CUDA card")
    dev = torch.device("cuda")
    _build.build(["emd_hybrid", "fused_ff"])
    out = {"root": root}
    refs, gens = (torch.as_tensor(clouds(s), device=dev) for s in (1, 2))
    ii = torch.arange(528, device=dev)
    a528, b528 = refs[ii % 32].contiguous(), gens[(ii + ii // 32) % 32].contiguous()
    for B in (132, 32, 528):
        a, b = a528[:B].contiguous(), b528[:B].contiguous()
        for iters in (150, 0):
            out[f"emd_ms_{B}_auction{iters}"] = cuda_ms(
                torch, lambda: eh.emd_assignment_hybrid(a, b, auction_iters=iters), 2)
        work = eh.emd_assignment_hybrid(a, b, auction_iters=150, return_work=True)
        out[f"emd_rounds_{B}"] = work[1].float().mean().item()
        out[f"emd_bids_{B}"] = work[2].float().mean().item()
        if len(work) > 3:  # the Sinkhorn's clock cycles, where the kernel counts them
            out[f"emd_sinkhorn_mcycles_{B}"] = work[3]["cycles"].double().mean().item() / 1e6
    del a528, b528
    refs, gens = (torch.as_tensor(clouds(s, n=8192), device=dev) for s in (3, 4))
    ii = ii[:132]
    a, b = refs[ii % 32].contiguous(), gens[(ii + ii // 32) % 32].contiguous()
    out["emd_ms_132_n8192_auction150"] = cuda_ms(
        torch, lambda: eh.emd_assignment_hybrid(a, b, auction_iters=150), 2)
    del a, b, refs, gens
    for D, T in ((128, 256 * 2048), (256, 1024)):
        args = fc.operands(ff.example_inputs(T, D, seed=5), dev, torch.bfloat16)
        out[f"ff_ms_d{D}_t{T}"] = cuda_ms(torch, lambda: ff.fused_ln_geglu_ff(*args), 20)
        del args
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", nargs="+", default=[HERE])
    ap.add_argument("--order", default=None, help="comma-separated indices into --roots")
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        one(os.path.abspath(args.one))
        return
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    order = [int(i) for i in args.order.split(",")] if args.order else list(range(len(args.roots)))
    runs = []
    for i in order:
        root = os.path.abspath(args.roots[i])
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root],
                              capture_output=True, text=True, timeout=1800)
        if proc.returncode:
            sys.exit(f"the run of {root} failed:\n{proc.stdout}\n{proc.stderr}")
        line = proc.stdout.strip().splitlines()[-1]
        print(f"[{i}] {line}", flush=True)
        runs.append((i, json.loads(line)))
    keys = [k for k in runs[0][1] if k != "root"]
    for k in keys:
        cells = "  ".join(f"[{i}] {r[k]:.4f}" for i, r in runs)
        print(f"{k}: {cells}")


if __name__ == "__main__":
    main()
