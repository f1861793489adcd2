#!/usr/bin/env python3
"""Where the training trunk's backward kernel spends its time, on one card.

    python3 tools/train_bwd_probe_torch.py [--batch 128] [--points 2048] [--iters 5]

Builds ``csrc/fused_core_train.cu`` as it is and, into ``build/probe/``,
copies with one part compiled out each by a ``-D`` switch of the source:

- ``flush`` (``PROBE_NO_FLUSH``): the weight-gradient flush (``red_tile``'s
  4-wide reductions of dWq, dWout, dW1 and dW2 into global memory);
- ``column_sums`` (``PROBE_NO_COLUMN_SUMS``): the bias and LayerNorm-parameter
  gradients and dK, dV (the column sums of ``red_column_pair``: the sums,
  their shuffles and reductions);
- ``reductions`` (``PROBE_NO_COLUMN_REDUCTIONS``): only the global reductions
  of those column sums (the sums and shuffles stay);

then times the backward kernel of each against the full one in turns (full,
cut, cut, full) with CUDA events at the training step's shape (depth 5,
p = 0.2), and the forward kernel with and without saving the activations the
backward reads. A cut's gradients are wrong by construction: the copies are
measurements, not kernels of the port.
"""

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from difffacto_torch.ops import _build  # noqa: E402
from difffacto_torch.ops import fused_core_train as fct  # noqa: E402

CUTS = {"flush": "PROBE_NO_FLUSH", "column_sums": "PROBE_NO_COLUMN_SUMS",
        "reductions": "PROBE_NO_COLUMN_REDUCTIONS"}


def build_cuts():
    """Compile every cut at once; returns {cut: loaded library}."""
    out = os.path.join(ROOT, "build", "probe")
    os.makedirs(out, exist_ok=True)
    cu = str(_build.CSRC / "fused_core_train.cu")
    procs = {}
    for name, define in CUTS.items():
        so = os.path.join(out, f"libfused_core_train_{name}.so")
        procs[name] = (subprocess.Popen([_build.nvcc(), *_build.FLAGS, f"-D{define}", "-o", so, cu],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed for the cut {name!r}:\n{log}")
        spill = [line.strip() for line in log.splitlines() if "spill" in line]
        print(f"cut {name}: {spill[-1] if spill else ''}")
        libs[name] = fct.bind(ctypes.CDLL(so))
    return libs


def cuda_ms(fn, iters):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--points", type=int, default=2048)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")
    dev = torch.device("cuda")
    B, N, depth = args.batch, args.points, 5
    inp = fct.example_inputs(B, N, depth=depth, seed=11)
    par = fct.example_params(depth=depth, seed=12)
    x, k, v = (torch.as_tensor(inp[n]).to(dev, torch.bfloat16) for n in ("x", "k", "v"))
    params = [torch.as_tensor(a).to(dev) for a in par.values()]
    ops, seed_t, launch = fct.launch_args(x, k, v, torch.as_tensor(inp["mask"]).to(dev), params,
                                          77, 0.25, 0.2)
    dy = torch.randn(B, N, 128, device=dev).to(torch.bfloat16)
    _, acts = fct.launch_forward(ops, seed_t, launch, save=True)
    real = fct._library()
    cuts = build_cuts()

    def bwd(lib):
        return cuda_ms(lambda: fct.launch_backward(ops, acts, dy, seed_t, launch, lib), args.iters)

    for name, lib in cuts.items():
        times = [bwd(real), bwd(lib), bwd(lib), bwd(real)]
        full, cut = np.mean([times[0], times[3]]), np.mean(times[1:3])
        print(f"backward B={B} N={N} depth {depth} p=0.2, without {name}: full "
              f"{times[0]:.3f} / {times[3]:.3f} ms, cut {times[1]:.3f} / {times[2]:.3f} ms: "
              f"{name} costs {full - cut:.3f} ms of {full:.3f} ({100 * (full - cut) / full:.1f}%)")
    fwd = [("save", cuda_ms(lambda: fct.launch_forward(ops, seed_t, launch, True), args.iters)),
           ("no save", cuda_ms(lambda: fct.launch_forward(ops, seed_t, launch, False), args.iters))]
    print("forward: " + ", ".join(f"{n} {t:.3f} ms" for n, t in fwd)
          + f"; saved activations {acts.numel() * 2 / 1e6:.1f} MB")


if __name__ == "__main__":
    main()
