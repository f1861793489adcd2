#!/usr/bin/env python3
"""Time the FPS kernel and the fused LN-GEGLU FF kernel at D = 256 of one or
more checkouts of the port, in turns, on one card.

    python3 tools/fps_ff_ab_torch.py [--roots ROOT [ROOT ...]] [--order 0,1,1,0]
                                     [--probe] [--smoke] [--log-dir DIR]

Each entry of ``--order`` runs one child process that imports
``difffacto_torch`` from that root (its kernels build into the root's own
``build/kernels/``) and prints one JSON line; the default is the checkout the
tool lies in, once. Compare two versions only within one call, in turns:
parent, change, change, parent.

What a child times, with CUDA events after one warm-up:

- FPS 8192 -> 2048 on 64 clouds (the 64 v 64 protocol's references), 32 and
  400 (the 400 v 400 protocol's), seeded Gaussians with random axis scales
  as ``chip_smoke.py`` phase 6 makes them; where the checkout has them, also
  at a cluster size of 1 and the latency floor
  (``ops/fps.py:latency_floor_probe``) at the plan's cluster size and at 1;
  and at 70 clouds of 10,000 and 132 of 14,000, past one block's registers
  (a cluster of 2) and inside the shared-memory limit of the first port's
  one-block-a-cloud kernel;
- the fused FF at T = 1024, D = 256 (the aligner at batch 256), by events
  over 20 back-to-back launches and as a CUDA graph of 20 launches (the
  device time alone: the launch is shorter than the wrapper's host time),
  and at T = 524,288, D = 128 (the two-attention denoiser at batch 256);
- with ``--probe``, where the checkout's ``csrc/fused_ff.cu`` holds the
  cluster kernel: three copies of it, each cut by a ``return`` (see
  ``PROBE_CUTS``) after the weights and LN(x) (``loads_only``), after the
  products (``no_exchange``) or after the exchange of the partials
  (``no_epilogue``), built into the root's ``build/probe/`` (measurement
  builds with wrong output, never the port's), each as a CUDA graph at
  T = 128 and 1024: where the kernel's time goes.

With ``--smoke`` each entry of ``--order`` runs that root's
``chip_smoke.py`` instead and prints its end-to-end numbers: gen_chair
shapes/s at batch 256 (phase 5), the 64 v 64 protocol's seconds (phase 6),
the training step's ms (phase 7) and two-attention shapes/s (phase 8); each
log goes to ``--log-dir``.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# name: (a line of csrc/fused_ff.cu's cluster kernel, the cut inserted
# after it (+) or before it (-)). Each cut waits for what the blocks of the
# cluster still send or load before it returns.
PROBE_CUTS = {
    "loads_only": ("  __syncthreads();  // also publishes the initialised mbarriers\n", "+",
                   "  for (int i = 0; i < 3; ++i) mbar_wait(&bar[i], 0);\n"
                   "  cluster_sync();\n  return;\n"),
    "no_exchange": ("  // The partial, band by band", "-", "  cluster_wait();\n  return;\n"),
    "no_epilogue": ("  // ---- block r: x + bf16(sum of the 8 partials + b2)", "-",
                    "  mbar_wait_cluster(&bar[3], 0);\n  cluster_sync();\n  return;\n"),
}


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


def graph_ms(torch, fn, iters):
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


def clouds(seed, count, n=8192):
    rng = np.random.RandomState(seed)
    return (rng.randn(count, n, 3) * rng.uniform(0.3, 1.0, (count, 1, 3))).astype(np.float32)


def probe_source(src, cut):
    """csrc/fused_ff.cu with the cut ``cut`` of PROBE_CUTS, or None where the
    source does not hold its line exactly once."""
    line, where, code = PROBE_CUTS[cut]
    if src.count(line) != 1:
        return None
    return src.replace(line, line + code if where == "+" else code + line)


def one(root, probe):
    sys.path.insert(0, root)
    import torch

    from difffacto_torch.ops import _build
    from difffacto_torch.ops import fps
    from difffacto_torch.ops import fused_core as fc
    from difffacto_torch.ops import fused_ff as ff

    if not torch.cuda.is_available():
        sys.exit("fps_ff_ab_torch: needs a CUDA card")
    dev = torch.device("cuda")
    _build.build(["fps", "fused_ff"])
    out = {"root": root}
    x400 = torch.as_tensor(clouds(5, 400), device=dev)
    has_plan = hasattr(fps, "latency_floor_probe")
    for B in (64, 32, 400):
        x = x400[:B].contiguous()
        out[f"fps_ms_{B}"] = cuda_ms(torch, lambda: fps.furthest_point_sample(x, 2048), 3)
        if has_plan:
            out[f"fps_ms_{B}_cluster1"] = cuda_ms(torch, lambda: fps._launch(x, 2048, 1), 3)
            out[f"fps_floor_ms_{B}"] = cuda_ms(torch, lambda: fps.latency_floor_probe(x, 2048), 3)
            out[f"fps_floor_ms_{B}_cluster1"] = cuda_ms(
                torch, lambda: fps.latency_floor_probe(x, 2048, cluster=1), 3)
    del x400
    for B, N in ((70, 10000), (132, 14000)):
        x = torch.as_tensor(clouds(7, B, N), device=dev)
        out[f"fps_ms_{B}x{N}"] = cuda_ms(torch, lambda: fps.furthest_point_sample(x, 2048), 3)
    del x
    args = fc.operands(ff.example_inputs(1024, 256, seed=5), dev, torch.bfloat16)
    out["ff_ms_d256_t1024_events"] = cuda_ms(torch, lambda: ff.fused_ln_geglu_ff(*args), 20)
    out["ff_ms_d256_t1024_graph"] = graph_ms(torch, lambda: ff.fused_ln_geglu_ff(*args), 20)
    big = fc.operands(ff.example_inputs(256 * 2048, 128, seed=5), dev, torch.bfloat16)
    out["ff_ms_d128_t524288"] = cuda_ms(torch, lambda: ff.fused_ln_geglu_ff(*big), 20)
    del big
    csrc = os.path.join(root, "difffacto_torch", "csrc")
    src = open(os.path.join(csrc, "fused_ff.cu")).read()
    cut_srcs = {p: probe_source(src, p) for p in PROBE_CUTS}
    if probe and all(cut_srcs.values()):
        pdir = os.path.join(root, "build", "probe")
        os.makedirs(pdir, exist_ok=True)
        procs = {}
        for p, text in cut_srcs.items():
            cu = os.path.join(pdir, f"fused_ff_{p}.cu")
            with open(cu, "w") as f:
                f.write(text)
            lib = os.path.join(pdir, f"libfused_ff_{p}.so")
            procs[p] = (lib, subprocess.Popen(
                [_build.nvcc(), *_build.FLAGS, "-I", csrc, "-o", lib, cu],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        real = _build.load("fused_ff")
        for p, (lib, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode:
                sys.exit(f"nvcc failed for {p}:\n{log}")
            _build._libs["fused_ff"] = ctypes.CDLL(lib)  # the wrapper binds what load returns
            for T in (128, 1024):
                a = fc.operands(ff.example_inputs(T, 256, seed=5), dev, torch.bfloat16)
                out[f"ff_{p}_ms_t{T}"] = graph_ms(
                    torch, lambda: ff.fused_ln_geglu_ff(*a), 20)
        _build._libs["fused_ff"] = real
        a = fc.operands(ff.example_inputs(128, 256, seed=5), dev, torch.bfloat16)
        out["ff_ms_d256_t128_graph"] = graph_ms(torch, lambda: ff.fused_ln_geglu_ff(*a), 20)
    print(json.dumps(out), flush=True)


def smoke(root, log_dir, tag):
    """Run ``root``'s chip_smoke.py; its end-to-end numbers from the output."""
    proc = subprocess.run([sys.executable, os.path.join(root, "chip_smoke.py")],
                          capture_output=True, text=True, timeout=1500)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        with open(os.path.join(log_dir, f"chip_smoke_{tag}.log"), "w") as f:
            f.write(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
    out = {"root": root, "exit": proc.returncode}
    lines = proc.stdout.strip().splitlines()
    kernels = next((json.loads(l) for l in lines if l.startswith('{"kernels"')), None)
    if kernels:
        by = {k["name"]: k for k in kernels["kernels"]}
        out["gen_shapes_per_s"] = by["fused_core"].get("gen_shapes_per_s")
        out["train_step_ms"] = by["fused_trunk_train_bwd"].get("train_step_ms")
        out["two_attn_shapes_per_s"] = by["fused_ff"].get("two_attn_shapes_per_s")
    m = re.search(r"protocol over \d+ pairs .* in ([0-9.]+) s:", proc.stdout)
    out["protocol_s"] = float(m.group(1)) if m else None
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", nargs="+", default=[HERE])
    ap.add_argument("--order", default=None, help="comma-separated indices into --roots")
    ap.add_argument("--probe", action="store_true", help="time the D = 256 probe builds")
    ap.add_argument("--smoke", action="store_true", help="run each root's chip_smoke.py")
    ap.add_argument("--log-dir", default=None, help="where --smoke writes each log")
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        one(os.path.abspath(args.one), args.probe)
        return
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    order = [int(i) for i in args.order.split(",")] if args.order else list(range(len(args.roots)))
    runs = []
    for n, i in enumerate(order):
        root = os.path.abspath(args.roots[i])
        if args.smoke:
            res = smoke(root, args.log_dir, f"{n}_{i}")
        else:
            cmd = [sys.executable, os.path.abspath(__file__), "--one", root]
            proc = subprocess.run(cmd + (["--probe"] if args.probe else []),
                                  capture_output=True, text=True, timeout=1800)
            if proc.returncode:
                sys.exit(f"the run of {root} failed:\n{proc.stdout}\n{proc.stderr}")
            res = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"[{i}] {json.dumps(res)}", flush=True)
        runs.append((i, res))
    keys = sorted({k for _, r in runs for k in r if k != "root"})
    for k in keys:
        cells = "  ".join(f"[{i}] {r[k]:.4f}" if isinstance(r.get(k), (int, float)) else f"[{i}] -"
                          for i, r in runs)
        print(f"{k}: {cells}")


if __name__ == "__main__":
    main()
