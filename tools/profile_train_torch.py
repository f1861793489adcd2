#!/usr/bin/env python3
"""Where the port's gen_chair training step spends its time on the card.

    python3 tools/profile_train_torch.py [--batch 128] [--steps 5] [--top 25]

Builds the model and the optimizer as ``chip_smoke.py`` phase 7 does (full
width, bf16, dropout 0.2, Adam with LinearLR and max_norm 10), takes a few
warm-up steps, then times three segments of one step with CUDA events (the
loss forward, the backward, the clip + optimizer update), the whole step
untraced, and traces
``--steps`` steps with ``torch.profiler``: device time by kernel name, the
number of kernel launches per step, and the device's busy share of the traced
window. Needs a CUDA card; prints the card's name and power limit.
"""

import argparse
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (the model, optimizer and batch of phase 7)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_train_torch: needs a CUDA card")
    from difffacto_torch.models import ensure_attn_maps
    from difffacto_torch.parallel import init_train_state, make_train_step
    from difffacto_torch.parallel.train import parse_losses

    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    model = cs.build_train_model(dev)
    tx = cs.build_train_optimizer()
    state = init_train_state(model, tx)
    step = make_train_step(model, tx)
    batch = cs.to_device(cs.example_batch(args.batch, 2048), dev)
    for i in range(3):
        state, _ = step(state, batch, 0, 0)
    torch.cuda.synchronize()

    # the step's three segments, by CUDA events
    params = list(model.parameters())
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    seg = [0.0, 0.0, 0.0]
    for i in range(args.steps):
        g = {"sample": torch.Generator(device=dev).manual_seed(2 * i),
             "dropout": torch.Generator(device=dev).manual_seed(2 * i + 1)}
        ev[0].record()
        total, _ = parse_losses(model.loss(ensure_attn_maps(batch), 0, True, rngs=g))
        ev[1].record()
        grads = torch.autograd.grad(total, params, allow_unused=True)
        ev[2].record()
        grads = [torch.zeros_like(p) if x is None else x for x, p in zip(grads, params)]
        with torch.no_grad():
            tx.update(grads, state.opt_state, params, state.paths)
        ev[3].record()
        torch.cuda.synchronize()
        for j in range(3):
            seg[j] += ev[j].elapsed_time(ev[j + 1]) / args.steps
    print(f"batch {args.batch} x 2048: loss forward {seg[0]:.2f} ms, backward {seg[1]:.2f} ms, "
          f"clip + optimizer update {seg[2]:.2f} ms (CUDA events, mean of {args.steps})")

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(args.steps):
        state, _ = step(state, batch, 1, 0)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / args.steps
    print(f"untraced: {step_ms:.2f} ms per step (CUDA events, mean of {args.steps})")

    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(args.steps):
            state, _ = step(state, batch, 1, 0)
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.key_averages() if e.device_time_total > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in events) / 1e3
    launches = sum(e.count for e in events)
    print(f"{args.steps} traced steps: {wall_ms / args.steps:.2f} ms per step by the host clock "
          f"(tracing on), device busy {busy_ms / args.steps:.2f} ms per step: "
          f"{100 * busy_ms / args.steps / step_ms:.1f}% of the untraced step, so idle "
          f"{100 - 100 * busy_ms / args.steps / step_ms:.1f}%; {launches / args.steps:.0f} kernel "
          f"launches per step")
    if busy_ms == 0:
        sys.exit("profile_train_torch: the trace holds no device time")
    for e in sorted(events, key=lambda e: -e.device_time_total)[:args.top]:
        print(f"  {e.device_time_total / 1e3 / args.steps:9.3f} ms/step  {e.count / args.steps:7.1f} x  "
              f"{e.key[:110]}")


if __name__ == "__main__":
    main()
