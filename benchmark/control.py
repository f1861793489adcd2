"""The control of a cell's check, and its readings, on the card.

    python3 benchmark/control.py --workload gen_chair.sample --seeds 11,12,13

For each seed: the cell's set-up and one unit of its traffic through the
program, then the check with the plain reference put in the program's
place, computed in the precision below the configuration's (the model's
products in fp8 e4m3, the protocol's clouds, distances and matrices in
bfloat16). It prints each compared number per seed: the readings that set
each limit's upper end. The benchmark's own runs never run it.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH.parent))
sys.path.insert(0, str(BENCH))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args()
    import torch

    import harness

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = harness.Spec()
    cell = spec.cell(args.workload)
    config, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    limits = spec.limits(args.workload)
    drv = harness.loop(traffic["loop"])
    os.environ.update(config.get("env", {}))
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = harness.Run(config, traffic, seed, dev, torch.cuda.synchronize)
        state = drv.setup(run)
        harness.window(run, drv, state, 0.0)
        values, _ = drv.check(run, state, control=True)
        ok, _ = harness.judge(values, limits)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "readings": harness.plain_json(values), "correct_under_limits": ok,
                          "seconds": time.perf_counter() - t0}), flush=True)
        del state
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
