"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload gen_chair.sample --seed 7 --seconds 30 --trace 0

from the root of a checkout. It needs the CUDA cards the cell asks for and
exits with a non-zero code, printing no result, where they are missing. The
last line of standard output is the result (JSON); the numbers the check
compared, each with its limit, are the last lines of standard error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH.parent))
sys.path.insert(0, str(BENCH))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    # Caches of the program's builds stay inside the checkout, at fixed paths.
    os.environ.setdefault("TRITON_CACHE_DIR", str(BENCH.parent / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(BENCH.parent / "build" / "torch_extensions"))
    import torch

    import harness

    spec = harness.Spec()
    chips = spec.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result, checks = harness.run_cell(spec, args.workload, args.seed, args.seconds,
                                      bool(args.trace), torch.device("cuda", 0), T_START)
    loaded = harness.forbidden_modules(sys.modules)
    if loaded:
        print(f"benchmark: the process loaded {loaded}; the port must not", file=sys.stderr)
        return 3
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi failed: {e}"
    print(f"card: {smi}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(harness.plain_json(result)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
