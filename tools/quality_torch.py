"""Train a config with the port for several seeds, then score each final checkpoint.

The quality cell of the port: for each seed, ``tools/run_net_torch.py --task
train --seed S --prefix seedS`` in this process, then
``tools/eval_ckpt_curve_torch.py --gen_num N --ckpts <final checkpoint>``
once for each value of ``--ddim`` (0: the full chain). Writes
``<out>/quality.json``: each seed's logged loss terms by step, its training
seconds and its metric rows.

    python tools/quality_torch.py --config-file configs/bench_train_tpu.py \\
        --seeds 0 1 --gen_num 64 --ddim 0 25 --log-interval 10 \\
        --out work_dirs/bench_train_tpu_quality

``--log-interval`` (default: the config's) writes a config whose ``_base_`` is
the given one, so the loss terms are logged more often; training is the same.
It runs on the CUDA card and raises where there is none, unless ``--cpu``
is given.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

LOSS_KEYS = ("total_loss", "mse_loss", "fit_loss", "prior_loss", "grad_norm")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config-file", required=True)
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    p.add_argument("--gen_num", type=int, default=64)
    p.add_argument("--ddim", type=int, nargs="+", default=[0, 25])
    p.add_argument("--log-interval", type=int, default=None)
    p.add_argument("--out", required=True, help="directory for quality.json")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import eval_ckpt_curve_torch

    from difffacto_torch.config import get_cfg
    from difffacto_torch.runner.cli import main as cli_main

    os.makedirs(args.out, exist_ok=True)
    config = os.path.abspath(args.config_file)
    if args.log_interval:
        derived = os.path.join(os.path.abspath(args.out), "quality_config.py")
        with open(derived, "w") as f:
            f.write(f"_base_ = [{config!r}]\nlog_interval = {args.log_interval}\n")
        config = derived
    cpu = ["--cpu"] if args.cpu else []
    report = {"config": args.config_file, "log_interval": args.log_interval, "seeds": {}}
    for seed in args.seeds:
        t0 = time.time()
        runner = cli_main(["--config-file", config, "--task", "train", "--seed", str(seed),
                           "--prefix", f"seed{seed}"] + cpu)
        train_s = time.time() - t0
        work_dir = runner.work_dir
        del runner
        curve = []
        with open(os.path.join(work_dir, "scalars.jsonl")) as f:
            for line in f:
                rec = json.loads(line)
                if "mse_loss" in rec:
                    curve.append({k: rec[k] for k in ("step", "epoch") + LOSS_KEYS if k in rec})
        ckpt = os.path.join(work_dir, "checkpoints", f"ckpt_{get_cfg().max_epoch}.pt")
        rows = {}
        for steps in args.ddim:
            argv_eval = ["--config-file", config, "--gen_num", str(args.gen_num),
                         "--ckpts", ckpt] + cpu
            if steps:
                argv_eval += ["--ddim", str(steps)]
            rows[f"ddim{steps}" if steps else "full"] = eval_ckpt_curve_torch.main(argv_eval)[0]
        report["seeds"][str(seed)] = {"train_s": train_s, "curve": curve, "metrics": rows}
        print(f"seed {seed}: trained in {train_s:.1f} s; mse_loss by step "
              + ", ".join(f"{r['step']}:{r['mse_loss']:.4f}" for r in curve), flush=True)
    with open(os.path.join(args.out, "quality.json"), "w") as f:
        json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
