"""Score a directory of the port's checkpoints with the generation protocol.

The peer of ``tools/eval_ckpt_curve.py``: one ``Runner`` (so the val set and
its ref-vs-ref metric block are built and paid once), then for each
checkpoint in epoch order: load it (model and epoch) -> ``generate_samples``
-> one JSON line. Used for epochs-vs-1-NNA curves, and with ``--ddim N`` for
the fast DDIM evaluation of the reference (25 quad steps, eta 1:
anchored_diffusion.py:114-126, configs/gen_chair.py:81-84).

    python tools/eval_ckpt_curve_torch.py --config-file configs/bench_train_tpu.py \\
        --gen_num 64 [--ckpts work_dirs/x/checkpoints/ckpt_150.pt ...] [--ddim 25] [--cpu]

``--ckpts`` also takes the JAX package's ``ckpt_<epoch>.msgpack``, as
``tools/eval_ckpt_curve.py`` scores them; ``--model-only`` reads the weights
alone (a checkpoint written without its optimizer state) and the epoch from
the ``.meta.json`` beside it.

It runs on the CUDA card and raises where there is none, unless ``--cpu``
is given.
"""

import argparse
import glob
import json
import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config-file", required=True)
    p.add_argument("--gen_num", type=int, default=64)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--ckpts", nargs="*", default=None,
                   help="explicit checkpoint paths; default: every ckpt_*.pt in "
                        "<work_dir>/checkpoints, by epoch")
    p.add_argument("--out", default=None, help="also append the JSON lines here")
    p.add_argument("--ddim", type=int, default=0,
                   help="evaluate with DDIM sampling at this many steps (0: the full chain)")
    p.add_argument("--ddim-discretize", default="quad", choices=["uniform", "quad"])
    p.add_argument("--ddim-eta", type=float, default=1.0)
    p.add_argument("--model-only", action="store_true",
                   help="read the weights alone; the epoch from the .meta.json")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    return p.parse_args(argv)


def main(argv=None):
    """Returns the rows it printed."""
    args = parse_args(argv)
    from difffacto_torch.config import get_cfg, init_cfg
    from difffacto_torch.runner import Runner
    from difffacto_torch.utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else "cuda")
    init_cfg(args.config_file)
    cfg = get_cfg()
    # The checkpoints are loaded below; without these the Runner would also
    # load the work_dir's newest one when it is built.
    cfg.resume_path = None
    cfg.auto_resume = False
    if args.ddim:
        cfg.model.diffusion.ddim_sampling = True
        cfg.model.diffusion.ddim_nsteps = args.ddim
        cfg.model.diffusion.ddim_discretize = args.ddim_discretize
        cfg.model.diffusion.ddim_eta = args.ddim_eta

    runner = Runner(cfg=cfg, device=device)
    ckpts = args.ckpts or sorted(
        glob.glob(os.path.join(runner.work_dir, "checkpoints", "ckpt_*.pt")),
        key=lambda f: int(re.search(r"ckpt_(\d+)\.pt$", f).group(1)))
    rows = []
    for path in ckpts:
        runner.load(path, model_only=args.model_only)
        if args.model_only:
            with open(os.path.splitext(path)[0] + ".meta.json") as f:
                runner.epoch = int(json.load(f)["epoch"])
        t0 = time.time()
        metrics = runner.generate_samples(num_gen=args.gen_num, batch=args.batch)
        row = {"ckpt": os.path.basename(path), "epoch": runner.epoch,
               "steps": len(runner.model.diff.steps), "eval_s": round(time.time() - t0, 2),
               **{k: float(v) for k, v in metrics.items()}}
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
