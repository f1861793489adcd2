"""The command line of the port: train, validate or score generation with a
config file.

The peer of ``tools/run_net.py`` with the same flags (``--config-file``,
``--task``, ``--seed``, ``--no_eval``, ``--short_val``, ``--gen_num``,
``--prefix``, ``--save_dir``), run on the card unless ``--cpu`` is given.
``main(argv)`` returns what it ran: the ``Runner`` after ``train``, the
metric dict after ``val`` and ``val_gen``. A caller that changes a few keys
writes a config whose ``_base_`` names the original by its absolute path.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

RUNNERS = ("auto", "default", "pretrain", "gan", "language")
NOT_PORTED = {
    "pretrain": "queue A item 7, the secondary families",
    "gan": "queue A item 7, the secondary families",
    "language": "queue A item 7, the secondary families",
    "interpolation": "queue A item 5, editing",
    "mixing": "queue A item 5, editing",
}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="DiffFacto runner (PyTorch port)")
    p.add_argument("--config-file", required=True)
    p.add_argument("--task", default="train",
                   choices=["train", "val", "val_gen", "interpolation", "mixing"])
    p.add_argument("--runner", default="auto", choices=RUNNERS,
                   help="runner family; 'auto' reads cfg.runner")
    p.add_argument("--save_dir", default=".", help="accepted as tools/run_net.py accepts it")
    p.add_argument("--prefix", default="")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no_eval", action="store_true")
    p.add_argument("--short_val", action="store_true")
    p.add_argument("--gen_num", type=int, default=400)
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
    from ..config import get_cfg, init_cfg
    from ..utils.device import resolve_device
    from .runner import Runner

    args = parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")
    init_cfg(args.config_file)
    cfg = get_cfg()
    if args.prefix:
        cfg.work_dir = os.path.join("work_dirs", cfg.name + "_" + args.prefix)

    kind = args.runner
    if kind == "auto":
        kind = cfg.get("runner", "default")
    for what in (kind, args.task):
        if what in NOT_PORTED:
            raise NotImplementedError(
                f"'{what}' is not ported yet (ROADMAP.md, {NOT_PORTED[what]})")

    runner = Runner(args=args, cfg=cfg, device=device)
    if args.task == "train":
        runner.run()
        return runner
    if args.task == "val":
        return runner.val()
    metrics = runner.generate_samples(num_gen=args.gen_num)
    for k, v in metrics.items():
        print(f"{k}: {v}")
    return metrics
