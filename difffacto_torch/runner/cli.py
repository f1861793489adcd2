"""The command line of the port: train, validate, score generation, mix or
interpolate parts with a config file.

The peer of ``tools/run_net.py`` with the same flags (``--config-file``,
``--task``, ``--seed``, ``--no_eval``, ``--short_val``, ``--gen_num``,
``--part_id``, ``--interpolation_dir``, ``--prefix``, ``--save_dir``), run
on the card unless ``--cpu`` is given; ``--runner pretrain`` trains each
part's own denoiser, ``--runner gan`` a latent GAN over the frozen encoder's
part codes and ``--runner language`` the text encoder and update MLP of
language editing (``runner/extra_runners.py``). ``--launcher pytorch``
joins the ranks that ``torch.distributed.run`` started (the reference's
launcher, ``tools/run_net.py:33-40``):

    python -m torch.distributed.run --nproc_per_node 4 tools/run_net_torch.py \
        --launcher pytorch --config-file configs/bench_train_tpu.py --task train

Each rank runs on ``cuda:LOCAL_RANK`` over NCCL (ranks share the cards,
over gloo, where a node runs more ranks than it has cards); with ``--cpu``
the ranks run on the CPU over gloo. A launcher that cannot start its
process group raises, and so does one asked for ``--runner pretrain``,
``gan`` or ``language`` or ``--task interpolation`` / ``mixing``, which run
on one device. ``main(argv)`` returns what it ran:
the ``Runner`` after ``train``, the metric dict after ``val`` and
``val_gen``, the written arrays after ``interpolation`` and ``mixing``. A
caller that changes a few keys writes a config whose ``_base_`` names the
original by its absolute path.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

RUNNERS = ("auto", "default", "pretrain", "gan", "language")
# Runners and tasks with no sharded path: under --launcher pytorch every rank
# would redo the whole work and write the same files.
SINGLE_DEVICE = ("pretrain", "gan", "language", "interpolation", "mixing")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="DiffFacto runner (PyTorch port)")
    p.add_argument("--config-file", required=True)
    p.add_argument("--task", default="train",
                   choices=["train", "val", "val_gen", "interpolation", "mixing"])
    p.add_argument("--runner", default="auto", choices=RUNNERS,
                   help="runner family; 'auto' reads cfg.runner")
    # accepted and read nowhere, as tools/run_net.py accepts them
    p.add_argument("--save_dir", default=".")
    p.add_argument("--sync_bn", action="store_true")
    p.add_argument("--deterministic", action="store_true")
    p.add_argument("--param_sample_num", type=int, default=10)
    p.add_argument("--prefix", default="")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no_eval", action="store_true")
    p.add_argument("--short_val", action="store_true")
    p.add_argument("--gen_num", type=int, default=400)
    p.add_argument("--part_id", type=int, default=0, help="the part --task interpolation moves")
    p.add_argument("--interpolation_dir", default=None,
                   help="where --task interpolation writes (default work_dir/interpolation)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    p.add_argument("--launcher", default="none", choices=["none", "pytorch"],
                   help="'pytorch': join the ranks torch.distributed.run started")
    p.add_argument("--local_rank", "--local-rank", type=int, default=None,
                   help="accepted as torch.distributed.launch passes it; LOCAL_RANK is read")
    return p.parse_args(argv)


def start_ranks(cpu: bool):
    """``--launcher pytorch``: this rank's device, the process group, and the
    kernels built once a node (local rank 0 builds, the others wait) so that
    two nvcc runs never race on one library."""
    import torch
    import torch.distributed as dist

    from ..parallel.mesh import initialize_distributed, rank_device

    device = rank_device(cpu)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    initialize_distributed(strict=True, device=device)
    if device.type == "cuda":
        from ..ops import _build

        if int(os.environ.get("LOCAL_RANK", 0)) == 0:
            _build.build(_build.sources())
        dist.barrier()
    print(f"[difffacto_torch] rank {dist.get_rank()}/{dist.get_world_size()} on {device} "
          f"({dist.get_backend()})", flush=True)
    return device


def main(argv: Optional[Sequence[str]] = None):
    from ..config import get_cfg, init_cfg
    from ..utils.device import resolve_device
    from .extra_runners import GanRunner, LanguageRunner, PretrainRunner
    from .runner import Runner

    args = parse_args(argv)
    init_cfg(args.config_file)
    cfg = get_cfg()
    if args.prefix:
        cfg.work_dir = os.path.join("work_dirs", cfg.name + "_" + args.prefix)

    kind = args.runner
    if kind == "auto":
        kind = cfg.get("runner", "default")
    if args.launcher == "pytorch":
        for what in (kind, args.task):
            if what in SINGLE_DEVICE:
                raise NotImplementedError(
                    f"'{what}' runs on one device; --launcher pytorch takes the default runner's "
                    "train, val and val_gen (ROADMAP.md, queue A item 5)")
        device = start_ranks(args.cpu)
    else:
        device = resolve_device("cpu" if args.cpu else "cuda")

    runner_cls = {"default": Runner, "pretrain": PretrainRunner, "gan": GanRunner,
                  "language": LanguageRunner}[kind]
    runner = runner_cls(args=args, cfg=cfg, device=device)
    if args.task == "train":
        runner.run()
        return runner
    if args.task == "val":
        return runner.val()
    if args.task in ("interpolation", "mixing"):
        from .editing import run_interpolation, run_mixing

        return (run_interpolation if args.task == "interpolation" else run_mixing)(runner, args)
    metrics = runner.generate_samples(num_gen=args.gen_num)
    for k, v in metrics.items():
        print(f"{k}: {v}")
    return metrics
