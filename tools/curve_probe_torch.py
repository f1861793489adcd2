"""Train the port and the JAX package from the same initial weights, and compare their loss curves.

``prepare``: build the port's Runner for ``--seed`` on a config (default
``configs/bench_train_tpu.py``) cut to ``--epochs`` epochs and logging every
step, write its initial weights in the JAX layout
(``<out>/init_seed<S>/checkpoints/ckpt_0.msgpack``) and a config for the JAX
package that loads them as ``pretrained_weights`` with ``model_only``
(``<out>/jax_seed<S>.py``), then train the port. The JAX side then runs
through its own command line, unchanged:

    python tools/curve_probe_torch.py prepare --seed 0 --epochs 20 --out OUT --cpu
    JAX_PLATFORMS=cpu python tools/run_net.py --config-file OUT/jax_seed0.py \\
        --task train --seed 0

Both use the same data (``data/synthetic.py``, equal bit for bit); their
random draws (CIMLE candidates, diffusion t and noise, dropout) come from
different generators, which the seeds' spread measures.

``compare``: read each run's ``scalars.jsonl`` and print, for each loss term,
the mean over windows of ``--window`` steps of every run, the spread of
each package over its seeds, and the first window where the packages' seed
ranges do not overlap:

    python tools/curve_probe_torch.py compare --out OUT --seeds 0 1 --window 10

``trim``: the weights alone of each run's final checkpoint (those that exist), for scoring
both on the card with the same code (``tools/eval_ckpt_curve_torch.py
--model-only``; a full checkpoint of this model holds Adam's moments too and
is three times larger): ``<dest>/jax_seed<S>.msgpack`` and
``<dest>/port_seed<S>.pt``, each with its ``.meta.json``:

    python tools/curve_probe_torch.py trim --out OUT --seeds 0 1 --epochs 20 --dest DEST

This script imports nothing of the JAX package; it runs on the card unless
``--cpu`` is given.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TERMS = ("mse_loss", "fit_loss", "prior_loss", "total_loss", "grad_norm")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("mode", choices=["prepare", "compare", "trim"])
    p.add_argument("--config-file", default=os.path.join(ROOT, "configs", "bench_train_tpu.py"))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--window", type=int, default=10)
    p.add_argument("--out", required=True)
    p.add_argument("--dest", default=None, help="where trim writes")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    return p.parse_args(argv)


def write_config(path, base, **keys):
    with open(path, "w") as f:
        f.write(f"_base_ = [{os.path.abspath(base)!r}]\n")
        f.write("".join(f"{k} = {v!r}\n" for k, v in keys.items()))
    return path


def prepare(args):
    import torch

    from difffacto_torch.config import Config
    from difffacto_torch.runner import Runner
    from difffacto_torch.utils.jax_checkpoint import write_jax_checkpoint
    from difffacto_torch.utils.jax_params import export_jax_train_state

    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    keys = dict(max_epoch=args.epochs, log_interval=1, checkpoint_interval=None,
                eval_interval=None)
    port_cfg = write_config(os.path.join(out, f"port_seed{args.seed}.py"), args.config_file,
                            work_dir=os.path.join(out, f"port_seed{args.seed}"), **keys)
    cfg = Config(port_cfg)
    runner = Runner(args=argparse.Namespace(seed=args.seed), cfg=cfg,
                    device="cpu" if args.cpu else "cuda")
    if runner.state.step != 0:
        raise RuntimeError(f"{cfg.work_dir} holds a checkpoint: use a fresh --out")
    init = write_jax_checkpoint(os.path.join(out, f"init_seed{args.seed}"), 0,
                                export_jax_train_state(runner.state, runner.tx))
    write_config(os.path.join(out, f"jax_seed{args.seed}.py"), args.config_file,
                 work_dir=os.path.join(out, f"jax_seed{args.seed}"), pretrained_weights=init,
                 model_only=True, **keys)
    print(f"initial weights in the JAX layout: {init}", flush=True)
    torch.manual_seed(args.seed)
    runner.run()


def read_curve(work_dir):
    with open(os.path.join(work_dir, "scalars.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [r for r in recs if "mse_loss" in r]


def compare(args):
    import numpy as np

    out = os.path.abspath(args.out)
    curves = {(pkg, s): read_curve(os.path.join(out, f"{pkg}_seed{s}"))
              for pkg in ("port", "jax") for s in args.seeds}
    steps = min(len(c) for c in curves.values())
    n_win = steps // args.window
    report = {"steps": steps, "window": args.window, "terms": {}}
    for term in TERMS:
        rows = []
        first_apart = None
        for w in range(n_win):
            sl = slice(w * args.window, (w + 1) * args.window)
            means = {k: float(np.mean([r[term] for r in c[sl]])) for k, c in curves.items()}
            port = [means[("port", s)] for s in args.seeds]
            jax = [means[("jax", s)] for s in args.seeds]
            apart = max(port) < min(jax) or max(jax) < min(port)
            if apart and first_apart is None:
                first_apart = w
            rows.append({"steps": [w * args.window + 1, (w + 1) * args.window],
                         "port": port, "jax": jax, "apart": apart})
        report["terms"][term] = {"windows": rows, "first_apart": first_apart}
        print(f"{term}: first window where the seed ranges part: "
              f"{'none' if first_apart is None else rows[first_apart]['steps']}")
        for r in rows:
            print(f"  steps {r['steps'][0]:>4}-{r['steps'][1]:<4} port "
                  + " ".join(f"{v:.4f}" for v in r["port"]) + "  jax "
                  + " ".join(f"{v:.4f}" for v in r["jax"]) + ("  apart" if r["apart"] else ""))
    with open(os.path.join(out, "compare.json"), "w") as f:
        json.dump(report, f, indent=1)
    return report


def trim(args):
    import shutil

    import torch

    from difffacto_torch.utils.jax_checkpoint import meta_path, read_jax_checkpoint, pack

    os.makedirs(args.dest, exist_ok=True)
    keep = ("step", "params", "batch_stats")
    for s in args.seeds:
        src = os.path.join(args.out, f"jax_seed{s}", "checkpoints", f"ckpt_{args.epochs}.msgpack")
        if os.path.exists(src):
            tree, _ = read_jax_checkpoint(src)
            dst = os.path.join(args.dest, f"jax_seed{s}.msgpack")
            with open(dst, "wb") as f:
                f.write(pack({k: tree[k] for k in keep}))
            shutil.copy(meta_path(src), meta_path(dst))
            print(f"{src} -> {dst}", flush=True)
        src = os.path.join(args.out, f"port_seed{s}", "checkpoints", f"ckpt_{args.epochs}.pt")
        if os.path.exists(src):
            ckpt = torch.load(src, map_location="cpu", weights_only=True)
            dst = os.path.join(args.dest, f"port_seed{s}.pt")
            torch.save({k: ckpt[k] for k in keep}, dst)
            shutil.copy(src[: -len(".pt")] + ".meta.json", dst[: -len(".pt")] + ".meta.json")
            print(f"{src} -> {dst}", flush=True)


def main(argv=None):
    args = parse_args(argv)
    return {"prepare": prepare, "compare": compare, "trim": trim}[args.mode](args)


if __name__ == "__main__":
    main()
