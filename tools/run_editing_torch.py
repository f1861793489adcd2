"""Editing with the PyTorch port, every mode from one tool.

The peer of ``tools/run_editing.py`` (same modes and flags, ``--cpu`` to run
on the CPU instead of the card):

  python tools/run_editing_torch.py --config-file configs/gen_chair.py --mode mixing
  python tools/run_editing_torch.py --config-file configs/gen_chair.py --mode interpolation --part_id 2
  python tools/run_editing_torch.py --config-file configs/gen_chair.py --mode sample_one_part --part_id 1
  python tools/run_editing_torch.py --config-file configs/gen_chair.py --mode optimize_noise
  python tools/run_editing_torch.py --config-file configs/gen_chair.py --mode shape_edit --part_id 1
  python tools/run_editing_torch.py --config-file configs/gen_chair.py --mode interpolate_params

It edits the first val batch with the weights the config names (a
``resume_path`` or ``pretrained_weights``, a reference ``.pth`` included) and
writes ``<work_dir>/<mode>/<mode>.npz``.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

MODES = ("mixing", "interpolation", "interpolate_params", "sample_one_part", "optimize_noise",
         "shape_edit")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config-file", required=True)
    ap.add_argument("--mode", required=True, choices=MODES)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--part_id", type=int, default=2)
    ap.add_argument("--sample_num_each", type=int, default=10)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    args = ap.parse_args(argv)

    import torch

    from difffacto_torch.config import get_cfg, init_cfg
    from difffacto_torch.runner import Runner
    from difffacto_torch.runner import editing
    from difffacto_torch.runner.runner import device_batch
    from difffacto_torch.utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else "cuda")
    init_cfg(args.config_file)
    runner = Runner(args=args, cfg=get_cfg(), device=device)
    model = runner.model
    gen = torch.Generator(device=device).manual_seed(args.seed)
    out_dir = os.path.join(runner.work_dir, args.mode)
    os.makedirs(out_dir, exist_ok=True)

    batch = device_batch(next(iter(runner.val_loader)), device, runner._slim_val)
    if args.mode == "mixing":
        out = editing.combine_latent(model, batch, generator=gen)
    elif args.mode == "interpolation":
        out = editing.interpolate_latent(model, batch, part_id=args.part_id, generator=gen)
    elif args.mode == "interpolate_params":
        out = editing.interpolate_params(model, batch, part_id=args.part_id, generator=gen)
    elif args.mode == "sample_one_part":
        # encode the batch's parts first (the reference loads saved latents)
        b = editing.ensure_attn_maps(batch)
        with torch.inference_mode():
            codes = model.encode_part_code(b["input"], b["attn_map"], False)
        scale = np.clip(b["part_scale"].float().cpu().numpy(), 1e-3, None)
        out = editing.sample_one_part(
            model, codes.float().cpu().numpy(), b["present"].float().cpu().numpy(),
            b["part_shift"].float().cpu().numpy(), 2 * np.log(scale),
            b["ref_seg_mask"].cpu().numpy(), part_id=args.part_id,
            sample_num_each=args.sample_num_each, generator=gen)
    elif args.mode == "optimize_noise":
        z, history = editing.optimize_noise(model, batch, steps=args.steps, generator=gen)
        out = {"z": z.cpu().numpy(), "loss_history": np.asarray(history)}
    else:  # shape_edit
        target_mean = np.zeros((batch["ref"].shape[0], 3), np.float32)
        target_mean[:, 1] = 0.5
        out = editing.shape_edit(model, batch, edit_part_id=args.part_id,
                                 edit_part_mean=target_mean, steps=args.steps, generator=gen)
    out = {k: v for k, v in out.items() if isinstance(v, np.ndarray)}
    path = os.path.join(out_dir, f"{args.mode}.npz")
    np.savez(path, **out)
    print(f"{args.mode} -> {path}")
    return out


if __name__ == "__main__":
    main()
