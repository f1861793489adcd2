"""FPS-downsample dense per-part clouds, with per-part statistics.

The PyTorch port's peer of ``tools/fps_shape.py``, with its flags: an npz of
dense shapes (``points`` (S, N, 3), ``labels`` (S, N)) in, each shape cut to
``--npoints`` by FPS and shape-normalized, with each part's canonical shift
and scale (parts of at least 10 points), written as one npz (``points``,
``labels`` int8, ``part_shift``, ``part_scale``). FPS runs on the card (one
launch for each group of shapes of equal length) unless ``--cpu`` is given;
without a card it raises.

    python tools/fps_shape_torch.py --input dense.npz --output out.npz [--clip] [--cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", required=True, help="npz with points (S,N,3), labels (S,N)")
    ap.add_argument("--output", required=True)
    ap.add_argument("--npoints", type=int, default=2048)
    ap.add_argument("--n_class", type=int, default=4)
    ap.add_argument("--clip", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run FPS on the CPU")
    args = ap.parse_args(argv)

    from difffacto_torch.data.dataset_utils import pc_norm
    from difffacto_torch.ops.points import furthest_point_sample_each
    from difffacto_torch.utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else "cuda")
    z = np.load(args.input, allow_pickle=True)
    points, labels = np.asarray(z["points"]), np.asarray(z["labels"])
    chosen = furthest_point_sample_each([np.asarray(pc, np.float32) for pc in points],
                                        args.npoints, device)
    out_pts, out_labels, out_shifts, out_scales = [], [], [], []
    for pc, lab, idx in zip(points, labels, chosen):
        pc, lab = pc[idx].astype(np.float32), lab[idx]
        pc, _, _ = pc_norm(pc, "shape_unit")
        shifts = np.zeros((args.n_class, 3), np.float32)
        scales = np.ones((args.n_class, 3), np.float32)
        for i in range(args.n_class):
            m = lab == i
            if m.sum() >= 10:
                _, s, c = pc_norm(pc[m], "shape_canonical", clip=args.clip)
                shifts[i], scales[i] = s[0], c[0]
        out_pts.append(pc)
        out_labels.append(lab)
        out_shifts.append(shifts)
        out_scales.append(scales)
    np.savez_compressed(
        args.output,
        points=np.stack(out_pts),
        labels=np.stack(out_labels).astype(np.int8),
        part_shift=np.stack(out_shifts),
        part_scale=np.stack(out_scales),
    )
    print(f"wrote {len(out_pts)} shapes -> {args.output}")


if __name__ == "__main__":
    main()
