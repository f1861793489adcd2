"""Pack dense part clouds into fixed-size arrays by furthest point sampling.

The PyTorch port's peer of ``tools/process_data.py``, with its flags: dense
per-shape clouds (an ``.h5`` with ``points`` and ``labels`` if h5py is
installed, an ``.npz`` with the same keys, or a directory of whitespace
``.txt`` files of ``x y z ... label`` rows) are tiled up to ``--npoints``
where shorter, downsampled to ``--npoints`` by FPS and written as one npz
(``points`` (S, npoints, 3) float32, ``labels`` (S, npoints) int8) that the
``Partnet`` and ``ShapeNetParts`` datasets read. FPS runs on the card (one
launch for each group of clouds of equal length; the output is that of one
cloud at a time) unless ``--cpu`` is given; without a card it raises.

    python tools/process_data_torch.py --input DIR_OR_NPZ --output out.npz [--cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def load_any(path):
    """(points, labels) of every shape in ``path``: arrays or lists of them."""
    if path.endswith(".h5"):
        import h5py  # optional

        with h5py.File(path, "r") as f:
            return np.asarray(f["points"]), np.asarray(f["labels"])
    if path.endswith(".npz"):
        z = np.load(path, allow_pickle=True)
        return np.asarray(z["points"]), np.asarray(z["labels"])
    if os.path.isdir(path):
        from difffacto_torch.native import fast_loadtxt

        pts, labs = [], []
        for fn in sorted(os.listdir(path)):
            if not fn.endswith(".txt"):
                continue
            data = fast_loadtxt(os.path.join(path, fn))
            pts.append(data[:, :3])
            labs.append(data[:, -1].astype(np.int32))
        return pts, labs
    raise ValueError(f"unsupported input: {path}")


def main(argv=None):
    ap = argparse.ArgumentParser(description="pack part clouds via FPS")
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--npoints", type=int, default=2048)
    ap.add_argument("--label-base", type=int, default=0, help="subtract from labels")
    ap.add_argument("--cpu", action="store_true", help="run FPS on the CPU")
    args = ap.parse_args(argv)

    from difffacto_torch.ops.points import furthest_point_sample_each
    from difffacto_torch.utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else "cuda")
    points, labels = load_any(args.input)
    clouds, labs = [], []
    for pc, lab in zip(points, labels):
        pc = np.asarray(pc, np.float32)
        lab = np.asarray(lab, np.int32) - args.label_base
        if pc.shape[0] < args.npoints:
            reps = int(np.ceil(args.npoints / pc.shape[0]))
            pc = np.tile(pc, (reps, 1))[: args.npoints]
            lab = np.tile(lab, reps)[: args.npoints]
        clouds.append(pc)
        labs.append(lab)
    idx = furthest_point_sample_each(clouds, args.npoints, device)
    np.savez_compressed(
        args.output,
        points=np.stack([pc[i] for pc, i in zip(clouds, idx)]),
        labels=np.stack([lab[i] for lab, i in zip(labs, idx)]).astype(np.int8),
    )
    print(f"packed {len(clouds)} shapes x {args.npoints} pts -> {args.output}")


if __name__ == "__main__":
    main()
