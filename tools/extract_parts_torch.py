"""Split generated shapes into fixed-size per-part clouds for part-level eval.

The PyTorch port's peer of ``tools/extract_parts.py``, with its flags: from
an npz dump of generated shapes (``pred`` and a segmentation mask), each
part of at least 10 points is taken out of each shape, canonicalized with
``--canonical`` (zero mean, per-axis std clipped to [0.01, 1]), cut to
``--npoint`` by FPS or padded by resampling (``RandomState(shape index)``),
and saved as arrays ``part_<k>`` (S_k, npoint, 3) of one npz. FPS runs on
the card (one launch for each group of parts of equal length) unless
``--cpu`` is given; without a card it raises.

    python tools/extract_parts_torch.py --dump val.npz --output parts.npz [--canonical] [--cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description="per-part cloud extraction")
    ap.add_argument("--dump", required=True, help="npz with pred + seg mask")
    ap.add_argument("--output", required=True)
    ap.add_argument("--pred-key", default="pred")
    ap.add_argument("--mask-key", default=None,
                    help="default: pred_seg_mask, else seg_mask, else ref_seg_mask")
    ap.add_argument("--npoint", type=int, default=512)
    ap.add_argument("--n-class", type=int, default=4)
    ap.add_argument("--canonical", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run FPS on the CPU")
    args = ap.parse_args(argv)

    from difffacto_torch.ops.points import furthest_point_sample_each
    from difffacto_torch.utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else "cuda")
    z = np.load(args.dump, allow_pickle=True)
    pred = np.asarray(z[args.pred_key], np.float32)
    if pred.ndim == 4:
        pred = pred[:, 0]
    mask = None
    for key in ([args.mask_key] if args.mask_key else
                ["pred_seg_mask", "seg_mask", "ref_seg_mask"]):
        if key and key in z:
            mask = np.asarray(z[key])
            break
    assert mask is not None, "no seg mask found in dump"

    # Every part's points first, then FPS over all parts that need it at once.
    parts = {k: [] for k in range(args.n_class)}
    for k in range(args.n_class):
        for b in range(pred.shape[0]):
            pts = pred[b][mask[b] == k]
            if len(pts) < 10:  # straggler parts are dropped like the dataset
                continue
            if args.canonical:
                pts = pts - pts.mean(0, keepdims=True)
                std = np.clip(pts.std(0, keepdims=True), 1e-2, 1.0)
                pts = pts / std
            parts[k].append((b, pts))
    dense = [pts for k in parts for _, pts in parts[k] if len(pts) >= args.npoint]
    chosen = iter(furthest_point_sample_each(dense, args.npoint, device))

    out = {}
    for k in range(args.n_class):
        clouds = []
        for b, pts in parts[k]:
            if len(pts) >= args.npoint:
                pts = pts[next(chosen)]
            else:
                reps = np.random.RandomState(b).choice(len(pts), args.npoint - len(pts))
                pts = np.concatenate([pts, pts[reps]])
            clouds.append(pts)
        if clouds:
            out[f"part_{k}"] = np.stack(clouds)
            print(f"part {k}: {out[f'part_{k}'].shape}")
    np.savez(args.output, **out)
    print(f"saved {args.output}")


if __name__ == "__main__":
    main()
