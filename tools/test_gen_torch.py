"""Recompute generation metrics from saved validation dumps, with the PyTorch port.

The counterpart of ``tools/test_gen.py``: reload generated and reference
clouds from the npz dumps that ``Runner.val`` writes
(``work_dirs/<name>/val/*.npz``), optionally bbox-normalize and FPS to 2048
points, and run the metric suite (MMD/COV/1-NNA over CD and EMD, optional
bbox/part/snapping extras) without re-running the model. Runs on the CUDA card
unless ``--cpu`` is given.

Usage:
  python tools/test_gen_torch.py --dump work_dirs/gen_chair/val/out_0.npz \
      [--pred-key pred --ref-key input_ref] [--bbox] [--part] [--snapping] \
      [--category Chair] [--batch 32] [--cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch


def main():
    ap = argparse.ArgumentParser(description="offline gen-metric recompute (PyTorch port)")
    ap.add_argument("--dump", required=True, help="npz produced by Runner.val")
    ap.add_argument("--ref-dump", default=None,
                    help="optional second npz holding the reference clouds")
    ap.add_argument("--pred-key", default="pred")
    ap.add_argument("--ref-key", default="input_ref")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--one-way", action="store_true")
    ap.add_argument("--no-normalize", action="store_true",
                    help="skip bbox normalization + FPS (paired AE eval)")
    ap.add_argument("--bbox", action="store_true", help="add bbox metrics")
    ap.add_argument("--part", action="store_true", help="add per-part metrics")
    ap.add_argument("--snapping", action="store_true", help="add snapping metric")
    ap.add_argument("--category", default="Chair")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    args = ap.parse_args()

    from difffacto_torch.data import bbox_normalize
    from difffacto_torch.metrics.eval import (
        compute_all_metrics,
        compute_bbox_metric,
        compute_part_metric,
        compute_snapping_metric,
    )
    from difffacto_torch.ops.points import fps
    from difffacto_torch.utils.device import resolve_device

    dev = resolve_device("cpu" if args.cpu else "cuda")

    z = np.load(args.dump, allow_pickle=True)
    gen = np.asarray(z[args.pred_key], np.float32)
    refsrc = np.load(args.ref_dump, allow_pickle=True) if args.ref_dump else z
    ref = np.asarray(refsrc[args.ref_key], np.float32)
    if gen.ndim == 4:  # (B, K, N, 3) CIMLE dumps: first sample
        gen = gen[:, 0]
    print(f"gen {gen.shape}  ref {ref.shape}  device {dev}")

    seg_gen = np.asarray(z["seg_mask"]) if "seg_mask" in z else None
    seg_ref = (
        np.asarray(refsrc["ref_seg_mask"]) if "ref_seg_mask" in refsrc else seg_gen
    )

    def resample(pts, seg):
        """FPS to 2048 and keep the seg mask aligned with the kept points."""
        idx = fps(torch.as_tensor(pts, device=dev), 2048, ret_id=True)[1].cpu().numpy()
        pts = np.take_along_axis(pts, idx[..., None], axis=1)
        if seg is not None:
            seg = np.take_along_axis(seg, idx, axis=1)
        return pts, seg

    if not args.no_normalize:
        if gen.shape[1] > 2048:
            gen, seg_gen = resample(gen, seg_gen)
        if ref.shape[1] > 2048:
            ref, seg_ref = resample(ref, seg_ref)
        gen = bbox_normalize(gen)
        ref = bbox_normalize(ref)

    metrics = compute_all_metrics(
        gen, ref, batch_size=args.batch, one_way=args.one_way, device=dev
    )
    for k, v in sorted(metrics.items()):
        print(f"{k}: {float(v):.6f}")

    if args.bbox or args.part or args.snapping:
        if seg_gen is None:
            print("no seg_mask in dump; skipping part-aware metrics")
            return
        if args.bbox:
            for k, v in sorted(
                compute_bbox_metric(gen, seg_gen, ref, seg_ref).items()
            ):
                print(f"bbox/{k}: {float(v):.6f}")
        if args.part:
            for k, v in sorted(
                compute_part_metric(gen, seg_gen, ref, seg_ref, device=dev).items()
            ):
                print(f"part/{k}: {float(v):.6f}")
        if args.snapping:
            for k, v in sorted(
                compute_snapping_metric(gen, seg_gen, cls=args.category).items()
            ):
                print(f"snapping/{k}: {float(v):.6f}")


if __name__ == "__main__":
    main()
