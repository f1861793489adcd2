"""The val_gen protocol as plain functions: generate, then score.

The bodies of ``Runner.generate_samples`` and ``Runner.evaluate_gen`` of the
JAX package (``difffacto_tpu/runner/runner.py``); the port's ``Runner``
(``runner/runner.py``) calls them with its model, val set and device.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..data.dataset_utils import bbox_normalize, sample_part_presence
from ..metrics.eval import compute_all_metrics
from ..models.anchor_diff import sample_generation
from ..ops.points import fps
from ..utils import trace
from ..utils.device import resolve_device

def generate_samples(model, num_gen: int = 400, batch: int = 128, seed: int = 0,
                     refs: Optional[np.ndarray] = None,
                     ref_self_cache: Optional[dict] = None, epoch: int = 0, mesh=None):
    """Unconditional generation protocol: ``num_gen`` shapes in batches of
    ``batch``, part-presence patterns drawn from ``np.random.RandomState(seed)``,
    the chain's noise from a ``torch.Generator`` seeded with ``seed + 17`` on
    the model's device, the first CIMLE sample of each shape. ``epoch`` is
    the training epoch the model stands at: before the aligner's
    ``cimle_start_epoch`` its noise is zero (``runner.py:567-576``).

    Returns the (num_gen, N, 3) float32 clouds, or with ``refs`` the metric
    dict of ``evaluate_gen(gen, refs)``. ``mesh`` shards each batch's chain
    (``models.decode``) and the sweeps; every rank gets the whole result.
    """
    rng_np = np.random.RandomState(seed)
    dev = model.device
    generator = torch.Generator(device=dev).manual_seed(seed + 17)
    # hypotheses per shape, the first one scored; one without CIMLE
    K = model.cimle_sample_num if model.cimle else 1
    preds = []
    remaining = num_gen
    while remaining > 0:
        b = min(batch, remaining)
        presence = sample_part_presence(rng_np, b, model.num_anchors)
        out = sample_generation(
            model, b, valid_id=torch.as_tensor(presence, device=dev), epoch=epoch,
            generator=generator, mesh=mesh)
        preds.append(out["pred"].float().reshape(b, K, -1, 3)[:, 0].cpu().numpy())
        remaining -= b
    gen = np.concatenate(preds)[:num_gen]
    if refs is None:
        return gen
    return evaluate_gen(gen, refs, ref_self_cache=ref_self_cache, device=dev, mesh=mesh)


def evaluate_gen(gen: np.ndarray, refs: np.ndarray, ref_self_cache: Optional[dict] = None,
                 device="cuda", mesh=None) -> Dict[str, float]:
    """FPS to 2048 points where a set has more, bbox-normalize, then
    ``compute_all_metrics(gen, refs, batch_size=32)``.

    ``ref_self_cache`` is a dict the caller keeps for the life of its val
    set: the ref-vs-ref block is then paid once over a curve of checkpoints.
    ``mesh`` deals the sweeps' pairs out to its ranks (``metrics/eval.py``).

    Recorded as the span ``evaluate_gen``; each set's FPS, with its copies
    in and out, is a child ``resample``, and each sweep a child ``sweep``
    (``compute_all_metrics``). The rest of it is host work.
    """
    dev = resolve_device(device)

    def resample(pts):
        with trace.span("resample"):
            return fps(torch.as_tensor(pts, dtype=torch.float32, device=dev), 2048).cpu().numpy()

    with trace.span("evaluate_gen"):
        gen, refs = np.asarray(gen), np.asarray(refs)
        if gen.shape[1] > 2048:
            gen = resample(gen)
        if refs.shape[1] > 2048:
            refs = resample(refs)
        gen = bbox_normalize(gen)
        refs = bbox_normalize(refs)
        return compute_all_metrics(
            gen, refs, batch_size=32, one_way=False, ref_self_cache=ref_self_cache, device=dev,
            mesh=mesh,
        )
