"""Editing: part mixing, interpolation, single-part resampling, transformation
editing and noise optimisation.

The port of ``difffacto_tpu/runner/editing.py``:

* ``combine_latent``           <- anchor_gen.py:457-532 (random permutation mixing)
* ``combine_latent_specific``  <- anchor_gen.py:412-455 (explicit per-part inputs)
* ``interpolate_latent``       <- anchor_gen.py:206-305 (one part's code interpolated)
* ``interpolate_two_shapes``   <- anchor_gen.py:188-204 (between two explicit shapes)
* ``select_best_noise_whole``  <- anchor_gen.py:815-836 (CIMLE by the decoded Chamfer)
* ``interpolate_params``       <- anchor_gen.py:338-410 (drift and stretch editing)
* ``subsample_params(_global)``<- part_encoders.py:545-621 (diverse parameter sets)
* ``sample_one_part``          <- anchor_gen.py:307-337, part_encoders.py:623-710
* ``optimize_noise``           <- tools/optimize_noise.py:73-113 (Adam on the CIMLE z)
* ``shape_edit``               <- tools/shape_edit.py:77-130 (noise -> target params)

``model`` is the port's ``AnchorDiffAE`` and a batch holds tensors on its
device (``runner.device_batch``). Every random draw comes from ``generator``
or is injected by keyword: ``part_code_eps`` (the posterior draw of the part
codes), ``perm_seed`` (the seed of the mixing permutations), ``cimle_noise``
(the aligner noise), ``w`` (the flow prior's input), ``z0`` (the start of a
noise optimisation), and the chain's ``x_T`` and ``step_noise``. The aligner
noise is 32 wide wherever the JAX functions draw it so (all but
``combine_latent``, which reads the aligner's width). Decoding runs under
``inference_mode``, where the aligner's fused FF launches its kernel; the
noise optimisations differentiate through the encoder and the aligner with
autograd, where it computes the unfused math (``nn/layers.py:ff_kernel_takes``).
Adam is ``torch.optim.Adam`` with optax's defaults (betas 0.9 and 0.999, eps
1e-8 added to the bias-corrected root, no eps inside the root), the update
optax's ``adam`` makes.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models.anchor_diff import (AnchorDiffAE, decode, ensure_attn_maps, reconstruct,
                                  select_best_noise)
from ..ops.chamfer import chamfer_l2
from ..utils.device import randn

NOISE_DIM = 32  # the aligner noise's width where the JAX functions fix it


def _draw(shape, generator, device, injected=None) -> torch.Tensor:
    if injected is not None:
        return _tensor(injected, device)
    return randn(shape, generator, device)


def _perm_seed(generator, injected=None) -> int:
    if injected is not None:
        return int(injected)
    if generator is None:
        raise ValueError("the permutation needs a torch.Generator (or pass perm_seed)")
    return int(torch.randint(0, 2**31 - 1, (), generator=generator,
                             device=generator.device).item())


def _tensor(a, device):
    """An injected draw (tensor or array) as a float32 tensor on ``device``."""
    if a is None:
        return None
    if not torch.is_tensor(a):
        a = torch.from_numpy(np.array(a, np.float32))
    return a.to(device, torch.float32)


def _t2n(t) -> np.ndarray:
    return t.float().cpu().numpy() if t.is_floating_point() else t.cpu().numpy()


def _decode(model, mean_pp, ctx, var_pp, seg_mask, valid_id, generator, x_T, step_noise):
    """The chain's prediction; ``step_noise`` is (len(model.diff.steps), B, N, 3)."""
    dev = mean_pp.device
    return decode(model, mean_pp, ctx=ctx, variance=var_pp, seg_mask=seg_mask, valid_id=valid_id,
                  noise=_tensor(x_T, dev), step_noise=_tensor(step_noise, dev),
                  generator=generator, ret_traj=False)["pred"]


# ------------------------------------------------------------------ mixing
@torch.inference_mode()
def combine_latent(model: AnchorDiffAE, batch, K: Optional[int] = None, generator=None, *,
                   part_code_eps=None, perm_seed=None, cimle_noise=None, x_T=None,
                   step_noise=None) -> Dict[str, np.ndarray]:
    """Random part mixing (``editing.py:39-77``): each part slot takes the
    code of a shape drawn by a permutation of the batch, a slot present only
    where both shapes have the part; K CIMLE hypotheses a mix."""
    batch = ensure_attn_maps(batch)
    x, seg_flag = batch["input"], batch["attn_map"]
    dev = x.device
    valid_id = batch["present"].float().clone()
    B = x.shape[0]
    K = (model.cimle_sample_num if model.cimle else 1) if K is None else K

    part_code = model.encode_part_code(x, seg_flag, True, generator,
                                       _tensor(part_code_eps, dev)).clone()
    perm_rng = np.random.RandomState(_perm_seed(generator, perm_seed))
    for i in range(model.num_anchors):
        perm = torch.as_tensor(perm_rng.permutation(B), device=dev)
        part_code[:, i] = part_code[perm, i]
        valid_id[:, i] = valid_id[perm, i] * valid_id[:, i]

    part_code = part_code.repeat_interleave(K, dim=0)
    valid_r = valid_id.repeat_interleave(K, dim=0)
    noise = (_draw((B * K, model.encoder_mod.noise_dim), generator, dev, cimle_noise)
             if model.cimle else None)
    ctx, mean_pp, var_pp, seg_mask, _ = model.latents_to_decode(part_code, valid_r, noise)
    pred = _t2n(_decode(model, mean_pp, ctx, var_pp, seg_mask, valid_r, generator, x_T,
                        step_noise)).reshape(B, K, model.npoints, 3)
    result = {f"pred_sample_{i}": pred[:, i] for i in range(K)}
    result["pred"] = pred[:, 0]
    result["pred_seg_mask"] = _t2n(seg_mask).reshape(B, K, -1)[:, 0]
    for key, name in (("ref", "input_ref"), ("ref_seg_mask", "ref_seg_mask"),
                      ("shift", "shift"), ("scale", "scale")):
        result[name] = _t2n(batch[key])
    return result


@torch.inference_mode()
def combine_latent_specific(model: AnchorDiffAE, part_clouds: Sequence[np.ndarray],
                            K: Optional[int] = None, generator=None, *, cimle_noise=None,
                            x_T=None, step_noise=None) -> Dict[str, np.ndarray]:
    """Mix explicit per-part clouds (one array per part slot; an all-zero
    array is an absent part) into one shape (``editing.py:80-122``). As in the
    JAX function, an absent slot's points go to slot 0's index
    (``latents_to_decode``'s equal split)."""
    if len(part_clouds) != model.num_anchors:
        raise ValueError(f"{len(part_clouds)} part clouds for {model.num_anchors} parts")
    dev = model.device
    valid = np.array([[1.0 if np.any(p != 0) else 0.0 for p in part_clouds]], np.float32)
    flags, pts = [], []
    for i, p in enumerate(part_clouds):
        if np.any(p != 0):
            one = np.zeros((p.shape[0], model.num_anchors), np.float32)
            one[:, i] = 1
            flags.append(one)
            pts.append(np.asarray(p, np.float32))
    x = torch.as_tensor(np.concatenate(pts)[None], device=dev)
    seg_flag = torch.as_tensor(np.concatenate(flags)[None], device=dev)

    part_code = model.encode_part_code(x, seg_flag, False)
    K = (model.cimle_sample_num if model.cimle else 1) if K is None else K
    part_code = part_code.repeat_interleave(K, dim=0)
    valid_r = torch.as_tensor(valid, device=dev).repeat_interleave(K, dim=0)
    noise = _draw((K, NOISE_DIM), generator, dev, cimle_noise) if model.cimle else None
    ctx, mean_pp, var_pp, seg_mask, _ = model.latents_to_decode(part_code, valid_r, noise)
    pred = _t2n(_decode(model, mean_pp, ctx, var_pp, seg_mask, valid_r, generator, x_T,
                        step_noise))  # (K, npoints, 3)
    result = {f"pred_sample_{i}": pred[i:i + 1] for i in range(K)}
    result["pred"] = pred[0:1]
    result["pred_seg_mask"] = _t2n(seg_mask)[0:1]
    result["input"] = _t2n(x)
    result["seg_mask"] = _t2n(torch.argmax(seg_flag, dim=2))
    result["shift"] = np.zeros((1, 1, 3), np.float32)
    result["scale"] = np.ones((1, 1, 1), np.float32)
    return result


# ------------------------------------------------------------ interpolation
def _interpolated_codes(part_code, partner_code, part_id: int, mid_num: int):
    """(B, K, zdim) codes with part ``part_id`` moved from ``part_code``'s to
    ``partner_code``'s in ``mid_num`` steps -> (B * mid_num, K, zdim)."""
    B = part_code.shape[0]
    dx = torch.as_tensor(np.linspace(0, 1, mid_num, dtype=np.float32).reshape(1, mid_num, 1),
                         device=part_code.device)
    src, dst = part_code[:, part_id], partner_code[:, part_id]
    interp = src[:, None] + (dst[:, None] - src[:, None]) * dx  # (B, mid, zdim)
    codes = part_code[:, None].repeat(1, mid_num, 1, 1)
    codes[:, :, part_id] = interp
    return codes.reshape(B * mid_num, *part_code.shape[1:])


@torch.inference_mode()
def interpolate_latent(model: AnchorDiffAE, batch, part_id: Optional[int] = None,
                       mid_num: int = 10, generator=None, *, part_code_eps=None, perm_seed=None,
                       cimle_noise=None, x_T=None, step_noise=None) -> Dict[str, np.ndarray]:
    """Interpolate one part's code toward a permuted partner shape's over
    ``mid_num`` steps (``editing.py:125-175``)."""
    part_id = model.interpolate_part_id if part_id is None else part_id
    batch = ensure_attn_maps(batch)
    x, seg_flag = batch["input"], batch["attn_map"]
    dev = x.device
    valid_id = batch["present"].float()
    ref_seg = batch["ref_seg_mask"].int()
    B = x.shape[0]

    part_code = model.encode_part_code(x, seg_flag, True, generator, _tensor(part_code_eps, dev))
    perm = np.random.RandomState(_perm_seed(generator, perm_seed)).permutation(B)
    codes = _interpolated_codes(part_code, part_code[torch.as_tensor(perm, device=dev)],
                                part_id, mid_num)
    valid_r = valid_id.repeat_interleave(mid_num, dim=0)
    noise = _draw((B, NOISE_DIM), generator, dev, cimle_noise) if model.cimle else None
    noise_r = noise.repeat_interleave(mid_num, dim=0) if noise is not None else None
    seg_mask = ref_seg.repeat_interleave(mid_num, dim=0)
    ctx, mean_pp, var_pp, seg_mask, _ = model.latents_to_decode(codes, valid_r, noise_r, seg_mask)
    pred = _t2n(_decode(model, mean_pp, ctx, var_pp, seg_mask, valid_r, generator, x_T,
                        step_noise)).reshape(B, mid_num, -1, 3)
    ref_seg_np, ref_np = _t2n(ref_seg), _t2n(batch["ref"])
    result = {f"interpolate sample {i}": pred[:, i] for i in range(mid_num)}
    result["pred"] = pred[:, 0]
    result["pred_seg_mask"] = ref_seg_np
    result["ref_seg_mask"] = ref_seg_np
    result["input_ref"] = ref_np
    result["permuted_ref"] = ref_np[perm]
    result["permuted_ref_seg_mask"] = ref_seg_np[perm]
    result["shift"] = _t2n(batch["shift"])
    result["scale"] = _t2n(batch["scale"])
    return result


@torch.inference_mode()
def interpolate_two_shapes(model: AnchorDiffAE, pcds1, mask1, pcds2, mask2, part_id: int,
                           mid_num: int = 10, generator=None, *, eps1=None, eps2=None,
                           cimle_noise=None, x_T=None, step_noise=None):
    """Interpolate part ``part_id`` between two explicit shapes
    (``editing.py:178-220``): pcds (B, N, 3), masks (B, N) integer part
    labels. Returns pred (B, mid_num, N, 3) and the seg masks (B, mid_num, N)."""
    dev, K_cls = model.device, model.num_anchors
    m1, m2 = (torch.as_tensor(np.asarray(m), device=dev).long() for m in (mask1, mask2))
    one1, one2 = (torch.nn.functional.one_hot(m, K_cls).float() for m in (m1, m2))
    c1 = model.encode_part_code(torch.as_tensor(np.asarray(pcds1), dtype=torch.float32,
                                                device=dev), one1, True, generator,
                                _tensor(eps1, dev))
    c2 = model.encode_part_code(torch.as_tensor(np.asarray(pcds2), dtype=torch.float32,
                                                device=dev), one2, True, generator,
                                _tensor(eps2, dev))
    B = c1.shape[0]
    valid = torch.stack([(m1 == i).any(1) for i in range(K_cls)], dim=1).float()
    codes = _interpolated_codes(c1, c2, part_id, mid_num)
    valid_r = valid.repeat_interleave(mid_num, dim=0)
    noise = _draw((B, NOISE_DIM), generator, dev, cimle_noise) if model.cimle else None
    noise_r = noise.repeat_interleave(mid_num, dim=0) if noise is not None else None
    seg = m1.int().repeat_interleave(mid_num, dim=0)
    ctx, mean_pp, var_pp, seg, _ = model.latents_to_decode(codes, valid_r, noise_r, seg)
    pred = _decode(model, mean_pp, ctx, var_pp, seg, valid_r, generator, x_T, step_noise)
    N = seg.shape[1]
    return _t2n(pred).reshape(B, mid_num, N, 3), _t2n(seg).reshape(B, mid_num, N)


@torch.inference_mode()
def select_best_noise_whole(model: AnchorDiffAE, batch, num: int = 10, generator=None, *,
                            noise=None, x_T=None, step_noise=None):
    """CIMLE selection by the decoded shape (``editing.py:223-245``): every
    one of ``num`` candidate noises goes through the whole reverse chain, and
    each shape keeps the one whose reconstruction has the least Chamfer
    distance to it, in world coordinates. ``noise`` (B * num, D) injects the
    candidates. Returns (noise (B, num, D), best_idx (B,), selected (B, D))."""
    batch = ensure_attn_maps(batch)
    cand, _, _ = select_best_noise(model, batch, num, generator=generator,
                                   noise=_tensor(noise, batch["ref"].device))
    dev = cand.device
    out = reconstruct(model, batch, noise=cand, generator=generator, x_T=_tensor(x_T, dev),
                      step_noise=_tensor(step_noise, dev))
    B = batch["ref"].shape[0]
    pred = out["pred"].float().reshape(B, num, -1, 3)
    shift, scale = batch["shift"].float(), batch["scale"].float()
    pred_w = pred * scale[:, None] + shift[:, None]
    ref_w = batch["ref"].float() * scale + shift
    N = pred_w.shape[2]
    cds = chamfer_l2(pred_w.reshape(B * num, N, 3),
                     ref_w.repeat_interleave(num, dim=0)).reshape(B, num)
    best = torch.argmin(cds, dim=1)
    selected = torch.gather(cand, 1, best[:, None, None].expand(-1, 1, cand.shape[-1]))[:, 0]
    return cand, best, selected


@torch.inference_mode()
def interpolate_params(model: AnchorDiffAE, batch, part_id: int = 1, generator=None, *,
                       part_code_eps=None, cimle_noise=None, x_T=None,
                       step_noise=None) -> Dict[str, np.ndarray]:
    """Transformation editing (``editing.py:248-299``): part ``part_id``
    stretched along x and z by sqrt(dx), its variances there by dx, dx in
    [1, 5] over ``cimle_sample_num`` steps."""
    batch = ensure_attn_maps(batch)
    x, seg_flag = batch["input"], batch["attn_map"]
    dev = x.device
    valid_id = batch["present"].float()
    ref_seg = batch["ref_seg_mask"].int()
    B, K = x.shape[0], model.cimle_sample_num
    enc = model.encoder_mod

    part_code = model.encode_part_code(x, seg_flag, True, generator, _tensor(part_code_eps, dev))
    dx = torch.as_tensor(np.linspace(1.0, 5.0, K, dtype=np.float32), device=dev)
    dx = dx.repeat(B)  # (B * K,): row b K + k takes dx[k]
    codes = part_code.repeat_interleave(K, dim=0)
    valid_r = valid_id.repeat_interleave(K, dim=0)
    noise = _draw((B, NOISE_DIM), generator, dev, cimle_noise) if model.cimle else None
    noise_r = noise.repeat_interleave(K, dim=0) if noise is not None else None
    seg_mask = ref_seg.repeat_interleave(K, dim=0)

    mean, logvar = enc.get_params_from_part_code(codes, valid_r, noise=noise_r)
    mean, logvar = mean.clone(), logvar.clone()
    for axis in (0, 2):
        mean[:, part_id, axis] *= torch.sqrt(dx)
        logvar[:, part_id, axis] += torch.log(dx)
    mean_pp, logvar_pp, _ = enc.gather_all(seg_mask, anchors=mean,
                                           variances=logvar + enc.log_scale_var)
    ctx = enc.prepare_ctx(codes, mean, logvar, seg_mask=seg_mask)
    pred = _t2n(_decode(model, mean_pp, ctx, torch.exp(logvar_pp), seg_mask, valid_r, generator,
                        x_T, step_noise)).reshape(B, K, -1, 3)
    ref_seg_np = _t2n(ref_seg)
    result = {f"interpolate sample {i}": pred[:, i] for i in range(K)}
    result["pred"] = pred[:, 0]
    result["pred_seg_mask"] = ref_seg_np
    result["ref_seg_mask"] = ref_seg_np
    result["seg_mask"] = ref_seg_np
    result["input_ref"] = _t2n(batch["ref"])
    result["shift"] = _t2n(batch["shift"])
    result["scale"] = _t2n(batch["scale"])
    return result


# ------------------------------------------------ diversity subsampling
def _param_scores(mean, logvar, valid, draws):
    """Per-candidate bbox-normalised sample statistics, the diversity score
    (part_encoders.py:553-561): 512 points a part drawn from the candidate
    Gaussians, normalised by the valid parts' bbox; the score is [mean |
    2 log(std)] a part, std unbiased."""
    C = mean.shape[0]
    scores = np.empty(mean.shape[:-1] + (6,), np.float64)  # (C, K, 6)
    for c in range(C):
        pts = draws[c] * np.exp(0.5 * logvar[c])[None] + mean[c][None]  # (512, K, 3)
        vpts = pts[:, valid.astype(bool)].reshape(-1, 3)
        shift = (vpts.max(0) + vpts.min(0)) / 2
        scale = (vpts.max(0) - vpts.min(0)).max() / 2
        pts = (pts - shift) / scale
        scores[c] = np.concatenate([pts.mean(0), 2.0 * np.log(pts.std(0, ddof=1))], axis=-1)
    return scores


def _greedy_select(score, valid, num):
    """Greedy farthest-score selection (part_encoders.py:563-583): start at
    candidate 0, then add the candidate farthest, by the least valid-weighted
    score distance, from those selected."""
    C = score.shape[0]
    selected = [0]
    vsum = valid.sum()
    while len(selected) < num:
        best_i, best_d = None, -np.inf
        for i in range(C):
            if i in selected:
                continue
            d = ((score[i][None] - score[selected]) ** 2) * valid[None, :, None]
            dmin = (d.sum(axis=(-1, -2)) / vsum).min()
            if dmin > best_d:
                best_d, best_i = dmin, i
        selected.append(best_i)
    return selected


def subsample_params(mean, logvar, valid_id, num, rng=None, return_ids=False, point_draws=None):
    """Diverse down-sampling of aligner parameter candidates on the host
    (part_encoders.py:545-589). mean, logvar (B, C, K, 3): C candidate sets a
    row; valid_id (B, K); ``point_draws`` (B, C, 512, K, 3) injects the
    standard normal draws (else from ``rng``, RandomState(0) by default).
    Returns (mean_sel, logvar_sel) each (B, num, K, 3), and with
    ``return_ids`` the (B, num) selected indices."""
    mean, logvar = np.asarray(mean, np.float64), np.asarray(logvar, np.float64)
    valid_id = np.asarray(valid_id, np.float64)
    B, C, Kc, _ = mean.shape
    if num > C:
        raise ValueError(f"subsample_params: requested {num} candidates but only {C} exist")
    rng = rng or np.random.RandomState(0)
    if point_draws is None:
        point_draws = rng.standard_normal((B, C, 512, Kc, 3))
    ids = np.empty((B, num), np.int64)
    for b in range(B):
        scores = _param_scores(mean[b], logvar[b], valid_id[b], point_draws[b])
        ids[b] = _greedy_select(scores, valid_id[b], num)
    msel = np.take_along_axis(mean, ids[..., None, None], axis=1).astype(np.float32)
    vsel = np.take_along_axis(logvar, ids[..., None, None], axis=1).astype(np.float32)
    return ((msel, vsel), ids) if return_ids else (msel, vsel)


def subsample_params_global(mean, logvar, valid_id, num, rng=None, point_draws=None):
    """Greedy diverse selection across rows (part_encoders.py:592-621): mean,
    logvar (B, K, 3), valid_id (B, K) -> ((mean_sel, logvar_sel) each
    (num, K, 3), the selected rows). Each row is scored with its own valid
    parts' bbox normalisation."""
    mean, logvar = np.asarray(mean, np.float64), np.asarray(logvar, np.float64)
    valid_id = np.asarray(valid_id, np.float64)
    B, Kc, _ = mean.shape
    rng = rng or np.random.RandomState(0)
    if point_draws is None:
        point_draws = rng.standard_normal((B, 512, Kc, 3))
    score = np.concatenate([_param_scores(mean[b:b + 1], logvar[b:b + 1], valid_id[b],
                                          point_draws[b:b + 1]) for b in range(B)])
    selected = [0]
    alive = np.ones(B, bool)
    alive[0] = False
    while len(selected) < num:
        d = (score[:, None] - score[selected][None]) ** 2  # (B, S, K, 6)
        w = (valid_id[:, None] * valid_id[selected][None])[..., None]
        d = ((d * w).sum(axis=(-1, -2)) / np.maximum(w[..., 0].sum(-1), 1e-12)).min(1)
        d[~alive] = -np.inf
        i = int(np.argmax(d))
        alive[i] = False
        selected.append(i)
    sel = np.asarray(selected, np.int64)
    return (mean[sel].astype(np.float32), logvar[sel].astype(np.float32)), sel


# --------------------------------------------------- single-part resampling
@torch.inference_mode()
def sample_one_part(model: AnchorDiffAE, codes, valid_id, gt_mean, gt_logvar, seg_mask,
                    part_id: int, sample_num_each: int = 10, fix_size: bool = True,
                    noise_search: int = 100, param_sample_num: int = 1,
                    selective: bool = False, generator=None, *, w=None, search_noise=None,
                    x_T=None, step_noise=None) -> Dict[str, np.ndarray]:
    """Resample one part's latent from the flow prior and keep the rest
    (``editing.py:411-520``).

    codes (S, K, zdim); valid_id (S, K); gt_mean, gt_logvar (S, K, 3); seg_mask
    (S, N). Each of the S shapes gets E = ``sample_num_each`` new codes for
    the part (``w`` (S E, K, zdim) injects the flow's input), each variant
    ``noise_search`` aligner noises (``search_noise`` (S E noise_search, 32)):
    the aligner runs on S E noise_search rows at once. ``fix_size`` keeps the
    noise whose parameters of the other parts fit the reference best; else
    P = ``param_sample_num`` sets a variant, the greedy-diverse
    ``subsample_params`` choice when ``selective``, else the first P. Rows
    are (shape, variant, noise) in that order throughout. Returns 'pred' (S,
    E P, N, 3), 'seg_mask', 'valid_id', 'codes', 'means', 'logvars'."""
    dev = model.device
    as_t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
    codes, valid_id = as_t(codes), as_t(valid_id)
    S, n_class, zdim = codes.shape
    E, Kn = sample_num_each, noise_search
    enc = model.encoder_mod

    w = _draw((S * E, n_class, zdim), generator, dev, w)
    new_codes = enc.flow(w, reverse=True)[:, part_id]
    codes_rep = codes.repeat_interleave(E, dim=0).clone()
    codes_rep[:, part_id] = new_codes.to(codes_rep.dtype)

    noise = _draw((S * E * Kn, NOISE_DIM), generator, dev, search_noise)
    mean, logvar = enc.get_params_from_part_code(
        codes_rep.repeat_interleave(Kn, dim=0), valid_id.repeat_interleave(E * Kn, dim=0),
        noise=noise)
    mean = mean.float().reshape(S, E, Kn, n_class, 3)
    logvar = logvar.float().reshape(S, E, Kn, n_class, 3)
    P = 1 if fix_size else max(1, param_sample_num)
    if P > Kn:
        raise ValueError(f"sample_one_part: param_sample_num={P} exceeds noise_search={Kn} "
                         "candidates")
    if fix_size:
        gt = torch.cat([as_t(gt_mean), as_t(gt_logvar)], dim=-1)[:, None, None]
        fit = ((torch.cat([mean, logvar], dim=-1) - gt) ** 2).sum(-1)
        fit = fit * valid_id[:, None, None, :]
        fit[..., part_id] = 0.0
        idx = torch.argmin(fit.sum(-1), dim=2)[..., None]  # (S, E, 1)
    elif selective:
        (_, _), ids = subsample_params(
            _t2n(mean).reshape(S * E, Kn, n_class, 3), _t2n(logvar).reshape(S * E, Kn, n_class, 3),
            np.repeat(_t2n(valid_id), E, axis=0), P, return_ids=True)
        idx = torch.as_tensor(ids.reshape(S, E, P), device=dev)
    else:
        idx = torch.arange(P, device=dev)[None, None].expand(S, E, P)

    take = lambda a: torch.gather(a, 2, idx[..., None, None].expand(-1, -1, -1, n_class, 3))
    mean_b = take(mean).reshape(S * E * P, n_class, 3)
    logvar_b = take(logvar).reshape(S * E * P, n_class, 3)
    codes_rep = codes_rep.repeat_interleave(P, dim=0)
    seg = torch.as_tensor(np.asarray(seg_mask), device=dev).int().repeat_interleave(E * P, dim=0)
    valid_e = valid_id.repeat_interleave(E * P, dim=0)

    mean_pp, logvar_pp, _ = enc.gather_all(seg, anchors=mean_b, variances=logvar_b)
    ctx = enc.prepare_ctx(codes_rep, mean_b, logvar_b, seg_mask=seg)
    pred = _decode(model, mean_pp, ctx, torch.exp(logvar_pp), seg, valid_e, generator, x_T,
                   step_noise)
    N, EP = seg.shape[1], E * P
    return {
        "pred": _t2n(pred).reshape(S, EP, N, 3),
        "seg_mask": _t2n(seg).reshape(S, EP, N),
        "valid_id": _t2n(valid_e).reshape(S, EP, n_class),
        "codes": _t2n(codes_rep).reshape(S, EP, n_class, zdim),
        "means": _t2n(mean_b).reshape(S, EP, n_class, 3),
        "logvars": _t2n(logvar_b).reshape(S, EP, n_class, 3),
    }


# ------------------------------------------------------ gradient-based edits
def _adam(z, lr):
    return torch.optim.Adam([z], lr=lr, betas=(0.9, 0.999), eps=1e-8)


def _total(losses) -> torch.Tensor:
    return sum(v.mean() for k, v in losses.items() if "loss" in k)


def recon_loss_and_grad(model: AnchorDiffAE, batch, z):
    """The loss ``optimize_noise`` descends (the sum of the means of
    ``recon_losses``' terms) at aligner noise z, and its gradient in z."""
    with torch.enable_grad():
        z = z.detach().requires_grad_(True)
        total = _total(model.recon_losses(batch, z))
        (g,) = torch.autograd.grad(total, [z])
    return total.detach(), g


def edit_loss_and_grad(model: AnchorDiffAE, z, x, seg_flag, valid_id, ref_means, ref_vars,
                       fix_ids, edit_part_id, edit_part_mean=None, edit_part_var=None,
                       fit_weight: float = 1.0):
    """The loss ``shape_edit`` descends (the sum of the means of
    ``edit_losses``' terms) at aligner noise z, and its gradient in z."""
    with torch.enable_grad():
        z = z.detach().requires_grad_(True)
        total = _total(model.edit_losses(z, x, seg_flag, valid_id, ref_means, ref_vars, fix_ids,
                                         edit_part_id, edit_part_mean, edit_part_var,
                                         fit_weight))
        (g,) = torch.autograd.grad(total, [z])
    return total.detach(), g


def _descend(loss_and_grad, z0, steps: int, lr: float):
    """``steps`` Adam steps from z0; returns (z, the loss at each step's start)."""
    z = z0.detach().clone().float()
    opt = _adam(z, lr)
    history: List[torch.Tensor] = []
    for _ in range(steps):
        val, g = loss_and_grad(z)
        z.grad = g.float()
        opt.step()
        history.append(val.float())
    return z.detach(), (torch.stack(history).tolist() if history else [])


def optimize_noise(model: AnchorDiffAE, batch, steps: int = 100, lr: float = 1.0,
                   generator=None, *, z0=None, part_code_eps=None):
    """Optimise the CIMLE noise z to minimise the encoder's fit loss and the
    noise's L2 penalty with Adam (``editing.py:523-551``). A ``gen``
    encoder's part code is drawn once (``part_code_eps`` injects it) and kept
    for every step, as the JAX function's loss reuses one key. Returns
    (z (B, 32), the loss at each step's start)."""
    batch = dict(ensure_attn_maps(batch))
    B, dev = batch["ref"].shape[0], batch["ref"].device
    z0 = _draw((B, NOISE_DIM), generator, dev, z0)
    if model.encoder_mod.gen:
        shape = (B, model.num_anchors, model.encoder_mod.zdim)
        batch["part_code_eps"] = _draw(shape, generator, dev, part_code_eps)
    return _descend(lambda z: recon_loss_and_grad(model, batch, z), z0, steps, lr)


def shape_edit(model: AnchorDiffAE, batch, edit_part_id: int, edit_part_mean=None,
               edit_part_var=None, fix_ids=None, steps: int = 100, lr: float = 0.1,
               fit_weight: float = 1.0, generator=None, *, z0=None, x_T=None,
               step_noise=None) -> Dict:
    """Optimise the aligner noise so that the edited part's parameters reach
    their target while the fixed parts stay put (``editing.py:554-612``), then
    decode with it. Returns 'pred' (B, N, 3), 'z' (B, 32) and 'loss' (the
    loss at the last step's start)."""
    batch = ensure_attn_maps(batch)
    x, seg_flag = batch["input"], batch["attn_map"]
    valid_id = batch["present"].float()
    B, dev = x.shape[0], x.device
    as_t = lambda a: None if a is None else torch.as_tensor(a, dtype=torch.float32, device=dev)
    if fix_ids is None:
        fix_ids = torch.ones_like(valid_id)
        fix_ids[:, edit_part_id] = 0.0
    fix_ids = as_t(fix_ids)
    ref_means, ref_vars = batch["part_shift"].float(), batch["part_scale"].float() ** 2
    edit_part_mean, edit_part_var = as_t(edit_part_mean), as_t(edit_part_var)

    z0 = _draw((B, NOISE_DIM), generator, dev, z0)
    z, history = _descend(
        lambda z: edit_loss_and_grad(model, z, x, seg_flag, valid_id, ref_means, ref_vars,
                                     fix_ids, edit_part_id, edit_part_mean, edit_part_var,
                                     fit_weight), z0, steps, lr)
    with torch.inference_mode():
        codes = model.encode_part_code(x, seg_flag, False)
        seg_mask = batch["ref_seg_mask"].int()
        ctx, mean_pp, var_pp, seg_mask, _ = model.latents_to_decode(codes, valid_id, z, seg_mask)
        pred = _decode(model, mean_pp, ctx, var_pp, seg_mask, valid_id, generator, x_T,
                       step_noise)
    return {"pred": _t2n(pred), "z": _t2n(z), "loss": history[-1] if history else float("nan")}


# -------------------------------------------------------------- CLI drivers
def _first_val_batch(runner):
    from .runner import device_batch

    return device_batch(next(iter(runner.val_loader)), runner.device, runner._slim_val)


def run_interpolation(runner, args) -> Dict[str, np.ndarray]:
    """``--task interpolation``: ``interpolate_latent`` on the first val batch,
    written to ``<interpolation_dir or work_dir/interpolation>/interpolation.npz``."""
    gen = torch.Generator(device=runner.device).manual_seed(args.seed)
    out = interpolate_latent(runner.model, _first_val_batch(runner), part_id=args.part_id,
                             generator=gen)
    out_dir = args.interpolation_dir or os.path.join(runner.work_dir, "interpolation")
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, "interpolation.npz"), **out)
    runner.logger.print_log(f"interpolation written to {out_dir}")
    return out


def run_mixing(runner, args) -> Dict[str, np.ndarray]:
    """``--task mixing``: ``combine_latent`` on the first val batch, written to
    ``work_dir/mixing/mixing.npz``."""
    gen = torch.Generator(device=runner.device).manual_seed(args.seed)
    out = combine_latent(runner.model, _first_val_batch(runner), generator=gen)
    out_dir = os.path.join(runner.work_dir, "mixing")
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, "mixing.npz"), **out)
    runner.logger.print_log(f"mixing written to {out_dir}")
    return out
