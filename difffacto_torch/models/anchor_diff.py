"""AnchorDiffAE: the training loss, and the generation entry points.

Port of ``difffacto_tpu/models/anchor_diff.py``: ``loss`` (the whole training
forward: encoder, prior and fit losses, q_sample, denoiser, mse),
``prepare_generation`` (flow prior -> CIMLE aligner -> per-point params and
ctx), ``decode`` (the reverse chain), ``sample_generation`` (both,
unconditional generation; reference anchor_gen.py:1034-1084) and
``select_best_noise`` (the CIMLE best-of-N noise selection). Every random draw
comes from an explicit ``torch.Generator`` or is injected: ``z`` (flow-prior
latents), ``cimle_noise`` (aligner noise), ``noise`` (x_T) and ``step_noise``
(per-step draws); in training ``diffusion_t``, ``diffusion_noise``, ``noise``
and ``part_code_eps`` through the batch.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..utils.device import resolve_device
from ..utils.registry import DIFFUSIONS, ENCODERS, MODELS, NETS, SAMPLERS, build_from_cfg
from . import samplers  # noqa: F401  (registers Uniform)
from .diffusion import AnchoredDiffusion
from .part_encoder import gather_per_point


def ensure_attn_maps(batch):
    """Rebuild the one-hot part maps on the device from integer seg masks
    (``anchor_diff.py:39-63``): no-op where the maps are present; int masks
    become int32 either way."""
    if "seg_mask" not in batch and "ref_seg_mask" not in batch:
        return batch
    out = dict(batch)
    K = out["present"].shape[-1] if "present" in out else None
    for mask_key, map_key in (("seg_mask", "attn_map"), ("ref_seg_mask", "ref_attn_map")):
        m = out.get(mask_key)
        if m is None:
            continue
        if m.dtype != torch.int32:
            out[mask_key] = m = m.to(torch.int32)
        if map_key not in out and K is not None:
            out[map_key] = torch.nn.functional.one_hot(m.long(), K).to(torch.float32)
    return out


def build_diffusion(diffusion_cfg: dict, num_timesteps: int) -> AnchoredDiffusion:
    cfg = dict(diffusion_cfg)
    cfg.pop("net", None)
    cfg.setdefault("type", "AnchoredDiffusion")
    cfg["num_timesteps"] = num_timesteps
    return build_from_cfg(cfg, DIFFUSIONS)


@MODELS.register_module()
class AnchorDiffAE(nn.Module):
    """Constructor arguments mirror the JAX module. ``seed`` fixes the initial
    weights (drawn on the CPU, so they are the same on every device)."""

    def __init__(self, encoder: dict, diffusion: dict, num_anchors: int, num_timesteps: int,
                 sampler: Optional[dict] = None, npoints: int = 2048, zero_anchors: bool = False,
                 gen: bool = False, sample_noise_num: int = 20, cimle: bool = False,
                 cimle_sample_num: int = 10, diffusion_loss_weight: float = 1.0,
                 use_input: bool = False, detach_anchor: bool = True, ret_traj: bool = False,
                 pretrain_prior: bool = False, train_language: bool = False,
                 *, dtype=None, device="cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        if pretrain_prior or train_language:
            raise NotImplementedError("pretrain_prior and train_language are not ported yet")
        g = torch.Generator().manual_seed(seed)
        self.num_anchors, self.num_timesteps, self.npoints = num_anchors, num_timesteps, npoints
        self.cimle_sample_num, self.ret_traj = cimle_sample_num, ret_traj
        self.zero_anchors, self.gen, self.cimle = zero_anchors, gen, cimle
        self.sample_noise_num, self.diffusion_loss_weight = sample_noise_num, diffusion_loss_weight
        self.use_input, self.detach_anchor = use_input, detach_anchor
        kw = dict(dtype=dtype, device=device, generator=g)
        self.encoder_mod = build_from_cfg(dict(encoder), ENCODERS, **kw)
        self.net = build_from_cfg(dict(diffusion["net"]), NETS, **kw)
        self.diff = build_diffusion(diffusion, num_timesteps)
        self.t_sampler = build_from_cfg(dict(sampler or dict(type="Uniform")), SAMPLERS,
                                        num_timesteps=num_timesteps)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def denoise(self, x, t, ctx, anchors, variances, seg_mask, valid_id, train: bool = False,
                generator=None):
        """One denoiser call: the body of every reverse step, and the training net."""
        return self.net(x, t, ctx, anchors, variances, seg_mask, valid_id, train=train,
                        generator=generator)

    def encode(self, batch, noise=None, epoch=-1, train: bool = False, rngs=None):
        """The encoder forward: (ctx, mean_pp, logvar_pp, flag_pp, losses, latents)."""
        return self.encoder_mod(batch, noise=noise, epoch=epoch, train=train, rngs=rngs)

    def sample_noise_candidates(self, batch, num=None, generator=None, noise=None):
        return self.encoder_mod.sample_noise_candidates(
            batch, self.sample_noise_num if num is None else num, generator=generator, noise=noise)

    def loss(self, batch, epoch=0, train: bool = True, rngs=None):
        """The full training loss (``anchor_diff.py:169-228``) as a dict.

        ``rngs`` holds the ``"sample"`` and ``"dropout"`` generators; the batch
        may inject ``diffusion_t``, ``diffusion_noise``, ``noise`` (the CIMLE
        latent) and ``part_code_eps``. ``train=False`` runs the same loss with
        the running BatchNorm statistics and no dropout.
        """
        rngs = rngs or {}
        ref = batch["ref"]
        seg_mask = batch["ref_seg_mask"].int()
        dp_valid_id = batch.get("dp_present")
        B = ref.shape[0]

        ctx, mean_pp, logvar_pp, _, loss_dict, _ = self.encoder_mod(
            batch, epoch=epoch, train=train, rngs=rngs)
        if self.zero_anchors:
            mean_pp = torch.zeros_like(mean_pp)
        # The variance is taken before the anchor is detached and keeps its
        # gradient; only the anchor is detached (a reference quirk, kept).
        variance_pp = torch.exp(logvar_pp)
        if self.detach_anchor:
            mean_pp = mean_pp.detach()

        t = batch.get("diffusion_t")
        if t is None:
            t, _ = self.t_sampler.sample(rngs.get("sample"), B, device=ref.device)
        dp_flags = None
        if dp_valid_id is not None:
            dp_flags = gather_per_point(dp_valid_id[..., None], seg_mask)[..., 0]

        def model_fn(inp, ts, c, anc, var, seg, vid):
            return self.denoise(inp, ts, c, anc, var, seg, vid, train=train,
                                generator=rngs.get("dropout"))

        x0 = batch["input"] if self.use_input else ref
        diff_losses = self.diff.training_losses(
            model_fn, x0, t.long(), anchors=mean_pp, variance=variance_pp, ctx=ctx,
            seg_mask=seg_mask, valid_id=dp_valid_id, flags=dp_flags,
            noise=batch.get("diffusion_noise"), generator=rngs.get("sample"))
        diff_losses["mse_loss"] = self.diffusion_loss_weight * diff_losses["mse_loss"]
        loss_dict.update(diff_losses)
        return loss_dict

    def prepare_generation(self, sample_num: int, fixed_id=None, valid_id=None, epoch: int = 0,
                           generator=None, z=None, cimle_noise=None):
        """Latents for unconditional generation (``anchor_diff.py:426-435``).

        Returns (ctx, mean_pp, variance_pp, seg_mask, valid_id, latents) with
        leading dim sample_num * cimle_sample_num.
        """
        ctx, mean_pp, logvar_pp, seg_mask, valid_id, latents = self.encoder_mod.sample_latents(
            sample_num, self.npoints, fixed_id=fixed_id, valid_id=valid_id, epoch=epoch,
            K=self.cimle_sample_num, generator=generator, z=z, cimle_noise=cimle_noise,
        )
        return ctx, mean_pp, torch.exp(logvar_pp), seg_mask, valid_id, latents


@torch.inference_mode()
def decode(model: AnchorDiffAE, anchors, ctx=None, variance=None, seg_mask=None, valid_id=None,
           noise=None, step_noise=None, generator: Optional[torch.Generator] = None,
           ret_traj: Optional[bool] = None):
    """The reverse diffusion chain (``anchor_diff.py:486-597``) -> {'pred': (B, N, 3)}."""
    ret_traj = model.ret_traj if ret_traj is None else ret_traj
    return model.diff.p_sample_loop(
        model.denoise, anchors, ctx=ctx, variance=variance, seg_mask=seg_mask,
        valid_id=valid_id, noise=noise, ret_traj=ret_traj, step_noise=step_noise,
        generator=generator,
    )


@torch.inference_mode()
def sample_generation(model: AnchorDiffAE, sample_num: int, valid_id=None, fixed_id=None,
                      epoch: int = 0, ret_traj: bool = False,
                      generator: Optional[torch.Generator] = None, z=None, cimle_noise=None,
                      noise=None, step_noise=None):
    """Unconditional generation (``anchor_diff.py:600-651``): flow prior ->
    aligner (K CIMLE hypotheses) -> reverse chain. Returns a dict with 'pred'
    (S*K, N, 3), 'seg_mask', 'valid_id', 'anchors', 'variance', 'latents'."""
    if fixed_id is None:
        fixed_id = torch.zeros(model.num_anchors, device=model.device)
    ctx, mean_pp, var_pp, seg_mask, vid, latents = model.prepare_generation(
        sample_num, fixed_id, valid_id, epoch, generator=generator, z=z, cimle_noise=cimle_noise
    )
    out = decode(model, mean_pp, ctx=ctx, variance=var_pp, seg_mask=seg_mask, valid_id=vid,
                 noise=noise, step_noise=step_noise, generator=generator, ret_traj=ret_traj)
    out.update(seg_mask=seg_mask, valid_id=vid, anchors=mean_pp, variance=var_pp, latents=latents)
    return out


@torch.no_grad()
def select_best_noise(model: AnchorDiffAE, batch, num: Optional[int] = None,
                      generator: Optional[torch.Generator] = None, noise=None):
    """CIMLE noise caching: the best of N candidates by fit loss
    (``anchor_diff.py:702-725``). ``noise`` (B * num, noise_dim) injects the
    candidates. Returns (noise (B, num, D), best_idx (B,), selected (B, D))."""
    cand, fit = model.sample_noise_candidates(ensure_attn_maps(batch), num, generator=generator,
                                              noise=noise)
    best = torch.argmin(fit, dim=1)
    selected = torch.gather(cand, 1, best[:, None, None].expand(-1, 1, cand.shape[-1]))[:, 0]
    return cand, best, selected
