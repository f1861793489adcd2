"""Part encoder: per-part latents, part aligner, fit and prior losses, sampling.

Port of ``difffacto_tpu/models/part_encoder.py`` for
``PartEncoderForTransformerDecoder``: the generation half (flow prior ->
aligner -> per-point params and ctx) and the training half (PointNetV2 part
codes, the five fit losses, the flow prior loss, the CIMLE noise candidates).
Every draw comes from an explicit generator or is injected.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..utils.device import randn, resolve_device
from ..utils.registry import ENCODERS, build_from_cfg
from ..nn.layers import default_generator
from ..utils.gaussian import gaussian_entropy, gaussian_log_likelihood, reparameterize_gaussian
from .flow import PerPartFlow


def gather_per_point(values: torch.Tensor, seg_mask: torch.Tensor) -> torch.Tensor:
    """(B, K, C), (B, N) int -> (B, N, C): per-point copy of per-part values."""
    idx = seg_mask.long()[..., None].expand(*seg_mask.shape, values.shape[-1])
    return torch.gather(values, 1, idx)


@ENCODERS.register_module()
class PartEncoderForTransformerDecoder(nn.Module):
    """Constructor arguments mirror the JAX package's ``PartEncoder``; the ctx
    is the K part tokens themselves (``part_encoder.py:433-447``)."""

    def __init__(self, encoder: dict, n_class: int = 4, part_aligner: Optional[dict] = None,
                 fit_loss_weight: float = 1.0, include_part_code: bool = False,
                 include_params: bool = False, use_gt_params: bool = False,
                 encode_ref: bool = False, scale_var: float = 1.0, fit_loss_type: int = 0,
                 origin_scale: bool = False, kl_weight: float = 0.001, use_flow: bool = False,
                 latent_flow_depth: int = 14, latent_flow_hidden_dim: int = 256,
                 use_gt_params_in_training: bool = False, gen: bool = False,
                 kl_weight_annealing: bool = False, min_kl_weight: float = 1e-7,
                 kl_weight_annealing_end_epoch: int = 3000, normalize_part_code: bool = False,
                 detach_params_in_ctx: bool = False, prior_var: float = 1.0,
                 *, dtype=None, device="cuda", generator=None):
        super().__init__()
        device = resolve_device(device)
        if encode_ref:
            raise NotImplementedError("encode_ref (the reference-cloud PointNet) is not ported yet")
        g = default_generator(generator)
        self.n_class, self.zdim = n_class, encoder["zdim"]
        self.include_part_code, self.include_params = include_part_code, include_params
        self.scale_var, self.prior_var = scale_var, prior_var
        self.fit_loss_weight, self.fit_loss_type = fit_loss_weight, fit_loss_type
        self.use_gt_params, self.use_gt_params_in_training = use_gt_params, use_gt_params_in_training
        self.origin_scale, self.gen, self.use_flow = origin_scale, gen, use_flow
        self.kl_weight, self.kl_weight_annealing = kl_weight, kl_weight_annealing
        self.min_kl_weight = min_kl_weight
        self.kl_weight_annealing_end_epoch = kl_weight_annealing_end_epoch
        self.normalize_part_code = normalize_part_code
        self.detach_params_in_ctx = detach_params_in_ctx
        self.encoder_net = build_from_cfg(dict(encoder), ENCODERS, num_anchors=n_class,
                                          dtype=dtype, device=device, generator=g)
        self.aligner = (
            build_from_cfg(dict(part_aligner), ENCODERS, dtype=dtype, device=device, generator=g)
            if part_aligner
            else None
        )
        self.flow = (
            PerPartFlow(n_class, latent_flow_depth, self.zdim, latent_flow_hidden_dim,
                        dtype=dtype, device=device, generator=g)
            if gen and use_flow
            else None
        )

    @property
    def log_scale_var(self) -> float:
        return math.log(self.scale_var)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @property
    def noise_dim(self) -> int:
        return self.aligner.noise_dim if self.aligner is not None else 32

    @property
    def cimle(self) -> bool:
        return self.aligner is not None and self.aligner.cimle

    def get_part_code(self, points, seg_flag, train: bool = False):
        """(B, N, 3), (B, N, K) -> means, logvars each (B, K, zdim)."""
        return self.encoder_net(points, seg_flag, train=train)

    def get_params_from_part_code(self, part_code, valid_id, gt_mean=None, gt_var=None,
                                  noise=None, train: bool = False, generator=None):
        """(B, K, zdim) -> mean, logvar each (B, K, 3) (``part_encoder.py:116-135``)."""
        mean = logvar = None
        if self.aligner is not None:
            mean, logvar = self.aligner(part_code, valid_id, noise=noise, train=train,
                                        generator=generator)
        if self.use_gt_params:
            mean, logvar = gt_mean, torch.log(gt_var)
        return mean, logvar

    def gather_all(self, seg_mask, anchors=None, variances=None, valid_id=None):
        """Per-point anchors, variances (zeros where there are none) and the
        per-point presence flag (ones without ``valid_id``)."""
        zeros = torch.zeros(*seg_mask.shape, 3, device=seg_mask.device)
        anchor_pp = gather_per_point(anchors, seg_mask) if anchors is not None else zeros
        var_pp = gather_per_point(variances, seg_mask) if variances is not None else zeros
        if valid_id is not None:
            flag_pp = gather_per_point(valid_id[..., None], seg_mask)[..., 0]
        else:
            flag_pp = torch.ones(seg_mask.shape, dtype=torch.float32, device=seg_mask.device)
        return anchor_pp, var_pp, flag_pp

    def prepare_ctx(self, part_code, mean, logvar):
        """concat(part_code, mean, exp(logvar + log_scale_var)) -> (B, K, zdim + 6)."""
        ctx = []
        if self.include_part_code:
            ctx.append(part_code)
        if self.include_params:
            params = torch.cat([mean, torch.exp(logvar + self.log_scale_var)], dim=-1)
            ctx.append(params.detach() if self.detach_params_in_ctx else params)
        dt = ctx[0].dtype
        for c in ctx[1:]:
            dt = torch.promote_types(dt, c.dtype)
        return torch.cat([c.to(dt) for c in ctx], dim=-1)

    def sample_flow_prior(self, sample_num: int, generator=None, z=None):
        """Part codes from the flow prior (``part_encoder.py:332-339``).

        ``z`` (sample_num, n_class, zdim) injects the Gaussian draw."""
        if z is None:
            z = randn((sample_num, self.n_class, self.zdim), generator, self.device)
        part_code = z.float() * math.sqrt(self.prior_var)
        if self.flow is not None:
            part_code = self.flow(part_code, reverse=True)
        return part_code

    def sample_latents(self, sample_num: int, sample_points: int, fixed_id=None, valid_id=None,
                       epoch: int = 0, K: Optional[int] = None, part_code=None,
                       generator=None, z=None, cimle_noise=None):
        """Generation-path latents (``part_encoder.py:341-398``).

        Returns (ctx, mean_pp, logvar_pp, seg_mask, valid_id, latents) with
        leading dim sample_num * K (K CIMLE hypotheses per shape). ``z`` and
        ``cimle_noise`` (sample_num * K, noise_dim) inject the two draws.
        """
        if part_code is None:
            part_code = self.sample_flow_prior(sample_num, generator, z)
        dev = part_code.device
        if self.aligner is not None and self.aligner.cimle:
            K = 10 if K is None else K
            noise = cimle_noise
            if noise is None:
                noise = randn((sample_num * K, self.aligner.noise_dim), generator, dev)
            if epoch < self.aligner.cimle_start_epoch:
                noise = torch.zeros_like(noise)
        else:
            K, noise = 1, None
        if valid_id is None:
            valid_id = torch.ones(sample_num, self.n_class, dtype=part_code.dtype, device=dev)
        if fixed_id is not None:
            fixed_id = torch.as_tensor(fixed_id, dtype=part_code.dtype, device=dev)
            fixed_codes = part_code[0:1]
            fixed_valid = torch.clamp(valid_id[0:1] + fixed_id[None], 0, 1)
            part_code = (
                part_code * (1 - fixed_id)[None, :, None] + fixed_id[None, :, None] * fixed_codes
            )
            valid_id = valid_id * (1 - fixed_id)[None] + fixed_id[None] * fixed_valid
            if noise is not None and bool((fixed_id == 1).any()):
                noise_r = noise.reshape(sample_num, K, -1)
                noise = noise_r[0:1].expand_as(noise_r).reshape(sample_num * K, -1)

        part_code = part_code.repeat_interleave(K, dim=0)
        valid_id = valid_id.repeat_interleave(K, dim=0)
        mean, logvar = self.get_params_from_part_code(part_code, valid_id, noise=noise)

        # Equal split of the points over the parts; an absent part's slot goes
        # to the first present part (``part_encoder.py:387-394``).
        first = torch.argmax(valid_id, dim=1)[:, None].to(part_code.dtype)
        ids = torch.arange(self.n_class, dtype=part_code.dtype, device=dev)[None] * valid_id
        ids = ids + first * (1 - valid_id)
        seg_mask = ids.int().repeat_interleave(sample_points // self.n_class, dim=1)
        lv = logvar + self.log_scale_var if logvar is not None else logvar
        mean_pp, logvar_pp, _ = self.gather_all(seg_mask, anchors=mean, variances=lv)
        # ``prepare_ctx`` adds log_scale_var again, as the JAX package does.
        ctx = self.prepare_ctx(part_code, mean, lv)
        return ctx, mean_pp, logvar_pp, seg_mask, valid_id, [part_code, mean, logvar, noise]

    # ----------------------------------------------------------------- losses
    def get_fit_loss(self, ref, mean, logvar, valid_id, mean_pp, logvar_pp, flag_pp, gt_shift,
                     gt_var, seg_mask, generator=None, eps=None):
        """The five fit-loss variants (``part_encoder.py:175-217``), each (B,).
        ref (B, N, 3); mean/logvar/gt (B, K, 3); *_pp (B, N, 3); flag_pp (B, N).
        Types 2 and 3 draw a sample: from ``generator``, or injected as ``eps``
        ((B, K, 3) for type 2, (B, N, 3) for type 3)."""
        if self.aligner is None:
            return torch.zeros(1, dtype=ref.dtype, device=ref.device)
        t = self.fit_loss_type
        if t == 0:
            ll = -gaussian_log_likelihood(ref, mean_pp, logvar_pp).mean(-1)
            return (ll * flag_pp).sum(-1) / flag_pp.sum(-1)
        if t == 1:
            err = (torch.cat([mean, torch.exp(logvar)], -1) - torch.cat([gt_shift, gt_var], -1)) ** 2
            return (err * valid_id[..., None]).sum(dim=(-1, -2)) / valid_id.sum(-1)
        if t == 2:
            samples = reparameterize_gaussian(mean, logvar, generator, eps)
            p_z = -gaussian_log_likelihood(samples, gt_shift, torch.log(gt_var), dim=3).mean(-1)
            ent = -gaussian_entropy(logvar, axis=-1)
            return ((p_z + ent) * valid_id).sum(-1) / valid_id.sum(-1)
        if t == 3:
            gt_mean_pp = gather_per_point(gt_shift, seg_mask)
            gt_var_pp = gather_per_point(gt_var, seg_mask)
            if eps is None:
                eps = randn(gt_var_pp.shape, generator, ref.device, ref.dtype)
            samples = eps * torch.sqrt(gt_var_pp) + gt_mean_pp
            ll = -gaussian_log_likelihood(samples, mean_pp, logvar_pp).mean(-1)
            return (ll * flag_pp).sum(-1) / flag_pp.sum(-1)
        if t == 4:
            err = (torch.cat([mean, logvar], -1)
                   - torch.cat([gt_shift, torch.log(gt_var)], -1)) ** 2
            return (err * valid_id[..., None]).sum(dim=(-1, -2)) / valid_id.sum(-1)
        raise NotImplementedError(t)

    def _kl_weight(self, epoch, device):
        # torch.full fills on the device; as_tensor of a Python number would
        # copy it from the host and wait for the card at every step
        f32 = torch.float32
        epoch = (epoch.to(device, f32) if isinstance(epoch, torch.Tensor)
                 else torch.full((), float(epoch), dtype=f32, device=device))
        kl = torch.full((), float(self.kl_weight), dtype=f32, device=device)
        if self.kl_weight_annealing:
            end = float(self.kl_weight_annealing_end_epoch)
            w = self.min_kl_weight + (self.kl_weight - self.min_kl_weight) * epoch / end
            return torch.where(epoch < end, w, kl)
        return kl

    def get_prior_loss(self, part_code, mean, logvar, valid_id, epoch=-1):
        """The flow prior loss over the parts, masked by ``valid_id``
        (``part_encoder.py:227-256``). part_code (B, K, zdim); mean and logvar
        are the part-code posterior statistics."""
        B, K, Dz = part_code.shape
        entropy = gaussian_entropy(logvar, axis=-1)  # (B, K)
        if self.use_flow:
            logpx0 = torch.zeros(B, K, 1, dtype=part_code.dtype, device=part_code.device)
            w, delta_log_pw = self.flow(part_code, logpx0, reverse=False)
            log_pw = gaussian_log_likelihood(w, 0.0, math.log(self.prior_var), dim=Dz).sum(-1)
            log_p_part = log_pw - delta_log_pw[..., 0]
        else:
            log_p_part = gaussian_log_likelihood(
                part_code, 0.0, math.log(self.prior_var), dim=Dz).sum(-1)
        loss_prior = ((-log_p_part - entropy) * valid_id).sum(1) / valid_id.sum(1)
        kl_w = self._kl_weight(epoch, part_code.device)
        out = {"prior_loss": kl_w * loss_prior.mean(), "kl_weight": kl_w}
        denom = torch.clamp(valid_id.sum(0), min=1.0)
        mlog_p = (log_p_part * valid_id).sum(0) / denom
        ment = (entropy * valid_id).sum(0) / denom
        for i in range(K):
            out[f"log_p_part_{i}"] = mlog_p[i]
            out[f"entropy_{i}"] = ment[i]
        return out

    def _batch_params(self, batch, ref):
        B = ref.shape[0]
        gt_shift = batch.get("part_shift")
        if gt_shift is None:
            gt_shift = torch.zeros(B, self.n_class, 3, dtype=ref.dtype, device=ref.device)
        gt_var = batch.get("part_scale")
        if gt_var is None:
            gt_var = torch.ones(B, self.n_class, 3, dtype=ref.dtype, device=ref.device)
        return gt_shift, gt_var if self.origin_scale else gt_var**2

    def _part_code(self, x, seg_flag, train, generator, part_code_eps):
        """(part_code, posterior means, posterior log-variances): a draw with
        ``gen``, else the means themselves."""
        pc_means, pc_logvars = self.get_part_code(x, seg_flag, train=train)
        part_code = pc_means
        if self.gen:
            part_code = reparameterize_gaussian(pc_means, pc_logvars, generator, part_code_eps)
        return part_code, pc_means, pc_logvars

    # ---------------------------------------------------------------- forward
    def forward(self, batch, noise=None, epoch=-1, train: bool = False, rngs=None):
        """The training and reconstruction forward (``part_encoder.py:259-329``).

        batch keys (channel-last): input (B, N, 3), present (B, K), ref
        (B, N, 3), ref_seg_mask (B, N), ref_attn_map (B, N, K), part_shift
        and part_scale (B, K, 3), noise (B, noise_dim) or (B, S, noise_dim)
        for S CIMLE hypotheses per shape; ``part_code_eps`` (B, K, zdim)
        injects the part-code draw of ``gen=True``. ``rngs`` holds the
        ``"sample"`` and ``"dropout"`` generators. Returns (ctx, mean_pp,
        logvar_pp + log_scale_var, flag_pp, loss_dict, [part_code, mean,
        logvar, noise]).
        """
        rngs = rngs or {}
        sample, drop = rngs.get("sample"), rngs.get("dropout")
        x, valid_id, ref = batch["input"], batch["present"], batch["ref"]
        seg_mask, seg_flag = batch["ref_seg_mask"].int(), batch["ref_attn_map"]
        B = ref.shape[0]
        gt_shift, gt_var = self._batch_params(batch, ref)
        if noise is None:
            noise = batch.get("noise")

        loss_dict = {}
        part_code, pc_means, pc_logvars = self._part_code(
            x, seg_flag, train, sample, batch.get("part_code_eps"))
        if self.gen:
            loss_dict.update(
                self.get_prior_loss(part_code, pc_means, pc_logvars, valid_id, epoch=epoch))
        if self.normalize_part_code:
            part_code = part_code / part_code.norm(dim=-1, keepdim=True)

        if noise is not None and noise.ndim == 3:
            num_sample = noise.shape[1]
            noise = noise.reshape(B * num_sample, -1)
            part_code, valid_id, seg_mask, ref, gt_shift, gt_var = (
                a.repeat_interleave(num_sample, dim=0)
                for a in (part_code, valid_id, seg_mask, ref, gt_shift, gt_var))

        mean, logvar = self.get_params_from_part_code(
            part_code, valid_id, gt_mean=gt_shift, gt_var=gt_var, noise=noise, train=train,
            generator=drop)
        mean_pp, logvar_pp, flag_pp = self.gather_all(
            seg_mask, anchors=mean, variances=logvar, valid_id=valid_id)
        fit_loss = self.get_fit_loss(ref, mean, logvar, valid_id, mean_pp, logvar_pp, flag_pp,
                                     gt_shift, gt_var, seg_mask, generator=sample)
        loss_dict["fit_loss"] = self.fit_loss_weight * fit_loss

        if self.use_gt_params_in_training:
            mean, logvar = gt_shift, torch.log(gt_var)
            mean_pp, logvar_pp, _ = self.gather_all(seg_mask, anchors=mean, variances=logvar)

        ctx = self.prepare_ctx(part_code, mean, logvar)
        return (ctx, mean_pp, logvar_pp + self.log_scale_var, flag_pp, loss_dict,
                [part_code, mean, logvar, noise])

    def sample_noise_candidates(self, batch, num: int, train: bool = False, generator=None,
                                noise=None):
        """CIMLE: ``num`` aligner noises per shape, scored by the fit loss
        (``part_encoder.py:400-430``). ``noise`` (B * num, noise_dim) injects
        the candidates. Returns (noise (B, num, D), fit (B, num))."""
        x, valid_id, ref = batch["input"], batch["present"], batch["ref"]
        seg_mask, seg_flag = batch["ref_seg_mask"].int(), batch["attn_map"]
        B = x.shape[0]
        gt_shift, gt_var = self._batch_params(batch, ref)
        part_code, _, _ = self._part_code(x, seg_flag, train, generator, batch.get("part_code_eps"))
        if noise is None:
            noise = randn((B * num, self.noise_dim), generator, x.device)
        part_code_r, valid_r, seg_r, ref_r, gts_r, gtv_r = (
            a.repeat_interleave(num, dim=0)
            for a in (part_code, valid_id, seg_mask, ref, gt_shift, gt_var))
        mean, logvar = self.get_params_from_part_code(part_code_r, valid_r, noise=noise)
        mean_pp, logvar_pp, flag_pp = self.gather_all(
            seg_r, anchors=mean, variances=logvar, valid_id=valid_r)
        fit = self.get_fit_loss(ref_r, mean, logvar, valid_r, mean_pp, logvar_pp, flag_pp, gts_r,
                                gtv_r, seg_r, generator=generator)
        return noise.reshape(B, num, -1), fit.reshape(B, num)
