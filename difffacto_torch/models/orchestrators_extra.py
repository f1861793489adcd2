"""The vanilla point-diffusion model ``PDM`` and the anchored generators.

Port of ``PDM`` in ``difffacto_tpu/models/orchestrators_extra.py`` (the
reference's point_diff.py): a whole-shape encoder (``PointNet2SSG``,
``PointNet2MSG`` or ``PointNet``) reads the cloud with its part maps and
gives one code, flattened to a single global vector; a vanilla chain
(``models/diffusion_extra.py``) with a pointwise or transformer denoiser
trains on the cloud from zero anchors with that code as its one context
token, and ``predict`` runs the reverse chain from zero anchors.

``AnchoredGeneration`` (``orchestrators_extra.py:127-350``, the reference's
anchor_gen_uncond.py) and ``AnchorDiffGenPartglot`` (``:353-514``,
anchor_gen_supseg_partglot.py): a decomposer turns part latents into a
global code, the anchors and mixed latents; an anchored chain with a fixed
variance (``learn_variance`` forced off, as in the JAX modules) decodes the
points around their anchors, the point's part latent concatenated onto x_t
and the global code the denoiser's one context token. As flax infers the
denoiser's widths, the port gives the net ``in_channels`` (the chain's model
input, 3 wide or 6 or 9 with its anchors and variance, plus C) and
``context_dim`` C (C the encoder's ``part_latent_dim``) where its config does
not.

Every draw comes from an explicit ``torch.Generator`` or is injected: in
``loss`` the batch's ``diffusion_t``, ``diffusion_noise`` and
``encoder_keep`` (the encoder head's dropout keep mask), ``latent_eps`` (the
posterior draw of ``AnchoredGeneration``), ``part_keep`` and
``global_keep`` (its guidance keep masks); in ``predict`` ``z`` (the latents
of ``AnchoredGeneration``), ``noise`` (x_T, or the forward chain's draw) and
``step_noise``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..utils.device import randn, resolve_device
from ..utils.gaussian import gaussian_entropy, reparameterize_gaussian, standard_normal_logprob
from ..utils.registry import DECOMPOSERS, ENCODERS, MODELS, NETS, SAMPLERS, build_from_cfg
from . import decomposers, diffusion_extra, pointnet2, supseg_encoders  # noqa: F401  (registers)
from .anchor_diff import build_diffusion, ensure_attn_maps
from .part_encoder import gather_per_point


@MODELS.register_module()
class PDM(nn.Module):
    """The vanilla point DPM (``orchestrators_extra.py:37-124``). Constructor
    arguments are the JAX module's fields; ``seed`` fixes the initial weights."""

    def __init__(self, encoder: dict, diffusion: dict, sampler: dict, num_timesteps: int,
                 npoints: int = 2048, include_attn_weight_in_encoder: bool = True,
                 ret_traj: bool = False, ret_interval: int = 20, *, dtype=None, device="cuda",
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        self.num_timesteps, self.npoints = num_timesteps, npoints
        self.include_attn_weight_in_encoder = include_attn_weight_in_encoder
        self.ret_traj, self.ret_interval = ret_traj, ret_interval
        kw = dict(dtype=dtype, device=device, generator=g)
        self.encoder_mod = build_from_cfg(dict(encoder), ENCODERS, **kw)
        self.net = build_from_cfg(dict(diffusion["net"]), NETS, **kw)
        self.diff = build_diffusion(diffusion, num_timesteps)
        self.t_sampler = build_from_cfg(dict(sampler), SAMPLERS, num_timesteps=num_timesteps)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def encode(self, batch, train: bool = False, generator=None):
        """The whole shape's code flattened to one vector, (B, F)
        (``orchestrators_extra.py:59-70``): the per-anchor structure is
        collapsed, as the reference does."""
        x = batch["input"]
        if self.include_attn_weight_in_encoder:
            x = torch.cat([x, batch["attn_map"].to(x.dtype)], dim=-1)
        code = self.encoder_mod(x, train=train, generator=generator,
                                keep=batch.get("encoder_keep"))
        if isinstance(code, tuple):
            code = code[0]
        return code.reshape(code.shape[0], -1)

    def denoise(self, x, t, ctx, anchors, variances, seg_mask, valid_id, train: bool = False,
                generator=None):
        return self.net(x, t, ctx, anchors, variances, seg_mask, valid_id, train=train,
                        generator=generator)

    def loss(self, batch, epoch=0, train: bool = True, rngs=None) -> Dict[str, torch.Tensor]:
        """The training forward (``orchestrators_extra.py:77-101``): the vanilla
        chain on the cloud from zero anchors, the code as its one ctx token.
        ``rngs`` holds the "sample" and "dropout" generators."""
        rngs = rngs or {}
        batch = ensure_attn_maps(batch)
        ref = batch["ref"]
        code = self.encode(batch, train=train, generator=rngs.get("dropout"))
        t = batch.get("diffusion_t")
        if t is None:
            t, _ = self.t_sampler.sample(rngs.get("sample"), ref.shape[0], device=ref.device)

        def model_fn(inp, ts, c, anc, var, seg, vid):
            return self.denoise(inp, ts, c, anc, var, seg, vid, train=train,
                                generator=rngs.get("dropout"))

        return self.diff.training_losses(
            model_fn, ref, t.long(), anchors=torch.zeros_like(ref), ctx=code[:, None, :],
            seg_mask=batch["ref_seg_mask"].int(), noise=batch.get("diffusion_noise"),
            generator=rngs.get("sample"))

    def prepare_decode(self, batch, train: bool = False):
        """(code, zero anchors (B, npoints, 3), seg_mask) (``:103-108``)."""
        batch = ensure_attn_maps(batch)
        code = self.encode(batch, train=train)
        anchors = torch.zeros(code.shape[0], self.npoints, 3, device=code.device)
        return code, anchors, batch["ref_seg_mask"].int()

    @torch.inference_mode()
    def predict(self, batch, generator: Optional[torch.Generator] = None, noise=None,
                step_noise=None) -> Dict[str, torch.Tensor]:
        """The reverse chain from zero anchors conditioned on the encoded
        cloud (``orchestrators_extra.py:110-124``); ``noise`` (B, npoints, 3)
        and ``step_noise`` (T, B, npoints, 3) inject the draws."""
        code, anchors, seg_mask = self.prepare_decode(batch)

        def model_fn(inp, ts, c, anc, var, seg, vid):
            return self.denoise(inp, ts, code[:, None, :], anc, var, seg, vid)

        out = self.diff.p_sample_loop(model_fn, anchors, ret_traj=self.ret_traj,
                                      ret_interval=self.ret_interval, noise=noise,
                                      step_noise=step_noise, generator=generator)
        out.update(input=batch["input"], input_ref=batch["ref"], seg_mask=seg_mask,
                   seg_mask_ref=seg_mask)
        return out


def _uniform(shape, generator, device) -> torch.Tensor:
    if generator is None:
        raise ValueError("this draw needs a torch.Generator (or pass the tensor to inject)")
    return torch.rand(shape, generator=generator, device=device)


class _AnchoredBase(nn.Module):
    """What the two anchored generators share: the decomposer, the denoiser
    with its inferred widths, the fixed-variance chain, the sampler, and the
    denoiser call on [x_t | the point's latent] with the global code as its
    one context token."""

    def _build_chain(self, encoder, decomposer, diffusion, sampler, num_anchors, num_timesteps,
                     npoints, ret_traj, ret_interval, forward_sample, save_pred_xstart, kw,
                     fixed_variance: bool = True):
        self.encoder, self.num_anchors, self.num_timesteps = dict(encoder), num_anchors, num_timesteps
        self.npoints, self.ret_traj, self.ret_interval = npoints, ret_traj, ret_interval
        self.forward_sample, self.save_pred_xstart = forward_sample, save_pred_xstart
        self.decomposer_mod = build_from_cfg(dict(decomposer), DECOMPOSERS,
                                             num_anchors=num_anchors, point_dim=3, **kw)
        dcfg = dict(diffusion)
        if fixed_variance:
            dcfg["learn_variance"] = False  # forced in the reference constructor
        net = dict(dcfg.pop("net"))
        self.diff = build_diffusion(dcfg, num_timesteps)
        # the chain's model input (x_t, its anchors, its variance) and the latent
        C = int(encoder["part_latent_dim"])
        net.setdefault("in_channels", 3 * (1 + self.diff.include_anchors + self.diff.include_cov)
                       + C)
        net.setdefault("context_dim", C)
        self.net = build_from_cfg(net, NETS, **kw)
        self.t_sampler = build_from_cfg(dict(sampler), SAMPLERS, num_timesteps=num_timesteps)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @property
    def points_per_anchor(self) -> int:
        return self.npoints // self.num_anchors

    def _model_fn(self, pointwise_latent, code, train: bool = False, generator=None):
        ctx_tok = code[:, None, :]

        def fn(inp, ts, c, anc, var, seg, vid):
            h = torch.cat([inp, pointwise_latent.to(inp.dtype)], dim=-1)
            return self.net(h, ts, ctx_tok, anc, var, seg, vid, train=train, generator=generator)

        return fn

    def _expand(self, anchors, latents):
        """Each anchor and latent on its part's equal share of the points, and
        the seg mask of that split."""
        pp, B = self.points_per_anchor, anchors.shape[0]
        seg = torch.arange(self.num_anchors, dtype=torch.int32, device=anchors.device)
        seg = seg.repeat_interleave(pp)[None].expand(B, self.npoints)
        return anchors.repeat_interleave(pp, dim=1), latents.repeat_interleave(pp, dim=1), seg

    def _decode(self, anchor_pp, code, latent_pp, generator=None, noise=None, step_noise=None):
        return self.diff.p_sample_loop(self._model_fn(latent_pp, code), anchor_pp,
                                       ret_traj=self.ret_traj, ret_interval=self.ret_interval,
                                       noise=noise, step_noise=step_noise, generator=generator)


@MODELS.register_module()
class AnchoredGeneration(_AnchoredBase):
    """Unconditional anchored generation (``orchestrators_extra.py:127-350``):
    the encoder and ``MeanVarianceRegressor`` give a per-part posterior, z
    is drawn from it with a prior loss, the decomposer gives (global code,
    anchors, part latents), guidance drops latents, and the chain trains on
    the cloud around the per-point anchors. The prior loss's entropy is over
    the latent axis, the evident intent the JAX module keeps of a reference
    defect (``:137-142``). ``loss`` (the constructor argument) is kept as
    ``anchor_loss_cfg`` and read nowhere: the anchor loss is the squared
    error, as in the JAX module, where flax freezes the dict into a
    ``FrozenDict`` that its ``isinstance(self.loss, dict)`` test
    (``orchestrators_extra.py``'s setup) never passes, so no ``METRICS``
    loss is built. ``seed`` fixes the initial weights."""

    def __init__(self, encoder: dict, decomposer: dict, parameter_regressor: dict,
                 diffusion: dict, sampler: dict, num_anchors: int, num_timesteps: int,
                 npoints: int = 2048, anchor_loss_weight: float = 1.0, loss: Optional[dict] = None,
                 include_attn_weight_in_encoder: bool = True, guidance: bool = False,
                 part_latent_dropout_prob: float = 0.2, global_latent_dropout_prob: float = 0.2,
                 kl_weight: float = 1e-3, ret_traj: bool = False, ret_interval: int = 20,
                 forward_sample: bool = False, fix_part: bool = False,
                 save_pred_xstart: bool = False, *, dtype=None, device="cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        kw = dict(dtype=dtype, device=device, generator=torch.Generator().manual_seed(seed))
        self.anchor_loss_weight, self.kl_weight = anchor_loss_weight, kl_weight
        self.include_attn_weight_in_encoder, self.guidance = include_attn_weight_in_encoder, guidance
        self.part_latent_dropout_prob = part_latent_dropout_prob
        self.global_latent_dropout_prob = global_latent_dropout_prob
        self.fix_part = fix_part
        self.encoder_mod = build_from_cfg(dict(encoder), ENCODERS, num_anchors=num_anchors, **kw)
        self.param_regressor_mod = build_from_cfg(dict(parameter_regressor), ENCODERS,
                                                  num_class=num_anchors, **kw)
        self._build_chain(encoder, decomposer, diffusion, sampler, num_anchors, num_timesteps,
                          npoints, ret_traj, ret_interval, forward_sample, save_pred_xstart, kw)
        self.anchor_loss_cfg = dict(loss) if isinstance(loss, dict) else None

    def encode_posterior(self, batch, train: bool = False):
        """The encoder and the regressor: per-part (means, logvars) (B, K, C)."""
        x = batch["input"]
        if self.include_attn_weight_in_encoder:
            x = torch.cat([x, batch["attn_map"].to(x.dtype)], dim=-1)
        return self.param_regressor_mod(self.encoder_mod(x, train=train), train=train)

    def decompose(self, z, train: bool = False):
        """(B, K, C) -> (global code, anchors (B, K, 3), mixed latents)."""
        return self.decomposer_mod(z, train=train)

    def loss(self, batch, epoch=0, train: bool = True, rngs=None) -> Dict[str, torch.Tensor]:
        """The training losses (``orchestrators_extra.py:227-276``): the
        chain's, ``prior_loss`` and ``anchor_loss``. ``rngs`` holds the
        "sample" and "dropout" generators; the batch may inject
        ``latent_eps`` (B, K, C), ``part_keep`` (B, K), ``global_keep`` (B,),
        ``diffusion_t`` and ``diffusion_noise``."""
        rngs = rngs or {}
        sample = rngs.get("sample")
        batch = ensure_attn_maps(batch)
        ref = batch["ref"]
        seg_mask = batch["seg_mask"].int()
        B, dev = ref.shape[0], ref.device
        means, logvars = self.encode_posterior(batch, train)
        z = reparameterize_gaussian(means, logvars, sample, batch.get("latent_eps"))
        log_pz = standard_normal_logprob(z).sum(-1)
        entropy = gaussian_entropy(logvars, axis=-1)
        prior_loss = self.kl_weight * (-log_pz - entropy).mean()

        global_feature, anchors, part_latent = self.decompose(z, train)
        if self.guidance:
            keep = batch.get("part_keep")
            if keep is None:
                keep = _uniform(part_latent.shape[:-1], sample, dev) >= self.part_latent_dropout_prob
            part_latent = part_latent * keep[..., None].to(part_latent.dtype)
            gkeep = batch.get("global_keep")
            if gkeep is None:
                gkeep = _uniform((B,), sample, dev) >= self.global_latent_dropout_prob
            global_feature = global_feature * gkeep[:, None].to(global_feature.dtype)

        t = batch.get("diffusion_t")
        if t is None:
            t, _ = self.t_sampler.sample(sample, B, device=dev)
        latent_pp = gather_per_point(part_latent, seg_mask)
        anchor_pp = gather_per_point(anchors, seg_mask)
        base_anchor = ((anchor_pp - ref) ** 2).sum(-1).mean()
        out = dict(self.diff.training_losses(
            self._model_fn(latent_pp, global_feature, train, rngs.get("dropout")), ref, t.long(),
            anchors=anchor_pp, noise=batch.get("diffusion_noise"), generator=sample))
        out["prior_loss"] = prior_loss
        out["anchor_loss"] = self.anchor_loss_weight * base_anchor
        return out

    def sample_latents(self, sample_num: int, fix_part: bool = False, anchor_id: int = 0,
                       generator=None, z=None):
        """z ~ N(0, 1) (sample_num, K, C) -> (global code, anchors, per-point
        anchors, per-point latents, seg mask) (``:278-304``); with
        ``fix_part`` one z shared by the batch but for slot ``anchor_id``.
        ``z`` injects the latents."""
        C, K = int(self.encoder["part_latent_dim"]), self.num_anchors
        if z is None:
            if fix_part or self.fix_part:
                z = randn((1, K, C), generator, self.device).repeat(sample_num, 1, 1)
                z[:, anchor_id] = randn((sample_num, C), generator, self.device)
            else:
                z = randn((sample_num, K, C), generator, self.device)
        global_feature, anchors, part_latent = self.decompose(z, train=False)
        anchor_pp, latent_pp, seg_mask = self._expand(anchors, part_latent)
        return global_feature, anchors, anchor_pp, latent_pp, seg_mask

    @torch.inference_mode()
    def predict(self, batch, generator: Optional[torch.Generator] = None, z=None, noise=None,
                step_noise=None) -> Dict[str, torch.Tensor]:
        """Sampled latents decoded (``:306-331``), or with ``forward_sample``
        the forward chain of the batch's clouds around the sampled anchors.
        ``z``, ``noise`` (x_T, or the forward chain's draw) and
        ``step_noise`` inject the draws."""
        ref = batch["ref"]
        g, anchors, anchor_pp, latent_pp, seg_mask = self.sample_latents(
            ref.shape[0], generator=generator, z=z)
        if self.forward_sample:
            out = {"pred": ref, "traj": self.diff.q_sample_loop(ref, anchor_pp, noise=noise,
                                                                generator=generator)}
        else:
            out = self._decode(anchor_pp, g, latent_pp, generator, noise, step_noise)
        out.update(anchors=anchors, assigned_anchor=anchor_pp, seg_mask=seg_mask,
                   input=batch["input"], input_ref=ref)
        return out


@MODELS.register_module()
class AnchorDiffGenPartglot(_AnchoredBase):
    """The decomposer-based generator over PartGlot super-segments
    (``orchestrators_extra.py:353-514``): the super-segment encoder gives part
    latents, the decomposer the anchors and a global code, and the chain
    models each super-segment's points around its anchor, masked by the
    segment-validity ``geo_mask``. ``interpolate_latent`` and
    ``combine_latent`` take the batch dict, as the JAX module resolves the
    reference's undefined ``x`` (``:337-339``). ``seed`` fixes the initial
    weights."""

    def __init__(self, encoder: dict, decomposer: dict, diffusion: dict, sampler: dict,
                 num_anchors: int, num_timesteps: int, npoints: int = 2048,
                 anchor_loss_weight: float = 1.0, ret_traj: bool = False, ret_interval: int = 20,
                 forward_sample: bool = False, save_pred_xstart: bool = False,
                 *, dtype=None, device="cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        kw = dict(dtype=dtype, device=device, generator=torch.Generator().manual_seed(seed))
        self.anchor_loss_weight = anchor_loss_weight
        self.encoder_mod = build_from_cfg(dict(encoder), ENCODERS, num_anchors=num_anchors, **kw)
        self._build_chain(encoder, decomposer, diffusion, sampler, num_anchors, num_timesteps,
                          npoints, ret_traj, ret_interval, forward_sample, save_pred_xstart, kw)

    def encode_decompose(self, x, geo_mask, train: bool = False):
        """(B, n_seg, npoint, 3), (B, n_seg) -> (global code, anchors, latents)."""
        return self.decomposer_mod(self.encoder_mod(x, geo_mask, train=train), train=train)

    def loss(self, batch, epoch=0, train: bool = True, rngs=None) -> Dict[str, torch.Tensor]:
        """``anchor_loss`` and ``diffusion_loss`` over the valid segments
        (``orchestrators_extra.py:421-468``). batch: input and ref (B, n_seg,
        npoint, 3), seg_mask (B, n_seg) the segments' anchors, geo_mask
        (B, n_seg); ``diffusion_t`` (B n_seg,) and ``diffusion_noise``
        (B n_seg, npoint, 3) inject the chain's draws, else ``rngs["sample"]``."""
        rngs = rngs or {}
        sample = rngs.get("sample")
        x, ref = batch["input"], batch["ref"]
        seg_mask = batch["seg_mask"].long()
        geo_mask = batch["geo_mask"].float()
        B, n_seg, npoint = ref.shape[:3]
        num_active = torch.clamp(geo_mask.sum(1), min=1.0)
        global_feature, anchors, part_latent = self.encode_decompose(x, geo_mask, train)
        C = part_latent.shape[-1]
        anchor_seg = torch.gather(anchors, 1, seg_mask[..., None].expand(-1, -1, 3))
        latent_seg = torch.gather(part_latent, 1, seg_mask[..., None].expand(-1, -1, C))
        anchor_pp = anchor_seg[:, :, None].expand(B, n_seg, npoint, 3)
        anchor_sq = ((anchor_pp - ref) ** 2).mean((-1, -2))
        anchor_loss = ((anchor_sq * geo_mask).sum(1) / num_active).mean()

        t = batch.get("diffusion_t")
        if t is None:
            t, _ = self.t_sampler.sample(sample, B * n_seg, device=ref.device)
        latent_pp = latent_seg[:, :, None].expand(B, n_seg, npoint, C).reshape(B * n_seg, npoint, C)
        code = global_feature.repeat_interleave(n_seg, dim=0)
        losses = self.diff.training_losses(
            self._model_fn(latent_pp, code, train, rngs.get("dropout")),
            ref.reshape(B * n_seg, npoint, 3), t.long(),
            anchors=anchor_pp.reshape(B * n_seg, npoint, 3), noise=batch.get("diffusion_noise"),
            reduce=False, generator=sample)
        mse = losses["mse_loss"].mean((-1, -2)).reshape(B, n_seg)
        return {"anchor_loss": self.anchor_loss_weight * anchor_loss,
                "diffusion_loss": ((mse * geo_mask).sum(1) / num_active).mean()}

    def _decoded(self, global_feature, anchors, latents, generator, noise, step_noise):
        anchor_pp, latent_pp, seg_mask = self._expand(anchors, latents)
        out = self._decode(anchor_pp, global_feature, latent_pp, generator, noise, step_noise)
        out.update(anchors=anchors, seg_mask=seg_mask)
        return out

    @torch.inference_mode()
    def predict(self, batch, generator: Optional[torch.Generator] = None, noise=None,
                step_noise=None) -> Dict[str, torch.Tensor]:
        """The decomposed latents decoded on an equal split of the points
        (``:481-494``), or with ``forward_sample`` the forward chain of the
        first ``npoints`` reference points around the anchors."""
        x, geo_mask = batch["input"], batch["geo_mask"].float()
        g, anchors, part_latent = self.encode_decompose(x, geo_mask, train=False)
        if not self.forward_sample:
            return self._decoded(g, anchors, part_latent, generator, noise, step_noise)
        anchor_pp, _, seg_mask = self._expand(anchors, part_latent)
        ref = batch["ref"].reshape(x.shape[0], -1, 3)[:, : self.npoints]
        return {"pred": ref, "traj": self.diff.q_sample_loop(ref, anchor_pp, noise=noise,
                                                             generator=generator),
                "anchors": anchors, "seg_mask": seg_mask}

    @torch.inference_mode()
    def interpolate_latent(self, batch, id1: int, id2: int, anchor_id: int, steps: int = 10,
                           generator: Optional[torch.Generator] = None, noise=None,
                           step_noise=None) -> Dict[str, torch.Tensor]:
        """Slot ``anchor_id``'s latent moved from shape id1's to id2's in
        ``steps`` equal steps, the others id1's (``:496-500``)."""
        idx = torch.tensor([id1, id2], device=batch["input"].device)
        lat = self.encoder_mod(batch["input"][idx], batch["geo_mask"].float()[idx], train=False)
        w = torch.linspace(0.0, 1.0, steps, device=lat.device)
        dx = torch.zeros(steps, self.num_anchors, 1, device=lat.device)
        dx[:, anchor_id, 0] = w
        latents = lat[0][None] + (lat[1] - lat[0])[None] * dx
        g, anchors, mixed = self.decomposer_mod(latents, train=False)
        return self._decoded(g, anchors, mixed, generator, noise, step_noise)

    @torch.inference_mode()
    def combine_latent(self, batch, ids, generator: Optional[torch.Generator] = None, noise=None,
                       step_noise=None) -> Dict[str, torch.Tensor]:
        """Part i's latent from shape ids[i], one shape (``:502-514``)."""
        idx = torch.as_tensor(list(ids), device=batch["input"].device)
        lat = self.encoder_mod(batch["input"][idx], batch["geo_mask"].float()[idx], train=False)
        latents = torch.stack([lat[i, i] for i in range(self.num_anchors)])[None]
        g, anchors, mixed = self.decomposer_mod(latents, train=False)
        return self._decoded(g, anchors, mixed, generator, noise, step_noise)
