"""The part encoder's variants and the MLP CIMLE aligner.

Port of ``difffacto_tpu/models/part_encoder_variants.py`` (the reference's
part_encoders.py:167-254, 1258-2142):

* ``PartAlignerCIMLE``: the MLP aligner with a noise encoder in front
  (``noise_encoder_type`` 0; zero noise where none, or one of another width,
  is given);
* ``PartEncodercVAE`` and ``PartEncodercVAE2``: in training the aligner's
  noise is a draw from a conditional posterior over the part codes and the
  reference cloud's code; its prior loss is computed and kept out of the
  loss, as the JAX module only ``sow``s it (``:130``): ``cvae_prior_loss``
  holds the last one;
* ``PartEncoderVAE``, ``PartEncoderForPartnetAndTransformerDecoder`` and
  ``PartEncoderForTransformerDecoderCIMLE``: the transformer-decoder ctx
  (``_td_prepare_ctx``);
* ``PartEncoderWithKLLoss``: the KL to N(0, ``prior_var``) as the prior loss;
  ``PartEncoderForTransformerDecoderKLLoss`` (and its ``CIMLE`` alias) adds
  the ctx without the ``log_scale_var`` offset, the std in place of the
  variance under ``include_std``;
* ``PartEncoderForPartnet`` (the part maps under ``attn_map``),
  ``PartEncoderCIMLE`` and ``PartEncoderNoMixer``: the base encoder;
* ``EncoderWithKLLoss``: one global latent for the whole shape with a
  ``PerPartFlow(n_class=1)`` prior, on every part slot.

Every draw comes from an explicit generator or is injected: the cVAE's
posterior draw by ``batch["cvae_eps"]`` (B, noise_dim), ``EncoderWithKLLoss``'s
global latent by ``batch["part_code_eps"]`` (B, zdim).
"""

from __future__ import annotations

import inspect
import math

import torch

from ..nn.layers import MLP, Dense, TorchBatchNorm, default_generator
from ..utils.device import randn, resolve_device
from ..utils.gaussian import gaussian_entropy, gaussian_log_likelihood, reparameterize_gaussian
from ..utils.registry import ENCODERS
from .aligner import MLPAlignerBase
from .flow import PerPartFlow
from .part_encoder import PartEncoder, PartEncoderForTransformerDecoder, _cat_promoted


def _with_fields(**fields):
    """Class decorator for a variant whose JAX class adds fields: its
    constructor advertises ``PartEncoder``'s parameters and ``fields`` (with
    their defaults), so ``build_from_cfg`` passes every key of a config that
    either names and nothing else."""
    def wrap(cls):
        base = inspect.signature(PartEncoder.__init__)
        params = list(base.parameters.values())
        own = [p for p in params if p.kind is not p.KEYWORD_ONLY]
        own += [inspect.Parameter(k, inspect.Parameter.POSITIONAL_OR_KEYWORD, default=v)
                for k, v in fields.items()]
        own += [p for p in params if p.kind is p.KEYWORD_ONLY]
        cls.__init__.__signature__ = base.replace(parameters=own)
        return cls
    return wrap


@ENCODERS.register_module()
class PartAlignerCIMLE(MLPAlignerBase):
    """part_code (B, K, width), valid_id (B, K), noise (B, noise_dim) ->
    mean, logvar each (B, K, 3) (``part_encoder_variants.py:36-82``). With
    ``noise_encoder_type`` 0 the noise is re-encoded from [codes | noise] by
    ``ne_fc1`` 512, ``ne_fc2`` 128 (BatchNorm and ReLU after each) and
    ``ne_fc3``; the branches read [codes | noise]."""

    def __init__(self, width: int, n_class: int, param_dim: int = 3, noise_dim: int = 32,
                 noise_encoder_type: int = 0, cimle: bool = True, cimle_start_epoch: int = 0,
                 *, dtype=None, device="cuda", generator=None):
        super().__init__()
        if param_dim != 3:
            raise ValueError("param_dim must be 3: the JAX module reads each branch as "
                             "(B, 3, n_class) (part_encoder_variants.py:80-81)")
        device = resolve_device(device)
        g = default_generator(generator)
        self.noise_dim, self.noise_encoder_type = noise_dim, noise_encoder_type
        self.cimle, self.cimle_start_epoch = cimle, cimle_start_epoch
        kw = dict(dtype=dtype, device=device)
        width_in = n_class * width + noise_dim
        if noise_encoder_type == 0:
            self.ne_fc1 = Dense(width_in, 512, generator=g, **kw)
            self.ne_bn1 = TorchBatchNorm(512, **kw)
            self.ne_fc2 = Dense(512, 128, generator=g, **kw)
            self.ne_bn2 = TorchBatchNorm(128, **kw)
            self.ne_fc3 = Dense(128, noise_dim, generator=g, **kw)
        self._build_branches(width_in, n_class, g, **kw)

    def forward(self, part_code, valid_id=None, noise=None, train: bool = False, generator=None):
        B = part_code.shape[0]
        if noise is None or noise.shape[-1] != self.noise_dim:
            noise = torch.zeros(B, self.noise_dim, dtype=part_code.dtype, device=part_code.device)
        x = (part_code * valid_id[..., None].to(part_code.dtype)).reshape(B, -1)
        noise = noise.to(x.dtype)
        if self.noise_encoder_type == 0:
            h = torch.relu(self.ne_bn1(self.ne_fc1(torch.cat([x, noise], dim=-1)), train))
            h = torch.relu(self.ne_bn2(self.ne_fc2(h), train))
            noise = self.ne_fc3(h)
        return self._branches(torch.cat([x, noise.to(x.dtype)], dim=-1), train)


def _td_prepare_ctx(enc, part_code, mean, logvar, *, scale_var=True, std=False):
    """The transformer-decoder ctx, [part_code | mean, var] a part token
    (``part_encoder_variants.py:85-97``): ``scale_var`` adds log_scale_var
    to the logvar, ``std`` gives exp(logvar / 2) in place of exp(logvar);
    detached under the encoder's ``detach_params_in_ctx``."""
    ctx = [part_code] if enc.include_part_code else []
    if enc.include_params:
        lv = logvar + enc.log_scale_var if scale_var else logvar
        var = torch.exp(0.5 * lv) if std else torch.exp(lv)
        params = torch.cat([mean, var], dim=-1)
        ctx.append(params.detach() if enc.detach_params_in_ctx else params)
    return _cat_promoted(ctx)


@ENCODERS.register_module()
@_with_fields(cvae_kl_weight=0.1)
class PartEncodercVAE(PartEncoderForTransformerDecoder):
    """The aligner's noise from a conditional VAE posterior in training
    (``part_encoder_variants.py:100-131``): ``cvae_encoder`` (an MLP zdim ->
    zdim -> 2 noise_dim) reads [the flattened part codes | ``ref_encoder``'s
    code of the reference cloud]. Like the JAX module it reads
    ``ref_encoder``, which exists only under ``encode_ref``; so does
    ``cvae_encoder`` here. ``cvae_kl_weight`` is kept and read nowhere, as
    in the JAX module. Outside training, or without a reference cloud, the
    given noise goes to the aligner."""

    def __init__(self, encoder: dict, cvae_kl_weight: float = 0.1, **kw):
        super().__init__(encoder, **kw)
        self.cvae_kl_weight = cvae_kl_weight
        self.cvae_prior_loss = None
        self._cvae_draw = (None, None)
        if self.encode_ref:
            p = next(self.parameters())
            self.cvae_encoder = MLP((self.n_class + 1) * self.zdim,
                                    (self.zdim, self.zdim, 2 * self.noise_dim),
                                    dtype=kw.get("dtype"), device=p.device,
                                    generator=default_generator(kw.get("generator")))

    def forward(self, batch, noise=None, epoch=-1, train: bool = False, rngs=None):
        """The base forward; the posterior draw comes from ``rngs["sample"]``
        or is injected as ``batch["cvae_eps"]`` (B, noise_dim)."""
        self._cvae_draw = ((rngs or {}).get("sample"), batch.get("cvae_eps"))
        try:
            return super().forward(batch, noise=noise, epoch=epoch, train=train, rngs=rngs)
        finally:
            self._cvae_draw = (None, None)

    def get_params_from_part_code(self, part_code, valid_id, gt_mean=None, gt_var=None,
                                  ref=None, noise=None, train: bool = False, generator=None):
        B = part_code.shape[0]
        if train and ref is not None:
            if not self.encode_ref:
                raise AttributeError(
                    "PartEncodercVAE trains on ref_encoder, which only encode_ref=True builds "
                    "(difffacto_tpu/models/part_encoder_variants.py:124, part_encoder.py:84)")
            g = self.ref_encoder(ref, train=train).reshape(B, -1)
            cond = torch.cat([part_code.reshape(B, -1), g.to(part_code.dtype)], dim=-1)
            nm, nl = self.cvae_encoder(cond).chunk(2, dim=-1)
            sample, eps = self._cvae_draw
            noise = reparameterize_gaussian(nm, nl, sample, eps)
            entropy = gaussian_entropy(nl, axis=-1)
            log_p = gaussian_log_likelihood(noise, 0.0, 0.0, dim=self.noise_dim).sum(-1)
            self.cvae_prior_loss = (-log_p - entropy).mean()
        return self.aligner(part_code, valid_id, noise=noise, train=train, generator=generator)


@ENCODERS.register_module()
class PartEncoderVAE(PartEncoderForTransformerDecoder):
    """The transformer-decoder ctx of ``_td_prepare_ctx`` (``:134-140``)."""

    def prepare_ctx(self, part_code, mean, logvar, seg_mask=None):
        return _td_prepare_ctx(self, part_code, mean, logvar)


@ENCODERS.register_module()
class PartEncodercVAE2(PartEncodercVAE):
    pass


@ENCODERS.register_module()
class PartEncoderWithKLLoss(PartEncoderForTransformerDecoder):
    """The prior loss is KL(N(mean, exp(logvar)) || N(0, prior_var)) a part,
    masked by presence (``part_encoder_variants.py:148-162``)."""

    def get_prior_loss(self, part_code, mean, logvar, valid_id, epoch=-1):
        pv = self.prior_var
        kl = 0.5 * ((torch.exp(logvar) + mean**2) / pv - 1.0 - logvar + math.log(pv)).sum(-1)
        loss = (kl * valid_id).sum(1) / valid_id.sum(1)
        kl_w = self._kl_weight(epoch, part_code.device)
        return {"prior_loss": kl_w * loss.mean(), "kl_weight": kl_w}


@ENCODERS.register_module()
class PartEncoderForPartnet(PartEncoder):
    """The PartNet layout: the part maps under ``attn_map`` (``:165-173``)."""

    def forward(self, batch, noise=None, epoch=-1, train: bool = False, rngs=None):
        batch = dict(batch)
        batch["ref_attn_map"] = batch.get("attn_map", batch.get("ref_attn_map"))
        return super().forward(batch, noise=noise, epoch=epoch, train=train, rngs=rngs)


@ENCODERS.register_module()
class PartEncoderCIMLE(PartEncoder):
    """The base encoder under the reference's CIMLE name (``:176-183``)."""


@ENCODERS.register_module()
class PartEncoderNoMixer(PartEncoder):
    """The base encoder under the reference's name (``:186-193``)."""


@ENCODERS.register_module()
class PartEncoderForPartnetAndTransformerDecoder(PartEncoderForPartnet):
    """The PartNet layout with the transformer-decoder ctx (``:196-202``)."""

    def prepare_ctx(self, part_code, mean, logvar, seg_mask=None):
        return _td_prepare_ctx(self, part_code, mean, logvar)


@ENCODERS.register_module()
class PartEncoderForTransformerDecoderCIMLE(PartEncoderCIMLE):
    """The base encoder with the transformer-decoder ctx (``:205-215``)."""

    def prepare_ctx(self, part_code, mean, logvar, seg_mask=None):
        return _td_prepare_ctx(self, part_code, mean, logvar)


@ENCODERS.register_module()
@_with_fields(include_std=False)
class PartEncoderForTransformerDecoderKLLoss(PartEncoderWithKLLoss):
    """The KL prior with the ctx [part_code | mean, exp(logvar)], or
    [part_code | mean, exp(logvar / 2)] under ``include_std``: no
    log_scale_var offset (``:218-230``)."""

    def __init__(self, encoder: dict, include_std: bool = False, **kw):
        super().__init__(encoder, **kw)
        self.include_std = include_std

    def prepare_ctx(self, part_code, mean, logvar, seg_mask=None):
        return _td_prepare_ctx(self, part_code, mean, logvar, scale_var=False,
                               std=self.include_std)


@ENCODERS.register_module()
class PartEncoderForTransformerDecoderKLLossCIMLE(PartEncoderForTransformerDecoderKLLoss):
    pass


@ENCODERS.register_module()
class EncoderWithKLLoss(PartEncoder):
    """One global latent z (B, zdim) for the whole shape, on every part slot
    (``part_encoder_variants.py:243-318``): ``encoder`` is a whole-cloud VAE
    encoder (``PointNetVAEBase``); the prior is
    ``global_flow`` (a ``PerPartFlow`` of one part) under ``use_flow``, else
    N(0, 1), with ``prior_var`` applied nowhere, as in the reference. It has
    no ``ref_encoder`` and no per-part ``flow``. The aligner runs with its
    running statistics in training too (the JAX module passes it no
    ``train``); the fit loss is a per-sample ratio."""

    def _build_latent_modules(self, encode_ref, use_flow, depth, hidden, kw):
        self.flow = None
        self.global_flow = PerPartFlow(1, depth, self.zdim, hidden, **kw) if use_flow else None

    def sample_flow_prior(self, sample_num: int, generator=None, z=None):
        """z ~ N(0, 1) (sample_num, 1, zdim), through the flow, on every part
        slot (``:268-275``); ``z`` injects the draw."""
        if z is None:
            z = randn((sample_num, 1, self.zdim), generator, self.device)
        z = z.float()
        if self.global_flow is not None:
            z = self.global_flow(z, reverse=True)
        return z.expand(sample_num, self.n_class, self.zdim)

    def forward(self, batch, noise=None, epoch=-1, train: bool = False, rngs=None):
        """(ctx, mean_pp, logvar_pp, flag_pp, losses, [part_code, mean, logvar,
        noise]) (``:277-318``); ``batch["part_code_eps"]`` (B, zdim) injects
        the global latent's draw, else ``rngs["sample"]`` draws it."""
        ref = batch["ref"]
        B = ref.shape[0]
        valid_id = batch.get("present")
        if valid_id is None:
            valid_id = torch.ones(B, self.n_class, dtype=ref.dtype, device=ref.device)
        seg_mask = batch["ref_seg_mask"].int()
        mean_g, logvar_g = self.encoder_net(ref, train=train)
        z = reparameterize_gaussian(mean_g, logvar_g, (rngs or {}).get("sample"),
                                    batch.get("part_code_eps"))
        if self.global_flow is not None:
            logpx0 = torch.zeros(B, 1, 1, dtype=z.dtype, device=z.device)
            w, delta = self.global_flow(z[:, None], logpx0, reverse=False)
            log_pz = (gaussian_log_likelihood(w[:, 0], 0.0, 0.0, dim=self.zdim).sum(-1)
                      - delta[:, 0, 0])
        else:
            log_pz = gaussian_log_likelihood(z, 0.0, 0.0, dim=self.zdim).sum(-1)
        entropy = gaussian_entropy(logvar_g, axis=-1)
        kl_w = self._kl_weight(epoch, ref.device)
        loss_dict = {"prior_loss": kl_w * (-log_pz - entropy).mean()}

        part_code = z[:, None].expand(B, self.n_class, self.zdim)
        mean, logvar = self.get_params_from_part_code(part_code, valid_id, noise=noise)
        mean_pp, logvar_pp, flag_pp = self.gather_all(seg_mask, anchors=mean, variances=logvar,
                                                      valid_id=valid_id)
        if train and self.aligner is not None:
            fit = -gaussian_log_likelihood(ref, mean_pp, logvar_pp).mean(-1) * flag_pp
            loss_dict["fit_loss"] = (self.fit_loss_weight * fit.sum(-1)
                                     / torch.clamp(flag_pp.sum(-1), min=1.0))
        ctx = self.prepare_ctx(part_code, mean, logvar, seg_mask=seg_mask)
        return ctx, mean_pp, logvar_pp, flag_pp, loss_dict, [part_code, mean, logvar, noise]
