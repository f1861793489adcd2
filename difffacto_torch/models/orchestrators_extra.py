"""The vanilla point-diffusion model ``PDM``.

Port of ``PDM`` in ``difffacto_tpu/models/orchestrators_extra.py`` (the
reference's point_diff.py): a whole-shape encoder (``PointNet2SSG``,
``PointNet2MSG`` or ``PointNet``) reads the cloud with its part maps and
gives one code, flattened to a single global vector; a vanilla chain
(``models/diffusion_extra.py``) with a pointwise or transformer denoiser
trains on the cloud from zero anchors with that code as its one context
token, and ``predict`` runs the reverse chain from zero anchors.
``AnchoredGeneration`` and ``AnchorDiffGenPartglot`` of the same JAX file are
not ported yet (``ROADMAP.md`` queue A item 6).

Every draw comes from an explicit ``torch.Generator`` or is injected: in
``loss`` the batch's ``diffusion_t``, ``diffusion_noise`` and
``encoder_keep`` (the encoder head's dropout keep mask), in ``predict``
``noise`` (x_T) and ``step_noise``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..utils.device import resolve_device
from ..utils.registry import ENCODERS, MODELS, NETS, SAMPLERS, build_from_cfg
from . import diffusion_extra  # noqa: F401  (registers the vanilla chains)
from . import pointnet2  # noqa: F401  (registers PointNet++)
from .anchor_diff import build_diffusion, ensure_attn_maps


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
