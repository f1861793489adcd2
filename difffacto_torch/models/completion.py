"""Point-cloud completion: PCN, CoarsePCN and DiffuCompletion.

Port of ``difffacto_tpu/models/completion.py`` (the reference's PCN.py,
coarsePCN.py and completion.py): a two-stage PointNet code of the partial
cloud, decoded by PCN's coarse MLP and folding refinement, or, in
``DiffuCompletion``, by a vanilla point DPM conditioned on it. Training
batches hold ``ref`` (the whole cloud) and ``input`` (the partial one),
as ``data/dataset_utils.py:CroppingDataLoader`` cuts them (its
``partial``).

PCN's and CoarsePCN's ``loss`` field names the Chamfer distance ("cd_l1"
or "cd_l2"). In the JAX modules the ``loss`` method shadows the field's
default, so a model built without ``loss`` compares its field, a function,
with "cd_l1" and trains on the squared-L2 Chamfer; the port's default
``None`` computes the same. The field is kept as ``loss_type``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..nn.layers import Dense, TorchBatchNorm
from ..ops.chamfer import chamfer_l1, chamfer_l2
from ..utils.device import resolve_device
from ..utils.registry import MODELS, NETS, SAMPLERS, build_from_cfg
from . import denoiser, diffusion_extra  # noqa: F401  (registers)
from .anchor_diff import build_diffusion
from .supseg_encoders import _TwoStage


def _chamfer(loss_type):
    return chamfer_l1 if loss_type == "cd_l1" else chamfer_l2


class PCNEncoder(nn.Module):
    """(B, N, 3) -> (B, encoder_channel): the two-stage PointNet with the
    [global, local] concatenation (``completion.py:24-37``)."""

    def __init__(self, encoder_channel: int = 1024, *, dtype=None, device="cuda",
                 generator=None):
        super().__init__()
        self.two_stage = _TwoStage(3, encoder_channel, global_first=True, dtype=dtype,
                                   device=resolve_device(device), generator=generator)

    def forward(self, xyz, train: bool = False):
        return self.two_stage(xyz, None, train)


def _coarse_head(self, enc, out, kw):
    self.pcn_encoder = PCNEncoder(enc, **kw)
    self.dense0 = Dense(enc, 1024, **kw)
    self.dense1 = Dense(1024, 1024, **kw)
    self.dense2 = Dense(1024, out, **kw)


def _coarse(self, xyz, train):
    feat = self.pcn_encoder(xyz, train)
    return feat, self.dense2(torch.relu(self.dense1(torch.relu(self.dense0(feat)))))


@MODELS.register_module()
class PCN(nn.Module):
    """The coarse MLP and folding refinement (``completion.py:40-103``):
    ``num_pred`` = coarse points x ``grid_size``^2. ``seed`` fixes the
    initial weights."""

    def __init__(self, num_pred: int = 2048, encoder_channel: int = 1024, grid_size: int = 4,
                 loss: Optional[str] = None, *, dtype=None, device="cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        kw = dict(dtype=dtype, device=device, generator=torch.Generator().manual_seed(seed))
        self.num_pred, self.grid_size, self.loss_type = num_pred, grid_size, loss
        self.num_coarse = num_pred // grid_size**2
        _coarse_head(self, encoder_channel, 3 * self.num_coarse, kw)
        bn = dict(dtype=dtype, device=device)
        self.dense3, self.bn0 = Dense(encoder_channel + 5, 512, **kw), TorchBatchNorm(512, **bn)
        self.dense4, self.bn1 = Dense(512, 512, **kw), TorchBatchNorm(512, **bn)
        self.dense5 = Dense(512, 3, **kw)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def forward(self, partial, train: bool = False):
        """partial (B, Np, 3) -> (coarse (B, num_coarse, 3), fine (B, num_pred, 3))."""
        B = partial.shape[0]
        feat, h = _coarse(self, partial, train)
        coarse = h.reshape(B, self.num_coarse, 3)
        g = self.grid_size
        lin = torch.linspace(-0.05, 0.05, g, dtype=feat.dtype, device=feat.device)
        m0, m1 = torch.meshgrid(lin, lin, indexing="ij")
        # channel 0 varies fast across the g x g grid, channel 1 slow (PCN.py:43-45)
        grid = torch.stack([m1, m0], -1).reshape(1, 1, g * g, 2)
        grid = grid.expand(B, self.num_coarse, g * g, 2).reshape(B, self.num_pred, 2)
        center = coarse.repeat_interleave(g * g, dim=1)
        feat_pp = feat[:, None].expand(B, self.num_pred, feat.shape[-1])
        h = torch.cat([feat_pp, grid, center], dim=-1)  # [feat, seed, point] (PCN.py:71)
        h = torch.relu(self.bn0(self.dense3(h), train))
        h = torch.relu(self.bn1(self.dense4(h), train))
        return coarse, self.dense5(h) + center

    def get_loss(self, coarse, fine, gt) -> Dict[str, torch.Tensor]:
        cd = _chamfer(self.loss_type)
        return {"coarse_loss": cd(coarse, gt).mean(), "fine_loss": cd(fine, gt).mean()}

    def loss(self, batch, epoch=0, train: bool = True, rngs=None) -> Dict[str, torch.Tensor]:
        """Chamfer of the coarse and the fine cloud of ``input`` against ``ref``."""
        coarse, fine = self(batch["input"], train=True)
        return self.get_loss(coarse, fine, batch["ref"])


@MODELS.register_module()
class CoarsePCN(nn.Module):
    """``num_anchors`` coarse points regressed from the whole cloud against
    that cloud (``completion.py:106-140``: the reference reads both from
    ``ref``). ``seed`` fixes the initial weights."""

    def __init__(self, num_anchors: int = 448, encoder_channel: int = 1024,
                 loss: Optional[str] = None, *, dtype=None, device="cuda", seed: int = 0):
        super().__init__()
        kw = dict(dtype=dtype, device=resolve_device(device),
                  generator=torch.Generator().manual_seed(seed))
        self.num_anchors, self.loss_type = num_anchors, loss
        _coarse_head(self, encoder_channel, 3 * num_anchors, kw)

    def forward(self, xyz, train: bool = False):
        return _coarse(self, xyz, train)[1].reshape(xyz.shape[0], self.num_anchors, 3)

    def loss(self, batch, epoch=0, train: bool = True, rngs=None) -> Dict[str, torch.Tensor]:
        gt = batch["ref"]
        return {"coarse_loss": _chamfer(self.loss_type)(self(gt, train=True), gt).mean()}


@MODELS.register_module()
class DiffuCompletion(nn.Module):
    """A vanilla point DPM conditioned on the partial cloud's code
    (``completion.py:143-205``). ``seed`` fixes the initial weights."""

    def __init__(self, diffusion: dict, sampler: dict, num_timesteps: int,
                 encoder_channel: int = 512, npoints: int = 2048, ret_traj: bool = False,
                 ret_interval: int = 20, *, dtype=None, device="cuda", seed: int = 0):
        super().__init__()
        kw = dict(dtype=dtype, device=resolve_device(device),
                  generator=torch.Generator().manual_seed(seed))
        self.num_timesteps, self.npoints = num_timesteps, npoints
        self.ret_traj, self.ret_interval = ret_traj, ret_interval
        self.partial_encoder = PCNEncoder(encoder_channel, **kw)
        self.net = build_from_cfg(dict(diffusion["net"]), NETS, **kw)
        self.diff = build_diffusion(diffusion, num_timesteps)
        self.t_sampler = build_from_cfg(dict(sampler), SAMPLERS, num_timesteps=num_timesteps)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def denoise(self, x, t, ctx, anchors, variances, seg_mask, valid_id, train: bool = False,
                generator=None):
        return self.net(x, t, ctx, anchors, variances, seg_mask, valid_id, train=train,
                        generator=generator)

    def encode(self, partial, train: bool = False):
        """(B, 1, encoder_channel): the partial cloud's code as one ctx token."""
        return self.partial_encoder(partial, train)[:, None]

    def decode(self, code, generator: Optional[torch.Generator] = None, noise=None,
               step_noise=None) -> Dict[str, torch.Tensor]:
        """The reverse chain from zero anchors conditioned on ``code``:
        {'pred' (B, npoints, 3)} and with ``ret_traj`` 'traj'. ``noise`` and
        ``step_noise`` inject x_T and the step draws."""
        B = code.shape[0]

        def model_fn(inp, ts, c, anc, var, seg, vid):
            return self.denoise(inp, ts, c, anc, var, seg, vid)

        return self.diff.p_sample_loop(
            model_fn, torch.zeros(B, self.npoints, 3, device=code.device), ctx=code,
            seg_mask=torch.zeros(B, self.npoints, dtype=torch.int32, device=code.device),
            noise=noise, ret_traj=self.ret_traj, ret_interval=self.ret_interval,
            step_noise=step_noise, generator=generator)

    @torch.inference_mode()
    def reconstruct(self, batch, generator: Optional[torch.Generator] = None, noise=None,
                    step_noise=None) -> Dict[str, torch.Tensor]:
        """``input`` encoded and decoded, with ``ref`` and ``input`` beside it."""
        out = self.decode(self.encode(batch["input"]), generator, noise, step_noise)
        out["ref"], out["input"] = batch["ref"], batch["input"]
        return out

    def loss(self, batch, epoch=0, train: bool = True, rngs=None) -> Dict[str, torch.Tensor]:
        """The chain's loss on ``ref`` from zero anchors, the code of
        ``input`` its context; ``diffusion_t`` and ``diffusion_noise`` inject
        the draws, else ``rngs["sample"]``."""
        rngs = rngs or {}
        gt = batch["ref"]
        code = self.encode(batch["input"], train=True)
        t = batch.get("diffusion_t")
        if t is None:
            t, _ = self.t_sampler.sample(rngs.get("sample"), gt.shape[0], device=gt.device)

        def model_fn(inp, ts, c, anc, var, seg, vid):
            return self.denoise(inp, ts, c, anc, var, seg, vid, train=True,
                                generator=rngs.get("dropout"))

        return self.diff.training_losses(
            model_fn, gt, t.long(), anchors=torch.zeros_like(gt), ctx=code,
            seg_mask=torch.zeros(gt.shape[:2], dtype=torch.int32, device=gt.device),
            noise=batch.get("diffusion_noise"), generator=rngs.get("sample"))
