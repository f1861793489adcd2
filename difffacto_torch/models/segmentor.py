"""The per-point segmentation head and the conditional BatchNorm.

Port of ``difffacto_tpu/models/segmentor.py`` (the reference's
segmentors/pointnet_segmentor.py:7-32 and modules/cbn.py:11-69).
``PointNetDenseCls``: a point stack 3 -> 64 -> 128 -> 1024, the global max,
and each point's first 64 features of the stack's last layer next to the
global code, classified per point (log-softmax). ``ConditionalBatchNorm1d``:
per-channel gamma and beta moved by two MLPs of a conditioning embedding,
over batch statistics with the unbiased variance, as the JAX module
implements the reference's evident intent.
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn.layers import ConvBNReLUStack, Dense, TorchBatchNorm, default_generator, param
from ..utils.device import resolve_device
from ..utils.registry import SEGMENTORS


@SEGMENTORS.register_module()
class PointNetDenseCls(nn.Module):
    """points (B, N, 3) -> (log_probs (B, N, n_class), global_feat (B, 1024))
    (``segmentor.py:21-43``)."""

    def __init__(self, n_class: int = 2, *, dtype=None, device="cuda", generator=None):
        super().__init__()
        kw = dict(dtype=dtype, device=resolve_device(device), generator=default_generator(generator))
        self.feat = ConvBNReLUStack(3, (64, 128, 1024), relu_last=False, **kw)
        dims = (64 + 1024, 512, 256, 128, n_class)
        for i in range(4):
            setattr(self, f"dense{i}", Dense(dims[i], dims[i + 1], **kw))
            if i < 3:
                setattr(self, f"bn{i}", TorchBatchNorm(dims[i + 1], dtype=dtype,
                                                       device=kw["device"]))

    def forward(self, points, train: bool = False):
        B, N, _ = points.shape
        h = self.feat(points, train)
        g = h.amax(dim=1)
        x = torch.cat([h[..., :64], g[:, None].expand(B, N, g.shape[-1])], dim=-1)
        for i in range(3):
            x = torch.relu(getattr(self, f"bn{i}")(getattr(self, f"dense{i}")(x), train))
        return torch.log_softmax(self.dense3(x), dim=-1), g


class ConditionalBatchNorm1d(nn.Module):
    """x (B, N, C), cond (B, embed_t_size) -> (x - mean) / sqrt(var + eps) *
    gamma + beta (``segmentor.py:46-86``): the statistics over (B, N), the
    variance unbiased (torch.var's default); gamma = ``gammas`` + fc_gamma(cond)
    and beta = ``betas`` + fc_beta(cond), each an MLP embed_t_size -> emb_size
    -> ReLU -> C, with ``use_gammas`` and ``use_betas``. It keeps no running
    statistics: ``train`` changes nothing."""

    def __init__(self, channels: int, embed_t_size: int = 128, emb_size: int = 256,
                 use_betas: bool = True, use_gammas: bool = True, eps: float = 1e-5,
                 *, dtype=None, device="cuda", generator=None):
        super().__init__()
        device = resolve_device(device)
        g = default_generator(generator)
        self.use_betas, self.use_gammas, self.eps = use_betas, use_gammas, eps
        self.betas = param(torch.zeros(channels), device)
        self.gammas = param(torch.ones(channels), device)
        kw = dict(dtype=dtype, device=device, generator=g)
        for name, on in (("fc_gamma", use_gammas), ("fc_beta", use_betas)):
            if on:
                setattr(self, f"{name}_0", Dense(embed_t_size, emb_size, **kw))
                setattr(self, f"{name}_1", Dense(emb_size, channels, **kw))

    def _delta(self, name, cond):
        return getattr(self, f"{name}_1")(torch.relu(getattr(self, f"{name}_0")(cond)))

    def forward(self, x, cond, train: bool = False):
        gamma = self.gammas[None] + (self._delta("fc_gamma", cond) if self.use_gammas else 0.0)
        beta = self.betas[None] + (self._delta("fc_beta", cond) if self.use_betas else 0.0)
        mu = x.mean(dim=(0, 1), keepdim=True)
        n = x.shape[0] * x.shape[1]
        var = x.var(dim=(0, 1), keepdim=True, correction=0) * (n / max(n - 1, 1))
        xhat = (x - mu) * torch.rsqrt(var + self.eps)
        return xhat * gamma[:, None, :] + beta[:, None, :]
