"""The super-segment encoders and the other two-stage encoders.

Port of ``difffacto_tpu/models/supseg_encoders.py`` (the reference's
encoders/super_seg_encoder.py, mean_variance_regressor.py, pnet.py and
PCN.py), channel-last, with masked maxima in place of loops:

* ``SupSegsEncoder``: a shared point stack pools each super-segment to one
  token, a two-stage PointNet over the tokens (masked slots pushed down by
  ``_NEG``) gives a global code, and an MLP the ``num_anchors`` part latents;
* ``PartglotSupSegsEncoderWithCBN``: the point stack with a conditional
  BatchNorm on a timestep embedding;
* ``MeanVarianceRegressor``: per-part mean and logvar MLPs whose BatchNorm
  statistics are kept a class;
* ``Pnet2Stage`` and ``PCNPartEncoder`` (``ENCODERS`` ``"PCN"``).

``_TwoStage``'s ``global_first`` keeps the reference's two concatenation
orders: [global, local] in ``Pnet2Stage`` and ``PCN``, [local, global] in
``SupSegsEncoder``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn.layers import Dense, TorchBatchNorm, default_generator, timestep_embedding
from ..utils.device import resolve_device
from ..utils.registry import ENCODERS
from .segmentor import ConditionalBatchNorm1d

_NEG = -10000.0  # the reference's additive mask of an absent segment


def _kw(dtype, device, generator):
    return dict(dtype=dtype, device=resolve_device(device), generator=default_generator(generator))


class _TwoStage(nn.Module):
    """x (B, M, in_dim) -> (B, out_dim) (``supseg_encoders.py:34-64``):
    dense 128 + BN + ReLU, dense 256, the (masked) max concatenated to every
    row, dense 512 + BN + ReLU, dense out_dim, the (masked) max."""

    def __init__(self, in_dim: int, out_dim: int, global_first: bool = True, **kw):
        super().__init__()
        self.global_first = global_first
        bn = dict(dtype=kw["dtype"], device=kw["device"])
        self.dense0, self.bn0 = Dense(in_dim, 128, **kw), TorchBatchNorm(128, **bn)
        self.dense1 = Dense(128, 256, **kw)
        self.dense2, self.bn1 = Dense(512, 512, **kw), TorchBatchNorm(512, **bn)
        self.dense3 = Dense(512, out_dim, **kw)

    def forward(self, x, neg_mask=None, train: bool = False):
        """``neg_mask`` (B, M) is added to every channel before each max."""
        h = self.dense1(torch.relu(self.bn0(self.dense0(x), train)))
        masked = h if neg_mask is None else h + neg_mask[..., None]
        g = masked.amax(dim=1, keepdim=True).expand_as(h)
        h = torch.cat([g, h] if self.global_first else [h, g], dim=-1)
        h = self.dense3(torch.relu(self.bn1(self.dense2(h), train)))
        masked = h if neg_mask is None else h + neg_mask[..., None]
        return masked.amax(dim=1)


def _dense_bn_relu(mod, x, n, train, norm="bn"):
    for i in range(n):
        x = torch.relu(getattr(mod, f"{norm}{i}")(getattr(mod, f"dense{i}")(x), train))
    return x


class PartglotSupSegsEncoderBase(nn.Module):
    """4 x (dense + BN + ReLU) then a dense, all ``sup_segs_dim`` wide
    (``supseg_encoders.py:67-80``)."""

    def __init__(self, in_dim: int = 3, sup_segs_dim: int = 64, **kw):
        super().__init__()
        dims = (in_dim,) + (sup_segs_dim,) * 5
        for i in range(5):
            setattr(self, f"dense{i}", Dense(dims[i], dims[i + 1], **kw))
            if i < 4:
                setattr(self, f"bn{i}", TorchBatchNorm(sup_segs_dim, dtype=kw["dtype"],
                                                       device=kw["device"]))

    def forward(self, x, train: bool = False):
        return self.dense4(_dense_bn_relu(self, x, 4, train))


@ENCODERS.register_module()
class SupSegsEncoder(nn.Module):
    """x (B, n_seg, npoint, 3), mask (B, n_seg) -> (B, num_anchors,
    part_latent_dim) (``supseg_encoders.py:83-108``)."""

    def __init__(self, sup_segs_dim: int = 64, part_latent_dim: int = 256, num_anchors: int = 4,
                 *, dtype=None, device="cuda", generator=None):
        super().__init__()
        kw = _kw(dtype, device, generator)
        self.num_anchors, self.part_latent_dim = num_anchors, part_latent_dim
        self.base = PartglotSupSegsEncoderBase(3, sup_segs_dim, **kw)
        self.two_stage = _TwoStage(sup_segs_dim, 1024, global_first=False, **kw)
        self.dense0 = Dense(1024, 1024, **kw)
        self.dense1 = Dense(1024, 1024, **kw)
        self.dense2 = Dense(1024, part_latent_dim * num_anchors, **kw)

    def forward(self, x, mask=None, train: bool = False):
        B, n_seg, npoint, _ = x.shape
        pts = self.base(x.reshape(B * n_seg, npoint, -1), train)
        tokens = pts.amax(dim=1).reshape(B, n_seg, -1)
        neg = None if mask is None else (1.0 - mask.float()) * _NEG
        g = self.two_stage(tokens, neg, train)
        h = self.dense2(torch.relu(self.dense1(torch.relu(self.dense0(g)))))
        return h.reshape(B, self.num_anchors, self.part_latent_dim)


@ENCODERS.register_module()
class PartglotSupSegsEncoderWithCBN(nn.Module):
    """x (B, N, 3), t (B,) -> (B, N, sup_segs_dim) (``supseg_encoders.py:111-130``):
    4 x (dense + conditional BN on the timestep embedding + ReLU), a dense."""

    def __init__(self, sup_segs_dim: int = 64, embed_t_size: int = 128, emb_size: int = 256,
                 *, dtype=None, device="cuda", generator=None):
        super().__init__()
        kw = _kw(dtype, device, generator)
        self.embed_t_size = embed_t_size
        dims = (3,) + (sup_segs_dim,) * 5
        for i in range(5):
            setattr(self, f"dense{i}", Dense(dims[i], dims[i + 1], **kw))
            if i < 4:
                setattr(self, f"cbn{i}", ConditionalBatchNorm1d(sup_segs_dim, embed_t_size,
                                                                emb_size, **kw))

    def forward(self, x, t, train: bool = False):
        cond = timestep_embedding(t, self.embed_t_size)
        h = x
        for i in range(4):
            h = torch.relu(getattr(self, f"cbn{i}")(getattr(self, f"dense{i}")(h), cond, train))
        return self.dense4(h)


class _PerClassBNMLP(nn.Module):
    """x (B, K, latent_dim) -> (B, K, latent_dim) (``supseg_encoders.py:133-157``):
    dense layers 256, 128, 256 shared by the K slots, each followed by a
    BatchNorm of its own a slot (``bn{layer K + k}``) and ReLU, then a dense
    back to latent_dim."""

    def __init__(self, latent_dim: int, num_class: int, **kw):
        super().__init__()
        self.num_class = num_class
        dims = (latent_dim, 256, 128, 256, latent_dim)
        for i in range(4):
            setattr(self, f"dense{i}", Dense(dims[i], dims[i + 1], **kw))
        for i in range(3):
            for k in range(num_class):
                setattr(self, f"bn{i * num_class + k}",
                        TorchBatchNorm(dims[i + 1], dtype=kw["dtype"], device=kw["device"]))

    def forward(self, x, train: bool = False):
        h = x
        for i in range(3):
            h = getattr(self, f"dense{i}")(h)
            h = torch.stack([getattr(self, f"bn{i * self.num_class + k}")(h[:, k], train)
                             for k in range(self.num_class)], dim=1)
            h = torch.relu(h)
        return self.dense3(h)


@ENCODERS.register_module()
class MeanVarianceRegressor(nn.Module):
    """(B, K, latent_dim) part codes -> (mean, logvar) each (B, K, latent_dim)
    (``supseg_encoders.py:160-176``)."""

    def __init__(self, latent_dim: int = 256, num_class: int = 4,
                 *, dtype=None, device="cuda", generator=None):
        super().__init__()
        kw = _kw(dtype, device, generator)
        self.mean = _PerClassBNMLP(latent_dim, num_class, **kw)
        self.var = _PerClassBNMLP(latent_dim, num_class, **kw)

    def forward(self, x, train: bool = False):
        return self.mean(x, train), self.var(x, train)


@ENCODERS.register_module()
class Pnet2Stage(nn.Module):
    """(B, N, point_dim) -> (B, latent_dim) (``supseg_encoders.py:179-189``)."""

    def __init__(self, latent_dim: int = 1024, point_dim: int = 3,
                 *, dtype=None, device="cuda", generator=None):
        super().__init__()
        self.two_stage = _TwoStage(point_dim, latent_dim, **_kw(dtype, device, generator))

    def forward(self, xyz, train: bool = False):
        return self.two_stage(xyz, None, train)


@ENCODERS.register_module(name="PCN")
class PCNPartEncoder(nn.Module):
    """(B, N, point_dim) -> (B, num_anchors, part_latent_dim)
    (``supseg_encoders.py:192-221``); each latent divided by its norm with
    ``normalize_latent``."""

    def __init__(self, point_dim: int = 3, part_latent_dim: int = 512, num_anchors: int = 4,
                 normalize_latent: bool = False, *, dtype=None, device="cuda", generator=None):
        super().__init__()
        kw = _kw(dtype, device, generator)
        self.num_anchors, self.part_latent_dim = num_anchors, part_latent_dim
        self.normalize_latent = normalize_latent
        self.two_stage = _TwoStage(point_dim, 1024, **kw)
        self.dense0 = Dense(1024, 1024, **kw)
        self.dense1 = Dense(1024, 1024, **kw)
        self.dense2 = Dense(1024, part_latent_dim * num_anchors, **kw)

    def forward(self, xyz, train: bool = False):
        g = self.two_stage(xyz, None, train)
        h = self.dense2(torch.relu(self.dense1(torch.relu(self.dense0(g)))))
        latent = h.reshape(xyz.shape[0], self.num_anchors, self.part_latent_dim)
        if self.normalize_latent:
            latent = latent / latent.norm(dim=-1, keepdim=True)
        return latent
