"""The masked part PointNet encoder, and the whole-cloud PointNet.

Port of ``difffacto_tpu/models/pointnet.py:PointNetV2`` and ``PointNet``.
``PointNetV2``: a shared per-point
stack 3 -> 128 -> 128 -> 256 -> 512, a mask-weighted max pool per part times
the number of parts, and per-part MLP heads 512 -> 256 -> 128 -> zdim. The JAX
package vmaps the heads over the part axis with separate parameters and
BatchNorm statistics; here they stay stacked on a leading part axis
((K, in, out) kernels, (K, C) statistics), so the weight bridge is a copy.
``PointNet`` (``pointnet.py:241-256``): the same stack 3 -> 128 -> 128 -> 256
-> 512, a max over the points, and one head to num_anchors x zdim; the part
encoder's ``encode_ref`` encodes the reference cloud with it.

And the variants of ``pointnet.py:91-239``: ``PointNetVAEBase`` (a whole
cloud -> mean, logvar (B, zdim), points masked to -inf before the pool),
``PointNetVAE`` (a whole cloud -> per-anchor mean, logvar), ``PointNetV2VAE``
(``PointNetV2`` with the part maps packed into the input's channels 3..),
``PointNetV2Variant`` (each part's max over its own points, an absent part
pooled to 0 by ``nan_to_num``) and ``PointNetV3`` (the global and the
weighted per-part pools concatenated -> per-part means). Every max over the
points goes through ``parallel/axes.allmax_points``, as in the JAX package.
The whole-cloud encoders take (and ignore) the ``generator`` and ``keep``
that ``PDM`` passes every encoder.
"""

from __future__ import annotations

import torch
from torch import nn

from ..parallel.axes import allmax_points
from ..nn.layers import (ConvBNReLUStack, Dense, LayerNorm, TorchBatchNorm, default_generator,
                         lecun_normal, param)
from ..utils.device import resolve_device
from ..utils.registry import ENCODERS


class _HeadMLP(nn.Module):
    """in_dim (512) -> 256 -> 128 -> zdim with BN (or LN) and ReLU between.
    With ``parts`` the parameters carry a leading part axis and x is
    (B, K, in_dim)."""

    def __init__(self, zdim: int, use_ln: bool = False, parts=None, in_dim: int = 512,
                 *, dtype=None, device="cuda", generator=None):
        super().__init__()
        g = default_generator(generator)
        self.parts, self.use_ln, self.dtype = parts, use_ln, dtype
        lead = () if parts is None else (parts,)
        dims = (in_dim, 256, 128, zdim)
        for i in range(3):
            if parts is None:
                setattr(self, f"dense{i}", Dense(dims[i], dims[i + 1], dtype=dtype, device=device,
                                                 generator=g))
            else:
                # flax splits the init rng per part: every part draws with its own fan-in
                kernel = torch.stack([lecun_normal((dims[i], dims[i + 1]), g) for _ in range(parts)])
                setattr(self, f"dense{i}", _StackedDense(kernel, dtype, device))
            if i < 2:
                if use_ln:
                    setattr(self, f"ln{i}", LayerNorm(dims[i + 1], dtype=dtype, device=device))
                else:
                    setattr(self, f"bn{i}", TorchBatchNorm(lead + (dims[i + 1],), dtype=dtype,
                                                           device=device))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for i in range(2):
            x = getattr(self, f"dense{i}")(x)
            x = getattr(self, f"ln{i}")(x) if self.use_ln else getattr(self, f"bn{i}")(x, train)
            x = torch.relu(x)
        return self.dense2(x)


class _StackedDense(nn.Module):
    """K independent dense layers: x (B, K, in) @ kernel (K, in, out) + bias (K, out)."""

    def __init__(self, kernel: torch.Tensor, dtype, device):
        super().__init__()
        self.dtype = dtype
        self.kernel = param(kernel, device)
        self.bias = param(torch.zeros(kernel.shape[0], kernel.shape[2]), device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, self.kernel.dtype)
        return torch.einsum("bki,kio->bko", x.to(dt), self.kernel.to(dt)) + self.bias.to(dt)


def _heads(zdim: int, per_part_mlp: bool, parts: int, use_ln: bool = False, **kw):
    """The ``mlp_m`` and ``mlp_v`` heads, stacked on the part axis with
    ``per_part_mlp`` (LayerNorm only without it, as the JAX module builds them)."""
    p = parts if per_part_mlp else None
    return (_HeadMLP(zdim, use_ln=use_ln and not per_part_mlp, parts=p, **kw),
            _HeadMLP(zdim, use_ln=use_ln and not per_part_mlp, parts=p, **kw))


@ENCODERS.register_module()
class PointNetV2(nn.Module):
    """points (B, N, point_dim), attn_weight (B, N, K) -> (m, v) each (B, K, zdim)."""

    def __init__(self, point_dim: int = 3, zdim: int = 1024, num_anchors: int = 4,
                 reweight_by_anchor: bool = True, use_ln: bool = False,
                 per_part_mlp: bool = False, *, dtype=None, device="cuda", generator=None):
        super().__init__()
        device = resolve_device(device)
        g = default_generator(generator)
        self.num_anchors, self.reweight_by_anchor = num_anchors, reweight_by_anchor
        kw = dict(dtype=dtype, device=device, generator=g)
        self.pnet = ConvBNReLUStack(point_dim, (128, 128, 256, 512), relu_last=False, **kw)
        self.mlp_m, self.mlp_v = _heads(zdim, per_part_mlp, num_anchors, use_ln, **kw)

    def forward(self, points, attn_weight, train: bool = False):
        h = self.pnet(points, train)
        # The features are multiplied by the 0/1 weight, so an absent part
        # pools to 0 where the features are not positive (``pointnet.py:63-69``).
        weighted = h[:, :, None, :] * attn_weight[:, :, :, None].to(h.dtype)
        if self.reweight_by_anchor:
            weighted = weighted * self.num_anchors
        pooled = allmax_points(weighted.amax(dim=1))  # (B, K, 512)
        return self.mlp_m(pooled, train), self.mlp_v(pooled, train)


@ENCODERS.register_module()
class PointNet(nn.Module):
    """points (B, N, point_dim) -> (B, num_anchors, zdim), deterministic."""

    def __init__(self, point_dim: int = 3, zdim: int = 1024, num_anchors: int = 1,
                 *, dtype=None, device="cuda", generator=None):
        super().__init__()
        device = resolve_device(device)
        g = default_generator(generator)
        self.num_anchors, self.zdim = num_anchors, zdim
        kw = dict(dtype=dtype, device=device, generator=g)
        self.pnet = ConvBNReLUStack(point_dim, (128, 128, 256, 512), relu_last=False, **kw)
        self.mlp_m = _HeadMLP(zdim * num_anchors, **kw)

    def forward(self, points, train: bool = False, generator=None, keep=None):
        """``generator`` and ``keep`` are the whole-shape encoders' draws
        (``PointNet2SSG``'s head dropout); PointNet has none and ignores them."""
        g = allmax_points(self.pnet(points, train).amax(dim=1))
        return self.mlp_m(g, train).reshape(points.shape[0], self.num_anchors, self.zdim)


def _split_maps(points, maps):
    """The part maps packed into the input's channels 3.. where none are given."""
    if maps is None:
        return points[..., :3], points[..., 3:]
    return points, maps


@ENCODERS.register_module()
class PointNetVAEBase(nn.Module):
    """points (B, N, point_dim) -> mean, logvar each (B, zdim)
    (``pointnet.py:91-110``). ``mask`` (B, N) bool drops points from the pool;
    a row with no point left pools to 0."""

    def __init__(self, point_dim: int = 3, zdim: int = 1024,
                 *, dtype=None, device="cuda", generator=None):
        super().__init__()
        kw = dict(dtype=dtype, device=resolve_device(device), generator=default_generator(generator))
        self.pnet = ConvBNReLUStack(point_dim, (128, 128, 256, 512), relu_last=False, **kw)
        self.mlp_m, self.mlp_v = _HeadMLP(zdim, **kw), _HeadMLP(zdim, **kw)

    def forward(self, points, mask=None, train: bool = False, generator=None, keep=None):
        h = self.pnet(points, train)
        if mask is not None:
            h = torch.where(mask[..., None].bool(), torch.full_like(h, -torch.inf), h)
        g = torch.nan_to_num(allmax_points(h.amax(dim=1)), neginf=0.0)
        return self.mlp_m(g, train), self.mlp_v(g, train)


@ENCODERS.register_module()
class PointNetVAE(nn.Module):
    """points (B, N, point_dim) -> mean, logvar each (B, num_anchors, zdim)
    (``pointnet.py:113-132``)."""

    def __init__(self, point_dim: int = 7, zdim: int = 1024, num_anchors: int = 4,
                 *, dtype=None, device="cuda", generator=None):
        super().__init__()
        kw = dict(dtype=dtype, device=resolve_device(device), generator=default_generator(generator))
        self.num_anchors, self.zdim = num_anchors, zdim
        self.pnet = ConvBNReLUStack(point_dim, (128, 128, 256, 512), relu_last=False, **kw)
        self.mlp_m = _HeadMLP(zdim * num_anchors, **kw)
        self.mlp_v = _HeadMLP(zdim * num_anchors, **kw)

    def forward(self, points, train: bool = False, generator=None, keep=None):
        g = allmax_points(self.pnet(points, train).amax(dim=1))
        shape = (points.shape[0], self.num_anchors, self.zdim)
        return self.mlp_m(g, train).reshape(shape), self.mlp_v(g, train).reshape(shape)


@ENCODERS.register_module()
class PointNetV2VAE(PointNetV2):
    """``PointNetV2`` with the part maps in the input's channels 3.. where
    none are given (``pointnet.py:135-150``); ``deterministic`` returns the
    means alone. ``point_dim`` is the width the point stack reads."""

    def __init__(self, point_dim: int = 3, zdim: int = 1024, num_anchors: int = 4,
                 reweight_by_anchor: bool = True, use_ln: bool = False,
                 per_part_mlp: bool = False, deterministic: bool = False,
                 *, dtype=None, device="cuda", generator=None):
        super().__init__(point_dim, zdim, num_anchors, reweight_by_anchor, use_ln, per_part_mlp,
                         dtype=dtype, device=device, generator=generator)
        self.deterministic = deterministic

    def forward(self, points, attn_weight=None, train: bool = False, generator=None, keep=None):
        m, v = super().forward(*_split_maps(points, attn_weight), train=train)
        return m if self.deterministic else (m, v)


@ENCODERS.register_module()
class PointNetV2Variant(nn.Module):
    """points (B, N, point_dim), seg_flag (B, N, K) (or packed in the input's
    channels 3..) -> mean, logvar each (B, K, zdim) (``pointnet.py:153-195``):
    each part's max over its own points, an absent part's -inf pooled to 0
    (``nan_to_num``, as the JAX module keeps it)."""

    def __init__(self, point_dim: int = 3, zdim: int = 1024, num_anchors: int = 4,
                 per_part_mlp: bool = False, *, dtype=None, device="cuda", generator=None):
        super().__init__()
        kw = dict(dtype=dtype, device=resolve_device(device), generator=default_generator(generator))
        self.pnet = ConvBNReLUStack(point_dim, (128, 128, 256, 512), relu_last=False, **kw)
        self.mlp_m, self.mlp_v = _heads(zdim, per_part_mlp, num_anchors, **kw)

    def forward(self, points, seg_flag=None, train: bool = False, generator=None, keep=None):
        points, seg_flag = _split_maps(points, seg_flag)
        h = self.pnet(points, train)
        weighted = torch.where(seg_flag[..., None] > 0, h[:, :, None, :],
                               torch.full((), -torch.inf, dtype=h.dtype, device=h.device))
        pooled = torch.nan_to_num(allmax_points(weighted.amax(dim=1)), nan=0.0, posinf=0.0,
                                  neginf=0.0)
        return self.mlp_m(pooled, train), self.mlp_v(pooled, train)


@ENCODERS.register_module()
class PointNetV3(nn.Module):
    """points (B, N, point_dim), attn_weight (B, N, K) (or packed in channels
    3.. of a 3 + K wide input) -> per-part means (B, K, zdim)
    (``pointnet.py:198-238``): the global max and the weighted per-part max
    (times K with ``reweight_by_anchor``), concatenated."""

    def __init__(self, point_dim: int = 3, zdim: int = 1024, num_anchors: int = 4,
                 mult: int = 1, reweight_by_anchor: bool = True,
                 *, dtype=None, device="cuda", generator=None):
        super().__init__()
        kw = dict(dtype=dtype, device=resolve_device(device), generator=default_generator(generator))
        self.num_anchors, self.reweight_by_anchor = num_anchors, reweight_by_anchor
        widths = (128 * mult, 128 * mult, 256 * mult, 256 * mult)
        self.pnet = ConvBNReLUStack(point_dim, widths, relu_last=False, **kw)
        self.mlp_m = _HeadMLP(zdim, in_dim=512 * mult, **kw)

    def forward(self, points, attn_weight=None, train: bool = False, generator=None, keep=None):
        if attn_weight is None and points.shape[-1] == 3 + self.num_anchors:
            points, attn_weight = _split_maps(points, None)
        h = self.pnet(points, train)
        weighted = h[:, :, None, :] * attn_weight[..., None]
        if self.reweight_by_anchor:
            weighted = weighted * self.num_anchors
        pooled = allmax_points(weighted.amax(dim=1))  # (B, K, 256 mult)
        g = allmax_points(h.amax(dim=1))[:, None].expand_as(pooled)
        return self.mlp_m(torch.cat([g, pooled], dim=-1), train)
