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
    """512 -> 256 -> 128 -> zdim with BN (or LN) and ReLU between. With
    ``parts`` the parameters carry a leading part axis and x is (B, K, 512)."""

    def __init__(self, zdim: int, use_ln: bool = False, parts=None,
                 *, dtype=None, device="cuda", generator=None):
        super().__init__()
        g = default_generator(generator)
        self.parts, self.use_ln, self.dtype = parts, use_ln, dtype
        lead = () if parts is None else (parts,)
        dims = (512, 256, 128, zdim)
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
        parts = num_anchors if per_part_mlp else None
        use_ln = use_ln and not per_part_mlp
        self.mlp_m = _HeadMLP(zdim, use_ln=use_ln, parts=parts, **kw)
        self.mlp_v = _HeadMLP(zdim, use_ln=use_ln, parts=parts, **kw)

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
