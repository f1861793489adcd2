"""PointNet++ set-abstraction encoders, single- and multi-scale.

Port of ``difffacto_tpu/models/pointnet2.py`` (the reference's PointNet++
stack): each set abstraction samples centres by furthest point sampling
(``ops/points.fps``, on the card the CUDA kernel ``csrc/fps.cu``), groups
the points of a ball around each (``ball_query``, ``group_points``, plain
torch as the JAX package's XLA), runs a shared Dense + BatchNorm + ReLU
stack over the channel axis of the (B, S, nsample, C) neighbourhoods and
max-pools over the neighbourhood. The modules keep flax's names
(``PointnetSAModule_<i>``, ``SharedMLP_<i>``, ``Dense_<k>`` -> ``dense<k>``,
``TorchBatchNorm_<k>`` -> ``bn<k>``) and the ``additioinal_dim`` spelling
of the configs.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..nn.layers import Dense, TorchBatchNorm, default_generator, dropout
from ..ops.points import ball_query, fps, group_points, three_interpolate, three_nn
from ..utils.device import resolve_device
from ..utils.registry import ENCODERS


class SharedMLP(nn.Module):
    """1x1-conv + BN + ReLU over the channel axis (``pointnet2.py:24-35``); no bias."""

    def __init__(self, in_features: int, features: Sequence[int], *, dtype=None, device="cuda",
                 generator=None):
        super().__init__()
        g = default_generator(generator)
        dims = [in_features, *features]
        self.n = len(features)
        for i in range(self.n):
            setattr(self, f"dense{i}", Dense(dims[i], dims[i + 1], use_bias=False, dtype=dtype,
                                             device=device, generator=g))
            setattr(self, f"bn{i}", TorchBatchNorm(dims[i + 1], dtype=dtype, device=device))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for i in range(self.n):
            x = torch.relu(getattr(self, f"bn{i}")(getattr(self, f"dense{i}")(x), train=train))
        return x


def query_and_group(xyz, new_xyz, features, radius: float, nsample: int, use_xyz: bool = True):
    """Ball-query neighbourhoods with centred xyz (``pointnet2.py:38-61``):
    xyz (B, N, 3), new_xyz (B, S, 3), features (B, N, C) or None ->
    (B, S, nsample, [3 +] C)."""
    idx = ball_query(new_xyz, xyz, radius, nsample)
    grouped_xyz = group_points(xyz.transpose(1, 2), idx).permute(0, 2, 3, 1)
    grouped_xyz = grouped_xyz - new_xyz[:, :, None, :]
    if features is None:
        if not use_xyz:
            raise ValueError("a neighbourhood without features must keep its xyz")
        return grouped_xyz
    grouped_feat = group_points(features.transpose(1, 2), idx).permute(0, 2, 3, 1)
    return torch.cat([grouped_xyz, grouped_feat], dim=-1) if use_xyz else grouped_feat


def group_all(xyz, features, use_xyz: bool = True):
    """One neighbourhood of every point (``pointnet2.py:64-74``): (B, 1, N, [3 +] C)."""
    if features is None:
        return xyz[:, None]
    return torch.cat([xyz[:, None], features[:, None]], dim=-1) if use_xyz else features[:, None]


class PointnetSAModule(nn.Module):
    """Single-scale set abstraction (``pointnet2.py:77-100``): FPS to ``npoint``
    centres and ball grouping, or, without ``npoint``, one group of every
    point; the shared MLP ``mlp[1:]`` over ``mlp[0]`` input channels."""

    def __init__(self, mlp: Sequence[int], npoint: Optional[int] = None,
                 radius: Optional[float] = None, nsample: Optional[int] = None,
                 use_xyz: bool = True, *, dtype=None, device="cuda", generator=None):
        super().__init__()
        self.npoint, self.radius, self.nsample, self.use_xyz = npoint, radius, nsample, use_xyz
        self.SharedMLP_0 = SharedMLP(mlp[0], mlp[1:], dtype=dtype, device=device,
                                     generator=generator)

    def forward(self, xyz, features=None, train: bool = False):
        if self.npoint is not None:
            new_xyz = fps(xyz, self.npoint)
            grouped = query_and_group(xyz, new_xyz, features, self.radius, self.nsample,
                                      self.use_xyz)
        else:
            new_xyz = None
            grouped = group_all(xyz, features, self.use_xyz)
        return new_xyz, self.SharedMLP_0(grouped, train=train).amax(dim=2)


class PointnetSAModuleMSG(nn.Module):
    """Multi-scale grouping (``pointnet2.py:103-123``): one ball and shared MLP
    a scale around the same FPS centres, the pooled features concatenated."""

    def __init__(self, npoint: int, radii: Sequence[float], nsamples: Sequence[int],
                 mlps: Sequence[Sequence[int]], use_xyz: bool = True, *, dtype=None,
                 device="cuda", generator=None):
        super().__init__()
        g = default_generator(generator)
        self.npoint, self.radii, self.nsamples, self.use_xyz = npoint, radii, nsamples, use_xyz
        for i, mlp in enumerate(mlps):
            setattr(self, f"SharedMLP_{i}", SharedMLP(mlp[0], mlp[1:], dtype=dtype, device=device,
                                                      generator=g))

    def forward(self, xyz, features=None, train: bool = False):
        new_xyz = fps(xyz, self.npoint)
        outs = []
        for i, (radius, nsample) in enumerate(zip(self.radii, self.nsamples)):
            grouped = query_and_group(xyz, new_xyz, features, radius, nsample, self.use_xyz)
            outs.append(getattr(self, f"SharedMLP_{i}")(grouped, train=train).amax(dim=2))
        return new_xyz, torch.cat(outs, dim=-1)


class PointnetFPModule(nn.Module):
    """Feature propagation by inverse-distance 3-NN interpolation
    (``pointnet2.py:126-150``). ``in_features`` is the width of the
    interpolated features with the unknown points' own, which flax infers."""

    def __init__(self, in_features: int, mlp: Sequence[int], *, dtype=None, device="cuda",
                 generator=None):
        super().__init__()
        self.SharedMLP_0 = SharedMLP(in_features, mlp, dtype=dtype, device=device,
                                     generator=generator)

    def forward(self, unknown, known, unknown_feats, known_feats, train: bool = False):
        if known is not None:
            dist, idx = three_nn(unknown, known)
            inv = 1.0 / dist.clamp_min(1e-8)
            weight = inv / inv.sum(-1, keepdim=True)
            interp = three_interpolate(known_feats.transpose(1, 2), idx, weight).transpose(1, 2)
        else:
            interp = known_feats.expand(known_feats.shape[0], unknown.shape[1],
                                        known_feats.shape[-1])
        if unknown_feats is not None:
            interp = torch.cat([interp, unknown_feats], dim=-1)
        return self.SharedMLP_0(interp, train=train)


@ENCODERS.register_module()
class PointNet2SSG(nn.Module):
    """Single-scale PointNet++ global encoder (``pointnet2.py:153-190``):
    pointcloud (B, N, 3 + additioinal_dim) -> (B, num_anchors, zdim). The
    head's dropout acts in training only."""

    def __init__(self, additioinal_dim: int = 4, zdim: int = 256, num_anchors: int = 4,
                 dropout: float = 0.5, *, dtype=None, device="cuda", generator=None):
        super().__init__()
        device = resolve_device(device)
        g = default_generator(generator)
        self.zdim, self.num_anchors, self.dropout = zdim, num_anchors, dropout
        kw = dict(dtype=dtype, device=device, generator=g)
        for name, module in self.sa_stack(additioinal_dim, kw):
            setattr(self, name, module)
        self.sa_names = [name for name, _ in self.sa_stack(additioinal_dim, None)]
        self.dense0 = Dense(1024, 512, use_bias=False, **kw)
        self.bn0 = TorchBatchNorm(512, dtype=dtype, device=device)
        self.dense1 = Dense(512, 256, use_bias=False, **kw)
        self.bn1 = TorchBatchNorm(256, dtype=dtype, device=device)
        self.dense2 = Dense(256, zdim * num_anchors, **kw)

    @staticmethod
    def sa_stack(extra: int, kw):
        """(name, module) of each set abstraction; names alone where ``kw`` is None."""
        specs = [
            ("PointnetSAModule_0", dict(mlp=[extra + 3, 64, 64, 128], npoint=512, radius=0.2,
                                        nsample=64)),
            ("PointnetSAModule_1", dict(mlp=[128 + 3, 128, 128, 256], npoint=128, radius=0.4,
                                        nsample=64)),
            ("PointnetSAModule_2", dict(mlp=[256 + 3, 256, 512, 1024])),
        ]
        return [(n, None if kw is None else PointnetSAModule(**spec, **kw)) for n, spec in specs]

    def forward(self, pointcloud: torch.Tensor, train: bool = False, generator=None,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``keep`` (B, 256) injects the head dropout's keep mask in training."""
        B = pointcloud.shape[0]
        xyz = pointcloud[..., :3].contiguous()
        features = pointcloud[..., 3:] if pointcloud.shape[-1] > 3 else None
        for name in self.sa_names:
            xyz, features = getattr(self, name)(xyz, features, train=train)
        h = features[:, 0]
        h = torch.relu(self.bn0(self.dense0(h), train=train))
        h = torch.relu(self.bn1(self.dense1(h), train=train))
        if train and keep is not None:
            h = h * keep.to(h.dtype) / (1.0 - self.dropout)
        else:
            h = dropout(h, self.dropout, train, generator)
        return self.dense2(h).reshape(B, self.num_anchors, self.zdim)


@ENCODERS.register_module()
class PointNet2MSG(PointNet2SSG):
    """Multi-scale variant (``pointnet2.py:193-222``)."""

    @staticmethod
    def sa_stack(extra: int, kw):
        specs = [
            ("PointnetSAModuleMSG_0", PointnetSAModuleMSG, dict(
                npoint=512, radii=[0.1, 0.2, 0.4], nsamples=[16, 32, 128],
                mlps=[[extra + 3, 32, 32, 64], [extra + 3, 64, 64, 128],
                      [extra + 3, 64, 96, 128]])),
            ("PointnetSAModuleMSG_1", PointnetSAModuleMSG, dict(
                npoint=128, radii=[0.2, 0.4, 0.8], nsamples=[32, 64, 128],
                mlps=[[64 + 128 + 128 + 3, 64, 64, 128], [64 + 128 + 128 + 3, 128, 128, 256],
                      [64 + 128 + 128 + 3, 128, 128, 256]])),
            ("PointnetSAModule_0", PointnetSAModule, dict(mlp=[128 + 256 + 256 + 3, 256, 512,
                                                               1024])),
        ]
        return [(n, None if kw is None else cls(**spec, **kw)) for n, cls, spec in specs]
