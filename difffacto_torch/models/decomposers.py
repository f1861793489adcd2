"""Decomposers: part-token mixers that give a global code and the anchors.

Port of ``difffacto_tpu/models/decomposers.py`` (the reference's
decomposers/mixer.py, transformer.py and common.py), channel-last:

* ``MultiHeadSelfAttention`` (projections only: no output projection, no
  residual), ``GraphAttentionLayer`` and ``GAT`` (heads ``attention_{i}``
  concatenated);
* ``ComponentMixer`` (and ``ComponentMixerV2``, attention on by default):
  part latents (B, K, C) -> (global code, anchors (B, K, 3), mixed latents),
  the anchors by ``mlp_type`` 0 (a flat MLP) or 1 (a per-token MLP, a max,
  a regressor), the mixing by pre-LN GAT or MHSA and the unfused GEGLU
  ``FeedForward``, the global code by ``global_mlp_type`` 0 (a flat MLP) or
  1 (BatchNorm'd per-token layers, a max, an MLP);
* ``PartCodeTransformer`` (and ``V2``): ViT residual blocks over the part
  tokens (fused qkv, the double square-root score scale, an f32 softmax, an
  exact-erf GELU MLP).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import MLP, Dense, FeedForward, LayerNorm, TorchBatchNorm, default_generator, param
from ..utils.device import resolve_device
from ..utils.registry import DECOMPOSERS


def _kw(dtype, device, generator):
    return dict(dtype=dtype, device=resolve_device(device), generator=default_generator(generator))


class MultiHeadSelfAttention(nn.Module):
    """x (B, N, in_channel) -> (B, N, out_channel) (``decomposers.py:29-57``):
    softmax(Q K^T / sqrt(qk_dim / nheads)) V a head, the heads concatenated."""

    def __init__(self, in_channel: int, out_channel: int, qk_dim: int = 512, nheads: int = 8,
                 qkv_bias: bool = True, scale: bool = True, **kw):
        super().__init__()
        self.nheads, self.qk_dim, self.out_channel = nheads, qk_dim, out_channel
        self.scale = 1.0 / math.sqrt(qk_dim // nheads) if scale else 1.0
        self.Wq = Dense(in_channel, qk_dim, use_bias=qkv_bias, **kw)
        self.Wk = Dense(in_channel, qk_dim, use_bias=qkv_bias, **kw)
        self.Wv = Dense(in_channel, out_channel, use_bias=qkv_bias, **kw)

    def forward(self, x):
        B, N, _ = x.shape
        h = self.nheads
        q = self.Wq(x).reshape(B, N, h, -1)
        k = self.Wk(x).reshape(B, N, h, -1)
        v = self.Wv(x).reshape(B, N, h, -1)
        w = torch.softmax(torch.einsum("bnhd,bmhd->bhnm", q, k) * self.scale, dim=-1)
        return torch.einsum("bhnm,bmhd->bnhd", w, v).reshape(B, N, self.out_channel)


def _xavier(shape, g):
    """flax ``variance_scaling(2.0, "fan_avg", "uniform")`` (the reference's
    xavier_uniform with gain 1.414)."""
    limit = math.sqrt(3.0 * 2.0 / ((shape[0] + shape[1]) / 2.0))
    return (torch.rand(shape, generator=g) * 2.0 - 1.0) * limit


class GraphAttentionLayer(nn.Module):
    """The dense GAT layer (``decomposers.py:60-83``): leaky-ReLU scores of
    the learned 2 out vector ``a`` over W x, a softmax over the neighbours,
    then ELU."""

    def __init__(self, in_features: int, out_features: int, alpha: float = 0.2,
                 *, device="cuda", generator=None):
        super().__init__()
        g = default_generator(generator)
        self.alpha, self.out_features = alpha, out_features
        self.W = param(_xavier((in_features, out_features), g), device)
        self.a = param(_xavier((2 * out_features, 1), g), device)

    def forward(self, x):
        wh = x @ self.W
        e1 = wh @ self.a[: self.out_features]
        e2 = wh @ self.a[self.out_features:]
        e = F.leaky_relu(e1 + e2.transpose(1, 2), self.alpha)
        return F.elu(torch.softmax(e, dim=2) @ wh)


class GAT(nn.Module):
    """``nheads`` GAT layers ``attention_{i}``, concatenated (``:86-101``)."""

    def __init__(self, in_channel: int, out_channel: int, nheads: int = 8, alpha: float = 0.2,
                 *, device="cuda", generator=None):
        super().__init__()
        self.nheads = nheads
        for i in range(nheads):
            setattr(self, f"attention_{i}",
                    GraphAttentionLayer(in_channel, out_channel // nheads, alpha, device=device,
                                        generator=generator))

    def forward(self, x):
        return torch.cat([getattr(self, f"attention_{i}")(x) for i in range(self.nheads)], dim=2)


def _unit(x):
    return x / torch.clamp(x.norm(dim=-1, keepdim=True), min=1e-12)


@DECOMPOSERS.register_module()
class ComponentMixer(nn.Module):
    """part latents (B, K, C) -> (global code (B, C) or None, anchors
    (B, K, point_dim), mixed latents (B, K, C)) (``decomposers.py:104-216``).
    ``global_mlp_type`` 1 needs C = 256, as the reference's layout does."""

    def __init__(self, num_anchors: int, part_latent_dim: int, point_dim: int = 3,
                 include_attention: bool = False, nheads: int = 8,
                 use_graph_attention: bool = True, include_global_feature: bool = False,
                 global_mlp_type: int = 0, normalize_latent: bool = False, mlp_type: int = 0,
                 res: bool = True, attn_ln: bool = True,
                 *, dtype=None, device="cuda", generator=None):
        super().__init__()
        kw = _kw(dtype, device, generator)
        dev, bn = kw["device"], dict(dtype=dtype, device=kw["device"])
        K, C, KP = num_anchors, part_latent_dim, num_anchors * point_dim
        self.num_anchors, self.point_dim, self.mlp_type = num_anchors, point_dim, mlp_type
        self.include_attention, self.res, self.attn_ln = include_attention, res, attn_ln
        self.include_global_feature, self.global_mlp_type = include_global_feature, global_mlp_type
        self.normalize_latent = normalize_latent
        if mlp_type == 0:
            self.mlp = MLP(K * C, (1024, 1024, KP), **kw)
        else:
            self.mlp_c1, self.mlp_c2 = Dense(C, 256, **kw), Dense(256, C, **kw)
            self.reg_c1, self.reg_c2 = Dense(C, 128, **kw), Dense(128, KP, **kw)
        if include_attention:
            self.attention = (GAT(C, C, nheads, device=dev, generator=kw["generator"])
                              if use_graph_attention else MultiHeadSelfAttention(C, C, nheads=nheads,
                                                                                 **kw))
            if attn_ln:
                self.norm1, self.norm2 = LayerNorm(C, device=dev), LayerNorm(C, device=dev)
            self.ff = FeedForward(C, glu=True, **kw)
        if include_global_feature:
            if global_mlp_type == 0:
                self.aggregator = MLP(K * C, (1024, 1024, C), **kw)
            else:
                self.agg_bn0 = TorchBatchNorm(C, **bn)
                self.agg_c1, self.agg_bn1 = Dense(C, 256, **kw), TorchBatchNorm(256, **bn)
                self.agg_c2 = Dense(256, C, **kw)
                self.agg_m1, self.agg_mbn1 = Dense(C, 256, **kw), TorchBatchNorm(256, **bn)
                self.agg_m2, self.agg_mbn2 = Dense(256, 256, **kw), TorchBatchNorm(256, **bn)
                self.agg_m3 = Dense(256, C, **kw)

    def forward(self, part_latent, train: bool = False):
        B = part_latent.shape[0]
        shape = (B, self.num_anchors, self.point_dim)
        if self.mlp_type == 0:
            coarse = self.mlp(part_latent.reshape(B, -1)).reshape(shape)
        else:
            h = self.mlp_c2(torch.relu(self.mlp_c1(torch.relu(part_latent))))
            r = self.reg_c1(torch.relu(h.amax(dim=1)))
            coarse = self.reg_c2(torch.relu(r)).reshape(shape)

        h = part_latent
        if self.include_attention:
            a = self.attention(self.norm1(h) if self.attn_ln else h)
            h = a + h if self.res else a
            f = self.ff(self.norm2(h) if self.attn_ln else h)
            h = f + h if self.res else f

        g = None
        if self.include_global_feature:
            if self.global_mlp_type == 0:
                g = self.aggregator(h.reshape(B, -1))
            else:
                g = self.agg_c1(torch.relu(self.agg_bn0(h, train)))
                g = self.agg_c2(torch.relu(self.agg_bn1(g, train))).amax(dim=1)
                g = torch.relu(self.agg_mbn1(self.agg_m1(g), train))
                g = torch.relu(self.agg_mbn2(self.agg_m2(g), train))
                g = self.agg_m3(g)
        if self.normalize_latent:
            g = _unit(g) if g is not None else None
            h = _unit(h)
        return g, coarse, h


@DECOMPOSERS.register_module()
class ComponentMixerV2(ComponentMixer):
    """``ComponentMixer`` with attention on by default (``:219-223``)."""

    def __init__(self, num_anchors: int, part_latent_dim: int, point_dim: int = 3,
                 include_attention: bool = True, nheads: int = 8,
                 use_graph_attention: bool = True, include_global_feature: bool = False,
                 global_mlp_type: int = 0, normalize_latent: bool = False, mlp_type: int = 0,
                 res: bool = True, attn_ln: bool = True,
                 *, dtype=None, device="cuda", generator=None):
        super().__init__(num_anchors, part_latent_dim, point_dim, include_attention, nheads,
                         use_graph_attention, include_global_feature, global_mlp_type,
                         normalize_latent, mlp_type, res, attn_ln, dtype=dtype, device=device,
                         generator=generator)


class _VitMLP(nn.Module):
    """width -> 4 width, exact (erf) GELU, -> width (``:226-238``)."""

    def __init__(self, width: int, **kw):
        super().__init__()
        self.c_fc, self.c_proj = Dense(width, 4 * width, **kw), Dense(4 * width, width, **kw)

    def forward(self, x):
        return self.c_proj(F.gelu(self.c_fc(x)))


class _VitAttention(nn.Module):
    """Fused-qkv attention, [q | k | v] a head, q and k each scaled by
    ch^-1/4, masked keys at the dtype's lowest value, an f32 softmax
    (``:241-263``)."""

    def __init__(self, width: int, heads: int, **kw):
        super().__init__()
        self.heads = heads
        self.c_qkv, self.c_proj = Dense(width, 3 * width, **kw), Dense(width, width, **kw)

    def forward(self, x, mask=None):
        B, N, W = x.shape
        ch = W // self.heads
        q, k, v = self.c_qkv(x).reshape(B, N, self.heads, 3 * ch).chunk(3, dim=-1)
        scale = 1.0 / math.sqrt(math.sqrt(ch))
        w = torch.einsum("bthc,bshc->bhts", q * scale, k * scale)
        if mask is not None:
            w = torch.where(mask[:, None, None, :].bool(), w,
                            torch.full((), torch.finfo(w.dtype).min, dtype=w.dtype, device=w.device))
        w = torch.softmax(w.float(), dim=-1).to(v.dtype)
        return self.c_proj(torch.einsum("bhts,bshc->bthc", w, v).reshape(B, N, -1))


class _ResidualAttentionBlock(nn.Module):
    """x + attn(ln_1(x)), then x + mlp(ln_2(x)) (``:266-281``); the weight
    bridge names the LayerNorms ``ln.1`` and ``ln.2``."""

    def __init__(self, width: int, heads: int, **kw):
        super().__init__()
        dev = kw["device"]
        self.attn, self.mlp = _VitAttention(width, heads, **kw), _VitMLP(width, **kw)
        self.ln = nn.ModuleDict({"1": LayerNorm(width, device=dev), "2": LayerNorm(width, device=dev)})

    def forward(self, x, mask=None):
        x = x + self.attn(self.ln["1"](x), mask)
        return x + self.mlp(self.ln["2"](x))


class _ClassEmbedding(nn.Module):
    """flax ``nn.Embed(n, n)`` read at arange(n): its whole table."""

    def __init__(self, n: int, g, device):
        super().__init__()
        self.embedding = param(torch.randn(n, n, generator=g) / math.sqrt(n), device)


@DECOMPOSERS.register_module()
class PartCodeTransformer(nn.Module):
    """x (B, K, input_channels), params: (B, K, .) tensors, mask (B, K) ->
    (global code (B, width), codes (B, K, output_channels))
    (``decomposers.py:284-346``): [x | params | class embedding] ->
    input_proj -> ln_pre -> ``layers`` residual blocks -> ln_post ->
    output_proj (starting at zero); the codes of absent parts are zeroed and
    the global code is ``aggregate`` of the masked max of the codes where
    output_channels = width, else of the hidden state, as the JAX module
    falls back. With ``param_cond`` the params given must be ``param_dim``
    wide together, as the port sizes input_proj when it builds it."""

    def __init__(self, input_channels: int = 3, output_channels: int = 3, n_ctx: int = 4,
                 width: int = 512, layers: int = 12, heads: int = 8, class_cond: bool = True,
                 param_cond: bool = True, param_dim: int = 6,
                 use_mask_in_transformer: bool = False,
                 *, dtype=None, device="cuda", generator=None):
        super().__init__()
        kw = _kw(dtype, device, generator)
        dev = kw["device"]
        self.n_ctx, self.width, self.output_channels = n_ctx, width, output_channels
        self.class_cond, self.param_cond = class_cond, param_cond
        self.use_mask_in_transformer, self.layers = use_mask_in_transformer, layers
        in_ch = input_channels + (param_dim if param_cond else 0) + (n_ctx if class_cond else 0)
        if class_cond:
            self.class_embedding = _ClassEmbedding(n_ctx, kw["generator"], dev)
        self.input_proj = Dense(in_ch, width, **kw)
        self.ln_pre = LayerNorm(width, device=dev)
        for i in range(layers):
            setattr(self, f"resblocks_{i}", _ResidualAttentionBlock(width, heads, **kw))
        self.ln_post = LayerNorm(width, device=dev)
        self.output_proj = Dense(width, output_channels, zero_kernel=True, **kw)
        self.aggregate = _VitMLP(width, **kw)

    def forward(self, x, params=(), mask=None, train: bool = False):
        B, K, _ = x.shape
        if self.param_cond and params:
            x = torch.cat([x, *params], dim=-1)
        if self.class_cond:
            emb = self.class_embedding.embedding
            x = torch.cat([x, emb[None].expand(B, K, self.n_ctx).to(x.dtype)], dim=-1)
        h = self.ln_pre(self.input_proj(x))
        attn_mask = mask if self.use_mask_in_transformer else None
        for i in range(self.layers):
            h = getattr(self, f"resblocks_{i}")(h, attn_mask)
        h = self.ln_post(h)
        codes = self.output_proj(h)
        if mask is not None:
            codes = codes * mask[..., None]
        src = codes if self.output_channels == self.width else h
        if mask is not None:
            m = mask[..., None]
            src = (codes + (1 - m) * -1e5 if self.output_channels == self.width
                   else h * m + (1 - m) * -1e5)
        return self.aggregate(src.amax(dim=1)), codes


@DECOMPOSERS.register_module()
class PartCodeTransformerV2(nn.Module):
    """``PartCodeTransformer`` (``inner``) giving output_channels / n_ctx a
    token, the K codes flattened to one vector (``:349-370``), through the
    ViT MLP ``post_mlp`` where asked; returns (z, z)."""

    def __init__(self, input_channels: int = 3, output_channels: int = 3, n_ctx: int = 4,
                 width: int = 512, layers: int = 12, heads: int = 8, class_cond: bool = True,
                 param_cond: bool = True, param_dim: int = 6,
                 use_mask_in_transformer: bool = False, post_mlp: bool = False,
                 *, dtype=None, device="cuda", generator=None):
        super().__init__()
        if output_channels % n_ctx:
            raise ValueError(f"output_channels {output_channels} is not a multiple of n_ctx {n_ctx}")
        kw = _kw(dtype, device, generator)
        self.output_channels = output_channels
        self.inner = PartCodeTransformer(input_channels, output_channels // n_ctx, n_ctx, width,
                                         layers, heads, class_cond, param_cond, param_dim,
                                         use_mask_in_transformer, **kw)
        self.post_mlp = _VitMLP(output_channels, **kw) if post_mlp else None

    def forward(self, x, params=(), mask=None, train: bool = False):
        _, codes = self.inner(x, params, mask, train)
        flat = codes.reshape(x.shape[0], self.output_channels)
        z = self.post_mlp(flat) if self.post_mlp is not None else flat
        return z, flat
