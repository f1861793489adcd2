"""The cross-diffusion denoisers.

Port of ``difffacto_tpu/models/denoiser.py:TransformerNet`` (the reference's
attention.py:309-440): per-point tokens (x_t ++ per-point params ++ class
one-hot) cross-attend to the 4 part tokens (part code ++ params ++ class ++
t-embedding) through ``depth`` blocks. With single-attention blocks the trunk
runs deterministically as one call of ``ops/fused_core.fused_core``; with
``train=True`` as one call of ``ops/fused_core_train.fused_trunk_train``
(proj_in outside, dropout inside, a backward kernel behind it): the CUDA
kernels on the card, their plain versions on the CPU. proj_out is applied
after the trunk with a matrix product, as in the JAX default (tail not fused).
With two-attention blocks (``single_attn=False``) the blocks run one by one,
each ending in ``FusedLNFF``, as the JAX package runs them
(``denoiser.py:301-309``); generation only.

And of ``UNet`` (``denoiser.py:381-434``), forward only: GroupNorm + SiLU +
proj_in, a time-embedding MLP, then per level a scale-shift LayerNorm, a
flat block that cross-attends to the part tokens (``ops/fused_block`` where
it qualifies) and, with a language code, one that attends to it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.attention import BasicTransformerBlock, TwoAttentionBlock
from ..nn.functional import ln_affine
from ..nn.layers import (Dense, FeedForward, GroupNorm, LayerNorm, default_generator,
                         timestep_embedding)
from ..ops.fused_core import fused_core
from ..ops.fused_core_train import fused_trunk_train
from ..utils.device import resolve_device
from ..utils.registry import NETS

T_DIM = 256  # width of the t-embedding appended to every context token


@NETS.register_module()
class TransformerNet(nn.Module):
    """Arguments mirror the JAX module; t added to x, the class embedding
    added to the context and ``use_checkpoint`` raise ``NotImplementedError``,
    as does ``train=True`` with two-attention blocks.

    forward(x (B, N, in_channels), t (B,), ctx (B, K, context_dim),
    anchors/variances (B, N, 3), seg_mask (B, N) int, valid_id (B, K),
    train=False, generator=None). With ``train=True`` and dropout > 0 the
    ``generator`` (the "dropout" stream) gives ``time_embed`` its mask and
    the trunk its seed.
    """

    def __init__(self, in_channels: int, out_channels: int, n_heads: int, d_head: int,
                 depth: int = 1, dropout: float = 0.0, context_dim=None, n_class: int = 4,
                 class_cond: bool = False, cat_params_to_x: bool = False,
                 cat_class_to_x: bool = False, single_attn: bool = False,
                 mask_out_unreferenced_code: bool = True, add_class_cond: bool = False,
                 add_t_to_x: bool = False, res: bool = False, include_std: bool = False,
                 use_checkpoint: bool = False, *, dtype=None, device="cuda", generator=None):
        super().__init__()
        device = resolve_device(device)
        if add_t_to_x or add_class_cond or context_dim is None:
            raise NotImplementedError(
                "TransformerNet is ported with a context, add_t_to_x=False and "
                "add_class_cond=False"
            )
        if use_checkpoint:
            raise NotImplementedError(
                "use_checkpoint=True is not ported: the JAX package cannot run it either "
                "(its nn.remat marks y static, not deterministic: denoiser.py:130)"
            )
        g = default_generator(generator)
        self.n_heads, self.d_head, self.n_class = n_heads, d_head, n_class
        self.class_cond, self.cat_params_to_x = class_cond, cat_params_to_x
        self.cat_class_to_x, self.mask_out_unreferenced_code = cat_class_to_x, mask_out_unreferenced_code
        self.res, self.include_std, self.dtype, self.dropout = res, include_std, dtype, dropout
        self.single_attn = single_attn
        inner = n_heads * d_head
        in_ch = in_channels + (6 if cat_params_to_x else 0) + (n_class if cat_class_to_x else 0)
        ctx_dim = context_dim + (n_class if class_cond else 0) + T_DIM
        kw = dict(dtype=dtype, device=device)
        self.time_embed = FeedForward(T_DIM, dropout=dropout, generator=g, **kw)
        self.proj_in = Dense(in_ch, inner, generator=g, **kw)
        self.proj_out = Dense(inner, out_channels, zero_kernel=(in_ch == out_channels or res),
                              generator=g, **kw)
        self.pre_norm = LayerNorm(inner, **kw)
        self.post_norm = LayerNorm(inner, **kw)
        self.blocks = nn.ModuleList(
            BasicTransformerBlock(inner, n_heads, d_head, context_dim=ctx_dim, dropout=dropout,
                                  generator=g, **kw)
            if single_attn
            else TwoAttentionBlock(inner, n_heads, d_head, context_dim=ctx_dim, generator=g, **kw)
            for _ in range(depth)
        )

    def _stacked(self, name: str, dtype) -> torch.Tensor:
        return torch.stack([getattr(b, name) for b in self.blocks]).to(dtype)

    def _proj_in(self, x, cdt):
        return x.to(cdt) @ self.proj_in.kernel.to(cdt) + self.proj_in.bias.to(cdt)

    def _two_attention_trunk(self, x, ctx, valid_id, cdt):
        """proj_in -> pre-LN -> the blocks one by one -> post-LN
        (``denoiser.py:301-308``)."""
        mask = valid_id if self.mask_out_unreferenced_code else None
        h = ln_affine(self._proj_in(x, cdt), self.pre_norm.scale, self.pre_norm.bias)
        for blk in self.blocks:
            h = blk(h, ctx, mask)
        return ln_affine(h, self.post_norm.scale, self.post_norm.bias)

    def _train_trunk(self, x, k, v, mask, cdt, generator):
        """proj_in, then the trainable trunk (``denoiser.py:256-298``): the
        f32 master parameters go in stacked, the function casts them, and
        their gradients come back through ``torch.stack``."""
        h0 = self._proj_in(x, cdt)
        if self.dropout > 0.0:
            if generator is None:
                raise ValueError("the trunk's dropout seed needs the 'dropout' torch.Generator")
            seed = torch.randint(0, 2**31 - 1, (1,), generator=generator, device=x.device)
        else:
            seed = torch.zeros(1, dtype=torch.int64, device=x.device)
        f32 = torch.float32
        return fused_trunk_train(
            seed, h0.contiguous(), k, v, mask.contiguous(),
            self.pre_norm.scale, self.pre_norm.bias, self.post_norm.scale, self.post_norm.bias,
            self._stacked("norm2_scale", f32), self._stacked("norm2_bias", f32),
            self._stacked("wq", f32), self._stacked("wout", f32), self._stacked("bout", f32),
            self._stacked("ffn_ln_scale", f32), self._stacked("ffn_ln_bias", f32),
            self._stacked("ffn_w1", f32), self._stacked("ffn_b1", f32),
            self._stacked("ffn_w2", f32), self._stacked("ffn_b2", f32),
            self.d_head**-0.5, float(self.dropout),
        )

    def forward(self, x, t, ctx, anchors=None, variances=None, seg_mask=None, valid_id=None,
                train: bool = False, generator=None):
        B, N = x.shape[:2]
        cdt = self.dtype or x.dtype
        if self.class_cond:
            eye = torch.eye(self.n_class, dtype=ctx.dtype, device=ctx.device)
            ctx = torch.cat([ctx, eye.expand(B, -1, -1)], dim=-1)
        t_embed = self.time_embed(timestep_embedding(t, T_DIM), train, generator)
        ct = torch.promote_types(ctx.dtype, t_embed.dtype)
        ctx = torch.cat([ctx.to(ct), t_embed[:, None].expand(B, ctx.shape[1], -1).to(ct)], dim=-1)

        if self.cat_params_to_x:
            var_feat = torch.sqrt(variances) if self.include_std else variances
            x = torch.cat([x, anchors.to(x.dtype), var_feat.to(x.dtype)], dim=-1)
        if self.cat_class_to_x:
            x = torch.cat([x, F.one_hot(seg_mask.long(), self.n_class).to(x.dtype)], dim=-1)
        x_in = x

        if not self.single_attn:
            if train:
                raise NotImplementedError(
                    "TransformerNet with two-attention blocks is ported for generation only")
            h = self._two_attention_trunk(x, ctx, valid_id, cdt)
        else:
            h = self._single_attention_trunk(x, ctx, valid_id, cdt, train, generator)
        out = (h.to(cdt) @ self.proj_out.kernel.to(cdt) + self.proj_out.bias.to(cdt)).to(x.dtype)
        if x_in.shape[-1] == out.shape[-1]:
            return out + x_in
        if self.res:
            return out + x_in[..., : out.shape[-1]]
        return out

    def _single_attention_trunk(self, x, ctx, valid_id, cdt, train, generator):
        """The whole trunk as one kernel call: ``fused_core`` deterministically,
        ``fused_trunk_train`` in training."""
        B = x.shape[0]
        M = ctx.shape[1]
        ctx_c = ctx.to(cdt)
        k = torch.einsum("bmc,icd->ibmd", ctx_c, self._stacked("wk", cdt)).contiguous()
        v = torch.einsum("bmc,icd->ibmd", ctx_c, self._stacked("wv", cdt)).contiguous()
        if self.mask_out_unreferenced_code:
            mask = valid_id.float()
        else:
            mask = torch.ones(B, M, device=x.device)
        f32 = torch.float32
        if train:
            return self._train_trunk(x, k, v, mask, cdt, generator)
        return fused_core(
            x.to(cdt).contiguous(), self.proj_in.kernel.to(cdt), self.proj_in.bias.to(f32),
            k, v, mask.contiguous(),
            self.pre_norm.scale.to(cdt), self.pre_norm.bias.to(cdt),
            self.post_norm.scale.to(cdt), self.post_norm.bias.to(cdt),
            self._stacked("norm2_scale", cdt), self._stacked("norm2_bias", cdt),
            self._stacked("wq", cdt), self._stacked("wout", cdt), self._stacked("bout", f32),
            self._stacked("ffn_ln_scale", cdt), self._stacked("ffn_ln_bias", cdt),
            self._stacked("ffn_w1", cdt), self._stacked("ffn_b1", f32),
            self._stacked("ffn_w2", cdt), self._stacked("ffn_b2", f32),
            self.d_head**-0.5,
        )


@NETS.register_module()
class UNet(nn.Module):
    """The 1D attention "UNet" denoiser (``difffacto_tpu/models/denoiser.py:381-434``,
    the reference's nets/unet.py:296-341), forward only.

    forward(x (B, N, in_channels), t (B,), ctx (B, K, prior_dim): the part
    tokens, valid_id (B, K) or None, language_code (B, L, language_dim) or
    None). GroupNorm (eps 1e-6, min(32, C) groups) and SiLU before proj_in;
    the time embedding through two Dense layers; per level a LayerNorm
    without a dtype (so the hidden state is f32) scaled and shifted by the
    embedding, then ``prior_blocks[i]`` on the part tokens and, when the
    model is built with ``language_cond``, ``lang_blocks[i]`` on the language
    code; proj_out starts at zero and the input is added back. The flat
    blocks take ``ops/fused_block`` where they qualify. As the JAX blocks take
    their context width from the context itself, ``prior_dim`` and
    ``language_dim`` must be the widths of ctx and language_code.
    """

    def __init__(self, in_channels: int, n_heads: int, d_head: int, depth: int = 1,
                 embed_dim: int = 128, dropout: float = 0.0, prior_dim: int = 512,
                 language_dim: int = 64, language_cond: bool = False,
                 *, dtype=None, device="cuda", generator=None):
        super().__init__()
        device = resolve_device(device)
        g = default_generator(generator)
        self.embed_dim, self.language_cond = embed_dim, language_cond
        inner = n_heads * d_head
        kw = dict(dtype=dtype, device=device)
        self.group_norm = GroupNorm(min(32, in_channels), in_channels, device=device)
        self.proj_in = Dense(in_channels, inner, generator=g, **kw)
        self.dense0 = Dense(embed_dim, embed_dim, generator=g, **kw)
        self.dense1 = Dense(embed_dim, embed_dim, generator=g, **kw)
        self.emb = nn.ModuleList(Dense(embed_dim, 2 * inner, generator=g, **kw)
                                 for _ in range(depth))
        self.ln = nn.ModuleList(LayerNorm(inner, device=device) for _ in range(depth))

        def blocks(cdim):
            return nn.ModuleList(
                BasicTransformerBlock(inner, n_heads, d_head, context_dim=cdim, dropout=dropout,
                                      generator=g, **kw)
                for _ in range(depth))

        self.prior_blocks = blocks(prior_dim)
        self.lang_blocks = blocks(language_dim) if language_cond else None
        self.proj_out = Dense(inner, in_channels, zero_kernel=True, generator=g, **kw)

    def forward(self, x, t, ctx, anchors=None, variances=None, seg_mask=None, valid_id=None,
                language_code=None, train: bool = False, generator=None):
        if train:
            raise NotImplementedError("UNet is ported for generation only (train=False)")
        if ctx is None or (language_code is not None) != self.language_cond:
            raise ValueError("UNet takes the part tokens, and a language code exactly when "
                             "it was built with language_cond=True")
        silu = torch.nn.functional.silu
        h = self.proj_in(silu(self.group_norm(x)))
        emb = self.dense1(silu(self.dense0(timestep_embedding(t, self.embed_dim))))
        for i, prior_block in enumerate(self.prior_blocks):
            scale, shift = self.emb[i](silu(emb)).chunk(2, dim=-1)
            h = self.ln[i](h) * (1 + scale[:, None]) + shift[:, None]
            h = prior_block(h, ctx, valid_id)
            if self.lang_blocks is not None:
                h = self.lang_blocks[i](h, language_code)
        return self.proj_out(h) + x
