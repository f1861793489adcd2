"""The cross-diffusion denoiser.

Port of ``difffacto_tpu/models/denoiser.py:TransformerNet`` (the reference's
attention.py:309-440): per-point tokens (x_t ++ per-point params ++ class
one-hot) cross-attend to the 4 part tokens (part code ++ params ++ class ++
t-embedding) through ``depth`` single-attention blocks. Deterministically
the trunk runs as one call of ``ops/fused_core.fused_core``; with
``train=True`` as one call of ``ops/fused_core_train.fused_trunk_train``
(proj_in outside, dropout inside, a backward kernel behind it): the CUDA
kernels on the card, their plain versions on the CPU. proj_out is applied
after the trunk with a matrix product, as in the JAX default (tail not fused).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.attention import BasicTransformerBlock
from ..nn.layers import Dense, FeedForward, LayerNorm, default_generator, timestep_embedding
from ..ops.fused_core import fused_core
from ..ops.fused_core_train import fused_trunk_train
from ..utils.device import resolve_device
from ..utils.registry import NETS

T_DIM = 256  # width of the t-embedding appended to every context token


@NETS.register_module()
class TransformerNet(nn.Module):
    """Arguments mirror the JAX module; the options the generation path does
    not use (two attentions per block, t added to x, class embedding added to
    the context) raise ``NotImplementedError``.

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
                 *, dtype=None, device="cuda", generator=None):
        super().__init__()
        device = resolve_device(device)
        if not single_attn or add_t_to_x or add_class_cond or context_dim is None:
            raise NotImplementedError(
                "TransformerNet is ported for single_attn=True with a context, "
                "add_t_to_x=False and add_class_cond=False"
            )
        g = default_generator(generator)
        self.n_heads, self.d_head, self.n_class = n_heads, d_head, n_class
        self.class_cond, self.cat_params_to_x = class_cond, cat_params_to_x
        self.cat_class_to_x, self.mask_out_unreferenced_code = cat_class_to_x, mask_out_unreferenced_code
        self.res, self.include_std, self.dtype, self.dropout = res, include_std, dtype, dropout
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
            for _ in range(depth)
        )

    def _stacked(self, name: str, dtype) -> torch.Tensor:
        return torch.stack([getattr(b, name) for b in self.blocks]).to(dtype)

    def _train_trunk(self, x, k, v, mask, cdt, generator):
        """proj_in, then the trainable trunk (``denoiser.py:256-298``): the
        f32 master parameters go in stacked, the function casts them, and
        their gradients come back through ``torch.stack``."""
        h0 = x.to(cdt) @ self.proj_in.kernel.to(cdt) + self.proj_in.bias.to(cdt)
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
            h = self._train_trunk(x, k, v, mask, cdt, generator)
        else:
            h = fused_core(
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
        out = (h @ self.proj_out.kernel.to(cdt) + self.proj_out.bias.to(cdt)).to(x.dtype)
        if x_in.shape[-1] == out.shape[-1]:
            return out + x_in
        if self.res:
            return out + x_in[..., : out.shape[-1]]
        return out
