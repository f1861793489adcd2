"""The cross-diffusion denoisers.

Port of ``difffacto_tpu/models/denoiser.py:TransformerNet`` (the reference's
attention.py:309-440): per-point tokens (x_t ++ per-point params ++ class
one-hot) cross-attend to the 4 part tokens (part code ++ params ++ class ++
t-embedding) through ``depth`` blocks. With single-attention blocks at the
shapes of ``trunk_kernel_takes`` (inner width 128, 8 heads, 4 part tokens) the
trunk runs deterministically as one call of ``ops/fused_core.fused_core``;
with ``train=True`` as one call of ``ops/fused_core_train.fused_trunk_train``
(proj_in outside, dropout inside, a backward kernel behind it): the CUDA
kernels on the card, their plain versions on the CPU. With ``add_t_to_x`` the
time embedding (as wide as the trunk) biases the projected h0 instead of
joining the context, and generation runs the kernel's head-less entry
(``ops/fused_core.fused_core_headless``), as the JAX denoiser leaves proj_in
out of its kernel then (``denoiser.py:244-258``). At any other shape the
blocks run one by one, as with two-attention blocks. proj_out is applied
after the trunk with a matrix product, as in the JAX default (tail not fused).
Generation reads the JAX denoiser's two switches at every call
(``denoiser.py:244-252``): ``DIFFFACTO_FUSE_TAIL=1`` fuses proj_out into the
trunk kernel (``fused_core_tail``, or ``fused_core_headless_tail`` without
the head), and ``DIFFFACTO_FUSE_HEAD=0`` applies proj_in outside the kernel
and runs the head-less entry. Their defaults are the JAX package's: head
fused, tail not. Training reads neither.
With two-attention blocks (``single_attn=False``) generation at those shapes,
without ``add_t_to_x``, runs the trunk as one call of
``ops/fused_core.fused_core_two_attn`` (the kernel's two-attention form, with
the head fused and proj_out outside; it reads neither switch); the JAX
package has no such kernel and runs the blocks one by one, each ending in
``FusedLNFF`` (``denoiser.py:301-309``), as the port still does at every
other shape, with ``add_t_to_x``, and in training, there with the unfused
math and dropout, as the JAX package trains them.

And of ``UNet`` (``denoiser.py:381-434``): GroupNorm + SiLU + proj_in, a
time-embedding MLP, then per level a scale-shift LayerNorm, a flat block
that cross-attends to the part tokens (``ops/fused_block`` where it qualifies
and no training is asked for; the unfused math with dropout in training) and,
with a language code, one that attends to it.

And of ``PointwiseNet`` (``denoiser.py:490-530``), the concat-squash MLP that
per-part pretraining conditions on one part token, with its
``ConcatSquashDense`` layers (``:436-446``), and ``PointwiseNet2``
(``:449-487``), which conditions each point on its own part's token.

And of the latent denoisers over the K part tokens: ``LDMNet``
(``denoiser.py:312-379``), whose blocks are ``transformer_block``'s, and
``PointwiseNetLatent`` (``:535-574``), concat-squash with a condition a token.
"""

from __future__ import annotations

import os
from operator import attrgetter

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.attention import BasicTransformerBlock, transformer_block
from ..nn.functional import ln_affine
from ..nn.layers import (Dense, FeedForward, GroupNorm, LayerNorm, default_generator,
                         timestep_embedding)
from ..ops.fused_block import takes as trunk_kernel_takes
from ..ops.fused_core import (fused_core, fused_core_headless, fused_core_headless_tail,
                              fused_core_tail, fused_core_two_attn)
from ..ops.fused_core_train import fused_trunk_train
from ..utils.device import kernel_dtype, resolve_device
from ..utils.registry import NETS

T_DIM = 256  # width of the t-embedding appended to every context token

# The two-attention trunk's per-block operands by their path in a block
# (``TransformerBlock``): K and V of attn2 and of attn1; attn2's half and the
# FF, then attn1's half, in the entry's argument order. The biases go in as f32.
_TWO_KV_PATHS = ("attn2.to_k.kernel", "attn2.to_v.kernel", "attn1.to_k.kernel",
                 "attn1.to_v.kernel")
_TWO_BLOCK_PATHS = ("norm2.scale", "norm2.bias", "attn2.to_q.kernel", "attn2.to_out.kernel",
                    "attn2.to_out.bias", "ffn.ln_scale", "ffn.ln_bias", "ffn.w1", "ffn.b1",
                    "ffn.w2", "ffn.b2")
_ATTN1_PATHS = ("norm1.scale", "norm1.bias", "attn1.to_q.kernel", "attn1.to_out.kernel",
                "attn1.to_out.bias")
_F32_PATHS = {"attn2.to_out.bias", "ffn.b1", "ffn.b2", "attn1.to_out.bias"}


@NETS.register_module()
class TransformerNet(nn.Module):
    """Arguments mirror the JAX module. ``use_checkpoint`` raises
    ``NotImplementedError``, and so does a net without ``context_dim``: the
    JAX module reads its context at every call. ``add_class_cond`` leaves out the class one-hot of
    the context (``denoiser.py:91``); the JAX module adds no class embedding
    in its place.

    forward(x (B, N, in_channels), t (B,), ctx (B, K, context_dim) or a list
    or tuple of tensors concatenated on the last axis,
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
        if context_dim is None:
            raise NotImplementedError(
                "TransformerNet without context_dim: the JAX module cannot run without a "
                "context either (difffacto_tpu/models/denoiser.py:101-102 concatenates the "
                "t-embedding to it, and :137 sizes the blocks by its width), and the port "
                "sizes K and V by context_dim when it builds them"
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
        self.single_attn, self.add_class_cond = single_attn, add_class_cond
        self.add_t_to_x = add_t_to_x
        self._kept, self._kept_stamp = {}, None  # _kept_operand's store
        inner = n_heads * d_head
        in_ch = in_channels + (6 if cat_params_to_x else 0) + (n_class if cat_class_to_x else 0)
        ctx_dim = (context_dim + (n_class if class_cond and not add_class_cond else 0)
                   + (0 if add_t_to_x else T_DIM))
        kw = dict(dtype=dtype, device=device)
        self.t_dim = inner if add_t_to_x else T_DIM
        self.time_embed = FeedForward(self.t_dim, dropout=dropout, generator=g, **kw)
        self.proj_in = Dense(in_ch, inner, generator=g, **kw)
        self.proj_out = Dense(inner, out_channels, zero_kernel=(in_ch == out_channels or res),
                              generator=g, **kw)
        self.pre_norm = LayerNorm(inner, **kw)
        self.post_norm = LayerNorm(inner, **kw)
        self.blocks = nn.ModuleList(
            transformer_block(inner, n_heads, d_head, context_dim=ctx_dim, dropout=dropout,
                              single_attn=single_attn, generator=g, **kw)
            for _ in range(depth)
        )

    def train(self, mode: bool = True):
        self._kept = {}  # a mode switch drops the kept operands (see _drop_stale_kept)
        return super().train(mode)

    def _drop_stale_kept(self):
        """Drop the operands ``_kept_operand`` keeps once a parameter of the
        net has changed since they were made: a new storage (``to``, a copy)
        or an in-place write that the parameter's version counter saw (the
        optimizer's and ``load_state_dict``'s ``copy_``, any in-place op on the
        parameter or on ``p.detach()``). A write through ``p.data`` bypasses
        that counter and is not seen: after one, call ``train()`` or
        ``eval()``, which drop the kept operands too."""
        if torch.is_grad_enabled():
            return
        stamp = tuple((p.data_ptr(), p._version) for p in self.parameters())
        if stamp != self._kept_stamp:
            self._kept, self._kept_stamp = {}, stamp

    def _kept_operand(self, key, build):
        """``build()``, kept under ``key`` outside autograd until
        ``_drop_stale_kept`` drops it, so that a chain's steps do not cast and
        stack the same weights a hundred times; built anew under autograd.
        The two-attention trunk keeps its operands so. The single-attention
        trunk casts and stacks them every step (``_stacked``): its cell reads
        a few tens of microseconds of Python a step, and keeping there read
        3% slower on the card (``PERF.md`` §7)."""
        if torch.is_grad_enabled():
            return build()
        if key not in self._kept:
            self._kept[key] = build()
        return self._kept[key]

    def _stacked(self, name: str, dtype) -> torch.Tensor:
        return torch.stack([getattr(b, name) for b in self.blocks]).to(dtype)

    def _proj_in(self, x, cdt, t_embed=None):
        """h0 = proj_in(x) in the compute dtype, with ``add_t_to_x`` biased by
        the time embedding (``denoiser.py:256-258``, ``:302-304``)."""
        h = x.to(cdt) @ self.proj_in.kernel.to(cdt) + self.proj_in.bias.to(cdt)
        return h if t_embed is None else h + t_embed.to(cdt)[:, None]

    def _block_trunk(self, x, ctx, valid_id, cdt, train=False, generator=None, t_embed=None):
        """proj_in -> pre-LN -> the blocks one by one -> post-LN
        (``denoiser.py:301-308``): the two-attention trunk in training and
        with ``add_t_to_x``, and either trunk at shapes the kernels do not take."""
        mask = valid_id if self.mask_out_unreferenced_code else None
        h = ln_affine(self._proj_in(x, cdt, t_embed), self.pre_norm.scale, self.pre_norm.bias)
        for blk in self.blocks:
            h = blk(h, ctx, mask, train, generator)
        return ln_affine(h, self.post_norm.scale, self.post_norm.bias)

    def _train_trunk(self, x, k, v, mask, cdt, generator, t_embed=None):
        """proj_in, then the trainable trunk (``denoiser.py:256-298``): the
        f32 master parameters go in stacked, the function casts them, and
        their gradients come back through ``torch.stack``."""
        h0 = self._proj_in(x, cdt, t_embed).to(kernel_dtype(x.device, cdt))
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
        if isinstance(ctx, (list, tuple)):
            ctx = torch.cat(list(ctx), dim=-1)
        if self.class_cond and not self.add_class_cond:
            eye = torch.eye(self.n_class, dtype=ctx.dtype, device=ctx.device)
            ctx = torch.cat([ctx, eye.expand(B, -1, -1)], dim=-1)
        t_embed = self.time_embed(timestep_embedding(t, self.t_dim), train, generator)
        if self.add_t_to_x:
            t_x = t_embed  # biases h0 (denoiser.py:257-258)
        else:
            t_x = None
            ct = torch.promote_types(ctx.dtype, t_embed.dtype)
            ctx = torch.cat([ctx.to(ct), t_embed[:, None].expand(B, ctx.shape[1], -1).to(ct)],
                            dim=-1)

        if self.cat_params_to_x:
            var_feat = torch.sqrt(variances) if self.include_std else variances
            x = torch.cat([x, anchors.to(x.dtype), var_feat.to(x.dtype)], dim=-1)
        if self.cat_class_to_x:
            x = torch.cat([x, F.one_hot(seg_mask.long(), self.n_class).to(x.dtype)], dim=-1)
        x_in = x

        takes = trunk_kernel_takes(self.n_heads * self.d_head, self.n_heads, ctx.shape[1])
        if self.single_attn and takes:
            out = self._single_attention_trunk(x, ctx, valid_id, cdt, train, generator, t_x)
        elif takes and not train and t_x is None:
            out = self._two_attention_trunk(x, ctx, valid_id, cdt)
        else:
            # the JAX package's per-block composition (denoiser.py:301-309)
            out = self._proj_out(self._block_trunk(x, ctx, valid_id, cdt, train, generator, t_x),
                                 cdt, x.dtype)
        if x_in.shape[-1] == out.shape[-1]:
            return out + x_in
        if self.res:
            return out + x_in[..., : out.shape[-1]]
        return out

    def _proj_out(self, h, cdt, dtype):
        return (h.to(cdt) @ self.proj_out.kernel.to(cdt) + self.proj_out.bias.to(cdt)).to(dtype)

    def _two_attention_trunk(self, x, ctx, valid_id, cdt):
        """The two-attention trunk in generation as one call of
        ``fused_core_two_attn`` (proj_in inside, proj_out after it), K and V
        of both attentions computed here once a step; its weights cast (and
        stacked over the blocks) once and kept (``_kept_operand``)."""
        self._drop_stale_kept()
        kdt = kernel_dtype(x.device, cdt)
        f32 = torch.float32

        def kept(path, dtype, blocks=True):
            def build():
                if blocks:
                    return torch.stack([attrgetter(path)(b) for b in self.blocks]).to(dtype)
                return attrgetter(path)(self).to(dtype)
            return self._kept_operand((path, dtype), build)

        ctx_c = ctx.to(cdt)
        k, v, k1, v1 = (torch.einsum("bmc,icd->ibmd", ctx_c, kept(p, cdt)).to(kdt).contiguous()
                        for p in _TWO_KV_PATHS)
        if self.mask_out_unreferenced_code:
            mask = valid_id.float().contiguous()
        else:
            mask = torch.ones(ctx.shape[:2], device=x.device)
        head = (kept("proj_in.kernel", kdt, False), kept("proj_in.bias", f32, False))
        norms = [kept(f"{n}.{w}", kdt, False) for n in ("pre_norm", "post_norm")
                 for w in ("scale", "bias")]
        w = [kept(p, f32 if p in _F32_PATHS else kdt) for p in _TWO_BLOCK_PATHS + _ATTN1_PATHS]
        n = len(_TWO_BLOCK_PATHS)
        h = fused_core_two_attn(x.to(kdt).contiguous(), *head, k, v, mask, *norms, *w[:n], k1, v1,
                                *w[n:], self.d_head**-0.5)
        return self._proj_out(h, cdt, x.dtype)

    def _single_attention_trunk(self, x, ctx, valid_id, cdt, train, generator, t_embed=None):
        """The whole trunk as one kernel call, at the shapes
        ``trunk_kernel_takes`` accepts, and proj_out: ``fused_trunk_train``
        in training; deterministically ``fused_core``, its head-less entry on
        h0 with ``add_t_to_x`` or ``DIFFFACTO_FUSE_HEAD=0``, and either with
        proj_out inside under ``DIFFFACTO_FUSE_TAIL=1`` (``denoiser.py:244-281``)."""
        B = x.shape[0]
        M = ctx.shape[1]
        kdt = kernel_dtype(x.device, cdt)  # bf16 on the card, whatever the module's dtype
        ctx_c = ctx.to(cdt)
        k = torch.einsum("bmc,icd->ibmd", ctx_c, self._stacked("wk", cdt)).to(kdt).contiguous()
        v = torch.einsum("bmc,icd->ibmd", ctx_c, self._stacked("wv", cdt)).to(kdt).contiguous()
        if self.mask_out_unreferenced_code:
            mask = valid_id.float()
        else:
            mask = torch.ones(B, M, device=x.device)
        f32 = torch.float32
        if train:
            return self._proj_out(self._train_trunk(x, k, v, mask, cdt, generator, t_embed), cdt,
                                  x.dtype)
        fuse_head = t_embed is None and os.environ.get("DIFFFACTO_FUSE_HEAD", "1") == "1"
        fuse_tail = os.environ.get("DIFFFACTO_FUSE_TAIL", "") == "1"
        if fuse_head:
            trunk = fused_core_tail if fuse_tail else fused_core
            head = (x.to(kdt).contiguous(), self.proj_in.kernel.to(kdt), self.proj_in.bias.to(f32))
        else:
            trunk = fused_core_headless_tail if fuse_tail else fused_core_headless
            head = (self._proj_in(x, cdt, t_embed).to(kdt).contiguous(),)
        tail = ()
        if fuse_tail:
            tail = (self.proj_out.kernel.to(kdt).contiguous(), self.proj_out.bias.to(f32))
        h = trunk(
            *head, k, v, mask.contiguous(),
            self.pre_norm.scale.to(kdt), self.pre_norm.bias.to(kdt),
            self.post_norm.scale.to(kdt), self.post_norm.bias.to(kdt),
            self._stacked("norm2_scale", kdt), self._stacked("norm2_bias", kdt),
            self._stacked("wq", kdt), self._stacked("wout", kdt), self._stacked("bout", f32),
            self._stacked("ffn_ln_scale", kdt), self._stacked("ffn_ln_bias", kdt),
            self._stacked("ffn_w1", kdt), self._stacked("ffn_b1", f32),
            self._stacked("ffn_w2", kdt), self._stacked("ffn_b2", f32), *tail,
            self.d_head**-0.5,
        )
        return h.to(x.dtype) if fuse_tail else self._proj_out(h, cdt, x.dtype)


@NETS.register_module()
class UNet(nn.Module):
    """The 1D attention "UNet" denoiser (``difffacto_tpu/models/denoiser.py:381-434``,
    the reference's nets/unet.py:296-341).

    forward(x (B, N, in_channels), t (B,), ctx (B, K, prior_dim): the part
    tokens, valid_id (B, K) or None, language_code (B, L, language_dim) or
    None, train, generator: the "dropout" stream with ``train=True``).
    GroupNorm (eps 1e-6, min(32, C) groups) and SiLU before proj_in;
    the time embedding through two Dense layers; per level a LayerNorm
    without a dtype (so the hidden state is f32) scaled and shifted by the
    embedding, then ``prior_blocks[i]`` on the part tokens and, when the
    model is built with ``language_cond``, ``lang_blocks[i]`` on the language
    code; proj_out starts at zero and the input is added back. The flat
    blocks take ``ops/fused_block`` where they qualify and ``train`` is
    False; in training they run the unfused math with dropout. As the JAX
    blocks take their context width from the context itself, ``prior_dim``
    and ``language_dim`` must be the widths of ctx and language_code.
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
        if ctx is None or (language_code is not None) != self.language_cond:
            raise ValueError("UNet takes the part tokens, and a language code exactly when "
                             "it was built with language_cond=True")
        silu = torch.nn.functional.silu
        h = self.proj_in(silu(self.group_norm(x)))
        emb = self.dense1(silu(self.dense0(timestep_embedding(t, self.embed_dim))))
        for i, prior_block in enumerate(self.prior_blocks):
            scale, shift = self.emb[i](silu(emb)).chunk(2, dim=-1)
            h = self.ln[i](h) * (1 + scale[:, None]) + shift[:, None]
            h = prior_block(h, ctx, valid_id, train, generator)
            if self.lang_blocks is not None:
                h = self.lang_blocks[i](h, language_code, None, train, generator)
        return self.proj_out(h) + x


class ConcatSquashDense(nn.Module):
    """``layer(x) * sigmoid(hyper_gate(ctx)) + hyper_bias(ctx)``
    (``difffacto_tpu/models/denoiser.py:436-446``; the reference's
    ConcatSquashLinear); ``hyper_bias`` has no bias."""

    def __init__(self, in_features: int, ctx_features: int, features: int,
                 *, dtype=None, device="cuda", generator=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.hyper_gate = Dense(ctx_features, features, **kw)
        self.hyper_bias = Dense(ctx_features, features, use_bias=False, **kw)
        self.layer = Dense(in_features, features, **kw)

    def forward(self, x, ctx):
        return self.layer(x) * torch.sigmoid(self.hyper_gate(ctx)) + self.hyper_bias(ctx)


def _concat_squash_stack(mod, in_dim, cond_dim, hidden, out_dim, kw):
    """``mod.cs_0`` .. ``cs_{n-1}`` over ``hidden`` and ``mod.cs_out``, each
    modulated by a condition ``cond_dim`` wide (the JAX modules' names)."""
    mod.hidden = tuple(hidden)
    dims = (in_dim,) + mod.hidden
    for i, f in enumerate(mod.hidden):
        setattr(mod, f"cs_{i}", ConcatSquashDense(dims[i], cond_dim, f, **kw))
    mod.cs_out = ConcatSquashDense(dims[-1], cond_dim, out_dim, **kw)


def _concat_squash_run(mod, x, cond):
    """The stack of ``_concat_squash_stack`` on x, leaky ReLU between layers."""
    h = x
    for i in range(len(mod.hidden)):
        h = F.leaky_relu(getattr(mod, f"cs_{i}")(h, cond), 0.01)
    return mod.cs_out(h, cond)


@NETS.register_module()
class PointwiseNet(nn.Module):
    """The concat-squash MLP denoiser (``difffacto_tpu/models/denoiser.py:490-530``,
    the reference's nets/pointwisenet.py:9-99): the context of a shape, [t,
    sin t, cos t] ++ ctx, modulates each of the ``hidden`` layers (leaky ReLU
    between them) and the output layer; the input is added back when
    ``residual`` and the widths agree. ``in_channels``, ``out_channels`` and
    ``res`` are the reference configs' aliases of ``point_dim`` and
    ``residual`` and win where given, as in the JAX module.

    forward(x (B, N, point_dim), t (B,), ctx: (B, F) or (B, 1, F), global, or
    (B, N, F), per point, or a list or tuple of them concatenated; F is
    ``context_dim``). The other arguments of the denoisers' call are
    accepted and read nowhere.
    """

    def __init__(self, point_dim: int = 3, context_dim: int = 256, residual: bool = True,
                 hidden=(128, 256, 512, 256, 128), in_channels=None, out_channels=None,
                 res=None, *, dtype=None, device="cuda", generator=None):
        super().__init__()
        device = resolve_device(device)
        g = default_generator(generator)
        in_dim = in_channels if in_channels is not None else point_dim
        out_dim = out_channels if out_channels is not None else point_dim
        self.residual = res if res is not None else residual
        _concat_squash_stack(self, in_dim, context_dim + 3, hidden, out_dim,
                             dict(dtype=dtype, device=device, generator=g))

    def forward(self, x, t, ctx, anchors=None, variances=None, seg_mask=None, valid_id=None,
                train: bool = False, generator=None):
        if isinstance(ctx, (list, tuple)):
            ctx = torch.cat([c if c.ndim == 3 else c[:, None] for c in ctx], dim=-1)
        elif ctx.ndim == 2:
            ctx = ctx[:, None]
        h = _concat_squash_run(self, x, _time_cond(t, ctx))
        return x + h if self.residual and x.shape[-1] == h.shape[-1] else h


def _time_cond(t, ctx):
    """[t, sin t, cos t] ++ ctx on every row of ctx (B, M, F) -> (B, M, 3 + F)."""
    tf = t.float()[:, None]
    time_emb = torch.cat([tf, torch.sin(tf), torch.cos(tf)], dim=-1)[:, None]
    ct = torch.promote_types(ctx.dtype, time_emb.dtype)
    return torch.cat([time_emb.expand(*ctx.shape[:2], 3), ctx.to(ct)], dim=-1)


@NETS.register_module()
class PointwiseNet2(nn.Module):
    """The concat-squash MLP with the per-part context gathered per point
    (``difffacto_tpu/models/denoiser.py:449-487``, the reference's
    nets/pointwisenet2.py:10-103): point n is modulated by [t, sin t, cos t]
    ++ ctx[seg_mask[n]].

    forward(x (B, N, in_channels), t (B,), ctx (B, K, context_dim) or a list
    or tuple of them concatenated, seg_mask (B, N)). The input is added back
    with ``res`` where the widths agree. ``num_anchors``,
    ``include_anchors`` and ``gather_layers`` are kept and read nowhere, as
    in the JAX module.
    """

    def __init__(self, in_channels: int = 3, out_channels: int = 3, context_dim: int = 256,
                 num_anchors: int = 4, res: bool = True, include_anchors: bool = False,
                 gather_layers=(1, 3), hidden=(128, 256, 512, 256, 128),
                 *, dtype=None, device="cuda", generator=None):
        super().__init__()
        device = resolve_device(device)
        g = default_generator(generator)
        self.res = res
        self.num_anchors, self.include_anchors = num_anchors, include_anchors
        self.gather_layers = tuple(gather_layers)
        _concat_squash_stack(self, in_channels, context_dim + 3, hidden, out_channels,
                             dict(dtype=dtype, device=device, generator=g))

    def forward(self, x, t, ctx, anchors=None, variances=None, seg_mask=None, valid_id=None,
                train: bool = False, generator=None):
        from .part_encoder import gather_per_point

        if isinstance(ctx, (list, tuple)):
            ctx = torch.cat(list(ctx), dim=-1)
        h = _concat_squash_run(self, x, _time_cond(t, gather_per_point(ctx, seg_mask)))
        return x + h if self.res and x.shape[-1] == h.shape[-1] else h


@NETS.register_module()
class LDMNet(nn.Module):
    """The latent denoiser over the K part tokens (``difffacto_tpu/models/denoiser.py:312-379``,
    the reference's attention.py:443-546).

    forward(x (B, K, in_channels), t (B,), ctx (B, M, context_dim), a list
    or tuple of them concatenated, or None (the blocks then self-attend),
    anchors, variances, seg_mask (read nowhere), valid_id (B, K) or None,
    train, generator). proj_in; the GEGLU ``time_embed`` of the first
    ``inner`` sinusoid channels of 256 (of ``inner`` where wider) joins as a
    token in front, its mask entry 1, with ``cond_time_as_token``, else
    biases every token; ``class_emb`` (n_class, inner) is added to the part
    tokens with ``class_cond``; pre-LN, ``depth`` blocks, post-LN, the time
    token dropped, a zero-initialised proj_out. The mask reaches the blocks
    as the JAX module passes it: a context's attention reads it as a mask
    over the context's tokens. The blocks are ``transformer_block``'s, so
    two-attention blocks end in ``FusedLNFF`` (the fused FF kernel where it
    takes the shape) and the flat layout takes the one-block kernel where
    ``block_kernel_takes`` the per-shape token count, as the JAX blocks
    dispatch. ``use_checkpoint`` raises, as in ``TransformerNet``.
    """

    def __init__(self, in_channels: int, out_channels: int, n_heads: int, d_head: int,
                 depth: int = 1, dropout: float = 0.0, context_dim=None, n_class: int = 4,
                 class_cond: bool = False, single_attn: bool = False,
                 mask_out_unreferenced_code: bool = True, cond_time_as_token: bool = True,
                 use_checkpoint: bool = False, *, dtype=None, device="cuda", generator=None):
        super().__init__()
        device = resolve_device(device)
        if use_checkpoint:
            raise NotImplementedError("use_checkpoint=True is not ported (see TransformerNet)")
        g = default_generator(generator)
        inner = n_heads * d_head
        self.inner, self.context_dim, self.class_cond = inner, context_dim, class_cond
        self.mask_out_unreferenced_code = mask_out_unreferenced_code
        self.cond_time_as_token = cond_time_as_token
        kw = dict(dtype=dtype, device=device)
        self.proj_in = Dense(in_channels, inner, generator=g, **kw)
        self.time_embed = FeedForward(inner, dropout=dropout, generator=g, **kw)
        if class_cond:
            self.class_emb = nn.Parameter(torch.randn(n_class, inner, generator=g).to(device))
        self.pre_norm = LayerNorm(inner, **kw)
        self.blocks = nn.ModuleList(
            transformer_block(inner, n_heads, d_head, context_dim=context_dim, dropout=dropout,
                              single_attn=single_attn, generator=g, **kw)
            for _ in range(depth))
        self.post_norm = LayerNorm(inner, **kw)
        self.proj_out = Dense(inner, out_channels, zero_kernel=True, generator=g, **kw)

    def forward(self, x, t, ctx=None, anchors=None, variances=None, seg_mask=None,
                valid_id=None, train: bool = False, generator=None):
        B = x.shape[0]
        if isinstance(ctx, (list, tuple)):
            ctx = torch.cat(list(ctx), dim=-1) if ctx else None
        if ctx is not None and self.context_dim is None:
            raise ValueError("LDMNet was built without context_dim; its blocks take no context")
        h = self.proj_in(x)
        emb = timestep_embedding(t, 256)[:, : self.inner] if self.inner <= 256 else (
            timestep_embedding(t, self.inner))
        t_embed = self.time_embed(emb, train, generator)
        mask = valid_id if self.mask_out_unreferenced_code else None
        extra = 0
        if self.cond_time_as_token:
            h = torch.cat([t_embed[:, None].to(h.dtype), h], dim=1)
            extra = 1
            if mask is not None:
                mask = torch.cat([torch.ones(B, 1, dtype=mask.dtype, device=mask.device), mask],
                                 dim=1)
        else:
            h = h + t_embed[:, None].to(h.dtype)
        if self.class_cond:
            pad = torch.zeros(extra, self.inner, dtype=h.dtype, device=h.device)
            h = h + torch.cat([pad, self.class_emb.to(h.dtype)], dim=0)[None]
        h = self.pre_norm(h)
        for blk in self.blocks:
            h = blk(h, ctx, mask, train, generator)
        h = self.post_norm(h)
        return self.proj_out(h[:, extra:])


@NETS.register_module()
class PointwiseNetLatent(nn.Module):
    """The concat-squash latent denoiser with a condition a token
    (``difffacto_tpu/models/denoiser.py:535-574``, the reference's
    nets/pointwisenet.py:9-59): part token k is modulated by [t, sin t, cos t]
    ++ prior[k] ++ the code (broadcast over the K tokens, zeroed where
    ``part_indicator`` is 0 with ``use_part_ind``); leaky ReLU between the
    ``hidden`` layers, the input added back with ``res``.

    forward(x (B, K, in_channels), t (B,), prior (B, K, P), code (B, F),
    (B, 1, F), (B, K, F) or None, part_indicator (B, K) or None).
    ``context_dim`` is the condition's width past the 3 time channels, P
    (+ F), which flax infers from the call.
    """

    def __init__(self, in_channels: int = 256, out_channels: int = 256, context_dim: int = 256,
                 res: bool = True, use_part_ind: bool = False,
                 hidden=(128, 256, 512, 256, 128), *, dtype=None, device="cuda",
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        g = default_generator(generator)
        self.res, self.use_part_ind = res, use_part_ind
        _concat_squash_stack(self, in_channels, context_dim + 3, hidden, out_channels,
                             dict(dtype=dtype, device=device, generator=g))

    def forward(self, x, t, prior, code=None, part_indicator=None, train: bool = False,
                generator=None):
        B, K = x.shape[:2]
        ctx = [prior]
        if code is not None:
            if code.ndim == 2:
                code = code[:, None]
            code = code.expand(B, K, code.shape[-1])
            if self.use_part_ind and part_indicator is not None:
                code = code * part_indicator[..., None].to(code.dtype)
            ctx.append(code)
        ct = torch.promote_types(prior.dtype, torch.float32)
        h = _concat_squash_run(self, x, _time_cond(t, torch.cat([c.to(ct) for c in ctx], dim=-1)))
        return h + x if self.res else h
