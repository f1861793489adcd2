"""Attention, and the transformer blocks of the aligner, the denoisers and UNet.

Port of ``difffacto_tpu/nn/attention.py``:

* ``CrossAttention`` (``attention.py:21-109``) with its two paths in the
  compute dtype: ``masked_softmax_attention`` (the ``finfo.min`` mask and a
  plain softmax) and, for a context of at most 8 tokens shorter than the
  queries, ``small_ctx_attention_cdt`` (the grouped softmax with a 1e30 sink).
  ``nn/functional.py:small_ctx_attention`` is the kernels' version, with f32
  scores: another function.
* ``TransformerBlock``: ``BasicTransformerBlock``'s unfused layout
  (``attention.py:152-195``): with ``single_attn=False`` norm1 -> attn1 first,
  then norm2 -> attn2, then ``FusedLNFF`` where ``gated_ff`` and not
  ``adaln``, else norm3 (shifted and scaled by ``emb_layers`` of silu(y)
  with ``adaln``) -> ``FeedForward(glu=gated_ff)``. The JAX package takes it
  for two-attention blocks, the aligner's ``cond_noise_type=2`` (adaLN),
  ``gated_ff=False`` and ``n_heads * d_head != dim``; none of these reaches
  a kernel but ``FusedLNFF``'s. ``transformer_block`` picks the layout as
  the JAX block does (``attention.py:143-150``).
* ``BasicTransformerBlock``: the flat single-attention layout
  (``attention.py:198-313``). With a context at the shapes the kernel takes
  (``block_kernel_takes``: width 128, 8 heads, 4 context tokens, and
  ``pick_tile(N)`` not 0) it runs as one call of
  ``ops/fused_block.fused_block``; otherwise, and in training, the unfused
  math, masked with ``finfo.min``. The JAX package takes its kernel at more
  shapes; the math is the same.

With ``train=True`` the blocks apply dropout where the JAX blocks do: after
each attention's out-projection and on the feed-forward's inner activations;
the draws come from an explicit generator.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.fused_block import fused_block
from ..ops.fused_block import takes as block_takes
from ..ops.fused_ff import pick_tile
from ..utils.device import kernel_dtype
from .functional import gelu, ln_stats_f32
from .layers import (Dense, FeedForward, FusedLNFF, LayerNorm, default_generator, dropout,
                     lecun_normal, param)

SMALL_CTX = 8  # context lengths at or below this take the small-context paths


def block_kernel_takes(width: int, heads: int, ctx_tokens: int, tokens: int) -> bool:
    """The shape rule of the flat block with a context: the one-block kernel
    where it takes (width, heads, context length) and ``pick_tile`` takes the
    token count, as the JAX package dispatches; the unfused math otherwise."""
    return block_takes(width, heads, ctx_tokens) and bool(pick_tile(tokens))


def masked_softmax_attention(q, k, v, mask, scale: float) -> torch.Tensor:
    """q (B, N, H, dh), k/v (B, M, H, dh), mask (B, M) or None -> (B, N, H, dh).

    Masked scores are replaced by the dtype's lowest value before a plain
    softmax, written out as ``jax.nn.softmax`` computes it, in the scores'
    dtype (``nn/attention.py:294-298``)."""
    sim = torch.einsum("bnhd,bmhd->bhnm", q, k) * scale
    if mask is not None:
        keep = mask[:, None, None, :].bool()
        sim = torch.where(keep, sim, torch.finfo(sim.dtype).min)
    e = torch.exp(sim - sim.amax(-1, keepdim=True))
    return torch.einsum("bhnm,bmhd->bnhd", e / e.sum(-1, keepdim=True), v)


def small_ctx_attention_cdt(q, k, v, mask, scale: float) -> torch.Tensor:
    """``CrossAttention._small_ctx_attention`` (``attention.py:66-109``): every
    step in the compute dtype of q, k and v (B, N | M, H, dh).

    Masked tokens (mask (B, M), 1 = attend, or None) sink by 1e30 in that
    dtype before one max-shift per token over all heads; the exponentials are
    zeroed by the mask and divided by their per-head sum, clamped at the
    dtype's smallest normal. Returns (B, N, H, dh)."""
    dt = q.dtype
    B, N = q.shape[:2]
    s = torch.einsum("bnhd,bmhd->bnhm", q, k) * scale
    if mask is not None:
        m = mask.to(dt)[:, None, None, :]
        s = s + (m - 1.0) * torch.tensor(1e30, dtype=dt)
    e = torch.exp(s - s.reshape(B, N, -1).amax(-1)[:, :, None, None])
    if mask is not None:
        e = e * m
    w = e / torch.clamp(e.sum(-1, keepdim=True), min=torch.finfo(dt).tiny)
    return torch.einsum("bnhm,bmhd->bnhd", w, v)


class CrossAttention(nn.Module):
    """Multi-head attention (``attention.py:21-64``): q from x (B, N,
    query_dim), k and v from ``context`` (B, M, context_dim) or, without one,
    from x; mask (B, M) with 1 = attend. ``to_q``, ``to_k`` and ``to_v`` have no
    bias. A context of at most 8 tokens with N > M takes
    ``small_ctx_attention_cdt``, anything else ``masked_softmax_attention``;
    dropout after ``to_out`` when training."""

    def __init__(self, query_dim: int, context_dim=None, heads: int = 8, dim_head: int = 64,
                 dropout: float = 0.0, *, dtype=None, device="cuda", generator=None):
        super().__init__()
        g = default_generator(generator)
        self.heads, self.dim_head, self.dropout = heads, dim_head, dropout
        inner = heads * dim_head
        cdim = context_dim if context_dim is not None else query_dim
        kw = dict(dtype=dtype, device=device, generator=g)
        self.to_q = Dense(query_dim, inner, use_bias=False, **kw)
        self.to_k = Dense(cdim, inner, use_bias=False, **kw)
        self.to_v = Dense(cdim, inner, use_bias=False, **kw)
        self.to_out = Dense(inner, query_dim, **kw)

    def forward(self, x: torch.Tensor, context=None, mask=None, train: bool = False,
                generator=None) -> torch.Tensor:
        ctx = x if context is None else context
        q, k, v = self.to_q(x), self.to_k(ctx), self.to_v(ctx)
        B, N, M = q.shape[0], q.shape[1], k.shape[1]
        h, d = self.heads, self.dim_head
        qh, kh, vh = q.reshape(B, N, h, d), k.reshape(B, M, h, d), v.reshape(B, M, h, d)
        if context is not None and M <= SMALL_CTX and N > M:
            out = small_ctx_attention_cdt(qh, kh, vh, mask, d**-0.5)
        else:
            out = masked_softmax_attention(qh, kh, vh, mask, d**-0.5)
        return dropout(self.to_out(out.reshape(B, N, h * d)), self.dropout, train, generator)


class TransformerBlock(nn.Module):
    """``BasicTransformerBlock``'s unfused layout (``attention.py:152-195``).

    forward(x (B, N, dim), context (B, M, context_dim) or None, mask (B, M)
    or None, train, generator, y (B, y_dim): the adaLN condition). Without a
    context the attentions are self-attention. With ``train=True`` both
    attentions and the feed-forward take their dropout, as the JAX block
    trains them; its FF then runs the unfused math."""

    def __init__(self, dim: int, n_heads: int, d_head: int, context_dim=None,
                 dropout: float = 0.0, gated_ff: bool = True, single_attn: bool = False,
                 adaln: bool = False, y_dim: int = 32, *, dtype=None, device="cuda",
                 generator=None):
        super().__init__()
        g = default_generator(generator)
        self.single_attn, self.adaln = single_attn, adaln
        self.fused_ff = gated_ff and not adaln
        kw = dict(dtype=dtype, device=device)
        attn = dict(dropout=dropout, generator=g, **kw)
        if not single_attn:
            self.norm1 = LayerNorm(dim, **kw)
            self.attn1 = CrossAttention(dim, context_dim, n_heads, d_head, **attn)
        self.norm2 = LayerNorm(dim, **kw)
        self.attn2 = CrossAttention(dim, context_dim, n_heads, d_head, **attn)
        if self.fused_ff:
            self.ffn = FusedLNFF(dim, dropout=dropout, generator=g, **kw)
        else:
            self.norm3 = LayerNorm(dim, **kw)
            if adaln:
                self.emb_layers = Dense(y_dim, 2 * dim, generator=g, **kw)
            self.ff = FeedForward(dim, dropout=dropout, glu=gated_ff, generator=g, **kw)

    def forward(self, x: torch.Tensor, context=None, mask=None, train: bool = False,
                generator=None, y=None) -> torch.Tensor:
        if not self.single_attn:
            x = self.attn1(self.norm1(x), context, mask, train, generator) + x
        x = self.attn2(self.norm2(x), context, mask, train, generator) + x
        if self.fused_ff:
            return self.ffn(x, train, generator)
        h = self.norm3(x)
        if self.adaln:
            shift, scale = self.emb_layers(torch.nn.functional.silu(y)).chunk(2, dim=-1)
            h = h * (1.0 + scale[:, None]) + shift[:, None]
        return self.ff(h, train, generator) + x


def transformer_block(dim: int, n_heads: int, d_head: int, context_dim=None,
                      dropout: float = 0.0, gated_ff: bool = True, single_attn: bool = False,
                      adaln: bool = False, y_dim: int = 32, **kw) -> nn.Module:
    """The block the JAX ``BasicTransformerBlock`` computes with these fields:
    the flat layout where ``single_attn and gated_ff and not adaln`` and
    ``n_heads * d_head == dim`` (``attention.py:143-150``), the unfused
    ``TransformerBlock`` otherwise."""
    if single_attn and gated_ff and not adaln and n_heads * d_head == dim:
        return BasicTransformerBlock(dim, n_heads, d_head, context_dim, dropout, **kw)
    return TransformerBlock(dim, n_heads, d_head, context_dim, dropout, gated_ff, single_attn,
                            adaln, y_dim, **kw)


class BasicTransformerBlock(nn.Module):
    """Single-attention GEGLU block with flat parameters
    (``BasicTransformerBlock._fused_layout``, ``nn/attention.py:198-220``).

    The parameters keep the JAX names and (in, out) layout. The denoiser
    stacks them across blocks for its trunk; ``forward`` runs one block, as
    the aligner (no context) and UNet (a context) do.
    """

    def __init__(self, dim: int, n_heads: int, d_head: int, context_dim=None,
                 dropout: float = 0.0, *, dtype=None, device="cuda", generator=None):
        super().__init__()
        if n_heads * d_head != dim:
            raise ValueError("the flat layout needs n_heads * d_head == dim; "
                             "transformer_block builds the unfused one for other widths")
        self.n_heads, self.d_head, self.dtype, self.dropout = n_heads, d_head, dtype, dropout
        g = default_generator(generator)
        cdim = context_dim if context_dim is not None else dim
        ff = 4 * dim
        ones, zeros = torch.ones, torch.zeros
        self.norm2_scale = param(ones(dim), device)
        self.norm2_bias = param(zeros(dim), device)
        self.wq = param(lecun_normal((dim, dim), g), device)
        self.wk = param(lecun_normal((cdim, dim), g), device)
        self.wv = param(lecun_normal((cdim, dim), g), device)
        self.wout = param(lecun_normal((dim, dim), g), device)
        self.bout = param(zeros(dim), device)
        self.ffn_ln_scale = param(ones(dim), device)
        self.ffn_ln_bias = param(zeros(dim), device)
        self.ffn_w1 = param(lecun_normal((dim, 2 * ff), g), device)
        self.ffn_b1 = param(zeros(2 * ff), device)
        self.ffn_w2 = param(lecun_normal((ff, dim), g), device)
        self.ffn_b2 = param(zeros(dim), device)

    def forward(self, x: torch.Tensor, context=None, mask=None, train: bool = False,
                generator=None, y=None) -> torch.Tensor:
        """x (B, N, dim) attends to ``context`` (B, M, context_dim), or to
        itself without one (``attention.py:235-313``); mask (B, M) or None.
        ``y`` is read by the adaLN layout only, as in the JAX block."""
        cdt = self.dtype or x.dtype
        B, N, D = x.shape
        M = context.shape[1] if context is not None else N
        h_, dh = self.n_heads, self.d_head
        if not train and context is not None and block_kernel_takes(D, h_, M, N):
            kdt = kernel_dtype(x.device, cdt)
            ctx_c = context.to(cdt)
            ones = torch.ones(B, M, device=x.device)
            return fused_block(
                x.to(kdt).contiguous(), (ctx_c @ self.wk.to(cdt)).to(kdt).contiguous(),
                (ctx_c @ self.wv.to(cdt)).to(kdt).contiguous(),
                (ones if mask is None else mask.float()).contiguous(),
                self.norm2_scale.to(kdt), self.norm2_bias.to(kdt), self.wq.to(kdt),
                self.wout.to(kdt), self.bout.float(), self.ffn_ln_scale.to(kdt),
                self.ffn_ln_bias.to(kdt), self.ffn_w1.to(kdt), self.ffn_b1.float(),
                self.ffn_w2.to(kdt), self.ffn_b2.float(), dh**-0.5, h_,
            ).to(x.dtype)

        hq = ln_stats_f32(x, self.norm2_scale, self.norm2_bias).to(cdt)
        kv_src = hq if context is None else context.to(cdt)
        q = (hq @ self.wq.to(cdt)).reshape(B, N, h_, dh)
        k = (kv_src @ self.wk.to(cdt)).reshape(B, M, h_, dh)
        v = (kv_src @ self.wv.to(cdt)).reshape(B, M, h_, dh)
        out = masked_softmax_attention(q, k, v, mask, dh**-0.5).reshape(B, N, D)
        out = out @ self.wout.to(cdt) + self.bout.to(cdt)
        out = dropout(out, self.dropout, train, generator)
        x = x + out.to(x.dtype)

        hf = ln_stats_f32(x, self.ffn_ln_scale, self.ffn_ln_bias).to(cdt)
        a, g = (hf @ self.ffn_w1.to(cdt) + self.ffn_b1.to(cdt)).chunk(2, dim=-1)
        act = dropout(a * gelu(g), self.dropout, train, generator)
        out = act @ self.ffn_w2.to(cdt) + self.ffn_b2.to(cdt)
        return x + out.to(x.dtype)
