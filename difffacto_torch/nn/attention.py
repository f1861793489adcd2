"""Attention, and the transformer blocks of the aligner, the denoisers and UNet.

Port of ``difffacto_tpu/nn/attention.py``:

* ``CrossAttention`` (``attention.py:21-109``) with its two paths in the
  compute dtype: ``masked_softmax_attention`` (the ``finfo.min`` mask and a
  plain softmax) and, for a context of at most 8 tokens shorter than the
  queries, ``small_ctx_attention_cdt`` (the grouped softmax with a 1e30 sink).
  ``nn/functional.py:small_ctx_attention`` is the kernels' version, with f32
  scores: another function.
* ``TwoAttentionBlock``: ``BasicTransformerBlock`` with ``single_attn=False``
  (``attention.py:152-181``), norm1 -> attn1, norm2 -> attn2, then
  ``FusedLNFF``. Generation only.
* ``BasicTransformerBlock``: the flat single-attention layout
  (``attention.py:198-313``). With a context of at most 8 tokens, 128
  dividing the width and ``pick_tile(N)`` not 0 it runs as one call of
  ``ops/fused_block.fused_block``; otherwise, and in training, the unfused
  math, masked with ``finfo.min``.

With ``train=True`` the flat block applies dropout after the out-projection
and on the GEGLU activations, the two sites of the JAX block; the draws come
from an explicit generator.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.fused_block import fused_block
from ..ops.fused_ff import pick_tile
from .functional import gelu, ln_stats_f32
from .layers import Dense, FusedLNFF, LayerNorm, default_generator, dropout, lecun_normal, param

SMALL_CTX = 8  # context lengths at or below this take the small-context paths


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
    ``small_ctx_attention_cdt``, anything else ``masked_softmax_attention``."""

    def __init__(self, query_dim: int, context_dim=None, heads: int = 8, dim_head: int = 64,
                 *, dtype=None, device="cuda", generator=None):
        super().__init__()
        g = default_generator(generator)
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        cdim = context_dim if context_dim is not None else query_dim
        kw = dict(dtype=dtype, device=device, generator=g)
        self.to_q = Dense(query_dim, inner, use_bias=False, **kw)
        self.to_k = Dense(cdim, inner, use_bias=False, **kw)
        self.to_v = Dense(cdim, inner, use_bias=False, **kw)
        self.to_out = Dense(inner, query_dim, **kw)

    def forward(self, x: torch.Tensor, context=None, mask=None) -> torch.Tensor:
        ctx = x if context is None else context
        q, k, v = self.to_q(x), self.to_k(ctx), self.to_v(ctx)
        B, N, M = q.shape[0], q.shape[1], k.shape[1]
        h, d = self.heads, self.dim_head
        qh, kh, vh = q.reshape(B, N, h, d), k.reshape(B, M, h, d), v.reshape(B, M, h, d)
        if context is not None and M <= SMALL_CTX and N > M:
            out = small_ctx_attention_cdt(qh, kh, vh, mask, d**-0.5)
        else:
            out = masked_softmax_attention(qh, kh, vh, mask, d**-0.5)
        return self.to_out(out.reshape(B, N, h * d))


class TwoAttentionBlock(nn.Module):
    """``BasicTransformerBlock`` with ``single_attn=False`` (``attention.py:152-181``):
    x + attn1(norm1(x)), then + attn2(norm2(x)), then ``ffn`` (``FusedLNFF``).
    As in the JAX package, both attentions take the context when there is
    one; without one (the aligner) both are self-attention. Generation only:
    ``train=True`` raises, the JAX package trains it unfused with dropout."""

    def __init__(self, dim: int, n_heads: int, d_head: int, context_dim=None,
                 *, dtype=None, device="cuda", generator=None):
        super().__init__()
        g = default_generator(generator)
        kw = dict(dtype=dtype, device=device)
        self.norm1 = LayerNorm(dim, **kw)
        self.attn1 = CrossAttention(dim, context_dim, n_heads, d_head, generator=g, **kw)
        self.norm2 = LayerNorm(dim, **kw)
        self.attn2 = CrossAttention(dim, context_dim, n_heads, d_head, generator=g, **kw)
        self.ffn = FusedLNFF(dim, generator=g, **kw)

    def forward(self, x: torch.Tensor, context=None, mask=None, train: bool = False,
                generator=None) -> torch.Tensor:
        if train:
            raise NotImplementedError(
                "the two-attention block is ported for generation only (train=False)")
        x = self.attn1(self.norm1(x), context, mask) + x
        x = self.attn2(self.norm2(x), context, mask) + x
        return self.ffn(x)


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
            raise NotImplementedError("only the block with n_heads * d_head == dim is ported")
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
                generator=None) -> torch.Tensor:
        """x (B, N, dim) attends to ``context`` (B, M, context_dim), or to
        itself without one (``attention.py:235-313``); mask (B, M) or None."""
        cdt = self.dtype or x.dtype
        B, N, D = x.shape
        M = context.shape[1] if context is not None else N
        h_, dh = self.n_heads, self.d_head
        if not train and context is not None and M <= SMALL_CTX and D % 128 == 0 and pick_tile(N):
            ctx_c = context.to(cdt)
            ones = torch.ones(B, M, device=x.device)
            return fused_block(
                x.to(cdt).contiguous(), (ctx_c @ self.wk.to(cdt)).contiguous(),
                (ctx_c @ self.wv.to(cdt)).contiguous(),
                (ones if mask is None else mask.float()).contiguous(),
                self.norm2_scale.to(cdt), self.norm2_bias.to(cdt), self.wq.to(cdt),
                self.wout.to(cdt), self.bout.float(), self.ffn_ln_scale.to(cdt),
                self.ffn_ln_bias.to(cdt), self.ffn_w1.to(cdt), self.ffn_b1.float(),
                self.ffn_w2.to(cdt), self.ffn_b2.float(), dh**-0.5, h_,
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
