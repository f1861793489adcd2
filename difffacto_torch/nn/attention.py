"""Attention over the 4 part tokens, and the flat-parameter transformer block.

Port of ``difffacto_tpu/nn/attention.py`` for the two cases on the
generation path:

* ``small_ctx_attention``: N point tokens cross-attend to the 4 part tokens,
  with the rounding and masking of the whole-trunk kernel
  (``difffacto_tpu/ops/fused_core.py:80-94``); the denoiser's plain trunk
  (``ops/fused_core.py:fused_core_reference``) calls it.
* ``BasicTransformerBlock`` with no context: self-attention over the 4 part
  tokens, masked with ``finfo.min`` and a plain softmax, as the aligner runs it
  (``BasicTransformerBlock._fused_layout``, ``nn/attention.py:281-313``).

With ``train=True`` the block applies dropout after the out-projection and
on the GEGLU activations, the two sites of the JAX block; the draws come from
an explicit generator.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import default_generator, dropout, gelu, lecun_normal, ln_stats_f32, param


def small_ctx_attention(q, k, v, mask, scale: float) -> torch.Tensor:
    """Cross attention to a few context tokens, as the trunk kernel does it.

    q (B, N, H, dh) in the compute dtype; k, v (B, M, H, dh); mask (B, M) with
    1 = attend. Scores are f32; masked tokens are sunk by 1e30 before the
    max-shift, which is one shift per token over all heads; the weights are
    zeroed by the mask, divided by their per-head sum (clamped at 1e-30) and
    rounded to the compute dtype, as is the weighted sum of V.
    Returns (B, N, H, dh) in q's dtype.
    """
    dt = q.dtype
    B, N, H, _ = q.shape
    s = torch.einsum("bnhd,bmhd->bnhm", q.float(), k.float()) * scale
    m = mask.float()[:, None, None, :]
    s = s + (m - 1.0) * 1e30
    c = s.reshape(B, N, -1).amax(-1)[:, :, None, None]
    e = torch.exp(s - c) * m
    w = (e / torch.clamp(e.sum(-1, keepdim=True), min=1e-30)).to(dt)
    return torch.einsum("bnhm,bmhd->bnhd", w.float(), v.float()).to(dt)


def masked_softmax_attention(q, k, v, mask, scale: float) -> torch.Tensor:
    """q (B, N, H, dh), k/v (B, M, H, dh), mask (B, M) or None -> (B, N, H, dh).

    Masked scores are replaced by the dtype's lowest value before a plain
    softmax (``nn/attention.py:294-298``)."""
    sim = torch.einsum("bnhd,bmhd->bhnm", q, k) * scale
    if mask is not None:
        keep = mask[:, None, None, :].bool()
        sim = torch.where(keep, sim, torch.finfo(sim.dtype).min)
    attn = torch.softmax(sim, dim=-1)
    return torch.einsum("bhnm,bmhd->bnhd", attn, v)


class BasicTransformerBlock(nn.Module):
    """Single-attention GEGLU block with flat parameters
    (``BasicTransformerBlock._fused_layout``, ``nn/attention.py:198-220``).

    The parameters keep the JAX names and (in, out) layout. The denoiser
    stacks them across blocks for its trunk; ``forward`` is the
    self-attention case the aligner runs.
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

    def forward(self, x: torch.Tensor, mask=None, train: bool = False,
                generator=None) -> torch.Tensor:
        """Self-attention over the tokens of x (B, M, dim), then the GEGLU FF."""
        cdt = self.dtype or x.dtype
        B, M, D = x.shape
        h_, dh = self.n_heads, self.d_head
        hq = ln_stats_f32(x, self.norm2_scale, self.norm2_bias).to(cdt)
        q = (hq @ self.wq.to(cdt)).reshape(B, M, h_, dh)
        k = (hq @ self.wk.to(cdt)).reshape(B, M, h_, dh)
        v = (hq @ self.wv.to(cdt)).reshape(B, M, h_, dh)
        out = masked_softmax_attention(q, k, v, mask, dh**-0.5).reshape(B, M, D)
        out = out @ self.wout.to(cdt) + self.bout.to(cdt)
        out = dropout(out, self.dropout, train, generator)
        x = x + out.to(x.dtype)

        hf = ln_stats_f32(x, self.ffn_ln_scale, self.ffn_ln_bias).to(cdt)
        a, g = (hf @ self.ffn_w1.to(cdt) + self.ffn_b1.to(cdt)).chunk(2, dim=-1)
        act = dropout(a * gelu(g), self.dropout, train, generator)
        out = act @ self.ffn_w2.to(cdt) + self.ffn_b2.to(cdt)
        return x + out.to(x.dtype)
