"""Plain PyTorch reference of DiffFacto's generation with two-attention blocks.

The gen_chair family of ``reference/generation.py`` with ``single_attn=False``
in the aligner and in the denoiser: DiffFacto's ``BasicTransformerBlock`` in
its default layout (github.com/diffFacto/diffFacto, ``nets/attention.py``
152-195, Stable Diffusion's block). Each block runs norm1 -> attn1, then
norm2 -> attn2, each attention with its own LayerNorm, q, k, v and
out-projection and a residual, then the pre-LN GEGLU feed-forward:

* in the aligner (no context) both attentions are self-attention over the K
  part tokens, absent parts masked as keys;
* in the denoiser both cross-attend to the K part tokens, each with its own
  K and V.

It reads the weights under the names of the program's checkpoint layout for
that block (``blocks.<i>.norm1.scale``, ``blocks.<i>.attn1.to_q.kernel``,
``blocks.<i>.ffn.w1``, ...) and imports nothing of the program; the flow
prior, the points' split, the time embedding and the chain are
``Generation``'s. The precisions are ``Generation``'s: float32 with TF32 off,
and the control's fp8 e4m3 operands.
"""

from __future__ import annotations

import copy
import math

import torch
import torch.nn.functional as F

from .generation import Generation, attention, gelu, layer_norm


class GenerationTwoAttn(Generation):
    """``Generation`` of a configuration whose aligner and denoiser both have
    ``single_attn=False``."""

    def __init__(self, weights: dict, model: dict, precision: str = "float32"):
        al = model["encoder"]["part_aligner"]
        net = model["diffusion"]["net"]
        if al.get("single_attn") or net.get("single_attn"):
            raise NotImplementedError("this reference covers two-attention blocks in both the "
                                      "aligner and the denoiser; reference/generation.py the "
                                      "single-attention ones")
        # Generation checks the rest of the family on a copy marked single.
        single = copy.deepcopy(model)
        single["encoder"]["part_aligner"]["single_attn"] = True
        single["diffusion"]["net"]["single_attn"] = True
        super().__init__(weights, single, precision)

    def _attend(self, h, b, n: int, tokens, valid, heads: int):
        """h + attn<n>(norm<n>(h)) with keys from ``tokens``, or from the
        normalised h itself where ``tokens`` is None."""
        a = layer_norm(h, self.w(f"{b}norm{n}.scale"), self.w(f"{b}norm{n}.bias"))
        at = f"{b}attn{n}."
        src = a if tokens is None else tokens
        q = self.p.dense(a, self.w(at + "to_q.kernel"))
        k = self.p.dense(src, self.w(at + "to_k.kernel"))
        v = self.p.dense(src, self.w(at + "to_v.kernel"))
        o = attention(q, k, v, valid, heads, self.p)
        return h + self.p.dense(o, self.w(at + "to_out.kernel"), self.w(at + "to_out.bias"))

    def _block(self, h, b, tokens, valid, heads: int):
        h = self._attend(h, b, 1, tokens, valid, heads)
        h = self._attend(h, b, 2, tokens, valid, heads)
        f = layer_norm(h, self.w(b + "ffn.ln_scale"), self.w(b + "ffn.ln_bias"))
        u, g = self.p.dense(f, self.w(b + "ffn.w1"), self.w(b + "ffn.b1")).chunk(2, dim=-1)
        return h + self.p.dense(u * gelu(g), self.w(b + "ffn.w2"), self.w(b + "ffn.b2"))

    def aligner(self, code, valid, noise):
        """code (B, K, zdim), valid (B, K), noise (B, noise_dim) -> mean, logvar (B, K, 3)."""
        B, K, _ = code.shape
        pre = "encoder_mod.aligner."
        x = torch.cat([code, (noise.float() * self.noise_scale)[:, None].expand(B, K, -1)], -1)
        h = self.p.dense(x, self.w(pre + "proj_in.kernel"), self.w(pre + "proj_in.bias"))
        h = h + self.w(pre + "class_emb")[None]
        for i in range(self.al_depth):
            h = self._block(h, f"{pre}blocks.{i}.", None, valid, self.al_heads)
        h = layer_norm(h, self.w(pre + "post_norm.scale"), self.w(pre + "post_norm.bias"))
        out = self.p.dense(h, self.w(pre + "proj_out.kernel"), self.w(pre + "proj_out.bias"))
        return out[..., :3], out[..., 3:6]

    def denoiser(self, x, t: int, ctx, anchors, var, seg, valid):
        """The epsilon of x (B, N, 3) at step t."""
        B, N, _ = x.shape
        pre = "net."
        half = 128
        freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                            device=x.device) / half)
        args = float(t) * freqs
        temb = torch.cat([torch.cos(args), torch.sin(args)])[None].expand(B, -1)
        a, g = self.p.dense(temb, self.w(pre + "time_embed.geglu.dense0.kernel"),
                            self.w(pre + "time_embed.geglu.dense0.bias")).chunk(2, dim=-1)
        temb = self.p.dense(a * gelu(g), self.w(pre + "time_embed.dense0.kernel"),
                            self.w(pre + "time_embed.dense0.bias"))
        eye = torch.eye(self.K, device=x.device)[None].expand(B, -1, -1)
        tokens = torch.cat([ctx, eye, temb[:, None].expand(B, self.K, -1)], dim=-1)
        onehot = F.one_hot(seg.long(), self.K).float()
        h = self.p.dense(torch.cat([x, anchors, var, onehot], dim=-1),
                         self.w(pre + "proj_in.kernel"), self.w(pre + "proj_in.bias"))
        h = layer_norm(h, self.w(pre + "pre_norm.scale"), self.w(pre + "pre_norm.bias"))
        for i in range(self.net_depth):
            h = self._block(h, f"{pre}blocks.{i}.", tokens, valid, self.net_heads)
        h = layer_norm(h, self.w(pre + "post_norm.scale"), self.w(pre + "post_norm.bias"))
        return self.p.dense(h, self.w(pre + "proj_out.kernel"), self.w(pre + "proj_out.bias"))
