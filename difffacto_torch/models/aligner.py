"""The part aligner: a small transformer over the K part tokens.

Port of ``difffacto_tpu/models/aligner.py:PartAlignerTransformer`` for the
shipped configs, generation and training: CIMLE noise of type 0 (scaled and
concatenated to every part token) and the class embedding added after
``proj_in``. The other noise types raise ``NotImplementedError``. With
``single_attn=False`` the blocks are ``TwoAttentionBlock``s, for generation
only.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.attention import BasicTransformerBlock, TwoAttentionBlock
from ..nn.layers import Dense, LayerNorm, default_generator, param
from ..utils.device import resolve_device
from ..utils.registry import ENCODERS


@ENCODERS.register_module()
class PartAlignerTransformer(nn.Module):
    """part_code (B, K, C) -> mean (B, K, 3), logvar (B, K, 3).

    ``use_checkpoint`` and ``use_linear`` are kept and read nowhere, as in the
    JAX module (``aligner.py:35``, ``:45``): it neither rematerialises the
    blocks nor has another layout."""

    def __init__(self, in_channels: int, n_heads: int, d_head: int, out_channels: int,
                 depth: int = 1, dropout: float = 0.0, n_class: int = 4,
                 use_checkpoint: bool = False, single_attn: bool = False, class_cond: bool = True,
                 mask_out_unreferenced_code: bool = True, cimle: bool = False,
                 noise_dim: int = 32, noise_scale: float = 10.0, cimle_start_epoch: int = 0,
                 add_class_cond: bool = False, cond_noise_type: int = 0,
                 use_linear: bool = True, *, dtype=None, device="cuda", generator=None):
        super().__init__()
        device = resolve_device(device)
        if cimle and cond_noise_type != 0:
            raise NotImplementedError(
                f"aligner cond_noise_type={cond_noise_type} is not ported yet (only 0)"
            )
        g = default_generator(generator)
        self.n_class, self.noise_dim, self.noise_scale = n_class, noise_dim, noise_scale
        self.class_cond, self.add_class_cond, self.cimle = class_cond, add_class_cond, cimle
        self.cimle_start_epoch = cimle_start_epoch
        self.mask_out_unreferenced_code = mask_out_unreferenced_code
        self.use_checkpoint, self.use_linear = use_checkpoint, use_linear
        inner = n_heads * d_head
        in_ch = in_channels + (n_class if class_cond and not add_class_cond else 0)
        in_ch += noise_dim if cimle else 0
        kw = dict(dtype=dtype, device=device)
        self.proj_in = Dense(in_ch, inner, generator=g, **kw)
        if class_cond and add_class_cond:
            self.class_emb = param(torch.randn(n_class, inner, generator=g), device)
        # With CIMLE, pre_norm is built but never applied (a reference quirk the
        # JAX package keeps, ``aligner.py:112-118``); its parameters still load.
        self.pre_norm = LayerNorm(inner, **kw)
        self.blocks = nn.ModuleList(
            BasicTransformerBlock(inner, n_heads, d_head, dropout=dropout, generator=g, **kw)
            if single_attn
            else TwoAttentionBlock(inner, n_heads, d_head, generator=g, **kw)
            for _ in range(depth)
        )
        self.post_norm = LayerNorm(inner, **kw)
        self.proj_out = Dense(inner, out_channels, generator=g, **kw)

    def forward(self, part_code: torch.Tensor, valid_id=None, noise: Optional[torch.Tensor] = None,
                train: bool = False, generator=None):
        """``noise`` (B, noise_dim) is the CIMLE latent; None or a wrong width
        is replaced by zeros (``aligner.py:64-66``). ``train`` turns the
        blocks' dropout on, drawn from ``generator``."""
        B, K, _ = part_code.shape
        if K != self.n_class:
            raise ValueError(f"part_code has {K} parts, the aligner {self.n_class}")
        x = part_code
        if self.class_cond and not self.add_class_cond:
            eye = torch.eye(K, dtype=x.dtype, device=x.device).expand(B, K, K)
            x = torch.cat([x, eye], dim=-1)
        if self.cimle:
            if noise is None or noise.shape[-1] != self.noise_dim:
                noise = torch.zeros(B, self.noise_dim, dtype=x.dtype, device=x.device)
            noise = noise * self.noise_scale
            dt = torch.promote_types(x.dtype, noise.dtype)
            x = torch.cat([x.to(dt), noise[:, None].expand(B, K, self.noise_dim).to(dt)], dim=-1)

        mask = valid_id if self.mask_out_unreferenced_code else None
        h = self.proj_in(x)
        if self.class_cond and self.add_class_cond:
            h = h + self.class_emb[None].to(h.dtype)
        if not self.cimle:
            h = self.pre_norm(h)
        for blk in self.blocks:
            h = blk(h, mask=mask, train=train, generator=generator)
        h = self.proj_out(self.post_norm(h))
        return h[..., :3], h[..., 3:6]
