"""The part aligner: a small transformer over the K part tokens.

Port of ``difffacto_tpu/models/aligner.py:PartAlignerTransformer``, generation
and training, with the CIMLE noise of every ``cond_noise_type``
(``aligner.py:64-137``): 0, the scaled noise concatenated to every part token
(``pre_norm`` built and never applied, a reference quirk the JAX package
keeps); 1, the noise as an extra token ahead of the parts, masked in,
``pre_norm`` applied, the token stripped after ``post_norm``; 2, adaLN from
the noise in every block; 3, a shift and scale from ``emb_layer`` of silu(noise)
after ``pre_norm``; 4, the noise through the ``emb_layer`` MLP, then
concatenated as in 0. The class embedding is concatenated or added after
``proj_in``. The blocks are built as the JAX block chooses its layout
(``nn/attention.py:transformer_block``); two-attention blocks are for
generation only.

And of ``PartAligner`` (``aligner.py:143-186``), the MLP aligner: the
presence-masked part codes flattened, then two branches ``m`` and ``v``,
each 512 -> 256 -> 64 with BatchNorm and ReLU, then ``fc4`` to 3 K; the
(B, 3, K) result is transposed to (B, K, 3).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.attention import transformer_block
from ..nn.layers import MLP, Dense, LayerNorm, TorchBatchNorm, default_generator, param
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
        g = default_generator(generator)
        self.n_class, self.noise_dim, self.noise_scale = n_class, noise_dim, noise_scale
        self.class_cond, self.add_class_cond, self.cimle = class_cond, add_class_cond, cimle
        self.cond_noise_type = cond_noise_type if cimle else None
        self.cimle_start_epoch = cimle_start_epoch
        self.mask_out_unreferenced_code = mask_out_unreferenced_code
        self.use_checkpoint, self.use_linear = use_checkpoint, use_linear
        inner = n_heads * d_head
        self.inner = inner
        noise_type = self.cond_noise_type
        in_ch = in_channels + (n_class if class_cond and not add_class_cond else 0)
        in_ch += noise_dim if noise_type in (0, 4) else 0
        kw = dict(dtype=dtype, device=device)
        if noise_type == 4:
            self.emb_layer = MLP(noise_dim, (4 * noise_dim, 4 * noise_dim, noise_dim),
                                 generator=g, **kw)
        self.proj_in = Dense(in_ch, inner, generator=g, **kw)
        if class_cond and add_class_cond:
            self.class_emb = param(torch.randn(n_class, inner, generator=g), device)
        if noise_type == 3:
            self.emb_layer = Dense(noise_dim, 2 * inner, generator=g, **kw)
        # With CIMLE of type 0, 2 or 4, pre_norm is built but never applied (a
        # reference quirk the JAX package keeps, ``aligner.py:112-118``); its
        # parameters still load.
        self.pre_norm = LayerNorm(inner, **kw)
        self.blocks = nn.ModuleList(
            transformer_block(inner, n_heads, d_head, dropout=dropout, single_attn=single_attn,
                              adaln=noise_type == 2, y_dim=noise_dim, generator=g, **kw)
            for _ in range(depth)
        )
        self.post_norm = LayerNorm(inner, **kw)
        self.proj_out = Dense(inner, out_channels, generator=g, **kw)

    def forward(self, part_code: torch.Tensor, valid_id=None, noise: Optional[torch.Tensor] = None,
                train: bool = False, generator=None):
        """``noise`` (B, noise_dim) is the CIMLE latent; None or a wrong width
        is replaced by zeros (``aligner.py:64-66``). Type 1 takes a (B, inner)
        noise token; without one (or at another width) the token is zeros
        and masked out, as the JAX module computes it when its caller gives
        no "noise" stream, which none of its callers does (``aligner.py:87-99``).
        ``train`` turns the blocks' dropout on, drawn from ``generator``."""
        B, K, _ = part_code.shape
        if K != self.n_class:
            raise ValueError(f"part_code has {K} parts, the aligner {self.n_class}")
        noise_type = self.cond_noise_type
        x = part_code
        if self.class_cond and not self.add_class_cond:
            eye = torch.eye(K, dtype=x.dtype, device=x.device).expand(B, K, K)
            x = torch.cat([x, eye], dim=-1)
        if self.cimle and noise_type != 1:
            if noise is None or noise.shape[-1] != self.noise_dim:
                noise = torch.zeros(B, self.noise_dim, dtype=x.dtype, device=x.device)
            noise = noise * self.noise_scale
            if noise_type == 4:
                noise = self.emb_layer(noise)
            if noise_type in (0, 4):
                dt = torch.promote_types(x.dtype, noise.dtype)
                x = torch.cat([x.to(dt), noise[:, None].expand(B, K, noise.shape[-1]).to(dt)],
                              dim=-1)

        mask = valid_id if self.mask_out_unreferenced_code else None
        h = self.proj_in(x)
        if self.class_cond and self.add_class_cond:
            h = h + self.class_emb[None].to(h.dtype)
        if noise_type == 1:
            if noise is None or noise.shape[-1] != self.inner:
                token = torch.zeros(B, self.inner, dtype=h.dtype, device=h.device)
                token_mask = torch.zeros(B, 1, dtype=h.dtype, device=h.device)
            else:
                token = noise.to(h.dtype)
                token_mask = torch.ones(B, 1, dtype=h.dtype, device=h.device)
            h = torch.cat([(token * self.noise_scale)[:, None], h], dim=1)
            if mask is not None:
                mask = torch.cat([token_mask, mask.to(h.dtype)], dim=1)
            h = self.pre_norm(h)
        elif noise_type == 3:
            shift, scale = self.emb_layer(torch.nn.functional.silu(noise)).chunk(2, dim=-1)
            h = self.pre_norm(h)
            h = h * (1.0 + scale[:, None]) + shift[:, None]
        elif not self.cimle:
            h = self.pre_norm(h)
        y = noise if noise_type == 2 else None
        for blk in self.blocks:
            h = blk(h, mask=mask, train=train, generator=generator, y=y)
        h = self.post_norm(h)
        if noise_type == 1:
            h = h[:, 1:]
        h = self.proj_out(h)
        return h[..., :3], h[..., 3:6]



def normal_dense(in_features: int, out_features: int, std: float, g: torch.Generator,
                 **kw) -> Dense:
    """A ``Dense`` whose kernel starts from N(0, std^2) (flax
    ``initializers.normal(std)``), the bias at zero."""
    dense = Dense(in_features, out_features, generator=g, **kw)
    with torch.no_grad():
        dense.kernel.copy_(std * torch.randn(in_features, out_features, generator=g))
    return dense


class MLPAlignerBase(nn.Module):
    """The two MLP branches ``m`` and ``v`` of the MLP aligners
    (``aligner.py:152-170``, ``part_encoder_variants.py:49-64``):
    ``fc{1,2,3}_<b>`` 512 -> 256 -> 64, each with ``fc_bn{i}_<b>`` and ReLU,
    then ``fc4_<b>`` to 3 K; kernels from N(0, 0.25^2)."""

    def _build_branches(self, in_features: int, n_class: int, g: torch.Generator, **kw):
        self.n_class = n_class
        dims = (in_features, 512, 256, 64)
        for b in ("m", "v"):
            for i in range(3):
                setattr(self, f"fc{i + 1}_{b}", normal_dense(dims[i], dims[i + 1], 0.25, g, **kw))
                setattr(self, f"fc_bn{i + 1}_{b}", TorchBatchNorm(dims[i + 1], **kw))
            setattr(self, f"fc4_{b}", normal_dense(64, 3 * n_class, 0.25, g, **kw))

    def _branches(self, x: torch.Tensor, train: bool):
        """(B, F) -> mean, logvar each (B, K, 3): each branch's (B, 3 K) read
        as (B, 3, K) and transposed."""
        out = []
        for b in ("m", "v"):
            h = x
            for i in range(1, 4):
                h = torch.relu(getattr(self, f"fc_bn{i}_{b}")(getattr(self, f"fc{i}_{b}")(h), train))
            h = getattr(self, f"fc4_{b}")(h)
            out.append(h.reshape(x.shape[0], 3, self.n_class).transpose(1, 2))
        return tuple(out)


@ENCODERS.register_module()
class PartAligner(MLPAlignerBase):
    """part_code (B, K, width) -> mean, logvar each (B, K, 3). It takes no
    noise; the encoder reads ``cimle``, ``noise_dim`` and
    ``cimle_start_epoch``, fields of the JAX module (``aligner.py:183-186``)."""

    def __init__(self, n_class: int, width: int, cimle: bool = False, noise_dim: int = 32,
                 cimle_start_epoch: int = 0, *, dtype=None, device="cuda", generator=None):
        super().__init__()
        self.cimle, self.noise_dim, self.cimle_start_epoch = cimle, noise_dim, cimle_start_epoch
        self._build_branches(n_class * width, n_class, default_generator(generator),
                             dtype=dtype, device=resolve_device(device))

    def forward(self, part_code, valid_id=None, noise=None, train: bool = False, generator=None):
        B = part_code.shape[0]
        x = (part_code * valid_id[..., None].to(part_code.dtype)).reshape(B, -1)
        return self._branches(x, train)
