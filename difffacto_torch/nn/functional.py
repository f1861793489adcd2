"""Plain functions that the layers and the kernels' plain versions share.

They depend on nothing else of the package, so that ``ops/`` (the kernels'
wrappers and plain versions) and ``nn/`` (the modules that call the kernels)
can both import them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu's default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def ln_stats_f32(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with f32 (or wider) statistics, two-pass biased variance,
    result in the statistics' dtype."""
    ln_dt = torch.promote_types(torch.float32, x.dtype)
    xf = x.to(ln_dt)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + eps) * scale.to(ln_dt) + bias.to(ln_dt)


def ln_affine(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``difffacto_tpu/nn/layers.py:ln_affine``: eps 1e-5, output in x.dtype."""
    return ln_stats_f32(x, scale, bias, eps).to(x.dtype)


def small_ctx_attention(q, k, v, mask, scale: float) -> torch.Tensor:
    """Cross attention to a few context tokens, as the trunk and block kernels do it.

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
