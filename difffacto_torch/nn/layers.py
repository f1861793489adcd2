"""Shared layers, channel-last, with the JAX package's parameter layout.

Port of the pieces of ``difffacto_tpu/nn/layers.py`` that generation, the
training step and the UNet denoiser use.
Parameters keep flax's names and layout (a dense kernel is (in, out)) so the
weight bridge (``utils/jax_params.py``) is a renaming, not a rewrite.

``dtype`` is the compute dtype, as flax's ``dtype=`` argument: parameters are
stored in float32 and cast to it at use; ``None`` computes in the input's
dtype. Initial values come from an explicit ``torch.Generator`` on the CPU, so
a seed gives the same weights on every device.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..ops.fused_ff import fused_ln_geglu_ff, pick_tile
from ..parallel.axes import point_axis, psum_points, sp_size
from ..ops.fused_ff import takes as ff_takes
from ..utils.device import kernel_dtype
from .functional import gelu, ln_stats_f32

_TRUNC_STD = 0.87962566103423978  # std of a standard normal truncated to [-2, 2]


def default_generator(generator: Optional[torch.Generator]) -> torch.Generator:
    return generator if generator is not None else torch.Generator().manual_seed(0)


def lecun_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """flax ``lecun_normal``: truncated normal on [-2, 2], variance 1/fan_in.

    For a (..., in, out) kernel fan_in is ``in`` times the leading dims.
    """
    fan_in = math.prod(shape[:-1])
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=generator, dtype=torch.float64) * (hi - lo) + lo
    z = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
    return (z * (math.sqrt(1.0 / fan_in) / _TRUNC_STD)).float()


def param(value: torch.Tensor, device) -> nn.Parameter:
    # Trainable; the generation entry points run under ``torch.inference_mode``.
    return nn.Parameter(value.to(device))


def dropout(x: torch.Tensor, p: float, train: bool, generator=None) -> torch.Tensor:
    """Inverted dropout with an explicit generator: the identity unless
    ``train`` and p > 0 (flax ``nn.Dropout``: keep with 1 - p, scale 1 / (1 - p))."""
    if not train or p <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return x * keep.to(x.dtype) / (1.0 - p)


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embeddings: (B,) -> (B, dim) float32, [cos | sin] halves
    (``difffacto_tpu/nn/layers.py:23-36``)."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device)
        / half
    )
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias`` with kernel (in, out); no bias
    with ``use_bias=False``."""

    def __init__(self, in_features: int, out_features: int, *, zero_kernel: bool = False,
                 use_bias: bool = True, dtype=None, device="cuda", generator=None):
        super().__init__()
        self.dtype = dtype
        g = default_generator(generator)
        kernel = (
            torch.zeros(in_features, out_features)
            if zero_kernel
            else lecun_normal((in_features, out_features), g)
        )
        self.kernel = param(kernel, device)
        self.bias = param(torch.zeros(out_features), device) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, self.kernel.dtype)
        y = torch.matmul(x.to(dt), self.kernel.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` (eps 1e-5): f32 statistics with flax's fast
    variance E[x^2] - E[x]^2 clipped at 0, result in ``dtype`` (else the
    input's dtype promoted with the f32 parameters)."""

    def __init__(self, dim: int, *, dtype=None, device="cuda"):
        super().__init__()
        self.dtype = dtype
        self.scale = param(torch.ones(dim), device)
        self.bias = param(torch.zeros(dim), device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        st = torch.promote_types(self.dtype or x.dtype, torch.float32)
        xf = x.to(st)
        mu = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
        y = (xf - mu) * (torch.rsqrt(var + 1e-5) * self.scale.to(st)) + self.bias.to(st)
        return y.to(self.dtype or torch.promote_types(x.dtype, self.scale.dtype))


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` without a dtype, over x (B, ..., C): per batch row
    and group of C / num_groups channels, f32 statistics over every other axis
    with flax's fast variance E[x^2] - E[x]^2 clipped at 0; result in the
    input's dtype promoted with the f32 parameters."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-6, *, device="cuda"):
        super().__init__()
        if channels % num_groups:
            raise ValueError(f"{num_groups} groups do not divide {channels} channels")
        self.num_groups, self.eps = num_groups, eps
        self.scale = param(torch.ones(channels), device)
        self.bias = param(torch.zeros(channels), device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        st = torch.promote_types(x.dtype, torch.float32)
        B, C = x.shape[0], x.shape[-1]
        grouped = (self.num_groups, C // self.num_groups)
        xf = x.to(st).reshape(B, -1, *grouped)
        mu = xf.mean((1, 3), keepdim=True)
        var = torch.clamp((xf * xf).mean((1, 3), keepdim=True) - mu * mu, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale.to(st).reshape(grouped)
        return ((xf - mu) * mul + self.bias.to(st).reshape(grouped)).reshape(x.shape)


class GEGLU(nn.Module):
    """x, gate = proj(x).chunk(2); x * gelu(gate) (``nn/layers.py:59-69``)."""

    def __init__(self, dim_in: int, dim_out: int, *, dtype=None, device="cuda", generator=None):
        super().__init__()
        self.dense0 = Dense(dim_in, 2 * dim_out, dtype=dtype, device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, gate = self.dense0(x).chunk(2, dim=-1)
        return a * gelu(gate)


class FeedForward(nn.Module):
    """The transformer MLP (``nn/layers.py:72-91``): a GEGLU gate with
    ``glu=True`` (the denoiser's ``time_embed``), else dense + gelu; dropout
    on the inner activations when training. flax names the layers in order:
    with the gate ``geglu`` then ``dense0``, without it ``dense0`` (in) and
    ``dense1`` (out)."""

    def __init__(self, dim: int, mult: int = 4, dropout: float = 0.0, glu: bool = True,
                 *, dtype=None, device="cuda", generator=None):
        super().__init__()
        g = default_generator(generator)
        self.dropout, self.glu = dropout, glu
        kw = dict(dtype=dtype, device=device, generator=g)
        if glu:
            self.geglu = GEGLU(dim, dim * mult, **kw)
            self.dense0 = Dense(dim * mult, dim, **kw)
        else:
            self.dense0 = Dense(dim, dim * mult, **kw)
            self.dense1 = Dense(dim * mult, dim, **kw)

    def forward(self, x: torch.Tensor, train: bool = False, generator=None) -> torch.Tensor:
        if self.glu:
            return self.dense0(dropout(self.geglu(x), self.dropout, train, generator))
        return self.dense1(dropout(gelu(self.dense0(x)), self.dropout, train, generator))


class MLP(nn.Module):
    """Dense layers with ReLU between (``nn/layers.py:223-236``), as the
    aligner's noise embedding of ``cond_noise_type=4``."""

    def __init__(self, in_features: int, features, *, dtype=None, device="cuda",
                 generator=None):
        super().__init__()
        g = default_generator(generator)
        dims = [in_features, *features]
        self.n = len(features)
        for i in range(self.n):
            setattr(self, f"dense{i}", Dense(dims[i], dims[i + 1], dtype=dtype, device=device,
                                             generator=g))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"dense{i}")(x)
            if i < self.n - 1:
                x = torch.relu(x)
        return x


def ff_kernel_takes(width: int, tokens: int, needs_grad: bool = False) -> bool:
    """The rule of ``FusedLNFF``: the fused FF kernel where it takes the width,
    ``pick_tile`` takes the token count and no gradient is asked for; the
    unfused math otherwise. The kernel has no backward in either package (the
    JAX module takes its kernel only when deterministic and differentiates the
    unfused composition, ``nn/layers.py:130-136``), so under autograd, as when
    shape editing differentiates through the aligner, the module computes the
    unfused math; under ``inference_mode`` or ``no_grad`` it launches the kernel."""
    return not needs_grad and ff_takes(width) and bool(pick_tile(tokens))


class FusedLNFF(nn.Module):
    """Pre-LN GEGLU feed-forward with residual, ``x + FF(LN(x))``
    (``difffacto_tpu/nn/layers.py:94-170``), parameters flat: ``ln_scale``,
    ``ln_bias``, ``w1`` (D, 8 D), ``b1``, ``w2`` (4 D, D), ``b2``.

    x (B, N, D) at the shapes ``ff_kernel_takes`` accepts (D 128 or 256,
    ``pick_tile(B N)`` not 0, no gradient asked for) goes through
    ``ops/fused_ff.fused_ln_geglu_ff``
    (the kernel on the card, its plain version on the CPU); any other input
    through the unfused composition, whose GEGLU runs in the compute dtype.
    The JAX package takes its kernel at any D that 128 divides. With
    ``train=True`` it computes the unfused math with dropout on the GEGLU
    activations, as the JAX package trains it.
    """

    def __init__(self, dim: int, mult: int = 4, dropout: float = 0.0,
                 *, dtype=None, device="cuda", generator=None):
        super().__init__()
        g = default_generator(generator)
        self.dtype, self.dropout = dtype, dropout
        inner = dim * mult
        self.ln_scale = param(torch.ones(dim), device)
        self.ln_bias = param(torch.zeros(dim), device)
        self.w1 = param(lecun_normal((dim, 2 * inner), g), device)
        self.b1 = param(torch.zeros(2 * inner), device)
        self.w2 = param(lecun_normal((inner, dim), g), device)
        self.b2 = param(torch.zeros(dim), device)

    def forward(self, x: torch.Tensor, train: bool = False, generator=None) -> torch.Tensor:
        cdt = self.dtype or x.dtype
        D = x.shape[-1]
        needs_grad = torch.is_grad_enabled() and (x.requires_grad or self.w1.requires_grad)
        if not train and x.ndim == 3 and ff_kernel_takes(D, x.shape[0] * x.shape[1], needs_grad):
            kdt = kernel_dtype(x.device, cdt)
            out = fused_ln_geglu_ff(
                x.reshape(-1, D).to(kdt).contiguous(), self.ln_scale.to(kdt),
                self.ln_bias.to(kdt), self.w1.to(kdt), self.b1.float(), self.w2.to(kdt),
                self.b2.float())
            return out.reshape(x.shape).to(x.dtype)
        h = ln_stats_f32(x.float(), self.ln_scale, self.ln_bias).to(cdt)
        a, g = (h @ self.w1.to(cdt) + self.b1.to(cdt)).chunk(2, dim=-1)
        act = dropout(a * gelu(g), self.dropout, train, generator)
        out = act @ self.w2.to(cdt) + self.b2.to(cdt)
        return x + out.to(x.dtype)


class TorchBatchNorm(nn.Module):
    """BatchNorm over the last axis as ``difffacto_tpu/nn/layers.py:TorchBatchNorm``
    (flax ``nn.BatchNorm``, eps 1e-5) computes it.

    ``shape`` is (C,) or, for the stacked per-part heads, (K, C): the
    statistics reduce over every leading axis of x that ``shape`` does not
    cover. In training the batch mean and the *biased* batch variance
    E[x^2] - E[x]^2 (clipped at 0, f32) normalise x and move the running
    statistics by ``running = 0.9 running + 0.1 batch``; torch's own
    BatchNorm1d would store the unbiased variance. In eval the running
    statistics normalise.

    Under a point-sharded training step (``parallel/axes.py``) the batch
    statistics span every point shard of the (B, N) slab, as the JAX
    ``TorchBatchNorm`` passes the point axis to flax; the data axis stays
    local, and the step averages the running statistics afterwards.
    """

    def __init__(self, shape, momentum: float = 0.1, eps: float = 1e-5,
                 *, dtype=None, device="cuda"):
        super().__init__()
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        self.momentum, self.eps, self.dtype = momentum, eps, dtype
        self.scale = param(torch.ones(shape), device)
        self.bias = param(torch.zeros(shape), device)
        self.register_buffer("mean", torch.zeros(shape, device=device))
        self.register_buffer("var", torch.ones(shape, device=device))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        st = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(st)
        if train:
            dims = tuple(range(x.ndim - self.scale.ndim))
            mean, mean2 = xf.mean(dims), (xf * xf).mean(dims)
            if point_axis() is not None:
                mean, mean2 = (psum_points(torch.stack([mean, mean2])) / sp_size()).unbind(0)
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            with torch.no_grad():
                self.mean.mul_(1.0 - self.momentum).add_(self.momentum * mean.to(self.mean.dtype))
                self.var.mul_(1.0 - self.momentum).add_(self.momentum * var.to(self.var.dtype))
        else:
            mean, var = self.mean.to(st), self.var.to(st)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.scale.to(st)) + self.bias.to(st)
        return y.to(self.dtype or torch.promote_types(x.dtype, self.scale.dtype))


class ConvBNReLUStack(nn.Module):
    """The 1x1-conv + BN + ReLU point stack (``nn/layers.py:299-319``): ReLU
    after every layer but, unless ``relu_last``, the last."""

    def __init__(self, in_features: int, features, relu_last: bool = False,
                 *, dtype=None, device="cuda", generator=None):
        super().__init__()
        g = default_generator(generator)
        self.relu_last = relu_last
        dims = [in_features, *features]
        for i in range(len(features)):
            setattr(self, f"dense{i}", Dense(dims[i], dims[i + 1], dtype=dtype, device=device,
                                             generator=g))
            setattr(self, f"bn{i}", TorchBatchNorm(dims[i + 1], dtype=dtype, device=device))
        self.n = len(features)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"bn{i}")(getattr(self, f"dense{i}")(x), train)
            if i < self.n - 1 or self.relu_last:
                x = torch.relu(x)
        return x
