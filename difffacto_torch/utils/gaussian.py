"""Gaussian math helpers, with the reference's quirks kept.

Port of ``difffacto_tpu/utils/gaussian.py``. ``gaussian_log_likelihood`` uses
``-logvar`` (not halved) and a per-element constant of ``-0.5 log(2 pi) dim``;
training used these formulas, so changing either would change every prior and
fit loss.
"""

from __future__ import annotations

import math

import torch

from .device import randn

LOG_2PI = math.log(2.0 * math.pi)


def reparameterize_gaussian(mean, logvar, generator=None, eps=None):
    """mean + exp(logvar / 2) * eps; ``eps`` injects the standard normal draw."""
    if eps is None:
        eps = randn(mean.shape, generator, mean.device, mean.dtype)
    return mean + torch.exp(0.5 * logvar) * eps.to(mean.dtype)


def gaussian_entropy(logvar, axis: int = -1):
    """0.5 sum(logvar) + 0.5 D (1 + log(2 pi)) over ``axis``."""
    D = logvar.shape[axis]
    return 0.5 * logvar.sum(axis) + 0.5 * float(D) * (1.0 + LOG_2PI)


def gaussian_log_likelihood(z, mean=None, logvar=None, dim: int = 3):
    """Elementwise quasi-log-density: the logvar term is not halved and the
    2 pi constant is scaled by ``dim`` per element."""
    log_z = -0.5 * LOG_2PI * dim
    if logvar is None:
        var, logvar = 1.0, 0.0
    else:
        var = torch.exp(logvar) if isinstance(logvar, torch.Tensor) else math.exp(logvar)
    if mean is None:
        mean = 0.0
    return -logvar + log_z - (z - mean) ** 2 / (2.0 * var)


def standard_normal_logprob(z):
    """-0.5 D log(2 pi) - z^2 / 2, elementwise, D the last axis's width."""
    return -0.5 * z.shape[-1] * LOG_2PI - z**2 / 2.0


def normal_kl(mean1, logvar1, mean2, logvar2, dim: int = 3):
    """KL between diagonal gaussians, elementwise."""
    return 0.5 * (
        -dim + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
        + (mean1 - mean2) ** 2 * torch.exp(-logvar2)
    )


def truncated_normal(shape, generator, mean: float = 0.0, std: float = 1.0,
                     trunc_std: float = 2.0, device="cpu", dtype=torch.float32) -> torch.Tensor:
    """A standard normal truncated to [-trunc_std, trunc_std] by the inverse
    CDF, times ``std`` plus ``mean``. Its support and moments are
    ``jax.random.truncated_normal``'s; its draws, from ``generator``, are not."""
    if generator is None:
        raise ValueError("this draw needs a torch.Generator (or pass the tensor to inject)")
    lo = 0.5 * (1.0 + math.erf(-trunc_std / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(trunc_std / math.sqrt(2.0)))
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float64)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + (hi - lo) * u) - 1.0)
    return (z.clamp(-trunc_std, trunc_std) * std + mean).to(dtype)
