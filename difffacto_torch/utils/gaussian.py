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


def normal_kl(mean1, logvar1, mean2, logvar2, dim: int = 3):
    """KL between diagonal gaussians, elementwise."""
    return 0.5 * (
        -dim + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
        + (mean1 - mean2) ** 2 * torch.exp(-logvar2)
    )
