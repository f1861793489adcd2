"""Latent-GAN components: generator, critics, their losses and penalties.

Port of ``difffacto_tpu/models/gan.py`` (the reference's latent GAN
baseline): an MLP generator of part codes over a (truncated) Gaussian prior,
a plain and a class-conditional critic, the WGAN, hinge and non-saturating
losses, and the two gradient penalties. Parameters keep flax's names
(``Dense_<k>`` -> ``dense<k>``, ``TorchBatchNorm_<k>`` -> ``bn<k>``,
``LayerNorm_<k>`` -> ``ln<k>``), so ``load_jax_params`` fills each module
from the JAX runner's separate ``g_vars`` and ``d_vars`` trees.

Flax infers a ``Dense``'s input width from its first input, so the JAX
critics ignore their ``in_dim`` field: the JAX ``GanRunner`` builds the
critic with the default 256 and feeds it the flattened codes, K * zdim wide.
Here ``in_dim`` is the width of the flattened input, and ``GanRunner`` passes
the generator's flattened output width, as the JAX runner's
``init(..., fake0)`` takes it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import Dense, LayerNorm, TorchBatchNorm, default_generator
from ..utils.device import randn, resolve_device
from ..utils.gaussian import truncated_normal
from ..utils.registry import DISCRIMINATORS, GENERATORS


@GENERATORS.register_module()
class Generator(nn.Module):
    """MLP latent generator (``gan.py:23-56``): ReLU between the hidden
    layers, an optional BatchNorm after each and after the output."""

    def __init__(self, noise_dim: int = 64, out_dim: int = 256, hidden: Sequence[int] = (256, 512),
                 use_bn: bool = False, output_bn: bool = False, truncate: bool = False,
                 trunc_std: float = 2.0, n_class: int = 4, per_part: bool = True,
                 *, dtype=None, device="cuda", generator=None):
        super().__init__()
        device = resolve_device(device)
        g = default_generator(generator)
        self.noise_dim, self.out_dim, self.n_class = noise_dim, out_dim, n_class
        self.use_bn, self.output_bn, self.per_part = use_bn, output_bn, per_part
        self.truncate, self.trunc_std = truncate, trunc_std
        dims = [noise_dim, *hidden, out_dim]
        self.n = len(hidden) + 1
        for i in range(self.n):
            setattr(self, f"dense{i}", Dense(dims[i], dims[i + 1], dtype=dtype, device=device,
                                             generator=g))
        n_bn = (len(hidden) if use_bn else 0) + (1 if output_bn else 0)
        widths = (list(hidden) if use_bn else []) + ([out_dim] if output_bn else [])
        for i in range(n_bn):
            setattr(self, f"bn{i}", TorchBatchNorm(widths[i], dtype=dtype, device=device))

    @property
    def device(self) -> torch.device:
        return self.dense0.kernel.device

    def noise_shape(self, num: int):
        return (num, self.n_class, self.noise_dim) if self.per_part else (num, self.noise_dim)

    def sample_noise(self, num: int, generator=None) -> torch.Tensor:
        """The prior's draw: (num, n_class, noise_dim), or (num, noise_dim)
        without ``per_part``; truncated to ±trunc_std with ``truncate``."""
        shape = self.noise_shape(num)
        if self.truncate:
            return truncated_normal(shape, generator, trunc_std=self.trunc_std, device=self.device)
        return randn(shape, generator, self.device)

    def forward(self, z: torch.Tensor, train: bool = False) -> torch.Tensor:
        h, bn = z, 0
        for i in range(self.n - 1):
            h = getattr(self, f"dense{i}")(h)
            if self.use_bn:
                h = getattr(self, f"bn{bn}")(h, train=train)
                bn += 1
            h = torch.relu(h)
        h = getattr(self, f"dense{self.n - 1}")(h)
        if self.output_bn:
            h = getattr(self, f"bn{bn}")(h, train=train)
        return h


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1) if x.dim() > 2 else x


@DISCRIMINATORS.register_module()
class Discriminator(nn.Module):
    """MLP critic over latent codes (``gan.py:59-85``): leaky ReLU 0.2, an
    optional BatchNorm and LayerNorm after each hidden layer, an optional
    sigmoid. ``in_dim`` is the flattened input's width (see the module note)."""

    def __init__(self, in_dim: int = 256, hidden: Sequence[int] = (512, 256, 128),
                 use_bn: bool = False, use_ln: bool = False, use_sigmoid: bool = False,
                 *, dtype=None, device="cuda", generator=None):
        super().__init__()
        device = resolve_device(device)
        g = default_generator(generator)
        self.use_bn, self.use_ln, self.use_sigmoid = use_bn, use_ln, use_sigmoid
        dims = [in_dim, *hidden, 1]
        self.n = len(hidden) + 1
        for i in range(self.n):
            setattr(self, f"dense{i}", Dense(dims[i], dims[i + 1], dtype=dtype, device=device,
                                             generator=g))
        for i, f in enumerate(hidden):
            if use_bn:
                setattr(self, f"bn{i}", TorchBatchNorm(f, dtype=dtype, device=device))
            if use_ln:
                setattr(self, f"ln{i}", LayerNorm(f, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = _flat(x)
        for i in range(self.n - 1):
            h = getattr(self, f"dense{i}")(h)
            if self.use_bn:
                h = getattr(self, f"bn{i}")(h, train=train)
            if self.use_ln:
                h = getattr(self, f"ln{i}")(h)
            h = F.leaky_relu(h, 0.2)
        h = getattr(self, f"dense{self.n - 1}")(h)[:, 0]
        return torch.sigmoid(h) if self.use_sigmoid else h


@DISCRIMINATORS.register_module()
class DiscriminatorcGan(nn.Module):
    """Class-conditional critic (``gan.py:88-105``): the condition's one-hot
    joins the flattened code. ``in_dim`` is the flattened code's width."""

    def __init__(self, in_dim: int = 256, n_class: int = 4, hidden: Sequence[int] = (512, 256, 128),
                 *, dtype=None, device="cuda", generator=None):
        super().__init__()
        device = resolve_device(device)
        g = default_generator(generator)
        dims = [in_dim + n_class, *hidden, 1]
        self.n = len(hidden) + 1
        for i in range(self.n):
            setattr(self, f"dense{i}", Dense(dims[i], dims[i + 1], dtype=dtype, device=device,
                                             generator=g))

    def forward(self, x: torch.Tensor, class_onehot: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        h = torch.cat([_flat(x), class_onehot.to(x.dtype)], dim=-1)
        for i in range(self.n - 1):
            h = F.leaky_relu(getattr(self, f"dense{i}")(h), 0.2)
        return getattr(self, f"dense{self.n - 1}")(h)[:, 0]


# ------------------------------------------------------------------ losses
def gen_loss(fake_scores: torch.Tensor, kind: str = "wgan") -> torch.Tensor:
    """Generator loss (``gan.py:109-117``)."""
    if kind in ("wgan", "hinge"):
        return -fake_scores.mean()
    if kind == "ns":
        return -F.logsigmoid(fake_scores).mean()
    raise ValueError(kind)


def dis_loss(real_scores: torch.Tensor, fake_scores: torch.Tensor,
             kind: str = "wgan") -> torch.Tensor:
    """Critic loss (``gan.py:120-133``)."""
    if kind == "wgan":
        return fake_scores.mean() - real_scores.mean()
    if kind == "hinge":
        return torch.relu(1.0 - real_scores).mean() + torch.relu(1.0 + fake_scores).mean()
    if kind == "ns":
        return (-F.logsigmoid(real_scores).mean()
                - torch.log1p(-torch.sigmoid(fake_scores) + 1e-8).mean())
    raise ValueError(kind)


def gradient_penalty(critic_fn, rng, real: torch.Tensor, fake: torch.Tensor, weight: float = 10.0,
                     gp_type: str = "zero_center",
                     eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The critic's gradient penalty (``gan.py:136-159``), differentiable in
    the critic's parameters (``create_graph``).

    ``zero_center``: weight * (mean_b |grad_x d(x_real)|)^2, the square of
    the mean of the per-sample norms (the reference's form).
    ``interpolated``: weight * mean_b (|grad_x d(x)| - 1)^2 at x = real eps +
    fake (1 - eps), with 1e-8 inside the root; ``eps`` (B, 1, ...) injects the
    uniform draw, else it comes from ``rng``, a ``torch.Generator`` (the JAX
    function's key).
    """
    if gp_type == "zero_center":
        x = real.detach().requires_grad_(True)
    elif gp_type == "interpolated":
        if eps is None:
            if rng is None:
                raise ValueError("the interpolated penalty needs a torch.Generator or eps")
            shape = (real.shape[0],) + (1,) * (real.dim() - 1)
            eps = torch.rand(shape, generator=rng, device=real.device, dtype=real.dtype)
        x = (real * eps + fake * (1 - eps)).detach().requires_grad_(True)
    else:
        raise ValueError(gp_type)
    (grads,) = torch.autograd.grad(critic_fn(x).sum(), x, create_graph=True)
    sq = (grads.reshape(grads.shape[0], -1) ** 2).sum(-1)
    if gp_type == "zero_center":
        return weight * torch.sqrt(sq).mean() ** 2
    return weight * ((torch.sqrt(sq + 1e-8) - 1.0) ** 2).mean()
