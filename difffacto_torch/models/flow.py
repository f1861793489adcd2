"""Latent normalizing flow (affine coupling) for the per-part prior.

Port of ``difffacto_tpu/models/flow.py``: ``n_class`` independent chains of
affine coupling layers with alternating swaps. Generation runs them in
reverse to turn Gaussian draws into part codes; training runs them forward
with the log-density change ``logpx`` for the prior loss.
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn.layers import Dense, default_generator


class CouplingLayer(nn.Module):
    """Affine coupling y2 = x2 * sigmoid(s + 2) + t (``flow.py:20-68``)."""

    def __init__(self, dim: int, intermediate_dim: int, swap: bool = False,
                 *, dtype=None, device="cuda", generator=None):
        super().__init__()
        g = default_generator(generator)
        self.swap = swap
        self.d = dim - dim // 2
        kw = dict(dtype=dtype, device=device, generator=g)
        self.dense0 = Dense(self.d, intermediate_dim, **kw)
        self.dense1 = Dense(intermediate_dim, intermediate_dim, **kw)
        # Zero-initialised s/t head, as the JAX package: every untrained layer
        # is a fixed affine map (scale sigmoid(2), shift 0), so the untrained
        # inverse stays finite (``flow.py:39-49``).
        self.dense2 = Dense(intermediate_dim, 2 * (dim - self.d), zero_kernel=True, **kw)

    def forward(self, x: torch.Tensor, logpx=None, reverse: bool = False):
        """x (B, dim); with ``logpx`` (B, 1) returns (y, logpx -+ log|det J|)."""
        d = self.d
        if self.swap:
            x = torch.cat([x[:, d:], x[:, :d]], dim=1)
        out_dim = x.shape[1] - d
        h = torch.relu(self.dense0(x[:, :d]))
        h = torch.relu(self.dense1(h))
        s_t = self.dense2(h)
        scale = torch.sigmoid(s_t[:, :out_dim] + 2.0)
        shift = s_t[:, out_dim:]
        y1 = (x[:, d:] - shift) / scale if reverse else x[:, d:] * scale + shift
        y = torch.cat([y1, x[:, :d]] if self.swap else [x[:, :d], y1], dim=1)
        if logpx is None:
            return y
        logdetjac = torch.log(scale).sum(dim=1, keepdim=True)
        return y, logpx + (logdetjac if reverse else -logdetjac)


class SequentialFlow(nn.Module):
    """Chain of coupling layers, swapping on even indices (``flow.py:71-95``)."""

    def __init__(self, depth: int, dim: int, intermediate_dim: int,
                 *, dtype=None, device="cuda", generator=None):
        super().__init__()
        g = default_generator(generator)
        self.chain = nn.ModuleList(
            CouplingLayer(dim, intermediate_dim, swap=(i % 2 == 0),
                          dtype=dtype, device=device, generator=g)
            for i in range(depth)
        )

    def forward(self, x: torch.Tensor, logpx=None, reverse: bool = False):
        for layer in (reversed(self.chain) if reverse else self.chain):
            if logpx is None:
                x = layer(x, reverse=reverse)
            else:
                x, logpx = layer(x, logpx, reverse=reverse)
        return x if logpx is None else (x, logpx)


class PerPartFlow(nn.Module):
    """``n_class`` independent flows, one per part (``flow.py:98-121``).

    x: (B, K, D). The JAX package vmaps one chain over the part axis with
    separate parameters; here each part has its own ``SequentialFlow``.
    """

    def __init__(self, n_class: int, depth: int, dim: int, intermediate_dim: int,
                 *, dtype=None, device="cuda", generator=None):
        super().__init__()
        g = default_generator(generator)
        self.flows = nn.ModuleList(
            SequentialFlow(depth, dim, intermediate_dim, dtype=dtype, device=device, generator=g)
            for _ in range(n_class)
        )

    def forward(self, x: torch.Tensor, logpx=None, reverse: bool = True):
        """x (B, K, D); with ``logpx`` (B, K, 1) returns (y, logpx)."""
        if logpx is None:
            return torch.stack([f(x[:, k], reverse=reverse) for k, f in enumerate(self.flows)], dim=1)
        outs = [f(x[:, k], logpx[:, k], reverse=reverse) for k, f in enumerate(self.flows)]
        return torch.stack([o[0] for o in outs], dim=1), torch.stack([o[1] for o in outs], dim=1)
