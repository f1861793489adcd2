"""PointFlow: continuous normalising flows over part-based clouds.

Port of ``difffacto_tpu/models/pointflow.py`` (the reference's flow.py,
cnf.py and odefunc.py). The ODE is integrated by fixed-step RK4, as the JAX
package integrates it in ``lax.scan``: ``steps`` steps over [0, T], or back
with a negative step, one ``ConcatSquashODE`` shared by every step. The
log-density change is the integral of the divergence: exact (one
forward-mode JVP a dimension, ``torch.autograd.forward_ad``) for the 3-D
point flow, or a Hutchinson estimate with one probe ``eps`` (ones unless the
caller passes one) for the latent flows. The training loss differentiates
through the tangents (reverse over forward).

With gradients on, each RK4 step runs under ``torch.utils.checkpoint``: its
activations (four stages, each with a JVP a dimension) are recomputed in the
backward instead of kept for all ``steps``, which changes no number. The JAX
package keeps every step's residuals; neither has an adjoint solver.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.autograd.forward_ad as fwAD
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..nn.layers import Dense, default_generator
from ..utils.device import randn, resolve_device
from ..utils.gaussian import (gaussian_entropy, gaussian_log_likelihood,
                              reparameterize_gaussian, standard_normal_logprob)
from ..utils.registry import ENCODERS, MODELS, build_from_cfg
from . import aligner, pointnet  # noqa: F401  (registers)
from .part_encoder import gather_per_point


class ConcatSquashODE(nn.Module):
    """f(y, t, ctx) (``pointflow.py:24-44``): each layer is
    ``lin(h) * sigmoid(gate([t, ctx])) + bias([t, ctx])`` (``bias_*`` has
    no bias), tanh between the layers. y (..., in_dim), t a scalar, ctx
    (..., context_dim) with y's leading axes."""

    def __init__(self, in_dim: int, context_dim: int, dims: Sequence[int], out_dim: int,
                 *, dtype=None, device="cuda", generator=None):
        super().__init__()
        g = default_generator(generator)
        self.dims, self.out_dim = tuple(dims), out_dim
        kw = dict(dtype=dtype, device=resolve_device(device), generator=g)
        widths = (in_dim,) + self.dims
        for i, f in enumerate(self.dims + (out_dim,)):
            name = str(i) if i < len(self.dims) else "out"
            setattr(self, f"gate_{name}", Dense(context_dim + 1, f, **kw))
            setattr(self, f"bias_{name}", Dense(context_dim + 1, f, use_bias=False, **kw))
            setattr(self, f"lin_{name}", Dense(widths[i], f, **kw))

    def forward(self, y, t, ctx):
        tt = torch.as_tensor(t, dtype=ctx.dtype, device=ctx.device)
        cond = torch.cat([tt.reshape(1).expand(*ctx.shape[:-1], 1), ctx], dim=-1)
        h = y
        names = [str(i) for i in range(len(self.dims))] + ["out"]
        for name in names:
            gate = torch.sigmoid(getattr(self, f"gate_{name}")(cond))
            h = getattr(self, f"lin_{name}")(h) * gate + getattr(self, f"bias_{name}")(cond)
            if name != "out":
                h = torch.tanh(h)
        return h


class CNF(nn.Module):
    """Fixed-step RK4 CNF with the divergence integrated beside y
    (``pointflow.py:47-116``). ``exact_trace``: ``out_dim`` JVPs an
    evaluation (for the 3-D points); otherwise one Hutchinson probe.
    ``context_dim`` is the ctx's width, which flax infers."""

    def __init__(self, dims: Sequence[int] = (256, 256, 256), out_dim: int = 3,
                 steps: int = 20, T: float = 0.5, exact_trace: bool = True,
                 context_dim: int = 1, *, dtype=None, device="cuda", generator=None):
        super().__init__()
        self.out_dim, self.steps, self.T, self.exact_trace = out_dim, steps, T, exact_trace
        self.ode = ConcatSquashODE(out_dim, context_dim, dims, out_dim, dtype=dtype,
                                   device=device, generator=generator)

    def _jvp(self, y, t, ctx, tangent):
        with fwAD.dual_level():
            out = self.ode(fwAD.make_dual(y, tangent), t, ctx)
            val, jvp = fwAD.unpack_dual(out)
        return val, jvp

    def _f_and_div(self, y, t, ctx, eps, with_div: bool):
        """f(y) and, with ``with_div``, its divergence: exact, or ``eps``'s
        Hutchinson estimate."""
        if not with_div:
            return self.ode(y, t, ctx), None
        if not self.exact_trace:
            val, jvp = self._jvp(y, t, ctx, eps)
            return val, (jvp * eps).sum(-1)
        div = torch.zeros(y.shape[:-1], dtype=y.dtype, device=y.device)
        for i in range(self.out_dim):
            basis = torch.zeros_like(y)
            basis[..., i] = 1.0
            val, jvp = self._jvp(y, t, ctx, basis)
            div = div + jvp[..., i]
        return val, div

    def _rk4(self, y, dl, t, dt, ctx, eps):
        """One RK4 step of y and, where ``dl`` is not None, of the divergence's integral."""
        w = dl is not None
        half = t + 0.5 * dt
        k1, d1 = self._f_and_div(y, t, ctx, eps, w)
        k2, d2 = self._f_and_div(y + 0.5 * dt * k1, half, ctx, eps, w)
        k3, d3 = self._f_and_div(y + 0.5 * dt * k2, half, ctx, eps, w)
        k4, d4 = self._f_and_div(y + dt * k3, t + dt, ctx, eps, w)
        y = y + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
        if w:
            dl = dl + dt / 6.0 * (d1 + 2 * d2 + 2 * d3 + d4)
        return y, dl

    def forward(self, y, ctx, logp=None, reverse: bool = False, eps=None,
                divergence: bool = True):
        """y (..., out_dim) integrated over [0, T] (back from T with
        ``reverse``); ctx broadcast to y's leading axes. Returns (y_out,
        delta_logp = -the divergence's integral), or (y_out, logp + delta)
        with ``logp``. ``eps`` is the Hutchinson probe (ones by default);
        ``divergence=False`` integrates y alone and returns None for it."""
        dt = self.T / self.steps
        if reverse:
            dt = -dt
        like = dict(dtype=y.dtype, device=y.device)
        t0, dt_t = torch.tensor(self.T if reverse else 0.0, **like), torch.tensor(dt, **like)
        if eps is None and divergence and not self.exact_trace:
            eps = torch.ones_like(y)
        dl = torch.zeros(y.shape[:-1], **like) if divergence else None
        ckpt = torch.is_grad_enabled() and any(p.requires_grad for p in self.parameters())
        for i in range(self.steps):
            t = t0 + dt_t * i
            if ckpt:
                y, dl = checkpoint(self._rk4, y, dl, t, dt, ctx, eps, use_reentrant=False)
            else:
                y, dl = self._rk4(y, dl, t, dt, ctx, eps)
        if dl is None:
            return y, None
        delta_logp = -dl
        return (y, delta_logp) if logp is None else (y, logp + delta_logp)


@MODELS.register_module()
class PointFlow(nn.Module):
    """The CNF part model (``pointflow.py:119-253``): an encoder's per-part
    posterior, per-part latent CNFs (Hutchinson) for the prior, an optional
    ``part_aligner`` whose means and variances join the point CNF's
    context, and the point CNF (exact divergence) for the reconstruction
    likelihood. ``point_cnf`` and ``latent_cnf`` give ``dims`` and
    ``steps``. ``seed`` fixes the initial weights."""

    def __init__(self, encoder: dict, point_cnf: dict, latent_cnf: dict,
                 part_aligner: Optional[dict] = None, input_dim: int = 3, zdim: int = 128,
                 n_class: int = 4, use_latent_flow: bool = True,
                 use_deterministic_encoder: bool = False, prior_weight: float = 1.0,
                 recon_weight: float = 1.0, entropy_weight: float = 1.0, *, dtype=None,
                 device="cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        kw = dict(dtype=dtype, device=device, generator=g)
        self.encoder = dict(encoder)
        self.input_dim, self.zdim, self.n_class = input_dim, zdim, n_class
        self.use_latent_flow = use_latent_flow
        self.use_deterministic_encoder = use_deterministic_encoder
        self.prior_weight, self.recon_weight = prior_weight, recon_weight
        self.entropy_weight = entropy_weight
        self.encoder_mod = build_from_cfg(dict(encoder), ENCODERS, **kw)
        pc, lc = dict(point_cnf), dict(latent_cnf)
        ctx_dim = n_class * zdim + (6 * n_class if part_aligner else 0)
        self.point_flow = CNF(tuple(pc.get("dims", (256, 256, 256))), input_dim,
                              pc.get("steps", 20), exact_trace=True, context_dim=ctx_dim, **kw)
        if use_latent_flow:
            for i in range(n_class):
                setattr(self, f"latent_flows_{i}", CNF(
                    tuple(lc.get("dims", (256, 256))), zdim, lc.get("steps", 10),
                    exact_trace=False, context_dim=1, **kw))
        self.aligner = build_from_cfg(dict(part_aligner), ENCODERS, **kw) if part_aligner else None

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @property
    def latent_flows(self):
        return [getattr(self, f"latent_flows_{i}") for i in range(self.n_class)]

    def _ctx(self, z, mean, logvar):
        B = z.shape[0]
        ctx = z.reshape(B, -1)
        if mean is not None:
            ctx = torch.cat([ctx, mean.reshape(B, -1), torch.exp(logvar).reshape(B, -1)], dim=-1)
        return ctx

    def loss(self, batch, epoch=0, train: bool = True, rngs=None) -> Dict[str, torch.Tensor]:
        """``fit_loss`` (with the aligner), ``entropy_loss``, ``recon_loss``
        and ``prior_loss`` (``pointflow.py:168-229``). ``latent_eps`` (B, K,
        zdim) injects the posterior draw, else ``rngs["sample"]``; the
        aligner's dropout draws from ``rngs["dropout"]``."""
        rngs = rngs or {}
        x, ref = batch["input"], batch["ref"]
        seg_mask, seg_flag = batch["ref_seg_mask"].int(), batch["attn_map"]
        valid_id = batch["present"]
        B, N, _ = ref.shape
        if self.encoder["type"] == "PointNetV2":
            z_mu, z_sigma = self.encoder_mod(x, seg_flag, train=True)
        else:  # whole-cloud VAE encoders take [xyz | part one-hot]
            z_mu, z_sigma = self.encoder_mod(torch.cat([x, seg_flag.to(x.dtype)], dim=-1),
                                             train=True)
        if self.use_deterministic_encoder:
            z = z_mu
            entropy = torch.zeros(B, dtype=ref.dtype, device=ref.device)
        else:
            z = reparameterize_gaussian(z_mu, z_sigma, rngs.get("sample"), batch.get("latent_eps"))
            entropy = gaussian_entropy(z_sigma.reshape(B * self.n_class, -1), axis=-1)

        loss_dict = {}
        mean = logvar = None
        if self.aligner is not None:
            mean, logvar = self.aligner(z, valid_id, train=True, generator=rngs.get("dropout"))
            loss_dict["fit_loss"] = -gaussian_log_likelihood(
                ref, gather_per_point(mean, seg_mask), gather_per_point(logvar, seg_mask)).mean()

        if self.use_latent_flow:
            parts = []
            for i, flow in enumerate(self.latent_flows):
                w, delta = flow(z[:, i], torch.zeros(B, 1, dtype=z.dtype, device=z.device))
                parts.append(standard_normal_logprob(w).sum(-1) - delta * valid_id[:, i])
            log_pz = torch.stack(parts, 1).sum(1) / valid_id.sum(1)
        else:
            log_pz = torch.zeros(B, dtype=ref.dtype, device=ref.device)

        ctx = self._ctx(z, mean, logvar)
        y, delta_log_py = self.point_flow(ref, ctx[:, None].expand(B, N, ctx.shape[-1]))
        log_px = standard_normal_logprob(y).sum(-1).sum(-1) - delta_log_py.sum(-1)
        loss_dict["entropy_loss"] = -entropy.mean() * self.entropy_weight
        loss_dict["recon_loss"] = -log_px.mean() * self.recon_weight / N
        loss_dict["prior_loss"] = -log_pz.mean() * self.prior_weight
        return loss_dict

    @torch.inference_mode()
    def sample(self, sample_num: int, num_points: int, valid_id=None,
               generator: Optional[torch.Generator] = None, w=None, y=None):
        """(z (S, K, zdim), points (S, num_points, input_dim)): latents from
        the latent CNFs run back from ``w``, points from the point CNF run
        back from ``y``. ``w`` and ``y`` inject the two normal draws, else
        ``generator`` draws them. The divergences, which sampling discards,
        are not integrated."""
        dev = self.device
        if w is None:
            w = randn((sample_num, self.n_class, self.zdim), generator, dev)
        if self.use_latent_flow:
            zero = torch.zeros(sample_num, 1, device=dev)
            z = torch.stack([flow(w[:, i], zero, reverse=True, divergence=False)[0]
                             for i, flow in enumerate(self.latent_flows)], 1)
        else:
            z = w
        if valid_id is None:
            valid_id = torch.ones(sample_num, self.n_class, device=dev)
        mean = logvar = None
        if self.aligner is not None:
            mean, logvar = self.aligner(z, valid_id)
        ctx = self._ctx(z, mean, logvar)
        if y is None:
            y = randn((sample_num, num_points, self.input_dim), generator, dev)
        pts, _ = self.point_flow(y, ctx[:, None].expand(sample_num, num_points, ctx.shape[-1]),
                                 reverse=True, divergence=False)
        return z, pts
