"""Anchored Gaussian diffusion: the reverse chain of generation and the training loss.

Port of the gen_chair branches of ``difffacto_tpu/models/diffusion.py``
(reference anchored_diffusion.py): the epsilon mean, the ``fixed_small``
variance scaled by the per-point variance L^2, ``p_sample`` and
``p_sample_loop`` as a Python loop over descending steps (with the
trajectory of every ``ret_interval``-th step), and for training ``q_sample``
and the mse ``training_losses``. The chain stays in float32 whatever the
denoiser's compute dtype (``diffusion.py:373-378``). The other mean and
variance types (and with them the variational-bound term), DDIM and guidance
raise ``NotImplementedError`` (``ROADMAP.md`` queue A item 4).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..ops.schedule import DiffusionSchedule, extract, make_schedule
from ..utils.device import randn
from ..utils.registry import DIFFUSIONS

EPSILON = "epsilon"
FIXED_SMALL = "fixed_small"


@DIFFUSIONS.register_module()
class AnchoredDiffusion:
    """Constructor arguments mirror the JAX dataclass; this object is math
    over the schedule tables, and the denoiser comes in as ``model_fn``."""

    def __init__(self, num_timesteps: int, beta_1: float, beta_T: float, k: float = 1.0,
                 res: bool = True, mode: str = "linear", use_beta: bool = True,
                 rescale_timesteps: bool = False, model_mean_type: str = EPSILON,
                 model_var_type: str = FIXED_SMALL, clip_xstart: bool = False,
                 include_anchors: bool = True, include_cov: bool = False,
                 learn_anchor: bool = True, learn_variance: bool = False,
                 classifier_weight: float = 1.0, guidance: bool = False,
                 ddim_sampling: bool = False, ddim_nsteps: int = 10,
                 ddim_discretize: str = "uniform", ddim_eta: float = 1.0,
                 loss_type: str = "mse", scale_loss: bool = False, net=None):
        unported = {
            "model_mean_type": (model_mean_type, EPSILON),
            "model_var_type": (model_var_type, FIXED_SMALL),
            "guidance": (guidance, False),
            "ddim_sampling": (ddim_sampling, False),
            "loss_type": (loss_type, "mse"),
        }
        for key, (got, ported) in unported.items():
            if got != ported:
                raise NotImplementedError(f"AnchoredDiffusion {key}={got!r} is not ported yet "
                                          "(ROADMAP.md, queue A item 4)")
        self.num_timesteps, self.k, self.res = num_timesteps, k, res
        self.use_beta, self.rescale_timesteps = use_beta, rescale_timesteps
        self.clip_xstart, self.include_anchors, self.include_cov = clip_xstart, include_anchors, include_cov
        self.learn_anchor, self.learn_variance = learn_anchor, learn_variance
        self.scale_loss = scale_loss
        # Read by guidance and DDIM only, which raise above; kept so that a
        # config's keys all reach the object.
        self.classifier_weight, self.ddim_nsteps = classifier_weight, ddim_nsteps
        self.ddim_discretize, self.ddim_eta = ddim_discretize, ddim_eta
        self.schedule = make_schedule(num_timesteps, beta_1, beta_T, mode)
        self._on_device: Dict[torch.device, DiffusionSchedule] = {}

    def tables(self, device) -> DiffusionSchedule:
        device = torch.device(device)
        if device not in self._on_device:
            self._on_device[device] = self.schedule.to(device)
        return self._on_device[device]

    def _anchors(self, anchors):
        return anchors if self.learn_anchor else torch.zeros_like(anchors)

    def _variance(self, variance, like):
        """Per-point variance L^2; k^2 when it is not learned."""
        if self.learn_variance:
            if variance is None:
                raise ValueError("learn_variance=True needs the per-point variance")
            return variance
        return torch.full_like(like, self.k * self.k)

    def scale_timesteps(self, t, s: DiffusionSchedule):
        if self.rescale_timesteps:
            return t.float() * (1000.0 / self.num_timesteps)
        if self.use_beta:
            return s.betas[t.long()]
        return t

    def model_input(self, x, anchors, variance):
        inp = x - anchors if self.res else x
        if self.include_anchors:
            inp = torch.cat([inp, anchors], dim=-1)
        if self.include_cov:
            inp = torch.cat([inp, variance], dim=-1)
        return inp

    def q_sample(self, x_start, t, anchors, noise=None, variance=None, generator=None):
        """The anchored forward kernel (``diffusion.py:134-147``); ``noise``
        injects the Gaussian draw."""
        s = self.tables(x_start.device)
        anchors = self._anchors(anchors)
        if noise is None:
            noise = randn(x_start.shape, generator, x_start.device, x_start.dtype)
        L = torch.sqrt(self._variance(variance, x_start))
        nd = x_start.ndim
        return (
            extract(s.sqrt_alphas_cumprod, t, nd) * (x_start - anchors)
            + anchors
            + extract(s.sqrt_one_minus_alphas_cumprod, t, nd) * L * noise
        )

    def training_losses(self, model_fn: Callable, x_start, t, anchors=None, variance=None,
                        ctx=None, seg_mask=None, valid_id=None, flags=None, noise=None,
                        reduce: bool = True, generator=None):
        """The mse training loss of the epsilon mean (``diffusion.py:468-549``).

        ``flags`` (B, N) masks the points of dropped parts; ``noise`` injects
        the diffusion draw. Returns {'mse_loss'}."""
        s = self.tables(x_start.device)
        if anchors is None:
            anchors = torch.zeros_like(x_start)
        if noise is None:
            noise = randn(x_start.shape, generator, x_start.device, x_start.dtype)
        x_t = self.q_sample(x_start, t, anchors, noise=noise, variance=variance)
        model_output = model_fn(self.model_input(x_t, anchors, variance),
                                self.scale_timesteps(t, s), ctx, anchors, variance, seg_mask,
                                valid_id)
        diff = (noise - model_output) ** 2  # the epsilon target
        if flags is not None:
            diff = diff * flags[..., None]
        if reduce:
            if flags is not None:
                diff = diff.mean(-1).sum() / flags.sum()
            else:
                diff = diff.sum() / diff.numel()
        if self.scale_loss:
            b, acp = extract(s.betas, t, diff.ndim), extract(s.alphas_cumprod, t, diff.ndim)
            diff = diff * b * b / (2 * (1.0 - b) * (1.0 - acp))
        return {"mse_loss": diff}

    def p_mean_variance(self, model_fn: Callable, x, t, anchors, ctx=None, variance=None,
                        seg_mask=None, valid_id=None):
        """Posterior mean and variance from the predicted epsilon
        (``diffusion.py:204-320``, epsilon mean, fixed_small variance)."""
        s = self.tables(x.device)
        nd = x.ndim
        eps = model_fn(self.model_input(x, anchors, variance), self.scale_timesteps(t, s),
                       ctx, anchors, variance, seg_mask, valid_id)
        variance = self._variance(variance, x)
        L = torch.sqrt(variance)
        model_variance = extract(s.posterior_variance, t, nd) * variance
        a = self._anchors(anchors)
        pred_xstart = (
            extract(s.sqrt_recip_alphas_cumprod, t, nd) * (x - a)
            + a
            - extract(s.sqrt_recipm1_alphas_cumprod, t, nd) * L * eps
        )
        if self.clip_xstart:
            pred_xstart = torch.clamp(pred_xstart, -10, 10)
        mean = (
            extract(s.posterior_mean_coef1, t, nd) * pred_xstart
            + extract(s.posterior_mean_coef2, t, nd) * x
            + extract(s.posterior_mean_coef3, t, nd) * a
        )
        return {"mean": mean, "variance": model_variance, "pred_xstart": pred_xstart}

    def p_sample(self, model_fn, x, t, anchors, ctx=None, variance=None, seg_mask=None,
                 valid_id=None, noise=None, generator=None):
        """One reverse step; ``noise`` injects the Gaussian draw."""
        out = self.p_mean_variance(model_fn, x, t, anchors, ctx, variance, seg_mask, valid_id)
        if noise is None:
            noise = randn(x.shape, generator, x.device, x.dtype)
        nonzero = (t != 0).to(x.dtype).reshape((-1,) + (1,) * (x.ndim - 1))
        sample = out["mean"] + nonzero * torch.sqrt(out["variance"]) * noise
        return {"sample": sample, "pred_xstart": out["pred_xstart"]}

    def p_sample_loop(self, model_fn, anchors, ctx=None, variance=None, seg_mask=None,
                      valid_id=None, noise=None, ret_traj: bool = False, ret_interval: int = 20,
                      step_noise=None, generator: Optional[torch.Generator] = None):
        """The whole reverse chain over steps T-1 .. 0.

        ``noise`` injects x_T and ``step_noise`` (T, B, N, 3) the per-step
        draws, in the order the steps run (descending t). Returns {'pred'};
        with ``ret_traj`` also 'traj' (T_kept, B, N, 3), the sample each step
        t with t % ``ret_interval`` == 0 returned, and 'traj_t' (T_kept,) those
        t in descending order (``diffusion.py:419-422``). Only the kept
        samples are stored.
        """
        anchors = anchors.float()
        if variance is not None:
            variance = variance.float()
        if noise is None:
            L = torch.sqrt(self._variance(variance, anchors))
            x = L * randn(anchors.shape, generator, anchors.device) + (
                anchors if self.learn_anchor else 0.0
            )
        else:
            x = noise.float()
        B = x.shape[0]
        traj, traj_t = [], []
        for i, step in enumerate(range(self.num_timesteps - 1, -1, -1)):
            t = torch.full((B,), step, dtype=torch.long, device=x.device)
            eps = None if step_noise is None else step_noise[i].float()
            x = self.p_sample(model_fn, x, t, anchors, ctx, variance, seg_mask, valid_id,
                              noise=eps, generator=generator)["sample"]
            if ret_traj and step % ret_interval == 0:
                traj.append(x)  # p_sample returns a new tensor: x is never written
                traj_t.append(step)
        out = {"pred": x}
        if ret_traj:
            out["traj"] = torch.stack(traj)
            out["traj_t"] = np.asarray(traj_t, np.int32)
        return out
