"""Anchored Gaussian diffusion: the reverse chain of generation and the training loss.

Port of ``difffacto_tpu/models/diffusion.py`` (reference
anchored_diffusion.py) with its whole option surface: the ten model-mean
types (the DR5 fall-through quirk kept), the four variance types
(``fixed_small``, ``fixed_large``, ``learned``, ``learned_range``) scaled by
the per-point variance L^2, ``clip_xstart``, classifier-free guidance, DDIM
over a uniform or quad subset of the steps, the variational-bound term of a
learned variance, and per-point ``flags`` for dropped parts. ``p_sample_loop``
is a Python loop over the descending steps (with the trajectory of every
``ret_interval``-th step). The chain stays in float32 whatever the denoiser's
compute dtype (``diffusion.py:373-378``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..ops.schedule import (DiffusionSchedule, ddim_steps, ddim_xt_dir_coeff, extract,
                            make_beta_schedule, make_schedule)
from ..parallel.axes import fold_points, psum_points, sp_size
from ..utils import trace
from ..utils.device import randn
from ..utils.gaussian import gaussian_log_likelihood, normal_kl
from ..utils.registry import DIFFUSIONS

# Model mean types (reference utils/constants.py:3-17)
PREVIOUS_X = "prev_x"
START_X = "x_0"
EPSILON = "epsilon"
DRIFTED_EPSILON1 = "drifted_epsilon1"
DRIFTED_EPSILON2 = "drifted_epsilon2"
DRIFTED_EPSILON3 = "drifted_epsilon3"
DRIFTED_EPSILON4 = "drifted_epsilon4"
DRIFTED_EPSILON5 = "drifted_epsilon5"
EPSILON_AND_ANCHOR = "epsilon_and_anchor"
SCALED_EPSILON = "scaled_epsilon"
MEAN_TYPES = (PREVIOUS_X, START_X, EPSILON, DRIFTED_EPSILON1, DRIFTED_EPSILON2,
              DRIFTED_EPSILON3, DRIFTED_EPSILON4, DRIFTED_EPSILON5, EPSILON_AND_ANCHOR,
              SCALED_EPSILON)

# Variance types (constants.py:20-30)
LEARNED = "learned"
LEARNED_RANGE = "learned_range"
FIXED_SMALL = "fixed_small"
FIXED_LARGE = "fixed_large"
VAR_TYPES = (LEARNED, LEARNED_RANGE, FIXED_SMALL, FIXED_LARGE)


def zeros_like_tree(ctx):
    """Every tensor leaf of ``ctx`` (a tensor, a list or tuple of them, or
    None) zeroed: the unconditional context of guidance."""
    if ctx is None:
        return None
    if isinstance(ctx, (list, tuple)):
        return type(ctx)(zeros_like_tree(c) for c in ctx)
    return torch.zeros_like(ctx)


@DIFFUSIONS.register_module()
class AnchoredDiffusion:
    """Constructor arguments mirror the JAX dataclass; this object is math
    over the schedule tables, and the denoiser comes in as ``model_fn``.

    ``loss_type`` is kept and read nowhere: the JAX package always computes
    the mse loss whatever it says (``diffusion.py:81``, ``:536``)."""

    def __init__(self, num_timesteps: int, beta_1: float, beta_T: float, k: float = 1.0,
                 res: bool = True, mode: str = "linear", use_beta: bool = True,
                 rescale_timesteps: bool = False, loss_type: str = "mse",
                 model_mean_type: str = EPSILON, model_var_type: str = FIXED_SMALL,
                 scale_loss: bool = False, clip_xstart: bool = False,
                 include_anchors: bool = True, include_cov: bool = False,
                 learn_anchor: bool = True, learn_variance: bool = False,
                 classifier_weight: float = 1.0, guidance: bool = False,
                 ddim_sampling: bool = False, ddim_nsteps: int = 10,
                 ddim_discretize: str = "uniform", ddim_eta: float = 1.0, net=None):
        if model_mean_type not in MEAN_TYPES:
            raise ValueError(f"unknown model_mean_type {model_mean_type!r}")
        if model_var_type not in VAR_TYPES:
            raise ValueError(f"unknown model_var_type {model_var_type!r}")
        self.num_timesteps, self.k, self.res = num_timesteps, k, res
        self.use_beta, self.rescale_timesteps = use_beta, rescale_timesteps
        self.loss_type = loss_type
        self.model_mean_type, self.model_var_type = model_mean_type, model_var_type
        self.scale_loss, self.clip_xstart = scale_loss, clip_xstart
        self.include_anchors, self.include_cov = include_anchors, include_cov
        self.learn_anchor, self.learn_variance = learn_anchor, learn_variance
        self.classifier_weight, self.guidance = classifier_weight, guidance
        self.ddim_sampling, self.ddim_nsteps = ddim_sampling, ddim_nsteps
        self.ddim_discretize, self.ddim_eta = ddim_discretize, ddim_eta
        self.schedule = make_schedule(num_timesteps, beta_1, beta_T, mode)
        if ddim_sampling:
            self.steps = ddim_steps(num_timesteps, ddim_nsteps, ddim_discretize)
            betas = make_beta_schedule(num_timesteps, beta_1, beta_T, mode)
            self.xt_dir_coeff = torch.as_tensor(
                ddim_xt_dir_coeff(betas, ddim_eta).astype(np.float32))
        else:
            self.steps = np.arange(num_timesteps, dtype=np.int32)
            self.xt_dir_coeff = None
        self._on_device: Dict[torch.device, tuple] = {}

    def tables(self, device) -> DiffusionSchedule:
        return self._device_tables(device)[0]

    def _device_tables(self, device):
        """(schedule, xt_dir_coeff or None) on ``device``, copied once."""
        device = torch.device(device)
        if device not in self._on_device:
            coeff = None if self.xt_dir_coeff is None else self.xt_dir_coeff.to(device)
            self._on_device[device] = (self.schedule.to(device), coeff)
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

    # ------------------------------------------------------------- q kernel
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

    def q_posterior_mean(self, x_start, x_t, t, anchors):
        s = self.tables(x_t.device)
        a = self._anchors(anchors)
        nd = x_t.ndim
        return (
            extract(s.posterior_mean_coef1, t, nd) * x_start
            + extract(s.posterior_mean_coef2, t, nd) * x_t
            + extract(s.posterior_mean_coef3, t, nd) * a
        )

    def q_posterior_variance(self, t, variance):
        """(posterior variance, its log), each scaled by the per-point
        ``variance`` (``diffusion.py:159-164``)."""
        s = self.tables(variance.device)
        nd = variance.ndim
        return (extract(s.posterior_variance, t, nd) * variance,
                extract(s.posterior_log_variance_clipped, t, nd) + torch.log(variance))

    def q_sample_loop(self, gt, anchors, variance=None, noise=None, generator=None):
        """The forward chain at t = 1 .. T-1 on one draw, (T-1, B, N, 3)
        (``diffusion.py:426-437``); ``noise`` injects the draw."""
        if noise is None:
            noise = randn(gt.shape, generator, gt.device, gt.dtype)
        B = gt.shape[0]
        return torch.stack([
            self.q_sample(gt, torch.full((B,), step, dtype=torch.long, device=gt.device),
                          anchors, noise=noise, variance=variance)
            for step in range(1, self.num_timesteps)])

    # ------------------------------------------------------- reverse kernel
    def _predict_xstart_from_eps(self, s, x_t, t, anchors, eps, L):
        a = self._anchors(anchors)
        nd = x_t.ndim
        if L is None:
            L = torch.ones_like(x_t)
        return (extract(s.sqrt_recip_alphas_cumprod, t, nd) * (x_t - a) + a
                - extract(s.sqrt_recipm1_alphas_cumprod, t, nd) * L * eps)

    def _process_xstart(self, x):
        return torch.clamp(x, -10, 10) if self.clip_xstart else x

    def p_mean_variance(self, model_fn: Callable, x, t, anchors, ctx=None, variance=None,
                        seg_mask=None, valid_id=None, frozen_out=None):
        """Posterior parameters from the model (``diffusion.py:204-320``):
        'mean', 'variance', 'log_variance', 'pred_xstart', 'sqrt_log_variance'
        and, with DDIM, 'xt_dir' (else None). ``frozen_out`` stands in for the
        model's output (the variational-bound term)."""
        s, coeff = self._device_tables(x.device)
        nd = x.ndim
        if frozen_out is not None:
            model_output = frozen_out
        else:
            inp = self.model_input(x, anchors, variance)
            ts = self.scale_timesteps(t, s)
            model_output = model_fn(inp, ts, ctx, anchors, variance, seg_mask, valid_id)
            if self.guidance:
                uncond = model_fn(inp, ts, zeros_like_tree(ctx), anchors, variance, seg_mask,
                                  valid_id)
                model_output = ((1.0 - self.classifier_weight) * uncond
                                + self.classifier_weight * model_output)

        if self.model_var_type in (LEARNED, LEARNED_RANGE):
            model_output, var_values = model_output.chunk(2, dim=-1)
            if self.model_var_type == LEARNED:
                model_log_variance = var_values
            else:
                min_log = extract(s.posterior_log_variance_clipped, t, nd)
                max_log = extract(s.log_betas, t, nd)
                frac = (var_values + 1) / 2
                model_log_variance = frac * max_log + (1 - frac) * min_log
            model_variance = torch.exp(model_log_variance)
        else:
            fixed = {FIXED_LARGE: (s.fixed_large_variance, s.fixed_large_log_variance),
                     FIXED_SMALL: (s.posterior_variance, s.posterior_log_variance_clipped),
                     }[self.model_var_type]
            model_variance = extract(fixed[0], t, nd)
            model_log_variance = extract(fixed[1], t, nd)

        variance = self._variance(variance, x)
        L = torch.sqrt(variance)
        # the per-timestep variance scaled by the per-point one (diffusion.py:253-259)
        model_sqrt_log_variance = 0.5 * model_log_variance + torch.log(L)
        model_variance = model_variance * variance
        model_log_variance = model_log_variance + torch.log(variance)

        mt = self.model_mean_type
        xt_dir = None
        if mt == PREVIOUS_X:
            c1, c2, c3 = (extract(c, t, nd) for c in (s.posterior_mean_coef1,
                                                      s.posterior_mean_coef2,
                                                      s.posterior_mean_coef3))
            pred_xstart = self._process_xstart(
                (model_output - c2 * x - c3 * self._anchors(anchors)) / c1)
            model_mean = model_output
        else:
            out = model_output
            if mt in (DRIFTED_EPSILON1, DRIFTED_EPSILON2, DRIFTED_EPSILON3, DRIFTED_EPSILON4):
                sra = extract(s.sqrt_recip_alphas_cumprod, t, nd)
                if mt == DRIFTED_EPSILON1:
                    out = sra * out
                elif mt == DRIFTED_EPSILON3:
                    out = extract(s.sqrt_recipm1_alphas_cumprod, t, nd) * out
                elif mt == DRIFTED_EPSILON4:
                    out = out - anchors
                pred_xstart = sra * (x - out)
            elif mt == START_X:
                pred_xstart = out
            elif mt == EPSILON_AND_ANCHOR:
                pred_eps, pred_anchor = out.chunk(2, dim=-1)
                pred_xstart = self._predict_xstart_from_eps(s, x, t, pred_anchor, pred_eps, L)
            elif mt == SCALED_EPSILON:
                pred_xstart = self._predict_xstart_from_eps(s, x, t, anchors, out, None)
            else:
                # EPSILON, and DRIFTED_EPSILON5, which falls through to the
                # plain epsilon branch in the reference (its transform sits
                # under an elif that admits DR1-DR4 only): diffusion.py:279-288.
                pred_xstart = self._predict_xstart_from_eps(s, x, t, anchors, out, L)
            pred_xstart = self._process_xstart(pred_xstart)
            if self.ddim_sampling:
                if out.shape[-1] != L.shape[-1]:
                    raise NotImplementedError(
                        f"DDIM with model_mean_type={mt!r}: the JAX package cannot run it "
                        "either (difffacto_tpu/models/diffusion.py:308-309 scales the "
                        f"{out.shape[-1]}-wide output by the {L.shape[-1]}-wide L)")
                xt_dir = L * extract(coeff, t, nd) * out
            model_mean = self.q_posterior_mean(pred_xstart, x, t, anchors)

        return {"mean": model_mean, "variance": model_variance,
                "log_variance": model_log_variance, "pred_xstart": pred_xstart,
                "sqrt_log_variance": model_sqrt_log_variance, "xt_dir": xt_dir}

    def p_sample(self, model_fn, x, t, anchors, ctx=None, variance=None, seg_mask=None,
                 valid_id=None, noise=None, generator=None):
        """One reverse step (``diffusion.py:322-344``), DDIM's where
        ``ddim_sampling``; ``noise`` injects the Gaussian draw."""
        if self.ddim_sampling and self.model_mean_type == PREVIOUS_X:
            raise NotImplementedError(
                "DDIM with model_mean_type='prev_x': the JAX package cannot run it either "
                "(difffacto_tpu/models/diffusion.py:267 leaves xt_dir None, which :339 adds)")
        out = self.p_mean_variance(model_fn, x, t, anchors, ctx, variance, seg_mask, valid_id)
        if noise is None:
            noise = randn(x.shape, generator, x.device, x.dtype)
        nonzero = (t != 0).to(x.dtype).reshape((-1,) + (1,) * (x.ndim - 1))
        if self.ddim_sampling:
            a = self._anchors(anchors)
            s = self.tables(x.device)
            sqrt_acp_prev = torch.sqrt(extract(s.alphas_cumprod_prev, t, x.ndim))
            sample = ((out["pred_xstart"] - a) * sqrt_acp_prev + a + out["xt_dir"]
                      + self.ddim_eta * nonzero * torch.sqrt(out["variance"]) * noise)
        else:
            sample = out["mean"] + nonzero * torch.sqrt(out["variance"]) * noise
        return {"sample": sample, "pred_xstart": out["pred_xstart"]}

    def p_sample_loop(self, model_fn, anchors, ctx=None, variance=None, seg_mask=None,
                      valid_id=None, noise=None, ret_traj: bool = False, ret_interval: int = 20,
                      step_noise=None, generator: Optional[torch.Generator] = None):
        """The whole reverse chain over ``steps`` in descending order: T-1 .. 0,
        or with DDIM its subset (a quad subset may repeat a step).

        ``noise`` injects x_T and ``step_noise`` (len(steps), B, N, 3) the
        per-step draws, in the order the steps run. Returns {'pred'}; with
        ``ret_traj`` also 'traj' (T_kept, B, N, 3), the sample each step t
        with t % ``ret_interval`` == 0 returned (every run of a repeated
        step), and 'traj_t' (T_kept,) those t in the order they ran
        (``diffusion.py:419-422``). Only the kept samples are stored.

        While the recorder records (``utils/trace.py``) each step adds to
        ``chain.steps`` and, on the card, a step the host begins with the
        stream already drained adds to ``chain.starved_steps``.
        """
        steps = self.steps[::-1]
        if step_noise is not None and step_noise.shape[0] != len(steps):
            raise ValueError(f"step_noise has {step_noise.shape[0]} steps, the chain "
                             f"{len(steps)}")
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
        stream = torch.cuda.current_stream(x.device) if x.device.type == "cuda" else None
        for i, step in enumerate(steps.tolist()):
            if trace.on():
                trace.count("chain.steps")
                if stream is not None and stream.query():
                    trace.count("chain.starved_steps")
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

    # ---------------------------------------------------------------- loss
    def _vb_terms(self, model_fn, x_start, x_t, t, anchors, ctx, variance, frozen_out,
                  seg_mask, flags):
        """The variational-bound term of a learned variance, in bits a point,
        (B,): the NLL of x_start at t = 0, the KL to the posterior elsewhere
        (``diffusion.py:440-466``)."""
        C = x_start.shape[-1]
        true_mean = self.q_posterior_mean(x_start, x_t, t, anchors)
        _, true_logvar = self.q_posterior_variance(t, self._variance(variance, x_start))
        out = self.p_mean_variance(model_fn, x_t, t, anchors, ctx, variance, seg_mask, None,
                                   frozen_out=frozen_out)
        kl = normal_kl(true_mean, true_logvar, out["mean"], out["log_variance"], dim=C).sum(-1)
        nll = -gaussian_log_likelihood(x_start, out["mean"], out["log_variance"], dim=C).sum(-1)
        if flags is not None:
            f = flags.reshape(flags.shape[0], -1)
            denom = psum_points(f.sum(1)) * math.log(2.0)
            kl, nll = psum_points((kl * f).sum(1)) / denom, psum_points((nll * f).sum(1)) / denom
        else:
            denom = kl.shape[-1] * sp_size() * math.log(2.0)
            kl, nll = psum_points(kl.sum(-1)) / denom, psum_points(nll.sum(-1)) / denom
        return torch.where(t == 0, nll, kl)

    def training_losses(self, model_fn: Callable, x_start, t, anchors=None, variance=None,
                        ctx=None, seg_mask=None, valid_id=None, flags=None, noise=None,
                        reduce: bool = True, generator=None):
        """The mse training loss of every mean type, with the variational-bound
        term of a learned variance (``diffusion.py:468-549``).

        ``flags`` (B, N) masks the points of dropped parts; ``noise`` injects
        the diffusion draw. Returns {'mse_loss'}, and with a learned variance
        'model_var_value' and 'vb_loss' first, as the JAX package orders them."""
        s = self.tables(x_start.device)
        loss_dict = {}
        if anchors is None:
            anchors = torch.zeros_like(x_start)
        if noise is None:
            # per-point: decorrelated across point shards (the timesteps were
            # drawn upstream from the unfolded stream)
            noise = randn(x_start.shape, fold_points(generator), x_start.device, x_start.dtype)
        nd = x_start.ndim
        anchors_eff = self._anchors(anchors)
        x_t = self.q_sample(x_start, t, anchors_eff, noise=noise, variance=variance)
        model_output = model_fn(self.model_input(x_t, anchors, variance),
                                self.scale_timesteps(t, s), ctx, anchors, variance, seg_mask,
                                valid_id)
        if self.model_var_type in (LEARNED, LEARNED_RANGE):
            model_output, var_values = model_output.chunk(2, dim=-1)
            loss_dict["model_var_value"] = psum_points(var_values.sum()) / (
                var_values.numel() * sp_size())
            frozen = torch.cat([model_output.detach(), var_values], dim=-1)
            vb = self._vb_terms(model_fn, x_start, x_t, t, anchors, ctx, variance, frozen,
                                seg_mask, flags).mean()
            loss_dict["vb_loss"] = vb * self.num_timesteps / 1000.0

        # each coefficient gathered only where its target reads it
        L = lambda: torch.sqrt(self._variance(variance, x_start))
        sa = lambda: extract(s.sqrt_alphas_cumprod, t, nd)
        soma = lambda: extract(s.sqrt_one_minus_alphas_cumprod, t, nd)
        sra = lambda: extract(s.sqrt_recip_alphas_cumprod, t, nd)
        srma = lambda: extract(s.sqrt_recipm1_alphas_cumprod, t, nd)
        target = {
            START_X: lambda: x_start,
            EPSILON: lambda: noise,
            SCALED_EPSILON: lambda: L() * noise,
            DRIFTED_EPSILON1: lambda: (1.0 - sa()) * anchors_eff + soma() * noise,
            DRIFTED_EPSILON2: lambda: (sra() - 1.0) * anchors_eff + srma() * noise,
            DRIFTED_EPSILON3: lambda: (1.0 - sa()) / soma() * anchors_eff + L() * noise,
            DRIFTED_EPSILON4: lambda: sra() * anchors_eff + srma() * noise,
            DRIFTED_EPSILON5: lambda: (1.0 - sa()) / soma() * anchors_eff / L() + noise,
            EPSILON_AND_ANCHOR: lambda: torch.cat([noise, anchors_eff], dim=-1),
        }
        if self.model_mean_type not in target:
            raise NotImplementedError(
                f"training with model_mean_type={self.model_mean_type!r}: the JAX package "
                "has no target for it either (difffacto_tpu/models/diffusion.py:524-534)")
        diff = (target[self.model_mean_type]() - model_output) ** 2
        if flags is not None:
            diff = diff * flags[..., None]
        if reduce:
            if flags is not None:
                diff = psum_points(diff.mean(-1).sum()) / psum_points(flags.sum())
            else:
                diff = psum_points(diff.sum()) / (diff.numel() * sp_size())
        if self.scale_loss:
            b, acp = extract(s.betas, t, diff.ndim), extract(s.alphas_cumprod, t, diff.ndim)
            diff = diff * b * b / (2 * (1.0 - b) * (1.0 - acp))
        loss_dict["mse_loss"] = diff
        return loss_dict
