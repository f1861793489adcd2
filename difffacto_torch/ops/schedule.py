"""Diffusion schedule tables for the anchored DDPM.

Port of ``difffacto_tpu/ops/schedule.py``: every coefficient the reference
computes in its diffusion constructor (reference:
anchored_diffusion.py:62-126) is built in float64 numpy and cast to float32
once, so the tables equal the JAX package's bit for bit.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def make_beta_schedule(num_timesteps: int, beta_1: float, beta_T: float, mode: str = "linear") -> np.ndarray:
    if mode == "linear":
        return np.linspace(beta_1, beta_T, num=num_timesteps, dtype=np.float64)
    if mode == "cosine":
        alpha_bar = lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
        return np.array(
            [
                min(1 - alpha_bar((i + 1) / num_timesteps) / alpha_bar(i / num_timesteps), 0.999)
                for i in range(num_timesteps)
            ],
            dtype=np.float64,
        )
    raise ValueError(f"unknown beta schedule mode: {mode}")


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """All per-timestep coefficient tables, (T,) float32 tensors on one device."""

    betas: torch.Tensor
    log_betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    alphas_cumprod_next: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    posterior_mean_coef3: torch.Tensor
    fixed_large_variance: torch.Tensor
    fixed_large_log_variance: torch.Tensor

    def to(self, device) -> "DiffusionSchedule":
        return DiffusionSchedule(
            **{f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)}
        )


def make_schedule(
    num_timesteps: int,
    beta_1: float,
    beta_T: float,
    mode: str = "linear",
    device="cpu",
) -> DiffusionSchedule:
    """Build every table in float64 and cast once to float32 on ``device``."""
    betas = make_beta_schedule(num_timesteps, beta_1, beta_T, mode)
    assert betas.ndim == 1 and (betas > 0).all() and (betas <= 1).all()
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
    alphas_cumprod_next = np.append(alphas_cumprod[1:], 0.0)

    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    posterior_log_variance_clipped = np.log(
        np.append(posterior_variance[1], posterior_variance[1:])
    )
    posterior_mean_coef1 = betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    posterior_mean_coef2 = (
        (1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod)
    )
    # The anchored diffusion's extra coefficient on the anchor term
    # (anchored_diffusion.py:109-112).
    posterior_mean_coef3 = 1.0 + (
        (np.sqrt(alphas_cumprod) - 1.0) * (np.sqrt(alphas_cumprod_prev) + np.sqrt(alphas))
    ) / (1.0 - alphas_cumprod)
    fixed_large_variance = np.append(posterior_variance[1], betas[1:])

    as_dev = lambda a: torch.as_tensor(a.astype(np.float32), device=device)
    return DiffusionSchedule(
        betas=as_dev(betas),
        log_betas=as_dev(np.log(betas)),
        alphas_cumprod=as_dev(alphas_cumprod),
        alphas_cumprod_prev=as_dev(alphas_cumprod_prev),
        alphas_cumprod_next=as_dev(alphas_cumprod_next),
        sqrt_alphas_cumprod=as_dev(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=as_dev(np.sqrt(1.0 - alphas_cumprod)),
        log_one_minus_alphas_cumprod=as_dev(np.log(1.0 - alphas_cumprod)),
        sqrt_recip_alphas_cumprod=as_dev(np.sqrt(1.0 / alphas_cumprod)),
        sqrt_recipm1_alphas_cumprod=as_dev(np.sqrt(1.0 / alphas_cumprod - 1.0)),
        posterior_variance=as_dev(posterior_variance),
        posterior_log_variance_clipped=as_dev(posterior_log_variance_clipped),
        posterior_mean_coef1=as_dev(posterior_mean_coef1),
        posterior_mean_coef2=as_dev(posterior_mean_coef2),
        posterior_mean_coef3=as_dev(posterior_mean_coef3),
        fixed_large_variance=as_dev(fixed_large_variance),
        fixed_large_log_variance=as_dev(np.log(fixed_large_variance)),
    )


def ddim_steps(num_timesteps: int, ddim_nsteps: int, discretize: str = "uniform") -> np.ndarray:
    """The timestep subset of DDIM sampling, ascending, int32
    (``difffacto_tpu/ops/schedule.py:144-155``). "quad" may repeat a step:
    at T = 100 and 25 steps it runs t = 0 three times and starts at t = 80,
    as the reference does."""
    if discretize == "uniform":
        return np.arange(0, num_timesteps, num_timesteps // ddim_nsteps, dtype=np.int32)
    if discretize == "quad":
        return (np.linspace(0.0, math.sqrt(num_timesteps * 0.8), ddim_nsteps) ** 2).astype(np.int32)
    raise NotImplementedError(discretize)


def ddim_xt_dir_coeff(betas: np.ndarray, ddim_eta: float) -> np.ndarray:
    """sqrt(1 - alpha_bar - eta^2 posterior_variance) per timestep, in float64
    (``difffacto_tpu/ops/schedule.py:158-166``); the caller casts it once."""
    betas = np.asarray(betas, dtype=np.float64)
    alphas_cumprod = np.cumprod(1.0 - betas)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    return np.sqrt(1.0 - alphas_cumprod - ddim_eta * ddim_eta * posterior_variance)


def extract(arr: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Gather per-batch coefficients: (T,), (B,) int -> (B, 1, ..., 1) with ``ndim`` dims."""
    out = arr[t.long()]
    return out.reshape(out.shape + (1,) * (ndim - 1))
