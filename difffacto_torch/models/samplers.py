"""Timestep samplers (``difffacto_tpu/models/samplers.py``)."""

from __future__ import annotations

import torch

from ..utils.registry import SAMPLERS


@SAMPLERS.register_module()
class Uniform:
    """t ~ U{0..T-1}, weights 1."""

    def __init__(self, num_timesteps: int):
        self.num_timesteps = num_timesteps

    def sample(self, generator: torch.Generator, batch_size: int, device="cpu"):
        if generator is None:
            raise ValueError("the timestep draw needs a torch.Generator (or inject diffusion_t)")
        t = torch.randint(0, self.num_timesteps, (batch_size,), generator=generator, device=device)
        return t, torch.ones(batch_size, dtype=torch.float32, device=device)
