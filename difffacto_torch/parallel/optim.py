"""Optimizers and LR schedules, with optax's arithmetic.

Port of ``difffacto_tpu/parallel/optim.py``. A schedule is a plain function
``epoch -> multiplier``; an optimizer is a small functional object over a list
of parameters (``init`` and ``update``), not a ``torch.optim`` class, because
the training step has to keep or discard a whole update on the device.

Where optax and ``torch.optim`` differ, this follows optax, which the JAX
package trains with:

* ``clip_by_global_norm`` leaves the gradients alone below ``max_norm`` and
  else scales them by ``max_norm / norm``, with no ``1e-6``;
* weight decay for Adam and Adamax is added to the gradient before the
  moments; AdamW adds ``weight_decay * param`` to the Adam direction;
* the schedule reads the optimizer's own count before it is incremented and
  floors ``count / iters_per_epoch``; a step the guard skips does not advance
  that count;
* ``lr_scale_fn(path)`` scales the update per parameter path.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence

import torch

from ..utils.registry import OPTIMS, SCHEDULERS

Schedule = Callable[[torch.Tensor], torch.Tensor]


def _epoch(epoch) -> torch.Tensor:
    return epoch if isinstance(epoch, torch.Tensor) else torch.as_tensor(float(epoch))


@SCHEDULERS.register_module()
def LinearLR(start_epoch, end_epoch, start_lr, end_lr):
    """1.0 until start_epoch, linear to end_lr / start_lr by end_epoch."""

    def lr_func(epoch):
        frac = torch.clamp((_epoch(epoch) - start_epoch) / (end_epoch - start_epoch), 0.0, 1.0)
        return (1 - frac) * 1.0 + frac * (end_lr / start_lr)

    return lr_func


@SCHEDULERS.register_module()
def CustomStepLR(milestone: Sequence[int], gamma: float):
    """gamma^(milestones passed); the drop applies at the milestone epoch itself."""
    ms = sorted(milestone)

    def lr_func(epoch):
        epoch = _epoch(epoch)
        out = torch.ones_like(epoch, dtype=torch.float32)
        for m in ms:
            out = torch.where(epoch >= m, out * gamma, out)
        return out

    return lr_func


@SCHEDULERS.register_module()
def StepLR(step_size: int, gamma: float = 0.1):
    def lr_func(epoch):
        return gamma ** torch.floor(_epoch(epoch) / step_size)

    return lr_func


@SCHEDULERS.register_module()
def CosineAnnealingLR(T_max: int, eta_min: float = 0.0, base_lr: float = 1.0):
    def lr_func(epoch):
        lr = eta_min + (base_lr - eta_min) * (1 + torch.cos(math.pi * _epoch(epoch) / T_max)) / 2
        return lr / base_lr

    return lr_func


@SCHEDULERS.register_module()
def CosineAnnealingLRWithWarmUp(T_max: int, eta_min: float = 0.0, warmup_T: int = 10,
                                warmup_lr: float = 1e-6, base_lr: float = 1.0):
    """Linear warm-up, then the reference's recursive cosine: the tail is
    rescaled from the last warm-up value (epoch warmup_T - 1), a quirk the JAX
    package keeps (``optim.py:75-99``). Valid for epoch <= T_max - warmup_T."""
    T = T_max - warmup_T
    target = eta_min + (base_lr - eta_min) * (1 + math.cos(warmup_T * math.pi / T)) / 2
    anchor = warmup_lr + (target - warmup_lr) * ((warmup_T - 1) / warmup_T)
    denom = 1 + math.cos(math.pi * (warmup_T - 1) / T)

    def lr_func(epoch):
        epoch = _epoch(epoch)
        warm = warmup_lr + (target - warmup_lr) * (epoch / warmup_T)
        cos = eta_min + (anchor - eta_min) * (1 + torch.cos(math.pi * epoch / T)) / denom
        return torch.where(epoch < warmup_T, warm, cos) / base_lr

    return lr_func


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor, f32, on the device."""
    return torch.sqrt(torch.stack(torch._foreach_norm(grads)).float().pow(2).sum())


class Optimizer:
    """clip by global norm -> base optimizer -> per-path scale, as optax chains them.

    ``init(params)`` returns the state (count, mu, nu); ``update(grads, state,
    params, paths)`` returns (updates, new_state) without touching either
    argument, so the caller can keep the old state when it discards a step.
    """

    def __init__(self, kind: str, lr: float, schedule: Optional[Schedule], iters_per_epoch: int,
                 max_norm: Optional[float], betas, eps: float, weight_decay: float, lr_scale_fn):
        if kind not in ("adam", "adamw", "adamax", "sgd"):
            raise ValueError(kind)
        self.kind, self.lr, self.schedule = kind, lr, schedule
        self.iters_per_epoch, self.max_norm = iters_per_epoch, max_norm
        (self.b1, self.b2), self.eps, self.weight_decay = betas, eps, weight_decay
        self.lr_scale_fn = lr_scale_fn

    def init(self, params: List[torch.Tensor]):
        state = {"count": torch.zeros((), dtype=torch.float32, device=params[0].device)}
        if self.kind != "sgd":
            state["mu"] = [torch.zeros_like(p) for p in params]
            state["nu"] = [torch.zeros_like(p) for p in params]
        return state

    def learning_rate(self, count: torch.Tensor) -> torch.Tensor:
        if self.schedule is None:
            return torch.full_like(count, self.lr)
        return self.lr * self.schedule(torch.floor(count / self.iters_per_epoch))

    def update(self, grads, state, params, paths=None):
        f = torch._foreach_mul
        if self.max_norm is not None:
            norm = global_norm(grads)
            # optax: unchanged below max_norm, else (g / norm) * max_norm
            factor = torch.where(norm < self.max_norm, torch.ones_like(norm), self.max_norm / norm)
            grads = f(grads, factor)
        count = state["count"]
        new_state = {"count": count + 1}
        neg_lr = -self.learning_rate(count)
        if self.kind == "sgd":
            updates = f(grads, neg_lr)
        else:
            b1, b2, wd = self.b1, self.b2, self.weight_decay
            if wd and self.kind in ("adam", "adamax"):
                grads = torch._foreach_add(grads, params, alpha=wd)
            mu = torch._foreach_add(f(state["mu"], b1), grads, alpha=1 - b1)
            c1 = 1 - b1 ** new_state["count"]
            if self.kind == "adamax":
                nu = torch._foreach_maximum(
                    torch._foreach_add(torch._foreach_abs(grads), self.eps), f(state["nu"], b2))
                direction = torch._foreach_div(torch._foreach_div(mu, c1), nu)
            else:
                nu = torch._foreach_add(f(state["nu"], b2), f(grads, grads), alpha=1 - b2)
                c2 = 1 - b2 ** new_state["count"]
                denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, c2)), self.eps)
                direction = torch._foreach_div(torch._foreach_div(mu, c1), denom)
                if wd and self.kind == "adamw":
                    direction = torch._foreach_add(direction, params, alpha=wd)
            updates = f(direction, neg_lr)
            new_state.update(mu=mu, nu=nu)
        if self.lr_scale_fn is not None:
            updates = [u * self.lr_scale_fn(p) for u, p in zip(updates, paths)]
        return updates, new_state


def make_optimizer(kind: str, lr: float, schedule: Optional[Schedule] = None,
                   iters_per_epoch: int = 1, max_norm: Optional[float] = None,
                   betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.0,
                   lr_scale_fn=None) -> Optimizer:
    """Clip by global norm + base optimizer + epoch-indexed schedule
    (``optim.py:121-150``). ``lr_scale_fn(path) -> scale`` takes a parameter's
    path as a tuple of names."""
    return Optimizer(kind, lr, schedule, iters_per_epoch, max_norm, betas, eps, weight_decay,
                     lr_scale_fn)


def build_optimizer_from_cfg(optimizer_cfg, scheduler_cfg=None, iters_per_epoch=1, max_norm=None,
                             lr_scale_fn=None) -> Optimizer:
    """Build from reference-style config dicts, e.g. dict(type='Adam', lr=2e-3)."""
    ocfg = dict(optimizer_cfg)
    kind = ocfg.pop("type").lower()
    lr = ocfg.pop("lr", 1e-3)
    schedule = None
    if scheduler_cfg is not None:
        scfg = dict(scheduler_cfg)
        schedule = SCHEDULERS.get(scfg.pop("type"))(**scfg)
    return make_optimizer(
        kind, lr, schedule=schedule, iters_per_epoch=iters_per_epoch, max_norm=max_norm,
        betas=ocfg.pop("betas", (0.9, 0.999)), eps=ocfg.pop("eps", 1e-8),
        weight_decay=ocfg.pop("weight_decay", 0.0), lr_scale_fn=lr_scale_fn,
    )


# The config-driven optimizers by type string, as the JAX package registers
# them (``difffacto_tpu/parallel/optim.py:195-197``).
for _kind in ("Adam", "AdamW", "Adamax"):
    OPTIMS.register_module(
        _kind, lambda _kind=_kind, **kw: build_optimizer_from_cfg(dict(type=_kind, **kw)))
