"""The training step: loss, gradients, clip, optimizer update and the guards.

Port of ``difffacto_tpu/parallel/train.py`` for one device. ``parse_losses``
keeps the reference semantics: the total is the sum of every entry whose key
contains 'loss'. The semantics of ``make_train_step`` that are kept:

* the global norm over all gradients goes through the clip; then the updates
  of parameters outside ``trainable_filter`` are dropped, while their optimizer
  moments still advance;
* a non-finite loss or gradient, or a gradient norm over ``skip_grad_norm``,
  skips the whole step: parameters, optimizer state and BatchNorm statistics
  keep their old values, ``step`` still advances and ``skipped_nonfinite``
  reads 1. The choice is made on the device with ``torch.where``; no value is
  pulled to the host.

The model's parameters and BatchNorm buffers are updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..models.anchor_diff import AnchorDiffAE, ensure_attn_maps
from .optim import Optimizer, global_norm


@dataclasses.dataclass
class TrainState:
    """``step`` counts calls of the step function (host side); ``model`` holds
    the parameters and the BatchNorm buffers; ``opt_state`` the optimizer's
    count and moments, in the order of ``model.named_parameters()``."""

    step: int
    model: AnchorDiffAE
    opt_state: Dict[str, Any]

    @property
    def paths(self) -> List[Tuple[str, ...]]:
        return [tuple(n.split(".")) for n, _ in self.model.named_parameters()]


def parse_losses(losses: Dict[str, torch.Tensor]):
    means = {k: v.mean() for k, v in losses.items()}
    total = sum(v for k, v in means.items() if "loss" in k)
    return total, means


def init_train_state(model: AnchorDiffAE, tx: Optimizer) -> TrainState:
    """The state of a model as it was built (its ``seed`` fixed the weights)."""
    return TrainState(step=0, model=model, opt_state=tx.init(list(model.parameters())))


def _generators(rng, step: int, device) -> Dict[str, torch.Generator]:
    """The "sample" and "dropout" streams of one step. A ``torch.Generator``
    serves both as it is; an int seed is folded with the step."""
    if isinstance(rng, torch.Generator):
        return {"sample": rng, "dropout": rng}
    base = (int(rng) * 1000003 + step) * 2
    return {
        "sample": torch.Generator(device=device).manual_seed(base),
        "dropout": torch.Generator(device=device).manual_seed(base + 1),
    }


def make_train_step(model: AnchorDiffAE, tx: Optimizer,
                    trainable_filter: Optional[Callable[[Tuple[str, ...]], bool]] = None,
                    skip_grad_norm: Optional[float] = None):
    """Build ``step(state, batch, rng, epoch) -> (state, metrics)``.

    ``rng`` is an int seed or a ``torch.Generator`` on the model's device;
    ``trainable_filter(path)`` takes a parameter's path as a tuple of names
    (('encoder_mod', 'aligner', 'blocks', '0', 'wq')). Metrics are 0-dim
    tensors on the device: every mean of the loss dict, ``total_loss``,
    ``grad_norm`` and ``skipped_nonfinite``.
    """
    params = list(model.parameters())
    paths = [tuple(n.split(".")) for n, _ in model.named_parameters()]
    live = [i for i, p in enumerate(paths) if trainable_filter is None or trainable_filter(p)]
    buffers = list(model.buffers())

    def step(state: TrainState, batch, rng, epoch):
        batch = ensure_attn_maps(batch)
        rngs = _generators(rng, state.step, params[0].device)
        old_buffers = [b.clone() for b in buffers]
        total, metrics = parse_losses(model.loss(batch, epoch, True, rngs=rngs))
        grads = torch.autograd.grad(total, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
        metrics = {k: v.detach() for k, v in metrics.items()}
        total = total.detach()

        with torch.no_grad():
            gnorm = global_norm(grads)
            # a NaN or an inf in any gradient makes the norm non-finite
            finite = torch.isfinite(total) & torch.isfinite(gnorm)
            if skip_grad_norm is not None:
                finite = finite & (gnorm < skip_grad_norm)
            # A non-finite gradient makes the update and the new moments
            # non-finite too; torch.where below never selects them.
            updates, new_opt = tx.update(grads, state.opt_state, params, paths)
            if live:
                moved = torch._foreach_add([params[i] for i in live], [updates[i] for i in live])
                for i, new in zip(live, moved):
                    params[i].copy_(torch.where(finite, new, params[i]))
            old_opt = state.opt_state
            opt_state = {"count": torch.where(finite, new_opt["count"], old_opt["count"])}
            for key in ("mu", "nu"):
                if key in new_opt:
                    opt_state[key] = [torch.where(finite, n, o)
                                      for n, o in zip(new_opt[key], old_opt[key])]
            for b, old in zip(buffers, old_buffers):
                b.copy_(torch.where(finite, b, old))
            metrics["total_loss"] = total
            metrics["grad_norm"] = gnorm
            metrics["skipped_nonfinite"] = 1.0 - finite.float()
        return TrainState(step=state.step + 1, model=model, opt_state=opt_state), metrics

    return step
