"""The training step: loss, gradients, clip, optimizer update and the guards.

Port of ``difffacto_tpu/parallel/train.py``, on one device or over a mesh of
ranks (``parallel/mesh.py``). ``parse_losses``
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

Over a mesh each rank takes ``autograd.grad`` of the loss of its own slice of
the batch (``mesh.shard_batch``); the gradients, the total, the metrics and
the BatchNorm running statistics are then averaged over every rank of the
mesh, the gradients and statistics in one all-reduce of one flat buffer and
the scalars in another (``pmean`` over the data and points axes in the JAX
package), and the norm, the clip and the guards run on the
averaged gradients, so every rank takes the same branch and holds the same
parameters after the update. Under a "points" axis the loss runs inside
``axes.points_sharded``. The streams are folded by the data rank where the
data axis has more than one rank (a 1-rank mesh steps as the plain step
does); point shards of a sample share its per-sample draws.

Dropout under a "points" axis is what the JAX package draws there: the
dropout stream is not folded by the point rank and B2/B3's hash keys on the
token's index within the rank's shard, so local token i has the same mask on
every point shard of a sample.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..models.anchor_diff import AnchorDiffAE, ensure_attn_maps
from .axes import fold_generator, fold_seed, points_sharded
from .mesh import Mesh, all_reduce_mean_, pmean_metrics
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


def fold_rng(rng, index: int):
    """Stream ``index`` of a step's ``rng`` (int seed or generator)."""
    if isinstance(rng, torch.Generator):
        return fold_generator(rng, index)
    return fold_seed(rng, index)


class TrainStep:
    """``step(state, batch, rng, epoch) -> (state, metrics)``: ``local``, the
    mean over the mesh where there is one, then ``apply``.

    ``local`` is what one rank computes: the loss of its slice and the
    gradients; ``apply`` the clip, the guards and the update from (mean)
    gradients. ``rng`` is an int seed or a ``torch.Generator`` on the model's
    device; ``trainable_filter(path)`` takes a parameter's path as a tuple of
    names (('encoder_mod', 'aligner', 'blocks', '0', 'wq')). Metrics are 0-dim
    tensors on the device: every mean of the loss dict, ``total_loss``,
    ``grad_norm`` and ``skipped_nonfinite``. With ``mesh`` the step takes
    this rank's slice of the batch (``mesh.shard_batch``) and every rank of
    the mesh calls it with the same ``rng``.
    """

    def __init__(self, model: AnchorDiffAE, tx: Optimizer,
                 trainable_filter: Optional[Callable[[Tuple[str, ...]], bool]] = None,
                 skip_grad_norm: Optional[float] = None, mesh: Optional[Mesh] = None):
        self.model, self.tx, self.skip_grad_norm, self.mesh = model, tx, skip_grad_norm, mesh
        self.params = list(model.parameters())
        self.paths = [tuple(n.split(".")) for n, _ in model.named_parameters()]
        self.live = [i for i, p in enumerate(self.paths)
                     if trainable_filter is None or trainable_filter(p)]
        self.buffers = list(model.buffers())
        self.point_group = None
        if mesh is not None and mesh.axis_size("points") > 1:
            self.point_group = mesh.groups["points"]
        self.data_rank = None
        if mesh is not None and mesh.shape[mesh.axis_names[0]] > 1:
            self.data_rank = mesh.index(mesh.axis_names[0])

    def __call__(self, state: TrainState, batch, rng, epoch):
        if self.data_rank is not None:
            rng = fold_rng(rng, self.data_rank)
        old_buffers = [b.clone() for b in self.buffers]
        total, metrics, grads = self.local(state, batch, rng, epoch)
        if self.mesh is not None:
            all_reduce_mean_(grads + self.buffers, self.mesh)
            metrics = pmean_metrics(dict(metrics, total_loss=total), self.mesh)
            total = metrics.pop("total_loss")
        return self.apply(state, total, metrics, grads, old_buffers)

    def local(self, state: TrainState, batch, rng, epoch):
        """(total, metrics, gradients) of this rank's batch; BatchNorm's
        running statistics move in place."""
        rngs = _generators(rng, state.step, self.params[0].device)
        with points_sharded(self.point_group):
            total, metrics = parse_losses(
                self.model.loss(ensure_attn_maps(batch), epoch, True, rngs=rngs))
            grads = torch.autograd.grad(total, self.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, self.params)]
        return total.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    @torch.no_grad()
    def apply(self, state: TrainState, total, metrics, grads, old_buffers):
        """The norm, the guards and the update; a skipped step puts
        ``old_buffers`` back."""
        params, tx, skip_grad_norm = self.params, self.tx, self.skip_grad_norm
        gnorm = global_norm(grads)
        # a NaN or an inf in any gradient makes the norm non-finite
        finite = torch.isfinite(total) & torch.isfinite(gnorm)
        if skip_grad_norm is not None:
            finite = finite & (gnorm < skip_grad_norm)
        # A non-finite gradient makes the update and the new moments
        # non-finite too; torch.where below never selects them.
        updates, new_opt = tx.update(grads, state.opt_state, params, self.paths)
        if self.live:
            live = self.live
            moved = torch._foreach_add([params[i] for i in live], [updates[i] for i in live])
            for i, new in zip(live, moved):
                params[i].copy_(torch.where(finite, new, params[i]))
        old_opt = state.opt_state
        opt_state = {"count": torch.where(finite, new_opt["count"], old_opt["count"])}
        for key in ("mu", "nu"):
            if key in new_opt:
                opt_state[key] = [torch.where(finite, n, o)
                                  for n, o in zip(new_opt[key], old_opt[key])]
        for b, old in zip(self.buffers, old_buffers):
            b.copy_(torch.where(finite, b, old))
        metrics["total_loss"] = total
        metrics["grad_norm"] = gnorm
        metrics["skipped_nonfinite"] = 1.0 - finite.float()
        return TrainState(step=state.step + 1, model=self.model, opt_state=opt_state), metrics


def make_train_step(model: AnchorDiffAE, tx: Optimizer,
                    trainable_filter: Optional[Callable[[Tuple[str, ...]], bool]] = None,
                    skip_grad_norm: Optional[float] = None, mesh: Optional[Mesh] = None):
    """The ``TrainStep`` of ``model`` (see there)."""
    return TrainStep(model, tx, trainable_filter, skip_grad_norm, mesh)
