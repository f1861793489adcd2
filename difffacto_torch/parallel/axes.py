"""The point axis of a sequence-parallel training step.

Port of ``difffacto_tpu/parallel/axes.py``. Under a ("data", "points") mesh a
training step cuts every point-axis batch array (``mesh.POINT_AXIS_BATCH_KEYS``)
over the ranks of its points group. The loss reduces over the point axis in a
few places (the masked max-pools of ``models/pointnet.py``, the per-point
fit and diffusion losses, BatchNorm's statistics), and the model calls the
helpers below there. Outside ``points_sharded`` each helper is the identity,
so the one-device and flat-dp paths do not change.

Gradients follow the JAX package's arithmetic: ``psum_points`` is an
all-reduce whose backward sums the cotangents of every shard (the transpose
of ``psum`` under ``shard_map``), so each rank's loss value is the global one
and its gradients of the point-sharded terms are the point-group size times
too large; the step then takes the mean of the gradients over the data and
points groups (``parallel/train.py``), which gives the exact gradient for
the point-sharded terms and for the replicated ones alike.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

import torch
import torch.distributed as dist

_POINT_GROUP = None  # the points group while a point-sharded step runs
_M31 = (1 << 31) - 1


def point_axis():
    """The process group of this rank's point shards, or None."""
    return _POINT_GROUP


@contextmanager
def points_sharded(group):
    """Shard the point axis over ``group`` (None: not sharded) for the
    duration of a loss and its gradients."""
    global _POINT_GROUP
    prev = _POINT_GROUP
    _POINT_GROUP = group
    try:
        yield
    finally:
        _POINT_GROUP = prev


def sp_size() -> int:
    """Number of point shards (1 outside ``points_sharded``)."""
    return 1 if _POINT_GROUP is None else dist.get_world_size(_POINT_GROUP)


class _AllReduceSum(torch.autograd.Function):
    """psum: forward and backward both sum over the group."""

    @staticmethod
    def forward(ctx, x, group):
        from .mesh import all_reduce_

        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        all_reduce_(y, group)
        return y

    @staticmethod
    def backward(ctx, g):
        from .mesh import all_reduce_

        g = g.clone(memory_format=torch.contiguous_format)
        all_reduce_(g, ctx.group)
        return g, None


class _AllGather(torch.autograd.Function):
    """all_gather on a new leading axis; its backward is the JAX transpose,
    psum_scatter: each shard's cotangent is the sum over ranks of the
    cotangents of its slot (one all-reduce of the stacked cotangents: gloo
    has no reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group):
        from .mesh import all_gather_stack

        ctx.group = group
        return all_gather_stack(x, group)

    @staticmethod
    def backward(ctx, g):
        from .mesh import all_reduce_

        g = g.clone(memory_format=torch.contiguous_format)
        all_reduce_(g, ctx.group)
        return g[dist.get_rank(ctx.group)], None


def psum_points(x: torch.Tensor) -> torch.Tensor:
    """Sum a partial point-axis reduction over all point shards."""
    if _POINT_GROUP is None:
        return x
    return _AllReduceSum.apply(x, _POINT_GROUP)


def allmax_points(x: torch.Tensor) -> torch.Tensor:
    """Elementwise max over the point shards of an already locally maxed
    value (the masked max-pools of ``models/pointnet.py``), as all_gather +
    max, so that the subgradient goes to the shard that holds the max (ties
    share it, as ``torch.amax`` and ``jnp.max`` share it)."""
    if _POINT_GROUP is None:
        return x
    return _AllGather.apply(x, _POINT_GROUP).amax(dim=0)


def fold_seed(seed: int, index: int) -> int:
    """A 31-bit seed for stream ``index`` of ``seed`` (splitmix64's mix):
    what ``jax.random.fold_in`` is to a key."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + (int(index) + 1) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return (z ^ (z >> 31)) & _M31


def fold_generator(generator: Optional[torch.Generator], index: int):
    """A new generator for stream ``index`` of ``generator``: one seed is drawn
    from ``generator`` (so every rank's ``generator`` advances alike) and
    folded with ``index``; for a generator on the card that read waits for
    the card. None stays None."""
    if generator is None:
        return None
    seed = int(torch.randint(0, _M31, (1,), generator=generator, device=generator.device))
    return torch.Generator(device=generator.device).manual_seed(fold_seed(seed, index))


def fold_points(generator: Optional[torch.Generator]):
    """Decorrelate a per-point stream across point shards (the q_sample
    noise, the fit loss's per-point samples). Per-sample draws (part codes,
    timesteps, aligner noise) must not be folded: point shards of one sample
    share them."""
    if _POINT_GROUP is None:
        return generator
    return fold_generator(generator, dist.get_rank(_POINT_GROUP))
