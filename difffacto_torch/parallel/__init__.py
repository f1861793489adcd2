"""Meshes, the point-axis collectives, optimizers, schedules and the training step."""

from .axes import (allmax_points, fold_generator, fold_points, fold_seed, point_axis,
                   points_sharded, psum_points, sp_size)
from .mesh import (POINT_AXIS_BATCH_KEYS, Mesh, initialize_distributed, make_mesh, pmean_metrics,
                   rank_device, replicate, shard_batch)
from .optim import build_optimizer_from_cfg, make_optimizer

# .train imports the model layer, and the model modules import .axes from
# this package: the train symbols load lazily (PEP 562), as in the JAX package.
_TRAIN_SYMBOLS = ("TrainState", "init_train_state", "make_train_step", "parse_losses")


def __getattr__(name):
    if name in _TRAIN_SYMBOLS:
        from . import train

        return getattr(train, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
