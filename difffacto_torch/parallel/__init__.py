"""Optimizers, schedules and the training step."""

from .optim import build_optimizer_from_cfg, make_optimizer
from .train import TrainState, init_train_state, make_train_step, parse_losses
