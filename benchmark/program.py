"""The program under test, built for one configuration with the benchmark's weights."""

from __future__ import annotations

import copy

import torch

import inputs


def build(config: dict, seed: int, device):
    """(model, weights): the configuration's ``AnchorDiffAE`` built by the
    program, in the configuration's dtype, holding the weights drawn from
    ``seed`` (float32, by the program's checkpoint names)."""
    from difffacto_torch import MODELS, build_from_cfg

    mcfg = copy.deepcopy(config["model"])
    mcfg["dtype"] = getattr(torch, config["dtype"])
    model = build_from_cfg(mcfg, MODELS, device=device, seed=0)
    layout = [(k, v.shape) for k, v in model.state_dict().items()]
    weights = inputs.weights(layout, seed, device)
    model.load_state_dict(weights)
    return model, weights
