"""The weight bridge: a JAX parameter tree into the port's modules.

``load_jax_params(model, params, batch_stats=None)`` takes
``variables["params"]`` (and ``variables["batch_stats"]``) of the JAX package
as nested dicts of arrays (anything ``numpy.asarray`` reads) and fills the
matching port module. The port keeps flax's names and (in, out) layout, so
the mapping is a renaming:

* ``block_{i}`` -> ``blocks.{i}``, ``chain_{j}`` -> ``chain.{j}``,
  ``Dense_{k}`` -> ``dense{k}``, ``GEGLU_0`` -> ``geglu``,
  ``TorchBatchNorm_{k}/BatchNorm_0`` -> ``bn{k}``, ``LayerNorm_{k}`` -> ``ln{k}``;
* UNet's ``GroupNorm_0`` -> ``group_norm``, ``emb_{i}`` -> ``emb.{i}``,
  ``ln_{i}`` -> ``ln.{i}``, ``prior_block_{i}`` -> ``prior_blocks.{i}``,
  ``lang_block_{i}`` -> ``lang_blocks.{i}``;
* the per-part flow parameters come stacked on a leading part axis
  (``flow/flows/chain_{j}/Dense_{k}/kernel`` is (4, in, out)) and split into
  ``flow.flows.{p}``; the per-part PointNetV2 heads stay stacked, as the port
  keeps them.

``params`` fills the module's parameters and ``batch_stats`` its BatchNorm
buffers (``mean``, ``var``); without ``batch_stats`` the buffers keep their
values. A key that is missing or left over raises ``KeyError``; a shape that
differs raises ``ValueError``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

_RENAMES = (
    (re.compile(r"^block_(\d+)$"), r"blocks.\1"),
    (re.compile(r"^chain_(\d+)$"), r"chain.\1"),
    (re.compile(r"^Dense_(\d+)$"), r"dense\1"),
    (re.compile(r"^GEGLU_0$"), "geglu"),
    (re.compile(r"^TorchBatchNorm_(\d+)$"), r"bn\1"),
    (re.compile(r"^LayerNorm_(\d+)$"), r"ln\1"),
    (re.compile(r"^GroupNorm_0$"), "group_norm"),
    (re.compile(r"^(emb|ln)_(\d+)$"), r"\1.\2"),
    (re.compile(r"^(prior|lang)_block_(\d+)$"), r"\1_blocks.\2"),
)


def _rename(key: str) -> str:
    for pat, rep in _RENAMES:
        if pat.match(key):
            return pat.sub(rep, key)
    return key


def _flatten(node: Mapping, prefix: str, out: Dict[str, np.ndarray]):
    for key, val in node.items():
        name = prefix + _rename(key)
        if isinstance(val, Mapping):
            if key == "BatchNorm_0":  # flax's module inside TorchBatchNorm
                _flatten(val, prefix, out)
            elif key == "flows":
                sub: Dict[str, np.ndarray] = {}
                _flatten(val, "", sub)
                for path, arr in sub.items():
                    for p in range(arr.shape[0]):
                        out[f"{name}.{p}.{path}"] = arr[p]
            else:
                _flatten(val, name + ".", out)
        else:
            out[name] = np.asarray(val)


def flatten_jax_tree(tree: Mapping) -> Dict[str, np.ndarray]:
    """A JAX ``params`` or ``batch_stats`` tree as {port name: array}."""
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    return flat


def load_jax_params(model: nn.Module, params: Mapping, batch_stats: Mapping = None) -> None:
    """Copy the JAX tree ``params`` into the parameters of ``model`` and, if
    given, ``batch_stats`` into its BatchNorm buffers, in place."""
    _fill(dict(model.named_parameters()), flatten_jax_tree(params))
    if batch_stats is not None:
        _fill(dict(model.named_buffers()), flatten_jax_tree(batch_stats))


def _fill(targets: Dict[str, torch.Tensor], flat: Dict[str, np.ndarray]) -> None:
    missing = sorted(set(targets) - set(flat))
    extra = sorted(set(flat) - set(targets))
    if missing or extra:
        raise KeyError(f"JAX tree does not match the port: missing {missing}, left over {extra}")
    for name, arr in flat.items():
        if tuple(arr.shape) != tuple(targets[name].shape):
            raise ValueError(
                f"{name}: JAX shape {tuple(arr.shape)} != port shape {tuple(targets[name].shape)}"
            )
    with torch.no_grad():
        for name, arr in flat.items():
            p = targets[name]
            p.copy_(torch.from_numpy(np.array(arr, np.float32)).to(p.device, p.dtype))
