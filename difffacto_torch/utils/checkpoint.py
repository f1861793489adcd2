"""Checkpoint save and load, with a shape-tolerant partial restore.

The port's counterpart of ``difffacto_tpu/utils/checkpoint.py``: epoch-indexed
checkpoints ``work_dir/checkpoints/ckpt_<epoch>.pt`` beside a
``ckpt_<epoch>.meta.json`` (epoch, iter, config dump). A checkpoint is a dict
of tensors that ``torch.load(weights_only=True)`` reads:

* ``params``: the model's parameters by name (the JAX ``params``);
* ``batch_stats``: its buffers, the BatchNorm statistics (the JAX
  ``batch_stats``);
* ``opt_state``: the optimizer's ``count`` and its moments ``mu`` and ``nu``
  by parameter name;
* ``step``: the train state's step counter;
* ``noise_table`` (where the run has one): the CIMLE table, ``ids`` and
  ``noise``, one row a training shape.

The training step's generators come from (seed, step) and the schedule reads
the optimizer's count, so both round-trip, and so does the CIMLE table: a
resumed run draws the same dropout and diffusion noise and trains on the same
cached noise as an uninterrupted one. (The JAX package's checkpoints carry no
table: its resumed runs train on zero noise until the next re-cache.)

``load_checkpoint`` copies every entry whose name and shape match and reports
the rest as skipped; ``strict`` raises on a skip; ``model_only`` restores the
parameters and BatchNorm buffers alone (the two-stage training wiring).
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..parallel.train import TrainState

MODEL_KEYS = ("params", "batch_stats")


def state_dict(state: TrainState) -> Dict[str, Any]:
    """The train state as the nested dict a checkpoint holds (live tensors)."""
    names = [n for n, _ in state.model.named_parameters()]
    opt = {"count": state.opt_state["count"]}
    for key in ("mu", "nu"):
        if key in state.opt_state:
            opt[key] = dict(zip(names, state.opt_state[key]))
    return {
        "params": dict(state.model.named_parameters()),
        "batch_stats": dict(state.model.named_buffers()),
        "opt_state": opt,
        "step": torch.tensor(state.step, dtype=torch.int64),
    }


def save_checkpoint(work_dir: str, epoch: int, state: TrainState, meta: Optional[Dict] = None,
                    noise_table: Optional[Dict[int, np.ndarray]] = None) -> str:
    """Write ``checkpoints/ckpt_<epoch>.pt`` and its ``.meta.json``; returns
    the path. ``noise_table`` is the CIMLE table, {training id: noise}."""
    ckpt_dir = os.path.join(work_dir, "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"ckpt_{epoch}.pt")

    def host(node):
        if isinstance(node, dict):
            return {k: host(v) for k, v in node.items()}
        return node.detach().cpu().clone()

    ckpt = host(state_dict(state))
    if noise_table:
        ids = sorted(noise_table)
        ckpt["noise_table"] = {
            "ids": torch.tensor(ids, dtype=torch.int64),
            "noise": torch.from_numpy(np.stack([np.asarray(noise_table[i], np.float32)
                                                for i in ids])),
        }
    tmp = path + ".tmp"
    torch.save(ckpt, tmp)
    os.replace(tmp, path)
    with open(path[: -len(".pt")] + ".meta.json", "w") as f:
        json.dump({"epoch": epoch, **(meta or {})}, f)
    return path


def search_ckpt(work_dir: str) -> Optional[str]:
    """The newest checkpoint by epoch number, or None."""
    files = glob.glob(os.path.join(work_dir, "checkpoints", "ckpt_*.pt"))
    if not files:
        return None
    return max(files, key=lambda p: int(re.search(r"ckpt_(\d+)\.pt$", p).group(1)))


def _merge_partial(target, loaded, path="") -> List[str]:
    """Copy ``loaded`` into ``target`` in place where names AND shapes match;
    returns what was skipped. Entries of ``loaded`` that ``target`` lacks are
    ignored."""
    skipped = []
    if isinstance(target, dict):
        for k, v in target.items():
            if isinstance(loaded, dict) and k in loaded:
                skipped += _merge_partial(v, loaded[k], f"{path}/{k}")
            else:
                skipped.append(f"{path}/{k} (missing)")
        return skipped
    if not isinstance(loaded, torch.Tensor) or target.shape != loaded.shape:
        shape = tuple(loaded.shape) if isinstance(loaded, torch.Tensor) else type(loaded).__name__
        return [f"{path} (shape {shape} != {tuple(target.shape)})"]
    with torch.no_grad():
        target.copy_(loaded.to(device=target.device, dtype=target.dtype))
    return []


def load_checkpoint(path: str, state: TrainState, model_only: bool = False,
                    strict: bool = False) -> Tuple[TrainState, Dict]:
    """Restore ``path`` into ``state`` (its model in place); returns
    (state, meta). Unless ``model_only``, ``meta["noise_table"]`` is the CIMLE
    table the checkpoint holds, {training id: noise}, or None."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    meta_path = path[: -len(".pt")] + ".meta.json"
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)

    target = state_dict(state)
    if model_only:
        target = {k: target[k] for k in MODEL_KEYS}
        raw = {k: v for k, v in raw.items() if k in MODEL_KEYS}
    else:
        # the optimizer's state is replaced, never written through
        opt = state.opt_state
        target["opt_state"] = {"count": opt["count"].clone()}
        for key in ("mu", "nu"):
            if key in opt:
                target["opt_state"][key] = {n: t.clone() for n, t in
                                            zip(target["params"], opt[key])}
    skipped = _merge_partial(target, raw)
    if strict and skipped:
        raise ValueError(f"missing or mismatched checkpoint entries: {skipped}")
    if skipped:
        print(f"[checkpoint] skipped {len(skipped)} entries, e.g. {skipped[:5]}")
    if model_only:
        return state, meta
    table = raw.get("noise_table")
    meta["noise_table"] = None if table is None else {
        int(i): n.numpy() for i, n in zip(table["ids"], table["noise"])}
    opt = target["opt_state"]
    new_opt = {"count": opt["count"]}
    for key in ("mu", "nu"):
        if key in opt:
            new_opt[key] = list(opt[key].values())
    return TrainState(step=int(target["step"]), model=state.model, opt_state=new_opt), meta
