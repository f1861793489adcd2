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
* the language encoder's ``OptimizedLSTMCell_0`` -> ``cell`` (its gate
  kernels ``ii`` ... ``ho`` keep flax's names);
* the super-segment encoders' ``_TwoStage_0`` -> ``two_stage``,
  ``PartglotSupSegsEncoderBase_0`` -> ``base``, ``ConditionalBatchNorm1d_{k}``
  -> ``cbn{k}``, the completion models' ``PCNEncoder_0`` -> ``pcn_encoder``;
* the per-part flow parameters come stacked on a leading part axis
  (``flow/flows/chain_{j}/Dense_{k}/kernel`` is (4, in, out)) and split into
  ``flow.flows.{p}``; the per-part PointNetV2 heads stay stacked, as the port
  keeps them.

``params`` fills the module's parameters and ``batch_stats`` its BatchNorm
buffers (``mean``, ``var``); without ``batch_stats`` the buffers keep their
values. A key that is missing or left over raises ``KeyError``; a shape that
differs raises ``ValueError``.

``export_jax_params(model)`` is the inverse: the two trees in the JAX layout,
the flow parameters restacked on the part axis. ``export_jax_train_state``
and ``load_jax_train_state`` carry a whole train state across, the step and
optax's optimizer state with it: ``opt_state`` is optax's chain as
``flax.serialization`` stores it (tuples as maps keyed "0", "1", ..., the
clip and scale states as empty maps, Adam's ``count``, ``mu`` and ``nu``,
the schedule's ``count``), laid out by ``jax_opt_layout`` from the port's
optimizer. ``mu`` and ``nu`` take the parameters' renaming and per-part
split; a moment that does not map raises as a parameter does.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Sequence, Tuple

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
    (re.compile(r"^OptimizedLSTMCell_0$"), "cell"),
    (re.compile(r"^_TwoStage_0$"), "two_stage"),
    (re.compile(r"^PartglotSupSegsEncoderBase_0$"), "base"),
    (re.compile(r"^ConditionalBatchNorm1d_(\d+)$"), r"cbn\1"),
    (re.compile(r"^PCNEncoder_0$"), "pcn_encoder"),
)


# list names of the port (a dotted index follows) -> the JAX prefix of ``<prefix>_<i>``
_LISTS = {"blocks": "block", "chain": "chain", "emb": "emb", "ln": "ln",
          "prior_blocks": "prior_block", "lang_blocks": "lang_block"}
_INVERSE = (
    (re.compile(r"^dense(\d+)$"), lambda m: ["Dense_" + m.group(1)]),
    (re.compile(r"^geglu$"), lambda m: ["GEGLU_0"]),
    (re.compile(r"^bn(\d+)$"), lambda m: ["TorchBatchNorm_" + m.group(1), "BatchNorm_0"]),
    (re.compile(r"^ln(\d+)$"), lambda m: ["LayerNorm_" + m.group(1)]),
    (re.compile(r"^group_norm$"), lambda m: ["GroupNorm_0"]),
    (re.compile(r"^cell$"), lambda m: ["OptimizedLSTMCell_0"]),
    (re.compile(r"^two_stage$"), lambda m: ["_TwoStage_0"]),
    (re.compile(r"^base$"), lambda m: ["PartglotSupSegsEncoderBase_0"]),
    (re.compile(r"^cbn(\d+)$"), lambda m: ["ConditionalBatchNorm1d_" + m.group(1)]),
    (re.compile(r"^pcn_encoder$"), lambda m: ["PCNEncoder_0"]),
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
            out[name] = val.float().numpy() if isinstance(val, torch.Tensor) else np.asarray(val)


def flatten_jax_tree(tree: Mapping) -> Dict[str, np.ndarray]:
    """A JAX ``params`` or ``batch_stats`` tree as {port name: array}."""
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    return flat


def jax_path(name: str) -> Tuple[List[str], int]:
    """A port name -> (its key path in the JAX tree, the part index of a
    ``flow.flows.{p}`` parameter, stacked on the leading axis there, or -1)."""
    tokens, path, part, i = name.split("."), [], -1, 0
    while i < len(tokens):
        tok = tokens[i]
        nxt = tokens[i + 1] if i + 1 < len(tokens) else ""
        if tok == "flows" and nxt.isdigit():
            path.append(tok)
            part, i = int(nxt), i + 2
            continue
        if tok in _LISTS and nxt.isdigit():
            path.append(f"{_LISTS[tok]}_{nxt}")
            i += 2
            continue
        for pat, fn in _INVERSE:
            m = pat.match(tok)
            if m:
                path.extend(fn(m))
                break
        else:
            path.append(tok)
        i += 1
    return path, part


def _unflatten(named: Mapping[str, torch.Tensor]) -> Dict:
    """{port name: tensor} -> the JAX tree of float32 numpy arrays (parts restacked)."""
    tree: Dict = {}
    stacks: Dict[Tuple[str, ...], Dict[int, np.ndarray]] = {}
    for name, t in named.items():
        path, part = jax_path(name)
        arr = t.detach().float().cpu().numpy()
        if part >= 0:
            stacks.setdefault(tuple(path), {})[part] = arr
            continue
        _put(tree, path, arr, name)
    for path, parts in stacks.items():
        if sorted(parts) != list(range(len(parts))):
            raise KeyError(f"{'/'.join(path)}: flow parts {sorted(parts)} are not 0..n-1")
        _put(tree, list(path), np.stack([parts[p] for p in range(len(parts))]), "/".join(path))
    return tree


def _put(tree: Dict, path: List[str], value, name: str):
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
        if not isinstance(node, dict):
            raise KeyError(f"{name}: {key} is both a leaf and a module in the JAX tree")
    if path[-1] in node:
        raise KeyError(f"{name}: two port names map to {'/'.join(path)}")
    node[path[-1]] = value


def export_jax_params(model: nn.Module) -> Tuple[Dict, Dict]:
    """The model as the JAX package's ``(params, batch_stats)`` trees, float32
    numpy leaves: the inverse of ``load_jax_params``."""
    return (_unflatten(dict(model.named_parameters())),
            _unflatten(dict(model.named_buffers())))


ADAM, SCHEDULE = "adam", "schedule"  # the two optax states that hold numbers


def jax_opt_layout(tx) -> Dict:
    """The tree of optax's state for the JAX optimizer that the config of the
    port's optimizer ``tx`` builds (``difffacto_tpu/parallel/optim.py:102-150``),
    as flax stores it: ``ADAM`` marks Adam's (count, mu, nu), ``SCHEDULE`` the
    schedule's count, {} a state with no numbers."""
    sched = SCHEDULE if tx.schedule is not None else {}
    if tx.kind in ("adam", "adamax"):
        base = {"0": ADAM, "1": sched}
        if tx.weight_decay:
            base = {"0": {}, "1": base}  # add_decayed_weights first
    elif tx.kind == "adamw":
        base = {"0": ADAM, "1": {}, "2": sched}
    else:  # sgd
        base = {"0": {}, "1": sched}
    chain = ([{}] if tx.max_norm is not None else []) + [base]
    chain += [{}] if tx.lr_scale_fn is not None else []
    return {str(i): node for i, node in enumerate(chain)}


def export_jax_train_state(state, tx) -> Dict:
    """The port's ``TrainState`` as the state dict the JAX package's
    checkpoint holds: step, params, batch_stats, opt_state."""
    params, batch_stats = export_jax_params(state.model)
    names = [n for n, _ in state.model.named_parameters()]
    count = np.asarray(int(state.opt_state["count"].item()), np.int32)

    def fill(node):
        if node == ADAM:
            return {"count": count,
                    **{k: _unflatten(dict(zip(names, state.opt_state[k]))) for k in ("mu", "nu")}}
        if node == SCHEDULE:
            return {"count": count}
        return {k: fill(v) for k, v in node.items()}

    return {"step": np.asarray(state.step, np.int32), "params": params,
            "batch_stats": batch_stats, "opt_state": fill(jax_opt_layout(tx))}


def load_jax_train_state(state, tx, tree: Mapping):
    """A JAX checkpoint's state dict into the port's ``TrainState``: the
    parameters and BatchNorm buffers in place, Adam's moments, the count and
    the step into a new state, which is returned. The optimizer state must
    have the layout of ``jax_opt_layout(tx)``; a key of it, or a moment, that
    is missing or left over raises ``KeyError``, a shape ``ValueError``."""
    from ..parallel.train import TrainState

    model = state.model
    found: Dict[str, Mapping] = {}

    def walk(node, got, path):
        if node in (ADAM, SCHEDULE):
            want = {"count", "mu", "nu"} if node == ADAM else {"count"}
            if not isinstance(got, Mapping) or set(got) != want:
                raise KeyError(f"opt_state{path}: expected {sorted(want)}, got "
                               f"{sorted(got) if isinstance(got, Mapping) else type(got).__name__}")
            found.setdefault(node, got)
            return
        if not isinstance(got, Mapping) or set(got) != set(node):
            raise KeyError(f"opt_state{path}: expected keys {sorted(node)}, got "
                           f"{sorted(got) if isinstance(got, Mapping) else type(got).__name__}")
        for k in node:
            walk(node[k], got[k], f"{path}/{k}")

    walk(jax_opt_layout(tx), tree["opt_state"], "")
    load_jax_params(model, tree["params"], tree["batch_stats"])
    params = dict(model.named_parameters())
    opt = {}
    if ADAM in found:
        for key in ("mu", "nu"):
            targets = {n: torch.empty_like(p) for n, p in params.items()}
            _fill(targets, flatten_jax_tree(found[ADAM][key]))
            opt[key] = list(targets.values())
    source = found.get(ADAM) or found.get(SCHEDULE) or {"count": tree["step"]}
    device = next(iter(params.values())).device
    opt["count"] = torch.tensor(float(np.asarray(source["count"])), dtype=torch.float32,
                                device=device)
    return TrainState(step=int(np.asarray(tree["step"])), model=model, opt_state=opt)


def load_jax_params(model: nn.Module, params: Mapping, batch_stats: Mapping = None,
                    absent: Sequence[str] = ()) -> None:
    """Copy the JAX tree ``params`` into the parameters of ``model`` and, if
    given, ``batch_stats`` into its BatchNorm buffers, in place. ``absent``
    names submodules of the port (``encoder_mod.aligner``) that the trees
    leave out as a whole: those keep their values. Any other parameter the
    trees lack, and any leaf the port lacks, raises."""
    _fill(dict(model.named_parameters()), flatten_jax_tree(params), absent)
    if batch_stats is not None:
        _fill(dict(model.named_buffers()), flatten_jax_tree(batch_stats), absent)


def _fill(targets: Dict[str, torch.Tensor], flat: Dict[str, np.ndarray],
          absent: Sequence[str] = ()) -> None:
    skip = tuple(f"{a}." for a in absent)
    missing = sorted(n for n in set(targets) - set(flat) if not n.startswith(skip))
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
