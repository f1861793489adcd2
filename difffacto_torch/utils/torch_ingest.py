"""A reference PyTorch checkpoint (``pretrained/<cat>.pth``) into the port's modules.

The port's own copy of ``difffacto_tpu/utils/torch_ingest.py``'s mapping. The
reference's state dict (module names of its PointNet, part encoders, flows and
attention) becomes a tree in the JAX package's parameter layout, which the
port's weight bridge (``utils/jax_params.py``) renames onto its modules:

* 1x1 Conv1d (out, in, 1) and Linear (out, in) -> a dense kernel (in, out);
* BatchNorm1d weight, bias, running_mean, running_var -> a ``TorchBatchNorm``'s
  scale, bias and its ``mean``, ``var`` buffers;
* the grouped per-part Conv1d heads (out K, in, 1) -> stacked kernels
  (K, in, out), the grouped BatchNorm -> (K, C);
* the per-part flow ``ModuleList`` -> the per-part flows;
* a block's LayerNorm, attention and GEGLU feed-forward -> its flat
  parameters.

The loader fails loudly: every model key of the checkpoint (``encoder.`` and
``diffusion.``) is consumed, each parameter it fills exists in the port, and
each matches in shape, and each parameter of the port is filled, but for an
aligner or flow the checkpoint holds no key of (a stage-1 checkpoint), which
keeps its values.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from .jax_params import load_jax_params


def _k(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def _t(w):
    return np.ascontiguousarray(np.asarray(w).T)


def _conv1d_to_dense(w):
    """(out, in, 1) -> (in, out)."""
    return np.ascontiguousarray(np.asarray(w)[..., 0].T)


class TreeBuilder:
    """Writes leaves into two nested dicts, ``params`` and ``batch_stats``,
    by '/'-joined path; writing a path twice raises."""

    def __init__(self):
        self.trees = {"params": {}, "batch_stats": {}}
        self.written: List[str] = []

    def put(self, collection: str, path: str, value):
        node = self.trees[collection]
        keys = [k for k in path.split("/") if k]
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        if keys[-1] in node:
            raise KeyError(f"{collection}/{path} written twice")
        node[keys[-1]] = np.asarray(value, np.float32)
        self.written.append(f"{collection}/{path}")


def _map_bn(sd, fill, tkey, jpath, per_part: bool = False, K: int = 1):
    for tname, jname, col in (("weight", "scale", "params"), ("bias", "bias", "params"),
                              ("running_mean", "mean", "batch_stats"),
                              ("running_var", "var", "batch_stats")):
        v = np.asarray(sd.pop(f"{tkey}.{tname}"))
        fill.put(col, f"{jpath}/BatchNorm_0/{jname}", v.reshape(K, -1) if per_part else v)
    sd.pop(f"{tkey}.num_batches_tracked", None)


def _map_head_mlp(sd, fill, tprefix: str, jprefix: str, per_part: bool, K: int):
    """The mlp_m / mlp_v heads (pointnet.py:157-185): Sequential(conv, bn,
    relu, conv, bn, relu, conv), grouped by part where ``per_part``."""
    for di, ci in enumerate((0, 3, 6)):
        w = np.asarray(sd.pop(_k(tprefix, f"{ci}.weight")))
        b = np.asarray(sd.pop(_k(tprefix, f"{ci}.bias")))
        if per_part:
            out_k = w.shape[0] // K
            kern = np.stack([_conv1d_to_dense(w[k * out_k:(k + 1) * out_k]) for k in range(K)])
            bias = b.reshape(K, out_k)
        else:
            kern, bias = _conv1d_to_dense(w), b
        fill.put("params", f"{jprefix}/Dense_{di}/kernel", kern)
        fill.put("params", f"{jprefix}/Dense_{di}/bias", bias)
    for bi, ti in enumerate((1, 4)):
        _map_bn(sd, fill, _k(tprefix, str(ti)), f"{jprefix}/TorchBatchNorm_{bi}", per_part, K)


def _map_pointnet_stack(sd, fill, tprefix: str, jprefix: str, n: int = 4):
    """conv1..4 and bn1..4 (pointnet.py:132-139) -> the conv-BN-ReLU stack."""
    for i in range(n):
        fill.put("params", f"{jprefix}/Dense_{i}/kernel",
                 _conv1d_to_dense(sd.pop(_k(tprefix, f"conv{i + 1}.weight"))))
        fill.put("params", f"{jprefix}/Dense_{i}/bias", sd.pop(_k(tprefix, f"conv{i + 1}.bias")))
        _map_bn(sd, fill, _k(tprefix, f"bn{i + 1}"), f"{jprefix}/TorchBatchNorm_{i}")


def _map_linear(sd, fill, tkey, jpath):
    fill.put("params", f"{jpath}/kernel", _t(sd.pop(f"{tkey}.weight")))
    if f"{tkey}.bias" in sd:
        fill.put("params", f"{jpath}/bias", sd.pop(f"{tkey}.bias"))


def _map_layernorm(sd, fill, tkey, jpath):
    fill.put("params", f"{jpath}/scale", sd.pop(f"{tkey}.weight"))
    fill.put("params", f"{jpath}/bias", sd.pop(f"{tkey}.bias"))


def _map_block(sd, fill, tprefix, jprefix):
    """A single-attention block (attention.py:259-306) -> the flat layout:
    norm2, attn2 (q, k, v, out), norm3, ff (GEGLU proj, out)."""
    for tname, jname in (("norm2.weight", "norm2_scale"), ("norm2.bias", "norm2_bias"),
                         ("attn2.to_out.0.bias", "bout"), ("norm3.weight", "ffn_ln_scale"),
                         ("norm3.bias", "ffn_ln_bias"), ("ff.net.0.proj.bias", "ffn_b1"),
                         ("ff.net.2.bias", "ffn_b2")):
        fill.put("params", f"{jprefix}/{jname}", sd.pop(_k(tprefix, tname)))
    for tname, jname in (("attn2.to_q.weight", "wq"), ("attn2.to_k.weight", "wk"),
                         ("attn2.to_v.weight", "wv"), ("attn2.to_out.0.weight", "wout"),
                         ("ff.net.0.proj.weight", "ffn_w1"), ("ff.net.2.weight", "ffn_w2")):
        fill.put("params", f"{jprefix}/{jname}", _t(sd.pop(_k(tprefix, tname))))


def _map_transformer_like(sd, fill, tprefix, jprefix, depth, has_class_emb=False,
                          has_time_embed=False):
    _map_linear(sd, fill, _k(tprefix, "proj_in"), f"{jprefix}/proj_in")
    _map_linear(sd, fill, _k(tprefix, "proj_out"), f"{jprefix}/proj_out")
    _map_layernorm(sd, fill, _k(tprefix, "pre_norm"), f"{jprefix}/pre_norm")
    _map_layernorm(sd, fill, _k(tprefix, "post_norm"), f"{jprefix}/post_norm")
    if has_class_emb and _k(tprefix, "class_emb.weight") in sd:
        fill.put("params", f"{jprefix}/class_emb", sd.pop(_k(tprefix, "class_emb.weight")))
    if has_time_embed:
        # FeedForward(glu) (attention.py:77-94): net.0.proj (GEGLU), net.2
        _map_linear(sd, fill, _k(tprefix, "time_embed.net.0.proj"),
                    f"{jprefix}/time_embed/GEGLU_0/Dense_0")
        _map_linear(sd, fill, _k(tprefix, "time_embed.net.2"), f"{jprefix}/time_embed/Dense_0")
    for d in range(depth):
        _map_block(sd, fill, _k(tprefix, f"transformer_blocks.{d}"), f"{jprefix}/block_{d}")


def _map_flows(sd, fill, tprefix, jprefix, n_class, depth):
    """The per-part coupling flows (flow.py:7-79), stacked on a part axis."""
    for j in range(depth):
        for li, dense in ((0, "Dense_0"), (2, "Dense_1"), (4, "Dense_2")):
            key = lambda i, what: _k(tprefix, f"{i}.chain.{j}.net_s_t.{li}.{what}")
            fill.put("params", f"{jprefix}/flows/chain_{j}/{dense}/kernel",
                     np.stack([_t(sd.pop(key(i, "weight"))) for i in range(n_class)]))
            fill.put("params", f"{jprefix}/flows/chain_{j}/{dense}/bias",
                     np.stack([np.asarray(sd.pop(key(i, "bias"))) for i in range(n_class)]))


def convert_state_dict(torch_sd: Dict[str, Any], n_class: int = 4, flow_depth: int = 14,
                       aligner_depth: int = 5, denoiser_depth: int = 5,
                       per_part_mlp: bool = True) -> Tuple[Dict, Dict, List[str]]:
    """A reference ``AnchorDiffAE`` state dict -> (params, batch_stats, the
    torch keys left unconsumed), the trees in the JAX package's layout."""
    sd = {(k[len("module."):] if k.startswith("module.") else k):
          (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
          for k, v in torch_sd.items()}
    fill = TreeBuilder()
    enc_t, enc_j = "encoder.encoder", "encoder_mod/encoder_net"
    _map_pointnet_stack(sd, fill, enc_t, f"{enc_j}/pnet")
    _map_head_mlp(sd, fill, f"{enc_t}.mlp_m", f"{enc_j}/mlp_m", per_part_mlp, n_class)
    _map_head_mlp(sd, fill, f"{enc_t}.mlp_v", f"{enc_j}/mlp_v", per_part_mlp, n_class)
    if any(k.startswith("encoder.part_aligner.") for k in sd):
        # pre_norm is in the checkpoint whether or not the aligner applies it
        _map_transformer_like(sd, fill, "encoder.part_aligner", "encoder_mod/aligner",
                              aligner_depth, has_class_emb=True)
    if any(k.startswith("encoder.flow.") for k in sd):
        _map_flows(sd, fill, "encoder.flow", "encoder_mod/flow", n_class, flow_depth)
    _map_transformer_like(sd, fill, "diffusion.model", "net", denoiser_depth,
                          has_time_embed=True)
    return fill.trees["params"], fill.trees["batch_stats"], sorted(sd)


def read_checkpoint(path: str) -> Dict[str, Any]:
    """The model state dict of a reference ``.pth``. The reference saves plain
    dicts of tensors and numbers (its runner's ``{"model": state_dict, ...}``),
    which the safe unpickler reads: ``weights_only=True``, with no fallback to
    full unpickling, which would run whatever code the file carries."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return ckpt.get("model", ckpt)


def load_state_dict(model, torch_sd: Dict[str, Any]) -> List[str]:
    """Fill ``model`` (the port's ``AnchorDiffAE``) from a reference state
    dict in place; returns the keys left over that are not the model's
    (optimizer, language and other extras). A model key left over raises
    ``ValueError``, a parameter the port lacks or one the checkpoint lacks
    ``KeyError``, and a shape that differs ``ValueError``. Only an aligner or
    flow the checkpoint holds no key of keeps its values (a stage-1
    checkpoint)."""
    enc_cfg = dict(model.encoder)
    params, stats, leftovers = convert_state_dict(
        torch_sd, n_class=model.num_anchors,
        flow_depth=enc_cfg.get("latent_flow_depth", 14),
        aligner_depth=(enc_cfg.get("part_aligner") or {}).get("depth", 5),
        denoiser_depth=model.diffusion["net"].get("depth", 5),
        per_part_mlp=enc_cfg["encoder"].get("per_part_mlp", True),
    )
    suspicious = [k for k in leftovers if k.startswith(("encoder.", "diffusion."))]
    if suspicious:
        raise ValueError(f"unmapped reference weights: {suspicious[:10]}")
    absent = [name for name, sub in (("encoder_mod.aligner", "aligner"), ("encoder_mod.flow", "flow"))
              if sub not in params.get("encoder_mod", {})]
    load_jax_params(model, params, stats, absent=absent)
    return leftovers


def load_reference_checkpoint(path: str, model) -> List[str]:
    """Load a reference ``.pth`` into ``model`` in place (``load_state_dict``)."""
    return load_state_dict(model, read_checkpoint(path))
