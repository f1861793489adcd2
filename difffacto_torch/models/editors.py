"""The latent editors, the listener and the super-segment generator.

Port of ``difffacto_tpu/models/editors.py``:

* ``ParameterTrainer`` (``editors.py:42-56``): the part encoder's losses in
  training (its aligner's fit), nothing else.
* ``PartglotClassifier`` (``:59-110``): the listener. The LSTM's text
  feature cross-attends over the part latents (``part_indicator`` as the
  mask), then Dense 512, BN, ReLU, 128, BN, ReLU, 1: a logit a shape;
  ``listener_loss`` is the target-against-distractor cross entropy.
* ``LatentDiffEdit`` (``:113-189``): a latent diffusion (``LDM`` on
  ``LDMNet``) of the target's part latents conditioned on the distractor's
  latents and the text feature.
* ``PartLatentEditor`` (``:192-259``): the fuser edits the distractor's
  (detached) latents with the text; direction, magnitude and the listener's
  logit supervise it. The caller freezes what should not train, as in the
  JAX module.
* ``_LatentProjection`` and ``AnchorDiffGenSuperSegments`` (``:262-782``):
  the decomposer-based generator whose primary part latents may be split
  into intrinsic codes and per-part shift and scale (``project_latent``),
  with its training loss, predict, parameter readout, latent combination,
  anchor drift and latent interpolation.
* ``Aligner`` (``:784-842``): per-part 6-dof parameters regressed from the
  encoder's codes, with their Gaussian fit loss.
* ``PartglotFinetune`` (``:845-858``): the loss of the editor it builds.

Every draw comes from an explicit ``torch.Generator`` (``rngs["sample"]``
and ``rngs["dropout"]`` in the losses, ``generator`` in the decoders) or is
injected: in the losses the batch's ``text_keep`` (the LSTM's embedding
dropout keep mask), ``part_keep`` and ``global_keep`` (guidance keep masks),
``global_shift_uniform`` and ``global_scale_uniform`` (the (B, 1, 3)
uniform draws of the super-segment generator's train-time augments),
``projection_keep`` (its post feed-forward's dropout keep mask),
``diffusion_t`` and ``diffusion_noise``; in the decoders ``noise`` (x_T, or
the forward chain's draw), ``step_noise`` and ``anchor_drift``'s
``direction``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import (MLP, Dense, GroupNorm, TorchBatchNorm, default_generator, dropout,
                         lecun_normal, param)
from ..utils.device import randn, resolve_device
from ..utils.gaussian import gaussian_log_likelihood
from ..utils.registry import DECOMPOSERS, ENCODERS, MODELS, NETS, SAMPLERS, build_from_cfg
from . import decomposers, denoiser, diffusion_extra, language, supseg_encoders  # noqa: F401
from .anchor_diff import build_diffusion
from .orchestrators_extra import _AnchoredBase, _uniform
from .part_encoder import gather_per_point


def _kw(dtype, device, seed):
    return dict(dtype=dtype, device=resolve_device(device),
                generator=torch.Generator().manual_seed(seed))


def _code(out):
    return out[0] if isinstance(out, tuple) else out


def _encode_pair(encoder, K, target, distractor, target_attn, distractor_attn, train):
    """(B, 2, K, C): the target's and the distractor's codes, encoded as one
    batch of 2 B clouds with their part maps."""
    B, N = target.shape[:2]
    x = torch.stack([target, distractor], 1).reshape(B * 2, N, 3)
    attn = torch.stack([target_attn, distractor_attn], 1).reshape(B * 2, N, -1)
    return _code(encoder(torch.cat([x, attn.to(x.dtype)], dim=-1), train=train)).reshape(
        B, 2, K, -1)


@MODELS.register_module()
class ParameterTrainer(nn.Module):
    """Only the encoder's part-parameter fit (``editors.py:42-56``). ``seed``
    fixes the initial weights."""

    def __init__(self, encoder: dict, num_anchors: int, npoints: int = 2048, *, dtype=None,
                 device="cuda", seed: int = 0):
        super().__init__()
        self.num_anchors, self.npoints = num_anchors, npoints
        self.encoder_mod = build_from_cfg(dict(encoder), ENCODERS, **_kw(dtype, device, seed))

    def loss(self, batch, epoch=0, train: bool = True, rngs=None) -> Dict[str, torch.Tensor]:
        """The encoder's loss dict in training; its batch keys and ``rngs``
        as ``PartEncoder.forward`` reads them."""
        return self.encoder_mod(batch, epoch=epoch, train=True, rngs=rngs)[4]


@MODELS.register_module()
class PartglotClassifier(nn.Module):
    """The listener (``editors.py:59-110``): does ``text`` refer to these
    parts? ``language_encoder`` defaults to an ``LSTM`` ``text_dim`` wide.
    Built as a model, ``seed`` fixes its weights; built inside another
    model, ``generator`` does."""

    def __init__(self, text_dim: int = 64, part_dim: int = 256, num_part: int = 4,
                 language_encoder: Optional[dict] = None, *, dtype=None, device="cuda",
                 seed: int = 0, generator=None):
        super().__init__()
        device = resolve_device(device)
        g = generator if generator is not None else torch.Generator().manual_seed(seed)
        self.text_dim, self.part_dim, self.num_part = text_dim, part_dim, num_part
        self.language_enc = build_from_cfg(
            dict(language_encoder or dict(type="LSTM", text_dim=text_dim)), ENCODERS,
            device=device, generator=g)
        self.xattn = language.MultiHeadCrossAttention(text_dim, part_dim, part_dim, nheads=4,
                                                      qk_dim=128, device=device, generator=g)
        kw = dict(dtype=dtype, device=device)
        self.dense0, self.bn0 = Dense(part_dim, 512, generator=g, **kw), TorchBatchNorm(512, **kw)
        self.dense1, self.bn1 = Dense(512, 128, generator=g, **kw), TorchBatchNorm(128, **kw)
        self.dense2 = Dense(128, 1, generator=g, **kw)

    def forward(self, part_latent, text, part_indicator, train: bool = False, generator=None,
                text_keep=None):
        """part_latent (B, K, part_dim), text (B, L) int, part_indicator
        (B, K) -> logits (B,). With ``train`` the LSTM's and the attention's
        dropout draw from ``generator`` (``text_keep`` injects the LSTM's) and
        the BatchNorms take batch statistics."""
        tfeat = self.language_enc(text, train, generator, text_keep)[0]
        msg = self.xattn(tfeat[:, None], part_latent, part_indicator, train, generator)[:, 0]
        h = torch.relu(self.bn0(self.dense0(msg), train))
        h = torch.relu(self.bn1(self.dense1(h), train))
        return self.dense2(h)[:, 0]

    def listener_loss(self, part_latent_pos, part_latent_neg, text, part_indicator,
                      train: bool = True, generator=None) -> Dict[str, torch.Tensor]:
        """The target-against-distractor cross entropy and the accuracy."""
        lp = self(part_latent_pos, text, part_indicator, train, generator)
        ln = self(part_latent_neg, text, part_indicator, train, generator)
        logits = torch.stack([lp, ln], dim=-1)
        return {"listener_loss": -F.log_softmax(logits, dim=-1)[:, 0].mean(),
                "listener_acc": (logits[:, 0] > logits[:, 1]).to(logits.dtype).mean()}


@MODELS.register_module()
class LatentDiffEdit(nn.Module):
    """Language-conditioned latent diffusion (``editors.py:113-189``): the
    target's part latents denoised with the distractor's latents and the text
    feature as the context of each part token. ``pcd_mixer`` builds a
    decomposer that nothing reads, as in the JAX module;
    ``language_latent_dropout_prob`` is read nowhere there either. The chain
    and the net are ``diff`` and ``net``: sampling is their
    ``p_sample_loop`` over (B, K, zdim) latents, as the JAX class has no
    sampling method. ``seed`` fixes the initial weights."""

    def __init__(self, encoder: dict, diffusion: dict, sampler: dict, language_encoder: dict,
                 num_anchors: int, num_timesteps: int, pcd_mixer: Optional[dict] = None,
                 guidance: bool = False, part_latent_dropout_prob: float = 0.1,
                 language_latent_dropout_prob: float = 0.1, zero_part_latent: bool = False,
                 *, dtype=None, device="cuda", seed: int = 0):
        super().__init__()
        kw = _kw(dtype, device, seed)
        self.num_anchors, self.num_timesteps = num_anchors, num_timesteps
        self.guidance, self.zero_part_latent = guidance, zero_part_latent
        self.part_latent_dropout_prob = part_latent_dropout_prob
        self.language_latent_dropout_prob = language_latent_dropout_prob
        self.encoder_mod = build_from_cfg(dict(encoder), ENCODERS, num_anchors=num_anchors, **kw)
        self.language_enc = build_from_cfg(dict(language_encoder), ENCODERS,
                                           device=kw["device"], generator=kw["generator"])
        self.mixer = (build_from_cfg(dict(pcd_mixer), DECOMPOSERS, num_anchors=num_anchors, **kw)
                      if pcd_mixer else None)
        self.net = build_from_cfg(dict(diffusion["net"]), NETS, **kw)
        self.diff = build_diffusion(diffusion, num_timesteps)
        self.t_sampler = build_from_cfg(dict(sampler), SAMPLERS, num_timesteps=num_timesteps)

    def encode_pair(self, target, distractor, target_attn, distractor_attn, train: bool = False):
        """(B, 2, K, zdim): the target's and the distractor's codes."""
        return _encode_pair(self.encoder_mod, self.num_anchors, target, distractor, target_attn,
                            distractor_attn, train)

    def loss(self, batch, epoch=0, train: bool = True, rngs=None) -> Dict[str, torch.Tensor]:
        """The chain's training loss on the target's latents from zero
        anchors (``editors.py:158-189``)."""
        rngs = rngs or {}
        sample, drop = rngs.get("sample"), rngs.get("dropout")
        target = batch["target"]
        codes = self.encode_pair(target, batch["distractor"], batch["target_attn_map"],
                                 batch["distractor_attn_map"], train=True)
        tgt_lat, dis_lat = codes[:, 0], codes[:, 1]
        text_feat = self.language_enc(batch["text"], True, drop, batch.get("text_keep"))[0]
        B, K = target.shape[0], self.num_anchors
        if self.guidance:
            keep = batch.get("part_keep")
            if keep is None:
                keep = _uniform((B, K), sample, target.device) >= self.part_latent_dropout_prob
            dis_lat = dis_lat * keep[..., None].to(dis_lat.dtype)
        if self.zero_part_latent:
            dis_lat = torch.zeros_like(dis_lat)
        ctx = torch.cat([dis_lat, text_feat[:, None].expand(B, K, text_feat.shape[-1])
                         .to(dis_lat.dtype)], dim=-1)
        t = batch.get("diffusion_t")
        if t is None:
            t, _ = self.t_sampler.sample(sample, B, device=target.device)

        def model_fn(inp, ts, c, anc, var, seg, vid):
            return self.net(inp, ts, c, anc, var, seg, vid, train=True, generator=drop)

        return self.diff.training_losses(
            model_fn, tgt_lat, t.long(), anchors=torch.zeros_like(tgt_lat), ctx=ctx,
            seg_mask=torch.zeros(B, K, dtype=torch.int32, device=target.device),
            noise=batch.get("diffusion_noise"), generator=sample)


@MODELS.register_module()
class PartLatentEditor(nn.Module):
    """Supervised latent editing with a listener (``editors.py:192-259``).
    The point encoder runs in eval mode and its codes are detached; the JAX
    module freezes nothing else itself, and neither does this one: the
    caller's trainable filter does. ``seed`` fixes the initial weights."""

    def __init__(self, language_encoder: dict, latent_language_fuser: dict, pcd_encoder: dict,
                 num_part_latent: int = 4, text_dim: int = 64, out_dim: int = 256,
                 logit_weight: float = 1.0, direction_weight: float = 1.0,
                 magnitude_weight: float = 1.0, *, dtype=None, device="cuda", seed: int = 0):
        super().__init__()
        kw = _kw(dtype, device, seed)
        lang = dict(device=kw["device"], generator=kw["generator"])
        self.num_part_latent, self.text_dim, self.out_dim = num_part_latent, text_dim, out_dim
        self.logit_weight, self.direction_weight = logit_weight, direction_weight
        self.magnitude_weight = magnitude_weight
        self.language_enc = build_from_cfg(dict(language_encoder), ENCODERS, **lang)
        self.fuser = build_from_cfg(dict(latent_language_fuser), ENCODERS,
                                    num_part=num_part_latent, **lang)
        self.pcd_enc = build_from_cfg(dict(pcd_encoder), ENCODERS, num_anchors=num_part_latent,
                                      **kw)
        self.listener = PartglotClassifier(text_dim=text_dim, part_dim=out_dim,
                                           num_part=num_part_latent,
                                           language_encoder=dict(type="LSTM", text_dim=text_dim),
                                           device=kw["device"], generator=kw["generator"])

    def loss(self, batch, epoch=0, train: bool = True, rngs=None) -> Dict[str, torch.Tensor]:
        """The distractor's latents edited towards the target's: the
        direction, magnitude and logit losses (``editors.py:225-259``)."""
        rngs = rngs or {}
        codes = _encode_pair(self.pcd_enc, self.num_part_latent, batch["target"],
                             batch["distractor"], batch["target_attn_map"],
                             batch["distractor_attn_map"], False).detach()
        tgt_lat, dis_lat = codes[:, 0], codes[:, 1]
        tfeat = self.language_enc(batch["text"], True, rngs.get("dropout"),
                                  batch.get("text_keep"))[0]
        pind = batch["part_indicator"].to(dis_lat.dtype)
        edited = self.fuser(dis_lat, pind, tfeat)[:, 0]
        ind = pind[..., None]
        true_delta = (tgt_lat - dis_lat) * ind
        pred_delta = (edited - dis_lat) * ind
        tn = true_delta / (torch.linalg.norm(true_delta, dim=-1, keepdim=True) + 1e-8)
        pn = pred_delta / (torch.linalg.norm(pred_delta, dim=-1, keepdim=True) + 1e-8)
        direction = (1.0 - (tn * pn).sum(-1)) * pind
        magnitude = (torch.linalg.norm(true_delta, dim=-1)
                     - torch.linalg.norm(pred_delta, dim=-1)) ** 2 * pind
        logit = self.listener(edited, batch["text"], pind, train=False)
        return {"direction_loss": self.direction_weight * direction.sum() / ind.sum(),
                "magnitude_loss": self.magnitude_weight * magnitude.sum() / ind.sum(),
                "logit_loss": -self.logit_weight * F.logsigmoid(logit).mean()}


class _LatentProjection(nn.Module):
    """A part latent split into an intrinsic code and extrinsic parameters
    and re-embedded (``editors.py:262-357``). ``project_pe_type`` 0: one
    Dense gives both; 1: an MLP gives the parameters, the latent is the
    intrinsic code; 2: the MLP reads the flattened K part latents.
    ``share_projection=False``: grouped per-part projections
    (``down_kernel`` (K, pd, pd + qd), ``up_kernel`` (K, qd, pd)). ``post_ff``:
    GroupNorm (32 groups over the K tokens and each group's channels) or
    BatchNorm, SiLU, dropout and a zero-initialised ``ff_out`` added to the
    latent."""

    def __init__(self, part_dim: int, param_dim: int, num_anchors: int, project_pe_type: int = 0,
                 share_projection: bool = True, post_ff: bool = False,
                 post_norm: Optional[str] = "gn", post_dp: float = 0.2, *, dtype=None,
                 device="cuda", generator=None):
        super().__init__()
        g = default_generator(generator)
        pd, qd, K = part_dim, param_dim, num_anchors
        self.part_dim, self.param_dim, self.num_anchors = pd, qd, K
        self.project_pe_type, self.share_projection = project_pe_type, share_projection
        self.post_ff, self.post_norm, self.post_dp = post_ff, post_norm, post_dp
        kw = dict(dtype=dtype, device=device, generator=g)
        if not share_projection:
            self.down_kernel = param(lecun_normal((K, pd, pd + qd), g), device)
            self.down_bias = param(torch.zeros(K, pd + qd), device)
            self.up_kernel = param(lecun_normal((K, qd, pd), g), device)
            self.up_bias = param(torch.zeros(K, pd), device)
        elif project_pe_type == 0:
            self.down0 = Dense(pd, pd + qd, **kw)
            self.up0 = Dense(qd, pd, **kw)
        else:
            widths = (128, 64, qd) if project_pe_type == 1 else (256, 64, qd * K)
            dims = (pd if project_pe_type == 1 else pd * K,) + widths
            for i in range(3):
                setattr(self, f"down_mlp_{i}", Dense(dims[i], dims[i + 1], **kw))
            self.up0 = Dense(qd, pd, **kw)
        if post_ff:
            if post_norm == "gn":
                self.ff_norm = GroupNorm(32, pd, eps=1e-6, device=device)
            elif post_norm == "bn":
                self.ff_norm = TorchBatchNorm(pd, dtype=dtype, device=device)
            self.ff_out = Dense(pd, pd, zero_kernel=True, **kw)

    def _mlp(self, h):
        h = torch.relu(h)
        for i in range(2):
            h = torch.relu(getattr(self, f"down_mlp_{i}")(h))
        return self.down_mlp_2(h)

    def down(self, latent):
        """latent (B, K, part_dim) -> (intrinsic, extrinsic (B, K, param_dim))."""
        B = latent.shape[0]
        if not self.share_projection:
            out = torch.einsum("bki,kio->bko", latent, self.down_kernel.to(latent.dtype))
            out = out + self.down_bias[None].to(out.dtype)
            return out[..., : self.part_dim], out[..., self.part_dim:]
        if self.project_pe_type == 0:
            out = self.down0(latent)
            return out[..., : self.part_dim], out[..., self.part_dim:]
        if self.project_pe_type == 1:
            return latent, self._mlp(latent)
        ext = self._mlp(latent.reshape(B, -1))
        return latent, ext.reshape(B, self.num_anchors, self.param_dim)

    def up(self, intrinsic, params, latent, train: bool = False, generator=None, keep=None):
        """The parameters re-embedded and added to the intrinsic code; with
        ``post_ff`` the latent plus the zero-initialised feed-forward of that
        sum (dropout with ``train``: ``keep`` (B, K, part_dim) injects its
        keep mask, else ``generator`` draws it)."""
        if self.share_projection:
            emb = self.up0(params)
        else:
            emb = torch.einsum("bki,kio->bko", params, self.up_kernel.to(params.dtype))
            emb = emb + self.up_bias[None].to(emb.dtype)
        out = intrinsic + emb
        if not self.post_ff:
            return out
        h = out
        if self.post_norm == "gn":
            h = self.ff_norm(h)
        elif self.post_norm == "bn":
            h = self.ff_norm(h, train)
        h = F.silu(h)
        if train and keep is not None:
            h = h * keep.to(h.dtype) / (1.0 - self.post_dp)
        else:
            h = dropout(h, self.post_dp, train, generator)
        return latent + self.ff_out(h)


@MODELS.register_module()
class AnchorDiffGenSuperSegments(_AnchoredBase):
    """The decomposer-based generator over PartGlot super-segments
    (``editors.py:360-782``). The encoder's primary part latents are split
    into intrinsic codes and per-part shift and scale with
    ``project_latent``; the decomposer gives a global code, anchors and
    secondary latents; an anchor loss supervises the per-point anchors; the
    chain trains with the global code as its one context token and the
    point's part latent concatenated onto its input. The chain keeps its
    configured variance: with ``learn_var`` the projected scale is its
    per-point variance.

    The constructor takes every JAX field. ``loss`` (the field) is kept as
    ``anchor_loss_cfg``, so that ``loss`` is the method, and read nowhere:
    the anchor loss is the squared error, as in the JAX module, where flax
    freezes the dict into a ``FrozenDict`` that its ``isinstance(self.loss,
    dict)`` (``editors.py:438-439``) never passes, so its ``METRICS`` branch
    (``:587-590``) is never taken. As in the JAX module, with ``use_log_for_scale``
    the projected scale is exponentiated twice (``editors.py:502-507``) and
    ``get_params`` takes one log; without ``learn_var`` the scale is ones
    before the exponentials. ``seed`` fixes the initial weights."""

    def __init__(self, encoder: dict, decomposer: dict, diffusion: dict, sampler: dict,
                 num_anchors: int, num_timesteps: int, npoints: int = 2048,
                 anchor_loss_weight: float = 1.0, anchor_weight_annealing: bool = False,
                 annealing_epoch: int = 500, loss: Optional[dict] = None,
                 include_attn_weight_in_encoder: bool = True, guidance: bool = False,
                 part_latent_dropout_prob: float = 0.2, global_latent_dropout_prob: float = 0.2,
                 use_primary: bool = False, use_zero_anchor: bool = False,
                 use_global_anchor: bool = False, use_gt_anchors: bool = False,
                 project_latent: bool = False, project_pe_type: int = 0, post_ff: bool = False,
                 post_norm: Optional[str] = "gn", post_dp: float = 0.2,
                 use_log_for_scale: bool = True, share_projection: bool = True,
                 learn_var: bool = False, detach_anchor: bool = False,
                 detach_variance: bool = True, part_dim: int = 256, global_shift: bool = False,
                 global_scale: bool = False, vertical_only: bool = True,
                 normal_diffusion: bool = False, sample_by_seg_mask: bool = False,
                 forward_sample: bool = False, ret_traj: bool = False, ret_interval: int = 20,
                 *, dtype=None, device="cuda", seed: int = 0):
        super().__init__()
        kw = _kw(dtype, device, seed)
        self.anchor_loss_weight, self.anchor_weight_annealing = (anchor_loss_weight,
                                                                 anchor_weight_annealing)
        self.annealing_epoch = annealing_epoch
        self.include_attn_weight_in_encoder = include_attn_weight_in_encoder
        self.guidance = guidance
        self.part_latent_dropout_prob = part_latent_dropout_prob
        self.global_latent_dropout_prob = global_latent_dropout_prob
        self.use_primary, self.use_zero_anchor = use_primary, use_zero_anchor
        self.use_global_anchor, self.use_gt_anchors = use_global_anchor, use_gt_anchors
        self.project_latent, self.use_log_for_scale = project_latent, use_log_for_scale
        self.learn_var, self.detach_anchor = learn_var, detach_anchor
        self.detach_variance, self.part_dim = detach_variance, part_dim
        self.global_shift, self.global_scale = global_shift, global_scale
        self.vertical_only, self.normal_diffusion = vertical_only, normal_diffusion
        self.sample_by_seg_mask = sample_by_seg_mask
        self.encoder_mod = build_from_cfg(dict(encoder), ENCODERS, num_anchors=num_anchors, **kw)
        latent_dim = dict(encoder).get("part_latent_dim", part_dim)
        self._build_chain(dict(encoder, part_latent_dim=latent_dim), decomposer, diffusion,
                          sampler, num_anchors, num_timesteps, npoints, ret_traj, ret_interval,
                          forward_sample, False, kw, fixed_variance=False)
        self.anchor_loss_cfg = dict(loss) if isinstance(loss, dict) else None
        if project_latent:
            self.projection = _LatentProjection(
                part_dim, 6 if learn_var else 3, num_anchors, project_pe_type, share_projection,
                post_ff, post_norm, post_dp, **kw)

    # ------------------------------------------------------------- encoding
    def get_primary_latent(self, batch, train: bool = False):
        """The encoder's part latents (B, K, C) of the cloud, with its part
        maps where ``include_attn_weight_in_encoder``."""
        x = batch["input"]
        if self.include_attn_weight_in_encoder:
            x = torch.cat([x, batch["attn_map"].to(x.dtype)], dim=-1)
        return _code(self.encoder_mod(x, train=train))

    def project_primary_latent(self, latent, ref=None, train: bool = False, fix_shift=None,
                               fix_scale=None, shift_uniform=None, scale_uniform=None,
                               generator=None, dropout_generator=None, keep=None):
        """(latent, corrected anchors, scale, ref) (``editors.py:465-507``):
        in training with ``global_shift`` (``global_scale``) a (B, 1, 3)
        uniform draw (``shift_uniform``, ``scale_uniform`` inject it, else
        ``generator``) shifts (scales) the parameters and ``ref`` alike;
        ``keep`` injects the post feed-forward's dropout mask."""
        B = latent.shape[0]
        intrinsic, extrinsic = self.projection.down(latent)
        if self.learn_var:
            shift, scale = extrinsic[..., :3], extrinsic[..., 3:]
        else:
            shift, scale = extrinsic, torch.ones_like(extrinsic)
        part_shifts = torch.zeros(B, 1, 3, dtype=latent.dtype, device=latent.device)
        part_scales = torch.ones(B, 1, 3, dtype=latent.dtype, device=latent.device)
        if train and self.global_shift:
            u = shift_uniform if shift_uniform is not None else _uniform(
                (B, 1, 3), generator, latent.device)
            rand_shift = u.to(latent.dtype) - 0.5
            if self.vertical_only:
                rand_shift = rand_shift * torch.tensor([0.0, 1.0, 0.0], dtype=latent.dtype,
                                                       device=latent.device)
            part_shifts = rand_shift
            ref = None if ref is None else ref + rand_shift
        if train and self.global_scale:
            u = scale_uniform if scale_uniform is not None else _uniform(
                (B, 1, 3), generator, latent.device)
            part_scales = u.to(latent.dtype) / 2 + 0.7
            ref = None if ref is None else ref * part_scales
        corrected_anchor = (shift + part_shifts) * part_scales
        corrected_scale = scale + torch.log(part_scales)
        if fix_shift is not None:
            corrected_anchor = torch.as_tensor(fix_shift, dtype=latent.dtype,
                                               device=latent.device).expand_as(corrected_anchor)
        if fix_scale is not None:
            corrected_scale = torch.as_tensor(fix_scale, dtype=latent.dtype,
                                              device=latent.device).expand_as(corrected_scale)
        params = (torch.cat([corrected_anchor, corrected_scale], dim=-1) if self.learn_var
                  else corrected_anchor)
        latent = self.projection.up(intrinsic, params, latent, train, dropout_generator, keep)
        corrected_scale = (torch.exp(corrected_scale) if self.use_log_for_scale
                           else torch.relu(corrected_scale))
        return latent, corrected_anchor, torch.exp(corrected_scale), ref

    def get_params(self, batch):
        """(shift, log scale) of the projection (``editors.py:509-513``)."""
        _, shift, scale, _ = self.project_primary_latent(self.get_primary_latent(batch))
        return shift, torch.log(scale)

    def _encode_decompose(self, batch, train: bool = False, rngs=None):
        """(global code, anchors, part latents, variances or None, ref)
        (``editors.py:515-537``)."""
        rngs = rngs or {}
        ref = batch["ref"]
        primary = self.get_primary_latent(batch, train=train)
        corrected_anchor = corrected_scale = None
        if self.project_latent:
            primary, corrected_anchor, corrected_scale, ref = self.project_primary_latent(
                primary, ref=ref, train=train, shift_uniform=batch.get("global_shift_uniform"),
                scale_uniform=batch.get("global_scale_uniform"), generator=rngs.get("sample"),
                dropout_generator=rngs.get("dropout"), keep=batch.get("projection_keep"))
        global_feature, anchors, secondary = self.decomposer_mod(primary, train=train)
        part_latent = primary if self.use_primary else secondary
        variances = None
        if self.project_latent:
            anchors = corrected_anchor
            if self.learn_var:
                variances = corrected_scale
        if self.use_zero_anchor:
            anchors = torch.zeros_like(anchors)
        if self.use_global_anchor:
            anchors = batch["global_anchor_mean"]
        if self.use_gt_anchors:
            anchors = batch["part_means"][..., 1:]
        return global_feature, anchors, part_latent, variances, ref

    # ----------------------------------------------------------------- loss
    def loss(self, batch, epoch=0, train: bool = True, rngs=None) -> Dict[str, torch.Tensor]:
        """``anchor_loss`` and the chain's losses (``editors.py:548-607``).
        ``rngs`` holds the "sample" and "dropout" generators; the batch may
        inject ``global_shift_uniform``, ``global_scale_uniform``,
        ``projection_keep`` (B, K, part_dim), ``part_keep`` (B, K),
        ``global_keep`` (B,), ``diffusion_t`` and ``diffusion_noise``."""
        rngs = rngs or {}
        sample = rngs.get("sample")
        seg_mask = batch["seg_mask"].int()
        B, dev = batch["input"].shape[0], batch["input"].device
        global_feature, anchors, part_latent, variances, ref = self._encode_decompose(
            batch, train=True, rngs=rngs)
        if self.guidance:
            keep = batch.get("part_keep")
            if keep is None:
                keep = (_uniform(part_latent.shape[:-1], sample, dev)
                        >= self.part_latent_dropout_prob)
            part_latent = part_latent * keep[..., None].to(part_latent.dtype)
            gkeep = batch.get("global_keep")
            if gkeep is None:
                gkeep = _uniform((B,), sample, dev) >= self.global_latent_dropout_prob
            global_feature = global_feature * gkeep[:, None].to(global_feature.dtype)
        t = batch.get("diffusion_t")
        if t is None:
            t, _ = self.t_sampler.sample(sample, B, device=dev)
        latent_pp = gather_per_point(part_latent, seg_mask)
        anchor_pp = gather_per_point(anchors, seg_mask)
        var_pp = gather_per_point(variances, seg_mask) if variances is not None else None

        if self.anchor_weight_annealing:
            w = 1.0 / self.annealing_epoch * min(epoch, self.annealing_epoch)
        elif self.use_zero_anchor or self.use_global_anchor or self.use_gt_anchors:
            w = 0.0
        else:
            w = self.anchor_loss_weight
        losses = {"anchor_loss": w * ((anchor_pp - ref) ** 2).sum(-1).mean()}

        if self.normal_diffusion:
            anchor_pp = anchor_pp * 0
            var_pp = None if var_pp is None else torch.ones_like(var_pp)
        if self.detach_anchor:
            anchor_pp = anchor_pp.detach()
        if self.detach_variance and var_pp is not None:
            var_pp = var_pp.detach()
        losses.update(self.diff.training_losses(
            self._model_fn(latent_pp, global_feature, True, rngs.get("dropout")), ref, t.long(),
            anchors=anchor_pp, variance=var_pp, seg_mask=seg_mask,
            noise=batch.get("diffusion_noise"), generator=sample))
        return losses

    # ------------------------------------------------------------- decoding
    def _split(self, rows, device):
        """The equal split of ``npoints`` over the K parts, (rows, npoints)."""
        seg = torch.arange(self.num_anchors, dtype=torch.int32, device=device)
        return seg.repeat_interleave(self.points_per_anchor)[None].expand(rows, self.npoints)

    def _chain(self, anchor_pp, code, latent_pp, variance, generator, noise, step_noise,
               traj=False):
        return self.diff.p_sample_loop(
            self._model_fn(latent_pp, code), anchor_pp, variance=variance,
            ret_traj=traj and self.ret_traj, ret_interval=self.ret_interval, noise=noise,
            step_noise=step_noise, generator=generator)

    @torch.inference_mode()
    def predict(self, batch, generator: Optional[torch.Generator] = None, noise=None,
                step_noise=None) -> Dict[str, torch.Tensor]:
        """The reverse chain of the encoded shapes (``editors.py:609-657``):
        the anchors and latents on the points by the batch's seg mask
        (``sample_by_seg_mask``, each label repeated npoints / N times) or
        an equal split; with ``forward_sample`` the forward chain of ``ref``.
        ``noise`` and ``step_noise`` inject the draws."""
        B = batch["input"].shape[0]
        global_feature, anchors, part_latent, variances, ref = self._encode_decompose(batch)
        if self.sample_by_seg_mask:
            seg = batch["seg_mask"].int()
            assignments = seg.repeat_interleave(self.npoints // seg.shape[1], dim=1)
        else:
            assignments = self._split(B, anchors.device)
        anchor_pp = gather_per_point(anchors, assignments)
        latent_pp = gather_per_point(part_latent, assignments)
        var_pp = gather_per_point(variances, assignments) if variances is not None else None
        if self.normal_diffusion:
            anchor_pp = anchor_pp * 0
            var_pp = None if var_pp is None else torch.ones_like(var_pp)
        if self.forward_sample:
            out = {"pred": ref, "traj": self.diff.q_sample_loop(ref, anchor_pp, noise=noise,
                                                                generator=generator)}
        else:
            out = self._chain(anchor_pp, global_feature, latent_pp, var_pp, generator, noise,
                              step_noise, traj=True)
        out.update(input=batch["input"], input_ref=ref, anchors=anchors, seg_mask=assignments,
                   seg_mask_ref=batch["seg_mask"], assigned_anchor=anchor_pp)
        return out

    @torch.inference_mode()
    def combine_latent(self, batch, ids, generator: Optional[torch.Generator] = None, noise=None,
                       step_noise=None) -> Dict[str, torch.Tensor]:
        """One shape whose part i's primary latent is shape ids[i]'s
        (``editors.py:659-702``), each donor keeping its projected shift and
        scale, decoded on an equal split."""
        idx = torch.as_tensor(list(ids), device=batch["input"].device)
        primary = self.get_primary_latent({k: batch[k][idx] for k in ("input", "attn_map")})
        mixed = torch.stack([primary[i, i] for i in range(self.num_anchors)])[None]
        variances = proj_anchors = None
        if self.project_latent:
            mixed, proj_anchors, scale, _ = self.project_primary_latent(mixed)
            if self.learn_var:
                variances = scale
        global_feature, dec_anchors, secondary = self.decomposer_mod(mixed, train=False)
        part_latent = mixed if self.use_primary else secondary
        anchors = proj_anchors if self.project_latent else dec_anchors
        if self.use_zero_anchor:
            anchors = torch.zeros_like(anchors)
        assignments = self._split(1, anchors.device)
        var_pp = gather_per_point(variances, assignments) if variances is not None else None
        out = self._chain(gather_per_point(anchors, assignments), global_feature,
                          gather_per_point(part_latent, assignments), var_pp, generator, noise,
                          step_noise)
        out.update(anchors=anchors, seg_mask=assignments)
        return out

    @torch.inference_mode()
    def anchor_drift(self, batch, n_drift: int = 10, max_scale: float = 2.0,
                     generator: Optional[torch.Generator] = None, direction=None, noise=None,
                     step_noise=None) -> Dict[str, torch.Tensor]:
        """Each shape's anchors moved along random directions at ``n_drift``
        magnitudes in [0, max_scale], re-embedded and decoded
        (``editors.py:704-747``). ``direction`` (B, n_drift, K, 1) injects
        the normal draw (normalised over its last axis, as the JAX module
        does)."""
        if not self.project_latent:
            raise ValueError("anchor_drift needs the latent projection (project_latent=True)")
        seg = batch["seg_mask"].int()
        B, K = batch["input"].shape[0], self.num_anchors
        primary = self.get_primary_latent(batch)
        intrinsic, extrinsic = self.projection.down(primary)
        anchors = extrinsic[..., :3]
        if direction is None:
            direction = randn((B, n_drift, K, 1), generator, primary.device)
        direction = direction.to(primary.dtype)
        direction = direction / torch.linalg.norm(direction, dim=-1, keepdim=True)
        scales = torch.linspace(0.0, max_scale, n_drift, dtype=primary.dtype,
                                device=primary.device).reshape(1, -1, 1, 1)
        shifted = (direction * scales + anchors[:, None]).reshape(B * n_drift, K, 3)
        intr = intrinsic.repeat_interleave(n_drift, dim=0)
        lat = primary.repeat_interleave(n_drift, dim=0)
        params = torch.cat([shifted, torch.zeros_like(shifted)], -1) if self.learn_var else shifted
        lat = self.projection.up(intr, params, lat)
        global_feature, _, part_latent = self.decomposer_mod(lat, train=False)
        if self.use_primary:
            part_latent = lat
        assignments = seg.repeat_interleave(n_drift, dim=0).repeat_interleave(
            self.npoints // seg.shape[1], dim=1)
        out = self._chain(gather_per_point(shifted, assignments), global_feature,
                          gather_per_point(part_latent, assignments), None, generator, noise,
                          step_noise)
        return {"pred": out["pred"].reshape(B, n_drift, self.npoints, 3),
                "anchors": shifted.reshape(B, n_drift, K, 3), "input": batch["input"],
                "seg_mask": seg}

    @torch.inference_mode()
    def interpolate_latent(self, batch, id1: int, id2: int, anchor_id: int, steps: int = 10,
                           generator: Optional[torch.Generator] = None, noise=None,
                           step_noise=None) -> Dict[str, torch.Tensor]:
        """Part ``anchor_id``'s latent moved from shape id1's to id2's in
        ``steps`` equal steps, the rest id1's (``editors.py:749-781``). Of
        the batch, the entries whose leading axis is the batch's are kept
        (rows id1 and id2); others are dropped."""
        B = batch["input"].shape[0]
        idx = torch.as_tensor([id1, id2], device=batch["input"].device)
        sub = {k: v[idx] for k, v in batch.items()
               if torch.is_tensor(v) and v.ndim > 0 and v.shape[0] == B}
        global_feature, anchors, part_latent, _, _ = self._encode_decompose(sub)
        w = torch.linspace(0.0, 1.0, steps, dtype=part_latent.dtype,
                           device=part_latent.device)[:, None]
        lat = part_latent[:1].repeat(steps, 1, 1)
        lat[:, anchor_id] = part_latent[0, anchor_id] * (1 - w) + part_latent[1, anchor_id] * w
        assignments = self._split(steps, anchors.device)
        out = self._chain(gather_per_point(anchors[:1].repeat(steps, 1, 1), assignments),
                          global_feature[:1].repeat(steps, 1), gather_per_point(lat, assignments),
                          None, generator, noise, step_noise)
        out["seg_mask"] = assignments
        return out


@MODELS.register_module()
class Aligner(nn.Module):
    """The standalone parameter regressor (``editors.py:784-842``): the
    encoder's codes, reshaped to (B, n_class, C), through an MLP of widths
    512, 512, 512, 512, 64, 6 give each part's mean and logvar. C is the
    encoder config's ``zdim`` (else ``part_latent_dim``), which flax infers
    from the codes. ``seed`` fixes the initial weights."""

    def __init__(self, encoder: dict, n_class: int = 4, *, dtype=None, device="cuda",
                 seed: int = 0):
        super().__init__()
        kw = _kw(dtype, device, seed)
        self.n_class = n_class
        enc = dict(encoder)
        width = enc.get("zdim", enc.get("part_latent_dim"))
        if width is None:
            raise ValueError("the Aligner's encoder config names no zdim or part_latent_dim: "
                             "the regressor's input width")
        self.encoder_mod = build_from_cfg(enc, ENCODERS, num_anchors=n_class, **kw)
        self.regressor = MLP(int(width), (512, 512, 512, 512, 64, 6), **kw)

    def regress(self, batch, train: bool = False):
        """(params (B, K, 6), each shape's fit loss (B,))."""
        ref = batch["ref"]
        seg_mask = batch["ref_seg_mask"].int()
        valid_id = batch["present"]
        B = ref.shape[0]
        codes = _code(self.encoder_mod(torch.cat([ref, batch["ref_attn_map"].to(ref.dtype)],
                                                 dim=-1), train=train))
        params = self.regressor(codes.reshape(B, self.n_class, -1))
        mean, logvar = params[..., :3], params[..., 3:]
        mean_pp = gather_per_point(mean, seg_mask)
        logvar_pp = gather_per_point(logvar, seg_mask)
        flag_pp = gather_per_point(valid_id[..., None].to(ref.dtype), seg_mask)[..., 0]
        ll = -gaussian_log_likelihood(ref, mean_pp, logvar_pp).mean(-1)
        return params, (ll * flag_pp).sum(-1) / flag_pp.sum(-1)

    def predict_params(self, batch) -> Dict[str, torch.Tensor]:
        """The eval branch: each part's mean and logvar and each shape's fit
        loss, keyed as the reference's result."""
        params, fit = self.regress(batch, train=False)
        return {"index": batch.get("id"), "mean": params[..., :3], "logvar": params[..., 3:],
                "loss": fit}

    def loss(self, batch, epoch=0, train: bool = True, rngs=None) -> Dict[str, torch.Tensor]:
        return {"fit_loss": self.regress(batch, train=True)[1].mean()}


@MODELS.register_module()
class PartglotFinetune(nn.Module):
    """The loss of the editor (a ``MODELS`` config) it builds
    (``editors.py:845-858``). ``seed`` fixes the initial weights."""

    def __init__(self, editor: dict, num_part: int = 4, *, dtype=None, device="cuda",
                 seed: int = 0):
        super().__init__()
        self.num_part = num_part
        self.editor_mod = build_from_cfg(dict(editor), MODELS, dtype=dtype, device=device,
                                         seed=seed)

    def loss(self, batch, epoch=0, train: bool = True, rngs=None) -> Dict[str, torch.Tensor]:
        return self.editor_mod.loss(batch, epoch, train, rngs=rngs)
