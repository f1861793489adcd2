"""AnchorDiffAE: the training loss, and the generation entry points.

Port of ``difffacto_tpu/models/anchor_diff.py``: ``loss`` (the whole training
forward: encoder, prior and fit losses, q_sample, denoiser, mse),
``prepare_generation`` (flow prior -> CIMLE aligner -> per-point params and
ctx), ``decode`` (the reverse chain), ``sample_generation`` (both,
unconditional generation; reference anchor_gen.py:1034-1084), ``reconstruct``
(encode a shape and decode it again; anchor_gen.py:1085-1128), the editing
helpers (``encode_part_code``, ``latents_to_decode``, ``edit_losses``,
``recon_losses``), ``select_best_noise`` (the CIMLE best-of-N noise
selection) and, with ``pretrain_prior``, per-part pretraining
(``pretrain_loss``, ``pretrain_sample``). Every random draw comes from an
explicit ``torch.Generator`` or is injected: ``z`` (flow-prior latents),
``cimle_noise`` (aligner noise), ``noise`` (x_T; ``x_T`` in ``reconstruct``,
whose ``noise`` is the aligner's, as in the JAX package) and ``step_noise``
(per-step draws); in training and
reconstruction ``diffusion_t``, ``diffusion_noise``, ``noise`` and
``part_code_eps`` through the batch.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..parallel.axes import fold_generator
from ..parallel.mesh import all_gather_cat
from ..utils import trace
from ..utils.device import randn, resolve_device
from ..utils.gaussian import reparameterize_gaussian
from ..utils.registry import DIFFUSIONS, ENCODERS, MODELS, NETS, SAMPLERS, build_from_cfg
from . import samplers  # noqa: F401  (registers Uniform)
from .diffusion import AnchoredDiffusion
from .part_encoder import equal_split_seg_mask, gather_per_point


def ensure_attn_maps(batch):
    """Rebuild the one-hot part maps on the device from integer seg masks
    (``anchor_diff.py:39-63``): no-op where the maps are present; int masks
    become int32 either way."""
    if "seg_mask" not in batch and "ref_seg_mask" not in batch:
        return batch
    out = dict(batch)
    K = out["present"].shape[-1] if "present" in out else None
    for mask_key, map_key in (("seg_mask", "attn_map"), ("ref_seg_mask", "ref_attn_map")):
        m = out.get(mask_key)
        if m is None:
            continue
        if m.dtype != torch.int32:
            out[mask_key] = m = m.to(torch.int32)
        if map_key not in out and K is not None:
            out[map_key] = torch.nn.functional.one_hot(m.long(), K).to(torch.float32)
    return out


def build_diffusion(diffusion_cfg: dict, num_timesteps: int) -> AnchoredDiffusion:
    cfg = dict(diffusion_cfg)
    cfg.pop("net", None)
    cfg.setdefault("type", "AnchoredDiffusion")
    cfg["num_timesteps"] = num_timesteps
    return build_from_cfg(cfg, DIFFUSIONS)


@MODELS.register_module()
class AnchorDiffAE(nn.Module):
    """Constructor arguments mirror the JAX module's fields, every one of them
    (``anchor_diff.py:83-111``). ``seed`` fixes the initial weights (drawn on
    the CPU, so they are the same on every device).

    ``learn_var`` and ``detach_variance`` are kept and read nowhere, as in
    the JAX ``AnchorDiffAE``. ``pretrain_prior`` builds one denoiser a part,
    ``net_list_<i>`` as the JAX module names them, ``net`` being the first.
    ``train_language`` adds the text encoder ``language_enc``
    (``language_encoder``, an ``LSTM`` by default) and ``update_mlp``, which
    ``language_train_step`` (weighted by ``clip_weight``, ``triplet_weight``
    and ``triplet_thresh``) and ``language_edit_latents`` use.
    """

    def __init__(self, encoder: dict, diffusion: dict, num_anchors: int, num_timesteps: int,
                 sampler: Optional[dict] = None, npoints: int = 2048, zero_anchors: bool = False,
                 gen: bool = False, sample_noise_num: int = 20, cimle: bool = False,
                 cimle_sample_num: int = 10, diffusion_loss_weight: float = 1.0,
                 use_input: bool = False, learn_var: bool = False, detach_variance: bool = True,
                 detach_anchor: bool = True, ret_traj: bool = False, ret_interval: int = 20,
                 interpolate_part_id: int = 2, fix_part_ids: Optional[tuple] = None,
                 noise_reg_loss: bool = True, reg_loss_weight: float = 1.0,
                 pretrain_prior: bool = False, train_language: bool = False,
                 language_encoder: Optional[dict] = None, clip_weight: float = 1.0,
                 triplet_weight: float = 1.0, triplet_thresh: float = 0.1,
                 *, dtype=None, device="cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        self.num_anchors, self.num_timesteps, self.npoints = num_anchors, num_timesteps, npoints
        self.cimle_sample_num, self.ret_traj = cimle_sample_num, ret_traj
        self.ret_interval = ret_interval
        self.zero_anchors, self.gen, self.cimle = zero_anchors, gen, cimle
        self.sample_noise_num, self.diffusion_loss_weight = sample_noise_num, diffusion_loss_weight
        self.use_input, self.detach_anchor = use_input, detach_anchor
        self.learn_var, self.detach_variance = learn_var, detach_variance
        self.interpolate_part_id = interpolate_part_id
        self.fix_part_ids = tuple(fix_part_ids) if fix_part_ids else None
        self.noise_reg_loss, self.reg_loss_weight = noise_reg_loss, reg_loss_weight
        self.clip_weight, self.triplet_weight = clip_weight, triplet_weight
        self.triplet_thresh = triplet_thresh
        self.encoder, self.diffusion = dict(encoder), dict(diffusion)
        kw = dict(dtype=dtype, device=device, generator=g)
        self.encoder_mod = build_from_cfg(dict(encoder), ENCODERS, **kw)
        if pretrain_prior:
            # one denoiser a part (anchor_diff.py:116-123); the first is also
            # ``net``, and its parameters are named once, under net_list_0
            self.net_list = [build_from_cfg(dict(diffusion["net"]), NETS, **kw)
                             for _ in range(num_anchors)]
            for i, net in enumerate(self.net_list):
                self.add_module(f"net_list_{i}", net)
            self.net = self.net_list[0]
        else:
            self.net = build_from_cfg(dict(diffusion["net"]), NETS, **kw)
        self.diff = build_diffusion(diffusion, num_timesteps)
        self.t_sampler = build_from_cfg(dict(sampler or dict(type="Uniform")), SAMPLERS,
                                        num_timesteps=num_timesteps)
        self.train_language = train_language
        if train_language:
            # the text encoder and the zero-initialised update MLP
            # (anchor_diff.py:130-139); flax infers the MLP's input width
            from .language import ZeroMLP

            zdim = encoder["encoder"]["zdim"]
            self.language_enc = build_from_cfg(dict(language_encoder or dict(type="LSTM")),
                                               ENCODERS, **kw)
            self.update_mlp = ZeroMLP(self.language_enc.text_dim + zdim,
                                      [zdim * 2, zdim * 2, zdim], dtype=dtype, device=device)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def denoise(self, x, t, ctx, anchors, variances, seg_mask, valid_id, train: bool = False,
                generator=None):
        """One denoiser call: the body of every reverse step, and the training net."""
        return self.net(x, t, ctx, anchors, variances, seg_mask, valid_id, train=train,
                        generator=generator)

    def encode(self, batch, noise=None, epoch=-1, train: bool = False, rngs=None):
        """The encoder forward: (ctx, mean_pp, logvar_pp, flag_pp, losses, latents)."""
        return self.encoder_mod(batch, noise=noise, epoch=epoch, train=train, rngs=rngs)

    def sample_noise_candidates(self, batch, num=None, generator=None, noise=None):
        return self.encoder_mod.sample_noise_candidates(
            batch, self.sample_noise_num if num is None else num, generator=generator, noise=noise)

    def loss(self, batch, epoch=0, train: bool = True, rngs=None):
        """The full training loss (``anchor_diff.py:169-228``) as a dict.

        ``rngs`` holds the ``"sample"`` and ``"dropout"`` generators; the batch
        may inject ``diffusion_t``, ``diffusion_noise``, ``noise`` (the CIMLE
        latent) and ``part_code_eps``. ``train=False`` runs the same loss with
        the running BatchNorm statistics and no dropout.
        """
        rngs = rngs or {}
        ref = batch["ref"]
        seg_mask = batch["ref_seg_mask"].int()
        dp_valid_id = batch.get("dp_present")
        B = ref.shape[0]

        ctx, mean_pp, logvar_pp, _, loss_dict, _ = self.encoder_mod(
            batch, epoch=epoch, train=train, rngs=rngs)
        if self.zero_anchors:
            mean_pp = torch.zeros_like(mean_pp)
        # The variance is taken before the anchor is detached and keeps its
        # gradient; only the anchor is detached (a reference quirk, kept).
        variance_pp = torch.exp(logvar_pp)
        if self.detach_anchor:
            mean_pp = mean_pp.detach()

        t = batch.get("diffusion_t")
        if t is None:
            t, _ = self.t_sampler.sample(rngs.get("sample"), B, device=ref.device)
        dp_flags = None
        if dp_valid_id is not None:
            dp_flags = gather_per_point(dp_valid_id[..., None], seg_mask)[..., 0]

        def model_fn(inp, ts, c, anc, var, seg, vid):
            return self.denoise(inp, ts, c, anc, var, seg, vid, train=train,
                                generator=rngs.get("dropout"))

        x0 = batch["input"] if self.use_input else ref
        diff_losses = self.diff.training_losses(
            model_fn, x0, t.long(), anchors=mean_pp, variance=variance_pp, ctx=ctx,
            seg_mask=seg_mask, valid_id=dp_valid_id, flags=dp_flags,
            noise=batch.get("diffusion_noise"), generator=rngs.get("sample"))
        diff_losses["mse_loss"] = self.diffusion_loss_weight * diff_losses["mse_loss"]
        loss_dict.update(diff_losses)
        return loss_dict

    def prepare_generation(self, sample_num: int, fixed_id=None, valid_id=None, epoch: int = 0,
                           generator=None, z=None, cimle_noise=None):
        """Latents for unconditional generation (``anchor_diff.py:426-435``).

        Returns (ctx, mean_pp, variance_pp, seg_mask, valid_id, latents) with
        leading dim sample_num * cimle_sample_num.
        """
        ctx, mean_pp, logvar_pp, seg_mask, valid_id, latents = self.encoder_mod.sample_latents(
            sample_num, self.npoints, fixed_id=fixed_id, valid_id=valid_id, epoch=epoch,
            K=self.cimle_sample_num, generator=generator, z=z, cimle_noise=cimle_noise,
        )
        return ctx, mean_pp, torch.exp(logvar_pp), seg_mask, valid_id, latents

    def prepare_reconstruction(self, batch, noise=None, epoch: int = -1, rngs=None):
        """Latents for encode -> decode (``anchor_diff.py:437-453``): the
        encoder forward in eval mode. ``noise`` is the aligner noise, (B, D)
        or (B, K, D) for K hypotheses a shape. Returns (ctx, mean_pp,
        variance_pp, latents)."""
        ctx, mean_pp, logvar_pp, _, _, latents = self.encoder_mod(
            batch, noise=noise, epoch=epoch, train=False, rngs=rngs)
        return ctx, mean_pp, torch.exp(logvar_pp), latents

    # ------------------------------------------------------- editing helpers
    def encode_part_code(self, x, seg_flag, sample: bool = False, generator=None, eps=None):
        """Per-part latent codes of a (possibly mixed) cloud, (B, N, 3) and
        (B, N, K) -> (B, K, zdim) (``anchor_diff.py:231-239``): the posterior
        means, or with ``sample`` (and a ``gen`` encoder) a draw from the
        posterior; ``eps`` (B, K, zdim) injects its standard normal."""
        means, logvars = self.encoder_mod.get_part_code(x, seg_flag, train=False)
        if sample and self.encoder_mod.gen:
            return reparameterize_gaussian(means, logvars, generator, eps)
        return means

    def latents_to_decode(self, part_code, valid_id, noise=None, seg_mask=None):
        """Aligner, per-point gather and ctx from explicit part codes
        (``anchor_diff.py:241-259``). Without ``seg_mask`` the points split
        equally over the parts, an absent part's share going to the first
        present one. Returns (ctx, mean_pp, variance_pp, seg_mask, (mean,
        logvar))."""
        enc = self.encoder_mod
        mean, logvar = enc.get_params_from_part_code(part_code, valid_id, noise=noise)
        if seg_mask is None:
            seg_mask = equal_split_seg_mask(valid_id.to(part_code.dtype), self.npoints)
        lv = logvar + enc.log_scale_var if logvar is not None else logvar
        mean_pp, logvar_pp, _ = enc.gather_all(seg_mask, anchors=mean, variances=lv)
        ctx = enc.prepare_ctx(part_code, mean, logvar, seg_mask=seg_mask)
        return ctx, mean_pp, torch.exp(logvar_pp), seg_mask, (mean, logvar)

    def edit_losses(self, z, x, seg_flag, valid_id, ref_means, ref_vars, fix_ids, edit_part_id,
                    edit_part_mean=None, edit_part_var=None, fit_weight: float = 1.0):
        """Noise-optimisation losses of shape editing (``anchor_diff.py:261-296``):
        the fixed parts' parameters held near the reference, the edited part
        pulled to its target, the noise L2-regularised."""
        enc = self.encoder_mod
        means, _ = enc.get_part_code(x, seg_flag, train=False)
        mean, logvar = enc.get_params_from_part_code(means, valid_id, noise=z)
        fit = (torch.cat([mean, logvar], -1)
               - torch.cat([ref_means, torch.log(ref_vars)], -1)) ** 2
        w = valid_id * fix_ids
        fit = (fit * w[..., None]).sum(dim=(-1, -2)) / w.sum(-1)
        out = {"fit_loss": fit_weight * fit}
        edit = torch.zeros((), dtype=mean.dtype, device=mean.device)
        if edit_part_mean is not None:
            edit = edit + ((mean[:, edit_part_id] - edit_part_mean) ** 2).mean()
        if edit_part_var is not None:
            edit = edit + ((logvar[:, edit_part_id] - torch.log(edit_part_var)) ** 2).mean()
        out["edit_loss"] = edit
        if self.noise_reg_loss:
            out["reg_loss"] = self.reg_loss_weight * (z**2).sum(-1)
        return out

    def recon_losses(self, batch, z, rngs=None):
        """Fit losses for the CIMLE noise optimisation (``anchor_diff.py:298-304``):
        the encoder forward's losses with aligner noise ``z``, plus the noise's
        L2 penalty. The part-code draw of a ``gen`` encoder comes from
        ``rngs["sample"]`` or ``batch["part_code_eps"]``."""
        _, _, _, _, loss_dict, _ = self.encoder_mod(batch, noise=z, epoch=-1, train=False,
                                                    rngs=rngs)
        if self.noise_reg_loss:
            loss_dict["reg_loss"] = self.reg_loss_weight * (z**2).sum(-1)
        return loss_dict

    # ------------------------------------------------------------ pretraining
    def pretrain_loss(self, part_inputs, valid=None, rngs=None, part_code_eps=None, t=None,
                      noise=None):
        """Per-part diffusion pretraining (``anchor_diff.py:306-344``): the
        part codes of part_inputs (B, K, Np, 3), each part's cloud normalised,
        their prior loss, and the mse of each part's own denoiser conditioned
        on that part's code, averaged over the parts. ``rngs`` holds the
        "sample" and "dropout" generators; ``part_code_eps`` (B, K, zdim), ``t``
        (K, B) and ``noise`` (K, B, Np, 3) inject the draws."""
        rngs = rngs or {}
        gen = rngs.get("sample")
        B, K, Np, _ = part_inputs.shape
        flat = part_inputs.reshape(B, K * Np, 3)
        eye = torch.eye(K, dtype=flat.dtype, device=flat.device)
        seg_flag = eye.repeat_interleave(Np, dim=0)[None].expand(B, -1, -1)
        enc = self.encoder_mod
        means, logvars = enc.get_part_code(flat, seg_flag, train=True)
        part_code = reparameterize_gaussian(means, logvars, gen, part_code_eps)
        if valid is None:
            valid = torch.ones(B, K, dtype=flat.dtype, device=flat.device)
        loss_dict = dict(enc.get_prior_loss(part_code, means, logvars, valid))
        zeros = torch.zeros(B, Np, 3, dtype=flat.dtype, device=flat.device)
        mse = 0.0
        for i in range(K):
            ti = t[i] if t is not None else self.t_sampler.sample(gen, B, device=flat.device)[0]

            def model_fn(inp, ts, c, anc, var, seg, vid, net=self.net_list[i]):
                return net(inp, ts, c, anc, var, seg, vid, train=True,
                           generator=rngs.get("dropout"))

            dl = self.diff.training_losses(
                model_fn, part_inputs[:, i], ti.long(), anchors=zeros,
                variance=torch.ones_like(zeros) if self.diff.learn_variance else None,
                ctx=part_code[:, i:i + 1],
                seg_mask=torch.zeros(B, Np, dtype=torch.int32, device=flat.device),
                noise=None if noise is None else noise[i], generator=gen)
            mse = mse + dl["mse_loss"]
        loss_dict["mse_loss"] = mse / K
        return loss_dict

    @torch.inference_mode()
    def pretrain_sample(self, sample_num: int, num_points: int, generator=None, codes=None,
                        noise=None, step_noise=None):
        """Each part's pretrained diffusion sampled on its own
        (``anchor_diff.py:346-370``): a list of K (S, Np, 3). ``codes`` (S, K,
        zdim), ``noise`` (K, S, Np, 3) and ``step_noise`` (K, T, S, Np, 3)
        inject the draws."""
        device = self.device
        if codes is None:
            codes = randn((sample_num, self.num_anchors, self.encoder["encoder"]["zdim"]),
                          generator, device)
        seg = torch.zeros(sample_num, num_points, dtype=torch.int32, device=device)
        outs = []
        for i, net in enumerate(self.net_list):
            out = self.diff.p_sample_loop(
                net, torch.zeros(sample_num, num_points, 3, device=device),
                ctx=codes[:, i:i + 1], seg_mask=seg,
                noise=None if noise is None else noise[i],
                step_noise=None if step_noise is None else step_noise[i], generator=generator)
            outs.append(out["pred"])
        return outs

    # ------------------------------------------------------------- language
    def language_train_step(self, batch, rngs=None):
        """The contrastive language-editing losses (``anchor_diff.py:373-415``).

        batch: input (B, 3, N, 3) triplets (target, to edit, distractor),
        attn_map (B, 3, N, K), part_indicator (B, K), text (B, L) tokens.
        ``rngs`` holds the "sample" generator (the part codes' draw) and the
        "dropout" one (the text encoder's); the batch may inject
        ``part_code_eps`` (B * 3, K, zdim) and ``text_keep``, the text
        encoder's dropout keep mask."""
        from .language import clip_style_loss, triplet_loss

        rngs = rngs or {}
        x, attn = batch["input"], batch["attn_map"]
        B, _, N, _ = x.shape
        K = self.num_anchors
        text_feat, _ = self.language_enc(batch["text"], train=True, generator=rngs.get("dropout"),
                                         keep=batch.get("text_keep"))
        means, logvars = self.encoder_mod.get_part_code(
            x.reshape(B * 3, N, 3), attn.reshape(B * 3, N, K).to(x.dtype), train=True)
        codes = means
        if self.encoder_mod.gen:
            codes = reparameterize_gaussian(means, logvars, rngs.get("sample"),
                                            batch.get("part_code_eps"))
        part_id = torch.argmax(batch["part_indicator"], dim=-1)
        ref_lat = codes.reshape(B, 3, K, -1)[torch.arange(B, device=x.device), :, part_id]
        tgt, to_edit, distractor = ref_lat[:, 0], ref_lat[:, 1], ref_lat[:, 2]
        modified = to_edit + self.update_mlp(torch.cat([text_feat, to_edit], dim=-1))
        clip_l, cos = clip_style_loss(modified, tgt, distractor)
        trip_l, pos_d, neg_d = triplet_loss(modified, tgt, distractor, self.triplet_thresh)
        return {
            "clip_loss": self.clip_weight * clip_l,
            "triplet_loss": self.triplet_weight * trip_l.mean(),
            "cos_sim_pos": cos[:, 0].mean(),
            "cos_sim_neg": cos[:, 1].mean(),
            "pos_diff": pos_d,
            "neg_diff": neg_d,
        }

    def language_edit_latents(self, part_code, text_tokens, part_id: int):
        """A text edit of one part's latent (``anchor_diff.py:417-423``):
        part_code (B, K, zdim) -> the codes with part ``part_id`` moved."""
        text_feat, _ = self.language_enc(text_tokens)
        selected = part_code[:, part_id]
        out = part_code.clone()
        out[:, part_id] = selected + self.update_mlp(torch.cat([text_feat, selected], dim=-1))
        return out


@torch.inference_mode()
def decode(model: AnchorDiffAE, anchors, ctx=None, variance=None, seg_mask=None, valid_id=None,
           noise=None, step_noise=None, generator: Optional[torch.Generator] = None,
           ret_traj: Optional[bool] = None, ret_interval: Optional[int] = None, mesh=None):
    """The reverse diffusion chain (``anchor_diff.py:486-597``) -> {'pred': (B, N, 3)},
    with 'traj' and 'traj_t' where ``ret_traj`` (default: the model's, every
    ``ret_interval``-th step). ``step_noise`` is (len(model.diff.steps), B, N,
    3): T draws for the full chain, ``ddim_nsteps`` with DDIM.

    With ``mesh`` (``parallel/mesh.py``), where the JAX package shards
    (no trajectory, B a multiple of the data axis and N of the points axis),
    each rank runs its batch slice, and under ("data", "points") its point
    slice, through the chain against the replicated context: a point token
    cross-attends only to the 4 context tokens, so a shard needs no
    collective. A per-point ctx (B, N, F), the base ``PartEncoder``'s, is
    cut on the batch axis only, as the JAX package's ``in_specs`` cut every
    ctx (``anchor_diff.py:558-563``): under a points axis its N rows meet
    the shard's N / points and the JAX denoiser fails to broadcast them, so
    the port raises there. Every rank passes the same inputs; the injected ``noise``
    and ``step_noise`` are cut to the rank's shard, the drawn ones come from
    ``generator`` folded by the rank where the mesh has more than one, and
    'pred' is gathered whole on every rank. Elsewhere every rank runs the
    whole chain, as one device does.
    """
    ret_traj = model.ret_traj if ret_traj is None else ret_traj
    ret_interval = model.ret_interval if ret_interval is None else ret_interval
    B, N = anchors.shape[:2]
    nd = mesh.shape[mesh.axis_names[0]] if mesh is not None else 1
    npts = mesh.axis_size("points") if mesh is not None else 1
    if mesh is None or ret_traj or B % nd or N % npts:
        return model.diff.p_sample_loop(
            model.denoise, anchors, ctx=ctx, variance=variance, seg_mask=seg_mask,
            valid_id=valid_id, noise=noise, ret_traj=ret_traj, ret_interval=ret_interval,
            step_noise=step_noise, generator=generator,
        )
    if npts > 1 and ctx is not None and ctx.ndim == 3 and ctx.shape[1] == N:
        raise ValueError(
            "a per-point ctx under a points axis: the JAX package shards ctx on the batch "
            "axis only (difffacto_tpu/models/anchor_diff.py:558-563), so each point shard "
            f"meets all {N} ctx rows and its denoiser cannot broadcast them; decode it "
            "under a data-only mesh")
    d = mesh.index(mesh.axis_names[0])
    p = mesh.index("points") if npts > 1 else 0
    rows = slice(d * B // nd, (d + 1) * B // nd)
    cols = slice(p * N // npts, (p + 1) * N // npts)
    shape = lambda x: None if x is None else x[rows]
    point = lambda x: None if x is None else x[rows, cols]
    if mesh.size > 1:
        generator = fold_generator(generator, mesh.index())
    pred = model.diff.p_sample_loop(
        model.denoise, point(anchors), ctx=shape(ctx), variance=point(variance),
        seg_mask=point(seg_mask), valid_id=shape(valid_id), noise=point(noise),
        ret_traj=False, step_noise=None if step_noise is None else step_noise[:, rows, cols],
        generator=generator,
    )["pred"]
    if npts > 1:
        pred = all_gather_cat(pred, mesh.groups["points"], dim=1)
    return {"pred": all_gather_cat(pred, mesh.groups[mesh.axis_names[0]], dim=0)}


@torch.inference_mode()
def sample_generation(model: AnchorDiffAE, sample_num: int, valid_id=None, fixed_id=None,
                      epoch: int = 0, ret_traj: bool = False,
                      generator: Optional[torch.Generator] = None, z=None, cimle_noise=None,
                      noise=None, step_noise=None, mesh=None):
    """Unconditional generation (``anchor_diff.py:600-651``): flow prior ->
    aligner (K CIMLE hypotheses) -> reverse chain. ``step_noise`` is
    (len(model.diff.steps), S*K, N, 3). Returns a dict with 'pred'
    (S*K, N, 3), 'seg_mask', 'valid_id', 'anchors', 'variance', 'latents'.
    With ``mesh`` every rank draws the same latents from the same
    ``generator`` and the chain is sharded as ``decode`` says.

    Recorded as the span ``sample_generation``, with the latents'
    ``prepare_generation`` as its child; the rest of it is the chain's
    enqueue (``utils/trace.py``)."""
    with trace.span("sample_generation"):
        if fixed_id is None:
            fixed_id = torch.zeros(model.num_anchors, device=model.device)
        with trace.span("prepare_generation"):
            ctx, mean_pp, var_pp, seg_mask, vid, latents = model.prepare_generation(
                sample_num, fixed_id, valid_id, epoch, generator=generator, z=z,
                cimle_noise=cimle_noise)
        out = decode(model, mean_pp, ctx=ctx, variance=var_pp, seg_mask=seg_mask, valid_id=vid,
                     noise=noise, step_noise=step_noise, generator=generator, ret_traj=ret_traj,
                     mesh=mesh)
    out.update(seg_mask=seg_mask, valid_id=vid, anchors=mean_pp, variance=var_pp, latents=latents)
    return out


@torch.inference_mode()
def reconstruct(model: AnchorDiffAE, batch, noise=None, epoch: int = -1, ret_traj: bool = False,
                generator: Optional[torch.Generator] = None, x_T=None, step_noise=None):
    """Encode and decode a batch of shapes (``anchor_diff.py:654-700``).

    ``noise`` is the aligner noise, (B, D) or (B, K, D): with K hypotheses a
    shape the seg masks and part flags repeat K times and 'pred' is
    (B * K, N, 3). The part-code draw of a ``gen`` encoder comes from
    ``generator`` or ``batch["part_code_eps"]``; ``x_T`` and ``step_noise``
    (len(model.diff.steps), B * K, N, 3) inject the chain's draws. Returns
    'pred', 'seg_mask', 'valid_id', 'anchors', 'latents' (and 'traj',
    'traj_t' with ``ret_traj``)."""
    batch = ensure_attn_maps(batch)
    ctx, mean_pp, var_pp, latents = model.prepare_reconstruction(
        batch, noise=noise, epoch=epoch, rngs={"sample": generator})
    seg_mask = batch["ref_seg_mask"].int()
    valid_id = batch.get("present")
    if noise is not None and noise.ndim == 3:
        K = noise.shape[1]
        seg_mask = seg_mask.repeat_interleave(K, dim=0)
        valid_id = valid_id.repeat_interleave(K, dim=0) if valid_id is not None else None
    out = decode(model, mean_pp, ctx=ctx, variance=var_pp, seg_mask=seg_mask, valid_id=valid_id,
                 noise=x_T, step_noise=step_noise, generator=generator, ret_traj=ret_traj)
    out.update(seg_mask=seg_mask, valid_id=valid_id, anchors=mean_pp, latents=latents)
    return out


@torch.no_grad()
def select_best_noise(model: AnchorDiffAE, batch, num: Optional[int] = None,
                      generator: Optional[torch.Generator] = None, noise=None):
    """CIMLE noise caching: the best of N candidates by fit loss
    (``anchor_diff.py:702-725``). ``noise`` (B * num, noise_dim) injects the
    candidates. Returns (noise (B, num, D), best_idx (B,), selected (B, D))."""
    cand, fit = model.sample_noise_candidates(ensure_attn_maps(batch), num, generator=generator,
                                              noise=noise)
    best = torch.argmin(fit, dim=1)
    selected = torch.gather(cand, 1, best[:, None, None].expand(-1, 1, cand.shape[-1]))[:, 0]
    return cand, best, selected
