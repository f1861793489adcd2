"""The secondary runners: per-part pretraining, the latent GAN, mixing, language.

The port of ``difffacto_tpu/runner/extra_runners.py`` (the reference's
pretrain_runner.py, gan_runner.py, mixing_runner.py and language_runner.py).
Each subclasses the ``Runner``'s config plumbing and replaces its step:

* ``PretrainRunner``: the model is built with ``pretrain_prior=True``, one
  denoiser a part, each trained on that part's cloud, normalised, and
  conditioned on that part's code (``AnchorDiffAE.pretrain_loss``); ``val``
  samples each part's diffusion on its own and writes
  ``val/pretrain_samples_<epoch>.npz``.
* ``GanRunner``: a latent GAN (``models/gan.py``) over the part codes of the
  frozen ``AnchorDiffAE`` encoder. ``save`` and ``val`` stay the
  ``Runner``'s: they write and evaluate the ``AnchorDiffAE``, not the
  generator, as in the JAX package.
* ``MixingRunner``: ``combine_latent`` over the val loader into
  ``work_dir/mixing/mixing.pkl``.
* ``LanguageRunner``: the model is built with ``train_language=True``; a
  step trains the text encoder and the update MLP alone
  (``AnchorDiffAE.language_train_step``).
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from ..models.anchor_diff import ensure_attn_maps
from ..models.gan import dis_loss, gen_loss, gradient_penalty
from ..parallel.optim import build_optimizer_from_cfg
from ..parallel.train import TrainState, parse_losses
from ..utils.registry import DISCRIMINATORS, GENERATORS, build_from_cfg
from .runner import Runner, cfgdict, check_interval, device_batch


def _split_parts(batch, n_class: int, pts_per_part: int, rng: np.random.RandomState):
    """Per-part normalised clouds (B, K, Np, 3) float32 from a dataset batch
    (``extra_runners.py:30-47``): for each shape and part, ``pts_per_part``
    of its points drawn with replacement by ``rng``, minus their mean, over
    their std clipped at 1e-2; an absent part stays zero."""
    ref = np.asarray(batch["ref"])
    seg = np.asarray(batch["ref_seg_mask"])
    B = ref.shape[0]
    out = np.zeros((B, n_class, pts_per_part, 3), np.float32)
    for b in range(B):
        for k in range(n_class):
            idx = np.nonzero(seg[b] == k)[0]
            if len(idx) == 0:
                continue
            sel = rng.choice(idx, pts_per_part, replace=True)
            part = ref[b, sel]
            m, s = part.mean(0), part.std(0).clip(1e-2, None)
            out[b, k] = (part - m) / s
    return out


def _apply_update(tx, params, grads, opt_state, paths=None):
    """One optimizer update of ``params`` in place; returns the new state."""
    with torch.no_grad():
        updates, opt_state = tx.update(grads, opt_state, params, paths)
        torch._foreach_add_(params, updates)
    return opt_state


def _step(tx, state: TrainState, losses, live=None):
    """The JAX runners' step from a loss dict: the gradient of the summed
    losses, zero where a parameter takes no part or ``live`` (a flag a
    parameter) is False, then ``tx``'s update of every parameter; no skip
    guard. Returns (new state, metrics)."""
    params = list(state.model.parameters())
    total, metrics = parse_losses(losses)
    grads = torch.autograd.grad(total, params, allow_unused=True)
    live = live or [True] * len(params)
    grads = [g if keep and g is not None else torch.zeros_like(p)
             for g, p, keep in zip(grads, params, live)]
    opt_state = _apply_update(tx, params, grads, state.opt_state, state.paths)
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["total_loss"] = total.detach()
    return TrainState(step=state.step + 1, model=state.model, opt_state=opt_state), metrics


class PretrainRunner(Runner):
    """Per-part diffusion pretraining (``extra_runners.py:50-131``). The step
    is the JAX one's: the gradient of the summed losses, the optimizer's
    update, no skip guard and no trainable filter; the part split's draws
    come from ``RandomState(seed)`` over the runner's life."""

    def __init__(self, args=None, cfg=None, device="cuda"):
        if cfg is not None and cfg.model is not None:
            cfg.model.pretrain_prior = True
        super().__init__(args=args, cfg=cfg, device=device)
        self.pts_per_part = int(self.cfg.pts_per_part or 512)
        self._np_rng = np.random.RandomState(self.seed)

    def pretrain_step(self, state, part_inputs, rngs, **inject):
        """One step on part_inputs (B, K, Np, 3): (new state, metrics).
        ``inject`` passes ``part_code_eps``, ``t`` and ``noise`` to
        ``pretrain_loss``."""
        return _step(self.tx, state, self.model.pretrain_loss(part_inputs, rngs=rngs, **inject))

    def train(self):
        gen = torch.Generator(device=self.device).manual_seed(self.seed + self.epoch)
        rngs = {"sample": gen, "dropout": gen}
        for batch in self.train_loader:
            parts = _split_parts(batch, self.model.num_anchors, self.pts_per_part, self._np_rng)
            parts = torch.from_numpy(parts).to(self.device)
            self.state, metrics = self.pretrain_step(self.state, parts, rngs)
            self.iter += 1
            if check_interval(self.iter, self.log_interval):
                values = torch.stack([v.float() for v in metrics.values()]).tolist()
                self.logger.log(dict(zip(metrics, values)), step=self.iter)
        self.epoch += 1

    def val(self):
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        outs = self.model.pretrain_sample(4, self.pts_per_part, generator=gen)
        out_dir = os.path.join(self.work_dir, "val")
        os.makedirs(out_dir, exist_ok=True)
        np.savez(os.path.join(out_dir, f"pretrain_samples_{self.epoch}.npz"),
                 **{f"part_{i}": o.float().cpu().numpy() for i, o in enumerate(outs)})
        return {}


class GanRunner(Runner):
    """A latent GAN over frozen encoder codes (``extra_runners.py:136-245``).

    ``cfg.generator`` and ``cfg.discriminator`` build the two nets (the JAX
    defaults where absent); flax infers the critic's input width from the
    generator's first output, and so does this runner, whatever the
    config's ``in_dim`` says. Adam with betas (0.5, 0.9) at ``g_lr`` and
    ``d_lr`` (1e-4), ``n_critic`` (5) critic steps a generator step,
    ``gan_loss_type`` ("wgan"), ``gp_weight`` (10) and ``gp_type``
    ("zero_center"). The nets' weights come from ``seed``.
    """

    def __init__(self, args=None, cfg=None, device="cuda"):
        super().__init__(args=args, cfg=cfg, device=device)
        cfg = self.cfg
        g = torch.Generator().manual_seed(self.seed)
        kw = dict(device=self.device, generator=g)
        self.generator = build_from_cfg(cfgdict(cfg.generator) or dict(type="Generator"),
                                        GENERATORS, **kw)
        with torch.no_grad():
            z0 = torch.zeros(self.generator.noise_shape(2), device=self.device)
            in_dim = self.generator(z0).reshape(2, -1).shape[1]
        self.discriminator = build_from_cfg(
            cfgdict(cfg.discriminator) or dict(type="Discriminator"), DISCRIMINATORS,
            in_dim=in_dim, **kw)
        self.gan_loss_type = cfg.gan_loss_type or "wgan"
        self.gp_weight = cfg.gp_weight if cfg.gp_weight is not None else 10.0
        self.gp_type = cfg.get("gp_type") or "zero_center"
        self.n_critic = cfg.n_critic or 5
        self.g_tx = build_optimizer_from_cfg(dict(type="Adam", lr=cfg.g_lr or 1e-4,
                                                  betas=(0.5, 0.9)))
        self.d_tx = build_optimizer_from_cfg(dict(type="Adam", lr=cfg.d_lr or 1e-4,
                                                  betas=(0.5, 0.9)))
        self.g_opt = self.g_tx.init(list(self.generator.parameters()))
        self.d_opt = self.d_tx.init(list(self.discriminator.parameters()))

    def d_step(self, real_codes, generator=None, z=None, gp_eps=None) -> torch.Tensor:
        """One critic step on ``real_codes`` (B, K, zdim) against the
        generator's codes of ``z`` (drawn from ``generator`` where not given);
        the interpolated penalty's uniform draw is ``gp_eps`` or from
        ``generator``. Returns the critic's loss."""
        G, D = self.generator, self.discriminator
        if z is None:
            z = G.sample_noise(real_codes.shape[0], generator)
        with torch.no_grad():
            fake = G(z)
        loss = dis_loss(D(real_codes), D(fake), self.gan_loss_type)
        if self.gan_loss_type == "wgan" and self.gp_weight > 0:
            loss = loss + gradient_penalty(D, generator, real_codes, fake, self.gp_weight,
                                           self.gp_type, eps=gp_eps)
        params = list(D.parameters())
        grads = torch.autograd.grad(loss, params)
        self.d_opt = _apply_update(self.d_tx, params, list(grads), self.d_opt)
        return loss.detach()

    def g_step(self, batch_size: int, generator=None, z=None) -> torch.Tensor:
        """One generator step against the current critic; returns its loss."""
        G = self.generator
        if z is None:
            z = G.sample_noise(batch_size, generator)
        loss = gen_loss(self.discriminator(G(z)), self.gan_loss_type)
        params = list(G.parameters())
        grads = torch.autograd.grad(loss, params)
        self.g_opt = _apply_update(self.g_tx, params, list(grads), self.g_opt)
        return loss.detach()

    @torch.no_grad()
    def real_codes(self, batch) -> torch.Tensor:
        """The frozen encoder's part-code means of a loader batch, BatchNorm
        on its running statistics (``extra_runners.py:208-218``): (B, K, zdim)."""
        db = ensure_attn_maps(device_batch(batch, self.device, self._slim_train))
        means, _ = self.model.encoder_mod.get_part_code(db["input"], db["ref_attn_map"],
                                                        train=False)
        return means

    def train(self):
        gen = torch.Generator(device=self.device).manual_seed(self.seed + self.epoch)
        for i, batch in enumerate(self.train_loader):
            codes = self.real_codes(batch)
            d_loss = self.d_step(codes, gen)
            if i % self.n_critic == 0:
                g_loss = self.g_step(codes.shape[0], gen)
            self.iter += 1
            if check_interval(self.iter, self.log_interval):
                self.logger.log({"d_loss": float(d_loss), "g_loss": float(g_loss)},
                                step=self.iter)
        self.epoch += 1

    @torch.no_grad()
    def generate_codes(self, num: int, generator=None, z=None) -> torch.Tensor:
        """Codes from the generator: (num, n_class, out_dim)."""
        G = self.generator
        return G(G.sample_noise(num, generator) if z is None else z)


class MixingRunner(Runner):
    """Part mixing over the val loader (``extra_runners.py:248-269``)."""

    def mixing(self, seed: int = 0, inject=None):
        """``combine_latent`` on every val batch, the arrays concatenated and
        pickled to ``work_dir/mixing/mixing.pkl``. The draws come from a
        generator seeded with ``seed``; ``inject`` gives each batch's
        ``combine_latent`` keyword draws in the loader's order."""
        from .editing import combine_latent

        gen = torch.Generator(device=self.device).manual_seed(seed)
        outs = []
        for i, batch in enumerate(self.val_loader):
            extra = inject[i] if inject is not None else {}
            outs.append(combine_latent(self.model, device_batch(batch, self.device, self._slim_val),
                                       generator=gen, **extra))
        out_dir = os.path.join(self.work_dir, "mixing")
        os.makedirs(out_dir, exist_ok=True)
        merged = {k: np.concatenate([o[k] for o in outs])
                  for k in outs[0] if isinstance(outs[0][k], np.ndarray)}
        with open(os.path.join(out_dir, "mixing.pkl"), "wb") as f:
            pickle.dump(merged, f)
        self.logger.print_log(f"mixing results -> {out_dir}/mixing.pkl")
        return merged


_LANGUAGE_KEYS = ("input", "ref", "attn_map", "ref_attn_map", "seg_mask", "ref_seg_mask",
                  "part_indicator", "text")


class LanguageRunner(Runner):
    """Language-editing training (``extra_runners.py:272-394``): the model is
    built with ``train_language=True``, and a step trains the text encoder
    and the update MLP on the triplet and contrastive losses. The gradient of
    every parameter whose name has no "language" or "update_mlp" in it is
    zeroed before the optimizer, so the clip and Adam see the zeros, as in
    optax: those parameters stay bit for bit as they were."""

    def __init__(self, args=None, cfg=None, device="cuda"):
        if cfg is not None and cfg.model is not None:
            cfg.model.train_language = True
        super().__init__(args=args, cfg=cfg, device=device)
        self.trained = [any("language" in p or "update_mlp" in p for p in path)
                        for path in self.state.paths]

    def language_step(self, state: TrainState, batch, rngs):
        """One step on a device batch: (new state, metrics). ``rngs`` holds the
        "sample" and "dropout" generators; the batch may inject
        ``part_code_eps`` and ``text_keep``."""
        return _step(self.tx, state, self.model.language_train_step(batch, rngs), self.trained)

    def train(self):
        gen = torch.Generator(device=self.device).manual_seed(self.seed + self.epoch)
        rngs = {"sample": gen, "dropout": gen}
        for batch in self.train_loader:
            db = {k: torch.as_tensor(np.asarray(batch[k]), device=self.device)
                  for k in _LANGUAGE_KEYS if k in batch}
            self.state, metrics = self.language_step(self.state, db, rngs)
            self.iter += 1
            if check_interval(self.iter, self.log_interval):
                values = torch.stack([v.float() for v in metrics.values()]).tolist()
                self.logger.log(dict(zip(metrics, values)), step=self.iter)
        self.epoch += 1
