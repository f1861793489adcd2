"""Per-part pretraining: ``PretrainRunner`` and its host-side part split.

The port of ``difffacto_tpu/runner/extra_runners.py:30-131`` (the reference's
pretrain_runner.py:37-261). The model is built with ``pretrain_prior=True``:
one denoiser a part, each trained on that part's cloud, normalised, and
conditioned on that part's code (``AnchorDiffAE.pretrain_loss``); ``val``
samples each part's diffusion on its own and writes
``val/pretrain_samples_<epoch>.npz``. The latent GAN and language runners
wait for their model families (``ROADMAP.md`` queue A item 6).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..parallel.train import parse_losses
from .runner import Runner, check_interval


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
        model = self.model
        params = list(model.parameters())
        total, metrics = parse_losses(model.pretrain_loss(part_inputs, rngs=rngs, **inject))
        grads = torch.autograd.grad(total, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
        with torch.no_grad():
            updates, opt_state = self.tx.update(grads, state.opt_state, params, state.paths)
            torch._foreach_add_(params, updates)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["total_loss"] = total.detach()
        return type(state)(step=state.step + 1, model=model, opt_state=opt_state), metrics

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
