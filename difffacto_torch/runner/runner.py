"""Runner: the config-driven train, val and val_gen loops.

The port of ``difffacto_tpu/runner/runner.py:Runner`` for one device:

* ``train`` runs ``make_train_step`` once per batch; metrics reach the host
  only every ``log_interval`` steps, so the host collates the next batch
  while the card runs the step;
* ``cache_noise`` re-caches the CIMLE noise every ``cimle_cache_interval``
  epochs: the best of N candidates by fit loss for each training shape;
* ``val`` generates a batch per val batch and scores it through the
  dataset's ``evaluate``, ``generate_samples`` and ``evaluate_gen`` the
  val_gen protocol (``runner/evaluation.py``);
* checkpoints (``utils/checkpoint.py``), auto-resume and the stage-1 ->
  stage-2 wiring (``model_only``, ``train_aligner``).

The model computes in bf16 on the card, the dtype its trunk kernels take,
and in float32 on the CPU. ``make_pack_spec`` and ``pack_batch`` (a TPU
transfer-link measure) and the device meshes come with the multi-GPU port.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import yaml

from .. import data  # noqa: F401  (registers the datasets)
from ..config.config import get_cfg
from ..models import sample_generation, select_best_noise
from ..parallel.optim import build_optimizer_from_cfg
from ..parallel.train import init_train_state, make_train_step
from ..utils import loggers  # noqa: F401  (registers RunLogger)
from ..utils.checkpoint import load_checkpoint, save_checkpoint, search_ckpt
from ..utils.device import resolve_device
from ..utils.registry import DATASETS, HOOKS, MODELS, build_from_cfg
from .evaluation import evaluate_gen, generate_samples

def check_interval(step, interval):
    if step is None or interval is None:
        return False
    return step % interval == 0


_BATCH_KEYS = (
    "input", "ref", "ref_seg_mask", "seg_mask", "ref_attn_map", "attn_map", "present",
    "dp_present", "part_shift", "part_scale", "noise", "text", "part_indicator", "shift",
    "scale",
)


def cfgdict(x):
    """Config or dict -> plain dict."""
    if x is None:
        return None
    return x.dump() if hasattr(x, "dump") else dict(x)


def device_batch(batch: Dict, device, slim_attn: bool = False) -> Dict[str, torch.Tensor]:
    """Numpy batch -> tensors on ``device`` for the model (host-only keys dropped).

    ``slim_attn=True`` (datasets whose ``attn_from_seg`` guarantees
    ``attn_map == eye(K)[seg_mask]``) leaves out the (B, N, K) float32 maps
    and sends the seg masks as int8; the model's entry points rebuild the
    maps on the device (``models.anchor_diff.ensure_attn_maps``). On the card
    each array goes through pinned memory with a non-blocking copy, so the
    host does not wait for the card's queue.
    """
    device = torch.device(device)
    out = {}
    for k in _BATCH_KEYS:
        if k not in batch:
            continue
        if slim_attn and k in ("attn_map", "ref_attn_map"):
            continue
        v = np.asarray(batch[k])
        if slim_attn and k in ("seg_mask", "ref_seg_mask"):
            v = v.astype(np.int8)
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


class Runner:
    """``Runner(args, cfg, device)``: ``cfg`` defaults to the loaded config
    singleton; ``args`` carries ``seed``, ``no_eval`` and ``short_val`` as the
    CLI parses them."""

    def __init__(self, args=None, cfg=None, device="cuda"):
        self.cfg = cfg if cfg is not None else get_cfg()
        cfg = self.cfg
        self.device = resolve_device(device)
        self.work_dir = cfg.work_dir
        os.makedirs(self.work_dir, exist_ok=True)
        self.logger = build_from_cfg(cfgdict(cfg.logger) or dict(type="RunLogger"), HOOKS,
                                     work_dir=self.work_dir)

        self.max_epoch = cfg.max_epoch
        self.max_iter = cfg.max_iter
        self.checkpoint_interval = cfg.checkpoint_interval
        self.eval_interval = cfg.eval_interval
        self.log_interval = cfg.log_interval or 50
        self.save_num_batch = cfg.save_num_batch or 1
        self.max_norm = cfg.max_norm
        self.seed = getattr(args, "seed", None) or 0
        self.no_eval = bool(getattr(args, "no_eval", False))
        self.short_val = bool(getattr(args, "short_val", False))

        # bf16 on the card, the dtype the trunk kernels take; float32 on the CPU
        dtype = torch.bfloat16 if self.device.type == "cuda" else None
        self.model = build_from_cfg(cfgdict(cfg.model), MODELS, device=self.device, dtype=dtype,
                                    seed=self.seed)
        self.train_loader, _ = build_from_cfg(cfgdict(cfg.dataset.train), DATASETS)
        self.val_loader, _ = build_from_cfg(cfgdict(cfg.dataset.val), DATASETS)
        self.iters_per_epoch = max(len(self.train_loader), 1)
        self._slim_train = bool(getattr(self.train_loader.dataset, "attn_from_seg", False))
        self._slim_val = bool(getattr(self.val_loader.dataset, "attn_from_seg", False))

        # The reference's train_aligner / joint_train parameter groups become
        # a trainable filter or a per-path learning-rate scale.
        trainable_filter = None
        lr_scale_fn = None
        if cfg.train_aligner:
            if cfg.joint_train:
                scale = cfg.lr_scale if cfg.lr_scale is not None else 1.0
                lr_scale_fn = lambda path: 1.0 if any("aligner" in p for p in path) else scale
            else:
                trainable_filter = lambda path: any("aligner" in p for p in path)
        self.trainable_filter, self.lr_scale_fn = trainable_filter, lr_scale_fn
        self.tx = build_optimizer_from_cfg(
            cfgdict(cfg.optimizer) or dict(type="Adam", lr=1e-3),
            scheduler_cfg=cfgdict(cfg.scheduler),
            iters_per_epoch=self.iters_per_epoch,
            max_norm=self.max_norm,
            lr_scale_fn=lr_scale_fn,
        )
        for key in ("sp_devices", "train_sp_devices"):
            if int(cfg.get(key, 0) or 0) > 1:
                self.logger.print_log(f"{key}={cfg[key]} needs several cards; the runner "
                                      "stays on one device")
        self._step_fn = make_train_step(self.model, self.tx, trainable_filter=trainable_filter,
                                        skip_grad_norm=cfg.get("skip_grad_norm"))
        self.state = init_train_state(self.model, self.tx)

        self.epoch = 0
        self.iter = 0
        self.total_iter = (self.max_epoch or 0) * self.iters_per_epoch or self.max_iter

        self.cimle = bool(cfg.cimle)
        self.cimle_start_epoch = cfg.cimle_start_epoch or 0
        self.cache_interval = cfg.cimle_cache_interval
        self._ref_self_cache: dict = {}

        with open(os.path.join(self.work_dir, "config.yaml"), "w") as f:
            yaml.dump(cfg.dump(), f)
        if args is not None:
            with open(os.path.join(self.work_dir, "args.yaml"), "w") as f:
                yaml.dump(vars(args), f)

        if cfg.pretrained_weights:
            self.load(cfg.pretrained_weights, model_only=bool(cfg.model_only))
        if cfg.resume_path and not os.path.exists(self._norm_ckpt(cfg.resume_path)):
            # An explicitly configured checkpoint that is absent aborts: fresh
            # weights would give numbers that look real.
            raise FileNotFoundError(f"cfg.resume_path does not exist: {cfg.resume_path}")
        auto = cfg.get("auto_resume", True)
        resume = cfg.resume_path or (search_ckpt(self.work_dir) if auto else None)
        if resume:
            self.load(self._norm_ckpt(resume), model_only=bool(cfg.model_only))

    @staticmethod
    def _norm_ckpt(path):
        if path.endswith(".pt") or path.endswith(".pth"):
            return path
        return path + ".pt"

    # ----------------------------------------------------------------- io
    def load(self, path, model_only=False):
        if path.endswith(".pth"):
            raise NotImplementedError("loading a reference .pth checkpoint is not ported yet "
                                      "(ROADMAP.md, queue A item 4: the reference .pth loader)")
        self.state, meta = load_checkpoint(path, self.state, model_only=model_only)
        if not model_only:
            self.epoch = int(meta.get("epoch", 0))
            self.iter = int(meta.get("iter", self.epoch * self.iters_per_epoch))
            if meta["noise_table"] is not None:
                self.train_loader.dataset.noises = meta["noise_table"]
        self.logger.print_log(f"resumed from {path} (epoch {self.epoch})")

    def save(self):
        path = save_checkpoint(self.work_dir, self.epoch, self.state,
                               meta={"iter": self.iter, "config": self.cfg.dump()},
                               noise_table=getattr(self.train_loader.dataset, "noises", None))
        self.logger.print_log(f"saved checkpoint {path}")

    # --------------------------------------------------------------- loops
    @property
    def finish(self):
        if self.max_epoch:
            return self.epoch >= self.max_epoch
        return self.iter >= (self.max_iter or 0)

    def run(self):
        self.logger.print_log("Start running")
        trained = False
        saved_final = False
        while not self.finish:
            self.train_loader.set_epoch(self.epoch)
            if (
                self.cimle
                and self.epoch >= self.cimle_start_epoch
                and check_interval(self.epoch - self.cimle_start_epoch, self.cache_interval)
            ):
                self.cache_noise()
            self.train()
            trained = True
            if check_interval(self.epoch, self.eval_interval) and not self.no_eval:
                self.val()
            saved_final = check_interval(self.epoch, self.checkpoint_interval)
            if saved_final:
                self.save()
        # Always leave a final checkpoint: a follow-up --task val or val_gen in
        # the same work_dir auto-resumes from it.
        if trained and not saved_final:
            self.save()

    def train(self):
        seed = self.seed + 7919  # folded with state.step by the step function
        # ips is a rolling rate over the last log window
        if not hasattr(self, "_rate_t"):
            self._rate_t, self._rate_iter = time.time(), self.iter
        profiler = None
        if self.cfg.profile_epoch is not None and self.epoch == self.cfg.profile_epoch:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=acts)
            profiler.start()
        for batch in self.train_loader:
            db = device_batch(batch, self.device, self._slim_train)
            self.state, metrics = self._step_fn(self.state, db, seed, self.epoch)
            self.iter += 1
            if check_interval(self.iter, self.log_interval):
                # the one point where the host waits for the card
                values = torch.stack([v.float() for v in metrics.values()]).tolist()
                logd = dict(zip(metrics, values))
                logd["epoch"] = self.epoch
                now = time.time()
                logd["ips"] = (self.iter - self._rate_iter) / max(now - self._rate_t, 1e-9)
                self._rate_t, self._rate_iter = now, self.iter
                self.logger.log(logd, step=self.iter, total_steps=self.total_iter)
        if profiler is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            profiler.stop()
            out = os.path.join(self.work_dir, "profile")
            os.makedirs(out, exist_ok=True)
            profiler.export_chrome_trace(os.path.join(out, f"epoch_{self.epoch}.json"))
            self.logger.print_log(f"profile trace -> {out}")
        self.epoch += 1

    # --------------------------------------------------------------- CIMLE
    def cache_noise(self, inject: Optional[List[Dict[str, torch.Tensor]]] = None):
        """The best of N aligner noises for each training shape, stored in
        the dataset. ``inject`` gives each batch's draws in the loader's order
        (``noise``: the (B * N, D) candidates; ``part_code_eps``: the part
        code's draw); what it leaves out is drawn from a generator seeded with
        ``seed + epoch``."""
        self.logger.print_log("caching CIMLE noise")
        all_noise, all_ids = [], []
        gen = torch.Generator(device=self.device).manual_seed(self.seed + self.epoch)
        for i, batch in enumerate(self.train_loader):
            db = device_batch(batch, self.device, self._slim_train)
            extra = dict(inject[i]) if inject is not None else {}
            noise = extra.pop("noise", None)
            db.update(extra)
            _, _, selected = select_best_noise(self.model, db, generator=gen, noise=noise)
            # One non-finite cached noise would poison every later step on that
            # shape; zero is the distribution's mean.
            selected = selected.float().cpu().numpy()
            all_noise.append(np.nan_to_num(selected, nan=0.0, posinf=0.0, neginf=0.0))
            all_ids.append(np.asarray(batch["id"]))
        self.train_loader.dataset.store_noise(all_noise, all_ids)

    # ----------------------------------------------------------------- val
    def _eval_batch(self, batch, generator) -> List[Tuple[Dict, str]]:
        """One val batch: generation for ``gen`` models."""
        if not self.model.gen:
            raise NotImplementedError(
                "val of a reconstruction (gen=False) model needs reconstruct, which is not "
                "ported yet (ROADMAP.md, queue A item 5)")
        db = device_batch(batch, self.device, self._slim_val)
        B = db["ref"].shape[0]
        out = sample_generation(self.model, B, valid_id=db["present"].float(), epoch=self.epoch,
                                generator=generator)
        name = "gen_fixed" + "0" * self.model.num_anchors
        full_pred = out["pred"].float().cpu().numpy()  # (B * K, N, 3)
        seg_mask = out["seg_mask"].cpu().numpy()
        anchors = out["anchors"].float().cpu().numpy()
        K = full_pred.shape[0] // B
        pred = {}
        if K > 1:
            r = full_pred.reshape(B, K, *full_pred.shape[1:])
            for i in range(K):
                pred[f"pred_sample {i}"] = r[:, i]
            pred["pred"] = r[:, 0]
            pred["pred_seg_mask"] = seg_mask.reshape(B, K, -1)[:, 0]
            pred["anchors"] = anchors.reshape(B, K, *anchors.shape[1:])[:, 0]
        else:
            pred["pred"] = full_pred
            pred["pred_seg_mask"] = seg_mask
            pred["anchors"] = anchors
        pred["input"] = np.asarray(batch["input"])
        pred["input_ref"] = np.asarray(batch["ref"])
        pred["ref_seg_mask"] = np.asarray(batch["ref_seg_mask"])
        pred["seg_mask"] = np.asarray(batch["seg_mask"])
        pred["present"] = np.asarray(batch["present"])
        pred["shift"] = np.asarray(batch["shift"])
        pred["scale"] = np.asarray(batch["scale"])
        pred["token"] = batch["token"]
        return [(pred, name)]

    def val(self):
        self.logger.print_log(f"validation @ epoch {self.epoch}")
        results: Dict[str, List[Dict]] = {}
        gen = torch.Generator(device=self.device).manual_seed(self.seed + 13)
        for i, batch in enumerate(self.val_loader):
            for pred, name in self._eval_batch(batch, gen):
                results.setdefault(name, []).append(pred)
            if self.short_val and i >= 1:
                break
        all_metrics = {}
        for name, res in results.items():
            save_dict, metrics = self.val_loader.evaluate(res, self.save_num_batch, self.device)
            out_dir = os.path.join(self.work_dir, "val")
            os.makedirs(out_dir, exist_ok=True)
            np.savez(
                os.path.join(out_dir, f"{name}_{self.epoch}.npz"),
                **{k: v for k, v in save_dict.items() if isinstance(v, np.ndarray)},
            )
            metrics = {f"{name}/{k}": float(v) for k, v in metrics.items()}
            all_metrics.update(metrics)
            self.logger.log(metrics, step=self.iter)
        return all_metrics

    # --------------------------------------------------- val_gen protocol
    def generate_samples(self, num_gen: int = 400, batch: int = 128):
        """Unconditional generation against the val set's references."""
        gen = generate_samples(self.model, num_gen=num_gen, batch=batch, seed=self.seed)
        refs = np.concatenate([np.asarray(vb["ref"]) for vb in self.val_loader])
        return self.evaluate_gen(gen, refs)

    def evaluate_gen(self, gen: np.ndarray, refs: np.ndarray):
        """FPS to 2048 points, bbox-normalize and the metric suite; the
        ref-vs-ref block is computed once for the runner's life."""
        metrics = evaluate_gen(gen, refs, ref_self_cache=self._ref_self_cache,
                               device=self.device)
        self.logger.log({f"gen/{k}": float(v) for k, v in metrics.items()}, step=self.iter)
        return metrics
