"""Runner: the config-driven train, val and val_gen loops.

The port of ``difffacto_tpu/runner/runner.py:Runner``, on one device or on
the ranks of a ``torch.distributed`` group (``--launcher pytorch``):

* ``train`` runs ``make_train_step`` once per batch; metrics reach the host
  only every ``log_interval`` steps, so the host collates the next batch
  while the card runs the step;
* ``cache_noise`` re-caches the CIMLE noise every ``cimle_cache_interval``
  epochs: the best of N candidates by fit loss for each training shape;
* ``val`` generates a batch per val batch (``gen`` models, with the fixed
  parts of ``fix_part_ids`` and the trajectory of ``ret_traj``) or
  reconstructs it (the CIMLE candidates of ``select_best_noise``, then
  ``reconstruct``) and scores it through the dataset's ``evaluate``;
  ``generate_samples`` and ``evaluate_gen`` are the val_gen protocol
  (``runner/evaluation.py``);
* checkpoints (``utils/checkpoint.py``), the JAX package's ``.msgpack``
  checkpoints (``utils/jax_checkpoint.py``), a reference ``.pth``
  (``utils/torch_ingest.py``), auto-resume and the stage-1 -> stage-2 wiring
  (``model_only``, ``train_aligner``).

The model computes in float32 on the card and on the CPU, as the JAX
``Runner`` builds it (``difffacto_tpu/runner/runner.py:168``): the flow prior,
PointNetV2, the aligner and the chain in float32, and bf16 only at the
operands of the hand-written kernels, which cast at the call
(``utils/device.kernel_dtype``). ``make_pack_spec`` and ``pack_batch`` (a TPU
transfer-link measure) are not ported.

Where a process group exists, the meshes are those of the JAX ``Runner``
(``runner.py:198-258``): the data mesh over the largest rank count that
divides the batch (ranks past it idle), the eval mesh over it for the metric
sweeps where it has more than one rank on the card, the generation mesh of
``sp_devices`` and the step mesh of ``train_sp_devices`` over the data
mesh's ranks (the JAX package lays them over all its devices). Every rank
reads the same global batch order and takes its slice (``shard_batch``), so
a W-rank step is the dp arithmetic of the one-device step on that global
batch. ``cache_noise`` selects the CIMLE noise of each rank's slice and
gathers the table on every rank; generation is sharded by
``models.decode``. Rank 0 alone logs and writes checkpoints, with a barrier
after each; every rank resumes from the same file, and ``replicate`` gives
every rank rank 0's weights.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import yaml

from .. import data  # noqa: F401  (registers the datasets)
from ..config.config import get_cfg
from ..metrics.eval import set_default_eval_mesh
from ..models import reconstruct, sample_generation, select_best_noise
from ..parallel.axes import fold_generator
from ..parallel.mesh import all_gather_cat, barrier, make_mesh, replicate, shard_batch
from ..parallel.optim import build_optimizer_from_cfg
from ..parallel.train import init_train_state, make_train_step
from ..utils import loggers  # noqa: F401  (registers RunLogger)
from ..utils.checkpoint import load_checkpoint, save_checkpoint, search_ckpt
from ..utils.device import resolve_device
from ..utils.jax_checkpoint import read_jax_checkpoint
from ..utils.jax_params import load_jax_params, load_jax_train_state
from ..utils.registry import DATASETS, HOOKS, MODELS, build_from_cfg
from ..utils.torch_ingest import load_reference_checkpoint
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


class _QuietLogger:
    """The logger of every rank but 0: it writes and prints nothing."""

    def log(self, data, step=None, total_steps=None):
        pass

    def print_log(self, msg):
        pass


class Runner:
    """``Runner(args, cfg, device)``: ``cfg`` defaults to the loaded config
    singleton; ``args`` carries ``seed``, ``no_eval`` and ``short_val`` as the
    CLI parses them. Under a process group every rank builds one, with the
    same arguments."""

    def __init__(self, args=None, cfg=None, device="cuda"):
        self.cfg = cfg if cfg is not None else get_cfg()
        cfg = self.cfg
        self.device = resolve_device(device)
        self.work_dir = cfg.work_dir
        self.rank0 = not dist.is_initialized() or dist.get_rank() == 0
        if self.rank0:
            os.makedirs(self.work_dir, exist_ok=True)
            self.logger = build_from_cfg(cfgdict(cfg.logger) or dict(type="RunLogger"), HOOKS,
                                         work_dir=self.work_dir)
        else:
            self.logger = _QuietLogger()

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

        # float32 on every device; the kernels cast their own operands to bf16
        self.model = build_from_cfg(cfgdict(cfg.model), MODELS, device=self.device,
                                    seed=self.seed)
        # A loader that works on the device (ShapeNet's cropping) takes the runner's.
        self.train_loader, _ = build_from_cfg(cfgdict(cfg.dataset.train), DATASETS,
                                              device=self.device)
        self.val_loader, _ = build_from_cfg(cfgdict(cfg.dataset.val), DATASETS,
                                            device=self.device)
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
        self.mesh = self.gen_mesh = self.step_mesh = self.eval_mesh = None
        if dist.is_initialized():
            self._build_meshes(cfgdict(cfg.dataset.train))
        self.spare = self.mesh is not None and not self.mesh.member
        self._step_fn = make_train_step(self.model, self.tx, trainable_filter=trainable_filter,
                                        skip_grad_norm=cfg.get("skip_grad_norm"),
                                        mesh=self.step_mesh)
        self.state = init_train_state(self.model, self.tx)

        self.epoch = 0
        self.iter = 0
        self.total_iter = (self.max_epoch or 0) * self.iters_per_epoch or self.max_iter

        self.cimle = bool(cfg.cimle)
        self.cimle_start_epoch = cfg.cimle_start_epoch or 0
        self.cache_interval = cfg.cimle_cache_interval
        self._ref_self_cache: dict = {}

        if self.rank0:
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
        if self.mesh is not None and not self.spare:
            replicate(self.mesh, self.model)

    def _build_meshes(self, train_cfg):
        """The data, generation, step and eval meshes (``runner.py:198-258``)."""
        cfg, world = self.cfg, dist.get_world_size()
        bs = int(train_cfg["batch_size"])
        nd = world
        while nd > 1 and bs % nd:
            nd -= 1
        self.mesh = self.gen_mesh = self.step_mesh = make_mesh(range(nd))
        sp = int(cfg.get("sp_devices", 0) or 0)
        if sp > 1:
            if nd % sp == 0:
                self.gen_mesh = make_mesh(range(nd), ("data", "points"), (nd // sp, sp))
            else:
                self.logger.print_log(f"sp_devices={sp} does not divide the data mesh's {nd} "
                                      "ranks; generation stays on the data mesh")
        train_sp = int(cfg.get("train_sp_devices", 0) or 0)
        if train_sp > 1:
            npoints = int(train_cfg.get("npoints", 0) or 0)
            if nd % train_sp == 0 and npoints % train_sp == 0:
                self.step_mesh = make_mesh(range(nd), ("data", "points"),
                                           (nd // train_sp, train_sp))
            else:
                self.logger.print_log(f"train_sp_devices={train_sp} does not divide the data "
                                      f"mesh's {nd} ranks or the points; training stays on the "
                                      "data mesh")
        # The JAX package gates the sharded sweeps on a real TPU (on its
        # virtual CPU mesh they buy no time); the port on the card.
        self.eval_mesh = self.mesh if nd > 1 and self.device.type == "cuda" else None
        self.logger.print_log(
            f"{world} ranks ({dist.get_backend()}): data mesh {nd}, generation mesh "
            f"{self.gen_mesh.shape}, step mesh {self.step_mesh.shape}, sharded sweeps "
            f"{'on' if self.eval_mesh is not None else 'off'}")
        if self.rank0 and nd < world:
            print(f"[difffacto_torch] the batch {bs} splits over {nd} of {world} ranks; "
                  f"ranks {nd}..{world - 1} idle", flush=True)
        if not self.mesh.member:
            self.gen_mesh = self.step_mesh = self.eval_mesh = None
        set_default_eval_mesh(self.eval_mesh)

    @staticmethod
    def _norm_ckpt(path):
        if path.endswith((".pt", ".pth", ".msgpack")):
            return path
        return path + ".pt"

    # ----------------------------------------------------------------- io
    def load(self, path, model_only=False):
        if path.endswith(".pth"):
            # A reference checkpoint holds the model alone (its epoch and
            # optimizer are not this port's): model_only or not, the weights
            # are all it restores, as in the JAX runner (runner.py:304-313).
            load_reference_checkpoint(path, self.model)
            self.logger.print_log(f"loaded reference torch weights from {path}")
            return
        if path.endswith(".msgpack"):
            self._load_jax(path, model_only)
            return
        self.state, meta = load_checkpoint(path, self.state, model_only=model_only)
        if not model_only:
            self.epoch = int(meta.get("epoch", 0))
            self.iter = int(meta.get("iter", self.epoch * self.iters_per_epoch))
            if meta["noise_table"] is not None:
                self.train_loader.dataset.noises = meta["noise_table"]
        self.logger.print_log(f"resumed from {path} (epoch {self.epoch})")

    def _load_jax(self, path, model_only):
        """A checkpoint of the JAX package's Runner: the weights alone with
        ``model_only`` (every key must map), else the step, Adam's state, the
        epoch and the iteration too. It carries no CIMLE table, so a resumed
        run trains on the pre-cache noise until the next re-cache, as the
        JAX Runner does."""
        tree, meta = read_jax_checkpoint(path)
        if model_only:
            load_jax_params(self.model, tree["params"], tree["batch_stats"])
            self.logger.print_log(f"loaded the JAX package's weights from {path}")
            return
        self.state = load_jax_train_state(self.state, self.tx, tree)
        self.epoch = int(meta.get("epoch", 0))
        self.iter = int(meta.get("iter", self.epoch * self.iters_per_epoch))
        self.logger.print_log(f"resumed from the JAX package's {path} (epoch {self.epoch}); it "
                              "holds no CIMLE table: none until the next re-cache")

    def save(self):
        if self.rank0:
            path = save_checkpoint(self.work_dir, self.epoch, self.state,
                                   meta={"iter": self.iter, "config": self.cfg.dump()},
                                   noise_table=getattr(self.train_loader.dataset, "noises", None))
            self.logger.print_log(f"saved checkpoint {path}")
        if self.mesh is not None:
            barrier(self.mesh)

    # --------------------------------------------------------------- loops
    @property
    def finish(self):
        if self.max_epoch:
            return self.epoch >= self.max_epoch
        return self.iter >= (self.max_iter or 0)

    def run(self):
        if self.spare:
            return
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
        t_epoch = time.perf_counter()
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
            if self.step_mesh is not None:
                batch = shard_batch(self.step_mesh, batch)
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
            if self.rank0:
                out = os.path.join(self.work_dir, "profile")
                os.makedirs(out, exist_ok=True)
                profiler.export_chrome_trace(os.path.join(out, f"epoch_{self.epoch}.json"))
                self.logger.print_log(f"profile trace -> {out}")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.logger.print_log(f"epoch {self.epoch} trained in {time.perf_counter() - t_epoch:.4f} s")
        self.epoch += 1

    # --------------------------------------------------------------- CIMLE
    def cache_noise(self, inject: Optional[List[Dict[str, torch.Tensor]]] = None):
        """The best of N aligner noises for each training shape, stored in
        the dataset. ``inject`` gives each batch's draws in the loader's order
        (``noise``: the (B * N, D) candidates; ``part_code_eps``: the part
        code's draw); what it leaves out is drawn from a generator seeded with
        ``seed + epoch``. On a data mesh each rank selects for its slice of a
        batch, from that generator folded by its data rank, and the rows are
        gathered, so every rank stores the same table (a ragged batch, whole
        on every rank, takes the unfolded generator)."""
        self.logger.print_log("caching CIMLE noise")
        all_noise, all_ids = [], []
        gen = torch.Generator(device=self.device).manual_seed(self.seed + self.epoch)
        for i, batch in enumerate(self.train_loader):
            extra = dict(inject[i]) if inject is not None else {}
            noise = extra.pop("noise", None)
            local, g = batch, gen
            sharded = False
            if self.mesh is not None:
                B = len(batch["ref"])
                local = shard_batch(self.mesh, dict(batch, **extra))
                sharded = len(local["ref"]) < B
                if noise is not None:
                    noise = shard_batch(self.mesh, {"n": noise.reshape(B, -1, noise.shape[-1])})["n"]
                    noise = noise.reshape(-1, noise.shape[-1])
                extra = {k: local.pop(k) for k in extra}
                if sharded:
                    g = fold_generator(gen, self.mesh.index())
            db = device_batch(local, self.device, self._slim_train)
            db.update(extra)
            _, _, selected = select_best_noise(self.model, db, generator=g, noise=noise)
            if sharded:
                selected = all_gather_cat(selected.contiguous(), self.mesh.groups["data"])
            # One non-finite cached noise would poison every later step on that
            # shape; zero is the distribution's mean.
            selected = selected.float().cpu().numpy()
            all_noise.append(np.nan_to_num(selected, nan=0.0, posinf=0.0, neginf=0.0))
            all_ids.append(np.asarray(batch["id"]))
        self.train_loader.dataset.store_noise(all_noise, all_ids)

    # ----------------------------------------------------------------- val
    def _eval_batch(self, batch, generator) -> List[Tuple[Dict, str]]:
        """One val batch (``runner.py:465-534``): generation for ``gen`` models,
        named ``gen_fixed`` and the digits of the fixed-part mask; otherwise
        the best of ``cimle_sample_num`` CIMLE candidates for each shape and
        the reconstruction, named ``sample``. With ``ret_traj`` the kept
        steps of the chain come out as ``traj_<t>``."""
        model = self.model
        db = device_batch(batch, self.device, self._slim_val)
        B = db["ref"].shape[0]
        if model.gen:
            fixed = torch.zeros(model.num_anchors, device=self.device)
            for i in model.fix_part_ids or ():
                fixed[i] = 1
            out = sample_generation(model, B, valid_id=db["present"].float(), fixed_id=fixed,
                                    epoch=self.epoch, ret_traj=model.ret_traj,
                                    generator=generator, mesh=self.gen_mesh)
            name = "gen_fixed" + "".join(str(int(i)) for i in fixed.tolist())
        else:
            noise = None
            if model.cimle:
                noise, _, _ = select_best_noise(model, db, model.cimle_sample_num,
                                                generator=generator)
            out = reconstruct(model, db, noise=noise, epoch=self.epoch, ret_traj=model.ret_traj,
                              generator=generator)
            name = "sample"
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
        if "traj" in out:
            traj = out["traj"].float().cpu().numpy()  # (T_kept, B * K, N, 3)
            for ti, t in enumerate(out["traj_t"]):
                pred[f"traj_{int(t)}"] = traj[ti].reshape(B, K, -1, 3)[:, 0]
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
        if self.spare:
            return {}
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
            if self.rank0:
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
        if self.spare:
            return {}
        gen = generate_samples(self.model, num_gen=num_gen, batch=batch, seed=self.seed,
                               epoch=self.epoch, mesh=self.gen_mesh)
        refs = np.concatenate([np.asarray(vb["ref"]) for vb in self.val_loader])
        return self.evaluate_gen(gen, refs)

    def evaluate_gen(self, gen: np.ndarray, refs: np.ndarray):
        """FPS to 2048 points, bbox-normalize and the metric suite; the
        ref-vs-ref block is computed once for the runner's life."""
        metrics = evaluate_gen(gen, refs, ref_self_cache=self._ref_self_cache,
                               device=self.device, mesh=self.eval_mesh)
        self.logger.log({f"gen/{k}": float(v) for k, v in metrics.items()}, step=self.iter)
        return metrics
