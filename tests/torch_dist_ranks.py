"""Gloo ranks on the CPU for the port's multi-GPU tests.

``spawn(suite, world, workdir)`` starts ``world`` processes of this file, each
one rank of a gloo group that meets through a ``FileStore`` under
``workdir`` (no port: several test workers run at once), runs the suite's
scenarios there and returns what each rank saved, {name: numpy array}, one
dict a rank. Rank 0 also computes the one-device references. The ranks
import torch and the port, never JAX.

    python tests/torch_dist_ranks.py SUITE RANK WORLD WORKDIR
"""

from __future__ import annotations

import concurrent.futures
import copy
import hashlib
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "tests", "configs", "tiny_gen.py")
B, N, K = 4, 64, 4


def spawn(suite: str, world: int, workdir, timeout: float = 240.0, backend: str = "gloo"):
    """Run ``suite`` on ``world`` ranks (gloo, or ``backend``); one {name:
    array} dict a rank."""
    workdir = str(workdir)
    os.makedirs(workdir, exist_ok=True)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), suite, str(r),
                               str(world), workdir, backend], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(world)]
    deadline = time.time() + timeout
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=max(deadline - time.time(), 1.0))[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"{suite} rank {r}/{world} exited {p.returncode}:\n{out[-4000:]}")
    results = []
    for r in range(world):
        with np.load(os.path.join(workdir, f"{suite}_rank{r}.npz")) as f:
            results.append({k: f[k] for k in f.files})
    return results


def spawn_async(suite: str, world: int, workdir) -> concurrent.futures.Future:
    """``spawn`` in a thread: the ranks run while the caller computes."""
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    future = pool.submit(spawn, suite, world, workdir)
    pool.shutdown(wait=False)
    return future


# ------------------------------------------------------------------ ranks
def tiny_model(encoder=None, diffusion=None, net=None, seed=0):
    """tests/configs/tiny_gen.py's model with its keys changed, every weight
    moved off its initial value (a zero proj_out would leave the trunk
    without gradients), the same on every rank."""
    import torch

    from difffacto_torch import Config, MODELS, build_from_cfg

    mcfg = Config(TINY).model.dump()
    mcfg["encoder"].update(encoder or {})
    mcfg["diffusion"].update(diffusion or {})
    mcfg["diffusion"]["net"].update(net or {})
    model = build_from_cfg(mcfg, MODELS, device="cpu", seed=seed)
    rng = np.random.RandomState(seed + 100)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.from_numpy(0.05 * rng.randn(*p.shape).astype(np.float32)))
    return model


def tiny_batch(model, seed=0, b=B, n=N):
    """A batch with every draw of the loss injected: diffusion_t and
    diffusion_noise, the aligner's noise, the part code's eps. Parts are
    scattered over the points; sample 0 drops part 3 from the diffusion loss."""
    rng = np.random.RandomState(seed)
    seg = rng.randint(0, K, (b, n)).astype(np.int32)
    seg[:, :K] = np.arange(K)
    pts = (rng.randn(b, n, 3) * 0.3).astype(np.float32)
    present = np.ones((b, K), np.float32)
    dp_present = present.copy()
    dp_present[0, 3] = 0
    zdim = model.encoder_mod.zdim
    return {
        "input": pts, "ref": pts.copy(), "ref_seg_mask": seg, "seg_mask": seg.copy(),
        "present": present, "dp_present": dp_present,
        "part_shift": (rng.randn(b, K, 3) * 0.1).astype(np.float32),
        "part_scale": (np.abs(rng.randn(b, K, 3)) * 0.2 + 0.3).astype(np.float32),
        "diffusion_t": rng.randint(0, model.num_timesteps, (b,)).astype(np.int64),
        "diffusion_noise": rng.randn(b, n, 3).astype(np.float32),
        "noise": rng.randn(b, model.encoder_mod.noise_dim).astype(np.float32),
        "part_code_eps": rng.randn(b, K, zdim).astype(np.float32),
    }


def tensors(batch, device="cpu"):
    import torch

    return {k: torch.as_tensor(np.array(v), device=device) for k, v in batch.items()}


def flat(ts):
    import torch

    return torch.cat([t.detach().reshape(-1).float().cpu() for t in ts]).numpy()


def digest(ts):
    """The sha256 of the tensors' bytes: ranks that hold equal ones agree."""
    return np.frombuffer(hashlib.sha256(flat(ts).tobytes()).digest(), np.uint8)


def loss_and_grads(model, batch, train, mesh=None):
    """The loss's total and gradients on this rank's slice, the mean over the
    mesh taken as the step takes it (eval mode: BN's running statistics)."""
    import torch

    from difffacto_torch.models import ensure_attn_maps
    from difffacto_torch.parallel import points_sharded, shard_batch
    from difffacto_torch.parallel.mesh import all_reduce_mean_
    from difffacto_torch.parallel.train import parse_losses

    group = None
    if mesh is not None:
        batch = shard_batch(mesh, batch)
        if mesh.axis_size("points") > 1:
            group = mesh.groups["points"]
    params = list(model.parameters())
    with points_sharded(group):
        total, _ = parse_losses(model.loss(ensure_attn_maps(tensors(batch)), 0, train))
        grads = torch.autograd.grad(total, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
    total = total.detach().reshape(1)
    if mesh is not None:
        all_reduce_mean_(grads + [total], mesh)
    return total, grads


def manual_dp_step(model, tx, batch, parts, device="cpu"):
    """The dp step's arithmetic by hand on one device: each part's loss and
    gradients in train mode from the same statistics, their mean, one
    update (``test_shard_map_step_matches_manual_dp_math``)."""
    import torch

    from difffacto_torch.models import ensure_attn_maps
    from difffacto_torch.parallel.optim import global_norm
    from difffacto_torch.parallel.train import init_train_state, parse_losses

    params = list(model.parameters())
    buffers = list(model.buffers())
    start = [b.clone() for b in buffers]
    state = init_train_state(model, tx)
    totals, grads, stats = [], [], []
    b = batch["ref"].shape[0] // parts
    for d in range(parts):
        for buf, s in zip(buffers, start):
            buf.copy_(s)
        local = {k: v[d * b:(d + 1) * b] for k, v in batch.items()}
        total, _ = parse_losses(model.loss(ensure_attn_maps(tensors(local, device)), 0, True))
        g = torch.autograd.grad(total, params, allow_unused=True)
        grads.append([torch.zeros_like(p) if x is None else x for x, p in zip(g, params)])
        totals.append(float(total))
        stats.append([buf.clone() for buf in buffers])
    mean = [sum(gs) / parts for gs in zip(*grads)]
    with torch.no_grad():
        updates, _ = tx.update(mean, state.opt_state, params, state.paths)
        new = [p + u for p, u in zip(params, updates)]
    stats = [sum(ss) / parts for ss in zip(*stats)]
    return {"total": np.float64(np.mean(totals)), "gnorm": float(global_norm(mean)),
            "params": flat(new), "stats": flat(stats)}


def parallel_suite(rank, world, workdir):
    """The dp step, the sp and dp x sp loss and gradients, BatchNorm over the
    point axis, the sp step and the sharded decode."""
    import torch

    from difffacto_torch.models import decode
    from difffacto_torch.nn.layers import TorchBatchNorm
    from difffacto_torch.parallel import (build_optimizer_from_cfg, init_train_state,
                                          make_mesh, make_train_step, points_sharded,
                                          psum_points, replicate, shard_batch)
    from difffacto_torch.parallel.mesh import all_gather_cat, all_reduce_mean_

    out = {}
    sp_layouts = [(1, world), (2, world // 2)] if world == 4 else [(1, world)]
    tx_cfg = dict(type="Adam", lr=1e-3, weight_decay=0.0)

    # dp steps: the mesh step against the manual dp arithmetic; a ragged
    # batch (replicated) against the plain step
    flat_mesh = make_mesh()
    for name, b in (("dp", B), ("ragged", B - 1)):
        model = replicate(flat_mesh, tiny_model())
        ref_model = copy.deepcopy(model)
        batch = tiny_batch(model, seed=7, b=b)
        tx = build_optimizer_from_cfg(tx_cfg, max_norm=10.0)
        step = make_train_step(model, tx, mesh=flat_mesh)
        _, m = step(init_train_state(model, tx), tensors(shard_batch(flat_mesh, batch)), 0, 0)
        out[f"{name}_total"] = np.float64(m["total_loss"])
        out[f"{name}_gnorm"] = np.float64(m["grad_norm"])
        out[f"{name}_params"] = flat(model.parameters())
        out[f"{name}_stats"] = flat(model.buffers())
        out[f"{name}_digest"] = digest(list(model.parameters()) + list(model.buffers()))
        if rank == 0:
            if name == "dp":
                ref = manual_dp_step(ref_model, tx, batch, world)
            else:
                plain = make_train_step(ref_model, tx)
                _, rm = plain(init_train_state(ref_model, tx), tensors(batch), 0, 0)
                ref = {"total": np.float64(rm["total_loss"]), "gnorm": np.float64(rm["grad_norm"]),
                       "params": flat(ref_model.parameters()), "stats": flat(ref_model.buffers())}
            for k, v in ref.items():
                out[f"{name}_ref_{k}"] = np.asarray(v)

    # eval-mode loss and gradients: one device, flat dp, sp and dp x sp, for
    # the fit-loss type that reduces over the points and for a learned variance
    variants = {"fit0": dict(encoder=dict(fit_loss_type=0)),
                "learned": dict(diffusion=dict(model_var_type="learned_range"),
                                net=dict(out_channels=6))}
    meshes = {"dp": flat_mesh}
    if world == 4:
        meshes["dp2"] = make_mesh(ranks=range(2))
    for nd, npts in sp_layouts:
        meshes[f"sp{nd}x{npts}"] = make_mesh(axis_names=("data", "points"), mesh_shape=(nd, npts))
    for vname, keys in variants.items():
        model = tiny_model(**keys)
        batch = tiny_batch(model, seed=11)
        if rank == 0:
            total, grads = loss_and_grads(model, batch, False)
            out[f"{vname}_one_total"], out[f"{vname}_one_grads"] = flat([total]), flat(grads)
        for mname, mesh in meshes.items():
            if not mesh.member:
                continue
            total, grads = loss_and_grads(model, batch, False, mesh)
            out[f"{vname}_{mname}_total"], out[f"{vname}_{mname}_grads"] = flat([total]), flat(grads)

    # the whole train-mode step over the point axis against one device
    for nd, npts in sp_layouts[:1]:
        mesh = meshes[f"sp{nd}x{npts}"]
        model = tiny_model(encoder=dict(fit_loss_type=0))
        ref_model = copy.deepcopy(model)
        batch = tiny_batch(model, seed=13)
        tx = build_optimizer_from_cfg(tx_cfg, max_norm=10.0)
        _, m = make_train_step(model, tx, mesh=mesh)(
            init_train_state(model, tx), tensors(shard_batch(mesh, batch)), 0, 0)
        out["spstep_total"], out["spstep_params"] = np.float64(m["total_loss"]), flat(
            model.parameters())
        out["spstep_digest"] = digest(model.parameters())
        if rank == 0:
            _, rm = make_train_step(ref_model, tx)(init_train_state(ref_model, tx),
                                                   tensors(batch), 0, 0)
            out["spstep_ref_total"] = np.float64(rm["total_loss"])
            out["spstep_ref_params"] = flat(ref_model.parameters())

    # BatchNorm over the point axis (test_bn_point_axis_sync)
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 32, 8).astype(np.float32))
    bn = TorchBatchNorm((8,), device="cpu")
    with torch.no_grad():
        bn.scale.add_(0.1)
        bn.bias.add_(0.2)
    start = [b.clone() for b in bn.buffers()]
    if rank == 0:
        y = bn(x, True)
        g = torch.autograd.grad((y ** 2).sum(), list(bn.parameters()))
        out["bn_ref_y"], out["bn_ref_stats"], out["bn_ref_grads"] = (
            flat([y]), flat(bn.buffers()), flat(g))
    mesh = meshes[f"sp1x{world}"]
    with torch.no_grad():
        for b_, s in zip(bn.buffers(), start):
            b_.copy_(s)
    n = 32 // world
    p = mesh.index("points")
    with points_sharded(mesh.groups["points"]):
        y = bn(x[:, p * n:(p + 1) * n], True)
        g = list(torch.autograd.grad(psum_points((y ** 2).sum()), list(bn.parameters())))
    all_reduce_mean_(g + list(bn.buffers()), mesh)
    out["bn_y"] = flat([all_gather_cat(y.detach(), mesh.groups["points"], dim=1)])
    out["bn_stats"], out["bn_grads"] = flat(bn.buffers()), flat(g)

    # decode: every layout against one device, x_T and the step draws injected
    model = tiny_model()
    gen = torch.Generator().manual_seed(5)
    ctx, mean_pp, var_pp, seg, vid, _ = model.prepare_generation(
        B, torch.zeros(K), torch.ones(B, K), 0, generator=gen)
    rng = np.random.RandomState(6)
    x_t = torch.from_numpy(rng.randn(*mean_pp.shape).astype(np.float32))
    steps = torch.from_numpy(rng.randn(len(model.diff.steps), *mean_pp.shape).astype(np.float32))
    kw = dict(ctx=ctx, variance=var_pp, seg_mask=seg, valid_id=vid, noise=x_t, step_noise=steps,
              ret_traj=False)
    if rank == 0:
        out["decode_ref"] = flat([decode(model, mean_pp, **kw)["pred"]])
    layouts = {f"{nd}x{npts}": (nd, npts) for nd, npts in
               ([(2, 1), (1, 2)] if world == 2 else [(2, 2), (1, 4), (4, 1)])}
    layouts["dp"] = None
    for lname, shape in layouts.items():
        mesh = flat_mesh if shape is None else make_mesh(
            ranks=range(shape[0] * shape[1]), axis_names=("data", "points"), mesh_shape=shape)
        if mesh.member:
            pred = decode(model, mean_pp, mesh=mesh, **kw)["pred"]
            out[f"decode_{lname}"], out[f"decode_{lname}_digest"] = flat([pred]), digest([pred])
    return out


def metrics_suite(rank, world, workdir):
    """Each sweep with its chunks dealt to the ranks, and one rank's."""
    from difffacto_torch.metrics.eval import (compute_all_metrics, emd_cd_paired,
                                              pairwise_cd_emd, pairwise_self_cd_emd,
                                              set_default_eval_mesh)
    from difffacto_torch.parallel import make_mesh

    os.environ["DIFFFACTO_EMD_ITERS"] = "60"
    mesh = make_mesh()
    rng = np.random.RandomState(0)
    clouds = lambda s, n=32: (rng.randn(s, n, 3) * 0.4).astype(np.float32)
    sample, ref, pts, a, b, gen, gref = (clouds(6), clouds(5), clouds(7), clouds(9), clouds(9),
                                         clouds(6), clouds(5))
    mask = (np.arange(32)[None] < 30).astype(np.float32).repeat(6, 0)
    kw = dict(batch_size=4, device="cpu")
    calls = {
        "pairwise": lambda m: pairwise_cd_emd(sample, ref, mask_sample=mask, mesh=m, **kw),
        "self": lambda m: pairwise_self_cd_emd(pts, mesh=m, **kw),
        "paired": lambda m: tuple(emd_cd_paired(a, b, reduced=False, mesh=m, **kw).values()),
        "all": lambda m: tuple(compute_all_metrics(gen, gref, mesh=m, **kw).values()),
    }
    out = {}
    for name, call in calls.items():
        out[f"{name}_mesh"] = np.stack([np.asarray(v, np.float64) for v in call(mesh)])
        out[f"{name}_digest"] = np.frombuffer(
            hashlib.sha256(out[f"{name}_mesh"].tobytes()).digest(), np.uint8)
        if rank == 0:
            out[f"{name}_one"] = np.stack([np.asarray(v, np.float64) for v in call(None)])
    set_default_eval_mesh(mesh)
    try:
        out["default_mesh"] = np.stack(pairwise_self_cd_emd(pts, **kw))
    finally:
        set_default_eval_mesh(None)
    return out


def write_config(path, name, workdir, max_epoch):
    """A config over tests/configs/tiny_gen.py with its own work_dir."""
    with open(path, "w") as f:
        f.write(f"_base_ = {TINY!r}\nname = {name!r}\n"
                f"work_dir = {os.path.join(workdir, name)!r}\nmax_epoch = {max_epoch}\n")
    return path


def runner_state(runner):
    """Parameters, buffers, Adam's count and moments and the CIMLE table."""
    import torch

    opt = runner.state.opt_state
    table = runner.train_loader.dataset.noises
    ids = sorted(table)
    return {"params": flat(runner.model.parameters()), "buffers": flat(runner.model.buffers()),
            "opt": flat([opt["count"].reshape(1).float()] + opt["mu"] + opt["nu"]),
            "table": np.stack([np.asarray(table[i], np.float32) for i in ids]),
            "table_ids": np.asarray(ids), "epoch": np.int64(runner.epoch)}


def runner_suite(rank, world, workdir):
    """``--launcher pytorch`` on gloo: tiny_gen for 2 epochs; the same for 1
    epoch, then resumed for the second; val after each."""
    from difffacto_torch.runner.cli import main

    os.environ["DIFFFACTO_EMD_ITERS"] = "16"
    out = {}
    runs = (("straight", "a", 2), ("first", "b", 1), ("resumed", "b", 2))
    for label, name, epochs in runs:
        cfg = write_config(os.path.join(workdir, f"{label}_rank{rank}.py"), name, workdir, epochs)
        runner = main(["--config-file", cfg, "--task", "train", "--launcher", "pytorch", "--cpu"])
        state = runner_state(runner)
        for k, v in state.items():
            out[f"{label}_{k}"] = v
        out[f"{label}_digest"] = digest([__import__("torch").from_numpy(state[k])
                                         for k in ("params", "buffers", "opt", "table")])
    metrics = runner.val()
    out["val_metrics"] = np.asarray([metrics[k] for k in sorted(metrics)], np.float64)
    out["val_digest"] = np.frombuffer(hashlib.sha256(out["val_metrics"].tobytes()).digest(),
                                      np.uint8)
    return out


def card_model(device):
    """gen_chair at full width with depth cut (denoiser 2, aligner 1, flows
    2), stage 1, dropout 0, float32 as the Runner builds it: the training
    trunk kernels B2/B3 run its denoiser on the card."""
    from difffacto_torch import Config, MODELS, build_from_cfg

    mcfg = Config(os.path.join(ROOT, "configs", "gen_chair.py")).model.dump()
    mcfg.update(npoints=512, num_timesteps=10, ret_traj=False, gen=False)
    mcfg["encoder"].update(gen=False, latent_flow_depth=2)
    mcfg["encoder"]["part_aligner"]["depth"] = 1
    mcfg["diffusion"]["net"].update(depth=2, dropout=0.0)
    return build_from_cfg(mcfg, MODELS, device=device, seed=0)


def card_suite(rank, world, workdir):
    """On the card: at world size 1 the mesh step (NCCL) against the plain
    step's update of the same local gradients, taken on a second model just
    before the all-reduce (the same tensors: a norm's summation order may
    follow their memory layout); at world size 2 (gloo, ranks sharing the
    card) the dp step against the two slices' arithmetic."""
    import torch

    from difffacto_torch.parallel import (build_optimizer_from_cfg, init_train_state, make_mesh,
                                          make_train_step, replicate, shard_batch)
    from difffacto_torch.utils import trace

    dev = torch.device("cuda", rank % torch.cuda.device_count())
    mesh = make_mesh()
    model = replicate(mesh, card_model(dev))
    batch = tiny_batch(model, seed=21, b=4, n=512)
    batch.pop("part_code_eps")
    tx = build_optimizer_from_cfg(dict(type="Adam", lr=1e-3, weight_decay=0.0), max_norm=10.0)
    step = make_train_step(model, tx, mesh=mesh)
    state = init_train_state(model, tx)
    out = {"before": flat(model.parameters())}
    ref = card_model(dev) if rank == 0 else None
    if world == 1:
        local = step.local
        plain = make_train_step(ref, tx)
        ref_start = [b.clone() for b in ref.buffers()]

        def local_then_plain_update(*a):
            total, metrics, grads = local(*a)
            with torch.no_grad():
                for b, s in zip(ref.buffers(), model.buffers()):
                    b.copy_(s)
            _, rm = plain.apply(init_train_state(ref, tx), total, dict(metrics), grads, ref_start)
            out.update(ref_total=np.float64(rm["total_loss"]), ref_gnorm=np.float64(rm["grad_norm"]))
            return total, metrics, grads

        step.local = local_then_plain_update
    before = trace.counters()
    _, m = step(state, tensors(shard_batch(mesh, batch), dev), 0, 0)
    after = trace.counters()
    out["launches"] = np.asarray([after.get(k, 0) - before.get(k, 0) for k in (
        "fused_trunk_train_fwd.launches", "fused_trunk_train_bwd.launches")])
    out["params"], out["stats"] = flat(model.parameters()), flat(model.buffers())
    out["total"], out["gnorm"] = np.float64(m["total_loss"]), np.float64(m["grad_norm"])
    out["digest"] = digest(list(model.parameters()) + list(model.buffers()))
    if world == 1:
        out.update(ref_params=flat(ref.parameters()), ref_stats=flat(ref.buffers()))
    elif rank == 0:
        ref_out = manual_dp_step(ref, tx, batch, world, dev)
        out.update({f"ref_{k}": np.asarray(v) for k, v in ref_out.items()})
    return out


def spare_suite(rank, world, workdir):
    """3 ranks and a batch of 4: the data mesh takes ranks 0 and 1 and rank 2
    idles (1 epoch, no val)."""
    from difffacto_torch.runner.cli import main

    cfg = write_config(os.path.join(workdir, f"spare_rank{rank}.py"), "spare", workdir, 1)
    runner = main(["--config-file", cfg, "--task", "train", "--launcher", "pytorch", "--cpu",
                   "--no_eval"])
    out = {"spare": np.int64(runner.spare), "epoch": np.int64(runner.epoch)}
    if not runner.spare:
        out["digest"] = digest(list(runner.model.parameters()))
    return out


def pointctx_suite(rank, world, workdir):
    """The base ``PartEncoder``'s per-point ctx with ``PointwiseNet`` on 2
    ranks: decode under a points axis raises, under a data axis it matches
    one device; the eval-mode loss and gradients under the points axis match
    one device."""
    import torch

    from difffacto_torch.models import decode
    from difffacto_torch.parallel import make_mesh

    model = tiny_model(
        encoder=dict(type="PartEncoder", fit_loss_type=0, include_z=True,
                     include_part_code=False, include_params=True,
                     part_aligner=dict(type="PartAligner", n_class=K, width=16)),
        net=dict(type="PointwiseNet", point_dim=3, context_dim=K * 16 + 6, hidden=(16, 32, 16)))
    with torch.no_grad():  # the N(0, 0.25^2) heads put exp(logvar) out of range
        for head in (model.encoder_mod.aligner.fc4_m, model.encoder_mod.aligner.fc4_v):
            head.kernel.mul_(0.01)
    out = {}
    gen = torch.Generator().manual_seed(5)
    ctx, mean_pp, var_pp, seg, vid, _ = model.prepare_generation(
        B, torch.zeros(K), torch.ones(B, K), 0, generator=gen)
    rng = np.random.RandomState(6)
    x_t = torch.from_numpy(rng.randn(*mean_pp.shape).astype(np.float32))
    steps = torch.from_numpy(rng.randn(len(model.diff.steps), *mean_pp.shape).astype(np.float32))
    kw = dict(ctx=ctx, variance=var_pp, seg_mask=seg, valid_id=vid, noise=x_t, step_noise=steps,
              ret_traj=False)
    if rank == 0:
        out["decode_ref"] = flat([decode(model, mean_pp, **kw)["pred"]])
    points = make_mesh(axis_names=("data", "points"), mesh_shape=(1, world))
    try:
        decode(model, mean_pp, mesh=points, **kw)
        out["points_raises"] = np.int64(0)
    except ValueError:
        out["points_raises"] = np.int64(1)
    data = make_mesh(axis_names=("data", "points"), mesh_shape=(world, 1))
    out["decode_dp"] = flat([decode(model, mean_pp, mesh=data, **kw)["pred"]])
    batch = tiny_batch(model, seed=11)
    if rank == 0:
        total, grads = loss_and_grads(model, batch, False)
        out["one_total"], out["one_grads"] = flat([total]), flat(grads)
    total, grads = loss_and_grads(model, batch, False, points)
    out["sp_total"], out["sp_grads"] = flat([total]), flat(grads)
    return out


SUITES = {"parallel": parallel_suite, "metrics": metrics_suite, "runner": runner_suite,
          "spare": spare_suite, "pointctx": pointctx_suite,
          "card": card_suite}


def main(argv):
    suite, rank, world, workdir, backend = argv[0], int(argv[1]), int(argv[2]), argv[3], argv[4]
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    if suite == "card":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    store = dist.FileStore(os.path.join(workdir, f"{suite}.store"), world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world)
    try:
        out = SUITES[suite](rank, world, workdir)
        if rank:  # the others keep what says they agree with rank 0, and their counts
            out = {k: v for k, v in out.items()
                   if k.endswith("digest") or k in ("launches", "spare", "epoch")}
        np.savez(os.path.join(workdir, f"{suite}_rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
