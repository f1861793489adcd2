"""The JAX package's ``.msgpack`` checkpoints in the port, on the CPU.

The codec (``utils/jax_checkpoint.py``) against ``flax.serialization`` both
ways; then a checkpoint the JAX ``Runner`` writes after two epochs of
``tests/configs/tiny_gen.py``, read by the port's ``Runner`` as
``resume_path`` (weights, BatchNorm statistics, Adam's moments and count, the
step, the epoch: bit for bit) and as ``pretrained_weights`` with
``model_only``. On those weights ``val`` and ``val_gen`` are held against the
JAX ``Runner``'s with every draw of the generation injected on both sides
(the flow input, the CIMLE noise, x_T and the step draws), and one resumed
training step's losses against the JAX loss (rtol 1e-3, as
``tests/test_torch_runner.py`` holds the first step). A checkpoint with a
missing, a left-over or a reshaped entry raises; a resume carries no CIMLE
table and re-caches at the next interval; ``tools/eval_ckpt_curve_torch.py``
scores a ``.msgpack``.
"""

import copy
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import difffacto_tpu.runner.runner as jax_runner_mod
from difffacto_tpu.config import Config as JaxConfig
from difffacto_tpu.models.anchor_diff import AnchorDiffAE as JaxAnchorDiffAE
from difffacto_tpu.models.anchor_diff import _model_fn, build_diffusion
from difffacto_tpu.runner import Runner as JaxRunner
from difffacto_tpu.runner.runner import device_batch as jax_device_batch
from difffacto_torch import Config, Runner
from difffacto_torch.models import ensure_attn_maps
from difffacto_torch.runner import evaluation as port_evaluation
from difffacto_torch.runner import runner as port_runner_mod
from difffacto_torch.runner.runner import device_batch
from difffacto_torch.utils import jax_checkpoint as jc
from difffacto_torch.utils.jax_params import export_jax_train_state, flatten_jax_tree

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "tests", "configs", "tiny_gen.py")


@pytest.fixture(scope="module", autouse=True)
def _fast_emd():
    old = os.environ.get("DIFFFACTO_EMD_ITERS")
    os.environ["DIFFFACTO_EMD_ITERS"] = "16"
    yield
    if old is None:
        os.environ.pop("DIFFFACTO_EMD_ITERS", None)
    else:
        os.environ["DIFFFACTO_EMD_ITERS"] = old


def leaves(tree):
    """{path: float64 or int numpy value} of a tree's leaves, bfloat16 ones
    (a torch tensor from the port's codec, a jax or ml_dtypes array from
    flax) widened to float32 first."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}")
            if not node:
                out[path] = "{}"
            return
        if isinstance(node, torch.Tensor):
            node = node.float().numpy()
        arr = np.asarray(node)
        if arr.dtype.name == "bfloat16":
            arr = arr.astype(np.float32)
        out[path] = (arr.dtype.name, arr.shape, arr.tolist())

    walk(tree, "")
    return out


TREES = {
    "bfloat16": lambda: {"w": jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3) / 3},
    "int32_0d": lambda: {"step": np.asarray(7, np.int32), "count": np.int32(3)},
    "empty_dict": lambda: {"opt_state": {"0": {}, "1": {"count": np.asarray(2, np.int32)}}},
    "tuple": lambda: serialization.to_state_dict(
        (np.ones(3, np.float32), (np.zeros((0, 2), np.float32), np.float64(2.5)))),
}


@pytest.mark.parametrize("kind", sorted(TREES))
def test_codec_matches_flax_both_ways(kind):
    """flax's bytes decode to the same leaves (bfloat16 as a torch tensor);
    what the port writes flax restores to the same leaves and dtypes, and is
    flax's own bytes."""
    tree = TREES[kind]()
    flax_bytes = serialization.msgpack_serialize(tree)
    ours = jc.unpack(flax_bytes)
    assert leaves(ours) == leaves(tree)
    if kind == "bfloat16":
        assert ours["w"].dtype == torch.bfloat16
    back = serialization.msgpack_restore(jc.pack(ours))
    assert leaves(back) == leaves(tree)
    assert jc.pack(ours) == flax_bytes
    with pytest.raises(ValueError):
        jc.unpack(flax_bytes[:-1])


# ------------------------------------------------------ the JAX Runner's file
@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX Runner after two epochs of tiny_gen (no CIMLE cache, no val),
    and the path of the checkpoint it wrote."""
    cfg = JaxConfig(TINY)
    cfg.work_dir = str(tmp_path_factory.mktemp("jax") / "run")
    cfg.update(dict(cimle_cache_interval=None, eval_interval=None))
    jr = JaxRunner(cfg=cfg)
    jr.run()
    path = os.path.join(cfg.work_dir, "checkpoints", "ckpt_2.msgpack")
    assert os.path.exists(path)
    return jr, path


def port_cfg(tmp_path, name="port", **changes):
    cfg = Config(TINY)
    cfg.work_dir = str(tmp_path / name)
    for k, v in changes.items():
        cfg[k] = cfg.dfs(v)
    return cfg


def test_file_round_trips_through_the_codec(jax_run):
    """The JAX Runner's checkpoint decodes, and encodes to the same bytes."""
    _, path = jax_run
    data = open(path, "rb").read()
    tree, meta = jc.read_jax_checkpoint(path)
    assert jc.pack(tree) == data and meta["epoch"] == 2 and meta["iter"] == 4
    assert leaves(tree) == leaves(serialization.msgpack_restore(data))


def test_resume_from_a_jax_checkpoint(jax_run, tmp_path):
    """``resume_path`` names the .msgpack: every parameter, BatchNorm
    statistic, Adam moment, the count and the step equal the JAX state's,
    bit for bit; epoch and iteration from its meta; no CIMLE table. Written
    back in the JAX layout it is the same tree."""
    jr, path = jax_run
    pr = Runner(cfg=port_cfg(tmp_path, resume_path=path), device="cpu")
    assert (pr.epoch, pr.iter, pr.state.step) == (2, 4, 4)
    assert float(pr.state.opt_state["count"]) == 4.0
    assert pr.train_loader.dataset.noises == {}
    names = [n for n, _ in pr.model.named_parameters()]
    want = flatten_jax_tree(jax.device_get(jr.state.params))
    for n, p in pr.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[n], err_msg=n)
    stats = flatten_jax_tree(jax.device_get(jr.state.batch_stats))
    for n, b in pr.model.named_buffers():
        np.testing.assert_array_equal(b.numpy(), stats[n], err_msg=n)
    adam = jax.device_get(jr.state.opt_state)[1][0]
    for key in ("mu", "nu"):
        moments = flatten_jax_tree(getattr(adam, key))
        for n, t in zip(names, pr.state.opt_state[key]):
            np.testing.assert_array_equal(t.numpy(), moments[n], err_msg=f"{key} {n}")
    tree, _ = jc.read_jax_checkpoint(path)
    assert leaves(export_jax_train_state(pr.state, pr.tx)) == leaves(tree)
    log = open(os.path.join(pr.work_dir, "log.txt")).read()
    assert "holds no CIMLE table" in log


def test_pretrained_weights_model_only(jax_run, tmp_path):
    """``pretrained_weights`` with ``model_only``: the weights and statistics
    alone; step, epoch, count and moments stay fresh."""
    jr, path = jax_run
    pr = Runner(cfg=port_cfg(tmp_path, pretrained_weights=path, model_only=True), device="cpu")
    assert (pr.epoch, pr.iter, pr.state.step) == (0, 0, 0)
    assert float(pr.state.opt_state["count"]) == 0.0
    assert all(not t.any() for t in pr.state.opt_state["mu"])
    want = flatten_jax_tree(jax.device_get(jr.state.params))
    for n, p in pr.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[n], err_msg=n)


def generation_draws(i, B, model):
    """Call ``i``'s flow input, x_T and step draws, from a RandomState of its own."""
    rng = np.random.RandomState(100 + i)
    zdim = model.encoder["encoder"]["zdim"]
    return (rng.randn(B, model.num_anchors, zdim).astype(np.float32),
            rng.randn(B, model.npoints, 3).astype(np.float32),
            rng.randn(model.num_timesteps, B, model.npoints, 3).astype(np.float32))


def jax_generation_fns(model):
    """The JAX prepare (flow input injected) and reverse chain (x_T and the
    step draws injected), each jitted once for the test's batch shape."""

    def prepare(m, z, valid, fixed, epoch):
        enc = m.encoder_mod
        pc = enc.flow(z * math.sqrt(enc.prior_var), reverse=True)
        ctx, mean_pp, logvar_pp, seg, vid, lat = enc.sample_latents(
            z.shape[0], m.npoints, fixed_id=fixed, valid_id=valid, epoch=epoch,
            K=m.cimle_sample_num, part_code=pc)
        return ctx, mean_pp, jnp.exp(logvar_pp), seg, vid, lat

    diff = build_diffusion(model.diffusion, model.num_timesteps)
    prep = jax.jit(lambda v, *a: model.apply(v, *a, method=prepare,
                                             rngs={"sample": jax.random.PRNGKey(7)}))
    chain = jax.jit(lambda v, *a: diff.p_sample_loop(
        _model_fn(model, v), jax.random.PRNGKey(0), a[0], ctx=a[1], variance=a[2],
        seg_mask=a[3], valid_id=a[4], noise=a[5], step_noise=a[6])["pred"])
    return prep, chain


def inject_generation(monkeypatch):
    """Replace the generation of both Runners (val and val_gen) by the same
    function with every draw given: the JAX side records the CIMLE noise its
    aligner takes, which the port's call of the same index then receives."""
    jax_calls, port_calls, fns = [], [], {}

    def jax_gen(model, variables, rng, sample_num, valid_id=None, fixed_id=None, epoch=0,
                ret_traj=False, mesh=None):
        z, x_T, steps = generation_draws(len(jax_calls), sample_num, model)
        valid = (jnp.ones((sample_num, model.num_anchors)) if valid_id is None
                 else jnp.asarray(valid_id, jnp.float32))
        fixed = jnp.zeros(model.num_anchors) if fixed_id is None else jnp.asarray(fixed_id)
        prep, chain = fns.setdefault(id(model), jax_generation_fns(model))
        ctx, mean, var, seg, vid, lat = jax.tree_util.tree_map(
            np.array, prep(variables, jnp.asarray(z), valid, fixed, jnp.asarray(epoch)))
        pred = np.asarray(chain(variables, *[jnp.asarray(a) for a in
                                             (mean, ctx, var, seg, vid, x_T, steps)]))
        jax_calls.append(dict(noise=lat[3], pred=pred))
        return dict(pred=pred, seg_mask=seg, valid_id=vid, anchors=mean, variance=var,
                    latents=lat)

    def port_gen(model, sample_num, valid_id=None, fixed_id=None, epoch=0, ret_traj=False,
                 generator=None, **_):
        i = len(port_calls)
        z, x_T, steps = generation_draws(i, sample_num, model)
        out = real_port(model, sample_num, valid_id=valid_id, fixed_id=fixed_id, epoch=epoch,
                        ret_traj=ret_traj, z=torch.from_numpy(z),
                        cimle_noise=torch.from_numpy(jax_calls[i]["noise"]),
                        noise=torch.from_numpy(x_T), step_noise=torch.from_numpy(steps))
        port_calls.append(out["pred"].float().numpy())
        return out

    real_port = port_runner_mod.sample_generation
    monkeypatch.setattr(jax_runner_mod, "sample_generation", jax_gen)
    monkeypatch.setattr(port_runner_mod, "sample_generation", port_gen)
    monkeypatch.setattr(port_evaluation, "sample_generation", port_gen)
    return jax_calls, port_calls


def test_val_and_val_gen_match_jax_on_its_weights(jax_run, tmp_path, monkeypatch):
    """val (2 batches of 4) and val_gen (8 shapes in batches of 4) of the port
    resumed from the JAX checkpoint against the JAX Runner that wrote it,
    the same draws on both sides: each generated batch within 1e-4 (as
    tests/test_torch_generation.py holds the chain), every Chamfer-side metric
    within rtol 1e-3 and every EMD-side one within rtol 0.03, as
    tests/test_torch_eval.py holds the auction EMD (a near-tie may go to
    another object; the auction is eps-optimal either way)."""
    jr, path = jax_run
    pr = Runner(cfg=port_cfg(tmp_path, resume_path=path), device="cpu")
    jax_calls, port_calls = inject_generation(monkeypatch)
    want = {**{k: float(v) for k, v in jr.val().items()},
            **{f"gen/{k}": float(v) for k, v in jr.generate_samples(num_gen=8, batch=4).items()}}
    got = {**pr.val(),
           **{f"gen/{k}": float(v) for k, v in pr.generate_samples(num_gen=8, batch=4).items()}}
    assert len(jax_calls) == len(port_calls) == 4
    for j, p in zip(jax_calls, port_calls):
        np.testing.assert_allclose(p, j["pred"], rtol=1e-4, atol=1e-4)
    assert set(got) == set(want) and len(want) == 24
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0.03 if "EMD" in k else 1e-3,
                                   atol=1e-5, err_msg=k)


def test_resumed_step_loss_matches_jax(jax_run, tmp_path):
    """One step of the resumed port Runner on its first batch (the pre-cache
    noise of width 1, as a resume without a table trains), t and the
    diffusion noise injected and the part-code draw recovered from JAX's
    encoder under the JAX step's rngs: every loss entry within rtol 1e-3 of
    the JAX loss on the checkpoint's weights."""
    jr, path = jax_run
    pr = Runner(cfg=port_cfg(tmp_path, resume_path=path), device="cpu")
    batch = next(iter(pr.train_loader))
    B, N = batch["ref"].shape[:2]
    assert batch["noise"].shape == (B, 1) and not batch["noise"].any()
    rng = np.random.RandomState(0)
    inject = {"diffusion_t": rng.randint(0, pr.model.num_timesteps, (B,)).astype(np.int32),
              "diffusion_noise": rng.randn(B, N, 3).astype(np.float32)}
    from difffacto_tpu.models.anchor_diff import ensure_attn_maps as jax_maps

    jbatch = jax_maps({**{k: jnp.asarray(v) for k, v in jax_device_batch(batch).items()},
                       **{k: jnp.asarray(v) for k, v in inject.items()}})
    key = jax.random.PRNGKey(pr.seed + 7919)
    r_sample, r_dropout = jax.random.split(jax.random.fold_in(key, pr.state.step))
    rngs = {"sample": r_sample, "dropout": r_dropout}

    def draw(m, b):
        latents = m.encode(b, epoch=2, train=True)[5]
        means, logvars = m.encoder_mod.get_part_code(b["input"], b["ref_attn_map"], train=True)
        return (latents[0] - means) / jnp.exp(0.5 * logvars)

    @jax.jit
    def draw_and_loss(variables, b, rngs):
        eps, _ = jr.model.apply(variables, b, method=draw, rngs=rngs, mutable=["batch_stats"])
        loss, _ = jr.model.apply(variables, b, 2, True, method=JaxAnchorDiffAE.loss, rngs=rngs,
                                 mutable=["batch_stats"])
        return eps, loss

    eps, want = draw_and_loss(jr.state.variables(), jbatch, rngs)
    db = device_batch(batch, "cpu", pr._slim_train)
    db.update({k: torch.from_numpy(v) for k, v in inject.items()})
    db["part_code_eps"] = torch.from_numpy(np.array(eps))
    pr.state, met = pr._step_fn(pr.state, ensure_attn_maps(db), pr.seed + 7919, pr.epoch)
    assert float(met["skipped_nonfinite"]) == 0.0 and pr.state.step == 5
    for k, v in want.items():
        np.testing.assert_allclose(float(met[k]), float(np.mean(v)), rtol=1e-3, atol=1e-5,
                                   err_msg=k)


def corrupt(tree, case):
    tree = copy.deepcopy(tree)
    params = tree["params"]["net"]
    if case == "missing":
        del params["proj_out"]["bias"]
    elif case == "extra":
        params["proj_out"]["gain"] = np.ones(3, np.float32)
    elif case == "shape":
        params["proj_out"]["bias"] = np.zeros(4, np.float32)
    else:  # an Adam moment missing
        del tree["opt_state"]["1"]["0"]["nu"]["net"]["proj_out"]
    return tree


@pytest.mark.parametrize("case,error", [("missing", KeyError), ("extra", KeyError),
                                        ("shape", ValueError), ("moment", KeyError)])
@pytest.mark.parametrize("model_only", [False, True], ids=["resume", "model_only"])
def test_a_corrupt_checkpoint_raises(jax_run, tmp_path, case, error, model_only):
    """A missing or left-over parameter and a wrong shape raise whether the
    optimizer is read or not; a missing moment raises where it is read and is
    not looked at with ``model_only``."""
    _, path = jax_run
    tree, meta = jc.read_jax_checkpoint(path)
    bad = jc.write_jax_checkpoint(str(tmp_path / "bad"), 2, corrupt(tree, case), meta)
    key = "pretrained_weights" if model_only else "resume_path"
    cfg = port_cfg(tmp_path, **{key: bad, "model_only": model_only})
    if case == "moment" and model_only:
        assert Runner(cfg=cfg, device="cpu").state.step == 0
        return
    with pytest.raises(error):
        Runner(cfg=cfg, device="cpu")


def test_resume_without_a_table_recaches(jax_run, tmp_path):
    """The JAX checkpoint holds no CIMLE table: the port resumes with none,
    trains epoch 2 on the pre-cache noise after re-caching at the interval
    (cimle_cache_interval 2), and ends with one noise of width 32 a shape."""
    _, path = jax_run
    pr = Runner(cfg=port_cfg(tmp_path, resume_path=path, max_epoch=3), device="cpu")
    pr.no_eval = True
    assert pr.train_loader.dataset.noises == {}
    pr.run()
    table = pr.train_loader.dataset.noises
    assert pr.epoch == 3 and sorted(table) == list(range(8))
    assert all(v.shape == (32,) and np.isfinite(v).all() for v in table.values())


def test_eval_ckpt_curve_scores_a_jax_checkpoint(jax_run, tmp_path, monkeypatch):
    """``tools/eval_ckpt_curve_torch.py --ckpts <ckpt_2.msgpack> --cpu``: one
    row at epoch 2, twelve finite metrics."""
    _, path = jax_run
    monkeypatch.chdir(tmp_path)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import eval_ckpt_curve_torch
    finally:
        sys.path.pop(0)
    rows = eval_ckpt_curve_torch.main(["--config-file", TINY, "--ckpts", path, "--gen_num", "4",
                                       "--batch", "4", "--cpu"])
    assert len(rows) == 1 and rows[0]["epoch"] == 2 and rows[0]["ckpt"] == "ckpt_2.msgpack"
    metrics = {k: v for k, v in rows[0].items() if k not in ("ckpt", "epoch", "steps", "eval_s")}
    assert len(metrics) == 12 and all(np.isfinite(v) for v in metrics.values())
