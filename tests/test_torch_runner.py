"""The port's ``Runner`` and CLI on the CPU, with ``tests/configs/tiny_gen.py``.

The counterparts of ``tests/test_runner.py`` (two epochs end to end, the
final checkpoint, the stage-1 -> stage-2 transition, val_gen), then the port
against the JAX package on the same weights (bridged with
``load_jax_params`` from a JAX ``Runner``): the trainable filter and the
per-path learning-rate scales, the learning rate of each iteration, the CIMLE
table with JAX's candidates injected, and the loss of one step. Port only: a
resumed run equals an uninterrupted one bit for bit, explicit absent
checkpoints raise, and ``tools/run_net_torch.py --cpu`` runs.
"""

import copy
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difffacto_tpu.config import Config as JaxConfig
from difffacto_tpu.data.synthetic import SyntheticPart as JaxSyntheticPart
from difffacto_tpu.models.anchor_diff import AnchorDiffAE as JaxAnchorDiffAE
from difffacto_tpu.models.anchor_diff import ensure_attn_maps as jax_maps
from difffacto_tpu.models.anchor_diff import select_best_noise as jax_select_best_noise
from difffacto_tpu.parallel import build_optimizer_from_cfg as jax_build_optimizer
from difffacto_tpu.runner import Runner as JaxRunner
from difffacto_tpu.runner.runner import device_batch as jax_device_batch
from difffacto_tpu.utils.gaussian import reparameterize_gaussian
from difffacto_torch import Config, Runner, load_jax_params
from difffacto_torch.models import ensure_attn_maps
from difffacto_torch.runner.runner import device_batch
from difffacto_torch.utils.jax_params import flatten_jax_tree

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "tests", "configs", "tiny_gen.py")


@pytest.fixture(scope="module", autouse=True)
def _fast_emd():
    """The metric values here are checks of finiteness, not goldens: the CPU
    auction EMD runs 16 iterations, as tests/test_runner.py sets it."""
    old = os.environ.get("DIFFFACTO_EMD_ITERS")
    os.environ["DIFFFACTO_EMD_ITERS"] = "16"
    yield
    if old is None:
        os.environ.pop("DIFFFACTO_EMD_ITERS", None)
    else:
        os.environ["DIFFFACTO_EMD_ITERS"] = old


def tiny(tmp_path, name="run", **changes):
    cfg = Config(TINY)
    cfg.work_dir = str(tmp_path / name)
    for k, v in changes.items():
        cfg[k] = cfg.dfs(v)
    return cfg


def runner(cfg, no_eval=False):
    r = Runner(cfg=cfg, device="cpu")
    r.no_eval = no_eval
    return r


def train_state(r):
    """Every tensor a checkpoint holds, cloned, by name."""
    out = {f"p/{n}": p.detach().clone() for n, p in r.model.named_parameters()}
    out.update({f"b/{n}": b.clone() for n, b in r.model.named_buffers()})
    names = [n for n, _ in r.model.named_parameters()]
    for key in ("mu", "nu"):
        out.update({f"{key}/{n}": t.clone() for n, t in zip(names, r.state.opt_state[key])})
    out["count"] = r.state.opt_state["count"].clone()
    out["step"] = torch.tensor(r.state.step)
    return out


def assert_states_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_runner_end_to_end(tmp_path):
    """Two epochs: CIMLE cache at epoch 0, val and checkpoint at epoch 2; the
    table, the val npz and the scalar log are written."""
    r = runner(tiny(tmp_path))
    r.run()
    assert r.epoch == 2 and r.iter == 4 and r.state.step == 4
    ckpts = sorted(os.listdir(os.path.join(r.work_dir, "checkpoints")))
    assert ckpts == ["ckpt_2.meta.json", "ckpt_2.pt"]
    meta = json.load(open(os.path.join(r.work_dir, "checkpoints", "ckpt_2.meta.json")))
    assert meta["epoch"] == 2 and meta["iter"] == 4 and meta["config"]["name"] == "tiny_gen"
    noises = r.train_loader.dataset.noises
    assert sorted(noises) == list(range(8))
    assert all(n.shape == (32,) and np.isfinite(n).all() for n in noises.values())
    val = np.load(os.path.join(r.work_dir, "val", "gen_fixed0000_2.npz"))
    assert val["pred"].shape == (4, 64, 3) and np.isfinite(val["pred"]).all()
    recs = [json.loads(line) for line in open(os.path.join(r.work_dir, "scalars.jsonl"))]
    steps = [x for x in recs if "total_loss" in x]
    assert [x["step"] for x in steps] == [1, 2, 3, 4]
    assert all(np.isfinite(x["total_loss"]) and x["skipped_nonfinite"] == 0 for x in steps)
    assert any("gen_fixed0000/1-NN-CD-acc" in x for x in recs)
    for f in ("config.yaml", "log.txt"):
        assert os.path.exists(os.path.join(r.work_dir, f))


def test_final_checkpoint_without_interval(tmp_path):
    r = runner(tiny(tmp_path, checkpoint_interval=None, max_epoch=1, cimle=False), no_eval=True)
    r.run()
    assert os.listdir(os.path.join(r.work_dir, "checkpoints")) != []
    assert os.path.exists(os.path.join(r.work_dir, "checkpoints", "ckpt_1.pt"))


def test_resume_equals_an_uninterrupted_run(tmp_path):
    """Two epochs straight, against one epoch, a new runner that resumes
    from its final checkpoint, then one more epoch: parameters, buffers,
    moments, count and step bit for bit (the CIMLE table of epoch 0 travels
    in the checkpoint). The checkpoint is what torch.load(weights_only=True)
    reads."""
    straight = runner(tiny(tmp_path, "straight", checkpoint_interval=None), no_eval=True)
    straight.run()
    first = runner(tiny(tmp_path, "split", checkpoint_interval=None, max_epoch=1), no_eval=True)
    first.run()
    ckpt = torch.load(os.path.join(first.work_dir, "checkpoints", "ckpt_1.pt"), weights_only=True)
    assert set(ckpt) == {"params", "batch_stats", "opt_state", "step", "noise_table"}
    resumed = runner(tiny(tmp_path, "split", checkpoint_interval=None), no_eval=True)
    assert resumed.epoch == 1 and resumed.iter == 2 and resumed.state.step == 2
    assert_states_equal(train_state(resumed), train_state(first))
    assert sorted(resumed.train_loader.dataset.noises) == list(range(8))
    resumed.run()
    assert resumed.epoch == 2
    assert_states_equal(train_state(resumed), train_state(straight))


def test_missing_and_reference_checkpoints_raise(tmp_path):
    with pytest.raises(FileNotFoundError, match="resume_path"):
        runner(tiny(tmp_path, "a", resume_path=str(tmp_path / "absent.pt")))
    # a reference .pth loads (tests/test_torch_pth.py); one that is absent raises
    with pytest.raises(FileNotFoundError, match="chair.pth"):
        runner(tiny(tmp_path, "b", pretrained_weights=str(tmp_path / "pretrained" / "chair.pth")))


def test_two_stage_transition(tmp_path):
    """A stage-1 checkpoint without the aligner restores model_only into the
    full model (aligner left at its initial weights); stage 2 then moves the
    aligner alone, every other parameter unmoved exactly."""
    cfg1 = tiny(tmp_path, "stage1", cimle=False, cimle_cache_interval=None)
    cfg1.model["encoder"]["part_aligner"] = None
    cfg1.model["encoder"]["use_gt_params"] = True
    cfg1.model["cimle"] = False
    r1 = runner(cfg1, no_eval=True)
    r1.run()
    ckpt = os.path.join(r1.work_dir, "checkpoints", "ckpt_2.pt")
    s1 = {n: p.detach().clone() for n, p in r1.model.named_parameters()}

    r2 = runner(tiny(tmp_path, "stage2", model_only=True, resume_path=ckpt, train_aligner=True),
                no_eval=True)
    assert r2.epoch == 0 and r2.state.step == 0
    s2 = {n: p.detach().clone() for n, p in r2.model.named_parameters()}
    carried = [n for n in s2 if "aligner" not in n.split(".")]
    assert carried and all(torch.equal(s1[n], s2[n]) for n in carried)
    assert not any("aligner" in n.split(".") for n in s1)
    r2.run()
    assert r2.epoch == 2
    after = dict(r2.model.named_parameters())
    moved = {n for n in s2 if not torch.equal(after[n], s2[n])}
    assert moved and all("aligner" in n.split(".") for n in moved)


def test_val_gen_protocol(tmp_path):
    r = runner(tiny(tmp_path, max_epoch=0))
    metrics = r.generate_samples(num_gen=8, batch=4)
    assert len(metrics) == 12 and all(np.isfinite(v) for v in metrics.values())
    assert r._ref_self_cache  # the ref-vs-ref block is kept for the runner's life


def _spy_generation(monkeypatch):
    """Record the aligner noise and the output of every generation batch of
    val_gen (``runner/evaluation.py``)."""
    import difffacto_torch.runner.evaluation as ev

    calls = []
    real = ev.sample_generation

    def spy(*args, **kw):
        out = real(*args, **kw)
        calls.append(dict(kw, noise=out["latents"][3], pred=out["pred"]))
        return out

    monkeypatch.setattr(ev, "sample_generation", spy)
    return calls


@pytest.mark.parametrize("epoch", [1, 5])
def test_val_gen_generates_at_the_runners_epoch(tmp_path, monkeypatch, epoch):
    """C6: val_gen generates at the runner's epoch, as the JAX Runner passes
    ``epoch=self.epoch`` (``difffacto_tpu/runner/runner.py:567-575``). With the
    aligner's ``cimle_start_epoch=3`` the CIMLE noise is zero at epoch 1 and
    drawn at epoch 5; the samples equal ``sample_generation`` at that epoch on
    the same generator."""
    from difffacto_torch.runner.evaluation import generate_samples

    cfg = tiny(tmp_path, max_epoch=0)
    cfg.model["encoder"]["part_aligner"]["cimle_start_epoch"] = 3
    r = runner(cfg)
    r.epoch = epoch
    calls = _spy_generation(monkeypatch)
    r.generate_samples(num_gen=4, batch=4)
    noise = calls[0]["noise"].abs().max().item()
    assert (noise > 1.0) if epoch >= 3 else (noise == 0.0)
    gen = torch.Generator().manual_seed(r.seed + 17)
    from difffacto_torch.data.dataset_utils import sample_part_presence

    presence = sample_part_presence(np.random.RandomState(r.seed), 4, 4)
    want = prunner_sample(r.model, presence, epoch, gen)
    np.testing.assert_array_equal(generate_samples(r.model, 4, 4, seed=r.seed, epoch=epoch), want)


def prunner_sample(model, presence, epoch, generator):
    from difffacto_torch.models import sample_generation

    out = sample_generation(model, len(presence), valid_id=torch.as_tensor(presence),
                            epoch=epoch, generator=generator)
    return out["pred"].float().numpy()


@pytest.mark.parametrize("npoints", [64, 80])
def test_val_gen_without_cimle_keeps_every_point(tmp_path, monkeypatch, npoints):
    """C7: a model without CIMLE makes one hypothesis a shape, and val_gen
    takes K = 1 for it whatever ``cimle_sample_num`` says
    (``difffacto_tpu/runner/runner.py:576``): (4, npoints, 3) out, each shape
    the generated one, at npoints = 64 (which raised) and 80 (which kept 8
    points)."""
    from difffacto_torch.runner.evaluation import generate_samples

    cfg = tiny(tmp_path, max_epoch=0, cimle=False)
    cfg.model["cimle"] = False
    cfg.model["cimle_sample_num"] = 10
    cfg.model["npoints"] = npoints
    cfg.model["encoder"]["part_aligner"]["cimle"] = False
    r = runner(cfg)
    calls = _spy_generation(monkeypatch)
    gen = generate_samples(r.model, num_gen=4, batch=4, seed=r.seed)
    assert gen.shape == (4, npoints, 3)
    np.testing.assert_array_equal(gen, calls[0]["pred"].float().numpy())


# ------------------------------------------------------------ against JAX
@pytest.fixture(scope="module")
def jax_pair(tmp_path_factory):
    """A JAX Runner on tiny_gen and the port's Runner on the same weights."""
    tmp = tmp_path_factory.mktemp("pair")
    jcfg = JaxConfig(TINY)
    jcfg.work_dir = str(tmp / "jax")
    jr = JaxRunner(cfg=jcfg)
    pr = runner(tiny(tmp, "port"))
    load_jax_params(pr.model, jr.state.params, jr.state.batch_stats)
    return jr, pr


def jax_runner_like(jr, tmp_path, **changes):
    """A JAX Runner with config changes that reuses ``jr``'s state (its
    ``_init_variables`` hook) instead of initialising again."""
    cfg = JaxConfig(TINY)
    cfg.work_dir = str(tmp_path / "jax_like")
    cfg.update(changes)
    init = JaxRunner._init_variables
    JaxRunner._init_variables = lambda self, example: jr.state
    try:
        return JaxRunner(cfg=cfg)
    finally:
        JaxRunner._init_variables = init


def jax_leaf_map(params, fn):
    """{port name: array} of ``fn(path)`` over a JAX params tree, each value
    broadcast to its leaf's shape."""
    tree = jax.tree_util.tree_map_with_path(
        lambda path, x: np.full(np.shape(x), fn(path), np.float64), params)
    return flatten_jax_tree(tree)


@pytest.mark.parametrize("changes", [dict(train_aligner=True),
                                     dict(train_aligner=True, joint_train=True, lr_scale=0.1)],
                         ids=["aligner-only", "joint"])
def test_trainable_filter_and_lr_scales_match_jax(jax_pair, tmp_path, changes):
    """Under train_aligner the port freezes the parameters JAX's filter
    freezes; under joint_train the per-path update scales equal JAX's (an
    Adam first step on unit gradients is -lr times the scale)."""
    jr, _ = jax_pair
    jlike = jax_runner_like(jr, tmp_path, **changes)
    port = runner(tiny(tmp_path, "port_like", **changes))
    names = [n for n, _ in port.model.named_parameters()]
    paths = [tuple(n.split(".")) for n in names]
    if not changes.get("joint_train"):
        want = jax_leaf_map(jr.state.params, lambda path: float(jlike._trainable_filter(
            tuple(getattr(p, "key", str(p)) for p in path))))
        got = {n: float(port.trainable_filter(p)) for n, p in zip(names, paths)}
        assert got == {n: float(want[n].flat[0]) for n in names}
        assert 0 < sum(got.values()) < len(got)
        return
    params = jr.state.params
    updates, _ = jax.jit(jlike.tx.update)(jax.tree_util.tree_map(jnp.ones_like, params),
                                          jlike.tx.init(params), params)
    lr = float(port.tx.lr)
    want = {n: -v / lr for n, v in flatten_jax_tree(jax.device_get(updates)).items()}
    ps = [p.detach() for p in port.model.parameters()]
    got, _ = port.tx.update([torch.ones_like(p) for p in ps], port.tx.init(ps), ps, paths)
    scales = {n: -(u / lr).numpy() for n, u in zip(names, got)}
    for n in names:
        np.testing.assert_allclose(scales[n], want[n], rtol=1e-6, err_msg=n)
    # the clip scales every unit gradient alike: two values, 10 times apart
    firsts = sorted({float(s.flat[0]) for s in scales.values()})
    assert len(firsts) == 2
    np.testing.assert_allclose(firsts[0] / firsts[1], 0.1, rtol=1e-6)


@pytest.mark.parametrize("scheduler", [
    dict(type="LinearLR", start_lr=1e-3, end_lr=1e-4, start_epoch=0, end_epoch=2),
    dict(type="CosineAnnealingLRWithWarmUp", T_max=8, eta_min=1e-5, warmup_T=2, warmup_lr=1e-5,
         base_lr=1.0),
    dict(type="StepLR", step_size=1, gamma=0.5),
], ids=["linear", "cosine-warmup", "step"])
def test_learning_rate_of_each_iteration_matches_optax(tmp_path, scheduler):
    """Two epochs of iterations of the runner's optimizer against JAX's,
    built from the same config with the iterations per epoch of JAX's own
    loader: the Adam update on a constant gradient is the learning rate
    times a constant, so each iteration's update holds the schedule (1e-6)."""
    cfg = tiny(tmp_path, scheduler=scheduler)
    port = runner(cfg)
    jloader, _ = JaxSyntheticPart(**cfg.dataset.train.dump())
    jtx = jax_build_optimizer(cfg.optimizer.dump(), cfg.scheduler.dump(),
                              iters_per_epoch=max(len(jloader), 1), max_norm=cfg.max_norm)
    assert port.iters_per_epoch == len(jloader) == 2
    g = np.array([0.3, -2.0], np.float32)
    jparams = {"w": jnp.zeros(2)}
    jstate = jtx.init(jparams)
    ps = [torch.zeros(2)]
    state = port.tx.init(ps)
    lrs = []
    for _ in range(2 * port.iters_per_epoch):
        jup, jstate = jtx.update({"w": jnp.asarray(g)}, jstate, jparams)
        up, state = port.tx.update([torch.from_numpy(g)], state, ps, [("w",)])
        np.testing.assert_allclose(up[0].numpy(), np.asarray(jup["w"]), rtol=1e-6)
        lrs.append(float(port.tx.learning_rate(state["count"] - 1)))
    assert lrs[0] == lrs[1] and lrs[1] != lrs[2]  # the schedule moves at the epoch


def jax_part_code_eps(m, b):
    """The part code's standard-normal draw, the first "sample" key of the
    encoder's scope, as JAX's sample_noise_candidates takes it."""
    enc = m.encoder_mod
    means, logvars = enc.get_part_code(b["input"], b["attn_map"], train=False)
    code = reparameterize_gaussian(enc.make_rng("sample"), means, logvars)
    return (code - means) / jnp.exp(0.5 * logvars)


def test_cache_noise_matches_jax(jax_pair):
    """JAX's cache_noise draws the part codes and candidates batch by batch
    from PRNGKey(seed + epoch); replayed and injected into the port's
    cache_noise, the table equals JAX's (1e-6), except rows whose two best
    fit losses lie within 1e-4 relative, where either may win."""
    jr, pr = jax_pair
    variables = jr.state.variables()
    rng = jax.random.PRNGKey(jr.seed + jr.epoch)
    inject, want = [], {}
    draw = jax.jit(lambda v, b, r: jr.model.apply(v, b, method=jax_part_code_eps,
                                                  rngs={"sample": r}))
    for batch in jr.train_loader:
        rng, sub = jax.random.split(rng)
        db = jax_device_batch(batch, jr._slim_train)
        cand, _, sel = jax_select_best_noise(jr.model, variables, sub, db)
        eps = draw(variables, jax_maps(db), sub)
        inject.append({"noise": torch.from_numpy(np.array(cand)).reshape(-1, cand.shape[-1]),
                       "part_code_eps": torch.from_numpy(np.array(eps))})
        want.update({int(i): np.asarray(s) for i, s in zip(batch["id"], sel)})
    jr.cache_noise()
    assert jr.train_loader.dataset.noises.keys() == want.keys()
    for i in want:  # the replay is JAX's own cache_noise
        np.testing.assert_array_equal(jr.train_loader.dataset.noises[i], want[i])
    pr.cache_noise(inject)
    got = pr.train_loader.dataset.noises
    assert got.keys() == want.keys()
    checked = 0
    for batch, inj in zip(pr.train_loader, inject):
        B = len(batch["id"])
        db = ensure_attn_maps(device_batch(batch, "cpu", pr._slim_train))
        db["part_code_eps"] = inj["part_code_eps"]
        _, fit = pr.model.sample_noise_candidates(db, inj["noise"].shape[0] // B,
                                                  noise=inj["noise"])
        top2 = torch.sort(fit, dim=1).values[:, :2]
        for row, i in enumerate(batch["id"]):
            a, b = top2[row].tolist()
            if abs(b - a) <= 1e-4 * abs(a):
                continue
            np.testing.assert_allclose(got[int(i)], want[int(i)], atol=1e-6)
            checked += 1
    assert checked >= 6


def test_first_step_loss_matches_jax(jax_pair):
    """The runner's step on its first training batch (the pre-cache noise of
    width 1), with t and the diffusion noise injected and the flow prior's
    part-code draw recovered from JAX's encoder under the JAX step's own
    rngs: every loss entry within 1e-3, the first rung of
    tests/test_torch_train_step.py's ladder."""
    jr, pr = jax_pair
    batch = next(iter(pr.train_loader))
    B, N = batch["ref"].shape[:2]
    batch["noise"] = np.zeros((B, 1), np.float32)  # an item's noise before any cache
    rng = np.random.RandomState(0)
    inject = {"diffusion_t": rng.randint(0, 5, (B,)).astype(np.int32),
              "diffusion_noise": rng.randn(B, N, 3).astype(np.float32)}
    jbatch = jax_maps({**{k: jnp.asarray(v) for k, v in jax_device_batch(batch).items()},
                       **{k: jnp.asarray(v) for k, v in inject.items()}})
    key = jax.random.PRNGKey(pr.seed + 7919)
    r_sample, r_dropout = jax.random.split(jax.random.fold_in(key, 0))
    rngs = {"sample": r_sample, "dropout": r_dropout}
    variables = jr.state.variables()

    def part_code_and_stats(m, b):
        latents = m.encode(b, epoch=0, train=True)[5]
        means, logvars = m.encoder_mod.get_part_code(b["input"], b["ref_attn_map"], train=True)
        return latents[0], means, logvars

    @jax.jit
    def draw_and_loss(variables, b, rngs):
        (code, means, logvars), _ = jr.model.apply(variables, b, method=part_code_and_stats,
                                                   rngs=rngs, mutable=["batch_stats"])
        loss, _ = jr.model.apply(variables, b, 0, True, method=JaxAnchorDiffAE.loss, rngs=rngs,
                                 mutable=["batch_stats"])
        return (code - means) / jnp.exp(0.5 * logvars), loss

    eps, want = draw_and_loss(variables, jbatch, rngs)
    db = device_batch(batch, "cpu", pr._slim_train)
    db.update({k: torch.from_numpy(v) for k, v in inject.items()})
    db["part_code_eps"] = torch.from_numpy(np.array(eps))
    state = copy.copy(pr.state)
    saved = [p.detach().clone() for p in pr.model.parameters()] + [b.clone() for b in pr.model.buffers()]
    _, met = pr._step_fn(state, db, pr.seed + 7919, 0)
    with torch.no_grad():  # leave the shared model as it was
        for t, old in zip(list(pr.model.parameters()) + list(pr.model.buffers()), saved):
            t.copy_(old)
    assert float(met["skipped_nonfinite"]) == 0.0
    total = 0.0
    for k, v in want.items():
        np.testing.assert_allclose(float(met[k]), float(np.mean(v)), rtol=1e-3, atol=1e-5,
                                   err_msg=k)
        total += float(np.mean(v)) if "loss" in k else 0.0
    np.testing.assert_allclose(float(met["total_loss"]), total, rtol=1e-3)


def test_cli_trains_resumes_and_scores_on_the_cpu(tmp_path):
    """tools/run_net_torch.py --cpu: train tiny_gen (checkpoint at epoch 2),
    then val_gen resumes from it and prints 12 finite metrics."""
    env = dict(os.environ, DIFFFACTO_EMD_ITERS="16")
    cmd = [sys.executable, os.path.join(ROOT, "tools", "run_net_torch.py"), "--config-file", TINY,
           "--cpu", "--prefix", "cli"]
    subprocess.run(cmd + ["--task", "train"], cwd=tmp_path, env=env, check=True,
                   capture_output=True, timeout=120)
    assert os.path.exists(tmp_path / "work_dirs" / "tiny_gen_cli" / "checkpoints" / "ckpt_2.pt")
    out = subprocess.run(cmd + ["--task", "val_gen", "--gen_num", "8"], cwd=tmp_path, env=env,
                         check=True, capture_output=True, text=True, timeout=120).stdout
    assert "resumed from" in out and "(epoch 2)" in out
    metrics = dict(line.split(": ") for line in out.splitlines()
                   if ": " in line and not line.startswith("["))
    assert len(metrics) == 12 and all(np.isfinite(float(v)) for v in metrics.values())


@pytest.mark.parametrize("argv,built", [
    (["--runner", "pretrain"], "PretrainRunner"),
    (["--runner", "language"], "LanguageRunner"),
    (["--runner", "gan"], "GanRunner"),
])
def test_cli_refuses_what_is_not_ported(argv, built, tmp_path):
    """Every runner family of the JAX command line is ported: ``--runner
    pretrain``, ``language`` and ``gan``, each refused until its family was
    ported, build their runners (max_epoch 0 trains nothing): one denoiser
    a part, the language modules, the latent GAN with its critic as wide as
    the generator's flattened codes."""
    from difffacto_torch.runner.cli import main

    cfg_file = tmp_path / "runner.py"
    cfg_file.write_text(f"_base_ = [{TINY!r}]\nwork_dir = {str(tmp_path / 'run')!r}\n"
                        "max_epoch = 0\n")
    runner = main(["--config-file", str(cfg_file), "--cpu"] + argv)
    assert type(runner).__name__ == built and runner.state.step == 0
    if built == "PretrainRunner":
        assert len(runner.model.net_list) == runner.model.num_anchors
    elif built == "LanguageRunner":
        assert runner.model.train_language and hasattr(runner.model, "update_mlp")
    else:
        g = runner.generator
        assert runner.discriminator.dense0.kernel.shape[0] == g.n_class * g.out_dim


def test_cli_without_a_card_raises():
    from difffacto_torch.runner.cli import main

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        main(["--config-file", TINY, "--task", "val_gen"])


@pytest.mark.parametrize("flag,value", [(["--sync_bn"], ("sync_bn", True)),
                                        (["--deterministic"], ("deterministic", True)),
                                        (["--param_sample_num", "5"], ("param_sample_num", 5))])
def test_cli_accepts_the_jax_flags_it_ignores(flag, value, monkeypatch):
    """``--sync_bn``, ``--deterministic`` and ``--param_sample_num`` parse as
    the JAX CLI parses them (``tools/run_net.py``) and change no other
    option: neither command line reads them."""
    import importlib.util

    from difffacto_torch.runner.cli import parse_args

    base = ["--config-file", TINY]
    got, plain = vars(parse_args(base + flag)), vars(parse_args(base))
    assert got.pop(value[0]) == value[1]
    plain.pop(value[0])
    assert got == plain
    spec = importlib.util.spec_from_file_location(
        "jax_run_net", os.path.join(ROOT, "tools", "run_net.py"))
    jax_cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_cli)
    monkeypatch.setattr(sys, "argv", ["run_net.py"] + base + flag)
    assert getattr(jax_cli.parse_args(), value[0]) == value[1]
