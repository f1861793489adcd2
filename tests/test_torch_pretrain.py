"""Per-part pretraining in the port against the JAX package, on the CPU.

``PointwiseNet`` and its ``ConcatSquashDense`` layers, ``pretrain_loss`` and
its gradients, ``pretrain_sample`` and ``_split_parts`` are held against
``difffacto_tpu`` on the same weights (bridged with ``load_jax_params``) and
the same draws: the JAX side's part-code draw, timesteps and q-sample noise
are replaced in the test by the arrays the port is given, its x_T and step
draws injected. Then ``--runner pretrain`` runs one epoch and its val through
``runner/cli.py:main`` on the CPU. All at ``tests/configs/tiny_gen.py``'s
widths with a small PointwiseNet, as ``tests/test_extra_runners.py`` builds
it.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import difffacto_tpu.models  # noqa: F401  (registers the JAX models)
import difffacto_tpu.utils.gaussian as jgauss
from difffacto_tpu.config import Config as JaxConfig
from difffacto_tpu.models.anchor_diff import AnchorDiffAE as JaxAnchorDiffAE
from difffacto_tpu.models.denoiser import PointwiseNet as JaxPointwiseNet
from difffacto_tpu.models.diffusion import AnchoredDiffusion as JaxDiffusion
from difffacto_tpu.models.samplers import Uniform as JaxUniform
from difffacto_tpu.runner.extra_runners import _split_parts as jax_split_parts
from difffacto_tpu.utils.registry import MODELS as JAX_MODELS
from difffacto_tpu.utils.registry import build_from_cfg as jax_build
from difffacto_torch import Config, load_jax_params
from difffacto_torch.models import PointwiseNet
from difffacto_torch.runner.extra_runners import _split_parts
from difffacto_torch.utils.jax_params import flatten_jax_tree
from difffacto_torch.utils.registry import MODELS, build_from_cfg

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "tests", "configs", "tiny_gen.py")
NET = dict(type="PointwiseNet", point_dim=3, context_dim=16, hidden=(32, 64, 32))
B, K, NP, ZDIM = 4, 4, 16, 16
ALIGNER = ("encoder_mod.aligner",)


def pretrain_cfg(cls):
    """tiny_gen with one PointwiseNet a part and no learned variance, as
    tests/test_extra_runners.py pretrains it."""
    cfg = cls(TINY)
    cfg.model.diffusion.net = cfg.dfs(dict(NET)) if hasattr(cfg, "dfs") else dict(NET)
    cfg.model.diffusion.learn_variance = False
    cfg.model.pretrain_prior = True
    return cfg


@pytest.fixture(scope="module")
def pair():
    """The JAX model with pretrain_prior, its variables, and the port's model
    on the same weights."""
    jcfg = pretrain_cfg(JaxConfig)
    jm = jax_build(jcfg.model.dump(), JAX_MODELS)
    parts = jnp.zeros((2, K, NP, 3), jnp.float32)
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(("params", "sample", "dropout"))}
    variables = jax.jit(lambda r, p: jm.init(r, p, method=JaxAnchorDiffAE.pretrain_loss))(
        rngs, parts)
    pm = build_from_cfg(pretrain_cfg(Config).model.dump(), MODELS, device="cpu")
    # pretrain_loss reaches no aligner, so JAX's init makes none
    load_jax_params(pm, variables["params"], variables["batch_stats"], absent=ALIGNER)
    return jm, variables, pm


def test_pretrain_model_holds_one_net_a_part_under_the_jax_names(pair):
    jm, variables, pm = pair
    nets = sorted(k for k in variables["params"] if k.startswith("net"))
    assert nets == [f"net_list_{i}" for i in range(K)]
    assert pm.net is pm.net_list[0] and len(pm.net_list) == K
    assert not any(n.startswith("net.") for n, _ in pm.named_parameters())


@pytest.mark.parametrize("layout", ["global", "flat", "per_point", "list"])
def test_pointwise_net_matches_jax(layout):
    """Every context layout of the JAX module (``denoiser.py:508-530``),
    float32, 1e-5."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 24, 3).astype(np.float32)
    t = np.array([3.0, 41.0], np.float32)
    ctx = {"global": rng.randn(2, 1, 16), "flat": rng.randn(2, 16),
           "per_point": rng.randn(2, 24, 16),
           "list": [rng.randn(2, 10), rng.randn(2, 1, 6)]}[layout]
    ctx = [c.astype(np.float32) for c in ctx] if layout == "list" else ctx.astype(np.float32)
    jnet = JaxPointwiseNet(point_dim=3, context_dim=16, hidden=(32, 64, 32))
    jctx = [jnp.asarray(c) for c in ctx] if layout == "list" else jnp.asarray(ctx)
    variables = jnet.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t), jctx)
    want = np.asarray(jnet.apply(variables, jnp.asarray(x), jnp.asarray(t), jctx))
    net = PointwiseNet(point_dim=3, context_dim=16, hidden=(32, 64, 32), device="cpu")
    load_jax_params(net, variables["params"])
    pctx = ([torch.from_numpy(c) for c in ctx] if layout == "list" else torch.from_numpy(ctx))
    got = net(torch.from_numpy(x), torch.from_numpy(t), pctx).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def inject_jax_draws(monkeypatch, eps, ts, noise):
    """Replace the JAX pretrain_loss's three draws with the given arrays:
    the part-code reparameterisation, each part's timesteps and q-sample
    noise, in the order the parts run."""
    calls = {"t": 0, "noise": 0}

    def fake_reparam(rng, mean, logvar):
        return mean + jnp.exp(0.5 * logvar) * jnp.asarray(eps)

    def fake_sample(self, rng, batch_size):
        i = calls["t"]
        calls["t"] += 1
        return jnp.asarray(ts[i]), jnp.ones((batch_size,), jnp.float32)

    real = JaxDiffusion.training_losses

    def fake_losses(self, model_fn, rng, x_start, t, **kw):
        i = calls["noise"]
        calls["noise"] += 1
        return real(self, model_fn, rng, x_start, t, **dict(kw, noise=jnp.asarray(noise[i])))

    monkeypatch.setattr(jgauss, "reparameterize_gaussian", fake_reparam)
    monkeypatch.setattr(JaxUniform, "sample", fake_sample)
    monkeypatch.setattr(JaxDiffusion, "training_losses", fake_losses)
    return calls


def test_pretrain_loss_and_gradients_match_jax(pair, monkeypatch):
    """The loss dict (1e-5) and the gradient of every parameter (2e-4 of
    the largest entry of each, or 2e-6 where that is below 1e-2: a bias
    before a BatchNorm has a gradient of zero, which both sides compute as
    f32 rounding of about 1e-7) on the same per-part clouds and draws."""
    jm, variables, pm = pair
    rng = np.random.RandomState(5)
    parts = rng.randn(B, K, NP, 3).astype(np.float32)
    eps = rng.randn(B, K, ZDIM).astype(np.float32)
    ts = rng.randint(0, pm.num_timesteps, (K, B)).astype(np.int32)
    noise = rng.randn(K, B, NP, 3).astype(np.float32)
    calls = inject_jax_draws(monkeypatch, eps, ts, noise)

    def loss_fn(params):
        out, _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                          jnp.asarray(parts), method=JaxAnchorDiffAE.pretrain_loss,
                          rngs={"sample": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)},
                          mutable=["batch_stats"])
        means = {k: jnp.mean(v) for k, v in out.items()}
        return sum(v for k, v in means.items() if "loss" in k), means

    (_, want), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    assert calls == {"t": K, "noise": K}
    got = pm.pretrain_loss(torch.from_numpy(parts), part_code_eps=torch.from_numpy(eps),
                           t=torch.from_numpy(ts), noise=torch.from_numpy(noise))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k].detach().mean()), float(want[k]), rtol=1e-5,
                                   atol=1e-6,
                                   err_msg=k)
    total = sum(v.mean() for k, v in got.items() if "loss" in k)
    names = [n for n, _ in pm.named_parameters()]
    grads = torch.autograd.grad(total, list(pm.parameters()), allow_unused=True)
    jflat = flatten_jax_tree(jax.device_get(jgrads))
    assert set(jflat) == {n for n in names if not n.startswith(ALIGNER[0] + ".")}
    for n, g in zip(names, grads):
        if n not in jflat:
            assert g is None, n  # the aligner takes no part in pretraining
            continue
        g = np.zeros_like(jflat[n]) if g is None else g.numpy()
        scale = max(float(np.abs(jflat[n]).max()), 1e-2)
        np.testing.assert_allclose(g, jflat[n], atol=2e-4 * scale, rtol=0, err_msg=n)


def test_pretrain_sample_matches_jax(pair, monkeypatch):
    """Each part's chain from the JAX codes with x_T and the step draws
    injected: (S, Np, 3) a part, 1e-4."""
    jm, variables, pm = pair
    S, T = 2, pm.num_timesteps
    rng = np.random.RandomState(7)
    x_T = rng.randn(K, S, NP, 3).astype(np.float32)
    steps = rng.randn(K, T, S, NP, 3).astype(np.float32)
    codes = []
    real = JaxDiffusion.p_sample_loop

    def fake_loop(self, model_fn, rng_, anchors, ctx=None, **kw):
        i = len(codes)
        codes.append(np.asarray(ctx))
        return real(self, model_fn, rng_, anchors, ctx=ctx,
                    **dict(kw, noise=jnp.asarray(x_T[i]), step_noise=jnp.asarray(steps[i])))

    monkeypatch.setattr(JaxDiffusion, "p_sample_loop", fake_loop)
    want = jm.apply(variables, S, NP, method=JaxAnchorDiffAE.pretrain_sample,
                    rngs={"sample": jax.random.PRNGKey(4)})
    code = torch.from_numpy(np.concatenate(codes, axis=1))  # (S, K, zdim)
    got = pm.pretrain_sample(S, NP, codes=code, noise=torch.from_numpy(x_T),
                             step_noise=torch.from_numpy(steps))
    assert len(got) == len(want) == K
    for g, w in zip(got, want):
        assert g.shape == (S, NP, 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


def test_split_parts_matches_jax_bit_for_bit():
    """The same batch and RandomState give the same clouds, an absent part
    zero in both."""
    rng = np.random.RandomState(11)
    seg = rng.randint(0, 3, (3, 50))  # part 3 absent
    batch = {"ref": rng.randn(3, 50, 3).astype(np.float32), "ref_seg_mask": seg}
    got = _split_parts(batch, 4, 8, np.random.RandomState(2))
    want = np.asarray(jax_split_parts(batch, 4, 8, np.random.RandomState(2)))
    assert got.dtype == np.float32 and got.shape == (3, 4, 8, 3)
    np.testing.assert_array_equal(got, want)
    assert not got[:, 3].any()


def test_cli_pretrain_runs_an_epoch_and_its_val(tmp_path):
    """``--runner pretrain --cpu``: one epoch (two steps), the final
    checkpoint and val's samples, each part (4, Np, 3) and finite."""
    from difffacto_torch.runner.cli import main

    cfg_file = tmp_path / "pretrain.py"
    net = ", ".join(f"{k}={v!r}" for k, v in NET.items())
    cfg_file.write_text(
        f"_base_ = [{TINY!r}]\n"
        f"work_dir = {str(tmp_path / 'run')!r}\n"
        f"model = dict(diffusion=dict(learn_variance=False, net=dict(_cover_=True, {net})))\n"
        "max_epoch = 1\neval_interval = 1\ncheckpoint_interval = None\n"
        f"cimle_cache_interval = None\npts_per_part = {NP}\nlog_interval = 1\n")
    runner = main(["--config-file", str(cfg_file), "--runner", "pretrain", "--cpu"])
    assert type(runner).__name__ == "PretrainRunner" and runner.epoch == 1
    assert runner.state.step == 2 and len(runner.model.net_list) == K
    assert os.path.exists(tmp_path / "run" / "checkpoints" / "ckpt_1.pt")
    samples = np.load(tmp_path / "run" / "val" / "pretrain_samples_1.npz")
    assert sorted(samples) == [f"part_{i}" for i in range(K)]
    assert all(samples[k].shape == (4, NP, 3) and np.isfinite(samples[k]).all()
               for k in samples)
