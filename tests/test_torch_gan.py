"""The latent GAN, the METRICS registry and the GAN and mixing runners of the
port against the JAX package, on the CPU.

``Generator``, ``Discriminator`` and ``DiscriminatorcGan`` are held against
``difffacto_tpu/models/gan.py`` on the same weights (bridged with
``load_jax_params``), ``gen_loss``, ``dis_loss`` and both gradient
penalties on the same scores (the interpolated penalty's uniform draw taken
from the JAX key), every entry of the METRICS registry on the same inputs,
one critic and one generator step of ``GanRunner`` (the generator's draw
taken from the JAX key; the JAX runner's separate ``g_vars`` and ``d_vars``
trees bridged, and read back from a ``.msgpack``) and
``MixingRunner.mixing`` with every draw injected on both sides. Then
``--runner gan`` runs one epoch and its val through ``runner/cli.py:main``.
Widths are ``tests/configs/tiny_gen.py``'s and the JAX tests' own
(``tests/test_extra_runners.py``, ``tests/test_secondary_models.py``).
Tolerance: 1e-5 for forwards, losses and one step in f32.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import difffacto_tpu.metrics.common as jmc
import difffacto_tpu.models.gan as jgan
import difffacto_tpu.runner.editing as jed
from difffacto_tpu.config import Config as JaxConfig
from difffacto_tpu.runner import GanRunner as JaxGanRunner
from difffacto_tpu.runner import MixingRunner as JaxMixingRunner
from difffacto_tpu.utils import gaussian as jgauss
from difffacto_torch import Config, load_jax_params
from difffacto_torch.models import gan as pgan
from difffacto_torch.runner import GanRunner, MixingRunner
from difffacto_torch.utils import gaussian as pgauss
from difffacto_torch.utils import registry as preg
from difffacto_torch.utils.jax_checkpoint import read_jax_checkpoint
from difffacto_torch.utils.jax_params import export_jax_params, flatten_jax_tree

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "tests", "configs", "tiny_gen.py")
TOL = dict(rtol=1e-5, atol=1e-5)
GEN = dict(type="Generator", noise_dim=8, out_dim=16, n_class=4)


def np_(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def randn(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ----------------------------------------------------------- registries
def test_registries_of_the_jax_package():
    """The port has the JAX package's 15 registries, and this slice fills
    METRICS, GENERATORS and DISCRIMINATORS with the JAX entries."""
    import difffacto_tpu.utils.registry as jreg

    names = [n for n in dir(jreg) if isinstance(getattr(jreg, n), jreg.Registry)]
    assert len(names) == 15 and all(isinstance(getattr(preg, n), preg.Registry) for n in names)
    for n in ("METRICS", "GENERATORS", "DISCRIMINATORS"):
        assert sorted(getattr(preg, n)._modules) == sorted(getattr(jreg, n).modules), n


def test_gaussian_helpers():
    """``standard_normal_logprob`` against JAX; ``truncated_normal``'s
    support, mean and std against ``jax.random.truncated_normal``'s (the
    draws differ: the streams do)."""
    z = randn(3, 5, seed=1)
    np.testing.assert_allclose(np_(pgauss.standard_normal_logprob(torch.from_numpy(z))),
                               np.asarray(jgauss.standard_normal_logprob(jnp.asarray(z))), **TOL)
    g = torch.Generator().manual_seed(0)
    got = pgauss.truncated_normal((200000,), g, mean=0.5, std=2.0, trunc_std=1.5).numpy()
    want = np.asarray(jgauss.truncated_normal(jax.random.PRNGKey(0), (200000,), mean=0.5,
                                              std=2.0, trunc_std=1.5))
    assert got.dtype == np.float32
    assert got.min() >= 0.5 - 3.0 and got.max() <= 0.5 + 3.0
    np.testing.assert_allclose([got.mean(), got.std()], [want.mean(), want.std()], atol=0.01)
    with pytest.raises(ValueError, match="Generator"):
        pgauss.truncated_normal((2,), None)


# ---------------------------------------------------------------- nets
def _pair(jmod, pmod, *args, train=False):
    variables = jmod.init(jax.random.PRNGKey(3), *(jnp.asarray(a) for a in args))
    load_jax_params(pmod, variables["params"], variables.get("batch_stats"))
    return variables


@pytest.mark.parametrize("kw,train", [({}, False), (dict(use_bn=True, output_bn=True), False),
                                      (dict(use_bn=True, output_bn=True), True),
                                      (dict(per_part=False), False), (dict(truncate=True), False)])
def test_generator_matches_jax(kw, train):
    """Forwards with and without BatchNorm, per part or not; in training the
    BatchNorm batch statistics and the running statistics they move. The
    noise shape and, truncated, its support."""
    jg = jgan.Generator(noise_dim=8, out_dim=16, n_class=4, **kw)
    pg = pgan.Generator(noise_dim=8, out_dim=16, n_class=4, device="cpu", **kw)
    z = np.asarray(jg.sample_noise(jax.random.PRNGKey(1), 5))
    assert pg.noise_shape(5) == z.shape
    drawn = pg.sample_noise(5, torch.Generator().manual_seed(1))
    assert drawn.shape == z.shape and (not kw.get("truncate") or drawn.abs().max() <= 2.0)
    variables = _pair(jg, pg, z)
    if train:
        want, mutated = jg.apply(variables, jnp.asarray(z), train=True, mutable=["batch_stats"])
    else:
        want, mutated = jg.apply(variables, jnp.asarray(z)), {}
    got = pg(torch.from_numpy(z), train=train)
    np.testing.assert_allclose(np_(got), np.asarray(want), **TOL)
    for name, arr in flatten_jax_tree(mutated.get("batch_stats", {})).items():
        np.testing.assert_allclose(np_(dict(pg.named_buffers())[name]), arr, **TOL)


@pytest.mark.parametrize("kw", [{}, dict(use_bn=True, use_ln=True, use_sigmoid=True)])
def test_discriminator_matches_jax(kw):
    """The critic on (B, K, zdim) codes: flax takes the input width from the
    flattened codes whatever ``in_dim`` says (the JAX runner builds it with
    256 and feeds it 64); the port is given that width."""
    x = randn(5, 4, 16, seed=2)
    jd = jgan.Discriminator(in_dim=256, **kw)
    pd = pgan.Discriminator(in_dim=64, device="cpu", **kw)
    variables = _pair(jd, pd, x)
    assert variables["params"]["Dense_0"]["kernel"].shape == (64, 512)
    for train in (False, True):
        want = (jd.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])[0]
                if train else jd.apply(variables, jnp.asarray(x)))
        np.testing.assert_allclose(np_(pd(torch.from_numpy(x), train=train)), np.asarray(want),
                                   **TOL)


def test_conditional_discriminator_matches_jax():
    x, onehot = randn(5, 4, 16, seed=3), np.eye(4, dtype=np.float32)[[0, 1, 2, 3, 1]]
    jd = jgan.DiscriminatorcGan(n_class=4)
    pd = pgan.DiscriminatorcGan(in_dim=64, n_class=4, device="cpu")
    variables = _pair(jd, pd, x, onehot)
    want = jd.apply(variables, jnp.asarray(x), jnp.asarray(onehot))
    np.testing.assert_allclose(np_(pd(torch.from_numpy(x), torch.from_numpy(onehot))),
                               np.asarray(want), **TOL)


# -------------------------------------------------------------- losses
@pytest.mark.parametrize("kind", ["wgan", "hinge", "ns"])
def test_gan_losses_match_jax(kind):
    real, fake = randn(7, seed=4), randn(7, seed=5)
    np.testing.assert_allclose(
        float(pgan.gen_loss(torch.from_numpy(fake), kind)),
        float(jgan.gen_loss(jnp.asarray(fake), kind)), **TOL)
    np.testing.assert_allclose(
        float(pgan.dis_loss(torch.from_numpy(real), torch.from_numpy(fake), kind)),
        float(jgan.dis_loss(jnp.asarray(real), jnp.asarray(fake), kind)), **TOL)
    with pytest.raises(ValueError):
        pgan.gen_loss(torch.from_numpy(fake), "other")


@pytest.mark.parametrize("gp_type", ["zero_center", "interpolated"])
def test_gradient_penalty_and_its_gradient_match_jax(gp_type):
    """The penalty and its gradient in the critic's parameters: zero_center
    squares the mean of the per-sample norms at the real codes; the
    interpolated one takes the JAX key's uniform draw."""
    real, fake = randn(6, 4, 16, seed=6), randn(6, 4, 16, seed=7)
    jd = jgan.Discriminator()
    pd = pgan.Discriminator(in_dim=64, device="cpu")
    variables = _pair(jd, pd, real)
    key = jax.random.PRNGKey(8)

    def jloss(params):
        return jgan.gradient_penalty(lambda x: jd.apply({"params": params}, x), key,
                                     jnp.asarray(real), jnp.asarray(fake), 10.0, gp_type=gp_type)

    want, jgrads = jax.value_and_grad(jloss)(variables["params"])
    eps = np.asarray(jax.random.uniform(key, (6, 1, 1)))
    got = pgan.gradient_penalty(pd, None, torch.from_numpy(real), torch.from_numpy(fake), 10.0,
                                gp_type, eps=torch.from_numpy(eps))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    names = [n for n, _ in pd.named_parameters()]
    # the last bias moves no input gradient: JAX's gradient of it is zero
    grads = torch.autograd.grad(got, list(pd.parameters()), allow_unused=True)
    jflat = flatten_jax_tree(jgrads)
    for n, g, p in zip(names, grads, pd.parameters()):
        g = torch.zeros_like(p) if g is None else g
        scale = max(float(np.abs(jflat[n]).max()), 1e-3)
        np.testing.assert_allclose(np_(g), jflat[n], atol=1e-5 * scale, rtol=1e-4, err_msg=n)


# ------------------------------------------------------------- METRICS
def _clouds(B, n, m, seed, zero_rows=0):
    a, b = randn(B, n, 3, seed=seed), randn(B, m, 3, seed=seed + 1)
    if zero_rows:
        a[:, -zero_rows:] = 0
        b[:, -zero_rows:] = 0
    return a, b


METRIC_CASES = {
    "ChamferDistanceL2": (dict(), lambda: _clouds(2, 20, 24, 10)),
    "ChamferDistanceL2/no_reduce": (dict(reduce=False), lambda: _clouds(2, 20, 20, 11)),
    "ChamferDistanceL2/ignore_zeros": (dict(ignore_zeros=True), lambda: _clouds(1, 20, 20, 12, 5)),
    "ChamferDistanceL2_split": (dict(), lambda: _clouds(2, 20, 24, 13)),
    "ChamferDistanceL2_split/ignore_zeros": (dict(ignore_zeros=True, reduce=False),
                                             lambda: _clouds(1, 20, 20, 14, 3)),
    "ChamferDistanceL1": (dict(), lambda: _clouds(2, 20, 24, 15)),
    "ChamferDistanceL1/no_reduce": (dict(reduce=False), lambda: _clouds(2, 20, 20, 16)),
    "EMD": (dict(eps=0.005, iters=50), lambda: _clouds(2, 16, 16, 17)),
    "EMD/dist_only": (dict(eps=0.005, iters=50, dist_only=True), lambda: _clouds(2, 16, 16, 18)),
    "SmoothCrossEntropy": (dict(alpha=0.2), lambda: (randn(6, 5, seed=19),
                                                     np.array([0, 4, 2, 1, 3, 3]))),
    "NegativeGaussianLogLikelihood": (dict(), lambda: (randn(4, 3, seed=20), randn(4, 3, seed=21))),
    "NegativeGaussianLogLikelihood/var": (
        dict(), lambda: (randn(4, 3, seed=22), randn(4, 3, seed=23),
                         np.abs(randn(4, 3, seed=24)) + 0.5)),
    "NegativeGaussianLogLikelihood/none": (
        dict(reduction="none"), lambda: (randn(5, seed=25), randn(5, seed=26),
                                         np.abs(randn(5, seed=27)) + 0.5)),
    "CrossEntropy": (dict(), lambda: (randn(8, seed=28), randn(8, seed=29))),
    "CrossEntropy/no_reduce": (dict(reduce=False), lambda: (randn(8, seed=30), randn(8, seed=31))),
    "L2Loss": (dict(), lambda: (randn(4, 6, seed=32), randn(4, 6, seed=33))),
    "L2Loss/none": (dict(reduction="none"), lambda: (randn(4, 6, seed=34), randn(4, 6, seed=35))),
    "L1Loss": (dict(), lambda: (randn(4, 6, seed=36), randn(4, 6, seed=37))),
    "SpectralContrastiveLoss": (dict(), lambda: (randn(5, 3, 8, seed=38),)),
}


@pytest.mark.parametrize("case", sorted(METRIC_CASES))
def test_metrics_registry_entry_matches_jax(case):
    """Each METRICS class built from its config on the same inputs; the EMD
    through the port's ``ops/emd.emd`` against the JAX auction, its
    assignment index for index."""
    name = case.split("/")[0]
    kw, inputs = METRIC_CASES[case]
    args = inputs()
    jm = jmc.METRICS.get(name)(**kw)
    pm = preg.build_from_cfg(dict(type=name, **kw), preg.METRICS)
    want = jm(*(jnp.asarray(a) for a in args))
    got = pm(*(torch.from_numpy(np.asarray(a)) for a in args))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np_(g), np.asarray(w)
        assert g.shape == w.shape, case
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=case)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=case)


def test_gan_losses_are_registered_by_name():
    for name, fn in (("dis_loss", pgan.dis_loss), ("gen_loss", pgan.gen_loss),
                     ("gradient_penalty", pgan.gradient_penalty)):
        assert preg.METRICS.get(name) is fn and name in jmc.METRICS


# -------------------------------------------------------------- runners
def tiny(cls, tmp_path, name, **keys):
    """The tiny config for one epoch, nothing cached, evaluated or saved on
    the way, one val batch of 4."""
    cfg = cls(TINY)
    cfg.work_dir = str(tmp_path / name)
    cfg.dataset.val.size = 4
    cfg.max_epoch = 1
    cfg.eval_interval = None
    cfg.checkpoint_interval = None
    cfg.cimle_cache_interval = None
    for k, v in keys.items():
        cfg[k] = cfg.dfs(v) if isinstance(v, dict) else v
    return cfg


@pytest.fixture(scope="module")
def gan_pair(tmp_path_factory):
    """A JAX GanRunner (the tiny config, the JAX test's generator and
    critic) and the port's, holding its model, generator and critic."""
    tmp = tmp_path_factory.mktemp("gan")
    keys = dict(generator=GEN, discriminator=dict(type="Discriminator", in_dim=64), n_critic=2)
    jr = JaxGanRunner(cfg=tiny(JaxConfig, tmp, "jax", **keys))
    pr = GanRunner(cfg=tiny(Config, tmp, "port", **keys), device="cpu")
    load_jax_params(pr.model, jr.state.params, jr.state.batch_stats)
    load_jax_params(pr.generator, jr.g_vars["params"])
    load_jax_params(pr.discriminator, jr.d_vars["params"])
    return jr, pr


def test_gan_runner_trees_bridge_and_read_back_from_msgpack(gan_pair, tmp_path):
    """The JAX runner's two trees written by flax as one ``.msgpack`` load
    into the port's generator and critic through the codec; a key missing
    or left over raises; export gives the trees back."""
    jr, pr = gan_pair
    path = tmp_path / "gan.msgpack"
    path.write_bytes(serialization.msgpack_serialize(
        {"g_vars": jax.device_get(jr.g_vars), "d_vars": jax.device_get(jr.d_vars)}))
    tree, _ = read_jax_checkpoint(str(path))
    g = pgan.Generator(noise_dim=8, out_dim=16, n_class=4, device="cpu")
    load_jax_params(g, tree["g_vars"]["params"])
    for n, p in g.named_parameters():
        assert torch.equal(p, dict(pr.generator.named_parameters())[n]), n
    params, _ = export_jax_params(pr.discriminator)
    for n, arr in flatten_jax_tree(params).items():
        np.testing.assert_array_equal(arr, flatten_jax_tree(tree["d_vars"]["params"])[n])
    broken = dict(tree["d_vars"]["params"])
    broken.pop("Dense_3")
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(pgan.Discriminator(in_dim=64, device="cpu"), broken)
    with pytest.raises(KeyError, match="left over"):
        load_jax_params(pgan.Discriminator(in_dim=64, hidden=(512, 256), device="cpu"),
                        tree["d_vars"]["params"])


def test_gan_runner_steps_match_jax(gan_pair):
    """The frozen encoder's codes; one critic step (wgan with the
    zero-centred penalty) and one generator step: the losses and every
    parameter after each step, 1e-5."""
    jr, pr = gan_pair
    batch = next(iter(jr.train_loader))
    codes = np.asarray(jr.real_codes(batch))
    got_codes = pr.real_codes(batch)
    np.testing.assert_allclose(np_(got_codes), codes, **TOL)
    key_d, key_g = jax.random.PRNGKey(11), jax.random.PRNGKey(12)
    B = codes.shape[0]
    dp, d_opt, dl = jr._d_step(jr.d_vars["params"], jr.d_opt, jr.g_vars, jnp.asarray(codes), key_d)
    z = torch.from_numpy(np.asarray(jr.generator.sample_noise(key_d, B)))
    got = pr.d_step(torch.from_numpy(codes), z=z)
    np.testing.assert_allclose(float(got), float(dl), **TOL)
    for n, arr in flatten_jax_tree(jax.device_get(dp)).items():
        np.testing.assert_allclose(np_(dict(pr.discriminator.named_parameters())[n]), arr,
                                   err_msg=n, **TOL)
    gp, g_opt, gl = jr._g_step(jr.g_vars["params"], jr.g_opt, {"params": dp}, key_g, B)
    z = torch.from_numpy(np.asarray(jr.generator.sample_noise(key_g, B)))
    got = pr.g_step(B, z=z)
    np.testing.assert_allclose(float(got), float(gl), **TOL)
    for n, arr in flatten_jax_tree(jax.device_get(gp)).items():
        np.testing.assert_allclose(np_(dict(pr.generator.named_parameters())[n]), arr,
                                   err_msg=n, **TOL)
    codes = pr.generate_codes(3, torch.Generator().manual_seed(0))
    assert codes.shape == (3, 4, 16) and torch.isfinite(codes).all()


def test_mixing_runner_matches_jax(gan_pair, monkeypatch, tmp_path):
    """``MixingRunner.mixing`` over the val loader (one batch of 4) with the
    JAX keys' permutation seeds and aligner noises, the part codes' and the
    chain's draws injected on both sides: the pickled arrays, 1e-4 (a
    whole reverse chain). The JAX runner's ``mixing`` runs on the GAN pair's
    model: both are ``Runner``s over the same tiny model."""
    jr, pr = gan_pair
    K, N, T = 1, 64, 5
    rng = np.random.RandomState(40)
    nb = len(jr.val_loader)
    eps = [rng.randn(4, 4, 16).astype(np.float32) for _ in range(nb)]
    x_T = [rng.randn(4 * K, N, 3).astype(np.float32) for _ in range(nb)]
    steps = [rng.randn(T, 4 * K, N, 3).astype(np.float32) for _ in range(nb)]
    eps_q, chain_q = list(eps), list(zip(x_T, steps))

    def fake_draw(key, mean, logvar):
        return mean + jnp.exp(0.5 * logvar) * jnp.asarray(eps_q.pop(0))

    def fake_decode(model, variables, key, anchors, **kw):
        from difffacto_tpu.models.anchor_diff import build_diffusion

        x, sn = chain_q.pop(0)
        diff = build_diffusion(model.diffusion, model.num_timesteps)

        def fn(inp, ts, c, anc, var, seg, vid):
            return model.apply(variables, inp, ts, c, anc, var, seg, vid,
                               method=type(model).denoise)

        return diff.p_sample_loop(fn, key, anchors, ctx=kw["ctx"], variance=kw["variance"],
                                  seg_mask=kw["seg_mask"], valid_id=kw["valid_id"],
                                  noise=jnp.asarray(x), step_noise=jnp.asarray(sn))

    monkeypatch.setattr(jgauss, "reparameterize_gaussian", fake_draw)
    monkeypatch.setattr(jed, "reparameterize_gaussian", fake_draw, raising=False)
    import difffacto_tpu.models.part_encoder as jpe
    monkeypatch.setattr(jpe, "reparameterize_gaussian", fake_draw, raising=False)
    monkeypatch.setattr(jed, "decode", fake_decode)
    want = JaxMixingRunner.mixing(jr, seed=3)
    mixer = MixingRunner(cfg=tiny(Config, tmp_path, "mix"), device="cpu")
    inject, key = [], jax.random.PRNGKey(3)
    for i in range(nb):
        key, sub = jax.random.split(key)
        _, k_perm, k_noise, _ = jax.random.split(sub, 4)
        inject.append(dict(part_code_eps=eps[i],
                           perm_seed=int(jax.random.randint(k_perm, (), 0, 2**31 - 1)),
                           cimle_noise=np.asarray(jax.random.normal(k_noise, (4 * K, 32))),
                           x_T=x_T[i], step_noise=steps[i]))
    load_jax_params(mixer.model, jr.state.params, jr.state.batch_stats)
    got = mixer.mixing(seed=3, inject=inject)
    with open(os.path.join(mixer.work_dir, "mixing", "mixing.pkl"), "rb") as f:
        saved = pickle.load(f)
    assert sorted(saved) == sorted(got) == sorted(want)
    for k in want:
        assert saved[k].shape[0] == 4, k
        np.testing.assert_allclose(saved[k], want[k], rtol=1e-4, atol=1e-4, err_msg=k)


def test_cli_gan_runs_an_epoch_and_its_val(tmp_path, monkeypatch):
    """``--runner gan --cpu``: one epoch (2 critic steps, 1 generator step at
    n_critic 2), the val of the AnchorDiffAE and its final checkpoint (the
    JAX runner saves no generator either)."""
    import json

    from difffacto_torch.runner.cli import main

    monkeypatch.setenv("DIFFFACTO_EMD_ITERS", "16")
    cfg_file = tmp_path / "gan.py"
    gen = ", ".join(f"{k}={v!r}" for k, v in GEN.items())
    cfg_file.write_text(
        f"_base_ = [{TINY!r}]\nwork_dir = {str(tmp_path / 'run')!r}\n"
        f"generator = dict({gen})\nn_critic = 2\nmax_epoch = 1\neval_interval = 1\n"
        "checkpoint_interval = None\ncimle_cache_interval = None\n")
    runner = main(["--config-file", str(cfg_file), "--runner", "gan", "--cpu"])
    assert type(runner).__name__ == "GanRunner" and runner.epoch == 1 and runner.iter == 2
    recs = [json.loads(line) for line in open(tmp_path / "run" / "scalars.jsonl")]
    losses = [(r["d_loss"], r["g_loss"]) for r in recs if "d_loss" in r]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert any("gen_fixed0000/1-NN-CD-acc" in r for r in recs)
    assert os.path.exists(tmp_path / "run" / "checkpoints" / "ckpt_1.pt")
