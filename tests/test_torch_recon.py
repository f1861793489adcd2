"""Reconstruction and the repairs of trajectories, fixed parts and dropped
keys, the port against the JAX package.

A tiny gen_chair (``tests/test_model.py:tiny_model_cfg``: 2 blocks, widths
16, T = 5) at 128 points; the JAX weights randomised and bridged with
``load_jax_params``. Every draw is injected: on the JAX side the part code's
posterior draw through ``reparameterize_gaussian`` and the chain's x_T and
step draws through ``decode`` (both patched here, in the test, around the
JAX package's own functions), on the port's side by keyword. float32 on the
CPU; tolerances are stated at each test.

* C3: ``p_sample_loop`` keeps every ``ret_interval``-th step (``traj``,
  ``traj_t``), and val writes them as ``traj_<t>``.
* C4: val honours ``fix_part_ids`` and names its output as the JAX runner does.
* C5: every registered port class takes every field of its JAX counterpart,
  and ``configs/gen_chair.py`` reaches the port with no key dropped.
* ``encode_part_code``, ``latents_to_decode``, ``reconstruct`` with (B, K, D)
  aligner noise, ``recon_losses`` and ``edit_losses`` (values and z-gradients),
  and the val of a reconstruction model through the ``ae`` protocol.
"""

import dataclasses
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import difffacto_tpu.models.anchor_diff as jad
import difffacto_tpu.models.part_encoder as jpe
import difffacto_tpu.runner.editing as jed
import difffacto_tpu.utils.gaussian as jgauss
from difffacto_tpu.models.anchor_diff import AnchorDiffAE as JaxAnchorDiffAE
from test_model import tiny_batch, tiny_model_cfg
from test_torch_generation import randomize, t2n

import difffacto_torch.runner.runner as prunner
from difffacto_torch import Config, MODELS, Runner, build_from_cfg, load_jax_params
from difffacto_torch.models import decode, reconstruct
from difffacto_torch.runner.editing import edit_loss_and_grad, recon_loss_and_grad

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "tests", "configs", "tiny_gen.py")
GEN_CHAIR = os.path.join(ROOT, "configs", "gen_chair.py")
N, KC, ZDIM, T = 128, 4, 16, 5
TOL = dict(rtol=1e-4, atol=1e-4)  # f32, the same sums in another order


def build_pair(seed=3, **changes):
    """(JAX model, its randomised variables, the port model holding them)."""
    cfg = tiny_model_cfg(**changes)
    cfg["npoints"] = N
    jm = JaxAnchorDiffAE(**cfg)
    rngs = {n: jax.random.PRNGKey(i) for i, n in enumerate(("params", "sample", "dropout"))}
    variables = jax.jit(lambda r, b: jm.init(r, b, 0, method=JaxAnchorDiffAE.loss))(
        rngs, tiny_batch(B=2))
    variables = {"params": randomize(variables["params"], seed),
                 "batch_stats": variables["batch_stats"]}
    pm = build_from_cfg(dict(type="AnchorDiffAE", **cfg), MODELS, device="cpu")
    load_jax_params(pm, variables["params"], variables["batch_stats"])
    return jm, variables, pm


@pytest.fixture(scope="module")
def pair():
    return build_pair()


def make_batch(B=3, seed=0):
    """Numpy batch: B shapes of N points, part 3 absent in row 1 (its points
    given to part 0)."""
    rng = np.random.RandomState(seed)
    seg = np.repeat(np.arange(KC), N // KC)[None].repeat(B, 0).astype(np.int32)
    present = np.ones((B, KC), np.float32)
    if B > 1:
        present[1, 3] = 0.0
        seg[1][seg[1] == 3] = 0
    pts = (rng.randn(B, N, 3) * 0.3).astype(np.float32)
    onehot = np.eye(KC, dtype=np.float32)[seg]
    return {
        "input": pts, "ref": pts, "ref_seg_mask": seg, "seg_mask": seg,
        "ref_attn_map": onehot, "attn_map": onehot, "present": present, "dp_present": present,
        "part_shift": (rng.randn(B, KC, 3) * 0.1).astype(np.float32),
        "part_scale": (np.abs(rng.randn(B, KC, 3)) * 0.2 + 0.3).astype(np.float32),
        "shift": (rng.randn(B, 1, 3) * 0.1).astype(np.float32),
        "scale": (1.0 + 0.1 * np.abs(rng.randn(B, 1, 1))).astype(np.float32),
    }


def jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def pb(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


# ------------------------------------------------------ JAX-side injection
def patch_part_code_draw(monkeypatch, eps):
    """The JAX package's posterior draws take the standard normals in ``eps``,
    in the order they are drawn (one array: every draw takes it)."""
    queue = list(eps) if isinstance(eps, list) else None

    def fake(rng, mean, logvar):
        e = queue.pop(0) if queue is not None else eps
        return mean + jnp.exp(0.5 * logvar) * jnp.asarray(e, mean.dtype)

    monkeypatch.setattr(jgauss, "reparameterize_gaussian", fake)
    monkeypatch.setattr(jpe, "reparameterize_gaussian", fake)
    monkeypatch.setattr(jed, "reparameterize_gaussian", fake)


_CHAINS = {}


def jax_chain(model, ret_traj, ret_interval):
    """The JAX reverse chain with x_T and the step draws as arguments, jitted
    once per model and options (and compiled once per shape)."""
    key = (id(model), ret_traj, ret_interval)
    if key not in _CHAINS:
        diff = jad.build_diffusion(model.diffusion, model.num_timesteps)
        _CHAINS[key] = (model, jax.jit(
            lambda v, anchors, ctx, var, seg, valid, x_T, sn: diff.p_sample_loop(
                jad._model_fn(model, v), jax.random.PRNGKey(0), anchors, ctx=ctx, variance=var,
                seg_mask=seg, valid_id=valid, noise=x_T, step_noise=sn, ret_traj=ret_traj,
                ret_interval=ret_interval)))
    return _CHAINS[key][1]


def patch_decode(monkeypatch, x_T, step_noise):
    """The JAX package's ``decode`` with x_T and every step's draw injected
    (``p_sample_loop``'s ``noise`` and ``step_noise``)."""

    def fake(model, variables, rng, anchors, ctx=None, variance=None, seg_mask=None,
             valid_id=None, noise=None, ret_traj=None, ret_interval=None, mesh=None):
        run = jax_chain(model, bool(model.ret_traj if ret_traj is None else ret_traj),
                        model.ret_interval if ret_interval is None else ret_interval)
        return run(variables, anchors, ctx, variance, seg_mask, valid_id, jnp.asarray(x_T),
                   jnp.asarray(step_noise))

    monkeypatch.setattr(jad, "decode", fake)
    monkeypatch.setattr(jed, "decode", fake)
    monkeypatch.setattr(jad, "_PIPELINE_CACHE", {})  # no jitted trace of an earlier draw


def chain_draws(B, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, N, 3).astype(np.float32),
            rng.randn(T, B, N, 3).astype(np.float32))


# --------------------------------------------------------------------- C3
def test_p_sample_loop_keeps_every_ret_interval_th_step(pair):
    """C3: ``traj`` (T_kept, B, N, 3) and ``traj_t`` [4, 2, 0] at T = 5,
    ``ret_interval`` 2, against JAX's scan with the same x_T and step draws;
    the last kept sample is the prediction. Tolerance 1e-4."""
    jm, variables, pm = pair
    B = 2
    rng = np.random.RandomState(5)
    seg = np.repeat(np.arange(KC), N // KC)[None].repeat(B, 0).astype(np.int32)
    anchors = (0.3 * rng.randn(B, N, 3)).astype(np.float32)
    variance = (0.05 + 0.1 * np.abs(rng.randn(B, N, 3))).astype(np.float32)
    ctx = rng.randn(B, KC, ZDIM + 6).astype(np.float32)
    valid = np.ones((B, KC), np.float32)
    x_T, step_noise = chain_draws(B, 6)
    want = jax_chain(jm, True, 2)(variables, *(jnp.asarray(a) for a in (
        anchors, ctx, variance, seg, valid, x_T, step_noise)))
    got = decode(pm, *(torch.as_tensor(a) for a in (anchors, ctx, variance, seg, valid)),
                 noise=torch.as_tensor(x_T), step_noise=torch.as_tensor(step_noise),
                 ret_traj=True, ret_interval=2)
    assert list(got["traj_t"]) == list(np.asarray(want["traj_t"])) == [4, 2, 0]
    assert got["traj"].shape == (3, B, N, 3)
    np.testing.assert_allclose(t2n(got["traj"]), np.asarray(want["traj"]), **TOL)
    np.testing.assert_allclose(t2n(got["pred"]), np.asarray(want["pred"]), **TOL)
    assert torch.equal(got["traj"][-1], got["pred"])


@pytest.fixture(autouse=True)
def _fast_emd(monkeypatch):
    # the val metrics here are checks of finiteness: 16 auction iterations
    monkeypatch.setenv("DIFFFACTO_EMD_ITERS", "16")


def tiny_cfg(tmp_path, name, **model_changes):
    cfg = Config(TINY)
    cfg.work_dir = str(tmp_path / name)
    for k, v in model_changes.items():
        cfg.model[k] = cfg.dfs(v) if isinstance(v, dict) else v
    return cfg


# --------------------------------------------------------------------- C4
def test_val_fixes_the_listed_parts_and_names_them(tmp_path, monkeypatch):
    """C4 and C3 in the runner: with ``fix_part_ids=[1]`` val fixes part 1
    (every generated shape takes the first one's code for it) and writes
    ``val/gen_fixed0100_<epoch>.npz``, the name the JAX runner builds from the
    mask (``runner.py:474-477``: "gen_fixed" and the mask's digits); with
    ``ret_traj`` the file holds ``traj_4``, ``traj_2`` and ``traj_0``
    (``ret_interval`` 2 at T = 5), each of the prediction's shape."""
    seen = []
    real = prunner.sample_generation

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        seen.append((kwargs["fixed_id"].clone(), out["latents"][0].clone()))
        return out

    monkeypatch.setattr(prunner, "sample_generation", spy)
    r = Runner(cfg=tiny_cfg(tmp_path, "fixed", fix_part_ids=[1], ret_traj=True), device="cpu")
    r.val()
    fixed = np.zeros(KC, np.float32)
    fixed[1] = 1
    name = "gen_fixed" + "".join(str(int(i)) for i in fixed)
    assert name == "gen_fixed0100"
    path = os.path.join(r.work_dir, "val", f"{name}_0.npz")
    assert os.path.exists(path)
    saved = np.load(path)
    for t in (4, 2, 0):
        assert saved[f"traj_{t}"].shape == saved["pred"].shape
    assert not np.allclose(saved["traj_4"], saved["traj_0"])
    assert seen and all(f.tolist() == fixed.tolist() for f, _ in seen)
    for _, codes in seen:
        assert torch.equal(codes[:, 1], codes[:1, 1].expand_as(codes[:, 1]))
        assert not torch.equal(codes[:, 0], codes[:1, 0].expand_as(codes[:, 0]))


# --------------------------------------------------------------------- C5
def _jax_fields(cls):
    if dataclasses.is_dataclass(cls):
        return [f.name for f in dataclasses.fields(cls) if f.name not in ("parent", "name")]
    return [p.name for p in inspect.signature(cls).parameters.values()
            if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]


def _registered_pairs():
    import difffacto_tpu.data  # noqa: F401  (registers)
    import difffacto_tpu.models  # noqa: F401
    import difffacto_tpu.runner  # noqa: F401
    import difffacto_torch.data  # noqa: F401
    import difffacto_torch.utils.loggers  # noqa: F401
    from difffacto_tpu.utils import registry as jreg
    from difffacto_torch.utils import registry as preg

    pairs = []
    for reg_name in sorted(vars(preg)):
        reg = getattr(preg, reg_name)
        if not isinstance(reg, preg.Registry):
            continue
        for key, cls in sorted(reg._modules.items()):
            jaxes = getattr(jreg, reg_name)._modules
            if key in jaxes:
                pairs.append(pytest.param(cls, jaxes[key], id=f"{reg_name}.{key}"))
    return pairs


@pytest.mark.parametrize("port_cls, jax_cls", _registered_pairs())
def test_constructor_takes_every_jax_field(port_cls, jax_cls):
    """C5: ``build_from_cfg`` drops a key the constructor does not take, as the
    JAX package's does; so every field of the JAX class must be a parameter
    of the port's, or a config's key would vanish without a word."""
    params = inspect.signature(port_cls).parameters
    missing = [f for f in _jax_fields(jax_cls) if f not in params and f != "dtype"]
    assert not missing, f"{port_cls.__name__} drops {missing}"


def test_gen_chair_reaches_the_port_with_no_key_dropped():
    """C5: of the keys of ``configs/gen_chair.py``'s model, encoder, aligner,
    PointNet, diffusion, denoiser and sampler, the port drops only those the
    JAX package drops too (the denoiser's ``use_linear``, which no JAX class
    takes); ``ret_interval=10`` reaches the model."""
    import difffacto_tpu.models  # noqa: F401  (registers)
    from difffacto_tpu.utils import registry as jreg
    from difffacto_torch.utils import registry as preg

    m = Config(GEN_CHAIR).model.dump()
    nested = [(m, "MODELS"), (m["encoder"], "ENCODERS"), (m["encoder"]["encoder"], "ENCODERS"),
              (m["encoder"]["part_aligner"], "ENCODERS"), (m["diffusion"], "DIFFUSIONS"),
              (m["diffusion"]["net"], "NETS"), (m["sampler"], "SAMPLERS")]
    for cfg, reg in nested:
        params = inspect.signature(getattr(preg, reg).get(cfg["type"])).parameters
        fields = _jax_fields(getattr(jreg, reg).get(cfg["type"]))
        dropped = [k for k in cfg if k != "type" and k not in params]
        assert not [k for k in dropped if k in fields], f"{cfg['type']} drops {dropped}"
    assert "use_linear" not in _jax_fields(jreg.NETS.get("TransformerNet"))
    pm = build_from_cfg(dict(Config(TINY).model.dump(), ret_interval=10), MODELS, device="cpu")
    assert pm.ret_interval == 10 and pm.interpolate_part_id == 2 and pm.noise_reg_loss


def test_unported_model_options_raise():
    """DDIM, ``pretrain_prior`` and the language options, which raised until
    they were ported, build the JAX package's step subset, one denoiser a
    part, and (with ``train_language`` only, as in the JAX module) the text
    encoder and the update MLP under the JAX names."""
    base = Config(TINY).model.dump()
    lstm = dict(type="LSTM", text_dim=8)
    pm = build_from_cfg(dict(base, language_encoder=lstm), MODELS, device="cpu")
    assert not hasattr(pm, "language_enc") and not hasattr(pm, "update_mlp")
    pm = build_from_cfg(dict(base, language_encoder=lstm, train_language=True), MODELS,
                        device="cpu")
    heads = {n.split(".")[0] for n, _ in pm.named_parameters()}
    assert {"language_enc", "update_mlp"} <= heads
    assert pm.update_mlp.dense0.kernel.shape == (8 + 16, 32)
    pm = build_from_cfg(dict(base, pretrain_prior=True), MODELS, device="cpu")
    heads = {n.split(".")[0] for n, _ in pm.named_parameters()}
    assert heads == {"encoder_mod"} | {f"net_list_{i}" for i in range(base["num_anchors"])}
    assert pm.net is pm.net_list[0]
    # DDIM raised here before the chain was ported; the model now builds
    # the JAX package's DDIM subset and direction coefficients from its keys.
    from difffacto_tpu.models.anchor_diff import build_diffusion as jax_build_diffusion

    diff = dict(base["diffusion"], ddim_sampling=True, ddim_nsteps=3, ddim_discretize="quad")
    pm = build_from_cfg(dict(base, diffusion=diff), MODELS, device="cpu")
    jd = jax_build_diffusion(diff, base["num_timesteps"])
    np.testing.assert_array_equal(pm.diff.steps, np.asarray(jd.steps))
    np.testing.assert_array_equal(pm.diff.xt_dir_coeff.numpy(), np.asarray(jd.xt_dir_coeff))


# ---------------------------------------------------------- reconstruction
@pytest.mark.parametrize("sample", [False, True])
def test_encode_part_code_matches_jax(pair, monkeypatch, sample):
    """The posterior means, or a posterior draw with its standard normal
    injected. Tolerance 1e-4."""
    jm, variables, pm = pair
    b = make_batch()
    eps = np.random.RandomState(7).randn(3, KC, ZDIM).astype(np.float32)
    patch_part_code_draw(monkeypatch, eps)
    want = jax.jit(lambda v, x, f: jm.apply(v, x, f, sample, method=JaxAnchorDiffAE.encode_part_code,
                                            rngs={"sample": jax.random.PRNGKey(0)}))(
        variables, jnp.asarray(b["input"]), jnp.asarray(b["attn_map"]))
    with torch.no_grad():
        got = pm.encode_part_code(torch.as_tensor(b["input"]), torch.as_tensor(b["attn_map"]),
                                  sample, eps=torch.as_tensor(eps))
    np.testing.assert_allclose(t2n(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("given_seg", [False, True])
def test_latents_to_decode_matches_jax(pair, given_seg):
    """ctx, per-point mean and variance, the seg mask (the equal split with
    an absent part's share to the first present one, or the one given) and
    the aligner's (mean, logvar), aligner noise injected. Tolerance 1e-4."""
    jm, variables, pm = pair
    rng = np.random.RandomState(8)
    B = 3
    codes = rng.randn(B, KC, ZDIM).astype(np.float32)
    valid = np.array([[1, 1, 1, 1], [1, 0, 1, 1], [0, 1, 1, 0]], np.float32)
    noise = rng.randn(B, 32).astype(np.float32)
    seg = make_batch(B)["ref_seg_mask"] if given_seg else None
    jseg = None if seg is None else jnp.asarray(seg)
    want = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda v, c, vi, n, s: jm.apply(v, c, vi, n, s, method=JaxAnchorDiffAE.latents_to_decode))(
        variables, jnp.asarray(codes), jnp.asarray(valid), jnp.asarray(noise), jseg))
    with torch.no_grad():
        got = pm.latents_to_decode(torch.as_tensor(codes), torch.as_tensor(valid),
                                   torch.as_tensor(noise),
                                   None if seg is None else torch.as_tensor(seg))
    np.testing.assert_array_equal(t2n(got[3]), want[3])
    for g, w in zip((got[0], got[1], got[2], *got[4]), (want[0], want[1], want[2], *want[4])):
        np.testing.assert_allclose(t2n(g), w, **TOL)


def test_reconstruct_matches_jax(pair, monkeypatch):
    """Encode and decode with (B, K, D) aligner noise, K = 2: the seg masks and
    part flags repeat K times; the part code's draw, x_T and the step draws
    injected. Tolerance 1e-4."""
    jm, variables, pm = pair
    B, Kh = 3, 2
    b = make_batch(B)
    rng = np.random.RandomState(9)
    noise = rng.randn(B, Kh, 32).astype(np.float32)
    eps = rng.randn(B, KC, ZDIM).astype(np.float32)
    x_T, step_noise = chain_draws(B * Kh, 10)
    patch_part_code_draw(monkeypatch, eps)
    patch_decode(monkeypatch, x_T, step_noise)
    want = jad.reconstruct(jm, variables, jax.random.PRNGKey(0), jb(b), noise=jnp.asarray(noise))
    got = reconstruct(pm, dict(pb(b), part_code_eps=torch.as_tensor(eps)),
                      noise=torch.as_tensor(noise), x_T=torch.as_tensor(x_T),
                      step_noise=torch.as_tensor(step_noise))
    assert got["pred"].shape == (B * Kh, N, 3)
    np.testing.assert_array_equal(t2n(got["seg_mask"]), np.asarray(want["seg_mask"]))
    np.testing.assert_array_equal(t2n(got["valid_id"]), np.asarray(want["valid_id"]))
    np.testing.assert_allclose(t2n(got["anchors"]), np.asarray(want["anchors"]), **TOL)
    np.testing.assert_allclose(t2n(got["pred"]), np.asarray(want["pred"]), **TOL)


def _jax_total(losses):
    return sum(v.mean() for k, v in losses.items() if "loss" in k)


def test_recon_losses_match_jax(pair, monkeypatch):
    """Every term of ``recon_losses`` at aligner noise z (the fit loss, the
    flow prior's, the noise's L2 penalty), and the z-gradient of their sum
    as ``optimize_noise`` descends it. Tolerance 1e-4 on the terms, 1e-4
    relative (1e-5 absolute) on the gradient."""
    jm, variables, pm = pair
    b = make_batch()
    rng = np.random.RandomState(11)
    z = rng.randn(3, 32).astype(np.float32)
    eps = rng.randn(3, KC, ZDIM).astype(np.float32)
    patch_part_code_draw(monkeypatch, eps)

    def losses(v, batch, z):
        return jm.apply(v, batch, z, method=JaxAnchorDiffAE.recon_losses,
                        rngs={"sample": jax.random.PRNGKey(0)})

    want = jax.jit(losses)(variables, jb(b), jnp.asarray(z))
    want_g = jax.jit(jax.grad(lambda z, v, batch: _jax_total(losses(v, batch, z))))(
        jnp.asarray(z), variables, jb(b))
    batch = dict(pb(b), part_code_eps=torch.as_tensor(eps))
    with torch.no_grad():
        got = pm.recon_losses(batch, torch.as_tensor(z))
    assert {k for k in got if "loss" in k} == {k for k in want if "loss" in k} \
        == {"fit_loss", "prior_loss", "reg_loss"}
    for k in want:
        np.testing.assert_allclose(t2n(got[k]), np.asarray(want[k]), err_msg=k, **TOL)
    total, g = recon_loss_and_grad(pm, batch, torch.as_tensor(z))
    np.testing.assert_allclose(float(total), float(_jax_total(want)), rtol=1e-5)
    np.testing.assert_allclose(t2n(g), np.asarray(want_g), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("targets", ["mean", "mean and var"])
def test_edit_losses_match_jax(pair, targets):
    """The fit, edit and regularisation terms of shape editing (part 1 edited,
    the others fixed, part 3 absent in a row) and the z-gradient of their sum
    as ``shape_edit`` descends it. Tolerance as for ``recon_losses``."""
    jm, variables, pm = pair
    b = make_batch()
    rng = np.random.RandomState(12)
    z = rng.randn(3, 32).astype(np.float32)
    fix = np.ones((3, KC), np.float32)
    fix[:, 1] = 0
    ref_vars = b["part_scale"] ** 2
    tmean = np.tile(np.array([[0.5, 0.0, 0.0]], np.float32), (3, 1))
    tvar = np.full((3, 3), 0.2, np.float32) if targets == "mean and var" else None
    args = (b["input"], b["attn_map"], b["present"], b["part_shift"], ref_vars, fix)

    def losses(z, v, *a):
        return jm.apply(v, z, *a, 1, jnp.asarray(tmean),
                        None if tvar is None else jnp.asarray(tvar), 0.5,
                        method=JaxAnchorDiffAE.edit_losses)

    jargs = [jnp.asarray(a) for a in args]
    want = jax.jit(losses)(jnp.asarray(z), variables, *jargs)
    want_g = jax.jit(jax.grad(lambda *a: _jax_total(losses(*a))))(jnp.asarray(z), variables, *jargs)
    targs = [torch.as_tensor(a) for a in args]
    tv = None if tvar is None else torch.as_tensor(tvar)
    with torch.no_grad():
        got = pm.edit_losses(torch.as_tensor(z), *targs, 1, torch.as_tensor(tmean), tv, 0.5)
    assert got.keys() == want.keys() == {"fit_loss", "edit_loss", "reg_loss"}
    for k in want:
        np.testing.assert_allclose(t2n(got[k]), np.asarray(want[k]), err_msg=k, **TOL)
    _, g = edit_loss_and_grad(pm, torch.as_tensor(z), *targs, 1, torch.as_tensor(tmean), tv, 0.5)
    np.testing.assert_allclose(t2n(g), np.asarray(want_g), rtol=1e-4, atol=1e-5)


def test_val_of_a_reconstruction_model(tmp_path):
    """A ``gen=False`` model's val (``runner.py:490-500``): the CIMLE noise of
    ``select_best_noise``, ``reconstruct``, written as ``val/sample_<epoch>.npz``
    and scored by the ``ae`` protocol (paired MMD-CD and MMD-EMD, finite)."""
    cfg = tiny_cfg(tmp_path, "recon", gen=False)
    cfg.model.encoder.gen = False
    cfg.dataset.val.eval_mode = "ae"
    metrics = Runner(cfg=cfg, device="cpu").val()
    assert set(metrics) == {"sample/MMD-CD", "sample/MMD-EMD"}
    assert all(np.isfinite(v) and v > 0 for v in metrics.values())
    saved = np.load(os.path.join(cfg.work_dir, "val", "sample_0.npz"))
    assert saved["pred"].shape == saved["input_ref"].shape
