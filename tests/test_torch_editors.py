"""The latent denoisers and the editors of the port against the JAX package.

On the CPU, at small shapes (B = 2, clouds of 32 points, 4 parts, latents
8 to 32 wide, T = 4), the weights bridged with ``load_jax_params`` and every
draw injected on both sides: the JAX side's ``jax.random.uniform`` (guidance
keep masks, the global shift and scale augments), ``bernoulli`` (flax's
dropout), the part code's reparameterisation, the timestep sampler, the
chain's noise, x_T and the step draws are replaced in the test by the
tensors the port takes through its batch and its calls, and the port's
dropout takes the same keep masks.

``LDMNet`` (two-attention and flat blocks, the time token on and off, the
class embedding, with a context and self-attending under a mask),
``PointwiseNetLatent``, the listener, ``LatentDiffEdit`` (losses and its
chain), ``PartLatentEditor``, ``ParameterTrainer``, ``Aligner``,
``PartglotFinetune``, the latent projection, and
``AnchorDiffGenSuperSegments``' loss over its option sets, predict, get_params,
combine_latent, anchor_drift and interpolate_latent; then which kernels
``LDMNet``'s blocks dispatch to.

Tolerances: 1e-5 for float32 forwards and losses; every training loss in
float64 on both sides (BatchNorm's batch statistics over few rows), but
those of the models with an LSTM, whose flax scan carries float32: those
train in float32 over 4 or 8 rows; gradients at 2e-4 of each tensor's
largest entry, or 2e-6 where that is below 1e-2, as
``tests/test_torch_language.py`` holds them; 1e-4 for a reverse chain.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import difffacto_tpu.models  # noqa: F401  (fills the JAX registries)
import difffacto_tpu.models.part_encoder as jpe
from difffacto_tpu.models import editors as jed
from difffacto_tpu.models.denoiser import LDMNet as JaxLDMNet
from difffacto_tpu.models.denoiser import PointwiseNetLatent as JaxPWL
from difffacto_tpu.models.language import tokenizing
from difffacto_torch import load_jax_params
from difffacto_torch.models import editors as ped
from difffacto_torch.models import language as plang
from difffacto_torch.models.denoiser import LDMNet, PointwiseNetLatent
from difffacto_torch.utils.jax_params import flatten_jax_tree
from test_model import tiny_batch, tiny_model_cfg
from test_torch_anchored_gen import Draws
from torch_pairs import RNGS, TOL, bridge, close, f64, np_, wide

torch.set_num_threads(1)

B, N, K, T = 2, 32, 4, 4
LB = 4  # the language batches that train BatchNorms in float32 (flax's LSTM scan is float32)
CHAIN_TOL = dict(rtol=1e-4, atol=1e-4)


def randn(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def patch_bernoulli(monkeypatch, masks):
    """flax's Dropout takes its keep masks from ``masks``, in order."""
    queue = [np.asarray(m, bool) for m in masks]

    def fake(key, p=0.5, shape=None):
        m = queue.pop(0)
        assert tuple(shape) == m.shape, (shape, m.shape)
        return jnp.asarray(m)

    monkeypatch.setattr(jax.random, "bernoulli", fake)
    return queue


def port_dropout(monkeypatch, masks, *modules):
    """The port's ``dropout`` in ``modules`` takes the same keep masks."""
    queue = [torch.from_numpy(np.asarray(m, bool)) for m in masks]

    def fake(x, p, train, generator=None):
        if not train or p <= 0.0:
            return x
        m = queue.pop(0)
        assert tuple(m.shape) == tuple(x.shape), (m.shape, x.shape)
        return x * m.to(x.dtype) / (1.0 - p)

    for mod in modules:
        monkeypatch.setattr(mod, "dropout", fake)
    return queue


def jax_loss_and_grads(jm, variables, args, method, epoch=0, x64=True):
    """The JAX model's loss dict, the gradients of the sum of its means and
    the moved BatchNorm statistics, in float64 (float32 where ``x64`` is
    off: flax's LSTM scan carries float32), as one jitted program."""
    widen = wide if x64 else np.asarray
    with jax.enable_x64(x64):
        v64 = f64(variables) if x64 else variables
        a64 = jax.tree_util.tree_map(lambda a: jnp.asarray(widen(a)) if hasattr(a, "shape")
                                     else a, args)

        def f(params):
            out, mut = jm.apply({**v64, "params": params}, *a64, epoch, method=method,
                                rngs={"sample": RNGS["sample"], "dropout": RNGS["dropout"]},
                                mutable=["batch_stats"])
            return sum(jnp.mean(v) for v in out.values()), (out, mut)

        (_, (out, mut)), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(v64["params"])
        return (jax.tree_util.tree_map(np.asarray, out), flatten_jax_tree(jax.device_get(grads)),
                flatten_jax_tree(jax.device_get(mut.get("batch_stats", {}))))


def port_loss_and_grads(pm, batch, epoch=0, call=None, x64=True):
    """The port's losses, gradients and moved buffers in float64 (or float32)."""
    pm64 = copy.deepcopy(pm).double() if x64 else copy.deepcopy(pm)
    widen = wide if x64 else np.asarray
    pb = {k: torch.as_tensor(widen(v)) if isinstance(v, np.ndarray) else v
          for k, v in batch.items()}
    out = call(pm64, pb) if call is not None else pm64.loss(pb, epoch)
    named = dict(pm64.named_parameters())
    total = sum(v.double().mean() for v in out.values() if v.requires_grad)
    grads = torch.autograd.grad(total, list(named.values()), allow_unused=True)
    return out, dict(zip(named, grads)), dict(pm64.named_buffers())


def hold_training(got, want, jax_nan=()):
    """Losses at TOL; every gradient at 2e-4 of its tensor's largest entry
    (2e-6 where that is below 1e-2: a bias before a BatchNorm has a zero
    gradient, which both sides compute as rounding); every moved statistic
    at TOL. (got, want) as the two helpers return. Parameters whose names
    start with one of ``jax_nan`` may have NaN JAX gradients; the port's must
    be finite there, and the finite entries are held."""
    (out, grads, buffers), (jout, jgrads, jstats) = got, want
    assert sorted(out) == sorted(jout)
    for k in jout:
        close(out[k], jout[k], what=k)
    assert sorted(grads) == sorted(jgrads)
    for name, w in jgrads.items():
        g = np.zeros_like(w) if grads[name] is None else np_(grads[name])
        if np.isnan(w).any():  # only where the test names it, and the port's finite
            assert name.startswith(tuple(jax_nan)), name
            assert np.isfinite(g).all(), name
            g, w = g[~np.isnan(w)], w[~np.isnan(w)]
            if not w.size:
                continue
        scale = float(np.abs(w).max())
        atol = 2e-4 * scale if scale >= 1e-2 else 2e-6
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=name)
    assert sorted(buffers) == sorted(jstats)
    for name, b in buffers.items():
        np.testing.assert_allclose(np_(b), jstats[name], err_msg=name, **TOL)


def lang_batch(seed=0, b=B):
    """The JAX tests' language batch: two clouds a row with their part
    maps, the second part referred to, one sentence."""
    seg = np.repeat(np.arange(K), N // K)[None].repeat(b, 0)
    onehot = np.eye(K, dtype=np.float32)[seg]
    ind = np.zeros((b, K), np.float32)
    ind[:, 1] = 1
    return {"target": randn(b, N, 3, seed=seed + 1), "distractor": randn(b, N, 3, seed=seed + 2),
            "target_attn_map": onehot, "distractor_attn_map": onehot, "part_indicator": ind,
            "text": np.stack([tokenizing("a chair with a tall back")] * b).astype(np.int32)}


def japply(jm, variables, *args, **kw):
    """``jm.apply`` compiled as one program (eager flax compiles op by op)."""
    return jax.jit(lambda v: jm.apply(v, *args, **kw))(variables)


def jnp_tree(batch):
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in batch.items()}


# ------------------------------------------------------------------ LDMNet
LDM_CASES = {
    "two_attn_ctx": dict(ctx=True),
    "flat_class_bias": dict(ctx=True, single_attn=True, class_cond=True,
                            cond_time_as_token=False),
    "two_attn_self_masked": dict(ctx=False, class_cond=True),
    "flat_self_masked_bias": dict(ctx=False, single_attn=True, cond_time_as_token=False),
}


@pytest.mark.parametrize("name", list(LDM_CASES))
def test_ldmnet_matches_jax(name):
    """(B, K, 8) from noisy latents: with a 24-wide context of K tokens (the
    mask unused, as the editor's chain passes none), or self-attending with
    ``valid_id`` masking a part (and the time token's 1 in front of it)."""
    case = dict(LDM_CASES[name])
    with_ctx = case.pop("ctx")
    kw = dict(in_channels=8, out_channels=8, n_heads=2, d_head=8, depth=2, n_class=K,
              context_dim=24 if with_ctx else None, **case)
    jm, pm = JaxLDMNet(**kw), LDMNet(**kw, device="cpu")
    x, ctx = randn(B, K, 8, seed=1), randn(B, K, 24, seed=2) if with_ctx else None
    t = np.array([3, 1], np.int32)
    vid = None if with_ctx else np.array([[1, 1, 0, 1], [1, 1, 1, 1]], np.float32)
    jargs = [jnp.asarray(a) if a is not None else None for a in (x, t, ctx, None, None, None, vid)]
    variables = bridge(jm, pm, *jargs, jit=True)
    want = japply(jm, variables, *jargs)
    got = pm(*[torch.from_numpy(a) if a is not None else None
               for a in (x, t, ctx, None, None, None, vid)])
    close(got, want)


@pytest.mark.parametrize("code", ["shape", "parts"])
def test_pointwise_net_latent_matches_jax(code):
    """Each part token modulated by [t, sin t, cos t | its prior | the code]:
    a (B, F) code zeroed on unselected parts with ``use_part_ind``, or a
    (B, K, F) code with ``res`` off."""
    kw = (dict(use_part_ind=True) if code == "shape" else dict(res=False))
    jm = JaxPWL(in_channels=8, out_channels=8, context_dim=5 + 6, hidden=(16, 8), **kw)
    pm = PointwiseNetLatent(in_channels=8, out_channels=8, context_dim=5 + 6, hidden=(16, 8),
                            device="cpu", **kw)
    x, prior = randn(B, K, 8, seed=3), randn(B, K, 5, seed=4)
    c = randn(B, 6, seed=5) if code == "shape" else randn(B, K, 6, seed=5)
    ind = np.array([[0, 1, 0, 0], [1, 0, 0, 1]], np.float32)
    t = np.array([0.3, 0.01], np.float32)
    args = (x, t, prior, c, ind)
    variables = bridge(jm, pm, *[jnp.asarray(a) for a in args], jit=True)
    close(pm(*[torch.from_numpy(a) for a in args]),
          japply(jm, variables, *[jnp.asarray(a) for a in args]))


# ---------------------------------------------------------------- listener
def test_listener_matches_jax(monkeypatch):
    """The logits in eval (running statistics), then ``listener_loss`` in
    training (float64): the LSTM's and the cross attention's dropout
    masks injected, the BatchNorms over B rows."""
    kw = dict(text_dim=16, part_dim=8, num_part=K, language_encoder=dict(type="LSTM", text_dim=16))
    jm, pm = jed.PartglotClassifier(**kw), ped.PartglotClassifier(**kw, device="cpu")
    b = lang_batch(b=2 * LB)
    lat, neg = randn(2 * LB, K, 8, seed=3), randn(2 * LB, K, 8, seed=4)
    args = [jnp.asarray(a) for a in (lat, b["text"], b["part_indicator"])]
    variables = bridge(jm, pm, *args, jit=True)
    close(pm(*[torch.from_numpy(a) for a in (lat, b["text"], b["part_indicator"])]),
          japply(jm, variables, *args))
    rng = np.random.RandomState(6)
    L = b["text"].shape[1]
    masks = [rng.rand(*s) > 0.3 for _ in range(2)
             for s in ((2 * LB, L, 100), (2 * LB, 4, 1, K), (2 * LB, 1, 8))]
    patch_bernoulli(monkeypatch, masks)
    port_dropout(monkeypatch, masks, plang)

    def method(m, pos, negative, text, ind, epoch):
        return m.listener_loss(pos, negative, text, ind)

    want = jax_loss_and_grads(jm, variables, (lat, neg, b["text"], b["part_indicator"]), method,
                              x64=False)
    got = port_loss_and_grads(pm, {}, x64=False, call=lambda m, _: m.listener_loss(
        *(torch.from_numpy(a) for a in (lat, neg, b["text"], b["part_indicator"]))))
    hold_training(got, want)


# ----------------------------------------------------------- LatentDiffEdit
def lde_cfg(**kw):
    return dict(encoder=dict(type="PointNet", zdim=8, point_dim=3 + K),
                diffusion=dict(type="LDM", net=dict(type="LDMNet", in_channels=8, out_channels=8,
                                                    n_heads=2, d_head=8, depth=1,
                                                    context_dim=8 + 16, n_class=K),
                               beta_1=1e-4, beta_T=0.02),
                sampler=dict(type="Uniform"), language_encoder=dict(type="LSTM", text_dim=16),
                num_anchors=K, num_timesteps=T, **kw)


_LDE = {}


def lde_pair(**kw):
    key = tuple(sorted(kw.items()))
    if key not in _LDE:
        jm, pm = jed.LatentDiffEdit(**lde_cfg(**kw)), ped.LatentDiffEdit(**lde_cfg(**kw),
                                                                          device="cpu")
        variables = bridge(jm, pm, jnp_tree(lang_batch()), 0, method=jed.LatentDiffEdit.loss,
                           jit=True)
        _LDE[key] = (jm, variables, pm)
    return _LDE[key]


@pytest.mark.parametrize("kw", [dict(), dict(guidance=True), dict(zero_part_latent=True)],
                         ids=["plain", "guidance", "zero_part_latent"])
def test_latent_diff_edit_loss_matches_jax(kw, monkeypatch):
    """The chain's loss on the target's latents (the encoder's BatchNorm
    over 2 B clouds), the text's dropout, the guidance keep mask (a part
    dropped), t and the noise injected; gradients too."""
    jm, variables, pm = lde_pair(**kw)
    b = lang_batch(seed=7, b=LB)
    rng = np.random.RandomState(8)
    keep = rng.rand(LB, b["text"].shape[1], 100) > 0.5
    part_keep = rng.rand(LB, K) > 0.3
    t, noise = np.array([0, 3, 1, 2], np.int32), rng.randn(LB, K, 8).astype(np.float32)
    patch_bernoulli(monkeypatch, [keep])
    Draws(monkeypatch, uniforms=[part_keep.astype(np.float64)] if kw.get("guidance") else [],
          t=t, noise=noise)
    want = jax_loss_and_grads(jm, variables, (b,), jed.LatentDiffEdit.loss, x64=False)
    b.update(text_keep=torch.from_numpy(keep), diffusion_t=torch.from_numpy(t),
             diffusion_noise=noise)
    if kw.get("guidance"):
        b["part_keep"] = torch.from_numpy(part_keep)
    hold_training(port_loss_and_grads(pm, b, x64=False), want)


def test_latent_diff_edit_chain_matches_jax():
    """The editor's own chain and net (``p_sample_loop`` over (B, K, 8)
    latents with its ctx of distractor latents and text), x_T and the step
    draws injected."""
    jm, variables, pm = lde_pair()
    rng = np.random.RandomState(9)
    ctx = rng.randn(B, K, 24).astype(np.float32)
    x_T, steps = rng.randn(B, K, 8).astype(np.float32), rng.randn(T, B, K, 8).astype(np.float32)

    def sample(m):
        return m.diff.p_sample_loop(lambda i, ts, c, *a: m.net(i, ts, c, *a), RNGS["sample"],
                                    jnp.zeros((B, K, 8)), ctx=jnp.asarray(ctx),
                                    noise=jnp.asarray(x_T), step_noise=jnp.asarray(steps))

    want = japply(jm, variables, method=sample)["pred"]
    with torch.inference_mode():
        got = pm.diff.p_sample_loop(lambda i, ts, c, *a: pm.net(i, ts, c, *a),
                                    torch.zeros(B, K, 8), ctx=torch.from_numpy(ctx),
                                    noise=torch.from_numpy(x_T),
                                    step_noise=torch.from_numpy(steps))["pred"]
    close(got, want, CHAIN_TOL)


# --------------------------------------------------- the other editor models
def ple_cfg():
    return dict(language_encoder=dict(type="LSTM", text_dim=16),
                latent_language_fuser=dict(type="LatentLanguageFuser", text_dim=16, part_dim=8),
                pcd_encoder=dict(type="PointNet", zdim=8, point_dim=3 + K), num_part_latent=K,
                text_dim=16, out_dim=8)


@pytest.mark.parametrize("kind", ["PartLatentEditor", "PartglotFinetune"])
def test_part_latent_editor_matches_jax(kind, monkeypatch):
    """Direction, magnitude and logit losses (the point encoder and the
    listener in eval, the text's dropout injected) and their gradients;
    ``PartglotFinetune`` returns its editor's. The JAX module differentiates
    the norms of the masked deltas at 0 (``editors.py:248-253``), which
    gives NaN gradients for everything before the fuser's output; torch's
    norm has a zero subgradient there, so the port's are finite and only
    the JAX package's finite entries are compared."""
    cfg = ple_cfg() if kind == "PartLatentEditor" else dict(
        editor=dict(type="PartLatentEditor", **ple_cfg()), num_part=K)
    jcls, pcls = getattr(jed, kind), getattr(ped, kind)
    jm, pm = jcls(**cfg), pcls(**cfg, device="cpu")
    variables = bridge(jm, pm, jnp_tree(lang_batch()), 0, method=jcls.loss, jit=True)
    b = lang_batch(seed=10)
    b["part_indicator"] = np.array([[0, 1, 0, 0], [1, 0, 1, 0]], np.float32)
    keep = np.random.RandomState(11).rand(B, b["text"].shape[1], 100) > 0.5
    patch_bernoulli(monkeypatch, [keep])
    want = jax_loss_and_grads(jm, variables, (b,), jcls.loss, x64=False)
    b["text_keep"] = torch.from_numpy(keep)
    pre = "editor_mod." if kind == "PartglotFinetune" else ""
    hold_training(port_loss_and_grads(pm, b, x64=False), want,
                  jax_nan=(pre + "fuser.", pre + "language_enc."))


def test_parameter_trainer_matches_jax(monkeypatch):
    """The part encoder's losses in training (the part code's draw
    injected) and their gradients."""
    cfg = dict(encoder=tiny_model_cfg()["encoder"], num_anchors=K, npoints=N)
    jm, pm = jed.ParameterTrainer(**cfg), ped.ParameterTrainer(**cfg, device="cpu")
    batch = {k: np.array(v) for k, v in tiny_batch(B=2).items()}
    variables = bridge(jm, pm, jnp_tree(batch), 0, method=jed.ParameterTrainer.loss, jit=True)
    batch = {k: np.array(v) for k, v in tiny_batch(B=2, rng=np.random.RandomState(12)).items()}
    eps = np.random.RandomState(13).randn(B, K, 16)
    queue = [eps]
    monkeypatch.setattr(jpe, "reparameterize_gaussian",
                        lambda rng, m, lv: m + jnp.exp(0.5 * lv) * jnp.asarray(queue.pop(0),
                                                                               m.dtype))
    want = jax_loss_and_grads(jm, variables, (batch,), jed.ParameterTrainer.loss)
    batch["part_code_eps"] = eps
    hold_training(port_loss_and_grads(pm, batch), want)


def test_aligner_matches_jax():
    """The fit loss in training (gradients too), then ``predict_params`` in
    eval with the batch's ids passed through."""
    cfg = dict(encoder=dict(type="PointNet", zdim=8, point_dim=3 + K), n_class=K)
    jm, pm = jed.Aligner(**cfg), ped.Aligner(**cfg, device="cpu")
    batch = {k: np.array(v) for k, v in tiny_batch(B=2).items()}
    batch["present"] = np.array([[1, 1, 0, 1], [1, 1, 1, 1]], np.float32)
    variables = bridge(jm, pm, jnp_tree(batch), 0, method=jed.Aligner.loss, jit=True)
    hold_training(port_loss_and_grads(pm, batch),
                  jax_loss_and_grads(jm, variables, (batch,), jed.Aligner.loss))
    want = japply(jm, variables, jnp_tree(batch), method=jed.Aligner.predict_params)
    got = pm.predict_params({k: torch.from_numpy(v) for k, v in batch.items()})
    assert want["index"] is None and got["index"] is None
    for k in ("mean", "logvar", "loss"):
        close(got[k], want[k], what=k)


@pytest.mark.parametrize("post_norm", ["gn", "bn"])
def test_latent_projection_post_ff_matches_jax(post_norm, monkeypatch):
    """The post feed-forward over (B, K, 32) with K > 1: flax's GroupNorm (32
    groups over the K tokens and each group's channels) or BatchNorm, SiLU,
    dropout (mask injected) and the zero-initialised ``ff_out`` (randomised)."""
    kw = dict(part_dim=32, param_dim=6, num_anchors=K, post_ff=True, post_norm=post_norm)
    jm, pm = jed._LatentProjection(**kw), ped._LatentProjection(**kw, device="cpu")
    lat = randn(B, K, 32, seed=14)
    params = randn(B, K, 6, seed=15)
    variables = bridge(jm, pm, jnp.asarray(lat), method=lambda m, x: m.up(*m.down(x)[:1],
                                                                           x[..., :6], x))
    keep = np.random.RandomState(16).rand(B, K, 32) > 0.2
    patch_bernoulli(monkeypatch, [keep])
    port_dropout(monkeypatch, [keep], ped)

    def up(m, x, p):
        return m.up(m.down(x)[0], p, x, deterministic=False)

    with jax.enable_x64(True):
        want, mut = jm.apply(f64(variables), jnp.asarray(wide(lat)), jnp.asarray(wide(params)),
                             method=up, rngs={"dropout": RNGS["dropout"]},
                             mutable=["batch_stats"])
    pm64 = copy.deepcopy(pm).double()
    got = pm64.up(pm64.down(torch.as_tensor(wide(lat)))[0], torch.as_tensor(wide(params)),
                  torch.as_tensor(wide(lat)), train=True)
    close(got, np.asarray(want))
    moved = flatten_jax_tree(jax.device_get(mut.get("batch_stats", {})))
    for n, b in pm64.named_buffers():
        np.testing.assert_allclose(np_(b), moved[n], err_msg=n, **TOL)


# ------------------------------------------------ AnchorDiffGenSuperSegments
C = 32
NET = dict(type="PointwiseNet", point_dim=3, residual=False, hidden=(16, 32, 16))


def ss_cfg(learn_variance=False, **kw):
    cfg = dict(encoder=dict(type="PCN", point_dim=7, part_latent_dim=C),
               decomposer=dict(type="ComponentMixer", part_latent_dim=C, include_attention=True,
                               include_global_feature=True),
               diffusion=dict(type="AnchoredDiffusion", net=NET, beta_1=1e-4, beta_T=0.02, k=1.0,
                              mode="linear", model_mean_type="epsilon",
                              learn_variance=learn_variance, include_anchors=False, res=False),
               sampler=dict(type="Uniform"), num_anchors=K, num_timesteps=T, npoints=N,
               part_dim=C, loss=dict(type="NegativeGaussianLogLikelihood"))
    cfg.update(kw)
    return cfg


def ss_batch(seed, b=B):
    batch = {k: np.array(v) for k, v in tiny_batch(B=b, rng=np.random.RandomState(seed)).items()}
    rng = np.random.RandomState(seed + 100)
    rng.shuffle(batch["seg_mask"][0])
    batch["attn_map"] = np.eye(K, dtype=np.float32)[batch["seg_mask"]]
    batch["part_means"] = rng.randn(b, K, 4).astype(np.float32)
    batch["global_anchor_mean"] = rng.randn(b, K, 3).astype(np.float32)
    return batch


_SS = {}
STRUCTURE = ("project_latent", "learn_var", "post_ff", "post_norm", "project_pe_type",
             "share_projection")


def ss_pair(**kw):
    """The two models of ``ss_cfg(**kw)`` on one set of weights, shared by
    every configuration with the same parameters (initialised once)."""
    key = tuple(sorted((k, str(v)) for k, v in kw.items() if k in STRUCTURE))
    if key not in _SS:
        shape = {k: v for k, v in kw.items() if k in STRUCTURE}
        jm = jed.AnchorDiffGenSuperSegments(**ss_cfg(**shape))
        pm = ped.AnchorDiffGenSuperSegments(**ss_cfg(**shape), device="cpu")
        _SS[key] = bridge(jm, pm, jnp_tree(ss_batch(17)), 0,
                          method=jed.AnchorDiffGenSuperSegments.loss, jit=True)
    variables = _SS[key]
    pm = ped.AnchorDiffGenSuperSegments(**ss_cfg(**kw), device="cpu")
    load_jax_params(pm, variables["params"], variables.get("batch_stats"))
    return jed.AnchorDiffGenSuperSegments(**ss_cfg(**kw)), variables, pm


SS_LOSS_CASES = {
    "plain": dict(),
    "bn_guidance_augments": dict(project_latent=True, learn_var=True, post_ff=True,
                                 post_norm="bn", guidance=True, global_shift=True,
                                 global_scale=True, learn_variance=True),
    "grouped_flat_primary_global": dict(project_latent=True, project_pe_type=2,
                                        share_projection=False, use_primary=True, loss=None,
                                        anchor_weight_annealing=True, annealing_epoch=5,
                                        use_zero_anchor=True, use_global_anchor=True),
    "gn_mlp_relu_scale_gt": dict(project_latent=True, learn_var=True, post_ff=True,
                                 post_norm="gn", project_pe_type=1, use_log_for_scale=False,
                                 detach_variance=False, detach_anchor=True,
                                 normal_diffusion=True, global_shift=True, vertical_only=False,
                                 use_gt_anchors=True),
}


@pytest.mark.parametrize("name", list(SS_LOSS_CASES))
def test_supseg_loss_matches_jax(name, monkeypatch):
    """``anchor_loss`` (the squared error, whatever ``loss`` names: see
    ``test_anchored_generation_builds_no_metrics_loss``) and the chain's
    losses in training (float64) over the option sets: no projection; the
    projection with the learned scale as the chain's variance, BatchNorm'd
    post-FF (its dropout injected), guidance and the global shift and scale
    augments; grouped per-part projections over the flattened latents with
    the primary latents decoded and the global anchors, the weight annealed
    at epoch 3; the MLP projection with GroupNorm, the ReLU'd scale, the
    anchors detached, plain diffusion, an all-axis shift and the gt anchors.
    Gradients too."""
    kw = dict(SS_LOSS_CASES[name])
    jm, variables, pm = ss_pair(**kw)
    batch = ss_batch(18)
    rng = np.random.RandomState(19)
    shift_u, scale_u = rng.rand(B, 1, 3), rng.rand(B, 1, 3)
    part_keep = np.array([[1, 0, 1, 1], [1, 1, 1, 1]], bool)
    global_keep = np.array([True, False])
    t, noise = np.array([0, 3], np.int32), rng.randn(B, N, 3)
    uniforms = ([shift_u] if kw.get("global_shift") else []) + (
        [scale_u] if kw.get("global_scale") else []) + (
        [part_keep.astype(np.float64), global_keep.astype(np.float64)]
        if kw.get("guidance") else [])
    keep = rng.rand(B, K, C) > 0.2
    if kw.get("post_ff"):
        patch_bernoulli(monkeypatch, [keep])
    Draws(monkeypatch, uniforms=uniforms, t=t, noise=noise)
    epoch = 3 if kw.get("anchor_weight_annealing") else 0
    want = jax_loss_and_grads(jm, variables, (batch,), jed.AnchorDiffGenSuperSegments.loss,
                              epoch)
    batch.update(global_shift_uniform=shift_u, global_scale_uniform=scale_u,
                 projection_keep=torch.from_numpy(keep),
                 part_keep=torch.from_numpy(part_keep), global_keep=torch.from_numpy(global_keep),
                 diffusion_t=torch.from_numpy(t), diffusion_noise=noise)
    hold_training(port_loss_and_grads(pm, batch, epoch), want)


SS_PREDICT_CASES = {
    "equal_split_traj": (dict(ret_traj=True, ret_interval=2), dict()),
    "seg_mask_learned_variance": (dict(project_latent=True, learn_var=True, learn_variance=True,
                                       post_ff=True, post_norm="bn"),
                                  dict(sample_by_seg_mask=True)),
    "forward_sample": (dict(), dict(forward_sample=True)),
    "zero_anchor_plain": (dict(project_latent=True, project_pe_type=2, share_projection=False,
                               use_zero_anchor=True), dict(normal_diffusion=True)),
}


@pytest.mark.parametrize("name", list(SS_PREDICT_CASES))
def test_supseg_predict_matches_jax(name, monkeypatch):
    """The reverse chain of the encoded shapes, x_T and the step draws
    injected: the equal split with the trajectory kept; the seg-mask
    assignment with the projected scale as the chain's variance; the
    forward chain of ``ref``; zero anchors and plain diffusion."""
    build, flags = SS_PREDICT_CASES[name]
    jm, variables, pm = ss_pair(**build)
    jm, pm = jm.clone(**flags), copy.copy(pm)
    for k, v in flags.items():
        setattr(pm, k, v)
    batch = ss_batch(20)
    rng = np.random.RandomState(21)
    x_T, steps = rng.randn(B, N, 3).astype(np.float32), rng.randn(T, B, N, 3).astype(np.float32)
    if flags.get("forward_sample"):
        Draws(monkeypatch, normals=[x_T])
    else:
        Draws(monkeypatch, x_T=x_T, steps=steps)
    run = jm.apply if build.get("ret_traj") else functools.partial(japply, jm)  # traj_t: numpy
    want = run(variables, jnp_tree(batch), method=jed.AnchorDiffGenSuperSegments.predict,
               rngs={"sample": RNGS["sample"]})
    got = pm.predict({k: torch.from_numpy(v) for k, v in batch.items()},
                     noise=torch.from_numpy(x_T), step_noise=torch.from_numpy(steps))
    keys = ("pred", "anchors", "assigned_anchor", "input_ref") + (
        ("traj",) if "traj" in want else ())
    for k in keys:
        close(got[k], want[k], CHAIN_TOL, what=k)
    np.testing.assert_array_equal(np_(got["seg_mask"]), np.asarray(want["seg_mask"]))
    if "traj_t" in want:
        np.testing.assert_array_equal(np.asarray(got["traj_t"]), np.asarray(want["traj_t"]))


@pytest.mark.parametrize("learn_var", [False, True])
def test_supseg_methods_match_jax(learn_var, monkeypatch):
    """``get_params`` (the double exponential and its one log), then
    ``combine_latent`` (part i from shape ids[i]), ``anchor_drift`` (3
    magnitudes, the directions injected) and ``interpolate_latent`` (3
    steps; the batch carries a list, which both drop), each chain's draws
    injected."""
    jm, variables, pm = ss_pair(**(
        dict(project_latent=True, learn_var=True, post_ff=True, post_norm="gn", project_pe_type=1)
        if learn_var else dict(project_latent=True, project_pe_type=2, share_projection=False)))
    batch = ss_batch(22, b=4)
    pb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jb = jnp_tree(batch)
    close(pm.get_params(pb), japply(jm, variables, jb,
                                    method=jed.AnchorDiffGenSuperSegments.get_params))
    rng = np.random.RandomState(23)
    runs = (("combine_latent", ([3, 0, 2, 1],), {}, 1),
            ("anchor_drift", (3,), {}, 12),
            ("interpolate_latent", (0, 2, 1, 3), {"names": ["a", "b", "c", "d"]}, 3))
    for method, args, extra, rows in runs:
        x_T = rng.randn(rows, N, 3).astype(np.float32)
        steps = rng.randn(T, rows, N, 3).astype(np.float32)
        direction = rng.randn(4, 3, K, 1).astype(np.float32)
        with monkeypatch.context() as mp:
            Draws(mp, normals=[direction] if method == "anchor_drift" else [], x_T=x_T,
                  steps=steps)
            want = japply(jm, variables, {**jb, **extra}, *args,
                          method=getattr(jed.AnchorDiffGenSuperSegments, method),
                          rngs={"sample": RNGS["sample"]})
        kw = dict(noise=torch.from_numpy(x_T), step_noise=torch.from_numpy(steps))
        if method == "anchor_drift":
            kw["direction"] = torch.from_numpy(direction)
        got = getattr(pm, method)({**pb, **extra}, *args, **kw)
        for k in ("pred", "anchors"):
            if k in want:
                close(got[k], want[k], CHAIN_TOL, what=f"{method} {k}")
        np.testing.assert_array_equal(np_(got["seg_mask"]), np.asarray(want["seg_mask"]))


# ------------------------------------------------------- kernel dispatch
@pytest.mark.parametrize("single_attn", [False, True])
@pytest.mark.parametrize("inner", [128, 256])
def test_ldmnet_blocks_take_the_jax_packages_kernels(single_attn, inner, monkeypatch):
    """Sampling-shaped calls (no gradient, 8 heads, a context of the K
    distractor-and-text tokens): two-attention blocks end in the fused FF
    over the B (K + 1) tokens where ``pick_tile`` takes them (B7), once a
    block; the flat blocks never reach the one-block kernel (B6), whose
    rule tiles a shape's K + 1 tokens, which ``pick_tile`` refuses, as in
    the JAX package."""
    from difffacto_torch.nn import attention, layers

    calls = {"fused_ff": 0, "fused_block": 0}

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(layers, "fused_ln_geglu_ff", spy("fused_ff", layers.fused_ln_geglu_ff))
    monkeypatch.setattr(attention, "fused_block", spy("fused_block", attention.fused_block))
    net = LDMNet(in_channels=16, out_channels=16, n_heads=8, d_head=inner // 8, depth=2,
                 context_dim=24, single_attn=single_attn, device="cpu")
    rows = 256 // (inner // 128) if not single_attn else 2  # B (K + 1) = 640 or 1280
    with torch.inference_mode():
        out = net(torch.randn(rows, K, 16), torch.arange(rows) % T, torch.randn(rows, K, 24))
    assert out.shape == (rows, K, 16)
    assert calls == {"fused_ff": 0 if single_attn else 2, "fused_block": 0}
