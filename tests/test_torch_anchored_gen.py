"""The anchored generators and their parts in the port against the JAX package.

On the CPU, at small shapes (B = 2, clouds of 32 points, 4 anchors, latents
16 wide; super-segment batches of 6 segments of 16 points), the weights
bridged with ``load_jax_params`` and every draw injected on both sides: the
segmentor and the conditional BatchNorm, every super-segment encoder (with
the masked-slot invariance), ``MeanVarianceRegressor``, ``Pnet2Stage`` and
``PCN``, ``ComponentMixer`` over its options, ``PartCodeTransformer`` and
``V2``, ``AnchoredGeneration``'s loss and predict, ``AnchorDiffGenPartglot``'s
loss, predict, latent interpolation and combination, and the registries.

Tolerances: 1e-5 for f32 forwards and losses; train mode (BatchNorm batch
statistics and the running statistics they move, every training loss of
the two generators, whose encoders train on batch statistics) in float64 on
both sides; 1e-4 for a whole reverse chain (a few f32 denoiser calls summed
in other orders).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import difffacto_tpu.models  # noqa: F401  (fills the JAX registries)
import difffacto_tpu.parallel.optim  # noqa: F401
import difffacto_tpu.utils.gaussian as jgauss
from difffacto_tpu.models.diffusion import AnchoredDiffusion as JaxDiffusion
from difffacto_tpu.models.orchestrators_extra import AnchorDiffGenPartglot as JaxPartglot
from difffacto_tpu.models.orchestrators_extra import AnchoredGeneration as JaxAnchoredGen
from difffacto_tpu.models.samplers import Uniform as JaxUniform
from difffacto_tpu.models.segmentor import ConditionalBatchNorm1d as JaxCBN
from difffacto_tpu.utils import registry as JR
from difffacto_torch import load_jax_params
from difffacto_torch.models import AnchorDiffGenPartglot, AnchoredGeneration
from difffacto_torch.models.segmentor import ConditionalBatchNorm1d
from difffacto_torch.utils import registry as PR
from difffacto_torch.utils.jax_params import flatten_jax_tree
from test_torch_generation import randomize
from torch_pairs import RNGS, TOL, bridge, close, f64, hold, np_, wide

torch.set_num_threads(1)

B, N, K, C = 2, 32, 4, 16
NSEG, NPT = 6, 16


def module_pair(registry, cfg, **extra):
    kind = cfg["type"]
    kw = {k: v for k, v in cfg.items() if k != "type"}
    jm = getattr(JR, registry).get(kind)(**kw, **extra)
    pm = getattr(PR, registry).get(kind)(**kw, **extra, device="cpu")
    return jm, pm


def train_call(m, v, a, t, **k):
    return m.apply(v, *a, train=t, **k)


def port_call(m, a, t):
    return m(*a, train=t)


# ---------------------------------------------------------------- segmentor
@pytest.mark.parametrize("train", [False, True])
def test_segmentor_matches_jax(train):
    """Per-point log-probabilities (B, N, n_class) and the global code."""
    jm, pm = module_pair("SEGMENTORS", dict(type="PointNetDenseCls", n_class=5))
    pts = (0.3 * np.random.RandomState(1).randn(B, N, 3)).astype(np.float32)
    variables = bridge(jm, pm, jnp.asarray(pts))
    hold(jm, variables, pm, [pts], train, train_call, port_call)


@pytest.mark.parametrize("gammas,betas", [(True, True), (False, True), (True, False)])
def test_conditional_batch_norm_matches_jax(gammas, betas):
    """Batch statistics with the unbiased variance, gamma and beta moved by
    the conditioning MLPs (each switchable)."""
    kw = dict(channels=8, embed_t_size=12, emb_size=10, use_gammas=gammas, use_betas=betas)
    jm, pm = JaxCBN(**kw), ConditionalBatchNorm1d(**kw, device="cpu")
    rng = np.random.RandomState(2)
    x, cond = rng.randn(B, N, 8).astype(np.float32), rng.randn(B, 12).astype(np.float32)
    variables = bridge(jm, pm, jnp.asarray(x), jnp.asarray(cond))
    hold(jm, variables, pm, [x, cond], False,
         lambda m, v, a, t, **k: m.apply(v, *a, **k), lambda m, a, t: m(*a))


# ---------------------------------------------------------------- encoders
def supsegs(seed, b=B):
    rng = np.random.RandomState(seed)
    x = (0.3 * rng.randn(b, NSEG, NPT, 3)).astype(np.float32)
    geo = np.ones((b, NSEG), np.float32)
    geo[:, 5] = 0.0
    geo[1, 2] = 0.0
    return x, geo


@pytest.mark.parametrize("train", [False, True])
def test_supsegs_encoder_matches_jax(train):
    """(B, 4, 16) part latents from super-segments, two of them masked."""
    jm, pm = module_pair("ENCODERS", dict(type="SupSegsEncoder", sup_segs_dim=8,
                                          part_latent_dim=C))
    x, geo = supsegs(3)
    variables = bridge(jm, pm, jnp.asarray(x), jnp.asarray(geo))
    hold(jm, variables, pm, [x, geo], train, train_call, port_call)


def test_supsegs_encoder_ignores_masked_segments():
    """In eval mode a masked segment's points change nothing, in either
    package: the additive mask keeps it out of both maxima."""
    jm, pm = module_pair("ENCODERS", dict(type="SupSegsEncoder", sup_segs_dim=8,
                                          part_latent_dim=C))
    x, geo = supsegs(4)
    variables = bridge(jm, pm, jnp.asarray(x), jnp.asarray(geo))
    moved = x.copy()
    moved[:, 5] += 3.0
    moved[1, 2] *= -2.0
    for a in (x, moved):
        want = jm.apply(variables, jnp.asarray(a), jnp.asarray(geo))
        got = pm(torch.from_numpy(a), torch.from_numpy(geo))
        close(got, want)
    base = pm(torch.from_numpy(x), torch.from_numpy(geo))
    assert torch.allclose(pm(torch.from_numpy(moved), torch.from_numpy(geo)), base, atol=1e-6)


def test_partglot_cbn_encoder_matches_jax():
    """The per-point stack with timestep-conditional BatchNorm."""
    jm, pm = module_pair("ENCODERS", dict(type="PartglotSupSegsEncoderWithCBN", sup_segs_dim=8,
                                          embed_t_size=12, emb_size=10))
    rng = np.random.RandomState(5)
    x = (0.3 * rng.randn(B, N, 3)).astype(np.float32)
    t = np.array([3, 40], np.int32)
    variables = bridge(jm, pm, jnp.asarray(x), jnp.asarray(t))
    hold(jm, variables, pm, [x, t], False, train_call, port_call)


@pytest.mark.parametrize("train", [False, True])
def test_mean_variance_regressor_matches_jax(train):
    """Per-part mean and logvar, each slot's BatchNorm statistics its own."""
    jm, pm = module_pair("ENCODERS", dict(type="MeanVarianceRegressor", latent_dim=C,
                                          num_class=K))
    x = np.random.RandomState(6).randn(B + 2, K, C).astype(np.float32)
    variables = bridge(jm, pm, jnp.asarray(x))
    hold(jm, variables, pm, [x], train, train_call, port_call)


@pytest.mark.parametrize("cfg", [dict(type="Pnet2Stage", latent_dim=24, point_dim=3),
                                 dict(type="PCN", point_dim=7, part_latent_dim=C),
                                 dict(type="PCN", point_dim=7, part_latent_dim=C,
                                      normalize_latent=True)],
                         ids=["pnet2stage", "pcn", "pcn_normalized"])
@pytest.mark.parametrize("train", [False, True])
def test_two_stage_encoders_match_jax(cfg, train):
    """The [global, local] two-stage PointNets."""
    jm, pm = module_pair("ENCODERS", cfg)
    x = (0.3 * np.random.RandomState(7).randn(B, N, cfg["point_dim"])).astype(np.float32)
    variables = bridge(jm, pm, jnp.asarray(x))
    hold(jm, variables, pm, [x], train, train_call, port_call)


# -------------------------------------------------------------- decomposers
MIXER_CASES = [dict(mlp_type=m, attention=a, global_mlp_type=g)
               for m in (0, 1) for a in ("gat", "mhsa", "none") for g in (0, 1)]


def mixer_cfg(mlp_type, attention, global_mlp_type, **extra):
    return dict(type="ComponentMixer", part_latent_dim=C, num_anchors=K, mlp_type=mlp_type,
                include_attention=attention != "none", use_graph_attention=attention == "gat",
                nheads=4, include_global_feature=True, global_mlp_type=global_mlp_type, **extra)


@pytest.mark.parametrize("case", MIXER_CASES + [
    dict(mlp_type=0, attention="gat", global_mlp_type=1, train=True),
    dict(mlp_type=1, attention="mhsa", global_mlp_type=1, train=True),
    dict(mlp_type=0, attention="mhsa", global_mlp_type=0, res=False, attn_ln=False,
         normalize_latent=True),
    dict(mlp_type=1, attention="gat", global_mlp_type=0, type="ComponentMixerV2",
         normalize_latent=True)],
    ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_component_mixer_matches_jax(case):
    """(global code, anchors (B, K, 3), mixed latents) over mlp_type 0 and
    1 x GAT, MHSA or no attention x global_mlp_type 0 and 1; the BatchNorm'd
    aggregator in training; without the residuals and LayerNorms; the latents
    normalised; ``ComponentMixerV2``."""
    case = dict(case)
    train = case.pop("train", False)
    kind = case.pop("type", "ComponentMixer")
    cfg = mixer_cfg(**case)
    cfg["type"] = kind
    if kind == "ComponentMixerV2":
        cfg.pop("include_attention")
    jm, pm = module_pair("DECOMPOSERS", cfg)
    x = np.random.RandomState(8).randn(B + 2, K, C).astype(np.float32)
    variables = bridge(jm, pm, jnp.asarray(x))
    hold(jm, variables, pm, [x], train, train_call, port_call)


PCT_CASES = {
    "masked_width": dict(cls="PartCodeTransformer", output_channels=16, mask=True,
                         use_mask_in_transformer=True),
    "fallback": dict(cls="PartCodeTransformer", output_channels=6, mask=True,
                     class_cond=False),
    "no_mask": dict(cls="PartCodeTransformer", output_channels=16, mask=False,
                    param_cond=False),
    "v2_post_mlp": dict(cls="PartCodeTransformerV2", output_channels=8, mask=True,
                        post_mlp=True),
}


@pytest.mark.parametrize("name", list(PCT_CASES))
def test_part_code_transformer_matches_jax(name):
    """The ViT over part tokens: [x | params | class embedding], masked
    attention, zeroed absent codes, the global code from the masked codes
    (output width = width) or the hidden state; ``V2`` flattening its
    per-token codes through its MLP."""
    case = dict(PCT_CASES[name])
    cls, use_mask = case.pop("cls"), case.pop("mask")
    kw = dict(input_channels=5, n_ctx=K, width=16, layers=2, heads=2, param_dim=6, **case)
    jm, pm = JR.DECOMPOSERS.get(cls)(**kw), PR.DECOMPOSERS.get(cls)(**kw, device="cpu")
    rng = np.random.RandomState(9)
    x = rng.randn(B, K, 5).astype(np.float32)
    params = [rng.randn(B, K, 3).astype(np.float32) for _ in range(2)]
    mask = np.array([[1, 1, 0, 1], [1, 1, 1, 1]], np.float32)
    if not kw.get("param_cond", True):
        params = []
    inputs = [x, mask if use_mask else None] + params
    jargs = lambda a: (a[0], tuple(a[2:]), a[1])
    jin = [jnp.asarray(a) if a is not None else None for a in inputs]
    variables = jm.init(RNGS, *jargs(jin))
    variables = {"params": randomize(jax.tree_util.tree_map(np.asarray, variables["params"]),
                                     10)}
    load_jax_params(pm, variables["params"])
    want = jm.apply(variables, *jargs(jin))
    tin = [torch.from_numpy(a) if a is not None else None for a in inputs]
    got = pm(tin[0], tuple(tin[2:]), tin[1])
    close(got, want)


# ------------------------------------------------------ AnchoredGeneration
NET = dict(type="PointwiseNet", point_dim=3, residual=False, hidden=(16, 32, 16))
DIFF = dict(type="AnchoredDiffusion", net=NET, beta_1=1e-4, beta_T=0.02, k=1.0, mode="linear",
            model_mean_type="epsilon", learn_variance=True, include_anchors=False, res=False)
T = 4


def gen_cfg(**extra):
    cfg = dict(encoder=dict(type="PCN", point_dim=7, part_latent_dim=C),
               parameter_regressor=dict(type="MeanVarianceRegressor", latent_dim=C),
               decomposer=dict(type="ComponentMixer", part_latent_dim=C, include_attention=True,
                               include_global_feature=True),
               diffusion=DIFF, sampler=dict(type="Uniform"), num_anchors=K, num_timesteps=T,
               npoints=N)
    cfg.update(extra)
    return cfg


def cloud_batch(seed, b=B):
    rng = np.random.RandomState(seed)
    pts = (0.3 * rng.randn(b, N, 3)).astype(np.float32)
    seg = np.repeat(np.arange(K), N // K)[None].repeat(b, 0).astype(np.int32)
    rng.shuffle(seg[1])
    return {"input": pts, "ref": pts.copy(), "seg_mask": seg,
            "attn_map": np.eye(K, dtype=np.float32)[seg]}


_GEN = {}


def gen_pair(guidance):
    if guidance not in _GEN:
        cfg = gen_cfg(guidance=guidance)
        jm, pm = JaxAnchoredGen(**cfg), AnchoredGeneration(**cfg, device="cpu")
        batch = {k: jnp.asarray(v) for k, v in cloud_batch(11).items()}
        variables = bridge(jm, pm, batch, 0, method=JaxAnchoredGen.loss, jit=True)
        _GEN[guidance] = (jm, variables, pm)
    return _GEN[guidance]


class Draws:
    """The JAX side's draws, injected: the posterior's normals, the guidance
    keep masks (uniforms 1 to keep, 0 to drop), the timesteps, the chain's
    noise, x_T and the step draws."""

    def __init__(self, mp, eps=(), uniforms=(), t=None, noise=None, x_T=None, steps=None,
                 normals=()):
        queue = [jnp.asarray(e) for e in eps]
        mp.setattr(jgauss, "reparameterize_gaussian",
                   lambda rng, m, lv: m + jnp.exp(0.5 * lv) * queue.pop(0).astype(m.dtype))
        uq = [jnp.asarray(u) for u in uniforms]
        mp.setattr(jax.random, "uniform", lambda key, shape=(), *a, **k: uq.pop(0))
        nq = [jnp.asarray(n) for n in normals]
        real_normal = jax.random.normal

        def normal(key, shape=(), dtype=jnp.float32):
            if not nq:
                return real_normal(key, shape, dtype)
            n = nq.pop(0)
            assert tuple(shape) == n.shape, (shape, n.shape)
            return n.astype(dtype)

        mp.setattr(jax.random, "normal", normal)
        if t is not None:
            mp.setattr(JaxUniform, "sample",
                       lambda self, key, n: (jnp.asarray(t), jnp.ones((n,), jnp.float32)))
        if noise is not None:
            real = JaxDiffusion.training_losses
            mp.setattr(JaxDiffusion, "training_losses", lambda self, fn, key, x, tt, **kw: real(
                self, fn, key, x, tt, **dict(kw, noise=jnp.asarray(noise, x.dtype))))
        if x_T is not None:
            loop = JaxDiffusion.p_sample_loop
            mp.setattr(JaxDiffusion, "p_sample_loop", lambda self, fn, key, anchors, **kw: loop(
                self, fn, key, anchors, **dict(kw, noise=jnp.asarray(x_T),
                                               step_noise=jnp.asarray(steps))))
        self.left = (queue, uq, nq)


@pytest.mark.parametrize("guidance", [False, True])
def test_anchored_generation_loss_matches_jax(guidance, monkeypatch):
    """mse, prior and anchor losses in training (the encoder's and the
    regressor's batch statistics, and the statistics they move), the
    posterior draw, the guidance keep masks (a part and a shape dropped), t
    and the chain's noise injected; float64 on both sides."""
    hold_anchored_loss(*gen_pair(guidance), guidance, monkeypatch)


def test_anchored_generation_builds_no_metrics_loss(monkeypatch):
    """C10: with ``loss`` naming a ``METRICS`` loss the anchor loss is still
    the squared error, as in the JAX module, whose flax dataclass freezes
    the dict so that its ``isinstance(self.loss, dict)`` never holds."""
    jm, variables, pm = gen_pair(False)
    metric = dict(type="NegativeGaussianLogLikelihood")
    pm2 = AnchoredGeneration(**gen_cfg(loss=metric), device="cpu")
    pm2.load_state_dict(pm.state_dict())
    hold_anchored_loss(jm.clone(loss=metric), variables, pm2, False, monkeypatch)


def hold_anchored_loss(jm, variables, pm, guidance, monkeypatch):
    batch = cloud_batch(12)
    rng = np.random.RandomState(13)
    eps = rng.randn(B, K, C)
    part_keep = np.array([[1, 0, 1, 1], [1, 1, 1, 1]], bool)
    global_keep = np.array([True, False])
    t = np.array([0, 3], np.int32)
    noise = rng.randn(B, N, 3)
    uniforms = [part_keep.astype(np.float64), global_keep.astype(np.float64)] if guidance else []
    draws = Draws(monkeypatch, eps=[eps], uniforms=uniforms, t=t, noise=noise)
    with jax.enable_x64(True):
        want, mutated = jm.apply(f64(variables), {k: jnp.asarray(wide(v)) for k, v in batch.items()},
                                 0, method=JaxAnchoredGen.loss,
                                 rngs={"sample": RNGS["sample"]}, mutable=["batch_stats"])
        want = jax.tree_util.tree_map(np.asarray, want)
        moved = flatten_jax_tree(jax.device_get(mutated["batch_stats"]))
    assert not any(draws.left)
    pm64 = copy.deepcopy(pm).double()
    pb = {k: torch.as_tensor(wide(v)) for k, v in batch.items()}
    pb.update(latent_eps=torch.from_numpy(eps), diffusion_t=torch.from_numpy(t),
              diffusion_noise=torch.from_numpy(noise))
    if guidance:
        pb.update(part_keep=torch.from_numpy(part_keep), global_keep=torch.from_numpy(global_keep))
    got = pm64.loss(pb, 0)
    assert sorted(got) == sorted(want)
    for k in want:
        close(got[k], want[k], what=k)
    for n, b in pm64.named_buffers():
        np.testing.assert_allclose(np_(b), moved[n], err_msg=n, **TOL)


@pytest.mark.parametrize("mode", ["sample", "fix_part", "forward_sample"])
def test_anchored_generation_predict_matches_jax(mode, monkeypatch):
    """Sampled latents decoded (z, x_T and the step draws injected); with
    ``fix_part`` one z shared but for anchor slot 0; with ``forward_sample``
    the forward chain of the batch's clouds around the sampled anchors."""
    jm, variables, pm = gen_pair(False)
    extra = {"fix_part": mode == "fix_part", "forward_sample": mode == "forward_sample"}
    jm, pm = jm.clone(**extra), copy.copy(pm)
    pm.fix_part, pm.forward_sample = extra["fix_part"], extra["forward_sample"]
    batch = cloud_batch(14)
    rng = np.random.RandomState(15)
    if mode == "fix_part":
        base, slot = rng.randn(1, K, C).astype(np.float32), rng.randn(B, C).astype(np.float32)
        normals = [base, slot]
        z = np.repeat(base, B, 0)
        z[:, 0] = slot
    else:
        z = rng.randn(B, K, C).astype(np.float32)
        normals = [z]
    x_T = rng.randn(B, N, 3).astype(np.float32)
    steps = rng.randn(T, B, N, 3).astype(np.float32)
    if mode == "forward_sample":
        normals.append(x_T)
        Draws(monkeypatch, normals=normals)
    else:
        Draws(monkeypatch, normals=normals, x_T=x_T, steps=steps)
    want = jm.apply(variables, {k: jnp.asarray(v) for k, v in batch.items()},
                    method=JaxAnchoredGen.predict, rngs={"sample": RNGS["sample"]})
    got = pm.predict({k: torch.as_tensor(v) for k, v in batch.items()}, z=torch.from_numpy(z),
                     noise=torch.from_numpy(x_T), step_noise=torch.from_numpy(steps))
    tol = dict(rtol=1e-4, atol=1e-4)
    for k in ("anchors", "assigned_anchor", "pred"):
        close(got[k], want[k], tol, what=k)
    np.testing.assert_array_equal(np_(got["seg_mask"]), np.asarray(want["seg_mask"]))
    if mode == "forward_sample":
        close(got["traj"], want["traj"], tol, what="traj")


# --------------------------------------------------- AnchorDiffGenPartglot
PARTGLOT = dict(encoder=dict(type="SupSegsEncoder", sup_segs_dim=8, part_latent_dim=C),
                decomposer=dict(type="ComponentMixer", part_latent_dim=C,
                                include_attention=True, include_global_feature=True),
                diffusion=DIFF, sampler=dict(type="Uniform"), num_anchors=K, num_timesteps=T,
                npoints=N)


def seg_batch(seed, b=B):
    x, geo = supsegs(seed, b)
    rng = np.random.RandomState(seed + 1)
    return {"input": x, "ref": (x + 0.01 * rng.randn(*x.shape)).astype(np.float32),
            "seg_mask": rng.randint(0, K, (b, NSEG)).astype(np.int32), "geo_mask": geo}


@pytest.fixture(scope="module")
def partglot_pair():
    jm, pm = JaxPartglot(**PARTGLOT), AnchorDiffGenPartglot(**PARTGLOT, device="cpu")
    batch = {k: jnp.asarray(v) for k, v in seg_batch(16).items()}
    variables = bridge(jm, pm, batch, 0, method=JaxPartglot.loss, jit=True)
    return jm, variables, pm


def test_partglot_loss_matches_jax(partglot_pair, monkeypatch):
    """``anchor_loss`` and ``diffusion_loss`` over the valid segments, in
    training (float64), t and the chain's noise (B n_seg rows) injected."""
    jm, variables, pm = partglot_pair
    batch = seg_batch(17)
    rng = np.random.RandomState(18)
    t = rng.randint(0, T, B * NSEG).astype(np.int32)
    noise = rng.randn(B * NSEG, NPT, 3)
    Draws(monkeypatch, t=t, noise=noise)
    with jax.enable_x64(True):
        want, mutated = jm.apply(f64(variables), {k: jnp.asarray(wide(v)) for k, v in batch.items()},
                                 0, method=JaxPartglot.loss, rngs={"sample": RNGS["sample"]},
                                 mutable=["batch_stats"])
        want = jax.tree_util.tree_map(np.asarray, want)
        moved = flatten_jax_tree(jax.device_get(mutated["batch_stats"]))
    pm64 = copy.deepcopy(pm).double()
    pb = {k: torch.as_tensor(wide(v)) for k, v in batch.items()}
    pb.update(diffusion_t=torch.from_numpy(t), diffusion_noise=torch.from_numpy(noise))
    got = pm64.loss(pb, 0)
    assert sorted(got) == sorted(want)
    for k in want:
        close(got[k], want[k], what=k)
    for n, b in pm64.named_buffers():
        np.testing.assert_allclose(np_(b), moved[n], err_msg=n, **TOL)


@pytest.mark.parametrize("method", ["predict", "interpolate_latent", "combine_latent"])
def test_partglot_decoding_matches_jax(partglot_pair, method, monkeypatch):
    """The decomposed latents decoded on an equal split of the points; one
    anchor's latent interpolated between two shapes in 3 steps; each part's
    latent from another shape. x_T and the step draws injected."""
    jm, variables, pm = partglot_pair
    batch = seg_batch(19, b=4)
    args = {"predict": (), "interpolate_latent": (0, 2, 1, 3),
            "combine_latent": ([3, 0, 2, 1],)}[method]
    rows = {"predict": 4, "interpolate_latent": 3, "combine_latent": 1}[method]
    rng = np.random.RandomState(20)
    x_T = rng.randn(rows, N, 3).astype(np.float32)
    steps = rng.randn(T, rows, N, 3).astype(np.float32)
    Draws(monkeypatch, x_T=x_T, steps=steps)
    want = jm.apply(variables, {k: jnp.asarray(v) for k, v in batch.items()}, *args,
                    method=getattr(JaxPartglot, method), rngs={"sample": RNGS["sample"]})
    got = getattr(pm, method)({k: torch.as_tensor(v) for k, v in batch.items()}, *args,
                              noise=torch.from_numpy(x_T), step_noise=torch.from_numpy(steps))
    tol = dict(rtol=1e-4, atol=1e-4)
    for k in ("anchors", "pred"):
        close(got[k], want[k], tol, what=k)
    np.testing.assert_array_equal(np_(got["seg_mask"]), np.asarray(want["seg_mask"]))


# --------------------------------------------------------------- registries
# What is still to port: nothing.
STILL_TO_PORT = {}


@pytest.mark.parametrize("name", ["ENCODERS", "DECOMPOSERS", "SEGMENTORS", "OPTIMS", "MODELS",
                                  "NETS", "LOSSES", "DATASETS"])
def test_registries_hold_the_jax_keys(name):
    """Every key the JAX package registers is the port's, and the port
    registers nothing the JAX package does not: each registry is equal.
    ``LOSSES`` is empty in both."""
    import difffacto_torch.data  # noqa: F401
    import difffacto_torch.metrics.common  # noqa: F401
    import difffacto_torch.models  # noqa: F401
    import difffacto_torch.parallel.optim  # noqa: F401
    import difffacto_tpu.data  # noqa: F401
    import difffacto_tpu.data.custom  # noqa: F401

    jkeys = set(getattr(JR, name).modules)
    pkeys = set(getattr(PR, name)._modules)
    assert pkeys <= jkeys
    assert jkeys - pkeys == STILL_TO_PORT.get(name, set())
