"""AnchorDiffAE's other encoder family in the port against the JAX package.

On the CPU, at a few points and narrow widths (B = 2 shapes of N = 32
points, 4 parts, zdim 8), the weights bridged with ``load_jax_params`` and
every draw injected on both sides: the base ``PartEncoder``'s per-point ctx
flag by flag, the MLP aligners, the PointNet variants, every encoder variant
of ``part_encoder_variants.py`` (its forward, losses and ctx),
``EncoderWithKLLoss`` with and without its flow, ``PointwiseNet2``, and
``AnchorDiffAE``'s loss and generation on a transformer-decoder variant and
on the base class with ``PointwiseNet``. The optimizers of ``OPTIMS``, the
weight bridge's refusal of a missing or a left-over key, and the per-point
ctx under a points mesh (the JAX package's decode and the port's on gloo
ranks) close the file.

Tolerances: 1e-5 for f32 forwards and losses; train mode (BatchNorm batch
statistics and the running statistics they move) in float64 on both sides;
gradients at 2e-4 of each tensor's largest entry; 1e-4 for a whole reverse
chain (a few f32 denoiser calls summed in other orders).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import difffacto_tpu.models.part_encoder as jpe
import difffacto_tpu.models.part_encoder_variants as jpev
from difffacto_tpu.config import Config as JaxConfig
from difffacto_tpu.models.anchor_diff import AnchorDiffAE as JaxAnchorDiffAE
from difffacto_tpu.models.anchor_diff import decode as jax_decode
from difffacto_tpu.parallel.train import parse_losses as jax_parse_losses
from difffacto_tpu.utils.registry import ENCODERS as JENC
from difffacto_tpu.utils.registry import MODELS as JAX_MODELS
from difffacto_tpu.utils.registry import NETS as JNETS
from difffacto_tpu.utils.registry import build_from_cfg as jax_build
from difffacto_torch import Config, MODELS, build_from_cfg, load_jax_params
from difffacto_torch import sample_generation
from difffacto_torch.parallel.optim import Optimizer
from difffacto_torch.parallel.train import parse_losses
from difffacto_torch.utils.registry import ENCODERS, NETS, OPTIMS
from test_torch_generation import jax_chain, randomize
from torch_dist_ranks import TINY, spawn_async
from torch_pairs import RNGS, TOL, bridge, close, hold, np_, patch_normals, stats_like, wide

torch.set_num_threads(1)

B, N, K, Z = 2, 32, 4, 8


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory):
    return spawn_async("pointctx", 2, tmp_path_factory.mktemp("pointctx"))


def seg_and_maps(seed, b=B, n=N):
    rng = np.random.RandomState(seed)
    seg = rng.randint(0, K, (b, n)).astype(np.int32)
    seg[:, :K] = np.arange(K)
    return seg, np.eye(K, dtype=np.float32)[seg]


def enc_batch(seed, noise_dim=None, b=B):
    """The encoder's batch keys, every part present but part 3 of shape 1."""
    rng = np.random.RandomState(seed)
    seg, maps = seg_and_maps(seed, b)
    pts = (rng.randn(b, N, 3) * 0.3).astype(np.float32)
    present = np.ones((b, K), np.float32)
    present[1, 3] = 0.0
    out = {"input": pts, "ref": pts.copy(), "present": present, "ref_seg_mask": seg,
           "ref_attn_map": maps, "attn_map": maps.copy(),
           "part_shift": (0.1 * rng.randn(b, K, 3)).astype(np.float32),
           "part_scale": (0.3 + 0.2 * np.abs(rng.randn(b, K, 3))).astype(np.float32)}
    if noise_dim:
        out["noise"] = rng.randn(b, noise_dim).astype(np.float32)
    return out


# ------------------------------------------------------------- optimizers
@pytest.mark.parametrize("kind", ["Adam", "AdamW", "Adamax"])
def test_optims_build_the_ports_optimizer(kind):
    """``OPTIMS`` has the JAX package's three type strings; each builds the
    port's optimizer through ``build_optimizer_from_cfg``."""
    tx = build_from_cfg(dict(type=kind, lr=2e-3, weight_decay=0.01), OPTIMS)
    assert isinstance(tx, Optimizer) and tx.kind == kind.lower()
    assert tx.lr == 2e-3 and tx.weight_decay == 0.01


# ----------------------------------------------------- base ctx and aligners
CTX_FLAGS = {
    "z": dict(include_z=True),
    "part_code": dict(include_z=False, include_part_code=True),
    "class_label": dict(include_z=False, include_class_label=True),
    "params": dict(include_z=False, include_params=True, scale_var=2.0),
    "all_detached": dict(include_z=True, include_part_code=True, include_class_label=True,
                         include_params=True, detach_params_in_ctx=True),
}


@pytest.mark.parametrize("flags", list(CTX_FLAGS))
def test_base_prepare_ctx_matches_jax(flags):
    """Each flag of the base class's per-point ctx, in the JAX order, (B, N, F);
    with ``detach_params_in_ctx`` the parameters' gradient stops."""
    cfg = dict(encoder=dict(type="PointNetV2", zdim=Z), n_class=K, **CTX_FLAGS[flags])
    rng = np.random.RandomState(1)
    code = rng.randn(B, K, Z).astype(np.float32)
    mean, logvar = (rng.randn(B, K, 3).astype(np.float32) for _ in range(2))
    seg, _ = seg_and_maps(2)
    jm = jpe.PartEncoder(**cfg)
    want = jm.apply({}, *(jnp.asarray(a) for a in (code, mean, logvar)),
                    seg_mask=jnp.asarray(seg), method=jpe.PartEncoder.prepare_ctx)
    pm = ENCODERS.get("PartEncoder")(**cfg, device="cpu")
    m = torch.from_numpy(mean).requires_grad_()
    got = pm.prepare_ctx(torch.from_numpy(code), m, torch.from_numpy(logvar),
                         seg_mask=torch.from_numpy(seg))
    assert got.shape[:2] == (B, N)
    close(got, want)
    if flags == "all_detached":
        assert not got.requires_grad


@pytest.mark.parametrize("train", [False, True])
def test_part_aligner_matches_jax(train):
    """The MLP aligner: (B, K, 3) mean and logvar, absent parts masked."""
    jm = JENC.get("PartAligner")(n_class=K, width=Z)
    pm = ENCODERS.get("PartAligner")(n_class=K, width=Z, device="cpu")
    code = np.random.RandomState(3).randn(B, K, Z).astype(np.float32)
    vid = enc_batch(3)["present"]
    variables = bridge(jm, pm, jnp.asarray(code), jnp.asarray(vid))
    hold(jm, variables, pm, [code, vid], train,
         lambda m, v, a, t, **kw: m.apply(v, *a, deterministic=not t, **kw),
         lambda m, a, t: m(*a, train=t))


@pytest.mark.parametrize("noise", ["given", "none", "wrong_width"])
@pytest.mark.parametrize("train", [False, True])
def test_part_aligner_cimle_matches_jax(noise, train):
    """The CIMLE MLP aligner with its noise encoder; without noise (or with
    noise of another width) it runs on zeros."""
    kw = dict(width=Z, n_class=K, noise_dim=6)
    jm, pm = JENC.get("PartAlignerCIMLE")(**kw), ENCODERS.get("PartAlignerCIMLE")(**kw,
                                                                                   device="cpu")
    rng = np.random.RandomState(4)
    code = rng.randn(B, K, Z).astype(np.float32)
    vid = enc_batch(4)["present"]
    z = {"given": rng.randn(B, 6), "none": None, "wrong_width": rng.randn(B, 5)}[noise]
    variables = bridge(jm, pm, jnp.asarray(code), jnp.asarray(vid), jnp.zeros((B, 6)))
    inputs = [code, vid] + ([z.astype(np.float32)] if z is not None else [])
    hold(jm, variables, pm, inputs, train,
         lambda m, v, a, t, **k: m.apply(v, *a, deterministic=not t, **k),
         lambda m, a, t: m(*a, train=t))


# ------------------------------------------------------------- PointNets
POINTNETS = {
    "PointNetVAEBase": (dict(zdim=Z), "whole"),
    "PointNetVAE": (dict(zdim=Z, num_anchors=K, point_dim=7), "packed"),
    "PointNetV2VAE": (dict(zdim=Z, num_anchors=K), "packed"),
    "PointNetV2VAE_det": (dict(zdim=Z, num_anchors=K, deterministic=True,
                               per_part_mlp=True), "maps"),
    "PointNetV2Variant": (dict(zdim=Z, num_anchors=K), "maps_absent"),
    "PointNetV2Variant_pp": (dict(zdim=Z, num_anchors=K, per_part_mlp=True), "packed"),
    "PointNetV3": (dict(zdim=Z, num_anchors=K, mult=2), "packed"),
}


# each class in eval and train mode; the deterministic V2VAE in eval, the
# per-part heads of V2Variant in training
POINTNET_CASES = [(n, t) for n in POINTNETS if "_" not in n for t in (False, True)]
POINTNET_CASES += [("PointNetV2VAE_det", False), ("PointNetV2Variant_pp", True)]


@pytest.mark.parametrize("name,train", POINTNET_CASES)
def test_pointnet_variants_match_jax(name, train):
    """Each variant on a cloud with its part maps (given, or packed in the
    input's channels 3..); ``PointNetV2Variant`` with a part absent from a
    shape, which pools to 0."""
    kw, layout = POINTNETS[name]
    cls = name.split("_")[0]
    jm, pm = JENC.get(cls)(**kw), ENCODERS.get(cls)(**kw, device="cpu")
    rng = np.random.RandomState(5)
    pts = (0.3 * rng.randn(B, N, 3)).astype(np.float32)
    seg, maps = seg_and_maps(6)
    if layout == "maps_absent":
        maps[1, :, 2] = 0.0
    inputs = {"whole": [pts], "packed": [np.concatenate([pts, maps], -1)],
              "maps": [pts, maps], "maps_absent": [pts, maps]}[layout]
    variables = bridge(jm, pm, *(jnp.asarray(a) for a in inputs))
    got, _ = hold(jm, variables, pm, inputs, train,
                  lambda m, v, a, t, **k: m.apply(v, *a, train=t, **k),
                  lambda m, a, t: m(*a, train=t))
    if name == "PointNetV2VAE_det":
        assert torch.is_tensor(got)


def test_pointnet_vae_base_mask_matches_jax():
    """``PointNetVAEBase``'s point mask: masked points leave the pool, a row
    with every point masked pools to 0."""
    jm = JENC.get("PointNetVAEBase")(zdim=Z)
    pm = ENCODERS.get("PointNetVAEBase")(zdim=Z, device="cpu")
    pts = (0.3 * np.random.RandomState(7).randn(B, N, 3)).astype(np.float32)
    mask = np.zeros((B, N), bool)
    mask[0, ::3] = True
    mask[1] = True
    variables = bridge(jm, pm, jnp.asarray(pts))
    hold(jm, variables, pm, [pts, mask], False,
         lambda m, v, a, t, **k: m.apply(v, a[0], a[1], **k),
         lambda m, a, t: m(a[0], a[1]))


# ------------------------------------------------------------ the variants
def variant_cfg(kind, **extra):
    base = dict(type=kind, encoder=dict(type="PointNetV2", zdim=Z, per_part_mlp=True),
                n_class=K, fit_loss_type=0, include_part_code=True, include_params=True,
                include_z=False)
    base.update(extra)
    return base


MLP_ALIGNER = dict(type="PartAligner", n_class=K, width=Z)
CIMLE_ALIGNER = dict(type="PartAlignerCIMLE", n_class=K, width=Z, noise_dim=6)
VARIANTS = {
    "PartEncoder": dict(part_aligner=MLP_ALIGNER, include_z=True, include_class_label=True,
                        scale_var=1.5),
    "PartEncodercVAE": dict(part_aligner=CIMLE_ALIGNER, encode_ref=True),
    "PartEncodercVAE2": dict(part_aligner=CIMLE_ALIGNER, encode_ref=True, scale_var=2.0),
    "PartEncoderVAE": dict(part_aligner=MLP_ALIGNER, scale_var=2.0),
    "PartEncoderWithKLLoss": dict(part_aligner=MLP_ALIGNER, gen=True, prior_var=0.5,
                                  kl_weight_annealing=True, kl_weight_annealing_end_epoch=4),
    "PartEncoderForPartnet": dict(part_aligner=MLP_ALIGNER, include_z=True),
    "PartEncoderCIMLE": dict(part_aligner=CIMLE_ALIGNER, gen=True, use_flow=True,
                             latent_flow_depth=2, latent_flow_hidden_dim=8),
    "PartEncoderNoMixer": dict(part_aligner=MLP_ALIGNER, use_gt_params_in_training=True),
    "PartEncoderForPartnetAndTransformerDecoder": dict(part_aligner=MLP_ALIGNER,
                                                       detach_params_in_ctx=True),
    "PartEncoderForTransformerDecoderCIMLE": dict(part_aligner=CIMLE_ALIGNER),
    "PartEncoderForTransformerDecoderKLLoss": dict(part_aligner=MLP_ALIGNER, gen=True,
                                                   include_std=True),
    "PartEncoderForTransformerDecoderKLLoss_var": dict(part_aligner=MLP_ALIGNER, gen=True),
    "PartEncoderForTransformerDecoderKLLossCIMLE": dict(part_aligner=CIMLE_ALIGNER, gen=True,
                                                        include_std=True),
}


def variant_pair(name):
    kind = name.split("_")[0]
    cfg = variant_cfg(kind, **VARIANTS[name])
    noise_dim = 6 if cfg["part_aligner"]["type"] == "PartAlignerCIMLE" else None
    batch = enc_batch(8, noise_dim)
    jm = jax_build(dict(cfg), JENC)
    pm = build_from_cfg(dict(cfg), ENCODERS, device="cpu")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with patched_normals(None):
        variables = bridge(jm, pm, jb, train=True)
    return jm, variables, pm, batch


# train mode (float64) for the variants whose forward differs in training
TRAINED = ("PartEncoder", "PartEncodercVAE", "PartEncoderWithKLLoss", "PartEncoderForPartnet",
           "PartEncoderNoMixer", "PartEncoderForTransformerDecoderKLLoss")
VARIANT_CASES = [(n, False) for n in VARIANTS] + [(n, True) for n in TRAINED]


class patched_normals:
    """``reparameterize_gaussian`` of the JAX part encoder modules takes its
    standard normals from ``eps`` in order (``None``: the means themselves,
    for initialisation)."""

    def __init__(self, eps):
        self.eps = eps

    def __enter__(self):
        self.mp = pytest.MonkeyPatch()
        for mod in (jpe, jpev):
            if self.eps is None:
                self.mp.setattr(mod, "reparameterize_gaussian", lambda rng, m, lv: m)
            else:
                patch_normals(self.mp, mod, self.eps)
        return self

    def __exit__(self, *a):
        self.mp.undo()


@pytest.mark.parametrize("name,train", VARIANT_CASES)
def test_encoder_variant_forward_matches_jax(name, train):
    """The forward of each variant: ctx, per-point means, logvars and
    presence flags, every loss, and the latents (part code, mean, logvar);
    the part code's posterior draw (``gen``) and the cVAE's noise draw
    injected. Eval mode for every variant; train mode (batch statistics,
    the cVAE's draw, the prior and fit losses in training) for the base
    class and each variant that overrides a training step. The cVAE's prior loss, which the JAX module only ``sow``s,
    is held against the port's ``cvae_prior_loss``."""
    jm, variables, pm, batch = variant_pair(name)
    rng = np.random.RandomState(10)
    pc_eps = rng.randn(B, K, Z).astype(np.float32)
    cvae_eps = rng.randn(B, 6).astype(np.float32)
    cvae = "cVAE" in name and train
    queue = ([pc_eps] if pm.gen else []) + ([cvae_eps] if cvae else [])
    keys = sorted(batch)

    def jcall(m, v, a, t, mutable=()):
        b = dict(zip(keys, a))
        with patched_normals(list(queue)):
            out, state = m.apply(v, b, epoch=2, train=t, rngs={"sample": RNGS["sample"]},
                                 mutable=list(mutable) + ["intermediates"])
        ctx, mpp, lpp, fpp, losses, lat = out
        inter = state.pop("intermediates", {})
        extra = [jax.tree_util.tree_leaves(inter)[0]] if cvae else []
        res = [ctx, mpp, lpp, fpp, {k: v for k, v in losses.items()}, lat[:3], extra]
        return (res, state) if mutable else res

    def pcall(m, a, t):
        b = dict(zip(keys, a))
        if pm.gen:
            b["part_code_eps"] = torch.as_tensor(wide(pc_eps) if t else pc_eps)
        if cvae:
            b["cvae_eps"] = torch.as_tensor(wide(cvae_eps))
        ctx, mpp, lpp, fpp, losses, lat = m(b, epoch=2, train=t, rngs={})
        extra = [m.cvae_prior_loss] if cvae else []
        return [ctx, mpp, lpp, fpp, losses, lat[:3], extra]

    got, _ = hold(jm, variables, pm, [batch[k] for k in keys], train, jcall, pcall)
    assert got[0].ndim == 3


@pytest.mark.parametrize("use_flow", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_encoder_with_kl_loss_matches_jax(use_flow, train):
    """One global latent on every part slot: the forward (its prior loss
    through the flow or N(0, 1), the per-sample fit loss in training, the
    per-point ctx) with the latent's draw injected, and the flow prior's
    sample from an injected z."""
    cfg = dict(type="EncoderWithKLLoss", encoder=dict(type="PointNetVAEBase", zdim=Z),
               part_aligner=MLP_ALIGNER, n_class=K, include_z=True, include_params=True,
               use_flow=use_flow, latent_flow_depth=2, latent_flow_hidden_dim=8)
    batch = enc_batch(11)
    jm, pm = jax_build(dict(cfg), JENC), build_from_cfg(dict(cfg), ENCODERS, device="cpu")
    eps = np.random.RandomState(12).randn(B, Z).astype(np.float32)
    keys = sorted(batch)
    with patched_normals([eps]):
        variables = bridge(jm, pm, {k: jnp.asarray(v) for k, v in batch.items()}, train=True)

    def jcall(m, v, a, t, mutable=()):
        with patched_normals([eps]):
            out = m.apply(v, dict(zip(keys, a)), epoch=1, train=t,
                          rngs={"sample": RNGS["sample"]}, mutable=list(mutable))
        return out if mutable else out[0]

    def pcall(m, a, t):
        b = dict(zip(keys, a), part_code_eps=torch.as_tensor(wide(eps) if t else eps))
        return m(b, epoch=1, train=t)

    hold(jm, variables, pm, [batch[k] for k in keys], train, jcall, pcall)
    if train:
        return
    z = np.random.RandomState(13).randn(3, 1, Z).astype(np.float32)

    def prior(m, z):
        zz = m.global_flow(z, reverse=True) if m.use_flow else z
        return jnp.broadcast_to(zz, (z.shape[0], K, Z))

    want = jm.apply(variables, jnp.asarray(z), method=prior)
    got = pm.sample_flow_prior(3, z=torch.from_numpy(z))
    close(got, want)


def test_pointwise_net2_matches_jax():
    """Each point modulated by [t, sin t, cos t] ++ its own part's token, the
    input added back (``res``)."""
    kw = dict(in_channels=3, out_channels=3, context_dim=10, hidden=(16, 24))
    jm = JNETS.get("PointwiseNet2")(**kw)
    pm = NETS.get("PointwiseNet2")(**kw, device="cpu")
    rng = np.random.RandomState(14)
    x = rng.randn(B, N, 3).astype(np.float32)
    t = np.array([3, 11], np.int32)
    ctx = rng.randn(B, K, 10).astype(np.float32)
    seg, _ = seg_and_maps(15)
    variables = bridge(jm, pm, *(jnp.asarray(a) for a in (x, t, ctx)), seg_mask=jnp.asarray(seg))
    hold(jm, variables, pm, [x, t, ctx, seg], False,
         lambda m, v, a, tr, **k: m.apply(v, a[0], a[1], a[2], seg_mask=a[3], **k),
         lambda m, a, tr: m(a[0], a[1], a[2], seg_mask=a[3]))


# ------------------------------------------------- AnchorDiffAE end to end
def ae_cfg(kind):
    """tests/configs/tiny_gen.py's model on a transformer-decoder variant
    (the KL prior with the std in the ctx), or on the base ``PartEncoder``
    with the MLP aligner, ``include_z`` and ``PointwiseNet`` on its
    per-point ctx (K zdim + 6 wide)."""
    jc, pc = JaxConfig(TINY).model.dump(), Config(TINY).model.dump()
    for cfg in (jc, pc):
        cfg.update(num_timesteps=4)
        enc = cfg["encoder"]
        if kind == "td":
            # its prior loss reads no flow: flax would build none to load
            enc.update(type="PartEncoderForTransformerDecoderKLLoss", include_std=True,
                       use_flow=False)
        else:
            enc.update(type="PartEncoder", part_aligner=dict(MLP_ALIGNER, width=16),
                       include_z=True, include_part_code=False, include_params=True)
            cfg["cimle"] = False
            cfg["diffusion"]["net"] = dict(type="PointwiseNet", point_dim=3,
                                           context_dim=4 * 16 + 6, hidden=(16, 32, 16))
    return jc, pc


_AE = {}


def ae_pair(kind):
    if kind not in _AE:
        jc, pc = ae_cfg(kind)
        jm, pm = jax_build(jc, JAX_MODELS), build_from_cfg(pc, MODELS, device="cpu")
        batch = ae_batch(pm, 16)
        jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "part_code_eps"}
        with patched_normals([batch["part_code_eps"]] * 2):
            variables = jax.jit(lambda r, b: jm.init(r, b, 0, method=JaxAnchorDiffAE.loss))(
                RNGS, jb)
        params = randomize(jax.tree_util.tree_map(np.asarray, variables["params"]), 17)
        aligner = params["encoder_mod"]["aligner"]
        for head in ("fc4_m", "fc4_v"):  # keep exp(logvar) and the chain in range
            if head in aligner:
                aligner[head]["kernel"] = 0.02 * aligner[head]["kernel"]
        variables = {"params": params, "batch_stats": stats_like(variables["batch_stats"], 18)}
        load_jax_params(pm, variables["params"], variables["batch_stats"])
        _AE[kind] = (jm, variables, pm)
    return _AE[kind]


def ae_batch(pm, seed):
    rng = np.random.RandomState(seed)
    out = enc_batch(seed, pm.encoder_mod.noise_dim if pm.cimle else None, b=2)
    n = out["ref"].shape[1]
    out.update(seg_mask=out["ref_seg_mask"].copy(),
               diffusion_t=np.array([0, 3], np.int64),
               diffusion_noise=rng.randn(2, n, 3).astype(np.float32),
               part_code_eps=rng.randn(2, K, pm.encoder_mod.zdim).astype(np.float32))
    return out


@pytest.mark.parametrize("kind", ["td", "base"])
def test_anchor_diff_ae_loss_matches_jax(kind):
    """The whole eval-mode loss, term by term (prior, fit and mse), on the
    same weights, t, noise and part-code draw."""
    jm, variables, pm = ae_pair(kind)
    batch = ae_batch(pm, 19)
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "part_code_eps"}
    with patched_normals([batch["part_code_eps"]]):
        want = jm.apply(variables, jb, 0, False, method=JaxAnchorDiffAE.loss, rngs=RNGS)
    with torch.no_grad():
        got = pm.loss({k: torch.as_tensor(v) for k, v in batch.items()}, 0, False)
    assert sorted(got) == sorted(want)
    for k in want:
        close(got[k], want[k], what=k)
    np.testing.assert_allclose(float(parse_losses(got)[0]), float(jax_parse_losses(want)[0]),
                               **TOL)


@pytest.mark.parametrize("kind", ["td", "base"])
def test_generation_matches_jax(kind):
    """Flow prior -> aligner -> ctx -> reverse chain, the flow's input, the
    CIMLE noise, x_T and the step draws injected: the ctx (the TD tokens,
    or the base class's per-point ctx) and the samples."""
    jm, variables, pm = ae_pair(kind)
    S = 2
    rng = np.random.RandomState(20)
    z = rng.randn(S, K, 16).astype(np.float32)
    valid = np.array([[1, 1, 1, 1], [1, 0, 1, 1]], np.float32)

    def prep(m, z, valid):
        enc = m.encoder_mod
        pc = z * math.sqrt(enc.prior_var)
        pc = enc.flow(pc, reverse=True) if enc.use_flow else pc
        ctx, mpp, lpp, seg, vid, lat = enc.sample_latents(
            S, m.npoints, fixed_id=jnp.zeros(K), valid_id=valid, K=m.cimle_sample_num,
            part_code=pc)
        return ctx, mpp, jnp.exp(lpp), seg, vid, lat[3]

    jctx, jmean, jvar, jseg, jvid, jnoise = jax.tree_util.tree_map(
        np.asarray, jm.apply(variables, jnp.asarray(z), jnp.asarray(valid), method=prep,
                             rngs={"sample": RNGS["sample"]}))
    steps = rng.randn(4, S, 64, 3).astype(np.float32)
    x_T = rng.randn(S, 64, 3).astype(np.float32)
    want = jax_chain(jm, variables, jmean, jctx, jvar, jseg, jvid, x_T, steps)
    out = sample_generation(pm, S, valid_id=torch.from_numpy(valid), z=torch.from_numpy(z),
                            cimle_noise=None if jnoise is None else torch.from_numpy(jnoise),
                            noise=torch.from_numpy(x_T), step_noise=torch.from_numpy(steps))
    ctx = pm.prepare_generation(S, torch.zeros(K), torch.from_numpy(valid), z=torch.from_numpy(z),
                                cimle_noise=None if jnoise is None else torch.from_numpy(jnoise))[0]
    assert ctx.shape[1] == (64 if kind == "base" else K)
    close(ctx, jctx, TOL)
    np.testing.assert_array_equal(np_(out["seg_mask"]), jseg)
    np.testing.assert_allclose(np_(out["pred"]), want, rtol=1e-4, atol=1e-4)


def test_gen_chair_ctx_is_unchanged_by_seg_mask():
    """gen_chair's transformer-decoder ctx reads no seg mask: the K part
    tokens are the same with and without one, and the JAX class's."""
    cfg = Config("configs/gen_chair.py").model.dump()["encoder"]
    jcfg = JaxConfig("configs/gen_chair.py").model.dump()["encoder"]
    pm = build_from_cfg(dict(cfg), ENCODERS, device="cpu")
    jm = jax_build(dict(jcfg), JENC)
    rng = np.random.RandomState(21)
    code = rng.randn(B, K, pm.zdim).astype(np.float32)
    mean, logvar = (rng.randn(B, K, 3).astype(np.float32) for _ in range(2))
    seg, _ = seg_and_maps(22)
    args = [torch.from_numpy(a) for a in (code, mean, logvar)]
    plain = pm.prepare_ctx(*args)
    with_seg = pm.prepare_ctx(*args, seg_mask=torch.from_numpy(seg))
    assert torch.equal(plain, with_seg) and plain.shape == (B, K, pm.zdim + 6)
    want = jm.apply({}, *(jnp.asarray(a) for a in (code, mean, logvar)), jnp.asarray(seg),
                    method=type(jm).prepare_ctx)
    close(plain, want)


# ------------------------------------------------------------ weight bridge
@pytest.mark.parametrize("fault", ["missing", "left_over"])
def test_bridge_refuses_a_missing_or_left_over_key(fault):
    """A new module's tree with a leaf taken out, or one added, raises."""
    jm = JENC.get("PointNetV3")(zdim=Z, num_anchors=K)
    pm = ENCODERS.get("PointNetV3")(zdim=Z, num_anchors=K, device="cpu")
    pts = np.zeros((B, N, 3 + K), np.float32)
    variables = jm.init(RNGS, jnp.asarray(pts))
    params = jax.tree_util.tree_map(np.asarray, dict(variables["params"]))
    params["mlp_m"] = dict(params["mlp_m"])
    if fault == "missing":
        params["mlp_m"].pop("Dense_2")
    else:
        params["mlp_m"]["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError):
        load_jax_params(pm, params, variables["batch_stats"])


# ------------------------------------------------ per-point ctx on a mesh
def test_jax_decode_refuses_a_per_point_ctx_under_a_points_axis():
    """The JAX package's decode cuts ctx on the batch axis only, so a
    per-point ctx under ("data", "points") meets a point shard of half its
    rows and the denoiser fails; under a data-only mesh it runs."""
    jm, variables, _ = ae_pair("base")
    rng = np.random.RandomState(23)
    anchors = rng.randn(2, 64, 3).astype(np.float32)
    ctx = rng.randn(2, 64, 70).astype(np.float32)
    seg = np.repeat(np.arange(K), 16)[None].repeat(2, 0).astype(np.int32)
    args = dict(ctx=jnp.asarray(ctx), variance=jnp.ones((2, 64, 3)), seg_mask=jnp.asarray(seg),
                valid_id=jnp.ones((2, K)), ret_traj=False)
    devices = np.array(jax.devices()[:2])
    with pytest.raises(Exception, match="[Ii]ncompatible shapes|broadcast"):
        jax_decode(jm, variables, RNGS["sample"], jnp.asarray(anchors),
                   mesh=JaxMesh(devices.reshape(1, 2), ("data", "points")), **args)
    out = jax_decode(jm, variables, RNGS["sample"], jnp.asarray(anchors),
                     mesh=JaxMesh(devices.reshape(2, 1), ("data", "points")), **args)
    assert out["pred"].shape == (2, 64, 3)


def test_port_per_point_ctx_on_gloo_ranks(started):
    """Two gloo ranks (``tests/torch_dist_ranks.py``, suite "pointctx") on
    the base ``PartEncoder`` with ``PointwiseNet``: decode under ("data",
    "points") (1, 2) raises as the JAX package fails; under (2, 1) it
    matches one device; the eval-mode loss and gradients under the points
    axis, where the per-point ctx is computed from the rank's own seg mask,
    match one device (1e-5 for the loss, 2e-4 of the largest gradient)."""
    r0 = started.result()[0]
    assert int(r0["points_raises"]) == 1
    np.testing.assert_allclose(r0["decode_dp"], r0["decode_ref"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(r0["sp_total"], r0["one_total"], rtol=1e-5, atol=1e-5)
    scale = max(float(np.abs(r0["one_grads"]).max()), 1e-2)
    np.testing.assert_allclose(r0["sp_grads"], r0["one_grads"], atol=2e-4 * scale, rtol=0)
