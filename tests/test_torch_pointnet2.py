"""PointNet++, the vanilla chains and ``PDM`` of the port against the JAX
package, on the CPU.

``ball_query``, ``group_points``, ``three_nn`` and ``three_interpolate``
(``difffacto_tpu/ops/points.py``: XLA there, plain torch here) on the same
clouds: the indices exactly, except that a candidate whose squared distance
lies within 1e-6 of r^2 may fall on either side of the ball; what follows
takes the JAX indices. ``PointNet2SSG`` and ``PointNet2MSG`` forward in eval
mode and in train mode (BatchNorm batch statistics and the running
statistics they move, the head's dropout keep mask injected), on the same
weights (``load_jax_params``, BatchNorm statistics included). The vanilla
chains of ``models/diffusion_extra.py`` as the JAX package configures them.
``PDM``'s loss and its gradients (timesteps, q-sample noise and dropout
injected on both sides) and ``PDM.predict`` (x_T and the step draws
injected). The shapes are the JAX tests' own (``tests/test_secondary_models.py``:
clouds of 1024 points with the 4 part maps, 7 channels); FPS at the set
abstractions' 1024 -> 512 and 512 -> 128, whose launch ``ops/fps.py:plan``
takes. Tolerances: 1e-5 for forwards and losses (train mode in float64,
see ``test_pointnet2_forward_matches_jax``), gradients at 2e-4 of each
tensor's largest entry (or 2e-6 where that is below 1e-2), 1e-4 for the
whole reverse chain.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import difffacto_tpu.models.diffusion_extra as jdx
import difffacto_tpu.ops.points as jpts
from difffacto_tpu.models.diffusion import AnchoredDiffusion as JaxDiffusion
from difffacto_tpu.models.orchestrators_extra import PDM as JaxPDM
from difffacto_tpu.models.pointnet2 import PointNet2MSG as JaxMSG
from difffacto_tpu.models.pointnet2 import PointNet2SSG as JaxSSG
from difffacto_tpu.models.samplers import Uniform as JaxUniform
from difffacto_torch import load_jax_params
from difffacto_torch.models import PDM, PointNet2MSG, PointNet2SSG
from difffacto_torch.models import diffusion_extra as pdx
from difffacto_torch.ops import fps as pfps
from difffacto_torch.ops import points as ppts
from difffacto_torch.utils.jax_params import export_jax_params, flatten_jax_tree

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
B, N = 2, 1024
RNGS = {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1),
        "dropout": jax.random.PRNGKey(2)}


def np_(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def cloud(B=B, N=N, seed=0):
    """(B, N, 7): points in the unit ball's neighbourhood and 4 one-hot maps."""
    rng = np.random.RandomState(seed)
    xyz = (rng.randn(B, N, 3) * 0.35).astype(np.float32)
    seg = rng.randint(0, 4, (B, N))
    return np.concatenate([xyz, np.eye(4, dtype=np.float32)[seg]], -1), seg.astype(np.int32)


# ----------------------------------------------------------------- ops
def hold_ball_query(got, want, new_xyz, xyz, radius):
    """Equal indices, or rows whose in-ball sets differ only by candidates
    on the ball's boundary (|d^2 - r^2| <= 1e-6)."""
    got, want = np.asarray(got), np.asarray(want)
    if np.array_equal(got, want):
        return
    d2 = ((new_xyz[:, :, None, :].astype(np.float64) - xyz[:, None].astype(np.float64)) ** 2).sum(-1)
    for b, s in zip(*np.nonzero((got != want).any(-1))):
        for i in set(got[b, s]) ^ set(want[b, s]):
            assert abs(d2[b, s, i] - radius * radius) <= 1e-6, (b, s, i, d2[b, s, i])


@pytest.mark.parametrize("radius,nsample", [(0.2, 64), (0.4, 16), (0.05, 8), (3.0, 32)])
def test_ball_query_matches_jax(radius, nsample):
    """Candidates in index order; empty slots take the first in-ball index,
    or 0 for an empty ball (the small radius leaves some balls empty but
    their own centre; the large one fills every slot)."""
    pc, _ = cloud(seed=1)
    xyz = pc[..., :3]
    new_xyz = np.concatenate([xyz[:, :60], np.full((B, 4, 3), 5.0, np.float32)], 1)
    got = ppts.ball_query(torch.from_numpy(new_xyz), torch.from_numpy(xyz), radius, nsample)
    want = jpts.ball_query(jnp.asarray(new_xyz), jnp.asarray(xyz), radius, nsample)
    assert got.dtype == torch.int32 and got.shape == (B, 64, nsample)
    hold_ball_query(got, want, new_xyz, xyz, radius)
    assert (np_(got)[:, 60:] == 0).all()  # the far centres' balls are empty


def test_group_points_and_three_interpolate_match_jax():
    rng = np.random.RandomState(2)
    feats = rng.randn(B, 5, 40).astype(np.float32)
    idx = rng.randint(0, 40, (B, 7, 3)).astype(np.int32)
    w = rng.rand(B, 7, 3).astype(np.float32)
    got = ppts.group_points(torch.from_numpy(feats), torch.from_numpy(idx))
    np.testing.assert_array_equal(np_(got), np.asarray(jpts.group_points(
        jnp.asarray(feats), jnp.asarray(idx))))
    got = ppts.three_interpolate(*(torch.from_numpy(a) for a in (feats, idx, w)))
    np.testing.assert_allclose(np_(got), np.asarray(jpts.three_interpolate(
        *(jnp.asarray(a) for a in (feats, idx, w)))), **TOL)


def test_three_nn_matches_jax_ties_to_the_lowest_index():
    """Nearest first; duplicated known points tie and go to the lower index."""
    rng = np.random.RandomState(3)
    known = rng.randn(B, 30, 3).astype(np.float32)
    known[:, 20:] = known[:, :10]  # every point twice
    unknown = np.concatenate([rng.randn(B, 10, 3), known[:, :5]], 1).astype(np.float32)
    got_d, got_i = ppts.three_nn(torch.from_numpy(unknown), torch.from_numpy(known))
    want_d, want_i = jpts.three_nn(jnp.asarray(unknown), jnp.asarray(known))
    np.testing.assert_array_equal(np_(got_i), np.asarray(want_i))
    # squared: the root of a duplicate's ~1e-7 rounding residue is ~3e-4
    np.testing.assert_allclose(np_(got_d) ** 2, np.asarray(want_d) ** 2, **TOL)
    assert got_i.dtype == torch.int32


@pytest.mark.parametrize("batch", [2, 32])
def test_fps_plan_takes_the_set_abstraction_shapes(batch):
    """The kernel's launch at PointNet++'s samples, 2048 -> 512 and 512 ->
    128 (and the tests' 1024 -> 512): one block a cloud, every point in
    registers; the plain FPS gives JAX's indices at the tests' shapes."""
    for n, m in ((2048, 512), (512, 128), (1024, 512)):
        p = pfps.plan(batch, n, 132)
        assert p["cluster"] == 1 and p["threads"] * p["points_per_thread"] >= n and m < n
    pc, _ = cloud(seed=4)
    got = ppts.fps(torch.from_numpy(pc[..., :3]), 512, ret_id=True)[1]
    want = jpts.fps(jnp.asarray(pc[..., :3]), 512, ret_id=True)[1]
    np.testing.assert_array_equal(np_(got), np.asarray(want))


# ------------------------------------------------------------ PointNet++
def patch_bernoulli(monkeypatch, masks):
    """flax's Dropout takes its keep masks from ``masks``, in order."""
    queue = list(masks)

    def fake(key, p=0.5, shape=None):
        m = queue.pop(0)
        assert tuple(shape) == m.shape
        return jnp.asarray(m, bool)

    monkeypatch.setattr(jax.random, "bernoulli", fake)


_ENCODERS = {}


def encoder_pair(kind):
    """The JAX encoder at zdim 8, 2 anchors, its variables, and the port's on them."""
    if kind not in _ENCODERS:
        jcls, pcls = {"ssg": (JaxSSG, PointNet2SSG), "msg": (JaxMSG, PointNet2MSG)}[kind]
        jm = jcls(additioinal_dim=4, zdim=8, num_anchors=2)
        pc, _ = cloud()
        variables = jax.jit(lambda: jm.init(RNGS, jnp.asarray(pc)))()
        pm = pcls(additioinal_dim=4, zdim=8, num_anchors=2, device="cpu")
        load_jax_params(pm, variables["params"], variables["batch_stats"])
        _ENCODERS[kind] = (jm, variables, pm)
    return _ENCODERS[kind]


def f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float64)), tree)


@pytest.mark.parametrize("kind", ["ssg", "msg"])
@pytest.mark.parametrize("train", [False, True])
def test_pointnet2_forward_matches_jax(kind, train, monkeypatch):
    """(B, 2, 8) codes in eval mode (float32, running statistics untouched)
    and in train mode: the batch statistics of every BatchNorm, the running
    statistics they move and the head's dropout keep mask (B, 256). Train
    mode is held in float64 on both sides: its first BatchNorms reduce over
    65,536 neighbourhood rows, where XLA's f32 sum on the CPU puts the
    variance 7e-5 off (torch's 5e-7), and the head's BatchNorm over a batch
    of 2 turns such differences into 3e-3 at the codes."""
    jm, variables, pm = encoder_pair(kind)
    pc, _ = cloud(seed=5)
    if not train:
        buffers = {n: b.clone() for n, b in pm.named_buffers()}
        want = jax.jit(jm.apply)(variables, jnp.asarray(pc))
        got = pm(torch.from_numpy(pc))
        assert got.shape == (B, 2, 8)
        np.testing.assert_allclose(np_(got), np.asarray(want), **TOL)
        assert all(torch.equal(b, buffers[n]) for n, b in pm.named_buffers())
        return
    keep = np.random.RandomState(6).rand(B, 256) > 0.5
    patch_bernoulli(monkeypatch, [keep])
    with jax.enable_x64(True):
        want, mutated = jax.jit(lambda v, x: jm.apply(
            v, x, train=True, rngs={"dropout": RNGS["dropout"]}, mutable=["batch_stats"]))(
                f64(variables), jnp.asarray(pc.astype(np.float64)))
        want, moved = np.asarray(want), flatten_jax_tree(jax.device_get(mutated["batch_stats"]))
    pm64 = copy.deepcopy(pm).double()
    got = pm64(torch.from_numpy(pc.astype(np.float64)), train=True, keep=torch.from_numpy(keep))
    np.testing.assert_allclose(np_(got), want, **TOL)
    for n, b in pm64.named_buffers():
        np.testing.assert_allclose(np_(b), moved[n], err_msg=n, **TOL)


def test_pointnet2_bridge_round_trip():
    """Every parameter and BatchNorm statistic under the JAX names, in and out."""
    jm, variables, pm = encoder_pair("msg")
    params, stats = export_jax_params(pm)
    for got, want in ((params, variables["params"]), (stats, variables["batch_stats"])):
        got, want = flatten_jax_tree(got), flatten_jax_tree(want)
        assert sorted(got) == sorted(want)
        for n in want:
            np.testing.assert_array_equal(got[n], want[n], err_msg=n)


# ------------------------------------------------------- vanilla chains
@pytest.mark.parametrize("name,kw", [("PointDiffusion", {}), ("LDM", dict(use_beta=False)),
                                     ("LatentDiffusionDrift", dict(classifier_weight=2.0)),
                                     ("LatentDiffusionDrift", {})])
def test_vanilla_chains_are_configured_as_in_jax(name, kw):
    """Every field the JAX package sets, and q_sample from zero anchors
    whatever anchors it is given."""
    want = getattr(jdx, name)(num_timesteps=10, **kw)
    got = getattr(pdx, name)(num_timesteps=10, **kw)
    for field in ("k", "res", "use_beta", "include_anchors", "learn_anchor", "learn_variance",
                  "guidance", "classifier_weight", "model_mean_type", "model_var_type",
                  "scale_loss"):
        assert getattr(got, field) == getattr(want, field), field
    rng = np.random.RandomState(7)
    x, noise, anchors = (rng.randn(2, 16, 3).astype(np.float32) for _ in range(3))
    t = np.array([3, 7])
    a = got.q_sample(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(anchors),
                     noise=torch.from_numpy(noise))
    b = want.q_sample(None, jnp.asarray(x), jnp.asarray(t), jnp.asarray(anchors),
                      noise=jnp.asarray(noise))
    np.testing.assert_allclose(np_(a), np.asarray(b), **TOL)


# ------------------------------------------------------------------ PDM
PDM_CFG = dict(
    encoder=dict(type="PointNet2SSG", additioinal_dim=4, zdim=16, num_anchors=1),
    diffusion=dict(type="PointDiffusion",
                   net=dict(type="PointwiseNet", point_dim=3, context_dim=16, hidden=(32, 64, 32)),
                   beta_1=1e-4, beta_T=0.02, mode="linear"),
    sampler=dict(type="Uniform"), num_timesteps=5, npoints=N)


def build_pdm_pair(cfg):
    jm = JaxPDM(**cfg)
    batch = pdm_batch(seed=8)
    variables = jax.jit(lambda r, b: jm.init(r, b, 0, method=JaxPDM.loss))(
        RNGS, {k: jnp.asarray(v) for k, v in batch.items()})
    pm = PDM(**cfg, device="cpu")
    load_jax_params(pm, variables["params"], variables["batch_stats"])
    return jm, variables, pm


@pytest.fixture(scope="module")
def pdm_pair():
    return build_pdm_pair(PDM_CFG)


def pdm_batch(seed):
    pc, seg = cloud(seed=seed)
    return {"input": pc[..., :3], "ref": pc[..., :3], "attn_map": pc[..., 3:],
            "ref_seg_mask": seg}


def test_pdm_loss_and_gradients_match_jax(pdm_pair, monkeypatch):
    """The mse loss (1e-5) and every parameter's gradient, the encoder in
    training (batch statistics, the head's dropout), on the same t, noise
    and keep mask; in float64 on both sides, as the encoder's train mode is
    held (see ``test_pointnet2_forward_matches_jax``)."""
    hold_pdm_loss(*pdm_pair, monkeypatch, dropout=True)


def test_pdm_on_pointnet_matches_jax(monkeypatch):
    """``PDM`` on the plain ``PointNet`` encoder, which draws nothing and
    takes the same call: the loss (1e-5) and every gradient, as above."""
    cfg = dict(PDM_CFG, encoder=dict(type="PointNet", point_dim=7, zdim=16, num_anchors=1))
    hold_pdm_loss(*build_pdm_pair(cfg), monkeypatch, dropout=False)


def hold_pdm_loss(jm, variables, pm, monkeypatch, dropout):
    """The mse loss and its gradients of ``pm`` against ``jm`` in float64, on
    the same t, noise and (where the encoder has a head dropout) keep mask."""
    batch = pdm_batch(seed=9)
    rng = np.random.RandomState(10)
    t = np.array([1, 4], np.int32)
    noise = rng.randn(B, N, 3)
    keep = rng.rand(B, 256) > 0.5
    monkeypatch.setattr(JaxUniform, "sample",
                        lambda self, key, n: (jnp.asarray(t), jnp.ones((n,), jnp.float32)))
    real = JaxDiffusion.training_losses
    monkeypatch.setattr(JaxDiffusion, "training_losses", lambda self, fn, key, x, tt, **kw: real(
        self, fn, key, x, tt, **dict(kw, noise=jnp.asarray(noise))))
    patch_bernoulli(monkeypatch, [keep] if dropout else [])

    with jax.enable_x64(True):
        def loss_fn(params):
            out, _ = jm.apply({"params": params, "batch_stats": f64(variables["batch_stats"])},
                              {k: jnp.asarray(v) for k, v in batch64(batch).items()}, 0,
                              method=JaxPDM.loss, rngs={"sample": RNGS["sample"],
                                                        "dropout": RNGS["dropout"]},
                              mutable=["batch_stats"])
            return jnp.mean(out["mse_loss"])

        want, jgrads = jax.jit(jax.value_and_grad(loss_fn))(f64(variables["params"]))
        want, jflat = float(want), flatten_jax_tree(jax.device_get(jgrads))
    pm64 = copy.deepcopy(pm).double()
    pb = {k: torch.as_tensor(v) for k, v in batch64(batch).items()}
    pb.update(diffusion_t=torch.from_numpy(t), diffusion_noise=torch.from_numpy(noise),
              encoder_keep=torch.from_numpy(keep))
    got = pm64.loss(pb)["mse_loss"].mean()
    np.testing.assert_allclose(float(got), want, **TOL)
    names = [n for n, _ in pm64.named_parameters()]
    grads = torch.autograd.grad(got, list(pm64.parameters()), allow_unused=True)
    assert sorted(jflat) == sorted(names)
    for n, g, p in zip(names, grads, pm64.parameters()):
        g = np_(torch.zeros_like(p) if g is None else g)
        scale = max(float(np.abs(jflat[n]).max()), 1e-2)
        np.testing.assert_allclose(g, jflat[n], atol=2e-4 * scale, rtol=0, err_msg=n)


def batch64(batch):
    return {k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in batch.items()}


def test_pdm_predict_matches_jax(pdm_pair, monkeypatch):
    """The reverse chain from zero anchors on the encoded cloud, x_T and
    the step draws injected: (B, N, 3), 1e-4; the batch's clouds and seg
    masks passed through."""
    jm, variables, pm = pdm_pair
    batch = pdm_batch(seed=11)
    rng = np.random.RandomState(12)
    x_T = rng.randn(B, N, 3).astype(np.float32)
    steps = rng.randn(5, B, N, 3).astype(np.float32)
    real = JaxDiffusion.p_sample_loop
    monkeypatch.setattr(JaxDiffusion, "p_sample_loop", lambda self, fn, key, anchors, **kw: real(
        self, fn, key, anchors, **dict(kw, noise=jnp.asarray(x_T), step_noise=jnp.asarray(steps))))
    want = jm.apply(variables, {k: jnp.asarray(v) for k, v in batch.items()},
                    method=JaxPDM.predict, rngs={"sample": RNGS["sample"]})
    got = pm.predict({k: torch.as_tensor(v) for k, v in batch.items()},
                     noise=torch.from_numpy(x_T), step_noise=torch.from_numpy(steps))
    assert got["pred"].shape == (B, N, 3)
    np.testing.assert_allclose(np_(got["pred"]), np.asarray(want["pred"]), rtol=1e-4, atol=1e-4)
    for k in ("input", "input_ref", "seg_mask", "seg_mask_ref"):
        np.testing.assert_array_equal(np_(got[k]), np.asarray(want[k]), err_msg=k)
