"""The port's training-side modules against their JAX counterparts.

BatchNorm (train and eval), PointNetV2 with per-part heads, the forward flow
with its log-density change, the five fit losses, the flow prior loss, the
diffusion training loss, the LR schedules and the optimizers against optax.
Same weights through ``load_jax_params``, inputs from a numpy seed, float32 on
the CPU; tolerances stated in each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

torch.set_num_threads(1)

from difffacto_tpu.models.diffusion import AnchoredDiffusion as JaxDiffusion
from difffacto_tpu.models.flow import PerPartFlow as JaxPerPartFlow
from difffacto_tpu.models.part_encoder import PartEncoderForTransformerDecoder as JaxPartEncoder
from difffacto_tpu.models.pointnet import PointNetV2 as JaxPointNetV2
from difffacto_tpu.nn.layers import TorchBatchNorm as JaxTorchBatchNorm
from difffacto_tpu.parallel import optim as jax_optim
from difffacto_tpu.utils import gaussian as jax_gaussian
from difffacto_torch.models import AnchoredDiffusion, PerPartFlow, PointNetV2
from difffacto_torch.models.part_encoder import PartEncoderForTransformerDecoder
from difffacto_torch.nn.layers import TorchBatchNorm
from difffacto_torch.parallel import optim
from difffacto_torch.utils import gaussian
from difffacto_torch.utils.jax_params import flatten_jax_tree, load_jax_params
from test_torch_modules import randomize, t2n

tt = torch.as_tensor


def test_gaussian_helpers_match_jax():
    """The quirks are kept: -logvar not halved, the 2 pi constant times dim. 1e-6."""
    rng = np.random.RandomState(0)
    z, m, lv, lv2 = (rng.randn(3, 4, 5).astype(np.float32) for _ in range(4))
    pairs = [
        (gaussian.gaussian_entropy(tt(lv)), jax_gaussian.gaussian_entropy(jnp.asarray(lv))),
        (gaussian.gaussian_log_likelihood(tt(z), tt(m), tt(lv), dim=5),
         jax_gaussian.gaussian_log_likelihood(jnp.asarray(z), jnp.asarray(m), jnp.asarray(lv), dim=5)),
        (gaussian.gaussian_log_likelihood(tt(z), 0.0, 0.3, dim=2),
         jax_gaussian.gaussian_log_likelihood(jnp.asarray(z), 0.0, 0.3, dim=2)),
        (gaussian.normal_kl(tt(z), tt(lv), tt(m), tt(lv2)),
         jax_gaussian.normal_kl(*[jnp.asarray(a) for a in (z, lv, m, lv2)])),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=1e-5, atol=1e-6)
    got = gaussian.reparameterize_gaussian(tt(m), tt(lv), eps=tt(z))
    np.testing.assert_allclose(t2n(got), m + np.exp(0.5 * lv) * z, rtol=1e-6, atol=1e-6)


def test_batchnorm_train_and_eval_match_flax():
    """Three training updates then an eval pass: outputs to 1e-5, the running
    mean and the *biased* running variance to 1e-6 (torch's BatchNorm1d would
    store the unbiased one and miss this by a factor n / (n - 1))."""
    rng = np.random.RandomState(1)
    jbn = JaxTorchBatchNorm()
    xs = [(rng.randn(6, 10, 16) * (i + 1) + i).astype(np.float32) for i in range(4)]
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]), use_running_average=False)
    params = randomize(variables["params"], 2)
    stats = variables["batch_stats"]
    bn = TorchBatchNorm(16, device="cpu")
    load_jax_params(bn, {"TorchBatchNorm_0": params}["TorchBatchNorm_0"], stats)
    for x in xs[:3]:
        want, mut = jbn.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                              use_running_average=False, mutable=["batch_stats"])
        stats = mut["batch_stats"]
        got = bn(tt(x), train=True)
        np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    flat = flatten_jax_tree(stats)
    np.testing.assert_allclose(bn.mean.numpy(), flat["mean"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.var.numpy(), flat["var"], rtol=1e-6, atol=1e-6)
    n = 60.0
    assert not np.allclose(bn.var.numpy(), 1 + (flat["var"] - 1) * n / (n - 1), rtol=1e-4)
    want = jbn.apply({"params": params, "batch_stats": stats}, jnp.asarray(xs[3]),
                     use_running_average=True)
    np.testing.assert_allclose(t2n(bn(tt(xs[3]))), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("train", [True, False])
def test_pointnet_v2_per_part_heads_match_jax(train):
    """3 -> 128 -> 128 -> 256 -> 512, masked max pool times K, stacked per-part
    heads; a part absent in one row. Outputs 1e-4, the BatchNorm statistics
    after the pass 1e-5."""
    rng = np.random.RandomState(3)
    B, N, K = 4, 64, 4
    pts = rng.randn(B, N, 3).astype(np.float32)
    seg = rng.randint(0, K, (B, N))
    seg[1][seg[1] == 2] = 0
    onehot = np.eye(K, dtype=np.float32)[seg]
    jnet = JaxPointNetV2(zdim=32, per_part_mlp=True)
    variables = jnet.init(jax.random.PRNGKey(0), jnp.asarray(pts), jnp.asarray(onehot), train=True)
    params = randomize(variables["params"], 4)
    stats = jax.tree_util.tree_map(
        lambda a: np.abs(rng.randn(*a.shape)).astype(np.float32) + 0.5, variables["batch_stats"])
    net = PointNetV2(zdim=32, per_part_mlp=True, device="cpu")
    load_jax_params(net, params, stats)
    assert net.mlp_m.dense0.kernel.shape == (4, 512, 256) and net.mlp_v.bn1.var.shape == (4, 128)
    want, mut = jnet.apply({"params": params, "batch_stats": stats}, jnp.asarray(pts),
                           jnp.asarray(onehot), train=train, mutable=["batch_stats"])
    got = net(tt(pts), tt(onehot), train=train)
    for g, w in zip(got, want):
        assert g.shape == (B, K, 32)
        np.testing.assert_allclose(t2n(g), np.asarray(w), rtol=1e-4, atol=1e-4)
    flat = flatten_jax_tree(mut["batch_stats"])
    bufs = dict(net.named_buffers())
    assert set(flat) == set(bufs)
    for name, want_stat in flat.items():
        np.testing.assert_allclose(bufs[name].numpy(), want_stat, rtol=1e-5, atol=1e-5, err_msg=name)


def test_flow_forward_with_logpx_matches_jax():
    """4 parts x 3 coupling layers forward with the log-density change, and
    forward then reverse is the identity: 1e-5 relative / 1e-4 absolute."""
    rng = np.random.RandomState(5)
    z = rng.randn(3, 4, 256).astype(np.float32)
    logpx = rng.randn(3, 4, 1).astype(np.float32)
    jflow = JaxPerPartFlow(n_class=4, depth=3, dim=256, intermediate_dim=64)
    params = randomize(jflow.init(jax.random.PRNGKey(0), jnp.asarray(z), reverse=True)["params"], 6)
    want_y, want_lp = jflow.apply({"params": params}, jnp.asarray(z), jnp.asarray(logpx), False)
    flow = PerPartFlow(4, 3, 256, 64, device="cpu")
    load_jax_params(flow, params)
    with torch.no_grad():
        y, lp = flow(tt(z), tt(logpx), reverse=False)
        back, lp_back = flow(y, lp, reverse=True)
    np.testing.assert_allclose(t2n(y), np.asarray(want_y), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(t2n(lp), np.asarray(want_lp), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(t2n(back), z, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(t2n(lp_back), logpx, rtol=1e-4, atol=1e-4)


ENCODER = dict(
    encoder=dict(type="PointNetV2", zdim=32, point_dim=3, per_part_mlp=True),
    part_aligner=dict(type="PartAlignerTransformer", in_channels=32, out_channels=6, n_class=4,
                      d_head=16, depth=1, n_heads=4, single_attn=True, class_cond=True,
                      add_class_cond=True, cimle=True, noise_scale=10, cond_noise_type=0),
    n_class=4, kl_weight=0.01, use_flow=True, latent_flow_depth=2, latent_flow_hidden_dim=32,
    include_part_code=True, include_params=True, gen=True,
)


def fit_inputs(seed, B=3, N=32, K=4):
    rng = np.random.RandomState(seed)
    r = lambda *s: rng.randn(*s).astype(np.float32)
    seg = rng.randint(0, K, (B, N)).astype(np.int32)
    valid = np.array([[1, 1, 1, 1], [1, 0, 1, 1], [1, 1, 1, 0]], np.float32)
    mean, logvar = 0.3 * r(B, K, 3), 0.3 * r(B, K, 3)
    idx = seg[..., None].repeat(3, -1)
    return dict(
        ref=r(B, N, 3), mean=mean, logvar=logvar, valid_id=valid,
        mean_pp=np.take_along_axis(mean, idx, 1), logvar_pp=np.take_along_axis(logvar, idx, 1),
        flag_pp=np.take_along_axis(valid, seg, 1), gt_shift=0.2 * r(B, K, 3),
        gt_var=np.abs(r(B, K, 3)) + 0.2, seg_mask=seg,
    )


@pytest.mark.parametrize("fit_type", [0, 1, 4])
def test_fit_loss_without_a_draw_matches_jax(fit_type):
    """Types 0, 1 and 4 (the shipped configs use 4) draw nothing: 1e-5."""
    inp = fit_inputs(7)
    cfg = dict(ENCODER, fit_loss_type=fit_type)
    jenc = JaxPartEncoder(**cfg)
    want = jenc.apply({}, *[jnp.asarray(a) for a in inp.values()], method=JaxPartEncoder.get_fit_loss)
    enc = PartEncoderForTransformerDecoder(**cfg, device="cpu")
    got = enc.get_fit_loss(*[tt(a) for a in inp.values()])
    assert got.shape == (3,)
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fit_type", [2, 3])
def test_fit_loss_with_an_injected_draw_matches_the_jax_formula(fit_type):
    """Types 2 and 3 sample inside the loss. The JAX method takes no draw, so
    its standard normal is recovered from its own rng stream (``make_rng``
    folds the stream's key with the call count) and injected: 1e-5."""
    inp = fit_inputs(8)
    cfg = dict(ENCODER, fit_loss_type=fit_type)
    jenc = JaxPartEncoder(**cfg)
    key = jax.random.PRNGKey(3)

    def with_draw(m, *args):
        shape = inp["mean"].shape if fit_type == 2 else inp["mean_pp"].shape
        # the same stream position the loss will read: make_rng is counted per module
        eps = jax.random.normal(m.make_rng("sample"), shape, jnp.float32)
        return eps

    eps = np.asarray(jenc.apply({}, method=with_draw, rngs={"sample": key}))
    want = jenc.apply({}, *[jnp.asarray(a) for a in inp.values()],
                      method=JaxPartEncoder.get_fit_loss, rngs={"sample": key})
    enc = PartEncoderForTransformerDecoder(**cfg, device="cpu")
    got = enc.get_fit_loss(*[tt(a) for a in inp.values()], eps=tt(eps))
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("annealing, epoch", [(False, 5), (True, 5), (True, 50)])
def test_prior_loss_on_a_given_part_code_matches_jax(annealing, epoch):
    """The flow prior loss and its per-part statistics on a given part code
    (the draw is outside this method), with and without kl annealing: 1e-4
    relative (the log-likelihood sums 32 terms of ~30 each)."""
    rng = np.random.RandomState(9)
    cfg = dict(ENCODER, kl_weight_annealing=annealing, kl_weight_annealing_end_epoch=20)
    code, mean, logvar = (rng.randn(3, 4, 32).astype(np.float32) for _ in range(3))
    valid = np.array([[1, 1, 1, 1], [1, 0, 1, 1], [1, 1, 1, 0]], np.float32)
    jenc = JaxPartEncoder(**cfg)
    jin = [jnp.asarray(a) for a in (code, mean, logvar, valid)]
    method = lambda m, *a: m.get_prior_loss(*a, epoch=epoch)
    variables = jenc.init(jax.random.PRNGKey(0), *jin, method=method)
    params = {"flow": randomize(variables["params"]["flow"], 10)}
    want = jenc.apply({"params": params}, *jin, method=method)
    enc = PartEncoderForTransformerDecoder(**cfg, device="cpu")
    load_jax_params(enc.flow, params["flow"])
    with torch.no_grad():
        got = enc.get_prior_loss(*[tt(a) for a in (code, mean, logvar, valid)], epoch=epoch)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(t2n(got[k]), np.asarray(want[k]), rtol=1e-4, atol=1e-4, err_msg=k)


DIFFUSION = dict(num_timesteps=10, beta_1=1e-4, beta_T=0.02, res=False, use_beta=False,
                 learn_variance=True, include_anchors=False)


@pytest.mark.parametrize("flags, reduce", [(False, True), (True, True), (True, False)])
def test_training_losses_match_jax(flags, reduce):
    """q_sample and the mse loss of the epsilon mean with the noise injected and
    a fixed model function, with and without per-point flags: 1e-5."""
    rng = np.random.RandomState(11)
    B, N = 3, 16
    x0, noise, anchors = (rng.randn(B, N, 3).astype(np.float32) for _ in range(3))
    variance = (np.abs(rng.randn(B, N, 3)) + 0.1).astype(np.float32)
    t = np.array([0, 4, 9], np.int32)
    fl = (rng.rand(B, N) > 0.3).astype(np.float32) if flags else None
    jfn = lambda inp, ts, c, anc, var, seg, vid: jnp.tanh(inp * 1.3) + 0.1 * ts[:, None, None]
    tfn = lambda inp, ts, c, anc, var, seg, vid: torch.tanh(inp * 1.3) + 0.1 * ts[:, None, None]
    jd, td = JaxDiffusion(**DIFFUSION), AnchoredDiffusion(**DIFFUSION)
    want = jd.training_losses(
        jfn, None, jnp.asarray(x0), jnp.asarray(t), anchors=jnp.asarray(anchors),
        variance=jnp.asarray(variance), flags=None if fl is None else jnp.asarray(fl),
        noise=jnp.asarray(noise), reduce=reduce)["mse_loss"]
    got = td.training_losses(
        tfn, tt(x0), tt(t).long(), anchors=tt(anchors), variance=tt(variance),
        flags=None if fl is None else tt(fl), noise=tt(noise), reduce=reduce)["mse_loss"]
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=1e-5, atol=1e-6)
    want_q = jd.q_sample(None, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(anchors),
                         noise=jnp.asarray(noise), variance=jnp.asarray(variance))
    got_q = td.q_sample(tt(x0), tt(t).long(), tt(anchors), noise=tt(noise), variance=tt(variance))
    np.testing.assert_allclose(t2n(got_q), np.asarray(want_q), rtol=1e-5, atol=1e-6)


SCHEDULES = [
    ("LinearLR", dict(start_epoch=2, end_epoch=5, start_lr=2e-3, end_lr=1e-4)),
    ("CustomStepLR", dict(milestone=[2, 4], gamma=0.5)),
    ("StepLR", dict(step_size=2, gamma=0.1)),
    ("CosineAnnealingLR", dict(T_max=6, eta_min=1e-5, base_lr=1e-3)),
    ("CosineAnnealingLRWithWarmUp", dict(T_max=20, eta_min=1e-5, warmup_T=3, warmup_lr=1e-6,
                                         base_lr=1e-3)),
]


@pytest.mark.parametrize("name, kw", SCHEDULES, ids=[s[0] for s in SCHEDULES])
def test_schedule_matches_jax_over_six_epochs(name, kw):
    ours, theirs = getattr(optim, name)(**kw), getattr(jax_optim, name)(**kw)
    for epoch in range(6):
        np.testing.assert_allclose(float(ours(epoch)), float(theirs(float(epoch))), rtol=1e-6,
                                   err_msg=f"epoch {epoch}")


@pytest.mark.parametrize("kind, weight_decay", [("Adam", 0.0), ("Adam", 0.01), ("AdamW", 0.01),
                                                ("Adamax", 0.01), ("SGD", 0.0)])
def test_optimizer_matches_optax_over_five_steps(kind, weight_decay):
    """Five updates on fixed gradients with the clip active (norm ~ 6 against
    max_norm 1), a schedule that moves every second step and a per-path scale:
    parameters to 1e-6 after every step."""
    rng = np.random.RandomState(12)
    shapes = {"a": (4, 3), "b": (5,), "c": (2, 2, 2)}
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) * (1 + i) for k, s in shapes.items()}
             for i in range(5)]
    ocfg = dict(type=kind, lr=1e-2, weight_decay=weight_decay)
    scfg = dict(type="CustomStepLR", milestone=[1, 2], gamma=0.5)
    jscale = lambda path: 0.5 if "b" in path[0] else 1.0
    jtx = jax_optim.build_optimizer_from_cfg(ocfg, scfg, iters_per_epoch=2, max_norm=1.0,
                                             lr_scale_fn=jscale)
    tx = optim.build_optimizer_from_cfg(ocfg, scfg, iters_per_epoch=2, max_norm=1.0,
                                        lr_scale_fn=lambda path: 0.5 if path == ("b",) else 1.0)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = jtx.init(jp)
    tp = [tt(v.copy()) for v in p0.values()]
    paths = [(k,) for k in p0]
    tstate = tx.init(tp)
    for g in grads:
        upd, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tupd, tstate = tx.update([tt(v) for v in g.values()], tstate, tp, paths)
        tp = [p + u for p, u in zip(tp, tupd)]
        for k, got in zip(p0, tp):
            np.testing.assert_allclose(got.numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    assert float(tstate["count"]) == 5
