"""Training through two-attention blocks and ``UNet``, against the JAX package.

The JAX package trains both unfused, with dropout (``deterministic=False``):
neither the one-block kernel nor the fused FF has a backward, so the port
runs the same unfused math under autograd. With dropout 0 the training
forward and every parameter's gradient of a fixed projection of the output
are held against ``jax.grad`` on the same weights (float32, 2e-4 of the
largest entry). Then one ``make_train_step`` step of a reduced gen_chair
whose denoiser is the two-attention ``TransformerNet``, and one whose
denoiser is ``UNet``, against the JAX step from the same state and batch:
the first rung of ``tests/test_torch_train_step.py``'s ladder.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from difffacto_tpu.config import Config as JaxConfig
from difffacto_tpu.models.anchor_diff import AnchorDiffAE as JaxAnchorDiffAE
from difffacto_tpu.models.denoiser import TransformerNet as JaxTransformerNet
from difffacto_tpu.models.denoiser import UNet as JaxUNet
from difffacto_tpu.parallel import build_optimizer_from_cfg as jax_build_optimizer
from difffacto_tpu.parallel import make_train_step as jax_make_train_step
from difffacto_tpu.parallel.train import TrainState as JaxTrainState
from difffacto_tpu.utils.registry import MODELS as JAX_MODELS
from difffacto_tpu.utils.registry import build_from_cfg as jax_build
from difffacto_torch import Config, MODELS, build_from_cfg, load_jax_params
from difffacto_torch.models import TransformerNet, UNet
from difffacto_torch.parallel import build_optimizer_from_cfg, init_train_state, make_train_step
from difffacto_torch.utils.jax_params import flatten_jax_tree
from test_torch_generation import CONFIG, randomize, t2n
from test_torch_modules import DENOISER
from test_torch_train_step import LADDER, OPT, SCHED, jb, make_batch, param_report, reduce, tb

B, N = 2, 64
UNET = dict(in_channels=3, n_heads=8, d_head=16, depth=2, embed_dim=128, prior_dim=22)


def denoiser_args(seed, width=262):
    rng = np.random.RandomState(seed)
    return dict(
        x=rng.randn(B, N, 3).astype(np.float32),
        t=np.array([3, 7], np.int32),
        ctx=rng.randn(B, 4, width).astype(np.float32),
        anchors=(0.1 * rng.randn(B, N, 3)).astype(np.float32),
        variances=(np.abs(rng.randn(B, N, 3)) * 0.5 + 0.1).astype(np.float32),
        seg_mask=np.repeat(np.arange(4), N // 4)[None].repeat(B, 0).astype(np.int32),
        valid_id=np.array([[1, 1, 1, 1], [1, 0, 1, 1]], np.float32),
    )


def hold_forward_and_grads(jnet, port, args, jcall, pcall):
    """The training forward of ``port`` against ``jnet`` (deterministic=False)
    and the gradients of sum(out * w) for every parameter."""
    jargs = {k: jnp.asarray(v) for k, v in args.items()}
    params = randomize(jnet.init(jax.random.PRNGKey(0), **jcall(jargs, True))["params"], seed=31)
    load_jax_params(port, params)
    w = np.random.RandomState(32).randn(B, N, 3).astype(np.float32)

    def loss(p):
        out = jnet.apply({"params": p}, **jcall(jargs, False))
        return jnp.sum(out * w), out

    (_, want), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    targs = {k: torch.as_tensor(v) for k, v in args.items()}
    out = port(**pcall(targs))
    np.testing.assert_allclose(t2n(out.detach()), np.asarray(want), rtol=2e-4, atol=2e-4)
    names = [n for n, _ in port.named_parameters()]
    grads = torch.autograd.grad((out * torch.as_tensor(w)).sum(), list(port.parameters()))
    jflat = flatten_jax_tree(jax.device_get(jgrads))
    assert set(jflat) == set(names)
    for n, g in zip(names, grads):
        scale = max(float(np.abs(jflat[n]).max()), 1e-2)
        np.testing.assert_allclose(t2n(g), jflat[n], rtol=0, atol=2e-4 * scale, err_msg=n)


def test_two_attention_transformer_net_trains_as_jax():
    """gen_chair's denoiser widths with two-attention blocks, depth 2,
    dropout 0, a part absent in row 1."""
    cfg = dict(DENOISER, single_attn=False)
    hold_forward_and_grads(
        JaxTransformerNet(**cfg), TransformerNet(**cfg, device="cpu"), denoiser_args(30),
        lambda a, init: dict(a, deterministic=init),
        lambda a: dict(a, train=True))


def test_unet_trains_as_jax():
    """UNet at depth 2, inner 128, the prior tokens with part 1 absent in row
    1, dropout 0: every flat block in training takes the unfused math."""
    args = denoiser_args(33, width=22)
    keep = ("x", "t", "ctx", "valid_id")
    args = {k: args[k] for k in keep}
    hold_forward_and_grads(
        JaxUNet(**UNET), UNet(**UNET, device="cpu"), args,
        lambda a, init: dict(a, deterministic=init),
        lambda a: dict(a, train=True))


def with_net(mcfg, kind):
    mcfg = reduce(mcfg, gen=False)
    if kind == "two_attention":
        mcfg["diffusion"]["net"].update(single_attn=False)
    else:
        mcfg["diffusion"]["net"] = dict(type="UNet", in_channels=3, n_heads=8, d_head=16,
                                        depth=2, embed_dim=128, prior_dim=262, dropout=0.0)
    return mcfg


@pytest.mark.parametrize("kind", ["two_attention", "unet"])
def test_one_train_step_matches_jax(kind):
    """One step of ``make_train_step`` against the JAX step on a reduced
    gen_chair (N = 128, T = 10) whose denoiser is ``kind``, every draw
    injected, the clip and the schedule as in test_torch_train_step: the loss
    dict and grad_norm to 1e-3, the mean parameter difference under 0.002 lr
    and at most 1 % of the entries more than 0.02 lr apart, the BatchNorm
    buffers to 1e-4."""
    jmodel = jax_build(with_net(JaxConfig(CONFIG).model.dump(), kind), JAX_MODELS)
    variables = jax.jit(lambda r, b: jmodel.init(r, b, 0, method=JaxAnchorDiffAE.loss))(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)}, jb(make_batch(0)))
    variables = {"params": randomize(variables["params"], seed=3),
                 "batch_stats": variables["batch_stats"]}
    pmodel = build_from_cfg(with_net(Config(CONFIG).model.dump(), kind), MODELS, device="cpu")
    load_jax_params(pmodel, variables["params"], variables["batch_stats"])
    jtx = jax_build_optimizer(OPT, SCHED, iters_per_epoch=1, max_norm=10.0)
    jstate, jmet = jax_make_train_step(jmodel, jtx, donate=False)(
        JaxTrainState.create(variables, jtx), jb(make_batch(40)), jax.random.PRNGKey(0), 0)
    tx = build_optimizer_from_cfg(OPT, SCHED, iters_per_epoch=1, max_norm=10.0)
    state, met = make_train_step(pmodel, tx)(init_train_state(pmodel, tx), tb(make_batch(40)),
                                             0, 0)
    jmet = {k: float(v) for k, v in jmet.items()}
    met = {k: float(v) for k, v in met.items()}
    assert set(met) == set(jmet) and met["skipped_nonfinite"] == 0.0
    rtol, mean_tol, share_tol, bn_tol = LADDER[0]
    for k in jmet:
        np.testing.assert_allclose(met[k], jmet[k], rtol=rtol, atol=1e-5, err_msg=k)
    pmax, pmean, pshare, bn = param_report(pmodel, jstate.params, jstate.batch_stats)
    assert pmax <= 2.05 and pmean <= mean_tol and pshare <= share_tol and bn <= bn_tol
    start = flatten_jax_tree(variables["params"])
    assert any(n.startswith("net.") and not np.array_equal(t2n(p), start[n])
               for n, p in pmodel.named_parameters())
