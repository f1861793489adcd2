"""PointFlow's CNF stack in the port against the JAX package, on the CPU.

The counterparts of ``TestCNF`` (``tests/test_flow_completion_editors.py``)
at its shapes, the weights bridged with ``load_jax_params``:
``ConcatSquashODE``; the CNF forward and reversed, with the exact
divergence (three JVPs) and with a Hutchinson probe, its round trip, and
the gradients of a loss on its output and log-density change (reverse mode
through the forward-mode tangents) against ``jax.grad``; ``PointFlow``'s
losses in training (the posterior draw injected) with their gradients, and
``sample`` with both normal draws injected.

Tolerances: 1e-5 for a float32 forward; 1e-4 for an RK4 integration in
float32; gradients in float64 on both sides (and ``PointFlow``'s training,
whose encoder's BatchNorm reads 2 clouds) at 2e-4 of each tensor's largest
entry (2e-6 where that is below 1e-2); the round trip at the JAX test's
1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difffacto_tpu.models import pointflow as jpf
from difffacto_torch import load_jax_params
from difffacto_torch.models import pointflow as ppf
from difffacto_torch.utils.jax_params import flatten_jax_tree
from test_model import N_CLASS, tiny_batch
from test_torch_anchored_gen import Draws
from test_torch_editors import (CHAIN_TOL, hold_training, jax_loss_and_grads, japply,
                                port_loss_and_grads, randn)
from torch_pairs import RNGS, bridge, close, f64, np_, wide

torch.set_num_threads(1)


def test_concat_squash_ode_matches_jax():
    """f(y, t, ctx): sigmoid gates and bias-free hyper-biases of [t, ctx]."""
    jm = jpf.ConcatSquashODE(dims=(16, 8), out_dim=3)
    pm = ppf.ConcatSquashODE(3, 5, (16, 8), 3, device="cpu")
    y, ctx = randn(2, 7, 3), randn(2, 7, 5, seed=1)
    variables = bridge(jm, pm, jnp.asarray(y), 0.25, jnp.asarray(ctx), jit=True)
    close(pm(torch.from_numpy(y), 0.25, torch.from_numpy(ctx)),
          japply(jm, variables, jnp.asarray(y), 0.25, jnp.asarray(ctx)))


def cnf_pair(exact):
    out = 3 if exact else 8
    kw = dict(dims=(16, 16), out_dim=out, steps=8, exact_trace=exact)
    jm, pm = jpf.CNF(**kw), ppf.CNF(**kw, context_dim=8 if exact else 1, device="cpu")
    y = randn(2, 10, 3) if exact else randn(2, out, seed=2)
    ctx = randn(2, 10, 8, seed=1) if exact else np.zeros((2, 1), np.float32)
    return jm, pm, y, ctx, bridge(jm, pm, jnp.asarray(y), jnp.asarray(ctx), jit=True)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "hutchinson"])
def test_cnf_matches_jax_both_ways(exact):
    """(y_out, delta_logp) forward and reversed at 1e-4, the Hutchinson
    probe a random ``eps``; the round trip returns y and the two density
    changes cancel (the JAX test's 1e-3)."""
    jm, pm, y, ctx, variables = cnf_pair(exact)
    eps = None if exact else randn(*y.shape, seed=3)
    jeps = None if exact else jnp.asarray(eps)
    peps = None if exact else torch.from_numpy(eps)
    for reverse in (False, True):
        want = japply(jm, variables, jnp.asarray(y), jnp.asarray(ctx), reverse=reverse, eps=jeps)
        got = pm(torch.from_numpy(y), torch.from_numpy(ctx), reverse=reverse, eps=peps)
        close(got, want, CHAIN_TOL, what=f"reverse={reverse}")
    fwd, delta = pm(torch.from_numpy(y), torch.from_numpy(ctx), eps=peps)
    back, delta_b = pm(fwd.detach(), torch.from_numpy(ctx), reverse=True, eps=peps)
    np.testing.assert_allclose(np_(back), y, atol=1e-3)
    np.testing.assert_allclose(np_(delta + delta_b), 0, atol=1e-3)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "hutchinson"])
def test_cnf_gradients_match_jax_grad(exact):
    """d/d(params, y) of mean(y_out^2) + mean(delta_logp): the gradient runs
    through the JVPs' tangents, each RK4 step checkpointed in the port."""
    jm, pm, y, ctx, variables = cnf_pair(exact)
    eps = randn(*y.shape, seed=3)
    with jax.enable_x64(True):
        def f(params, yy):
            out, delta = jm.apply({"params": params}, yy, jnp.asarray(wide(ctx)),
                                  eps=None if exact else jnp.asarray(wide(eps)))
            return jnp.mean(out ** 2) + jnp.mean(delta)

        jg, jy = jax.jit(jax.grad(f, argnums=(0, 1)))(f64(variables)["params"],
                                                      jnp.asarray(wide(y)))
        jg = flatten_jax_tree(jax.device_get(jg))
    pm64 = pm.double()
    yt = torch.as_tensor(wide(y)).requires_grad_(True)
    out, delta = pm64(yt, torch.as_tensor(wide(ctx)),
                      eps=None if exact else torch.as_tensor(wide(eps)))
    named = dict(pm64.named_parameters())
    grads = torch.autograd.grad((out ** 2).mean() + delta.mean(), [yt] + list(named.values()))
    hold_training(({}, dict(zip(["y"] + list(named), grads)), {}),
                  ({}, {"y": np.asarray(jy), **jg}, {}))


PF = dict(encoder=dict(type="PointNetV2", zdim=8, point_dim=3, per_part_mlp=False),
          point_cnf=dict(dims=(16, 16), steps=4), latent_cnf=dict(dims=(16,), steps=4),
          part_aligner=dict(type="PartAlignerTransformer", in_channels=8, out_channels=6,
                            n_class=N_CLASS, d_head=4, depth=1, n_heads=2, single_attn=True,
                            class_cond=True, add_class_cond=True),
          zdim=8, n_class=N_CLASS)


@pytest.fixture(scope="module")
def pf_pair():
    jm, pm = jpf.PointFlow(**PF), ppf.PointFlow(**PF, device="cpu")
    return jm, bridge(jm, pm, tiny_batch(B=2), 0, method=jpf.PointFlow.loss, jit=True), pm


def test_pointflow_loss_matches_jax(pf_pair, monkeypatch):
    """fit, entropy, recon and prior losses in training (float64), the
    posterior's normals injected; gradients through both flows."""
    jm, variables, pm = pf_pair
    batch = {k: np.array(v) for k, v in tiny_batch(B=2, rng=np.random.RandomState(4)).items()}
    batch["present"][1, 2] = 0.0
    eps = np.random.RandomState(5).randn(2, N_CLASS, 8)
    Draws(monkeypatch, eps=[eps])
    want = jax_loss_and_grads(jm, variables, (batch,), jpf.PointFlow.loss)
    batch["latent_eps"] = eps
    hold_training(port_loss_and_grads(pm, batch), want)


def test_pointflow_sample_matches_jax(pf_pair, monkeypatch):
    """Latents through the latent CNFs reversed, points through the point
    CNF reversed, from injected normals."""
    jm, variables, pm = pf_pair
    rng = np.random.RandomState(6)
    w, y = rng.randn(2, N_CLASS, 8).astype(np.float32), rng.randn(2, 16, 3).astype(np.float32)
    Draws(monkeypatch, normals=[w, y])
    want = japply(jm, variables, 2, 16, method=jpf.PointFlow.sample,
                  rngs={"sample": RNGS["sample"]})
    got = pm.sample(2, 16, w=torch.from_numpy(w), y=torch.from_numpy(y))
    assert got[1].shape == (2, 16, 3)
    close(got, want, CHAIN_TOL)


def test_load_jax_params_fills_every_flow(pf_pair):
    """The point flow, the four latent flows and the aligner load under
    the JAX names, and a missing leaf raises."""
    _, variables, pm = pf_pair
    params = dict(variables["params"])
    for i in range(N_CLASS):
        np.testing.assert_array_equal(
            np_(pm.latent_flows[i].ode.gate_0.kernel),
            np.asarray(params[f"latent_flows_{i}"]["ode"]["gate_0"]["kernel"]))
    del params["latent_flows_3"]
    with pytest.raises(KeyError, match="latent_flows_3"):
        load_jax_params(ppf.PointFlow(**PF, device="cpu"), params)
