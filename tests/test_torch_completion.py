"""The completion models of the port against the JAX package, on the CPU.

The counterparts of ``TestCompletion`` (``tests/test_flow_completion_editors.py``)
at its shapes (partial clouds of 32 or 16 points, PCN 64 points on a 4 x 4
grid, encoders 16 or 32 wide, T = 5), the weights bridged with
``load_jax_params``: ``PCN``'s coarse and fine clouds and its Chamfer
losses (the default, which the JAX module computes as the squared-L2
Chamfer because its ``loss`` method shadows the field, and "cd_l1"),
``CoarsePCN``, and ``DiffuCompletion``'s loss (t and the chain's noise
injected) and ``reconstruct`` (x_T and the step draws injected, the
trajectory kept); then ``PCN``'s loss on a batch of the port's
``CroppingDataLoader``.

Tolerances: 1e-5 for float32 forwards; every training loss in float64 on
both sides (BatchNorm's batch statistics over 2 clouds), with its gradients
at 2e-4 of each tensor's largest entry (2e-6 where that is below 1e-2);
1e-4 for a reverse chain.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difffacto_tpu.models import completion as jc
from difffacto_torch.data import SyntheticPart
from difffacto_torch.data.dataset_utils import CroppingDataLoader
from difffacto_torch.models import completion as pc
from test_torch_anchored_gen import Draws
from test_torch_editors import (CHAIN_TOL, hold_training, jax_loss_and_grads, japply,
                                port_loss_and_grads, randn)
from torch_pairs import RNGS, bridge, close

torch.set_num_threads(1)

B = 2


@pytest.mark.parametrize("loss", [None, "cd_l1"], ids=["default", "cd_l1"])
def test_pcn_matches_jax(loss):
    """Coarse (B, 4, 3) and fine (B, 64, 3) clouds in eval, then both
    Chamfer losses in training with their gradients."""
    kw = dict(num_pred=64, encoder_channel=32, grid_size=4)
    if loss is not None:
        kw["loss"] = loss
    jm, pm = jc.PCN(**kw), pc.PCN(**kw, device="cpu")
    partial = randn(B, 32, 3)
    variables = bridge(jm, pm, jnp.asarray(partial), jit=True)
    got = pm(torch.from_numpy(partial))
    assert got[0].shape == (B, 4, 3) and got[1].shape == (B, 64, 3)
    close(got, japply(jm, variables, jnp.asarray(partial)))
    batch = {"ref": randn(B, 64, 3, seed=2), "input": partial}
    hold_training(port_loss_and_grads(pm, batch),
                  jax_loss_and_grads(jm, variables, (batch,), jc.PCN.loss))


def test_coarse_pcn_matches_jax():
    """32 coarse points from the whole cloud, and their Chamfer loss
    against it in training."""
    jm, pm = jc.CoarsePCN(num_anchors=32, encoder_channel=32), pc.CoarsePCN(
        num_anchors=32, encoder_channel=32, device="cpu")
    cloud = randn(B, 32, 3, seed=3)
    variables = bridge(jm, pm, jnp.asarray(cloud), jit=True)
    close(pm(torch.from_numpy(cloud)), japply(jm, variables, jnp.asarray(cloud)))
    batch = {"ref": cloud}
    hold_training(port_loss_and_grads(pm, batch),
                  jax_loss_and_grads(jm, variables, (batch,), jc.CoarsePCN.loss))


DC = dict(diffusion=dict(type="PointDiffusion",
                         net=dict(type="PointwiseNet", point_dim=3, context_dim=16,
                                  hidden=(16, 32, 16)),
                         beta_1=1e-4, beta_T=0.02),
          sampler=dict(type="Uniform"), num_timesteps=5, encoder_channel=16, npoints=32)


@pytest.fixture(scope="module")
def dc_pair():
    jm, pm = jc.DiffuCompletion(**DC), pc.DiffuCompletion(**DC, device="cpu")
    batch = {"ref": jnp.asarray(randn(B, 32, 3)), "input": jnp.asarray(randn(B, 16, 3, seed=1))}
    return jm, bridge(jm, pm, batch, 0, method=jc.DiffuCompletion.loss, jit=True), pm


def test_diffu_completion_loss_matches_jax(dc_pair, monkeypatch):
    """The chain's loss on ``ref`` from zero anchors, the partial cloud's
    code its one ctx token; t and the noise injected; gradients too."""
    jm, variables, pm = dc_pair
    rng = np.random.RandomState(4)
    batch = {"ref": randn(B, 32, 3, seed=5), "input": randn(B, 16, 3, seed=6)}
    t, noise = np.array([0, 4], np.int32), rng.randn(B, 32, 3)
    Draws(monkeypatch, t=t, noise=noise)
    want = jax_loss_and_grads(jm, variables, (batch,), jc.DiffuCompletion.loss)
    batch.update(diffusion_t=torch.from_numpy(t), diffusion_noise=noise)
    hold_training(port_loss_and_grads(pm, batch), want)


@pytest.mark.parametrize("ret_traj", [False, True])
def test_diffu_completion_reconstruct_matches_jax(dc_pair, ret_traj, monkeypatch):
    """encode -> the reverse chain -> pred, with ref and input beside it;
    x_T and the step draws injected; with ``ret_traj`` every other step."""
    jm, variables, pm = dc_pair
    jm = jm.clone(ret_traj=ret_traj, ret_interval=2)
    pm.ret_traj, pm.ret_interval = ret_traj, 2
    rng = np.random.RandomState(7)
    batch = {"ref": randn(B, 32, 3, seed=8), "input": randn(B, 16, 3, seed=9)}
    x_T, steps = rng.randn(B, 32, 3).astype(np.float32), rng.randn(5, B, 32, 3).astype(np.float32)
    Draws(monkeypatch, x_T=x_T, steps=steps)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    run = jm.apply if ret_traj else lambda v, *a, **k: japply(jm, v, *a, **k)
    want = run(variables, jb, method=jc.DiffuCompletion.reconstruct,
               rngs={"sample": RNGS["sample"]})
    got = pm.reconstruct({k: torch.from_numpy(v) for k, v in batch.items()},
                         noise=torch.from_numpy(x_T), step_noise=torch.from_numpy(steps))
    pm.ret_traj = False
    assert sorted(got) == sorted(want)
    for k in want:
        close(got[k], want[k], CHAIN_TOL, what=k)


def test_pcn_trains_on_the_cropping_loaders_batches():
    """``input`` is the loader's ``partial`` cut from ``ref``: PCN's losses
    and gradients on such a batch match the JAX module's on the same arrays."""
    loader, _ = SyntheticPart(batch_size=B, npoints=96, size=4, shuffle=False)
    crop = CroppingDataLoader(loader, crop=40, seed=3, device="cpu")
    raw = next(iter(crop))
    batch = {"ref": np.asarray(raw["input"], np.float32),
             "input": raw["partial"].numpy().astype(np.float32)}
    assert batch["input"].shape == (B, 56, 3)
    kw = dict(num_pred=64, encoder_channel=32, grid_size=4)
    jm, pm = jc.PCN(**kw), pc.PCN(**kw, device="cpu")
    variables = bridge(jm, pm, jnp.asarray(batch["input"]), jit=True)
    hold_training(port_loss_and_grads(pm, batch),
                  jax_loss_and_grads(jm, variables, (batch,), jc.PCN.loss))
