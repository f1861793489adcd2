"""The port's training slice against the JAX package, end to end.

A reduced-depth gen_chair (denoiser depth 2, flow depth 2, aligner depth 1,
N = 128, T = 10, dropout 0) at full widths: the JAX model is initialised, its
parameters randomised and bridged into the port with ``load_jax_params``
(BatchNorm statistics included). ``diffusion_t``, ``diffusion_noise`` and the
aligner ``noise`` are injected through the batch, so both sides see the same
draws. float32 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from __graft_entry__ import _example_batch
from difffacto_tpu.config import Config as JaxConfig
from difffacto_tpu.models.anchor_diff import AnchorDiffAE as JaxAnchorDiffAE
from difffacto_tpu.models.anchor_diff import select_best_noise as jax_select_best_noise
from difffacto_tpu.parallel import build_optimizer_from_cfg as jax_build_optimizer
from difffacto_tpu.parallel import make_train_step as jax_make_train_step
from difffacto_tpu.parallel.train import TrainState as JaxTrainState
from difffacto_tpu.utils.registry import MODELS as JAX_MODELS
from difffacto_tpu.utils.registry import build_from_cfg as jax_build
from difffacto_torch import Config, MODELS, build_from_cfg, load_jax_params
from difffacto_torch.models import ensure_attn_maps, select_best_noise
from difffacto_torch.parallel import build_optimizer_from_cfg, init_train_state, make_train_step
from difffacto_torch.utils.jax_params import flatten_jax_tree
from test_torch_generation import CONFIG, randomize, t2n

N, T, B = 128, 10, 4
LR = 2e-3
OPT = dict(type="Adam", lr=LR, weight_decay=0.0)
SCHED = dict(type="LinearLR", start_lr=2e-3, end_lr=1e-4, start_epoch=1, end_epoch=3)


def reduce(mcfg, gen):
    mcfg.update(npoints=N, num_timesteps=T, ret_traj=False, cimle_sample_num=1, gen=gen)
    mcfg["encoder"]["gen"] = gen
    mcfg["encoder"]["kl_weight"] = 0.01
    mcfg["encoder"]["part_aligner"].update(depth=1, noise_scale=10)
    mcfg["encoder"]["latent_flow_depth"] = 2
    mcfg["diffusion"]["net"].update(depth=2, dropout=0.0)
    return mcfg


def make_batch(seed, nan=False):
    """The entry point's synthetic batch with every draw of the loss injected."""
    rng = np.random.RandomState(seed)
    batch = {k: np.asarray(v) for k, v in _example_batch(B=B, npoints=N, seed=seed).items()}
    batch["present"] = np.array([[1, 1, 1, 1], [1, 0, 1, 1], [1, 1, 1, 1], [1, 1, 1, 0]], np.float32)
    batch["dp_present"] = batch["present"]
    batch.update(diffusion_t=rng.randint(0, T, (B,)).astype(np.int32),
                 diffusion_noise=rng.randn(B, N, 3).astype(np.float32),
                 noise=rng.randn(B, 32).astype(np.float32))
    if nan:
        batch["ref"] = batch["ref"].copy()
        batch["ref"][1, 5, 2] = np.nan
        batch["input"] = batch["ref"]
    return batch


def jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tb(batch):
    return {k: torch.as_tensor(np.array(v)) for k, v in batch.items()}


def build_pair(gen):
    jmodel = jax_build(reduce(JaxConfig(CONFIG).model.dump(), gen), JAX_MODELS)
    variables = jax.jit(lambda r, b: jmodel.init(r, b, 0, method=JaxAnchorDiffAE.loss))(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)}, jb(make_batch(0)))
    variables = {"params": randomize(variables["params"], seed=3),
                 "batch_stats": variables["batch_stats"]}
    pmodel = build_from_cfg(reduce(Config(CONFIG).model.dump(), gen), MODELS, device="cpu")
    load_jax_params(pmodel, variables["params"], variables["batch_stats"])
    return jmodel, variables, pmodel


@pytest.fixture(scope="module")
def pair_stage1():
    return build_pair(gen=False)


@pytest.fixture(scope="module")
def pair_gen():
    return build_pair(gen=True)


RNGS = {"sample": jax.random.PRNGKey(7), "dropout": jax.random.PRNGKey(8)}


def assert_loss_dicts(got, want, rtol=1e-4):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(t2n(got[k])), np.asarray(want[k]), rtol=rtol,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("train", [True, False])
def test_loss_matches_jax_without_the_prior(pair_stage1, train, monkeypatch):
    """``gen=False``: fit loss type 4 and the mse loss, with t, the diffusion
    noise and the aligner noise injected; in training mode the JAX trunk is
    its Pallas training kernel in interpret mode. 1e-4 relative per entry."""
    monkeypatch.setenv("DIFFFACTO_PALLAS_INTERPRET", "1")
    jmodel, variables, pmodel = pair_stage1
    batch = make_batch(1)
    want, _ = jmodel.apply(variables, jb(batch), 0, train, method=JaxAnchorDiffAE.loss,
                           rngs=RNGS, mutable=["batch_stats"])
    stats = [b.clone() for b in pmodel.buffers()]
    got = pmodel.loss(ensure_attn_maps(tb(batch)), 0, train)
    for b, old in zip(pmodel.buffers(), stats):  # leave the shared model as it was
        b.copy_(old)
    assert set(want) == {"fit_loss", "mse_loss"}
    assert_loss_dicts(got, want)


def test_loss_matches_jax_with_the_flow_prior(pair_gen):
    """``gen=True``: the JAX loss draws the part code itself. The draw is
    recovered from ``AnchorDiffAE.encode`` under the same rngs (latents[0]
    against the posterior means and log-variances), injected into the port as
    ``part_code_eps``, and the whole loss dict (prior loss, per-part
    log-densities and entropies, fit and mse losses) must then reproduce:
    1e-4 relative (the draw goes through a division in f32)."""
    jmodel, variables, pmodel = pair_gen
    batch = make_batch(2)

    def part_code_and_stats(m, b):
        from difffacto_tpu.models.anchor_diff import ensure_attn_maps as jax_maps

        b = jax_maps(b)
        latents = m.encode(b, epoch=0, train=True)[5]
        means, logvars = m.encoder_mod.get_part_code(b["input"], b["ref_attn_map"], train=True)
        return latents[0], means, logvars

    (code, means, logvars), _ = jmodel.apply(variables, jb(batch), method=part_code_and_stats,
                                             rngs=RNGS, mutable=["batch_stats"])
    eps = (np.asarray(code) - np.asarray(means)) / np.exp(0.5 * np.asarray(logvars))
    assert 0.5 < eps.std() < 1.5  # a standard normal draw
    want, _ = jmodel.apply(variables, jb(batch), 0, True, method=JaxAnchorDiffAE.loss, rngs=RNGS,
                           mutable=["batch_stats"])
    stats = [b.clone() for b in pmodel.buffers()]
    got = pmodel.loss(ensure_attn_maps(tb(dict(batch, part_code_eps=eps))), 0, True)
    for b, old in zip(pmodel.buffers(), stats):
        b.copy_(old)
    assert "prior_loss" in want and float(want["prior_loss"]) != 0.0
    assert_loss_dicts(got, want)


def test_select_best_noise_matches_jax(pair_stage1):
    """The CIMLE best-of-N selection with JAX's own candidates injected into
    the port: the same winners and selected noises."""
    jmodel, variables, pmodel = pair_stage1
    batch = make_batch(3)
    cand, best, selected = jax_select_best_noise(jmodel, variables, jax.random.PRNGKey(4),
                                                 jb(batch), num=6)
    noise = torch.as_tensor(np.asarray(cand)).reshape(B * 6, -1)
    got_cand, got_best, got_sel = select_best_noise(pmodel, tb(batch), num=6, noise=noise)
    assert got_cand.shape == (B, 6, 32)
    np.testing.assert_array_equal(t2n(got_best), np.asarray(best))
    np.testing.assert_array_equal(t2n(got_sel), np.asarray(selected))
    drawn = select_best_noise(pmodel, tb(batch), num=6, generator=torch.Generator().manual_seed(0))
    assert drawn[0].shape == (B, 6, 32) and drawn[2].shape == (B, 32)


def param_report(pmodel, jparams, jstats):
    """Largest and mean absolute difference of the parameters in units of lr,
    the share of entries more than 0.02 lr apart, and the largest difference
    of a BatchNorm buffer relative to its largest entry."""
    want = flatten_jax_tree(jparams)
    diffs = np.concatenate([np.abs(t2n(p) - want[n]).ravel() for n, p in pmodel.named_parameters()])
    wstats = flatten_jax_tree(jstats)
    bn = max(np.abs(b.numpy() - wstats[n]).max() / np.abs(wstats[n]).max()
             for n, b in pmodel.named_buffers())
    return diffs.max() / LR, diffs.mean() / LR, (diffs > 0.02 * LR).mean(), bn


# per step: (rtol of the metrics, mean parameter difference in lr, share of
# entries over 0.02 lr, relative difference of the BatchNorm buffers)
LADDER = ((1e-3, 0.002, 0.01, 1e-4), (5e-3, 0.01, 0.06, 2e-2), (3e-2, 0.05, 0.3, 0.2))


@pytest.mark.parametrize("filtered", [False, True], ids=["all", "aligner-only"])
def test_five_coupled_steps_match_jax(filtered):
    """Five steps of ``make_train_step`` against the JAX step from the same
    state and batches, the clip active (gradient norm over 100 against
    ``max_norm`` 10) and the schedule moving from step 1, once with every
    parameter trainable and once with the aligner filter.

    Both sides are float32, so the coupled map is followed only as far as it
    is stable: Adam's first updates are lr * g / (|g| + eps), whose sign at a
    near-zero gradient is set by rounding (2 lr apart after one flip), and
    train-mode BatchNorm over 4 shapes amplifies that from step to step; the
    JAX package's own coupled test runs in float64 for this reason. Steps 0 to
    2 are held hard on a ladder (``LADDER``), each rung about 5 times what
    this test measured: at step 0 the loss dict and grad_norm to 1e-3, the
    mean parameter difference under 0.002 lr (measured 0.0002 lr), at most 1 %
    of the entries more than 0.02 lr apart, BatchNorm buffers to 1e-4. A wrong
    clip, schedule, filter or moment moves every entry by the order of lr from
    step 0 or 1 on. Steps 3 and 4 only have to stay finite and within 20 % in
    loss."""
    jmodel, variables, pmodel = build_pair(gen=False)
    filt = (lambda path: "aligner" in path) if filtered else None
    jtx = jax_build_optimizer(OPT, SCHED, iters_per_epoch=1, max_norm=10.0)
    jstep = jax_make_train_step(jmodel, jtx, trainable_filter=filt, donate=False)
    jstate = JaxTrainState.create(variables, jtx)
    tx = build_optimizer_from_cfg(OPT, SCHED, iters_per_epoch=1, max_norm=10.0)
    state = init_train_state(pmodel, tx)
    step = make_train_step(pmodel, tx, trainable_filter=filt)
    p0 = {n: p.detach().clone() for n, p in pmodel.named_parameters()}
    for i in range(5):
        batch = make_batch(10 + i)
        jstate, jmet = jstep(jstate, jb(batch), jax.random.PRNGKey(i), 0)
        state, met = step(state, tb(batch), i, 0)
        jmet = {k: float(v) for k, v in jmet.items()}
        met = {k: float(v) for k, v in met.items()}
        assert set(met) == set(jmet) and met["skipped_nonfinite"] == 0.0
        assert jmet["grad_norm"] > 10.0  # the clip is active
        pmax, pmean, pshare, bn = param_report(pmodel, jstate.params, jstate.batch_stats)
        print(f"step {i}: loss {met['total_loss']:.5f} vs {jmet['total_loss']:.5f}, grad_norm "
              f"{met['grad_norm']:.4f} vs {jmet['grad_norm']:.4f}, parameters max {pmax:.3f} lr, "
              f"mean {pmean:.5f} lr, share over 0.02 lr {pshare:.5f}, BN buffers {bn:.2e}")
        if i <= 2:
            rtol, mean_tol, share_tol, bn_tol = LADDER[i]
            for k in jmet:
                np.testing.assert_allclose(met[k], jmet[k], rtol=rtol, atol=1e-5, err_msg=k)
            assert pmax <= 2.05 * (i + 1) and pmean <= mean_tol and pshare <= share_tol
            assert bn <= bn_tol
        else:
            assert all(np.isfinite(v) for v in met.values())
            np.testing.assert_allclose(met["total_loss"], jmet["total_loss"], rtol=0.2)
    assert state.step == 5 and float(state.opt_state["count"]) == 5
    moved = {n for n, p in pmodel.named_parameters() if not torch.equal(p, p0[n])}
    if filtered:
        assert moved and all("aligner" in n.split(".") for n in moved)
        frozen = [mu for n, mu in zip(p0, state.opt_state["mu"]) if n.startswith("net.blocks")]
        assert all(bool((mu != 0).any()) for mu in frozen)  # frozen moments still advance
    else:
        assert any(n.startswith("net.") for n in moved)


def snapshot(model, state):
    return ([p.detach().clone() for p in model.parameters()] + [b.clone() for b in model.buffers()]
            + [t.clone() for key in ("mu", "nu") for t in state.opt_state[key]]
            + [state.opt_state["count"].clone()])


@pytest.mark.parametrize("case", ["nan_batch", "skip_grad_norm"])
def test_guard_skips_the_whole_step(case):
    """A NaN in the batch, or a gradient norm over ``skip_grad_norm``: every
    parameter, Adam moment and BatchNorm buffer keeps its bits, ``step`` still
    advances, the optimizer's count does not, ``skipped_nonfinite`` reads 1 as
    the JAX step's does; a good step afterwards goes through."""
    jmodel, variables, pmodel = build_pair(gen=False)
    skip = 1e-3 if case == "skip_grad_norm" else None
    tx = build_optimizer_from_cfg(OPT, SCHED, iters_per_epoch=1, max_norm=10.0)
    step = make_train_step(pmodel, tx, skip_grad_norm=skip)
    state = init_train_state(pmodel, tx)
    if case == "nan_batch":  # one good step first, so the moments are not zero
        state, met = step(state, tb(make_batch(20)), 0, 0)
        assert float(met["skipped_nonfinite"]) == 0.0
    before, count = snapshot(pmodel, state), float(state.opt_state["count"])
    batch = make_batch(21, nan=(case == "nan_batch"))
    state, met = step(state, tb(batch), 1, 0)
    assert float(met["skipped_nonfinite"]) == 1.0
    assert all(torch.equal(a, b) for a, b in zip(before, snapshot(pmodel, state)))
    assert state.step == (2 if case == "nan_batch" else 1)
    assert float(state.opt_state["count"]) == count
    jtx = jax_build_optimizer(OPT, SCHED, iters_per_epoch=1, max_norm=10.0)
    jstep = jax_make_train_step(jmodel, jtx, donate=False, skip_grad_norm=skip)
    _, jmet = jstep(JaxTrainState.create(variables, jtx), jb(batch), jax.random.PRNGKey(1), 0)
    assert float(jmet["skipped_nonfinite"]) == 1.0
    if case == "nan_batch":
        state, met = step(state, tb(make_batch(22)), 2, 0)
        assert float(met["skipped_nonfinite"]) == 0.0 and float(state.opt_state["count"]) == 2


@pytest.mark.parametrize("variant", ["multi_hypothesis", "use_gt_params", "gt_params_in_training"])
def test_encoder_forward_variants_match_jax(variant):
    """``AnchorDiffAE.encode`` in eval mode: S = 3 CIMLE hypotheses per shape
    through a (B, S, noise_dim) noise, ``use_gt_params`` and
    ``use_gt_params_in_training``. ctx, per-point mean and log-variance, the
    presence flags and the fit loss: 1e-4."""
    def tweak(mcfg):
        mcfg = reduce(mcfg, gen=False)
        if variant == "use_gt_params":
            mcfg["encoder"]["use_gt_params"] = True
        if variant == "gt_params_in_training":
            mcfg["encoder"]["use_gt_params_in_training"] = True
        return mcfg

    jmodel = jax_build(tweak(JaxConfig(CONFIG).model.dump()), JAX_MODELS)
    batch = make_batch(30)
    if variant == "multi_hypothesis":
        batch["noise"] = np.random.RandomState(31).randn(B, 3, 32).astype(np.float32)
    variables = jax.jit(lambda r, b: jmodel.init(r, b, 0, method=JaxAnchorDiffAE.loss))(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)}, jb(make_batch(0)))
    variables = {"params": randomize(variables["params"], seed=5),
                 "batch_stats": variables["batch_stats"]}
    pmodel = build_from_cfg(tweak(Config(CONFIG).model.dump()), MODELS, device="cpu")
    load_jax_params(pmodel, variables["params"], variables["batch_stats"])

    from difffacto_tpu.models.anchor_diff import ensure_attn_maps as jax_maps

    want = jmodel.apply(variables, jax_maps(jb(batch)), method=JaxAnchorDiffAE.encode, rngs=RNGS)
    with torch.no_grad():
        got = pmodel.encode(ensure_attn_maps(tb(batch)))
    rows = B * 3 if variant == "multi_hypothesis" else B
    assert got[0].shape == (rows, 4, 262) and got[1].shape == (rows, N, 3)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_allclose(t2n(g), np.asarray(w), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(t2n(got[4]["fit_loss"]), np.asarray(want[4]["fit_loss"]),
                               rtol=1e-4, atol=1e-5)
