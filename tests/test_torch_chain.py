"""The whole reverse chain and the training loss of the port against the JAX package.

``AnchoredDiffusion`` with every option the JAX dataclass takes: the DDIM
step subsets and direction coefficients (bit for bit), one step
(``p_mean_variance``, ``p_sample``) for every mean type and variance type,
with and without DDIM and guidance, the whole DDIM chain with its
trajectory, and ``training_losses`` with the variational-bound term. The
denoiser is a stub ``model_fn`` of seeded weights, the same on both sides;
every draw is injected. Then the slice as a whole: ``sample_generation`` on
``tests/configs/tiny_gen.py`` with DDIM. float32 on the CPU; the tolerance
is stated at each test.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import difffacto_tpu.models.diffusion as jdiff
from difffacto_tpu.config import Config as JaxConfig
from difffacto_tpu.models.anchor_diff import AnchorDiffAE as JaxAnchorDiffAE
from difffacto_tpu.models.anchor_diff import _model_fn, build_diffusion
from difffacto_tpu.ops import schedule as jsched
from test_torch_generation import randomize, t2n

from difffacto_torch import Config, MODELS, build_from_cfg, load_jax_params, sample_generation
from difffacto_torch.models import diffusion as pdiff
from difffacto_torch.ops import schedule as psched

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "tests", "configs", "tiny_gen.py")
T, B, N, H = 100, 2, 64, 16
MEAN_TYPES = pdiff.MEAN_TYPES
VAR_TYPES = ("fixed_small", "fixed_large", "learned", "learned_range")


# ------------------------------------------------------------ schedule tables
@pytest.mark.parametrize("discretize", ["uniform", "quad"])
@pytest.mark.parametrize("T_, nsteps", [(100, 25), (100, 10), (5, 3)])
def test_ddim_tables_equal_jax_bit_for_bit(discretize, T_, nsteps):
    """The step subset and sqrt(1 - a_bar - eta^2 var) as float32, at eta 1
    and 0, from the port's helpers and from a constructed diffusion."""
    steps = psched.ddim_steps(T_, nsteps, discretize)
    np.testing.assert_array_equal(steps, jsched.ddim_steps(T_, nsteps, discretize))
    assert steps.dtype == np.int32
    if (T_, nsteps, discretize) == (100, 25, "quad"):
        assert steps[:4].tolist() == [0, 0, 0, 1] and steps[-3:].tolist() == [67, 73, 80]
    betas = psched.make_beta_schedule(T_, 1e-4, 0.02)
    for eta in (1.0, 0.0):
        np.testing.assert_array_equal(
            psched.ddim_xt_dir_coeff(betas, eta).astype(np.float32),
            np.asarray(jnp.asarray(jsched.ddim_xt_dir_coeff(betas, eta), jnp.float32)))
        kw = dict(ddim_sampling=True, ddim_nsteps=nsteps, ddim_discretize=discretize,
                  ddim_eta=eta)
        pd, jd = pdiff.AnchoredDiffusion(T_, 1e-4, 0.02, **kw), jdiff.AnchoredDiffusion(
            T_, 1e-4, 0.02, **kw)
        np.testing.assert_array_equal(pd.steps, np.asarray(jd.steps))
        np.testing.assert_array_equal(pd.xt_dir_coeff.numpy(), np.asarray(jd.xt_dir_coeff))


# ---------------------------------------------------------------- the stub
def stub_weights(in_ch, out_ch, ctx_ch, seed):
    rng = np.random.RandomState(seed)
    return dict(w1=rng.randn(in_ch, H).astype(np.float32) / math.sqrt(in_ch),
                wt=rng.randn(H).astype(np.float32),
                wc=rng.randn(ctx_ch, H).astype(np.float32) / math.sqrt(ctx_ch),
                w2=rng.randn(H, out_ch).astype(np.float32) * 0.3)


def stub(lib, w):
    """model_fn(inp, ts, ctx, ...): tanh(inp W1 + ts wt + mean_k(ctx) Wc) W2,
    in jnp or torch; a list or tuple ctx is concatenated on its last axis."""
    cat = jnp.concatenate if lib is jnp else torch.cat

    def fn(inp, ts, ctx, anchors, variance, seg_mask, valid_id):
        if isinstance(ctx, (list, tuple)):
            ctx = cat(list(ctx), -1)
        h = inp @ w["w1"] + ts[:, None, None] * w["wt"] + (ctx.mean(1) @ w["wc"])[:, None]
        return lib.tanh(h) @ w["w2"]

    return fn


def out_channels(mean_type, var_type):
    c = 6 if mean_type == "epsilon_and_anchor" else 3
    return 2 * c if var_type in ("learned", "learned_range") else c


def step_inputs(seed, ctx_ch=5):
    """x (4 x a normal, so that clip_xstart clips some), t (with a 0),
    anchors, per-point variance, ctx (B, 4, ctx_ch) and the step's draw."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    return dict(x=4 * f(B, N, 3), t=np.array([0, 57], np.int64), anchors=0.5 * f(B, N, 3),
                variance=np.exp(0.3 * f(B, N, 3)).astype(np.float32), ctx=f(B, 4, ctx_ch),
                noise=f(B, N, 3))


def pair(mean_type, var_type, **kw):
    cfg = dict(model_mean_type=mean_type, model_var_type=var_type, learn_variance=True,
               clip_xstart=True, **kw)
    return pdiff.AnchoredDiffusion(T, 1e-4, 0.02, **cfg), jdiff.AnchoredDiffusion(
        T, 1e-4, 0.02, **cfg)


def torchify(d):
    return {k: torch.as_tensor(v) for k, v in d.items()}


def jaxify(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


# ------------------------------------------------------------------ one step
@pytest.mark.parametrize("var_type", VAR_TYPES)
@pytest.mark.parametrize("mean_type", MEAN_TYPES)
def test_one_step_matches_jax(mean_type, var_type):
    """``p_mean_variance`` (every key) and ``p_sample`` with and without DDIM
    (25 quad steps, eta 1) and guidance (weight 2), through the stub. A
    combination the JAX package cannot run raises in the port too.
    Tolerance rtol = atol = 1e-5."""
    w = stub_weights(6, out_channels(mean_type, var_type), 5, seed=1)
    inp = step_inputs(2)
    for ddim in (False, True):
        for guidance in (False, True):
            kw = dict(guidance=guidance, classifier_weight=2.0, ddim_sampling=ddim,
                      ddim_nsteps=25, ddim_discretize="quad")
            pd, jd = pair(mean_type, var_type, **kw)
            j, p = jaxify(inp), torchify(inp)
            args = lambda d: (d["x"], d["t"], d["anchors"], d["ctx"], d["variance"], None, None)
            try:
                want = jd.p_mean_variance(stub(jnp, jaxify(w)), *args(j))
                want_s = jd.p_sample(stub(jnp, jaxify(w)), None, *args(j), noise=j["noise"])
            except (TypeError, ValueError, NotImplementedError):
                with pytest.raises((RuntimeError, NotImplementedError)):
                    pd.p_mean_variance(stub(torch, torchify(w)), *args(p))
                    pd.p_sample(stub(torch, torchify(w)), *args(p), noise=p["noise"])
                continue
            got = pd.p_mean_variance(stub(torch, torchify(w)), *args(p))
            got_s = pd.p_sample(stub(torch, torchify(w)), *args(p), noise=p["noise"])
            assert set(got) == set(want)
            for k in want:
                if want[k] is None:
                    assert got[k] is None, k
                    continue
                np.testing.assert_allclose(t2n(got[k]), np.asarray(want[k]), rtol=1e-5,
                                           atol=1e-5, err_msg=f"{k} ddim={ddim} guid={guidance}")
            for k in ("sample", "pred_xstart"):
                np.testing.assert_allclose(t2n(got_s[k]), np.asarray(want_s[k]), rtol=1e-5,
                                           atol=1e-5, err_msg=f"{k} ddim={ddim} guid={guidance}")


def test_guidance_zeroes_every_leaf_of_a_list_ctx():
    """Guidance's second call sees every leaf of a tuple ctx zeroed, as
    ``jax.tree_util.tree_map(jnp.zeros_like, ctx)`` makes it."""
    w = stub_weights(6, 3, 5, seed=3)
    inp = step_inputs(4)
    ctx = (inp["ctx"][..., :2], inp["ctx"][..., 2:])
    pd, jd = pair("epsilon", "fixed_small", guidance=True, classifier_weight=3.0)
    args = lambda d, c: (d["x"], d["t"], d["anchors"], c, d["variance"])
    want = jd.p_mean_variance(stub(jnp, jaxify(w)), *args(jaxify(inp), tuple(map(jnp.asarray, ctx))))
    seen = []

    def spy(inp_, ts, c, *rest):
        seen.append(c)
        return stub(torch, torchify(w))(inp_, ts, c, *rest)

    got = pd.p_mean_variance(spy, *args(torchify(inp), tuple(map(torch.as_tensor, ctx))))
    assert isinstance(seen[1], tuple) and all(float(c.abs().max()) == 0.0 for c in seen[1])
    np.testing.assert_allclose(t2n(got["mean"]), np.asarray(want["mean"]), rtol=1e-5, atol=1e-5)


def test_ddim_prev_x_raises_where_jax_cannot_run():
    """DDIM with the prev_x mean has no direction term in either package."""
    pd, jd = pair("prev_x", "fixed_small", ddim_sampling=True, ddim_nsteps=10)
    w = stub_weights(6, 3, 5, seed=5)
    inp = step_inputs(6)
    with pytest.raises(TypeError):
        j = jaxify(inp)
        jd.p_sample(stub(jnp, jaxify(w)), None, j["x"], j["t"], j["anchors"], j["ctx"],
                    j["variance"], noise=j["noise"])
    p = torchify(inp)
    with pytest.raises(NotImplementedError, match="diffusion.py:267"):
        pd.p_sample(stub(torch, torchify(w)), p["x"], p["t"], p["anchors"], p["ctx"],
                    p["variance"], noise=p["noise"])


def test_q_posterior_variance_and_q_sample_loop_match_jax():
    """The posterior variance and its log scaled by the per-point variance;
    the forward chain at t = 1 .. T-1 on one draw. Tolerance 1e-5."""
    pd, jd = pair("epsilon", "fixed_small")
    inp = step_inputs(7)
    t = inp["t"]
    for g, w in zip(pd.q_posterior_variance(torch.as_tensor(t), torch.as_tensor(inp["variance"])),
                    jd.q_posterior_variance(jnp.asarray(t), jnp.asarray(inp["variance"]))):
        np.testing.assert_allclose(t2n(g), np.asarray(w), rtol=1e-5, atol=1e-5)
    want = jd.q_sample_loop(None, jnp.asarray(inp["x"]), jnp.asarray(inp["anchors"]),
                            jnp.asarray(inp["variance"]), noise=jnp.asarray(inp["noise"]))
    got = pd.q_sample_loop(torch.as_tensor(inp["x"]), torch.as_tensor(inp["anchors"]),
                           torch.as_tensor(inp["variance"]), noise=torch.as_tensor(inp["noise"]))
    assert got.shape == (T - 1, B, N, 3)
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------- the whole chain
@pytest.mark.parametrize("eta", [0.0, 1.0])
@pytest.mark.parametrize("discretize", ["uniform", "quad"])
def test_ddim_chain_matches_jax(discretize, eta):
    """``p_sample_loop`` over 25 DDIM steps of T = 100 with x_T and every
    step's draw injected, the trajectory of every 10th step kept (the quad
    subset's three runs of t = 0 each kept). Tolerance 1e-4."""
    pd, jd = pair("epsilon", "fixed_small", ddim_sampling=True, ddim_nsteps=25,
                  ddim_discretize=discretize, ddim_eta=eta)
    w = stub_weights(6, 3, 5, seed=8)
    inp = step_inputs(9)
    rng = np.random.RandomState(10)
    step_noise = rng.randn(25, B, N, 3).astype(np.float32)
    x_T = rng.randn(B, N, 3).astype(np.float32)
    j = jaxify(inp)
    want = jd.p_sample_loop(stub(jnp, jaxify(w)), jax.random.PRNGKey(0), j["anchors"],
                            ctx=j["ctx"], variance=j["variance"], noise=jnp.asarray(x_T),
                            ret_traj=True, ret_interval=10, step_noise=jnp.asarray(step_noise))
    p = torchify(inp)
    got = pd.p_sample_loop(stub(torch, torchify(w)), p["anchors"], ctx=p["ctx"],
                           variance=p["variance"], noise=torch.as_tensor(x_T), ret_traj=True,
                           ret_interval=10, step_noise=torch.as_tensor(step_noise))
    np.testing.assert_array_equal(got["traj_t"], want["traj_t"])
    if discretize == "quad":
        assert got["traj_t"].tolist()[-3:] == [0, 0, 0]
    for k in ("pred", "traj"):
        np.testing.assert_allclose(t2n(got[k]), np.asarray(want[k]), rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="step_noise"):
        pd.p_sample_loop(stub(torch, torchify(w)), p["anchors"], ctx=p["ctx"],
                         variance=p["variance"], step_noise=torch.zeros(T, B, N, 3))


# ------------------------------------------------------------------- losses
@pytest.mark.parametrize("var_type", ["fixed_small", "learned", "learned_range"])
@pytest.mark.parametrize("mean_type", MEAN_TYPES)
def test_training_losses_match_jax(mean_type, var_type):
    """``training_losses`` of every mean type, the learned variances with
    their vb term (t = 0 takes the NLL, t > 0 the KL), with and without
    ``flags`` (a dropped part's points), and the gradients of the summed
    losses in the stub's weights. prev_x has no target in either package.
    Tolerance 1e-5 for the losses, 1e-4 for the gradients."""
    w = stub_weights(6, out_channels(mean_type, var_type), 5, seed=11)
    rng = np.random.RandomState(12)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    data = dict(x0=f(3, N, 3), anchors=0.5 * f(3, N, 3),
                variance=np.exp(0.3 * f(3, N, 3)).astype(np.float32), ctx=f(3, 4, 5),
                noise=f(3, N, 3), t=np.array([0, 37, 99], np.int64),
                flags=(rng.rand(3, N) > 0.25).astype(np.float32))
    pd, jd = pair(mean_type, var_type)
    for flags in (False, True):
        def jloss(jw):
            d = jaxify(data)
            return jd.training_losses(stub(jnp, jw), None, d["x0"], d["t"], d["anchors"],
                                      d["variance"], d["ctx"], flags=d["flags"] if flags else None,
                                      noise=d["noise"])

        if mean_type == "prev_x":
            with pytest.raises(KeyError):
                jloss(jaxify(w))
            with pytest.raises(NotImplementedError, match="diffusion.py:524-534"):
                ploss(pd, torchify(w), data, flags)
            return
        try:
            want = jloss(jaxify(w))
        except TypeError:  # epsilon_and_anchor's 6-wide log-variance against a 3-wide L
            with pytest.raises(RuntimeError):
                ploss(pd, torchify(w), data, flags)
            return
        want_g = jax.grad(lambda jw: sum(jnp.sum(v) for v in jloss(jw).values()))(jaxify(w))
        tw = {k: v.clone().requires_grad_(True) for k, v in torchify(w).items()}
        got = ploss(pd, tw, data, flags)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_allclose(t2n(got[k]), np.asarray(want[k]), rtol=1e-5, atol=1e-5,
                                       err_msg=f"{k} flags={flags}")
        grads = torch.autograd.grad(sum(v.sum() for v in got.values()), list(tw.values()))
        for (k, g) in zip(tw, grads):
            np.testing.assert_allclose(t2n(g), np.asarray(want_g[k]), rtol=1e-4, atol=1e-4,
                                       err_msg=f"d{k} flags={flags}")


def ploss(pd, tw, data, flags):
    d = torchify(data)
    return pd.training_losses(stub(torch, tw), d["x0"], d["t"], d["anchors"], d["variance"],
                              d["ctx"], flags=d["flags"] if flags else None, noise=d["noise"])


def test_any_loss_type_computes_the_mse():
    """``loss_type`` is read nowhere in the JAX package: any value gives the
    mse loss."""
    pd = pdiff.AnchoredDiffusion(T, 1e-4, 0.02, loss_type="kl")
    ref = pdiff.AnchoredDiffusion(T, 1e-4, 0.02)
    w = torchify(stub_weights(6, 3, 5, seed=13))
    d = torchify(step_inputs(14))
    a, b = (m.training_losses(stub(torch, w), d["x"], d["t"], d["anchors"], ctx=d["ctx"],
                              noise=d["noise"]) for m in (pd, ref))
    assert list(a) == ["mse_loss"] and torch.equal(a["mse_loss"], b["mse_loss"])


# ------------------------------------------------------ the slice as a whole
def test_ddim_sample_generation_matches_jax(monkeypatch):
    """``sample_generation`` on tiny_gen with DDIM (3 quad steps of T = 5:
    t = 4, 1, 0), the flow input, the CIMLE noise, x_T and every step's draw
    injected, against the JAX pieces composed the same way. Tolerance 1e-4."""
    monkeypatch.setenv("DIFFFACTO_PALLAS_INTERPRET", "1")
    ddim = dict(ddim_sampling=True, ddim_nsteps=3, ddim_discretize="quad", ddim_eta=1.0)
    jcfg = JaxConfig(TINY).model.dump()
    jcfg["diffusion"].update(ddim)
    from difffacto_tpu.utils.registry import MODELS as JAX_MODELS
    from difffacto_tpu.utils.registry import build_from_cfg as jax_build
    from __graft_entry__ import _example_batch

    jmodel = jax_build(jcfg, JAX_MODELS)
    variables = jax.jit(lambda r, b: jmodel.init(r, b, 0, method=JaxAnchorDiffAE.loss))(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)}, _example_batch(B=2, npoints=64))
    params = randomize(variables["params"], seed=15)
    variables = dict(variables, params=params)
    pcfg = Config(TINY).model.dump()
    pcfg["diffusion"].update(ddim)
    pmodel = build_from_cfg(pcfg, MODELS, device="cpu")
    load_jax_params(pmodel, params, variables.get("batch_stats"))
    assert pmodel.diff.steps.tolist() == [0, 1, 4]

    rng = np.random.RandomState(16)
    valid = np.array([[1, 1, 1, 1], [1, 0, 1, 1]], np.float32)
    z = rng.randn(2, 4, 16).astype(np.float32)
    cimle = rng.randn(2, 32).astype(np.float32)
    x_T = rng.randn(2, 64, 3).astype(np.float32)
    step_noise = rng.randn(3, 2, 64, 3).astype(np.float32)

    def prepare(m, z, valid, noise):
        enc = m.encoder_mod
        pc = enc.flow(z * math.sqrt(enc.prior_var), reverse=True)
        mean, logvar = enc.get_params_from_part_code(pc, valid, noise=noise)
        return pc, mean, logvar

    pc, mean, logvar = jmodel.apply(variables, jnp.asarray(z), jnp.asarray(valid),
                                    jnp.asarray(cimle), method=prepare)
    enc_ctx = jnp.concatenate([pc, mean, jnp.exp(logvar)], -1)
    seg = np.repeat(np.arange(4), 16)[None].repeat(2, 0).astype(np.int32)
    seg[1][seg[1] == 1] = 0
    take = lambda a: np.asarray(a)[np.arange(2)[:, None], seg]
    diff = build_diffusion(jmodel.diffusion, jmodel.num_timesteps)
    want = diff.p_sample_loop(
        _model_fn(jmodel, variables), jax.random.PRNGKey(0), jnp.asarray(take(mean)),
        ctx=enc_ctx, variance=jnp.asarray(take(np.exp(np.asarray(logvar)))),
        seg_mask=jnp.asarray(seg), valid_id=jnp.asarray(valid), noise=jnp.asarray(x_T),
        step_noise=jnp.asarray(step_noise))["pred"]
    out = sample_generation(pmodel, 2, valid_id=torch.as_tensor(valid), z=torch.as_tensor(z),
                            cimle_noise=torch.as_tensor(cimle), noise=torch.as_tensor(x_T),
                            step_noise=torch.as_tensor(step_noise))
    np.testing.assert_array_equal(t2n(out["seg_mask"]), seg)
    np.testing.assert_allclose(t2n(out["pred"]), np.asarray(want), rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------------ scorer
def test_checkpoint_curve_scorer_with_and_without_ddim(tmp_path, monkeypatch):
    """``tools/eval_ckpt_curve_torch.py --cpu`` over the two checkpoints a
    tiny_gen run writes: one JSON line each in epoch order with the 12
    metrics, the full chain (5 steps) and ``--ddim 3`` (3 steps), the
    ref-vs-ref block computed once for the runner's life."""
    import runpy

    import difffacto_torch.runner.evaluation as ev
    from difffacto_torch.runner.cli import main as cli

    monkeypatch.setenv("DIFFFACTO_EMD_ITERS", "16")
    cfg_file = tmp_path / "curve.py"
    cfg_file.write_text(f"_base_ = {TINY!r}\nwork_dir = {str(tmp_path / 'run')!r}\n"
                        "checkpoint_interval = 1\neval_interval = None\n")
    cli(["--config-file", str(cfg_file), "--task", "train", "--cpu", "--no_eval"])
    caches = []
    real = ev.compute_all_metrics
    monkeypatch.setattr(ev, "compute_all_metrics", lambda *a, **kw: (
        caches.append((id(kw["ref_self_cache"]), len(kw["ref_self_cache"]))), real(*a, **kw))[1])
    tool = runpy.run_path(os.path.join(ROOT, "tools", "eval_ckpt_curve_torch.py"),
                          run_name="imported")
    out = tmp_path / "curve.jsonl"
    for extra, steps in (([], 5), (["--ddim", "3"], 3)):
        caches.clear()
        rows = tool["main"](["--config-file", str(cfg_file), "--gen_num", "4", "--batch", "4",
                             "--cpu", "--out", str(out)] + extra)
        assert [r["ckpt"] for r in rows] == ["ckpt_1.pt", "ckpt_2.pt"]
        assert [r["epoch"] for r in rows] == [1, 2] and {r["steps"] for r in rows} == {steps}
        metrics = [{k: v for k, v in r.items() if k not in ("ckpt", "epoch", "steps", "eval_s")}
                   for r in rows]
        assert all(len(m) == 12 and np.isfinite(list(m.values())).all() for m in metrics)
        assert caches[0][0] == caches[1][0] and caches[0][1] == 0 < caches[1][1]
    assert len(out.read_text().splitlines()) == 4
