"""The port's editing (``difffacto_torch/runner/editing.py``) against the JAX
package's (``difffacto_tpu/runner/editing.py``), function by function.

The model pair of ``tests/test_torch_recon.py`` (the tiny gen_chair of
``tests/test_model.py``, 2 blocks, T = 5, 128 points, JAX weights bridged
into the port). Each JAX function splits its key as it does; the test draws
the same normals from those keys (the aligner noises, the flow's input, the
start of a noise optimisation, the permutation seeds) and hands them to the
port, and injects the part codes' posterior draws and the chain's draws on
both sides (``patch_part_code_draw``, ``patch_decode``). The noise
optimisations are held on a ladder of steps. Then ``--task mixing`` and
``--task interpolation`` through ``runner/cli.py:main`` write the keys the
JAX functions return (which ``tools/run_net.py`` writes), and
``tools/run_editing_torch.py`` runs every mode of ``tools/run_editing.py``.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import difffacto_tpu.models.anchor_diff as jad
import difffacto_tpu.runner.editing as jed
from test_torch_recon import (KC, ZDIM, build_pair, chain_draws, jb, make_batch, pb,
                              patch_decode, patch_part_code_draw)

from difffacto_torch.runner import editing as ped

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "tests", "configs", "tiny_gen.py")
TOL = dict(rtol=1e-4, atol=1e-4)  # f32, the same sums in another order


@pytest.fixture(scope="module")
def pair():
    return build_pair()


def jax_perm_seed(key):
    return int(jax.random.randint(key, (), 0, 2**31 - 1))


def normal(key, shape):
    return np.asarray(jax.random.normal(key, shape))


def assert_same_dict(got, want, tol=TOL):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, k
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, err_msg=k, **tol)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_combine_latent_matches_jax(pair, monkeypatch):
    """Random part mixing, K = 2 hypotheses a mix, part 3 absent in a row:
    the permutations from JAX's seed, the aligner noise from its key."""
    jm, variables, pm = pair
    B, K = 3, 2
    b = make_batch(B)
    key = jax.random.PRNGKey(21)
    _, k_perm, k_noise, _ = jax.random.split(key, 4)
    eps = np.random.RandomState(1).randn(B, KC, ZDIM).astype(np.float32)
    x_T, sn = chain_draws(B * K, 2)
    patch_part_code_draw(monkeypatch, eps)
    patch_decode(monkeypatch, x_T, sn)
    want = jed.combine_latent(jm, variables, key, jb(b), K=K)
    got = ped.combine_latent(pm, pb(b), K=K, part_code_eps=eps, perm_seed=jax_perm_seed(k_perm),
                             cimle_noise=normal(k_noise, (B * K, 32)), x_T=x_T, step_noise=sn)
    assert_same_dict(got, want)


def test_combine_latent_specific_matches_jax(pair, monkeypatch):
    """Explicit per-part clouds, part 3 absent (all zeros), K = 2."""
    jm, variables, pm = pair
    K = 2
    rng = np.random.RandomState(3)
    parts = [(rng.randn(16, 3) * 0.2).astype(np.float32) for _ in range(KC)]
    parts[3] = np.zeros((16, 3), np.float32)
    key = jax.random.PRNGKey(22)
    k_noise, _ = jax.random.split(key)
    x_T, sn = chain_draws(K, 4)
    patch_decode(monkeypatch, x_T, sn)
    want = jed.combine_latent_specific(jm, variables, key, parts, K=K)
    got = ped.combine_latent_specific(pm, parts, K=K, cimle_noise=normal(k_noise, (K, 32)),
                                      x_T=x_T, step_noise=sn)
    assert_same_dict(got, want)


def test_interpolate_latent_matches_jax(pair, monkeypatch):
    """Part 1 moved toward a permuted partner's in 2 steps; the keys and the
    layout (B, mid, N, 3) of the JAX function."""
    jm, variables, pm = pair
    B, mid = 3, 2
    b = make_batch(B, seed=5)
    key = jax.random.PRNGKey(23)
    _, k_perm, k_noise, _ = jax.random.split(key, 4)
    eps = np.random.RandomState(6).randn(B, KC, ZDIM).astype(np.float32)
    x_T, sn = chain_draws(B * mid, 7)
    patch_part_code_draw(monkeypatch, eps)
    patch_decode(monkeypatch, x_T, sn)
    want = jed.interpolate_latent(jm, variables, key, jb(b), part_id=1, mid_num=mid)
    got = ped.interpolate_latent(pm, pb(b), part_id=1, mid_num=mid, part_code_eps=eps,
                                 perm_seed=jax_perm_seed(k_perm),
                                 cimle_noise=normal(k_noise, (B, 32)), x_T=x_T, step_noise=sn)
    assert_same_dict(got, want)
    assert not np.allclose(got["interpolate sample 0"], got["interpolate sample 1"])


def test_interpolate_two_shapes_matches_jax(pair, monkeypatch):
    """Part 1 between two explicit shapes (two posterior draws, in order)."""
    jm, variables, pm = pair
    B, mid = 2, 3
    b1, b2 = make_batch(B, seed=8), make_batch(B, seed=9)
    key = jax.random.PRNGKey(24)
    _, _, k_noise, _ = jax.random.split(key, 4)
    rng = np.random.RandomState(10)
    eps1, eps2 = (rng.randn(B, KC, ZDIM).astype(np.float32) for _ in range(2))
    x_T, sn = chain_draws(B * mid, 11)
    patch_part_code_draw(monkeypatch, [eps1, eps2])
    patch_decode(monkeypatch, x_T, sn)
    want = jed.interpolate_two_shapes(jm, variables, key, b1["input"], b1["ref_seg_mask"],
                                      b2["input"], b2["ref_seg_mask"], part_id=1, mid_num=mid)
    got = ped.interpolate_two_shapes(pm, b1["input"], b1["ref_seg_mask"], b2["input"],
                                     b2["ref_seg_mask"], 1, mid, eps1=eps1, eps2=eps2,
                                     cimle_noise=normal(k_noise, (B, 32)), x_T=x_T, step_noise=sn)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), **TOL)
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))


def test_select_best_noise_whole_matches_jax(pair, monkeypatch):
    """Every one of 2 candidate noises decoded, the best by world-space
    Chamfer to the shape: the candidates injected on both sides."""
    jm, variables, pm = pair
    B, num = 3, 2
    b = make_batch(B, seed=12)
    rng = np.random.RandomState(13)
    cand = rng.randn(B, num, 32).astype(np.float32)
    eps = rng.randn(B, KC, ZDIM).astype(np.float32)
    x_T, sn = chain_draws(B * num, 14)
    patch_part_code_draw(monkeypatch, eps)
    patch_decode(monkeypatch, x_T, sn)
    monkeypatch.setattr(jad, "select_best_noise",
                        lambda *a, **k: (jnp.asarray(cand), None, None))
    want = jed.select_best_noise_whole(jm, variables, jax.random.PRNGKey(25), jb(b), num=num)
    got = ped.select_best_noise_whole(pm, dict(pb(b), part_code_eps=torch.as_tensor(eps)),
                                      num=num, noise=cand.reshape(B * num, 32), x_T=x_T,
                                      step_noise=sn)
    np.testing.assert_array_equal(got[0].numpy(), cand)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_interpolate_params_matches_jax(pair, monkeypatch):
    """Part 1 stretched along x and z over K = cimle_sample_num = 2 steps."""
    jm, variables, pm = pair
    B, K = 3, jm.cimle_sample_num
    b = make_batch(B, seed=15)
    key = jax.random.PRNGKey(26)
    _, k_noise, _ = jax.random.split(key, 3)
    eps = np.random.RandomState(16).randn(B, KC, ZDIM).astype(np.float32)
    x_T, sn = chain_draws(B * K, 17)
    patch_part_code_draw(monkeypatch, eps)
    patch_decode(monkeypatch, x_T, sn)
    want = jed.interpolate_params(jm, variables, key, jb(b), part_id=1)
    got = ped.interpolate_params(pm, pb(b), part_id=1, part_code_eps=eps,
                                 cimle_noise=normal(k_noise, (B, 32)), x_T=x_T, step_noise=sn)
    assert_same_dict(got, want)


def _candidates(seed, B=3, C=6):
    rng = np.random.RandomState(seed)
    mean = (rng.randn(B, C, KC, 3) * 0.3).astype(np.float32)
    logvar = (rng.randn(B, C, KC, 3) * 0.3 - 2).astype(np.float32)
    valid = np.ones((B, KC), np.float32)
    valid[1, 2] = 0
    return mean, logvar, valid


def test_param_scores_and_greedy_select_match_jax():
    """The diversity score and the greedy farthest-score walk, host numpy
    both: equal."""
    mean, logvar, valid = _candidates(30)
    draws = np.random.RandomState(31).standard_normal((6, 512, KC, 3))
    want = jed._param_scores(mean[1].astype(np.float64), logvar[1].astype(np.float64),
                             valid[1], draws)
    got = ped._param_scores(mean[1].astype(np.float64), logvar[1].astype(np.float64),
                            valid[1], draws)
    np.testing.assert_array_equal(got, want)
    assert ped._greedy_select(got, valid[1], 4) == jed._greedy_select(mean[1], want, valid[1], 4)


def test_subsample_params_matches_jax():
    """Per-row and across-row diverse selection with the default draws."""
    mean, logvar, valid = _candidates(32)
    (gm, gv), gid = ped.subsample_params(mean, logvar, valid, 3, return_ids=True)
    (wm, wv), wid = jed.subsample_params(mean, logvar, valid, 3, return_ids=True)
    np.testing.assert_array_equal(gid, wid)
    np.testing.assert_array_equal(gm, wm)
    np.testing.assert_array_equal(gv, wv)
    with pytest.raises(ValueError):
        ped.subsample_params(mean, logvar, valid, 7)
    (gm, gv), gsel = ped.subsample_params_global(mean[:, 0], logvar[:, 0], valid, 2)
    (wm, wv), wsel = jed.subsample_params_global(mean[:, 0], logvar[:, 0], valid, 2)
    np.testing.assert_array_equal(gsel, wsel)
    np.testing.assert_array_equal(gm, wm)


@pytest.mark.parametrize("fix_size, selective, E, P", [(True, False, 2, 1), (False, True, 1, 2),
                                                        (False, False, 1, 2)])
def test_sample_one_part_matches_jax(pair, monkeypatch, fix_size, selective, E, P):
    """Part 1 resampled from the flow prior for S = 3 shapes, E variants
    each, an aligner search over 5 noises a variant (the rows in (shape,
    variant, noise) order, as the JAX function lays them); the best fit, or
    P parameter sets by the greedy-diverse choice or the first P."""
    jm, variables, pm = pair
    S, Kn = 3, 5
    rng = np.random.RandomState(33)
    codes = rng.randn(S, KC, ZDIM).astype(np.float32)
    valid = np.array([[1, 1, 1, 1], [1, 1, 0, 1], [0, 1, 1, 1]], np.float32)
    gt_mean = (rng.randn(S, KC, 3) * 0.1).astype(np.float32)
    gt_logvar = (rng.randn(S, KC, 3) * 0.1).astype(np.float32)
    seg = make_batch(S)["ref_seg_mask"]
    key = jax.random.PRNGKey(27)
    k_w, k_noise, _ = jax.random.split(key, 3)
    x_T, sn = chain_draws(S * E * P, 34)
    patch_decode(monkeypatch, x_T, sn)
    kw = dict(part_id=1, sample_num_each=E, noise_search=Kn, fix_size=fix_size,
              param_sample_num=P, selective=selective)
    want = jed.sample_one_part(jm, variables, key, codes, valid, gt_mean, gt_logvar, seg, **kw)
    got = ped.sample_one_part(pm, codes, valid, gt_mean, gt_logvar, seg, **kw,
                              w=normal(k_w, (S * E, KC, ZDIM)),
                              search_noise=normal(k_noise, (S * E * Kn, 32)), x_T=x_T,
                              step_noise=sn)
    assert_same_dict(got, want)
    np.testing.assert_array_equal(got["codes"][:, :, 0], np.repeat(codes[:, None, 0], E * P, 1))


# The ladders: float32 Adam from the same z0 on both sides. The first steps
# agree to rounding; Adam divides each gradient by its own running scale, so
# a rounding difference in a small gradient component moves its update by a
# share of lr, and the two runs drift apart slowly: the bound widens with the
# steps.
LADDER = ((1, 1e-5), (10, 1e-4), (100, 1e-3))


def test_adam_makes_optax_adams_updates():
    """``torch.optim.Adam`` as the editing functions build it, against
    ``optax.adam`` on the same 100 gradients of scales 1e-6 to 10: the same
    iterates within f32 rounding, 5e-5 absolute over 100 steps of lr 0.1
    (measured 1.5e-5; optax adds eps to the bias-corrected root, as torch
    does, where eps inside the root would move the small-gradient columns by
    their whole step)."""
    import optax

    rng = np.random.RandomState(40)
    grads = (rng.randn(100, 3, 32) * np.logspace(-6, 1, 32)).astype(np.float32)
    z0 = rng.randn(3, 32).astype(np.float32)
    tx = optax.adam(0.1)
    zj, st = jnp.asarray(z0), tx.init(jnp.asarray(z0))
    zp = torch.as_tensor(z0).clone()
    opt = ped._adam(zp, 0.1)
    for g in grads:
        u, st = tx.update(jnp.asarray(g), st)
        zj = optax.apply_updates(zj, u)
        zp.grad = torch.as_tensor(g)
        opt.step()
    np.testing.assert_allclose(zp.numpy(), np.asarray(zj), rtol=0, atol=5e-5)


def test_optimize_noise_matches_jax_on_a_ladder(pair, monkeypatch):
    """Adam on the CIMLE noise: the loss at every step's start and z after
    1, 10 and 100 steps, within the ladder's bounds (relative to z's scale);
    the loss falls. At lr 0.02 the loss descends for all 100 steps. At the
    JAX default of 1.0, or 0.1, it reaches its floor within them, where
    Adam's steps oscillate and a rounding in a gradient near zero flips its
    sign: the runs part (0.15 in z after 100 steps at lr 0.1) while the
    gradients at the same z still agree to 2e-6 (``test_recon_losses_match_jax``
    holds them)."""
    jm, variables, pm = pair
    b = make_batch(3, seed=35)
    key = jax.random.PRNGKey(28)
    eps = np.random.RandomState(36).randn(3, KC, ZDIM).astype(np.float32)
    patch_part_code_draw(monkeypatch, eps)
    z0 = normal(key, (3, 32))
    wz, wh = jed.optimize_noise(jm, variables, key, jb(b), steps=100, lr=0.02)
    for steps, tol in LADDER:
        gz, gh = ped.optimize_noise(pm, pb(b), steps=steps, lr=0.02, z0=z0, part_code_eps=eps)
        np.testing.assert_allclose(gh, wh[:steps], rtol=tol, err_msg=f"losses over {steps} steps")
    scale = np.abs(np.asarray(wz)).max()
    np.testing.assert_allclose(gz.numpy(), np.asarray(wz), rtol=0, atol=1e-3 * scale)
    assert gh[-1] < 0.1 * gh[0]


def test_shape_edit_matches_jax_on_a_ladder(pair, monkeypatch):
    """Adam on the aligner noise toward part 1's target mean: z, the last
    loss and the decoded shape after 1, 10 and 100 steps, within the
    ladder's bounds, at lr 0.02 for the reason ``optimize_noise``'s ladder
    gives (at the JAX default of 0.1 the runs part by 0.19 in z after 100
    steps, past the loss's floor)."""
    jm, variables, pm = pair
    B = 3
    b = make_batch(B, seed=37)
    key = jax.random.PRNGKey(29)
    k_z, _ = jax.random.split(key)
    target = np.tile(np.array([[0.5, 0.0, 0.0]], np.float32), (B, 1))
    x_T, sn = chain_draws(B, 38)
    patch_decode(monkeypatch, x_T, sn)
    for steps, tol in LADDER:
        want = jed.shape_edit(jm, variables, key, jb(b), 1, edit_part_mean=jnp.asarray(target),
                              steps=steps, lr=0.02)
        got = ped.shape_edit(pm, pb(b), 1, edit_part_mean=target, steps=steps, lr=0.02,
                             z0=normal(k_z, (B, 32)), x_T=x_T, step_noise=sn)
        scale = np.abs(want["z"]).max()
        np.testing.assert_allclose(got["z"], want["z"], rtol=0, atol=tol * scale,
                                   err_msg=f"z after {steps} steps")
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=tol)
        np.testing.assert_allclose(got["pred"], want["pred"], rtol=10 * tol, atol=10 * tol)


# ------------------------------------------------------------ entry points
@pytest.fixture(scope="module")
def jax_keys(pair):
    """The keys of what the JAX functions return (and ``tools/run_net.py``'s
    ``run_mixing`` and ``run_interpolation`` write) for the tiny config's
    model: one CIMLE hypothesis, 10 interpolation steps. The keys do not
    depend on the chain's values: its decode returns the anchors."""
    jm, variables, _ = pair
    jm = jm.clone(cimle_sample_num=1)
    b = jb(make_batch(2))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jed, "decode", lambda m, v, r, anchors, **kw: {"pred": anchors})
        mixing = jed.combine_latent(jm, variables, jax.random.PRNGKey(0), b)
        interp = jed.interpolate_latent(jm, variables, jax.random.PRNGKey(0), b, part_id=0)
    return {"mixing": sorted(mixing), "interpolation": sorted(interp)}


@pytest.mark.parametrize("task", ["mixing", "interpolation"])
def test_cli_editing_tasks_write_the_jax_keys(task, jax_keys, tmp_path, monkeypatch):
    """``runner/cli.py:main`` (what ``tools/run_net_torch.py`` runs) with
    ``--task mixing`` or ``--task interpolation --interpolation_dir`` on the
    CPU writes one ``.npz`` with the JAX functions' keys, finite."""
    from difffacto_torch.runner.cli import main

    monkeypatch.chdir(tmp_path)
    argv = ["--config-file", TINY, "--task", task, "--cpu", "--prefix", task]
    if task == "interpolation":
        argv += ["--interpolation_dir", str(tmp_path / "interp")]
        path = tmp_path / "interp" / "interpolation.npz"
    else:
        path = tmp_path / "work_dirs" / "tiny_gen_mixing" / "mixing" / "mixing.npz"
    main(argv)
    saved = np.load(path)
    assert sorted(saved.files) == jax_keys[task]
    assert all(np.isfinite(saved[k]).all() for k in saved.files)


@pytest.mark.parametrize("mode", ["mixing", "interpolation", "interpolate_params",
                                  "sample_one_part", "optimize_noise", "shape_edit"])
def test_run_editing_torch_runs_every_mode(mode, tmp_path, monkeypatch):
    """``tools/run_editing_torch.py --mode <mode> --cpu`` on the tiny config
    writes ``<work_dir>/<mode>/<mode>.npz``, finite (5 optimisation steps)."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import run_editing_torch

    monkeypatch.chdir(tmp_path)
    out = run_editing_torch.main(["--config-file", TINY, "--mode", mode, "--cpu",
                                  "--steps", "5", "--sample_num_each", "2"])
    saved = np.load(tmp_path / "work_dirs" / "tiny_gen" / mode / f"{mode}.npz")
    assert sorted(saved.files) == sorted(out) and saved.files
    assert all(np.isfinite(saved[k]).all() for k in saved.files)
