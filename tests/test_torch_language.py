"""The language family of the port against the JAX package, on the CPU.

``tokenizing``, the ``SyntheticLanguagePart`` items and batches (bit for
bit), the ``LSTM`` (its output at every step, padding included, the final
feature and the word attention, with and without dropout), the three fusers,
``ZeroMLP``, the two losses, ``AnchorDiffAE.language_train_step`` (losses and
gradients) and ``language_edit_latents``, and one ``LanguageRunner`` step
(losses and every parameter after it; every parameter outside the text
encoder and the update MLP bit for bit as before) are held against
``difffacto_tpu`` on the same weights: the JAX ``LanguageRunner``'s merged
tree, bridged with ``load_jax_params`` and read back from the ``.msgpack``
it writes. The JAX side's draws are replaced in the test by the port's
injected ones: the part codes' reparameterisation and the dropout keep
masks (``jax.random.bernoulli``, which flax's ``Dropout`` calls). Then
``--runner language`` runs one epoch through ``runner/cli.py:main``. Widths
are ``tests/configs/tiny_gen.py``'s with the JAX test's language data
(``tests/test_extra_runners.py``). Tolerance: 1e-5 for forwards, losses and
one step in f32; gradients at 2e-4 of each tensor's largest entry (or
2e-6 where that is below 1e-2: a bias before a BatchNorm has a gradient of
zero, which both sides compute as f32 rounding), as
``tests/test_torch_pretrain.py`` holds them.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import difffacto_tpu.models.language as jlang
from difffacto_tpu.config import Config as JaxConfig
from difffacto_tpu.data.synthetic import SyntheticLanguagePart as JaxLanguagePart
from difffacto_tpu.models.anchor_diff import AnchorDiffAE as JaxAnchorDiffAE
from difffacto_tpu.runner import LanguageRunner as JaxLanguageRunner
from difffacto_tpu.utils import gaussian as jgauss
from difffacto_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from difffacto_torch import Config, load_jax_params
from difffacto_torch.data import SyntheticLanguagePart
from difffacto_torch.models import language as plang
from difffacto_torch.runner import LanguageRunner
from difffacto_torch.utils.jax_params import export_jax_params, flatten_jax_tree

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "tests", "configs", "tiny_gen.py")
TOL = dict(rtol=1e-5, atol=1e-5)
KEYS = ("input", "ref", "attn_map", "ref_attn_map", "seg_mask", "ref_seg_mask",
        "part_indicator", "text")


def np_(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def randn(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def patch_bernoulli(monkeypatch, masks):
    """flax's Dropout takes its keep masks from ``masks``, in order."""
    queue = list(masks)

    def fake(key, p=0.5, shape=None):
        m = queue.pop(0)
        assert tuple(shape) == m.shape
        return jnp.asarray(m, bool)

    monkeypatch.setattr(jax.random, "bernoulli", fake)
    return queue


def patch_draw(monkeypatch, eps):
    def fake(key, mean, logvar):
        return mean + jnp.exp(0.5 * logvar) * jnp.asarray(eps, mean.dtype)

    monkeypatch.setattr(jgauss, "reparameterize_gaussian", fake)


# ------------------------------------------------------------------- text
@pytest.mark.parametrize("text", ["a chair with thick legs", "A Tall BACK, wheels!",
                                  "arm " * 30, ""])
def test_tokenizing_matches_jax(text):
    got = plang.tokenizing(text)
    want = jlang.tokenizing(text)
    assert got.dtype == want.dtype and got.shape == (24,)
    np.testing.assert_array_equal(got, want)
    vocab = ["chair", "back"]
    np.testing.assert_array_equal(plang.tokenizing(text, plang.Vocabulary(vocab), max_len=6),
                                  jlang.tokenizing(text, jlang.Vocabulary(vocab), max_len=6))


@pytest.mark.parametrize("split", ["train", "test"])
def test_synthetic_language_part_matches_jax_bit_for_bit(split):
    """Every item of a split and the first batch of an epoch's shuffle."""
    (pl, _), (jl, _) = (f(batch_size=4, size=6, npoints=64, split=split)
                        for f in (SyntheticLanguagePart, JaxLanguagePart))
    for i in range(6):
        got, want = pl.dataset[i], jl.dataset[i]
        assert sorted(got) == sorted(want)
        for k in want:
            if isinstance(want[k], str):
                assert got[k] == want[k]
            else:
                assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    pl.set_epoch(1)
    jl.set_epoch(1)
    got, want = next(iter(pl)), next(iter(jl))
    for k in KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------- modules
TOKENS = np.array([[3, 4, 5, 0, 0, 0], [7, 0, 0, 0, 0, 0], [0, 0, 0, 0, 0, 0],
                   [9, 8, 7, 6, 5, 4]], np.int32)


@pytest.mark.parametrize("train", [False, True])
def test_lstm_matches_jax_at_every_step(train, monkeypatch):
    """rnn_out at every position (padding included: the recurrence runs on),
    the final feature and the attention (padding at -1e9, an empty row
    uniform); in training the embeddings' dropout keep mask injected."""
    jm = jlang.LSTM(text_dim=8, embedding_dim=6, vocab_size=30)
    pm = plang.LSTM(text_dim=8, embedding_dim=6, vocab_size=30, device="cpu")
    variables = jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(TOKENS))
    load_jax_params(pm, variables["params"])
    keep = np.random.RandomState(1).rand(4, 6, 6) > 0.5
    if train:
        patch_bernoulli(monkeypatch, [keep])
    (final, attn), inter = jm.apply(variables, jnp.asarray(TOKENS), deterministic=not train,
                                    rngs={"dropout": jax.random.PRNGKey(2)},
                                    capture_intermediates=True, mutable=["intermediates"])
    rnn_out = inter["intermediates"]["rnn"]["__call__"][0]
    got = pm.sequence(torch.from_numpy(TOKENS), train=train,
                      keep=torch.from_numpy(keep) if train else None)
    for g, w, name in zip(got, (final, attn, rnn_out), ("final", "attn", "rnn_out")):
        np.testing.assert_allclose(np_(g), np.asarray(w), err_msg=name, **TOL)
    np.testing.assert_allclose(np_(got[1])[2], np.full(6, 1 / 6), **TOL)


@pytest.mark.parametrize("scale", [True, False])
def test_multi_head_cross_attention_matches_jax(scale):
    src, tgt = randn(3, 4, 12, seed=3), randn(3, 5, 10, seed=4)  # one src token a part
    ind = np.eye(4, dtype=np.float32)[[0, 2, 3]]
    jm = jlang.MultiHeadCrossAttention(12, 10, 16, qk_dim=16, nheads=4, scale=scale)
    pm = plang.MultiHeadCrossAttention(12, 10, 16, qk_dim=16, nheads=4, scale=scale,
                                       device="cpu")
    args = (jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(ind))
    variables = jm.init(jax.random.PRNGKey(5), *args)
    load_jax_params(pm, variables["params"])
    want = jm.apply(variables, *args)
    got = pm(*(torch.from_numpy(a) for a in (src, tgt, ind)))
    np.testing.assert_allclose(np_(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("kw", [{}, dict(residual=False, cat_weights=False),
                                dict(regress_weights=True, normalize_latent=True)])
def test_latent_language_fuser_matches_jax(kw):
    part, text = randn(3, 4, 16, seed=6), randn(3, 8, seed=7)
    ind = np.eye(4, dtype=np.float32)[[1, 0, 3]]
    jm = jlang.LatentLanguageFuser(text_dim=8, part_dim=16, num_part=4, mid_dim=32, **kw)
    pm = plang.LatentLanguageFuser(text_dim=8, part_dim=16, num_part=4, mid_dim=32,
                                   device="cpu", **kw)
    args = (jnp.asarray(part), jnp.asarray(ind), jnp.asarray(text))
    variables = jm.init(jax.random.PRNGKey(8), *args)
    load_jax_params(pm, variables["params"])
    want = jm.apply(variables, *args)
    got = pm(*(torch.from_numpy(a) for a in (part, ind, text)))
    assert got.shape == (3, 1, 4, 16)
    np.testing.assert_allclose(np_(got), np.asarray(want), **TOL)


def test_part_selector_and_zero_mlp_match_jax():
    tgt, ind = randn(3, 4, 16, seed=9), np.eye(4, dtype=np.float32)[[2, 0, 1]]
    want = jlang.PartLanguageSelector().apply({}, None, jnp.asarray(tgt), jnp.asarray(ind))
    got = plang.PartLanguageSelector(device="cpu")(None, torch.from_numpy(tgt),
                                                   torch.from_numpy(ind))
    np.testing.assert_array_equal(np_(got), np.asarray(want))
    x = randn(3, 24, seed=10)
    jz = jlang.ZeroMLP([32, 32, 16])
    variables = jz.init(jax.random.PRNGKey(0), jnp.asarray(x))
    pz = plang.ZeroMLP(24, [32, 32, 16], device="cpu")
    port = {n: tuple(p.shape) for n, p in pz.named_parameters()}
    assert port == {n: a.shape for n, a in flatten_jax_tree(variables["params"]).items()}
    assert all(not p.any() for p in pz.parameters())
    np.testing.assert_array_equal(np_(pz(torch.from_numpy(x))), np.zeros((3, 16), np.float32))


def test_language_losses_match_jax():
    a, p, n = (randn(5, 16, seed=s) for s in (11, 12, 13))
    got = plang.triplet_loss(*(torch.from_numpy(t) for t in (a, p, n)), thresh=0.3)
    want = jlang.triplet_loss(*(jnp.asarray(t) for t in (a, p, n)), thresh=0.3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np_(g), np.asarray(w), **TOL)
    got = plang.clip_style_loss(*(torch.from_numpy(t) for t in (a, p, n)))
    want = jlang.clip_style_loss(*(jnp.asarray(t) for t in (a, p, n)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(np_(g), np.asarray(w), **TOL)


# ------------------------------------------------------------ the runner
def lang_cfg(cls, tmp, name):
    """tiny_gen on the JAX test's language data (``test_extra_runners.py:64-73``)."""
    cfg = cls(TINY)
    cfg.work_dir = str(tmp / name)
    cfg.max_epoch = 1
    cfg.eval_interval = None
    cfg.checkpoint_interval = None
    cfg.cimle_cache_interval = None
    cfg.dataset.train = cfg.dfs(dict(type="SyntheticLanguagePart", batch_size=4, size=8,
                                     npoints=64))
    cfg.dataset.val = cfg.dfs(dict(type="SyntheticLanguagePart", batch_size=4, size=4,
                                   npoints=64, split="test"))
    return cfg


@pytest.fixture(scope="module")
def lang_pair(tmp_path_factory):
    """The JAX LanguageRunner (its merged init tree) and the port's, which
    reads that tree back from the ``.msgpack`` the JAX runner writes."""
    tmp = tmp_path_factory.mktemp("lang")
    jr = JaxLanguageRunner(cfg=lang_cfg(JaxConfig, tmp, "jax"))
    path = jax_save_checkpoint(str(tmp / "ckpt"), 0, jr.state)
    cfg = lang_cfg(Config, tmp, "port")
    cfg.resume_path = path
    pr = LanguageRunner(cfg=cfg, device="cpu")
    return jr, pr


def test_language_runner_reads_the_merged_tree(lang_pair):
    """The JAX runner's merged tree carries ``language_enc`` and
    ``update_mlp`` beside the model's; the port's runner resumed from it
    holds every parameter, exports the LSTM's gates under flax's names
    again, and a tree without the update MLP raises."""
    jr, pr = lang_pair
    params = flatten_jax_tree(jax.device_get(jr.state.params))
    assert any(n.startswith("language_enc.cell.") for n in params)
    assert any(n.startswith("update_mlp.dense2.") for n in params)
    port = dict(pr.model.named_parameters())
    assert sorted(port) == sorted(params)
    for n, arr in params.items():
        np.testing.assert_array_equal(np_(port[n]), arr, err_msg=n)
    exported, _ = export_jax_params(pr.model)  # the inverse, flax's names again
    jtree = jax.device_get(jr.state.params)
    for gate in ("ii", "if", "ig", "io", "hi", "hf", "hg", "ho"):
        got = exported["language_enc"]["OptimizedLSTMCell_0"][gate]
        want = jtree["language_enc"]["OptimizedLSTMCell_0"][gate]
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=gate)
    broken = dict(jtree)
    broken.pop("update_mlp")
    with pytest.raises(KeyError, match="update_mlp"):
        load_jax_params(pr.model, broken)


def _batch(jr):
    batch = next(iter(jr.train_loader))
    return {k: np.asarray(batch[k]) for k in KEYS}


def _draws(B, N=64, K=4, zdim=16, seed=20):
    rng = np.random.RandomState(seed)
    return rng.randn(B * 3, K, zdim).astype(np.float32), rng.rand(B, 24, 100) > 0.5


def test_language_train_step_losses_and_gradients_match_jax(lang_pair, monkeypatch):
    """The loss dict and the gradient of the summed losses in every
    parameter (the encoder's too: the step masks them afterwards)."""
    jr, pr = lang_pair
    db = _batch(jr)
    eps, keep = _draws(len(db["text"]))
    patch_draw(monkeypatch, eps)
    patch_bernoulli(monkeypatch, [keep])
    variables = jr.state.variables()

    def loss_fn(params):
        out, _ = jr.model.apply(dict(variables, params=params), {k: jnp.asarray(v) for k, v in
                                                                 db.items()},
                                method=JaxAnchorDiffAE.language_train_step,
                                rngs={"sample": jax.random.PRNGKey(0),
                                      "dropout": jax.random.PRNGKey(1)},
                                mutable=["batch_stats"])
        means = {k: jnp.mean(v) for k, v in out.items()}
        return sum(v for k, v in means.items() if "loss" in k), means

    (_, want), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    model = pr.model
    buffers = {n: b.clone() for n, b in model.named_buffers()}
    batch = {k: torch.as_tensor(v) for k, v in db.items()}
    batch.update(part_code_eps=torch.from_numpy(eps), text_keep=torch.from_numpy(keep))
    got = model.language_train_step(batch)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k].mean()), float(want[k]), err_msg=k, **TOL)
    total = sum(v.mean() for k, v in got.items() if "loss" in k)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(total, list(model.parameters()), allow_unused=True)
    jflat = flatten_jax_tree(jax.device_get(jgrads))
    for n, g, p in zip(names, grads, model.parameters()):
        g = np_(torch.zeros_like(p) if g is None else g)
        scale = max(float(np.abs(jflat[n]).max()), 1e-2)
        np.testing.assert_allclose(g, jflat[n], atol=2e-4 * scale, rtol=0, err_msg=n)
    with torch.no_grad():  # the BatchNorm statistics this forward moved
        for n, b in model.named_buffers():
            b.copy_(buffers[n])


def test_language_runner_step_matches_jax_and_moves_only_the_language_modules(lang_pair,
                                                                              monkeypatch):
    """One step: the metrics and every parameter after it against JAX's step
    (1e-5); every parameter outside ``language_enc`` and ``update_mlp`` equal
    bit for bit to its value before the step, the language modules moved."""
    jr, pr = lang_pair
    db = _batch(jr)
    eps, keep = _draws(len(db["text"]), seed=21)
    patch_draw(monkeypatch, eps)
    patch_bernoulli(monkeypatch, [keep])
    state0 = jr.state
    new_state, want = jr._language_step(state0, {k: jnp.asarray(v) for k, v in db.items()},
                                        jax.random.PRNGKey(3))
    jr.state = state0
    before = {n: p.detach().clone() for n, p in pr.model.named_parameters()}
    buffers = {n: b.clone() for n, b in pr.model.named_buffers()}
    batch = {k: torch.as_tensor(v) for k, v in db.items()}
    batch.update(part_code_eps=torch.from_numpy(eps), text_keep=torch.from_numpy(keep))
    state, got = pr.language_step(pr.state, batch, {})
    assert state.step == 1 and sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), err_msg=k, **TOL)
    after = flatten_jax_tree(jax.device_get(new_state.params))
    moved = 0
    for n, p in pr.model.named_parameters():
        np.testing.assert_allclose(np_(p), after[n], err_msg=n, **TOL)
        if n.startswith(("language_enc.", "update_mlp.")):
            moved += int(not torch.equal(p, before[n]))
        else:
            assert torch.equal(p, before[n]), n
    assert moved > 0
    with torch.no_grad():
        for n, p in pr.model.named_parameters():
            p.copy_(before[n])
        for n, b in pr.model.named_buffers():
            b.copy_(buffers[n])


def test_language_edit_latents_matches_jax(lang_pair):
    jr, pr = lang_pair
    code = randn(3, 4, 16, seed=30)
    tokens = TOKENS[:3, :]
    want = jr.model.apply(jr.state.variables(), jnp.asarray(code), jnp.asarray(tokens), 2,
                          method=JaxAnchorDiffAE.language_edit_latents)
    got = pr.model.language_edit_latents(torch.from_numpy(code), torch.from_numpy(tokens), 2)
    np.testing.assert_allclose(np_(got), np.asarray(want), **TOL)


def test_cli_language_runs_an_epoch(tmp_path):
    """``--runner language --no_eval --cpu``: one epoch of 2 steps on the
    language data, finite losses, the final checkpoint."""
    import json

    from difffacto_torch.runner.cli import main

    cfg_file = tmp_path / "lang.py"
    cfg_file.write_text(
        f"_base_ = [{TINY!r}]\nwork_dir = {str(tmp_path / 'run')!r}\n"
        "dataset = dict(train=dict(_cover_=True, type='SyntheticLanguagePart', batch_size=4, "
        "size=8, npoints=64), val=dict(_cover_=True, type='SyntheticLanguagePart', "
        "batch_size=4, size=4, npoints=64, split='test'))\n"
        "max_epoch = 1\ncheckpoint_interval = None\ncimle_cache_interval = None\n")
    runner = main(["--config-file", str(cfg_file), "--runner", "language", "--no_eval", "--cpu"])
    assert type(runner).__name__ == "LanguageRunner" and runner.epoch == 1
    assert runner.state.step == 2
    recs = [json.loads(line) for line in open(tmp_path / "run" / "scalars.jsonl")]
    losses = [r["total_loss"] for r in recs if "total_loss" in r]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert os.path.exists(tmp_path / "run" / "checkpoints" / "ckpt_1.pt")
