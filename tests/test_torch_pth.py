"""The port's reference ``.pth`` loader against the JAX package's.

A full-width gen_chair state dict in the reference's layout (the modules of
``tools/reference_layout_torch.py``, the same as ``tests/test_full_ingest.py``
builds) goes through ``difffacto_torch/utils/torch_ingest.py`` and through
``difffacto_tpu/utils/torch_ingest.py``: every parameter and BatchNorm buffer
the two fill is equal, bit for bit, and the port's encoder, aligner, flows and
denoiser reproduce the torch modules. A checkpoint with a key too many, a key
too few or a wrong shape raises and leaves the model as it was; a ``Runner``
loads a ``.pth`` from its config.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difffacto_tpu.config import Config as JaxConfig
from difffacto_tpu.models.anchor_diff import AnchorDiffAE as JaxAnchorDiffAE
from difffacto_tpu.utils.registry import MODELS as JAX_MODELS
from difffacto_tpu.utils.registry import build_from_cfg as jax_build
from difffacto_tpu.utils.torch_ingest import convert_state_dict as jax_convert
from difffacto_torch import Config, MODELS, Runner, build_from_cfg
from difffacto_torch.utils import torch_ingest
from difffacto_torch.utils.jax_params import flatten_jax_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import reference_layout_torch as ref  # noqa: E402

torch.set_num_threads(1)

CFG = os.path.join(ROOT, "tests", "configs", "ingest_gen_chair.py")  # gen_chair at 64 points
TINY = os.path.join(ROOT, "tests", "configs", "tiny_gen.py")
K, N_PTS = 4, 64


def port_model():
    return build_from_cfg(Config(CFG).model.dump(), MODELS, device="cpu")


def snapshot(model):
    out = {n: p.detach().clone() for n, p in model.named_parameters()}
    out.update({n: b.clone() for n, b in model.named_buffers()})
    return out


@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory):
    mods = ref.build_modules(seed=0)
    pth = tmp_path_factory.mktemp("pth") / "gen_chair_reference_layout.pth"
    ref.save_pth(mods, str(pth))
    port = port_model()
    leftovers = torch_ingest.load_reference_checkpoint(str(pth), port)
    return mods, pth, port, leftovers


def jax_written(pth):
    """The JAX loader's conversion into a template of the JAX model's shapes
    (``jax.eval_shape``: nothing compiled): the leaves it wrote, renamed as
    the port names them, split into parameters and buffers."""
    jm = jax_build(JaxConfig(CFG).model.dump(), JAX_MODELS)
    seg = np.repeat(np.arange(K), N_PTS // K)[None].repeat(2, 0)
    onehot = np.eye(K, dtype=np.float32)[seg]
    batch = {
        "input": jnp.zeros((2, N_PTS, 3)), "ref": jnp.zeros((2, N_PTS, 3)),
        "ref_seg_mask": jnp.asarray(seg, jnp.int32), "seg_mask": jnp.asarray(seg, jnp.int32),
        "ref_attn_map": jnp.asarray(onehot), "attn_map": jnp.asarray(onehot),
        "present": jnp.ones((2, K)), "dp_present": jnp.ones((2, K)),
        "part_shift": jnp.zeros((2, K, 3)), "part_scale": jnp.ones((2, K, 3)),
        "noise": jnp.zeros((2, 1)),
    }
    rngs = {n: jax.random.PRNGKey(i) for i, n in enumerate(("params", "sample", "dropout"))}
    shapes = jax.eval_shape(lambda r, b: jm.init(r, b, 0, method=JaxAnchorDiffAE.loss), rngs, batch)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    sd = {k: v.numpy() for k, v in torch.load(pth, weights_only=True)["model"].items()}
    params, stats, leftovers, fill = jax_convert(sd, zeros["params"], zeros["batch_stats"])
    trees = {"params": params, "batch_stats": stats}
    written = {"params": {}, "batch_stats": {}}
    for path in fill.written:
        col, *keys = path.split("/")
        src, dst = trees[col], written[col]
        for k in keys[:-1]:
            src, dst = src[k], dst.setdefault(k, {})
        dst[keys[-1]] = src[keys[-1]]
    return (flatten_jax_tree(written["params"]), flatten_jax_tree(written["batch_stats"]),
            leftovers)


def test_both_loaders_fill_every_parameter_alike(rehearsal):
    """Every parameter and buffer of the port is filled, each equal to the
    JAX loader's leaf of the same name, bit for bit; neither loader leaves a
    key of the checkpoint over."""
    _, pth, port, leftovers = rehearsal
    jparams, jstats, jleft = jax_written(pth)
    assert leftovers == [] and jleft == []
    got_p = dict(port.named_parameters())
    got_b = dict(port.named_buffers())
    assert sorted(jparams) == sorted(got_p) and sorted(jstats) == sorted(got_b)
    for name, want in list(jparams.items()) + list(jstats.items()):
        got = (got_p if name in got_p else got_b)[name]
        np.testing.assert_array_equal(got.detach().numpy(), want, err_msg=name)


def t(a):
    return torch.as_tensor(a)


def test_encoder_matches_the_reference_modules(rehearsal):
    """The PointNetV2 part encoder with the grouped per-part heads (eval-mode
    BatchNorm with non-trivial running statistics). Tolerance 5e-4, as the
    JAX package's rehearsal holds it."""
    mods, _, port, _ = rehearsal
    rng = np.random.RandomState(0)
    pts = rng.randn(2, N_PTS, 3).astype(np.float32)
    onehot = np.eye(K, dtype=np.float32)[rng.randint(0, K, (2, N_PTS))]
    with torch.no_grad():
        tm, tv = mods["encoder"](t(pts), t(onehot))
        pm, pv = port.encoder_mod.get_part_code(t(pts), t(onehot), train=False)
    np.testing.assert_allclose(pm.numpy(), tm.numpy(), atol=5e-4)
    np.testing.assert_allclose(pv.numpy(), tv.numpy(), atol=5e-4)


def test_aligner_matches_the_reference_modules(rehearsal):
    """The aligner with a part absent, pre_norm skipped as the reference
    skips it. Tolerance 1e-3 (the reference's LayerNorms take eps 1e-6, the
    port's 1e-5), as the JAX package's rehearsal holds it."""
    mods, _, port, _ = rehearsal
    rng = np.random.RandomState(1)
    code = rng.randn(2, K, ref.ZDIM).astype(np.float32)
    noise = (rng.randn(2, ref.NOISE_DIM) * 0.01).astype(np.float32)
    valid = np.ones((2, K), np.float32)
    valid[1, 3] = 0.0
    with torch.no_grad():
        tm, tv = mods["aligner"](t(code), t(valid), t(noise))
        pm, pv = port.encoder_mod.aligner(t(code), t(valid), noise=t(noise))
    np.testing.assert_allclose(pm.numpy(), tm.numpy(), atol=1e-3)
    np.testing.assert_allclose(pv.numpy(), tv.numpy(), atol=1e-3)


@pytest.mark.parametrize("reverse", [False, True])
def test_flows_match_the_reference_modules(rehearsal, reverse):
    """The 4 x 14 coupling flows, each part through its own. Tolerance 5e-4."""
    mods, _, port, _ = rehearsal
    x = np.random.RandomState(2).randn(2, K, ref.ZDIM).astype(np.float32)
    with torch.no_grad():
        want = torch.stack([mods["flows"][i](t(x[:, i]), reverse=reverse) for i in range(K)], 1)
        got = port.encoder_mod.flow(t(x), reverse=reverse)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-4)


def test_denoiser_matches_the_reference_modules(rehearsal):
    """The 5-block denoiser with its GEGLU time embedding. Tolerance 1e-3."""
    mods, _, port, _ = rehearsal
    rng = np.random.RandomState(3)
    B = 2
    x = rng.randn(B, N_PTS, 3).astype(np.float32)
    ts = np.array([7.0, 42.0], np.float32)
    ctx = rng.randn(B, K, ref.ZDIM + 6).astype(np.float32)
    anchors = (rng.randn(B, N_PTS, 3) * 0.1).astype(np.float32)
    variances = (np.abs(rng.randn(B, N_PTS, 3)) * 0.2 + 0.5).astype(np.float32)
    seg = np.repeat(np.arange(K), N_PTS // K)[None].repeat(B, 0)
    valid = np.ones((B, K), np.float32)
    args = [t(a) for a in (x, ts, ctx, anchors, variances, seg, valid)]
    with torch.no_grad():
        want = mods["denoiser"](*args)
        got = port.net(*args)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-3)


def _corrupt(kind, sd):
    sd = dict(sd)
    if kind == "key too many":
        sd["encoder.encoder.conv5.weight"] = torch.zeros(3, 3, 1)
    elif kind == "key too few":
        del sd["encoder.flow.2.chain.3.net_s_t.2.weight"]
    elif kind == "aligner leaf too few":  # the aligner is there, its class_emb not
        del sd["encoder.part_aligner.class_emb.weight"]
    else:  # a wrong shape
        sd["encoder.part_aligner.proj_in.weight"] = torch.zeros(256, 300)
    return sd


@pytest.mark.parametrize("kind, error", [("key too many", ValueError),
                                         ("key too few", KeyError),
                                         ("aligner leaf too few", KeyError),
                                         ("wrong shape", ValueError)])
def test_a_corrupted_checkpoint_raises(rehearsal, kind, error):
    """The loader fails loudly, as the JAX package's ``TreeFiller`` does, and
    before it has written anything."""
    mods, _, _, _ = rehearsal
    model = port_model()
    before = snapshot(model)
    with pytest.raises(error):
        torch_ingest.load_state_dict(model, _corrupt(kind, ref.state_dict(mods)))
    after = snapshot(model)
    assert all(torch.equal(before[k], after[k]) for k in before)


def test_a_stage1_checkpoint_leaves_aligner_and_flow_as_they_were(rehearsal):
    """A checkpoint that holds no key of the aligner or the flow fills every
    other parameter and buffer; those two keep their values."""
    mods, _, port, _ = rehearsal
    sd = {k: v for k, v in ref.state_dict(mods).items()
          if not k.startswith(("encoder.part_aligner.", "encoder.flow."))}
    model = port_model()
    before, want = snapshot(model), snapshot(port)
    assert torch_ingest.load_state_dict(model, sd) == []
    after = snapshot(model)
    kept = ("encoder_mod.aligner.", "encoder_mod.flow.")
    assert any(k.startswith(kept) for k in after)
    for k in after:
        assert torch.equal(after[k], before[k] if k.startswith(kept) else want[k]), k


def test_runner_loads_a_pth_from_its_config(rehearsal, tmp_path):
    """A ``Runner`` whose config names a ``.pth`` (``pretrained_weights`` with
    ``model_only``, or ``resume_path``) restores it through the loader; the
    epoch stays 0."""
    _, pth, port, _ = rehearsal
    want = snapshot(port)
    for key in ("pretrained_weights", "resume_path"):
        cfg = Config(TINY)
        cfg.work_dir = str(tmp_path / key)
        cfg.model = cfg.dfs(Config(CFG).model.dump())
        cfg[key] = str(pth)
        cfg.model_only = key == "pretrained_weights"
        r = Runner(cfg=cfg, device="cpu")
        got = snapshot(r.model)
        assert r.epoch == 0 and got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in want), key
