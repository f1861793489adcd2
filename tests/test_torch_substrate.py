"""The port's substrate: no JAX in the package, its own config loader and
registries, the schedule tables, the device rule and the weight bridge."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from difffacto_tpu.config import Config as JaxConfig
from difffacto_tpu.models.flow import PerPartFlow as JaxPerPartFlow
from difffacto_tpu.ops.schedule import make_schedule as jax_make_schedule
from difffacto_torch import Config, MODELS, build_from_cfg
from difffacto_torch.models import AnchoredDiffusion, PerPartFlow, TransformerNet
from difffacto_torch.ops.schedule import make_schedule
from difffacto_torch.utils.jax_params import load_jax_params

ROOT = Path(__file__).resolve().parent.parent
GEN_CHAIR = str(ROOT / "configs" / "gen_chair.py")


def test_import_leaves_jax_out():
    code = (
        "import sys, runpy, difffacto_torch, difffacto_torch.models, difffacto_torch.ops.fused_core;"
        "import difffacto_torch.ops.points, difffacto_torch.ops.fps, difffacto_torch.ops.chamfer;"
        "import difffacto_torch.ops.emd, difffacto_torch.ops.emd_hybrid, difffacto_torch.data;"
        "import difffacto_torch.metrics, difffacto_torch.metrics.iou, difffacto_torch.runner;"
        "import difffacto_torch.ops.fused_core_train, difffacto_torch.parallel.optim;"
        "import difffacto_torch.parallel.train, difffacto_torch.models.pointnet;"
        "import difffacto_torch.models.samplers, difffacto_torch.utils.gaussian;"
        "runpy.run_path('tools/test_gen_torch.py', run_name='imported');"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'optax', 'difffacto_tpu', '__graft_entry__'));"
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_no_jax_import_in_the_port():
    files = sorted((ROOT / "difffacto_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tools" / "test_gen_torch.py",
        ROOT / "tools" / "profile_train_torch.py", ROOT / "tools" / "eval_ckpt_curve_torch.py",
        ROOT / "tools" / "quality_torch.py", ROOT / "tools" / "curve_probe_torch.py"]
    assert len(files) >= 47
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            bad += [f"{path.name}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "flax", "jaxlib", "optax", "difffacto_tpu",
                                           "__graft_entry__", "msgpack", "ml_dtypes")]
    assert not bad, bad


def test_config_matches_jax_loader():
    assert Config(GEN_CHAIR).dump() == JaxConfig(GEN_CHAIR).dump()


@pytest.mark.parametrize("mode, T", [("linear", 100), ("cosine", 50)])
def test_schedule_equals_jax_tables(mode, T):
    ours, theirs = make_schedule(T, 1e-4, 0.02, mode), jax_make_schedule(T, 1e-4, 0.02, mode)
    for name in ours.__dataclass_fields__:
        got, want = getattr(ours, name).numpy(), np.asarray(getattr(theirs, name))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_unported_chain_options_raise():
    """The options that raised before the chain was ported (the x_0 mean,
    the learned_range variance, DDIM, guidance) now compute: one reverse step
    of each against the JAX diffusion, through a linear stub denoiser that
    reads the context. Tolerance 1e-5."""
    import jax.numpy as jnp

    from difffacto_tpu.models.diffusion import AnchoredDiffusion as JaxDiffusion

    rng = np.random.RandomState(0)
    x, anchors, noise = (rng.randn(2, 16, 3).astype(np.float32) for _ in range(3))
    ctx = rng.randn(2, 4, 5).astype(np.float32)
    t = np.array([0, 7], np.int64)
    for kw, out_ch in ((dict(model_mean_type="x_0"), 3), (dict(model_var_type="learned_range"), 6),
                       (dict(ddim_sampling=True, ddim_nsteps=5), 3),
                       (dict(guidance=True, classifier_weight=2.0), 3)):
        w = rng.randn(6, out_ch).astype(np.float32) * 0.3
        wc = rng.randn(5, out_ch).astype(np.float32) * 0.3

        def fn(inp, ts, c, *rest, lib=np):
            return inp @ lib.asarray(w) + (c.mean(1) @ lib.asarray(wc))[:, None]

        want = JaxDiffusion(10, 1e-4, 0.02, **kw).p_sample(
            lambda *a: fn(*a, lib=jnp), None, jnp.asarray(x), jnp.asarray(t),
            jnp.asarray(anchors), jnp.asarray(ctx), noise=jnp.asarray(noise))["sample"]
        got = AnchoredDiffusion(10, 1e-4, 0.02, **kw).p_sample(
            lambda *a: fn(*a, lib=torch), torch.as_tensor(x), torch.as_tensor(t),
            torch.as_tensor(anchors), torch.as_tensor(ctx), noise=torch.as_tensor(noise))["sample"]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5,
                                   err_msg=str(kw))


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the rule under test is for machines without one")
    with pytest.raises(RuntimeError, match="cuda"):
        TransformerNet(3, 3, 8, 16, context_dim=262, single_attn=True)
    mcfg = Config(GEN_CHAIR).model.dump()
    with pytest.raises(RuntimeError, match="cuda"):
        build_from_cfg(mcfg, MODELS)


def _flow_tree():
    z = jax.numpy.zeros((2, 4, 8))
    return JaxPerPartFlow(n_class=4, depth=2, dim=8, intermediate_dim=16).init(
        jax.random.PRNGKey(0), z, reverse=True
    )["params"]


def test_bridge_loads_and_splits_the_part_axis():
    params = _flow_tree()
    flow = PerPartFlow(4, 2, 8, 16, device="cpu")
    load_jax_params(flow, params)
    want = np.asarray(params["flows"]["chain_1"]["Dense_0"]["kernel"][2])
    np.testing.assert_array_equal(flow.flows[2].chain[1].dense0.kernel.detach().numpy(), want)


def test_bridge_raises_on_missing_or_extra_keys():
    flow = PerPartFlow(4, 2, 8, 16, device="cpu")
    params = _flow_tree()
    del params["flows"]["chain_1"]["Dense_2"]["bias"]
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(flow, params)
    params = _flow_tree()
    params["flows"]["chain_2"] = params["flows"]["chain_1"]
    with pytest.raises(KeyError, match="left over"):
        load_jax_params(flow, params)
    params = _flow_tree()
    params["encoder_net"] = {"Dense_0": {"kernel": np.zeros((3, 3))}}
    with pytest.raises(KeyError, match="left over"):  # no key is skipped by name
        load_jax_params(flow, params)
    del params["encoder_net"]
    with pytest.raises(KeyError, match="left over"):  # nor a buffer the module lacks
        load_jax_params(flow, params, batch_stats={"bn": {"mean": np.zeros(3)}})
    params["flows"]["chain_0"]["Dense_0"]["kernel"] = np.zeros((4, 5, 16))
    with pytest.raises(ValueError):
        load_jax_params(flow, params)
