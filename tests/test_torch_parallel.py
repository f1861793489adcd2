"""The port's data and sequence parallelism over gloo ranks on the CPU.

The JAX package's ``tests/test_parallel.py`` is the specification. Two and
four ranks (``tests/torch_dist_ranks.py``, suite "parallel", started once for
the module while the JAX test below runs) each hold what they computed over
a mesh against the one-device run rank 0 computes on the same inputs, with
tests/configs/tiny_gen.py's model (B = 4, N = 64, every weight moved off its
initial value) and every draw of the loss injected. One test ties the port's
one-device loss and gradients to the JAX package's; everything sharded is
then held against the port's own one-device run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difffacto_tpu.config import Config as JaxConfig
from difffacto_tpu.models.anchor_diff import AnchorDiffAE as JaxAnchorDiffAE
from difffacto_tpu.parallel.train import parse_losses as jax_parse_losses
from difffacto_tpu.utils.registry import MODELS as JAX_MODELS
from difffacto_tpu.utils.registry import build_from_cfg as jax_build
from difffacto_torch import Config, MODELS, build_from_cfg, load_jax_params
from difffacto_torch.parallel import Mesh, make_mesh, shard_batch
from test_torch_generation import randomize
from torch_dist_ranks import TINY, loss_and_grads, spawn_async, tiny_batch

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory):
    return {w: spawn_async("parallel", w, tmp_path_factory.mktemp(f"parallel{w}"))
            for w in (2, 4)}


@pytest.fixture(scope="module")
def ranks(started):
    return {w: f.result() for w, f in started.items()}


def close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


def test_one_device_loss_and_grads_match_jax():
    """The tie to the reference: the port's one-device eval-mode loss and
    gradients against the JAX package's on the same weights and injected
    draws, at the shape every test below uses (tiny_gen with fit loss type 0,
    the point-reduced one, and ``gen=False``, whose loss draws nothing).
    Loss 1e-5 relative; gradients 1e-3 relative and 1e-4 of the largest
    entry absolute (f32 on both sides, summed in other orders)."""
    jcfg = JaxConfig(TINY).model.dump()
    pcfg = Config(TINY).model.dump()
    for cfg in (jcfg, pcfg):
        cfg["gen"] = False
        cfg["encoder"].update(gen=False, fit_loss_type=0)
    jmodel = jax_build(jcfg, JAX_MODELS)
    pmodel = build_from_cfg(pcfg, MODELS, device="cpu")
    batch = tiny_batch(pmodel, seed=3)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items() if k != "part_code_eps"}
    jbatch["attn_map"] = jbatch["ref_attn_map"] = jax.nn.one_hot(jbatch["ref_seg_mask"], 4)
    rngs = {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1),
            "dropout": jax.random.PRNGKey(2)}
    variables = jax.jit(lambda r, b: jmodel.init(r, b, 0, method=JaxAnchorDiffAE.loss))(
        rngs, jbatch)
    params = randomize(variables["params"], seed=4)
    stats = variables["batch_stats"]

    def total(p):
        outs = jmodel.apply({"params": p, "batch_stats": stats}, jbatch, 0, False,
                            method=JaxAnchorDiffAE.loss, rngs=rngs)
        return jax_parse_losses(outs)[0]

    jtotal, jgrads = jax.jit(jax.value_and_grad(total))(params)
    load_jax_params(pmodel, params, stats)
    ptotal, pgrads = loss_and_grads(pmodel, {k: v for k, v in batch.items()
                                             if k != "part_code_eps"}, False)
    # the JAX gradients in the port's layout: the weight bridge is a copy
    load_jax_params(pmodel, jgrads, stats)
    want = np.concatenate([p.detach().numpy().reshape(-1) for p in pmodel.parameters()])
    got = np.concatenate([g.numpy().reshape(-1) for g in pgrads])
    close(ptotal.item(), float(jtotal), 1e-5, 0.0)
    close(got, want, 1e-3, 1e-4 * np.abs(want).max())


def test_make_mesh_refuses_the_layouts_jax_refuses():
    """As ``test_mesh_2d_constructor``: a second axis other than "points"
    and a shape that does not cover the ranks raise, before any group."""
    with pytest.raises(NotImplementedError):
        make_mesh(ranks=range(4), axis_names=("data", "model"))
    with pytest.raises(ValueError):
        make_mesh(ranks=range(4), axis_names=("data", "points"), mesh_shape=(3, 2))


def test_shard_batch_cuts_rows_and_points():
    """Rank 3 of a (2, 2) mesh takes the second half of the rows and, for
    the point-axis keys only, the second half of the points; a ragged batch
    stays whole; lists stay whole."""
    mesh = Mesh(("data", "points"), {"data": 2, "points": 2}, (0, 1, 2, 3), 3, None, {})
    x = np.arange(4 * 6 * 3).reshape(4, 6, 3)
    out = shard_batch(mesh, {"ref": x, "part_shift": x, "token": ["a"] * 4})
    np.testing.assert_array_equal(out["ref"], x[2:, 3:])
    np.testing.assert_array_equal(out["part_shift"], x[2:])
    assert out["token"] == ["a"] * 4
    ragged = shard_batch(mesh, {"ref": x[:3]})["ref"]
    np.testing.assert_array_equal(ragged, x[:3])


@pytest.mark.parametrize("world", [2, 4])
def test_dp_step_matches_manual_dp_math(ranks, world):
    """``test_shard_map_step_matches_manual_dp_math``: the W-rank step (one
    sample of the 4 a rank at W = 4) against each slice's loss and gradients
    by hand from the same statistics, their mean and one Adam update: loss
    and gradient norm 1e-5 relative, parameters and BatchNorm statistics
    1e-4 relative and 1e-7 absolute (JAX's tolerances)."""
    r = ranks[world][0]
    close(r["dp_total"], r["dp_ref_total"], 1e-5, 0.0)
    close(r["dp_gnorm"], r["dp_ref_gnorm"], 1e-5, 0.0)
    close(r["dp_params"], r["dp_ref_params"], 1e-4, 1e-7)
    close(r["dp_stats"], r["dp_ref_stats"], 1e-4, 1e-7)


@pytest.mark.parametrize("world", [2, 4])
def test_ragged_batch_counts_its_gradients_once(ranks, world):
    """A batch of 3 on W ranks stays whole on every rank; the mean over the
    ranks of W equal gradients is the one-device step's: equal bit for bit
    (a mean of 2 or 4 equal terms is exact)."""
    r = ranks[world][0]
    for k in ("total", "gnorm", "params", "stats"):
        np.testing.assert_array_equal(r[f"ragged_{k}"], r[f"ragged_ref_{k}"])


SP_CASES = [(2, "sp1x2", "one"), (4, "sp1x4", "one"), (4, "sp2x2", "dp2")]


@pytest.mark.parametrize("variant", ["fit0", "learned"])
@pytest.mark.parametrize("world,mesh,ref", SP_CASES)
def test_sp_loss_grads_match(ranks, world, mesh, ref, variant):
    """``test_sp_loss_grads_match_single_device`` and
    ``test_dp_sp_loss_grads_match_flat_dp``: eval-mode loss and gradients
    (BN's running statistics, injected draws) on (1, 2) and (1, 4) against
    one device, on (2, 2) against flat dp over 2 ranks (flat dp is its own
    estimator where the slices hold unequal shares of the flagged points).
    Loss 1e-5 relative, gradients 1e-4 relative and 1e-5 absolute (JAX's).
    ``fit0``: the fit loss reduced over the points and the diffusion loss
    over the flagged points; ``learned``: a learned-range variance, whose vb
    term and variance value reduce over the points."""
    r = ranks[world][0]
    close(r[f"{variant}_{mesh}_total"], r[f"{variant}_{ref}_total"], 1e-5, 0.0)
    close(r[f"{variant}_{mesh}_grads"], r[f"{variant}_{ref}_grads"], 1e-4, 1e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_bn_point_axis_sync(ranks, world):
    """``test_bn_point_axis_sync``: train-mode BatchNorm with its points cut
    over (1, W): outputs 2e-6 absolute, running statistics and the gradients
    of sum(y^2) (combined by the mean over the ranks) 1e-5 relative and
    1e-5 absolute (the bias gradient is analytically 0: f32 residue)."""
    r = ranks[world][0]
    close(r["bn_y"], r["bn_ref_y"], 0.0, 2e-6)
    close(r["bn_stats"], r["bn_ref_stats"], 1e-5, 1e-5)
    close(r["bn_grads"], r["bn_ref_grads"], 1e-5, 1e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_sp_train_step_layout_smoke(ranks, world):
    """``test_sp_train_step_layout_smoke``: the whole train-mode step on
    (1, W) against the one-device step, loosely, as the JAX test holds it:
    the loss 1e-2 relative (BatchNorm over 4 shapes amplifies the sharded
    stack's reduction order), every parameter within 2.5e-3 of the
    reference (Adam's first update is +-lr = 1e-3 a weight; a sign flip of a
    near-zero gradient moves it by 2 lr)."""
    r = ranks[world][0]
    close(r["spstep_total"], r["spstep_ref_total"], 1e-2, 0.0)
    close(r["spstep_params"], r["spstep_ref_params"], 0.0, 2.5e-3)


DECODE_CASES = [(2, "dp"), (2, "2x1"), (2, "1x2"), (4, "dp"), (4, "2x2"), (4, "1x4"), (4, "4x1")]


@pytest.mark.parametrize("world,layout", DECODE_CASES)
def test_decode_matches_one_device(ranks, world, layout):
    """``test_decode_sharded_equals_unsharded`` and
    ``test_decode_points_sharded_equals_unsharded``: the reverse chain over
    a flat mesh and over ("data", "points") layouts, x_T and every step's
    draw injected and cut to the rank's shard, against one device: 1e-5
    relative, 1e-6 absolute (JAX's)."""
    r = ranks[world][0]
    close(r[f"decode_{layout}"], r["decode_ref"], 1e-5, 1e-6)


EVERY_RANK = ["dp_digest", "ragged_digest", "spstep_digest", "decode_dp_digest"]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("key", EVERY_RANK)
def test_every_rank_holds_the_same_result(ranks, world, key):
    """After a step every rank holds the same parameters and statistics,
    and after a sharded decode the same gathered samples (sha256 digests
    equal to rank 0's)."""
    for r in ranks[world][1:]:
        np.testing.assert_array_equal(r[key], ranks[world][0][key])
