"""The port's modules against their JAX counterparts, on the same weights.

Each JAX module is initialised, its parameters are replaced by random values
(so zero-initialised heads and biases matter too), and the tree reaches the
port through ``load_jax_params``. Inputs come from a numpy seed and go to
both packages. All in float32 on the CPU; the JAX denoiser runs its Pallas
trunk kernel in interpret mode.
"""

import math

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from difffacto_tpu.models.aligner import PartAlignerTransformer as JaxAligner
from difffacto_tpu.models.denoiser import TransformerNet as JaxTransformerNet
from difffacto_tpu.models.flow import PerPartFlow as JaxPerPartFlow
from difffacto_torch.models import PartAlignerTransformer, PerPartFlow, TransformerNet
from difffacto_torch.nn.layers import timestep_embedding
from difffacto_torch.utils.jax_params import load_jax_params
from difffacto_tpu.nn.layers import timestep_embedding as jax_timestep_embedding


def randomize(params, seed):
    """Every leaf replaced by a random value of its shape: LayerNorm scales
    near 1, vectors small, matrices scaled by 1/sqrt(fan-in)."""
    rng = np.random.RandomState(seed)
    flat = flax.traverse_util.flatten_dict(params)
    for key, leaf in flat.items():
        shape = np.shape(leaf)
        r = rng.randn(*shape).astype(np.float32)
        if "scale" in key[-1]:
            flat[key] = 1.0 + 0.1 * r
        elif len(shape) == 1:
            flat[key] = 0.1 * r
        else:
            flat[key] = r / math.sqrt(shape[-2])
    return flax.traverse_util.unflatten_dict(flat)


def t2n(t):
    return t.detach().cpu().numpy()


DENOISER = dict(
    in_channels=3, out_channels=3, n_heads=8, d_head=16, depth=2, context_dim=262,
    n_class=4, class_cond=True, cat_params_to_x=True, single_attn=True, cat_class_to_x=True,
)


@pytest.mark.parametrize("t_max, atol", [(7, 1e-6), (99, 1e-5)])
def test_timestep_embedding(t_max, atol):
    """XLA's and torch's float32 exp differ by one ulp on some frequencies;
    cos/sin of t * freq carry that scaled by t, about t * 6e-8."""
    t = np.arange(t_max + 1, dtype=np.int32)
    want = np.asarray(jax_timestep_embedding(jnp.asarray(t), 256))
    got = t2n(timestep_embedding(torch.as_tensor(t), 256))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_transformer_net_matches_jax(monkeypatch):
    """One denoiser call, a part absent in row 1. Tolerance 2e-4, the trunk
    band of tests/test_ops.py::TestFusedDenoiserCore."""
    monkeypatch.setenv("DIFFFACTO_PALLAS_INTERPRET", "1")
    rng = np.random.RandomState(1)
    B, N = 2, 128
    args = dict(
        x=rng.randn(B, N, 3).astype(np.float32),
        t=np.array([3, 7], np.int32),
        ctx=rng.randn(B, 4, 262).astype(np.float32),
        anchors=(0.1 * rng.randn(B, N, 3)).astype(np.float32),
        variances=(np.abs(rng.randn(B, N, 3)) * 0.5 + 0.1).astype(np.float32),
        seg_mask=np.repeat(np.arange(4), N // 4)[None].repeat(B, 0).astype(np.int32),
        valid_id=np.array([[1, 1, 1, 1], [1, 0, 1, 1]], np.float32),
    )
    jnet = JaxTransformerNet(**DENOISER)
    jargs = [jnp.asarray(a) for a in args.values()]
    params = randomize(jnet.init(jax.random.PRNGKey(0), *jargs)["params"], seed=2)
    want = np.asarray(jnet.apply({"params": params}, *jargs))

    net = TransformerNet(**DENOISER, device="cpu")
    load_jax_params(net, params)
    with torch.no_grad():
        got = t2n(net(*[torch.as_tensor(a) for a in args.values()]))
    assert got.shape == (B, N, 3)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_flow_reverse_matches_jax():
    """4 parts x 2 coupling layers at zdim 256, reverse; f32 sums in another
    order, tolerance 1e-5 relative / 1e-4 absolute."""
    rng = np.random.RandomState(3)
    z = rng.randn(3, 4, 256).astype(np.float32)
    jflow = JaxPerPartFlow(n_class=4, depth=2, dim=256, intermediate_dim=256)
    params = randomize(jflow.init(jax.random.PRNGKey(0), jnp.asarray(z), reverse=True)["params"], 4)
    want = np.asarray(jflow.apply({"params": params}, jnp.asarray(z), reverse=True))

    flow = PerPartFlow(4, 2, 256, 256, device="cpu")
    load_jax_params(flow, params)
    with torch.no_grad():
        got = t2n(flow(torch.as_tensor(z), reverse=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


ALIGNER = dict(
    in_channels=256, out_channels=6, n_class=4, d_head=32, depth=1, n_heads=8,
    single_attn=True, class_cond=True, add_class_cond=True, cimle=True,
    noise_scale=100, cond_noise_type=0,
)


def test_aligner_matches_jax():
    """CIMLE noise type 0 at noise_scale 100 with the noise injected, a part
    absent in one row; tolerance 1e-4 (f32, sums in another order)."""
    rng = np.random.RandomState(5)
    code = rng.randn(3, 4, 256).astype(np.float32)
    valid = np.array([[1, 1, 1, 1], [0, 1, 1, 1], [1, 1, 0, 0]], np.float32)
    noise = rng.randn(3, 32).astype(np.float32)
    jal = JaxAligner(**ALIGNER)
    jin = [jnp.asarray(a) for a in (code, valid, noise)]
    params = randomize(jal.init(jax.random.PRNGKey(0), *jin)["params"], 6)
    want = [np.asarray(a) for a in jal.apply({"params": params}, *jin)]

    al = PartAlignerTransformer(**ALIGNER, device="cpu")
    load_jax_params(al, params)
    with torch.no_grad():
        got = [t2n(a) for a in al(*[torch.as_tensor(a) for a in (code, valid, noise)])]
    for g, w in zip(got, want):
        assert g.shape == (3, 4, 3)
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


def test_other_aligner_noise_types_raise():
    """Noise type 2 raised until it was ported: adaLN from the noise in
    every block, against JAX at the shipped aligner's widths. Tolerance 1e-4
    as for type 0."""
    cfg = dict(ALIGNER, cond_noise_type=2)
    rng = np.random.RandomState(15)
    code = rng.randn(3, 4, 256).astype(np.float32)
    valid = np.array([[1, 1, 1, 1], [0, 1, 1, 1], [1, 1, 0, 0]], np.float32)
    noise = rng.randn(3, 32).astype(np.float32)
    jal = JaxAligner(**cfg)
    jin = [jnp.asarray(a) for a in (code, valid, noise)]
    params = randomize(jal.init(jax.random.PRNGKey(0), *jin)["params"], 16)
    want = [np.asarray(a) for a in jal.apply({"params": params}, *jin)]
    al = PartAlignerTransformer(**cfg, device="cpu")
    load_jax_params(al, params)
    with torch.no_grad():
        got = [t2n(a) for a in al(*[torch.as_tensor(a) for a in (code, valid, noise)])]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
