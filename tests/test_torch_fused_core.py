"""The port's denoiser trunk (difffacto_torch/ops/fused_core.py) against the
TPU kernel it replaces (difffacto_tpu/ops/fused_core.py). The CUDA kernel is
held against the plain version in tests/test_torch_gpu.py."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp

from difffacto_tpu.ops.fused_core import fused_denoiser_core_call
from difffacto_torch.ops import fused_core as fc

H, DH, M = 8, 16, 4


def jax_trunk(inp, heads=H):
    """The Pallas kernel in interpret mode, with the block-diagonal K/V the
    JAX denoiser builds (difffacto_tpu/models/denoiser.py:217-234) for
    ``heads`` heads of 128 / heads channels."""
    depth, B = inp["k"].shape[:2]
    dh = H * DH // heads
    eye = np.eye(heads, dtype=np.float32)
    k = inp["k"].reshape(depth, B, M, heads, dh)
    v = inp["v"].reshape(depth, B, M, heads, dh)
    k_bd = np.einsum("ibmhd,gh->ibgdhm", k, eye).reshape(depth, B, heads * dh, heads * M)
    v_bd = np.einsum("ibmhd,hg->ibhmgd", v, eye).reshape(depth, B, heads * M, heads * dh)
    j = {k_: jnp.asarray(v_) for k_, v_ in inp.items()}
    out = fused_denoiser_core_call(
        j["x"], jnp.asarray(k_bd), jnp.asarray(v_bd), jnp.asarray(np.tile(inp["mask"], (1, heads))),
        jnp.asarray(np.kron(eye, np.ones((M, M), np.float32))),
        j["pre_scale"], j["pre_bias"], j["post_scale"], j["post_bias"],
        j["n2_scale"], j["n2_bias"], j["wq"], j["wout"], j["bout"],
        j["ff_scale"], j["ff_bias"], j["w1"], j["b1"], j["w2"], j["b2"],
        dh**-0.5, interpret=True, pin_w=j["pin_w"], pin_b=j["pin_b"],
    )
    return np.asarray(out)


def test_reference_matches_pallas_kernel():
    """f32, one batch row with a part absent; the 2e-4 band of
    tests/test_ops.py::TestFusedDenoiserCore (f32 sums in another order)."""
    inp = fc.example_inputs(B=2, N=128, depth=2, mask=[[1, 1, 1, 1], [1, 0, 1, 1]])
    want = jax_trunk(inp)
    got = fc.fused_core_reference(*fc.operands(inp), DH**-0.5).numpy()
    assert got.shape == (2, 128, H * DH)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_absent_part_is_ignored():
    """K/V of a masked part token do not reach the output (exactly)."""
    inp = fc.example_inputs(B=2, N=64, depth=2, mask=[[1, 1, 1, 1], [1, 0, 1, 1]])
    base = fc.fused_core_reference(*fc.operands(inp), DH**-0.5)
    inp["k"][:, 1, 1] += 100.0
    inp["v"][:, 1, 1] -= 50.0
    moved = fc.fused_core_reference(*fc.operands(inp), DH**-0.5)
    assert torch.equal(base, moved)
    inp["k"][:, 0, 1] += 100.0  # the same part is present in row 0
    assert not torch.equal(base[0], fc.fused_core_reference(*fc.operands(inp), DH**-0.5)[0])


def test_cpu_wrapper_runs_plain_version_without_counting():
    inp = fc.example_inputs(B=1, N=32, depth=1)
    before = fc.launches
    out = fc.fused_core(*fc.operands(inp), DH**-0.5)
    assert fc.launches == before
    assert torch.equal(out, fc.fused_core_reference(*fc.operands(inp), DH**-0.5))
