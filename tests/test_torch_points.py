"""The port's point ops and Chamfer (difffacto_torch/ops/points.py, fps.py,
chamfer.py) against the JAX package on the same numpy clouds.

The JAX tests do not run the Pallas FPS in interpret mode, so the XLA path
``difffacto_tpu.ops.points.furthest_point_sample`` is the reference, as
``fps_auto`` uses it off the TPU. The CUDA kernel is held against the plain
version in tests/test_torch_gpu.py.
"""

import importlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp

from difffacto_torch.ops import chamfer as tc
from difffacto_torch.ops import fps as tfps
from difffacto_torch.ops import points as tp
from difffacto_torch.utils import trace

# ``difffacto_tpu.ops`` re-exports functions named like its modules.
jp = importlib.import_module("difffacto_tpu.ops.points")
jc = importlib.import_module("difffacto_tpu.ops.chamfer")

# f32 on both sides; the products sum in another order, and |x|^2 + |y|^2 - 2xy
# cancels for near points, so an absolute term goes with the relative one.
RTOL, ATOL = 1e-5, 1e-5


def clouds(B, N, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(B, N, 3) * scale).astype(np.float32)


def test_square_distance_matches_jax():
    a, b = clouds(2, 96, 0), clouds(2, 70, 1)
    want = np.asarray(jp.square_distance(jnp.asarray(a), jnp.asarray(b)))
    got = tp.square_distance(torch.as_tensor(a), torch.as_tensor(b))
    assert got.dtype == torch.float32 and got.shape == (2, 96, 70)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_square_distance_restores_the_tf32_flag():
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tp.square_distance(torch.zeros(1, 4, 3), torch.zeros(1, 4, 3))
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def test_gathers_match_jax():
    rng = np.random.RandomState(2)
    feats = rng.randn(2, 5, 40).astype(np.float32)
    idx = rng.randint(0, 40, size=(2, 17)).astype(np.int32)
    want = np.asarray(jp.gather_points(jnp.asarray(feats), jnp.asarray(idx)))
    got = tp.gather_points(torch.as_tensor(feats), torch.as_tensor(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    pts = np.ascontiguousarray(feats.transpose(0, 2, 1))
    want = np.asarray(jp.gather_points_nd(jnp.asarray(pts), jnp.asarray(idx)))
    got = tp.gather_points_nd(torch.as_tensor(pts), torch.as_tensor(idx))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("duplicated", [False, True])
def test_fps_equals_jax_index_for_index(duplicated):
    """(3, 512 -> 64). With the second half a copy of the first, every step
    has exact ties, which go to the lowest index on both sides."""
    x = clouds(3, 512, 3)
    if duplicated:
        x[:, 256:] = x[:, :256]
    want = np.asarray(jp.furthest_point_sample(jnp.asarray(x), 64))
    ref = tfps.furthest_point_sample_reference(torch.as_tensor(x), 64)
    assert ref.dtype == torch.int32
    np.testing.assert_array_equal(ref.numpy(), want)
    sub, idx = tp.fps(torch.as_tensor(x), 64, ret_id=True)
    np.testing.assert_array_equal(idx.numpy(), want)
    np.testing.assert_array_equal(sub.numpy(), np.take_along_axis(x, want[..., None], axis=1))
    np.testing.assert_array_equal(
        tp.fps(torch.as_tensor(x), 64).numpy(), np.asarray(jp.fps(jnp.asarray(x), 64))
    )


def test_fps_with_fewer_distinct_points_than_samples():
    """16 distinct points repeated to 64, 32 samples: once the 16 are taken
    all distances are 0 and index 0 repeats, as jnp.argmax gives."""
    x = np.tile(clouds(2, 16, 4), (1, 4, 1))
    want = np.asarray(jp.furthest_point_sample(jnp.asarray(x), 32))
    got = tfps.furthest_point_sample(torch.as_tensor(x), 32).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:, 16:] == 0).all()


def test_fps_launches_no_kernel_on_cpu_tensors():
    before = trace.counters()
    tfps.furthest_point_sample(torch.as_tensor(clouds(1, 32, 5)), 4)
    assert trace.counters() == before
    with pytest.raises(ValueError):
        tfps.furthest_point_sample(torch.zeros(2, 8), 4)


def test_assign_anchor_matches_jax():
    a, anchors = clouds(2, 80, 6), clouds(2, 4, 7)
    want = np.asarray(jp.assign_anchor(jnp.asarray(a), jnp.asarray(anchors)))
    got = tp.assign_anchor(torch.as_tensor(a), torch.as_tensor(anchors))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_chamfer_split_l2_l1_match_jax():
    a, b = clouds(2, 96, 8), clouds(2, 64, 9)
    ja, jb, ta, tb = jnp.asarray(a), jnp.asarray(b), torch.as_tensor(a), torch.as_tensor(b)
    for got, want in zip(tc.chamfer_split(ta, tb), jc.chamfer_split(ja, jb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tc.chamfer_l2(ta, tb).numpy(), np.asarray(jc.chamfer_l2(ja, jb)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tc.chamfer_l1(ta, tb).numpy(), np.asarray(jc.chamfer_l1(ja, jb)),
                               rtol=1e-4, atol=ATOL)  # sqrt near 0 widens the relative error


def test_chamfer_split_tiled_matches_jax_and_untiled():
    a, b = clouds(2, 48, 10), clouds(2, 128, 11)
    want = jc.chamfer_split_tiled(jnp.asarray(a), jnp.asarray(b), 32)
    got = tc.chamfer_split_tiled(torch.as_tensor(a), torch.as_tensor(b), 32)
    whole = tc.chamfer_split(torch.as_tensor(a), torch.as_tensor(b))
    for g, w, u in zip(got, want, whole):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(g.numpy(), u.numpy(), rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError):
        tc.chamfer_split_tiled(torch.as_tensor(a), torch.as_tensor(b), 48)


def test_pairwise_chamfer_matches_jax():
    s, r = clouds(3, 64, 12), clouds(4, 64, 13)
    want = np.asarray(jc.pairwise_chamfer(jnp.asarray(s), jnp.asarray(r)))
    got = tc.pairwise_chamfer(torch.as_tensor(s), torch.as_tensor(r))
    assert got.shape == (3, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_chamfer_gradient_flows_through_min():
    a = torch.as_tensor(clouds(1, 16, 14), dtype=torch.float32).requires_grad_()
    b = torch.as_tensor(clouds(1, 16, 15))
    tc.chamfer_l2(a, b).sum().backward()
    assert torch.isfinite(a.grad).all() and a.grad.abs().sum() > 0
