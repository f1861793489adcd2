"""The FPS kernel's launch plan and its reduction (difffacto_torch/ops/fps.py,
csrc/fps.cu) on the CPU.

``plan`` decides the kernel's cluster size, threads and points a thread;
``furthest_point_sample_model`` runs the kernel's argmax the way it takes it (contiguous ownership, the warp's largest f32 bits
and then its lowest index, then the same over the cluster's candidates).
Both are held here: the plan against the rules it states, the model index
for index against the plain version and the JAX package's XLA FPS (the
reference ``tests/test_torch_points.py`` uses too). The kernel itself is
held against the plain version on the card (``tests/test_torch_gpu.py``).
"""

import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from difffacto_torch.ops import fps as tfps

jp = importlib.import_module("difffacto_tpu.ops.points")

SMS = 132  # an H100's SMs


def occupancy_cluster(B, N, sms=SMS):
    """The plan's cluster size before it grows to hold a cloud: doubled from
    1 while B * 2C blocks fit on the SMs, each keeps 2048 points, C <= 8."""
    C = 1
    while C < 8 and B * 2 * C <= sms and -(-N // (2 * C)) >= 2048:
        C *= 2
    return C


@pytest.mark.parametrize("B", [1, 32, 64, 132, 400])
@pytest.mark.parametrize("N", [256, 1000, 2048, 8192, 14528])
def test_plan_covers_every_point_once(B, N):
    """Every point of a cloud has exactly one (block, thread, slot); the
    cluster grows past its occupancy size exactly where that size's registers
    cannot hold the cloud, and then to the least size that holds it."""
    pl = tfps.plan(B, N, SMS)
    C0 = occupancy_cluster(B, N)
    C, npc, P, T = pl["cluster"], pl["points_per_block"], pl["points_per_thread"], pl["threads"]
    if N <= C0 * tfps.BLOCK_POINTS:
        assert C == C0
    else:
        assert C > C0 and N > (C // 2) * tfps.BLOCK_POINTS
    assert N <= C * tfps.BLOCK_POINTS and N <= tfps.REG_MAX_POINTS
    assert P in tfps.REG_POINTS and T % 32 == 0 and 32 <= T <= tfps.BLOCK_POINTS // P
    assert pl["grid"] == B * C and pl["smem_bytes"] <= 232448
    r, t, j = np.meshgrid(np.arange(C), np.arange(T), np.arange(P), indexing="ij")
    local = t * P + j
    index = r * npc + local
    owned = (local < npc) & (index < N)
    assert np.array_equal(np.sort(index[owned]), np.arange(N))


def test_plan_at_the_protocols_shapes():
    """64 clouds of 8192 take clusters of 2, 32 clouds 4, 132 and 400 one
    block a cloud (32 points a thread); one cloud of 16,384 a cluster of 8."""
    assert [tfps.plan(B, 8192, SMS)["cluster"] for B in (64, 32, 132, 400)] == [2, 4, 1, 1]
    assert tfps.plan(400, 8192, SMS)["points_per_thread"] == 32
    assert tfps.plan(64, 8192, SMS)["threads"] == 256
    assert tfps.plan(1, 16384, SMS)["cluster"] == 8


def test_plan_refuses_what_neither_path_holds():
    """A cloud past each block's shared copy (``REG_MAX_POINTS``), a cluster
    size the kernel does not take, and a forced cluster whose registers
    cannot hold the cloud are refused."""
    with pytest.raises(ValueError):
        tfps.plan(1, tfps.REG_MAX_POINTS + 1, SMS)
    with pytest.raises(ValueError):
        tfps.plan(4, 1000, SMS, cluster=3)
    with pytest.raises(ValueError):  # a forced cluster of 1 past one block's registers
        tfps.plan(4, tfps.BLOCK_POINTS + 1, SMS, cluster=1)


def test_float_bits_order_as_unsigned_for_non_negative_floats():
    """The kernel's argmax compares distances by their bits: for f32 >= 0,
    zero, subnormals and infinity included, the order of the bits as
    unsigned integers is the order of the values."""
    rng = np.random.RandomState(0)
    special = np.array([0.0, np.finfo(np.float32).smallest_subnormal, 1e-40, 1e-38,
                        np.finfo(np.float32).tiny, 1.0, np.nextafter(np.float32(1), 2),
                        np.finfo(np.float32).max, np.inf], np.float32)
    vals = np.concatenate([special, np.abs(rng.randn(400).astype(np.float32))
                           * np.float32(10.0) ** rng.randint(-30, 30, 400).astype(np.float32)])
    vals = np.abs(vals).astype(np.float32)
    bits = tfps.float_bits(torch.as_tensor(vals)).numpy()
    assert bits.min() >= 0 and bits.max() < 2**32
    v, b = vals[:, None], bits[:, None]
    np.testing.assert_array_equal(v < v.T, b < b.T)
    np.testing.assert_array_equal(v == v.T, b == b.T)


def clouds(case, B=3, N=5000):
    x = np.random.RandomState(7).randn(B, N, 3).astype(np.float32)
    if case == "duplicated":
        x[:, N // 2:] = x[:, :N // 2]
    elif case == "few_distinct":  # 40 distinct points, 64 samples: index 0 repeats
        x = np.tile(x[:, :40], (1, N // 40 + 1, 1))[:, :N]
    return x


@functools.lru_cache(maxsize=None)
def jax_fps(case, m):
    return np.asarray(jp.furthest_point_sample(jnp.asarray(clouds(case)), m))


@pytest.mark.parametrize("case", ["random", "duplicated", "few_distinct"])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_reduction_model_equals_reference_and_jax(case, cluster):
    """The kernel's reduction over contiguous runs, warps and the cluster
    gives the plain version's and JAX's indices, ties to the lowest index.
    5000 points: runs of 32 at a cluster of 1, of 16 at 2, 4 and 8."""
    x = torch.as_tensor(clouds(case))
    m = 64
    assert tfps.plan(3, 5000, SMS, cluster)["points_per_thread"] == (32 if cluster == 1 else 16)
    got = tfps.furthest_point_sample_model(x, m, cluster)
    want = tfps.furthest_point_sample_reference(x, m)
    assert got.dtype == torch.int32 and got.shape == (3, m)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.numpy(), jax_fps(case, m))
    if case == "few_distinct":
        assert (got[:, 40:] == 0).all()
