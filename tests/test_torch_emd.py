"""The port's EMD (difffacto_torch/ops/emd.py, emd_hybrid.py) against the JAX
package on the same numpy clouds.

The auction is held to JAX's assignment for assignment. The plain version of
the Sinkhorn+auction hybrid is held as tests/test_ops.py holds the Pallas
kernel (bijective, within 1.01 x the Hungarian optimum) and against that
kernel in interpret mode. The CUDA kernel is held against the plain version
in tests/test_torch_gpu.py.
"""

import importlib

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from difffacto_tpu.ops.emd_pallas import emd_assignment_hybrid as jax_hybrid
from difffacto_torch.ops import emd as te
from difffacto_torch.ops import emd_hybrid as th
from difffacto_torch.utils import trace

je = importlib.import_module("difffacto_tpu.ops.emd")  # the module, not the function


def pair(B, n, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, n, 3).astype(np.float32) * 0.3,
            rng.randn(B, n, 3).astype(np.float32) * 0.3)


def mean_cost(a, b, assign):
    return np.stack([
        np.sqrt(((a[i] - b[i][assign[i]]) ** 2).sum(-1)).mean() for i in range(len(a))
    ])


@pytest.mark.parametrize("n", [64, 128])
def test_auction_equals_jax_assignment(n):
    """eps 0.002, 200 iterations: the same bids, winners and evictions give the
    same assignment; the matched squared distances then agree to f32 rounding."""
    a, b = pair(2, n, n)
    dist_j, assign_j = je.emd(jnp.asarray(a), jnp.asarray(b), 0.002, 200)
    dist_t, assign_t = te.emd(torch.as_tensor(a), torch.as_tensor(b), 0.002, 200)
    np.testing.assert_array_equal(assign_t.numpy(), np.asarray(assign_j))
    np.testing.assert_allclose(dist_t.numpy(), np.asarray(dist_j), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        te.emd_cost(torch.as_tensor(a), torch.as_tensor(b), 0.002, 200).numpy(),
        np.asarray(je.emd_cost(jnp.asarray(a), jnp.asarray(b), 0.002, 200)), rtol=1e-6,
    )


def test_auction_single_takes_one_matrix_and_a_batch():
    a, b = pair(2, 64, 5)
    d = torch.cdist(torch.as_tensor(a), torch.as_tensor(b))
    batch, price = te._auction_single(d, 0.002, 200)
    one, price0 = te._auction_single(d[0], 0.002, 200)
    assert batch.shape == (2, 64) and one.shape == (64,) and price0.shape == (64,)
    torch.testing.assert_close(one, batch[0])
    torch.testing.assert_close(price0, price[0])
    want, _ = je._auction_single(jnp.asarray(d[0].numpy()), 0.002, 200)
    np.testing.assert_array_equal(one.numpy(), np.asarray(want))


def test_auction_force_assigns_on_the_last_iteration():
    """Three iterations cannot seat 64 points: the last one assigns every
    remaining bidder to its bid, as JAX does."""
    a, b = pair(1, 64, 6)
    _, assign_j = je.emd(jnp.asarray(a), jnp.asarray(b), 0.002, 3)
    _, assign_t = te.emd(torch.as_tensor(a), torch.as_tensor(b), 0.002, 3)
    assert (assign_t >= 0).all()
    np.testing.assert_array_equal(assign_t.numpy(), np.asarray(assign_j))


def test_emd_backward_matches_jax_vjp():
    """The gradient goes to xyz1 only: 2 (x1 - matched) g. Same assignment on
    both sides, so the two agree to f32 rounding."""
    a, b = pair(2, 64, 7)
    g = np.random.RandomState(8).randn(2, 64).astype(np.float32)
    _, vjp = jax.vjp(lambda p, q: je.emd(p, q, 0.005, 50)[0], jnp.asarray(a), jnp.asarray(b))
    g1_j, g2_j = vjp(jnp.asarray(g))
    ta = torch.as_tensor(a).requires_grad_()
    tb = torch.as_tensor(b).requires_grad_()
    dist, assign = te.emd(ta, tb, 0.005, 50)
    assert not assign.requires_grad
    (dist * torch.as_tensor(g)).sum().backward()
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(g1_j), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(tb.grad.numpy(), np.asarray(g2_j))
    assert not np.asarray(g2_j).any()


@pytest.fixture(scope="module")
def hybrid_256():
    """Both hybrids at n = 256 on the pairs of tests/test_ops.py (seed 11)."""
    a, b = pair(2, 256, 11)
    plain, rounds, bids = th.emd_assignment_hybrid_reference(
        torch.as_tensor(a), torch.as_tensor(b), return_work=True
    )
    pallas = jax_hybrid(jnp.asarray(a), jnp.asarray(b), tile=128, interpret=True)
    return a, b, plain.numpy(), (rounds.numpy(), bids.numpy()), np.asarray(pallas)


def test_hybrid_reference_is_bijective_and_near_hungarian(hybrid_256):
    a, b, plain, (rounds, bids), _ = hybrid_256
    assert plain.dtype == np.int32 and plain.shape == (2, 256)
    assert ((1 <= rounds) & (rounds <= 300)).all()
    # Every row bids in round 1, at least one row in each later round, and
    # never more than all rows a round (plus the force-assigned ones).
    assert ((256 + rounds - 1 <= bids) & (bids <= 256 * (rounds + 1))).all()
    print(f"rounds {rounds.tolist()}, bids {bids.tolist()} of {(256 * rounds).tolist()}")
    got = mean_cost(a, b, plain)
    for i in range(2):
        d = np.sqrt(((a[i][:, None] - b[i][None]) ** 2).sum(-1))
        ri, ci = linear_sum_assignment(d)
        assert len(np.unique(plain[i])) == 256, "not bijective"
        assert got[i] <= d[ri, ci].mean() * 1.01, f"cost {got[i]} vs optimal {d[ri, ci].mean()}"


def test_hybrid_reference_cost_within_1_percent_of_pallas_kernel(hybrid_256):
    """The two compute distances and the log-sum-exp in another order (direct
    differences against |x|^2 + |y|^2 - 2xy), so near-ties may land on other
    objects; both are eps-optimal, so the costs agree within 1 %."""
    a, b, plain, _, pallas = hybrid_256
    print(f"share of equal assignments: {(plain == pallas).mean():.4f}")
    np.testing.assert_allclose(mean_cost(a, b, plain), mean_cost(a, b, pallas), rtol=0.01)


def test_hybrid_wrapper_runs_the_plain_version_on_cpu_tensors(hybrid_256):
    a, b, plain, _, _ = hybrid_256
    before = trace.counters()
    got = th.emd_assignment_hybrid(torch.as_tensor(a), torch.as_tensor(b))
    assert trace.counters() == before  # no kernel for a CPU tensor
    np.testing.assert_array_equal(got.numpy(), plain)
    with pytest.raises(TypeError):  # the TPU kernel's scheduling knobs have no counterpart
        th.emd_assignment_hybrid(torch.as_tensor(a), torch.as_tensor(b), auction_chunk=8)
    with pytest.raises(ValueError):
        th.emd_assignment_hybrid(torch.zeros(1, 100, 3), torch.zeros(1, 100, 3))


def test_hybrid_wrapper_work_on_cpu_tensors_has_no_kernel_sinkhorn(hybrid_256):
    """With ``return_work`` the wrapper gives the plain version's rounds and
    bids on CPU tensors, and no kernel Sinkhorn work (None): there is no
    device clock and no soft exp2 on the CPU."""
    a, b, plain, (rounds, bids), _ = hybrid_256
    got, got_rounds, got_bids, sinkhorn = th.emd_assignment_hybrid(
        torch.as_tensor(a), torch.as_tensor(b), return_work=True)
    np.testing.assert_array_equal(got.numpy(), plain)
    np.testing.assert_array_equal(got_rounds.numpy(), rounds)
    np.testing.assert_array_equal(got_bids.numpy(), bids)
    assert sinkhorn is None


def test_hybrid_subsampled_sinkhorn_stays_in_band():
    """Half the rows in the warm start (n = 512, m = 256): the auction absorbs
    the cheaper start, as tests/test_ops.py asks of the Pallas kernel."""
    a, b = pair(1, 512, 13)
    got = th.emd_assignment_hybrid_reference(
        torch.as_tensor(a), torch.as_tensor(b), sinkhorn_rows=256, auction_iters=600
    ).numpy()
    d = np.sqrt(((a[0][:, None] - b[0][None]) ** 2).sum(-1))
    ri, ci = linear_sum_assignment(d)
    assert 512 - len(np.unique(got[0])) <= 3, "far from bijective"
    assert abs(mean_cost(a, b, got)[0] / d[ri, ci].mean() - 1.0) <= 0.015


def test_eps_schedule_is_the_pallas_kernels():
    e = th.eps_schedule(150, 30, 0.002, 0.05, 0.4)
    assert e.dtype == np.float32 and e.shape == (150,)
    want = np.maximum(0.05 * 0.4 ** (np.arange(150) // 30), 0.002)
    np.testing.assert_allclose(e, want, rtol=1e-6)
    assert e[0] == np.float32(0.05) and e[-1] == np.float32(0.002)


def test_emd_cost_eval_routing(monkeypatch):
    """As tests/test_ops.py::test_emd_cost_eval_routing: the hybrid agrees with
    the auction to metric accuracy (rtol 0.03), and with JAX's own hybrid in
    interpret mode (rtol 0.01, both eps-optimal)."""
    rng = np.random.RandomState(12)
    a = (rng.randn(2, 256, 3) * 0.3).astype(np.float32)
    b = (rng.randn(2, 256, 3) * 0.3).astype(np.float32)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    monkeypatch.delenv("DIFFFACTO_EMD_IMPL", raising=False)
    assert te.resolved_emd_eval_config(256, "cpu")[0] == "auction"
    assert te.resolved_emd_eval_config(256, "cuda")[0] == "hybrid"
    assert te.resolved_emd_eval_config(200, "cuda")[0] == "auction"
    auction = te.emd_cost_eval(ta, tb, 0.002, 1500).numpy()
    monkeypatch.setenv("DIFFFACTO_EMD_IMPL", "hybrid")
    assert te.resolved_emd_eval_config(256, "cpu")[0] == "hybrid"
    assert te.resolved_emd_eval_config(200, "cpu")[0] == "auction"
    hybrid = te.emd_cost_eval(ta, tb, 0.002, 1500).numpy()
    np.testing.assert_allclose(hybrid, auction, rtol=0.03)
    monkeypatch.setenv("DIFFFACTO_PALLAS_INTERPRET", "1")
    jax_hybrid_cost = np.asarray(je.emd_cost_eval(jnp.asarray(a), jnp.asarray(b), 0.002, 1500))
    np.testing.assert_allclose(hybrid, jax_hybrid_cost, rtol=0.01)


def test_resolved_config_reads_the_knobs(monkeypatch):
    for name, value in (("IMPL", "auction"), ("SINKHORN_ITERS", "40"), ("AUCTION_ITERS", "70"),
                        ("SINKHORN_ROWS", "256")):
        monkeypatch.setenv(f"DIFFFACTO_EMD_{name}", value)
    assert te.resolved_emd_eval_config(2048, "cuda") == ("auction", 40, 70, 256)
    # The TPU kernel's cache and scheduling knobs have no counterpart: setting
    # them changes nothing, so it cannot miss a ref_self_cache either.
    monkeypatch.setenv("DIFFFACTO_EMD_AUCTION_CACHE", "0")
    monkeypatch.setenv("DIFFFACTO_EMD_AUCTION_CHUNK", "4")
    assert te.resolved_emd_eval_config(2048, "cuda") == ("auction", 40, 70, 256)
