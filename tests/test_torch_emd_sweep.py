"""The EMD kernel's arithmetic and the FF kernel's walk, on the CPU.

``csrc/emd_hybrid.cu`` runs its Sinkhorn in base 2 with each sum shifted by
the point's own potential from the previous sweep (no running max), redoing a
point with the exact max when its sum leaves a band, with a share of its
exp2s in software (``exp2_soft``), and its bids as a warp's job (lanes over
strided objects, then a butterfly). ``ops/emd_hybrid.py`` models them:
``sinkhorn_log2_reference``, ``exp2_soft_reference`` and
``best_two_strided``. Here the first is held against the plain Sinkhorn (with
the soft exp2 in none, some or all of a sweep step's terms) and, through the
auction, against the Pallas kernel in interpret mode; the second against
float64 to ``ex2.approx``'s accuracy; the third against the serial
``_best_two`` exactly, ties included. The FF kernel at D = 128 walks
``ops/fused_core.py:schedule(1, T, sms)``: every token once.
"""

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

torch.set_num_threads(1)

import jax.numpy as jnp

from difffacto_tpu.ops.emd_pallas import emd_assignment_hybrid as jax_hybrid
from difffacto_torch.ops import emd_hybrid as eh
from difffacto_torch.ops import fused_core as fc

TABLE = eh.eps_schedule(150, 30, 0.002, 0.05, 0.4)
# Both Sinkhorns run in f32 from g = 0 through the same 150 maps, one in base 2
# with a shift, the other in base e with a max: g agrees to f32 rounding
# carried through the iterations (1.5e-6 seen with all rows, |g| < 0.6; 1.1e-5
# with half the rows, where columns no sampled row is near reach |g| = 2.2).
G_RTOL = G_ATOL = 1e-5


def pair(B, n, seed, scale=0.3):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, n, 3).astype(np.float32) * scale,
            rng.randn(B, n, 3).astype(np.float32) * scale)


def normalized(B, n, seed):
    """Seeded clouds with random axis scales, bbox-normalized as the eval
    protocol normalizes its clouds."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(B, n, 3) * rng.uniform(0.3, 1.0, (B, 1, 3))).astype(np.float32)
    lo, hi = x.min(axis=1, keepdims=True), x.max(axis=1, keepdims=True)
    return (x - (lo + hi) / 2) / ((hi - lo).max(axis=-1, keepdims=True) / 2)


def distances(a, b):
    return eh.pair_distances(torch.as_tensor(a), torch.as_tensor(b))


@pytest.mark.parametrize("soft", [0, 3, eh.ROWS * eh.KSTEP])
@pytest.mark.parametrize("n, seed, rows", [(128, 3, 128), (256, 11, 256), (256, 7, 128)])
def test_log2_sweep_g_matches_the_plain_sinkhorn(n, seed, rows, soft):
    """All rows, and the subsampled Sinkhorn (the first ``rows`` rows); the
    soft exp2 in none, 3 or all of each sweep step's ROWS x KSTEP terms."""
    a, b = pair(2, n, seed)
    d = distances(a, b)[:, :rows]
    g, redone = eh.sinkhorn_log2_reference(d, TABLE, return_redone=True, soft=soft)
    want = eh.sinkhorn_reference(d, TABLE)
    assert g.shape == want.shape == (2, n) and len(redone) == 300
    err = (g - want).abs().max().item()
    print(f"n={n} rows={rows} soft={soft}: max |g - g_plain| {err:.3e} (|g| up to "
          f"{want.abs().max().item():.2f}), sweeps with a redo {sum(r > 0 for r in redone)}")
    np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=G_RTOL, atol=G_ATOL)
    if soft:  # the soft terms moved g, within f32 rounding
        exact = eh.sinkhorn_log2_reference(d, TABLE)
        assert 0 < (g - exact).abs().max().item() <= G_ATOL


# ex2.approx.ftz.f32's relative error (PTX ISA), which the soft exp2 keeps.
EX2_REL = 2.0**-22


def test_exp2_soft_within_ex2_approx_accuracy():
    """Every multiple of 2^-12 in [-126, 0] (so every integer and half
    integer) and 10^6 random float32 values there: relative error at most
    2^-22 against float64, exact at the integers."""
    grid = np.linspace(-126.0, 0.0, 126 * 4096 + 1)
    rand = np.random.RandomState(0).uniform(-126.0, 0.0, 10**6)
    z = np.concatenate([grid, rand]).astype(np.float32)
    got = eh.exp2_soft_reference(torch.as_tensor(z)).double().numpy()
    want = np.exp2(z.astype(np.float64))
    rel = np.abs(got / want - 1)
    print(f"max relative error {rel.max():.3e} = 2^{np.log2(rel.max()):.2f}")
    assert rel.max() <= EX2_REL
    ints = np.arange(-126, 1, dtype=np.float32)
    assert np.array_equal(eh.exp2_soft_reference(torch.as_tensor(ints)).numpy(),
                          np.exp2(ints.astype(np.float64)).astype(np.float32))


def test_exp2_soft_flushes_below_2_to_the_minus_126():
    """As ex2.approx.ftz: a result below 2^-126 is 0, exactly, down past
    the clamp at -127; at -126 the result is 2^-126."""
    z = np.concatenate([np.linspace(-126.0, -1000.0, 20001)[1:], [-127.0, -126.5, -3.0e38,
                                                                    -np.inf]]).astype(np.float32)
    got = eh.exp2_soft_reference(torch.as_tensor(z))
    assert (got == 0).all() and not torch.signbit(got).any()
    assert eh.exp2_soft_reference(torch.tensor([-126.0])).item() == 2.0**-126


def _soft_by_the_kernels_loop(n, count, others, soft):
    """The terms the kernel's loops give the soft exp2: thread tid's slot r of
    the pass at base holds point base + r T + tid, where it is below count,
    and at step k its term u is against point k + u of the other axis."""
    T = eh.sweep_threads(n)
    mask = np.zeros((count, others), bool)
    for base in range(0, count, eh.ROWS * T):
        for r in range(eh.ROWS):
            i = base + r * T + np.arange(T)
            for u in range(eh.KSTEP):
                if (eh.ROWS - 1 - r) * eh.KSTEP + u < soft:
                    mask[i[i < count][:, None], np.arange(u, others, eh.KSTEP)] = True
    return mask


@pytest.mark.parametrize("n, m", [(2048, 2048), (2048, 1024), (8192, 8192), (8192, 2048),
                                  (384, 384), (512, 256)])
def test_sweep_counts_follow_the_kernels_loops(n, m):
    for soft in (0, 1, 3, 4, 5, 16):
        for count, others in ((m, n), (n, m)):
            assert np.array_equal(eh.soft_mask(n, count, others, soft).numpy(),
                                  _soft_by_the_kernels_loop(n, count, others, soft))
    counts = eh.sweep_counts(3, n, m, 150, 3)
    soft = _soft_by_the_kernels_loop(n, m, n, 3).sum() + _soft_by_the_kernels_loop(n, n, m, 3).sum()
    assert counts == {"emd.sweep_terms": 3 * 150 * 2 * m * n, "emd.sweep_soft_terms": 3 * 150 * soft}
    if m == n:  # 3 terms of each 16
        assert 16 * counts["emd.sweep_soft_terms"] == 3 * counts["emd.sweep_terms"]


def test_shift_keeps_every_sum_in_band_on_normalized_clouds():
    """On clouds shaped like the protocol's, the previous sweep's potential is
    a shift good enough for every point of every sweep: the redo list stays
    empty."""
    a, b = normalized(2, 256, 1), normalized(2, 256, 2)
    _, redone = eh.sinkhorn_log2_reference(distances(a, b), TABLE, return_redone=True)
    assert redone == [0] * 300


def test_guard_redoes_every_row_of_far_apart_clouds():
    """Clouds 5 apart: at the first sweep (g = 0, f = 0) every term 2^(-c d)
    underflows, so every row goes to the redo with the exact max, and g still
    follows the plain Sinkhorn (|g| up to 1.9 here)."""
    a, b = pair(2, 256, 5)
    d = distances(a, b + 5.0)
    g, redone = eh.sinkhorn_log2_reference(d, TABLE, return_redone=True)
    assert redone[0] == 2 * 256
    np.testing.assert_allclose(g.numpy(), eh.sinkhorn_reference(d, TABLE).numpy(), atol=5e-5)


@pytest.mark.parametrize("sweeps", [(60, 61), (0,), (299,)])
def test_forced_redo_gives_the_shifted_result(sweeps):
    """Sweeps 60 and 61 are the first iteration after an eps step (x 0.4 at
    k = 30): redoing every point there with the exact max, or at the first or
    the last sweep, changes g only by f32 rounding (8e-8 seen)."""
    a, b = pair(1, 128, 9)
    d = distances(a, b)
    g, redone = eh.sinkhorn_log2_reference(d, TABLE, force_redo=sweeps, return_redone=True)
    assert all(redone[s] == 128 for s in sweeps)
    free = eh.sinkhorn_log2_reference(d, TABLE)
    assert (g - free).abs().max().item() <= 1e-6


@pytest.fixture(scope="module")
def log2_and_pallas_256():
    """The log2 sweep's assignment through the plain auction, and the Pallas
    kernel in interpret mode, on the pairs of tests/test_ops.py (seed 11)."""
    a, b = pair(2, 256, 11)
    d = distances(a, b)
    g = eh.sinkhorn_log2_reference(d, TABLE)
    assign, rounds, bids = eh.auction_reference(d, g, 300, 0.002)
    pallas = np.asarray(jax_hybrid(jnp.asarray(a), jnp.asarray(b), tile=128, interpret=True))
    return a, b, assign.numpy(), rounds.numpy(), bids.numpy(), pallas


def _cost(a, b, assign):
    return np.stack([np.sqrt(((a[i] - b[i][assign[i]]) ** 2).sum(-1)).mean()
                     for i in range(len(a))])


def test_log2_assignment_cost_within_1_percent_of_pallas_kernel(log2_and_pallas_256):
    """As tests/test_torch_emd.py holds the plain version: both eps-optimal,
    so the costs agree within 1 %."""
    a, b, assign, _, _, pallas = log2_and_pallas_256
    print(f"share of equal assignments: {(assign == pallas).mean():.4f}")
    np.testing.assert_allclose(_cost(a, b, assign), _cost(a, b, pallas), rtol=0.01)


def test_log2_assignment_is_bijective_and_near_hungarian(log2_and_pallas_256):
    a, b, assign, rounds, bids, _ = log2_and_pallas_256
    assert ((256 + rounds - 1 <= bids) & (bids <= 256 * (rounds + 1))).all()
    got = _cost(a, b, assign)
    for i in range(2):
        d = np.sqrt(((a[i][:, None] - b[i][None]) ** 2).sum(-1))
        ri, ci = linear_sum_assignment(d)
        assert len(np.unique(assign[i])) == 256
        assert got[i] <= 1.01 * d[ri, ci].mean()


def _ties(kind, B, R, n, seed):
    """(d, price) whose values -d - price hold ties of the given kind."""
    rng = np.random.RandomState(seed)
    if kind == "random":
        d, price = rng.rand(B, R, n), rng.rand(B, n)
    elif kind == "few_levels":  # equal values at many indices, in every lane
        d, price = rng.randint(0, 4, (B, R, n)) * 0.25, np.zeros((B, n))
    elif kind == "best_across_lanes":  # the best value at several lanes and rounds
        d = rng.rand(B, R, n) + 1.0
        for r in range(R):
            d[:, r, rng.choice(n, 5, replace=False)] = 0.5
        price = np.zeros((B, n))
    elif kind == "best_in_one_lane":  # the best twice in one lane, the second elsewhere
        d = rng.rand(B, R, n) + 1.0
        d[:, :, 3] = d[:, :, 3 + 32] = 0.25
        d[:, :, 10] = 0.5
        price = np.zeros((B, n))
    elif kind == "all_equal":
        d, price = np.full((B, R, n), 0.75), np.zeros((B, n))
    else:  # "price_ties": distances and prices that add up to equal values
        d = rng.randint(0, 3, (B, R, n)) * 0.5
        price = rng.randint(0, 3, (B, n)) * 0.5
    return torch.as_tensor(d, dtype=torch.float32), torch.as_tensor(price, dtype=torch.float32)


@pytest.mark.parametrize("kind", ["random", "few_levels", "best_across_lanes",
                                  "best_in_one_lane", "all_equal", "price_ties"])
@pytest.mark.parametrize("n", [64, 256])
def test_best_two_strided_equals_the_serial_scan(kind, n):
    """The warp's (best, index, second) is the serial scan's exactly: the
    lowest index among equal values, and the best among the other objects
    (equal to the best where it repeats)."""
    d, price = _ties(kind, 2, n, n, seed=n)
    lane = torch.arange(n, dtype=torch.int32)
    want = eh._best_two(d, price, lane)
    got = eh.best_two_strided(d, price)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    if kind == "all_equal":
        assert (got[1] == 0).all() and torch.equal(got[0], got[2])


@pytest.mark.parametrize("lanes", [4, 8])
def test_best_two_strided_at_other_lane_counts(lanes):
    d, price = _ties("few_levels", 1, 64, 64, seed=lanes)
    want = eh._best_two(d, price, torch.arange(64, dtype=torch.int32))
    for g, w in zip(eh.best_two_strided(d, price, lanes=lanes), want):
        assert torch.equal(g, w)


def _ff_walk(T, sms):
    """The tokens each thread block of the FF kernel takes: tiles
    block, block + grid, ... of schedule(1, T, sms), 128 tokens each, cut at T."""
    s = fc.schedule(1, T, sms)
    tokens = []
    for block in range(s["grid"]):
        for tile in range(block, s["total_tiles"], s["grid"]):
            assert tile // s["tiles_per_row"] == 0  # one row: B = 1
            start = fc.TILE * (tile % s["tiles_per_row"])
            tokens.append(np.arange(start, min(start + fc.TILE, T)))
    return s, np.concatenate(tokens)


@pytest.mark.parametrize("T, sms", [(1, 132), (100, 132), (128, 132), (129, 132), (1000, 132),
                                    (16 * 2048 + 5, 132), (524288, 132), (524288, 114)])
def test_ff_walk_covers_every_token_once(T, sms):
    """T below one tile, exactly one, one past it, ragged T, and the
    two-attention denoiser's T = 256 x 2048 (4096 tiles, 31 or 32 a block)."""
    s, tokens = _ff_walk(T, sms)
    assert s["grid"] == min(sms, -(-T // fc.TILE))
    assert len(tokens) == T and np.array_equal(np.sort(tokens), np.arange(T))
