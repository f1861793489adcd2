"""The port's CUDA kernels on the card, each against its plain version.

These tests need a CUDA card and skip with a reason where there is none.
They import no JAX, so on a machine without it they run with
``python -m pytest --noconftest tests/test_torch_gpu.py -m gpu``.
"""

import numpy as np
import pytest
import torch

from difffacto_torch.ops import emd_hybrid as eh
from difffacto_torch.ops import fps as fps_mod
from difffacto_torch.ops import fused_block as fb
from difffacto_torch.ops import fused_core as fc
from difffacto_torch.ops import fused_core_train as fct
from difffacto_torch.ops import fused_ff as ff
from difffacto_torch.utils import trace

torch.set_num_threads(1)

DH = 16


def launched(*ops):
    """The recorder's count of each op's kernel launches: a number for one
    op, a tuple for several."""
    counts = trace.counters()
    got = tuple(counts.get(f"{op}.launches", 0) for op in ops)
    return got[0] if len(ops) == 1 else got

# bf16 kernel against the bf16 plain version: both round at the same points,
# but sums run in another order, so an intermediate may round one bf16 step
# (2^-8 relative) apart and carry through the blocks. The post-LN output
# reaches |4|, where one bf16 step is 2^-6: the max allows 8 such steps, the
# mean about 4x what an H100 showed (max 6.25e-2, mean 2.4e-4 at N=1000).
BF16_MAX_ABS, BF16_MEAN_ABS = 0.125, 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B, N, depth", [(2, 2048, 5), (2, 1000, 5), (32, 2048, 5), (1, 100, 5),
                                         (1, 1000, 5), (1, 300, 10)])
def test_fused_core_matches_plain_version(cuda, B, N, depth):
    """Depth 5 with a part absent in the last row: N a multiple of the tile
    and a ragged N; more tiles than twice the SMs, so that every block of the
    persistent grid walks several; an N shorter than one tile; fewer tiles
    than SMs; and depth 10, past the 8 blocks whose K and V the kernel holds
    at once."""
    sched = fc.schedule(B, N, torch.cuda.get_device_properties(cuda).multi_processor_count)
    if B == 32:
        assert sched["total_tiles"] > 2 * sched["grid"]
    mask = np.ones((B, fc.CTX), np.float32)
    mask[B - 1, 2] = 0.0
    args = fc.operands(fc.example_inputs(B, N, depth=depth, mask=mask), cuda, torch.bfloat16)
    before = launched("fused_core")
    got = fc.fused_core(*args, DH**-0.5)
    torch.cuda.synchronize()
    assert launched("fused_core") == before + 1
    want = fc.fused_core_reference(*args, DH**-0.5)
    assert got.shape == want.shape == (B, N, 128)
    assert torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs()
    print(f"fused_core B={B} N={N} depth={depth} ({sched['total_tiles']} tiles on "
          f"{sched['grid']} blocks): max abs err {err.max().item():.3e}, "
          f"mean {err.mean().item():.3e}")
    assert err.max().item() <= BF16_MAX_ABS and err.mean().item() <= BF16_MEAN_ABS


@pytest.mark.gpu
@pytest.mark.parametrize("B, N, depth", [(2, 2048, 5), (2, 1000, 5), (32, 2048, 5), (1, 300, 10)])
def test_fused_core_headless_matches_plain_version(cuda, B, N, depth):
    """The trunk without proj_in: h0 (B, N, 128) in, a part absent in the
    last row, a ragged N, many tiles a block and depth 10; counted in
    ``fused_core_headless.launches`` alone."""
    mask = np.ones((B, fc.CTX), np.float32)
    mask[B - 1, 1] = 0.0
    args = fc.operands(fc.example_inputs(B, N, depth=depth, in_ch=fc.D, mask=mask), cuda,
                       torch.bfloat16)
    x = (args[0].float() @ args[1].float() + args[2]).to(torch.bfloat16)
    rest = args[3:]
    before, before_core = launched("fused_core_headless"), launched("fused_core")
    got = fc.fused_core_headless(x, *rest, DH**-0.5)
    torch.cuda.synchronize()
    assert launched("fused_core_headless", "fused_core") == (before + 1, before_core)
    want = fc.fused_core_reference(x, None, None, *rest, DH**-0.5)
    assert got.shape == want.shape == (B, N, 128) and torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs()
    print(f"fused_core_headless B={B} N={N} depth={depth}: max abs err {err.max().item():.3e}, "
          f"mean {err.mean().item():.3e}")
    assert err.max().item() <= BF16_MAX_ABS and err.mean().item() <= BF16_MEAN_ABS


def _tail(out_ch, seed, device):
    rng = np.random.RandomState(seed)
    w = torch.as_tensor(rng.randn(fc.D, out_ch) * fc.D**-0.5, dtype=torch.bfloat16, device=device)
    b = torch.as_tensor(0.1 * rng.randn(out_ch), dtype=torch.float32, device=device)
    return w, b


@pytest.mark.gpu
@pytest.mark.parametrize("head", [True, False])
@pytest.mark.parametrize("B, N, depth, out_ch", [(2, 2048, 5, 3), (2, 1000, 5, 6),
                                                 (32, 2048, 5, 3), (1, 300, 10, 8),
                                                 (3, 100, 2, 1)])
def test_fused_core_tail_matches_plain_version(cuda, head, B, N, depth, out_ch):
    """proj_out fused (B, N, OUT) with and without the head: a part absent,
    a ragged N (the last tile's run shorter), many tiles a block, depth 10,
    OUT = 1, 3, 6 and 8; each entry counted in its own counter alone.

    The epilogue is held to one bf16 step against the plain proj_out of the
    same entry's trunk without the tail (the same kernel code before the
    epilogue, so the same rows; the 128-term f32 sums differ only in order).
    End to end the output carries the trunk's own difference from its plain
    version through one more product, and is held to the trunk's band up to
    depth 5; at depth 10 the trunk alone reads a mean of 8.4e-4 against the
    band's 1e-3 on an H100, and its tail 1.03e-3 at OUT = 8."""
    mask = np.ones((B, fc.CTX), np.float32)
    mask[B - 1, 2] = 0.0
    args = fc.operands(fc.example_inputs(B, N, depth=depth, in_ch=13 if head else fc.D,
                                         seed=N + out_ch, mask=mask), cuda, torch.bfloat16)
    if not head:
        args = [args[0]] + args[3:]
    pw, pb = _tail(out_ch, out_ch, cuda)
    entry = fc.fused_core_tail if head else fc.fused_core_headless_tail
    bare = fc.fused_core if head else fc.fused_core_headless
    counters = ("fused_core", "fused_core_headless", "fused_core_tail", "fused_core_headless_tail")
    before = {c: launched(c) for c in counters}
    got = entry(*args, pw, pb, DH**-0.5)
    torch.cuda.synchronize()
    moved = {c: launched(c) - before[c] for c in counters}
    assert moved == {c: int(c == ("fused_core_tail" if head else "fused_core_headless_tail"))
                     for c in counters}
    assert got.shape == (B, N, out_ch) and got.dtype == torch.bfloat16
    assert torch.isfinite(got.float()).all()
    epilogue = (bare(*args, DH**-0.5).float() @ pw.float() + pb).to(torch.bfloat16)
    torch.testing.assert_close(got.float(), epilogue.float(), rtol=2**-7, atol=2**-7)
    if head:
        want = fc.fused_core_reference(*args, DH**-0.5, pout_w=pw, pout_b=pb)
    else:
        want = fc.fused_core_reference(args[0], None, None, *args[1:], DH**-0.5, pout_w=pw,
                                       pout_b=pb)
    err = (got.float() - want.float()).abs()
    steps = (got.float() - epilogue.float()).abs().max().item()
    print(f"fused_core{'' if head else '_headless'}_tail B={B} N={N} depth={depth} OUT={out_ch}: "
          f"against the plain version max abs err {err.max().item():.3e}, mean "
          f"{err.mean().item():.3e}; against its trunk and a plain proj_out {steps:.3e}")
    if depth <= 5:
        assert err.max().item() <= BF16_MAX_ABS and err.mean().item() <= BF16_MEAN_ABS


@pytest.mark.gpu
@pytest.mark.parametrize("absent", [False, True])
@pytest.mark.parametrize("B, N, depth", [(4, 2048, 5), (1, 8192, 5), (2, 300, 10), (64, 2048, 5),
                                         (64, 300, 10)])
def test_fused_core_two_attn_matches_plain_version(cuda, absent, B, N, depth):
    """The two-attention trunk at 4 x 2048 and 1 x 8192 (the two cells' shapes
    a row), with and without absent parts in the last row, and at a ragged N
    with depth 10, past the 8 blocks whose K, V, K1 and V1 the kernel holds at
    once; at 64 rows each persistent block walks several tiles of different
    rows (8 a block at 2048 points, up to 2 at 300), and with ``absent`` a
    part is also absent in every third row, so K1, V1 and the mask are
    restaged between tiles of one block; counted in
    ``fused_core_two_attn.launches`` alone. Held to the
    trunk's band up to depth 5. At depth 10 the output has passed 20 attention
    halves and 10 feed-forwards, each a chance for a bf16 step, and the mean
    reads 9.5e-4 to 1.19e-3 on an H100; it is held to the band's max and
    twice its mean there (a stale or misplaced K1, V1 group moves most
    tokens by 1e-1 or more)."""
    mask = np.ones((B, fc.CTX), np.float32)
    if absent:
        mask[B - 1, 1] = mask[B - 1, 3] = 0.0
        if B > 4:
            mask[1:-1:3, 2] = 0.0
    args = fc.operands(fc.example_inputs(B, N, depth=depth, mask=mask, two_attn=True, seed=N + B),
                       cuda, torch.bfloat16)
    counters = ("fused_core", "fused_core_two_attn")
    before = {c: launched(c) for c in counters}
    got = fc.fused_core_two_attn(*args, DH**-0.5)
    torch.cuda.synchronize()
    assert {c: launched(c) - before[c] for c in counters} == {"fused_core": 0,
                                                            "fused_core_two_attn": 1}
    n = len(fc.example_inputs(1, 1, 1))
    want = fc.fused_core_reference(*args[:n], DH**-0.5, attn1=args[n:])
    assert got.shape == want.shape == (B, N, 128) and torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs()
    print(f"fused_core_two_attn B={B} N={N} depth={depth} absent={absent}: max abs err "
          f"{err.max().item():.3e}, mean {err.mean().item():.3e}")
    mean_band = BF16_MEAN_ABS * (1 if depth <= 5 else 2)
    assert err.max().item() <= BF16_MAX_ABS and err.mean().item() <= mean_band


@pytest.mark.gpu
def test_two_attention_generation_takes_the_trunk_kernel(cuda, monkeypatch):
    """The gen_chair_two_attn configuration as the benchmark builds it, at
    batch 2: one launch of the two-attention entry a step (100 a batch), none
    of the single-attention trunk's, no per-block trunk and so no denoiser FF
    launch; the samples finite."""
    import json
    import os

    from difffacto_torch import MODELS, build_from_cfg, sample_generation
    from difffacto_torch.models import denoiser

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "benchmark", "configs", "gen_chair_two_attn.json")) as f:
        mcfg = json.load(f)["model"]
    mcfg["dtype"] = torch.bfloat16
    model = build_from_cfg(mcfg, MODELS, device=cuda, seed=0)
    blocks = []
    real = denoiser.TransformerNet._block_trunk
    monkeypatch.setattr(denoiser.TransformerNet, "_block_trunk",
                        lambda *a, **k: blocks.append(1) or real(*a, **k))
    counters = ("fused_core", "fused_core_two_attn", "fused_ff")
    before = {c: launched(c) for c in counters}
    with torch.no_grad():
        pred = sample_generation(model, 2, valid_id=torch.tensor([[1, 1, 1, 0], [1, 1, 1, 1.]],
                                                                 device=cuda),
                                 generator=torch.Generator(device=cuda).manual_seed(0))["pred"]
    torch.cuda.synchronize()
    moved = {c: launched(c) - before[c] for c in counters}
    print(f"two-attention generation at batch 2: launches {moved}")
    assert moved["fused_core"] == 0 and moved["fused_core_two_attn"] == mcfg["num_timesteps"]
    assert moved["fused_ff"] == 0 and not blocks
    assert pred.shape == (2, mcfg["npoints"], 3) and torch.isfinite(pred).all()


@pytest.mark.gpu
def test_fused_core_tail_refuses_wide_outputs(cuda):
    args = fc.operands(fc.example_inputs(B=1, N=64, depth=1), cuda, torch.bfloat16)
    pw, pb = _tail(fc.MAX_OUT + 1, 0, cuda)
    with pytest.raises(ValueError):
        fc.fused_core_tail(*args, pw, pb, DH**-0.5)


@pytest.mark.gpu
def test_fused_core_refuses_float32(cuda):
    args = fc.operands(fc.example_inputs(B=1, N=64, depth=1), cuda, torch.float32)
    with pytest.raises(TypeError):
        fc.fused_core(*args, DH**-0.5)


def _clouds(B, N, seed, distinct=None):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, distinct or N, 3).astype(np.float32)
    if distinct:
        x = np.tile(x, (1, N // distinct, 1))
    return torch.as_tensor(x)


@pytest.mark.gpu
@pytest.mark.parametrize("B, N, m, distinct", [(2, 8192, 2048, None), (3, 1000, 64, None),
                                               (2, 256, 32, 16), (1, 8192, 512, None),
                                               (32, 8192, 256, None), (64, 8192, 256, None),
                                               (132, 8192, 128, None), (400, 8192, 64, None),
                                               (70, 10000, 64, None), (132, 14528, 64, None),
                                               (1, 16384, 256, None), (4, 19198, 64, None)])
def test_fps_matches_plain_version_index_for_index(cuda, B, N, m, distinct):
    """The real shape, a ragged N, and fewer distinct points than samples (all
    remaining distances are 0, so index 0 repeats); then 1, 32, 64, 132 and
    400 clouds of 8192 (``ops/fps.py:plan``: clusters of 4, 4, 2, 1 and 1),
    N above one block's registers at 70 and 132 clouds (the plan grows the
    cluster to 2), a cluster of 8, and the largest cloud the kernel takes
    (each block's shared copy of 19,198 points fills its shared memory).
    Both sides compute (dx*dx + dy*dy) + dz*dz in f32 without FMA, so the
    indices are equal."""
    x = _clouds(B, N, seed=N, distinct=distinct).to(cuda)
    before = launched("fps")
    got = fps_mod.furthest_point_sample(x, m)
    torch.cuda.synchronize()
    assert launched("fps") == before + 1
    want = fps_mod.furthest_point_sample_reference(x, m)
    assert got.dtype == torch.int32 and got.shape == (B, m)
    assert torch.equal(got, want)
    if distinct:
        assert (got[:, distinct:] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_fps_each_cluster_size(cuda, cluster):
    """Every cluster size, set by hand (runs of 32 points a thread at 1, of 16
    at 2, 4 and 8), on a ragged N with duplicated points (exact ties in every
    step)."""
    x = _clouds(3, 5000, seed=11)
    x[:, 2500:] = x[:, :2500]
    x = x.to(cuda)
    got = fps_mod._launch(x, 300, cluster)
    torch.cuda.synchronize()
    assert torch.equal(got, fps_mod.furthest_point_sample_reference(x, 300))


@pytest.mark.gpu
def test_fps_latency_floor_probe_runs_and_is_not_counted(cuda):
    x = _clouds(4, 8192, seed=12).to(cuda)
    before = launched("fps")
    idx = fps_mod.latency_floor_probe(x, 2048)
    torch.cuda.synchronize()
    assert launched("fps") == before
    assert idx.shape == (4, 2048) and int(idx.min()) >= 0 and int(idx.max()) < 8192


def _mean_cost(a, b, assign):
    matched = torch.gather(b, 1, assign.long()[..., None].expand(-1, -1, 3))
    return (a - matched).norm(dim=-1).mean(dim=1)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [2048, 512, 384])
def test_emd_hybrid_matches_plain_version(cuda, n):
    """The kernel and its plain version sum their log-sum-exp in another order,
    so near-ties may land on other objects: the matched costs must agree
    within 0.5 %, the share of equal assignments is printed. At n = 512 the
    kernel's cost is held to 1.01 x the Hungarian optimum."""
    a = (_clouds(2, n, seed=n) * 0.3).to(cuda)
    b = (_clouds(2, n, seed=n + 1) * 0.3).to(cuda)
    before = launched("emd_hybrid")
    got, rounds, bids, _ = eh.emd_assignment_hybrid(a, b, auction_iters=150, return_work=True)
    torch.cuda.synchronize()
    assert launched("emd_hybrid") == before + 1
    want, rounds_w, bids_w = eh.emd_assignment_hybrid_reference(
        a, b, auction_iters=150, return_work=True)
    assert got.dtype == torch.int32 and got.shape == (2, n)
    assert (got >= 0).all() and (got < n).all()
    cg, cw = _mean_cost(a, b, got), _mean_cost(a, b, want)
    print(f"emd_hybrid n={n}: equal share {(got == want).float().mean().item():.4f}, "
          f"rounds {rounds.tolist()} vs plain {rounds_w.tolist()}, bids {bids.tolist()} vs "
          f"plain {bids_w.tolist()}, cost {cg.tolist()} vs plain {cw.tolist()}")
    assert ((cg - cw).abs() <= 0.005 * cw).all()
    assert ((n + rounds - 1 <= bids) & (bids <= n * (rounds + 1))).all()
    _hold_permutation(got, rounds, 150)
    if torch.equal(got, want):
        assert torch.equal(rounds, rounds_w) and torch.equal(bids, bids_w)
    if n == 512:
        from scipy.optimize import linear_sum_assignment

        for i in range(2):
            d = torch.cdist(a[i], b[i]).cpu().numpy()
            ri, ci = linear_sum_assignment(d)
            assert cg[i].item() <= 1.01 * d[ri, ci].mean()


def _hold_permutation(got, rounds, cap):
    """Each pair whose auction finished before its cap holds every object once."""
    n = got.shape[1]
    for i in torch.nonzero(rounds < cap).flatten().tolist():
        assert got[i].unique().numel() == n, f"pair {i} finished in {rounds[i]} rounds"


def _hold_emd(a, b, label):
    """The kernel against its plain version with the gates above: in range,
    matched cost within 0.5 %, the bids invariant, a permutation wherever the
    auction finished; the share of equal assignments is printed, not held."""
    before = launched("emd_hybrid")
    got, rounds, bids, _ = eh.emd_assignment_hybrid(a, b, auction_iters=150, return_work=True)
    torch.cuda.synchronize()
    assert launched("emd_hybrid") == before + 1
    want, rounds_w, bids_w = eh.emd_assignment_hybrid_reference(
        a, b, auction_iters=150, return_work=True)
    n = a.shape[1]
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert (got >= 0).all() and (got < n).all()
    cg, cw = _mean_cost(a, b, got), _mean_cost(a, b, want)
    rel = ((cg - cw).abs() / cw).max().item()
    print(f"emd_hybrid {label}: equal share {(got == want).float().mean().item():.4f}, mean "
          f"rounds {rounds.float().mean().item():.1f} vs plain {rounds_w.float().mean().item():.1f}, "
          f"mean bids {bids.float().mean().item():.0f} vs plain {bids_w.float().mean().item():.0f}, "
          f"cost off by at most {rel:.3e}")
    assert ((cg - cw).abs() <= 0.005 * cw).all()
    assert ((n + rounds - 1 <= bids) & (bids <= n * (rounds + 1))).all()
    _hold_permutation(got, rounds, 150)
    return rounds, bids


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 32, 132])
def test_emd_hybrid_pairs_per_launch(cuda, B):
    """n = 2048 with one pair, 32 pairs, and 132 (one pair on every SM of an
    H100, the protocol's full-card shape), clouds scaled per axis."""
    rng = np.random.RandomState(B)
    scale = torch.as_tensor(rng.uniform(0.2, 0.5, (B, 1, 3)).astype(np.float32))
    a = (_clouds(B, 2048, seed=B) * scale).to(cuda)
    b = (_clouds(B, 2048, seed=B + 1) * scale).to(cuda)
    _hold_emd(a, b, f"B={B} n=2048")


@pytest.mark.gpu
@pytest.mark.parametrize("n", [2048, 512])
def test_emd_hybrid_few_bidders(cuda, n):
    """The second cloud is the first, permuted and moved by 1e-3, with 8 of
    its points put onto 8 others: after the first round only the rows whose
    object was taken bid, about 2 a round for all 150 rounds (the plain
    version's count on the CPU), far fewer than the kernel's n / 64 warps."""
    a = (_clouds(2, n, seed=n) * 0.3).to(cuda)
    perm = torch.as_tensor(np.random.RandomState(n).permutation(n), device=cuda)
    b = a[:, perm] + 1e-3 * _clouds(2, n, seed=n + 7).to(cuda)
    b[:, :8] = b[:, 8:16]
    rounds, bids = _hold_emd(a, b.contiguous(), f"few bidders n={n}")
    assert (rounds >= 2).all() and (bids - n < (n // 64) * (rounds - 1)).all()


@pytest.mark.gpu
def test_emd_hybrid_global_state_at_8192(cuda):
    """n = 8192 does not fit in shared memory: the state lies in the global
    workspace. That variant is held to the plain version as the shared-memory
    one is: in range, matched cost within 0.5 %, nearly bijective. One pair,
    because the plain version holds several (B, 8192, 8192) f32 matrices."""
    a = (_clouds(1, 8192, seed=3) * 0.3).to(cuda)
    b = (_clouds(1, 8192, seed=4) * 0.3).to(cuda)
    got, rounds, bids, _ = eh.emd_assignment_hybrid(a, b, auction_iters=150, return_work=True)
    torch.cuda.synchronize()
    want = eh.emd_assignment_hybrid_reference(a, b, auction_iters=150)
    assert (got >= 0).all() and (got < 8192).all()
    share = got[0].unique().numel() / 8192
    cg, cw = _mean_cost(a, b, got), _mean_cost(a, b, want)
    print(f"emd_hybrid n=8192: rounds {rounds.tolist()}, bids {bids.tolist()}, distinct objects "
          f"{share:.4f}, equal share {(got == want).float().mean().item():.4f}, "
          f"cost {cg.tolist()} vs plain {cw.tolist()}")
    assert 1 <= rounds.item() <= 150 and share >= 0.98
    assert ((cg - cw).abs() <= 0.005 * cw).all()
    _hold_permutation(got, rounds, 150)


@pytest.mark.gpu
def test_emd_exp2s_on_the_card(cuda):
    """The sweep's soft exp2 equals its model (``exp2_soft_reference``) to
    the last bit but for a rare double rounding in the model, keeps
    ex2.approx's relative error of 2^-22 on [-126, 0], and is 0 where a
    result falls below 2^-126, as ex2.approx.ftz is; ex2.approx's own error is
    printed beside it."""
    grid = np.linspace(-126.0, 0.0, 126 * 4096 + 1)
    rand = np.random.RandomState(1).uniform(-126.0, 0.0, 10**6)
    z = torch.as_tensor(np.concatenate([grid, rand]).astype(np.float32))
    soft = eh.exp2_probe(z.to(cuda), soft=True).cpu()
    hard = eh.exp2_probe(z.to(cuda), soft=False).cpu()
    ulps = (soft.view(torch.int32) - eh.exp2_soft_reference(z).view(torch.int32)).abs()
    want = torch.exp2(z.double())
    rel_soft = (soft.double() / want - 1).abs().max().item()
    rel_hard = (hard.double() / want - 1).abs().max().item()
    print(f"exp2 on [-126, 0]: soft 2^{np.log2(rel_soft):.2f}, ex2.approx 2^{np.log2(rel_hard):.2f}"
          f"; soft against its model: {(ulps > 0).sum().item()} of {z.numel()} off by one ulp")
    assert ulps.max().item() <= 1 and (ulps > 0).float().mean().item() < 1e-3
    assert rel_soft <= 2.0**-22
    low = torch.linspace(-126.001, -1000.0, 10001).to(cuda)
    assert (eh.exp2_probe(low, soft=True) == 0).all()
    assert (eh.exp2_probe(low, soft=False) == 0).all()


@pytest.mark.gpu
def test_emd_sinkhorn_counters_only_while_recording(cuda, monkeypatch):
    """Through the eval EMD at n = 2048: the kernel's sweep terms, the share
    its soft exp2 took and its Sinkhorn's clock cycles are counted while the
    recorder records, and not otherwise."""
    from difffacto_torch.ops import emd as te

    monkeypatch.delenv("DIFFFACTO_EMD_IMPL", raising=False)
    keys = ("emd.sweep_terms", "emd.sweep_soft_terms", "emd.sinkhorn_cycles")

    def read():
        counts = trace.counters()
        return {k: counts.get(k, 0) for k in keys}

    a = (_clouds(3, 2048, seed=21) * 0.3).to(cuda)
    b = (_clouds(3, 2048, seed=22) * 0.3).to(cuda)
    before = read()
    te.emd_cost_eval(a, b)
    torch.cuda.synchronize()
    assert read() == before
    with trace.recording():
        te.emd_cost_eval(a, b)
    got = {k: v - before[k] for k, v in read().items()}
    soft = eh._library().difffacto_emd_hybrid_soft_terms()
    want = eh.sweep_counts(3, 2048, 2048, 150, soft)
    print(f"soft terms {soft} of {eh.ROWS * eh.KSTEP}; counts {got}; "
          f"{got['emd.sinkhorn_cycles'] / 3e6:.1f} Mcycles a pair")
    assert got["emd.sweep_terms"] == want["emd.sweep_terms"] == 3 * 150 * 2 * 2048 * 2048
    assert got["emd.sweep_soft_terms"] == want["emd.sweep_soft_terms"] > 0
    assert got["emd.sinkhorn_cycles"] > 0


@pytest.mark.gpu
def test_emd_hybrid_refuses_ragged_n(cuda):
    a = torch.zeros(1, 100, 3, device=cuda)
    with pytest.raises(ValueError):
        eh.emd_assignment_hybrid(a, a)


# The training trunk. Forward: the bf16 limits above. Backward: the kernel
# rounds the inputs of its matrix products to bf16 (as the Pallas kernel does)
# and sums its weight gradients with f32 reductions in no fixed order (they
# repeat only to f32 rounding); autograd through the plain version does
# neither. An H100 showed 2e-3 to 9e-3 in relative L2.
GRAD_REL_L2 = 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("n, p, depth", [(512, 0.0, 3), (512, 0.2, 3), (200, 0.2, 3),
                                         (1000, 0.2, 1), (1000, 0.0, 10), (100, 0.2, 2)])
def test_fused_trunk_train_matches_plain_version(cuda, n, p, depth):
    """A part absent in one row, N a multiple of the 128-token tile and ragged
    ones (1000, and 100: shorter than one tile), depth 1, 3 and 10: the
    forward and dx, dK, dV and the 15 parameter gradients; one launch of each
    kernel."""
    inp = fct.example_inputs(B=2, N=n, depth=depth, seed=1, mask=[[1, 1, 1, 1], [1, 1, 0, 1]])
    inp["cot"] = np.random.RandomState(2).randn(2, n, 128).astype(np.float32)
    par = fct.example_params(depth=depth, seed=3)
    before = launched("fused_trunk_train_fwd", "fused_trunk_train_bwd")
    y, g = fct.run_example(fct.fused_trunk_train, inp, par, p, 99, cuda)
    torch.cuda.synchronize()
    assert launched("fused_trunk_train_fwd", "fused_trunk_train_bwd") == (before[0] + 1,
                                                                         before[1] + 1)
    yr, gr = fct.run_example(fct.fused_trunk_train_reference, inp, par, p, 99, cuda)
    err = (y - yr).abs()
    assert err.max().item() <= BF16_MAX_ABS and err.mean().item() <= BF16_MEAN_ABS
    names = ["x", "k", "v"] + list(fct.PARAM_NAMES)
    for name, a, b in zip(names, g, gr):
        assert a.shape == b.shape and torch.isfinite(a).all(), name
        rel = ((a - b).norm() / b.norm()).item()
        print(f"d{name}: relative L2 {rel:.3e}")
        assert rel <= GRAD_REL_L2, name


@pytest.mark.gpu
def test_fused_trunk_train_many_tiles_per_block(cuda):
    """More tiles than twice the card's SMs (not a multiple of their count), a
    ragged N and absent parts: every block of both persistent grids walks
    several tiles, reuses its parked gradient and adds many tiles into one
    dK/dV row."""
    B, n = 40, 1000
    tiles = B * -(-n // fct.TILE)
    assert tiles > 2 * torch.cuda.get_device_properties(cuda).multi_processor_count
    mask = np.ones((B, 4), np.float32)
    mask[1, 2] = mask[7, 0] = mask[B - 1, 3] = 0.0
    inp = fct.example_inputs(B=B, N=n, depth=2, seed=6, mask=mask)
    inp["cot"] = np.random.RandomState(7).randn(B, n, 128).astype(np.float32)
    par = fct.example_params(depth=2, seed=8)
    y, g = fct.run_example(fct.fused_trunk_train, inp, par, 0.2, 31, cuda)
    torch.cuda.synchronize()
    yr, gr = fct.run_example(fct.fused_trunk_train_reference, inp, par, 0.2, 31, cuda)
    err = (y - yr).abs()
    assert err.max().item() <= BF16_MAX_ABS and err.mean().item() <= BF16_MEAN_ABS
    for name, a, b in zip(["x", "k", "v"] + list(fct.PARAM_NAMES), g, gr):
        assert torch.isfinite(a).all(), name
        rel = ((a - b).norm() / b.norm()).item()
        print(f"d{name}: relative L2 {rel:.3e}")
        assert rel <= GRAD_REL_L2, name


@pytest.mark.gpu
def test_fused_trunk_train_dropout_repeats_and_depends_on_the_seed(cuda):
    inp = fct.example_inputs(B=2, N=256, depth=2, seed=4)
    par = fct.example_params(depth=2, seed=5)
    x, k, v = (torch.as_tensor(inp[n]).to(cuda, torch.bfloat16) for n in ("x", "k", "v"))
    rest = [torch.as_tensor(inp["mask"]).to(cuda)] + [torch.as_tensor(a).to(cuda) for a in par.values()]
    with torch.no_grad():
        y1, y1b, y2 = (fct.fused_trunk_train(s, x, k, v, *rest, DH**-0.5, 0.2) for s in (7, 7, 8))
    assert torch.equal(y1, y1b) and not torch.equal(y1, y2)


@pytest.mark.gpu
def test_fused_trunk_train_refuses_float32_activations(cuda):
    inp = fct.example_inputs(B=1, N=64, depth=1)
    par = fct.example_params(depth=1)
    x, k, v = (torch.as_tensor(inp[n]).to(cuda) for n in ("x", "k", "v"))
    rest = [torch.as_tensor(inp["mask"]).to(cuda)] + [torch.as_tensor(a).to(cuda) for a in par.values()]
    with pytest.raises(TypeError):
        fct.fused_trunk_train(0, x, k, v, *rest, DH**-0.5, 0.0)


def _ff_operands(D, T, device, seed=0):
    """fused_ff's operands: bf16, the biases b1 and b2 f32."""
    return fc.operands(ff.example_inputs(T, D, seed), device, torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("D, T", [(128, 16 * 2048), (256, 1024), (256, 384), (128, 100),
                                  (128, 128), (128, 256 * 2048), (256, 100), (256, 128),
                                  (256, 16 * 2048), (256, 256 * 2048)])
def test_fused_ff_matches_plain_version(cuda, D, T):
    """The denoiser's shape at batch 16 and 256 (T = 524,288: 4096 tiles, 31
    or 32 for each block of the persistent grid at D = 128), the aligner's at
    batch 256, a smaller aligner T, T = 128 (one tile), and T = 100, shorter
    than a tile at both widths (128 tokens at D = 128, 64 at D = 256)."""
    args = _ff_operands(D, T, cuda, seed=T)
    before = launched("fused_ff")
    got = ff.fused_ln_geglu_ff(*args)
    torch.cuda.synchronize()
    assert launched("fused_ff") == before + 1
    want = ff.fused_ln_geglu_ff_reference(*args)
    assert got.shape == want.shape == (T, D) and torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs()
    print(f"fused_ff D={D} T={T}: max abs err {err.max().item():.3e}, mean {err.mean().item():.3e}")
    assert err.max().item() <= BF16_MAX_ABS and err.mean().item() <= BF16_MEAN_ABS


@pytest.mark.gpu
@pytest.mark.parametrize("B, N", [(16, 2048), (2, 384), (2, 1000), (32, 2048), (1, 100),
                                  (1, 1000)])
def test_fused_block_matches_plain_version(cuda, B, N):
    """UNet's block at batch 16 x 2048 points, an N that pick_tile takes
    (384), a ragged N, and the trunk's walk shapes: more tiles than twice the
    SMs, an N shorter than one tile, fewer tiles than SMs; parts absent in
    some rows."""
    mask = np.ones((B, fb.CTX), np.float32)
    mask[min(1, B - 1), 1] = mask[B - 1, 3] = 0.0
    args = fc.operands(fb.example_inputs(B, N, seed=N, mask=mask), cuda, torch.bfloat16)
    before = launched("fused_block")
    got = fb.fused_block(*args, DH**-0.5)
    torch.cuda.synchronize()
    assert launched("fused_block") == before + 1
    want = fb.fused_block_reference(*args, DH**-0.5)
    assert got.shape == want.shape == (B, N, fb.D) and torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs()
    print(f"fused_block B={B} N={N}: max abs err {err.max().item():.3e}, mean {err.mean().item():.3e}")
    assert err.max().item() <= BF16_MAX_ABS and err.mean().item() <= BF16_MEAN_ABS


@pytest.mark.gpu
def test_fused_ff_and_block_refuse_wrong_operands(cuda):
    """float32 activations, a weight left on the CPU and an unported width
    raise before any launch."""
    args = _ff_operands(128, 256, cuda)
    with pytest.raises(TypeError):
        ff.fused_ln_geglu_ff(args[0].float(), *args[1:])
    with pytest.raises(ValueError, match="not on the card"):
        ff.fused_ln_geglu_ff(*args[:3], args[3].cpu(), *args[4:])
    with pytest.raises(NotImplementedError):
        ff.fused_ln_geglu_ff(*_ff_operands(64, 256, cuda))
    block = fc.operands(fb.example_inputs(2, 256), cuda, torch.bfloat16)
    with pytest.raises(ValueError, match="not on the card"):
        fb.fused_block(*block[:6], block[6].cpu(), *block[7:], DH**-0.5)
    with pytest.raises(NotImplementedError):
        fb.fused_block(block[0], block[1][:, :3], block[2][:, :3], block[3][:, :3], *block[4:],
                       DH**-0.5)



def _on_both(make):
    """One module built on the CPU from a seeded generator, and a copy on the card."""
    import copy

    cpu = make()
    return cpu, copy.deepcopy(cpu).to("cuda")


def _denoiser(n_heads, d_head):
    from difffacto_torch.models import TransformerNet

    return TransformerNet(3, 3, n_heads, d_head, depth=2, context_dim=262, class_cond=True,
                          cat_params_to_x=True, single_attn=True, cat_class_to_x=True,
                          device="cpu", generator=torch.Generator().manual_seed(0))


def _denoiser_args(device):
    rng = np.random.RandomState(1)
    B, N = 2, 256
    a = dict(x=rng.randn(B, N, 3), t=np.array([3, 7]), ctx=rng.randn(B, 4, 262),
             anchors=0.1 * rng.randn(B, N, 3), variances=np.abs(rng.randn(B, N, 3)) + 0.1,
             seg_mask=np.repeat(np.arange(4), N // 4)[None].repeat(B, 0),
             valid_id=np.array([[1, 1, 1, 1], [1, 0, 1, 1]]))
    return [torch.as_tensor(v, dtype=torch.int64 if k in ("t", "seg_mask") else torch.float32,
                            device=device) for k, v in a.items()]


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["denoiser_4x32", "denoiser_16x8", "denoiser_4x32_train",
                                  "denoiser_16x8_train", "unet_language_3", "ff_384"])
def test_shapes_the_kernels_do_not_take_run_unfused(cuda, case):
    """Shapes the JAX package computes but the kernels do not take: the single-
    attention denoiser at 4 x 32 and 16 x 8 heads (generation, and a training
    forward and backward), UNet with a language code of 3 tokens, FusedLNFF at
    D = 384. Each runs the unfused math on the card, launches no kernel, and
    agrees with the same module on the CPU in f32 (TF32 off; sums in another
    order: 1e-4 relative, gradients 1e-3)."""
    from difffacto_torch.models import UNet
    from difffacto_torch.nn.layers import FusedLNFF

    counts = lambda: launched("fused_core", "fused_trunk_train_fwd", "fused_trunk_train_bwd",
                              "fused_block", "fused_ff")
    before = counts()
    if case.startswith("denoiser"):
        heads = (4, 32) if "4x32" in case else (16, 8)
        cpu, gpu = _on_both(lambda: _denoiser(*heads))
        train = case.endswith("train")
        outs, grads = [], []
        for net, dev in ((cpu, "cpu"), (gpu, cuda)):
            args = _denoiser_args(dev)
            args[2].requires_grad_(train)
            with torch.set_grad_enabled(train):
                y = net(*args, train=train)
                if train:
                    (y * torch.linspace(-1, 1, y.numel(), device=dev).view_as(y)).sum().backward()
                    grads.append([args[2].grad] + [p.grad for p in net.parameters()])
            outs.append(y.detach().cpu())
        for gc, gg in zip(*grads) if train else ():
            if gc is not None:
                torch.testing.assert_close(gg.cpu(), gc, rtol=1e-3, atol=1e-4)
    elif case == "unet_language_3":
        # bf16 as the denoiser runs: the part-token blocks take the one-block
        # kernel on the card (its plain version on the CPU), the language
        # blocks the unfused math on both; held as chip_smoke.py holds UNet, by
        # the relative L2 of what the net adds (5e-2: the bf16 net differs from
        # itself in f32 by 1.5e-2 on the CPU).
        make = lambda: UNet(3, 8, 16, depth=2, prior_dim=20, language_dim=12, language_cond=True,
                            dtype=torch.bfloat16, device="cpu",
                            generator=torch.Generator().manual_seed(0))
        cpu, gpu = _on_both(make)
        gen = torch.Generator().manual_seed(1)
        x, ctx, lang = (torch.randn(*s, generator=gen) for s in ((2, 384, 3), (2, 4, 20), (2, 3, 12)))
        for net in (cpu, gpu):
            with torch.no_grad():
                net.proj_out.kernel.copy_(torch.linspace(-0.5, 0.5, 384).view(128, 3))
        adds = []
        for net, dev in ((cpu, "cpu"), (gpu, cuda)):
            with torch.no_grad():
                y = net(x.to(dev), torch.tensor([1, 5], device=dev), ctx.to(dev),
                        valid_id=torch.ones(2, 4, device=dev), language_code=lang.to(dev))
            adds.append((y - x.to(dev)).float().cpu())
        torch.cuda.synchronize()
        # the part-token blocks still take the kernel
        assert launched("fused_block") == before[3] + 2
        assert counts()[:3] + counts()[4:] == before[:3] + before[4:]
        assert torch.isfinite(adds[1]).all()
        rel = ((adds[1] - adds[0]).norm() / adds[0].norm()).item()
        print(f"UNet with a 3-token language code: card against CPU relative L2 {rel:.3e}")
        assert rel <= 5e-2
        return
    else:
        cpu, gpu = _on_both(lambda: FusedLNFF(384, device="cpu",
                                              generator=torch.Generator().manual_seed(0)))
        x = torch.randn(2, 256, 384, generator=torch.Generator().manual_seed(1))
        with torch.no_grad():
            outs = [cpu(x), gpu(x.to(cuda)).cpu()]
    torch.cuda.synchronize()
    assert counts() == before
    assert torch.isfinite(outs[1]).all()
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("crop, padding_zeros", [(700, False), (700, True), ([2048, 6144], False)],
                         ids=["integer", "padding-zeros", "crop-range"])
def test_separate_point_cloud_on_the_card_matches_the_cpu(cuda, crop, padding_zeros):
    """The cropping pair on the card against the CPU on the same clouds and
    fixed point: the ranking picks the same points for each half. The card
    may round a distance one f32 step apart from the CPU (a fused
    multiply-add), which can swap two near-tied neighbours in the ranking,
    so the order is held to 99% of the positions (an H100 80GB HBM3 at 700 W
    had 0.04% of the partial points out of place: one swapped pair); at a crop range both
    halves go through the FPS kernel."""
    from difffacto_torch.data.dataset_utils import separate_point_cloud

    n = 8192 if isinstance(crop, list) else 2000
    xyz = torch.as_tensor(np.random.RandomState(0).randn(4, n, 3).astype(np.float32))
    center = np.array([0.2, 0.9, -0.1], np.float32)
    before = launched("fps")
    got = separate_point_cloud(xyz.to(cuda), n, crop, fixed_points=center,
                               padding_zeros=padding_zeros, rng=np.random.RandomState(1))
    torch.cuda.synchronize()
    want = separate_point_cloud(xyz, n, crop, fixed_points=center, padding_zeros=padding_zeros,
                                rng=np.random.RandomState(1))
    assert launched("fps") == before + (2 if isinstance(crop, list) else 0)
    for g, w in zip(got, want):
        assert g.is_cuda and g.shape == w.shape
        g = g.cpu()
        for a, b in zip(g.numpy(), w.numpy()):  # the same points in each cloud
            np.testing.assert_array_equal(a[np.lexsort(a.T)], b[np.lexsort(b.T)])
        share = (g == w).all(-1).float().mean().item()
        print(f"{crop}, padding_zeros={padding_zeros}: {100 * share:.2f}% of the points in place")
        assert share >= 0.99


@pytest.mark.gpu
def test_checkpoint_round_trip_of_a_card_model(cuda, tmp_path):
    """A bf16 model on the card after two training steps: save, then load
    into a fresh runner state; parameters, buffers, moments, count and step
    come back bit for bit and on the card."""
    import os

    from difffacto_torch import MODELS, Config, build_from_cfg
    from difffacto_torch.parallel import build_optimizer_from_cfg, init_train_state, make_train_step
    from difffacto_torch.utils.checkpoint import load_checkpoint, save_checkpoint, state_dict

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def build(seed):
        mcfg = Config(os.path.join(root, "configs", "gen_chair.py")).model.dump()
        mcfg.update(npoints=256, ret_traj=False, gen=False, dtype=torch.bfloat16)
        mcfg["encoder"]["gen"] = False
        mcfg["diffusion"]["net"]["depth"] = 2
        return build_from_cfg(mcfg, MODELS, device=cuda, seed=seed)

    tx = build_optimizer_from_cfg(dict(type="Adam", lr=2e-3), max_norm=10.0)
    model = build(0)
    state = init_train_state(model, tx)
    step = make_train_step(model, tx)
    rng = np.random.RandomState(2)
    seg = np.repeat(np.arange(4), 64)[None].repeat(2, 0).astype(np.int32)
    pts = rng.randn(2, 256, 3).astype(np.float32) * 0.3
    batch = {"input": pts, "ref": pts, "ref_seg_mask": seg, "seg_mask": seg,
             "present": np.ones((2, 4), np.float32), "dp_present": np.ones((2, 4), np.float32),
             "part_shift": rng.randn(2, 4, 3).astype(np.float32) * 0.1,
             "part_scale": np.full((2, 4, 3), 0.3, np.float32),
             "noise": np.zeros((2, 1), np.float32)}
    batch = {k: torch.as_tensor(v, device=cuda) for k, v in batch.items()}
    for i in range(2):
        state, _ = step(state, batch, 5, 0)
    path = save_checkpoint(str(tmp_path), 2, state, meta={"iter": 2})
    fresh = build(1)
    restored, meta = load_checkpoint(path, init_train_state(fresh, tx), strict=True)
    assert meta == {"epoch": 2, "iter": 2, "noise_table": None} and restored.step == 2
    want, got = state_dict(state), state_dict(restored)
    for group in ("params", "batch_stats"):
        for name, t in want[group].items():
            assert got[group][name].is_cuda and torch.equal(got[group][name], t), name
    for key in ("mu", "nu"):
        for name, t in want["opt_state"][key].items():
            assert torch.equal(got["opt_state"][key][name], t), name
    assert torch.equal(got["opt_state"]["count"], want["opt_state"]["count"])


@pytest.mark.gpu
def test_fused_ff_at_the_sample_one_part_search_size(cuda):
    """The aligner's FF at D = 256 as ``sample_one_part`` runs it under
    ``inference_mode``: 32 shapes x 10 variants x 100 noises x 4 part tokens
    = 128,000 tokens in one launch, against the plain version on the module's
    own operands."""
    from difffacto_torch.nn.layers import FusedLNFF

    m = FusedLNFF(256, dtype=torch.bfloat16, device=cuda, generator=torch.Generator().manual_seed(4))
    x = torch.randn(32 * 10 * 100, 4, 256, generator=torch.Generator().manual_seed(5))
    x = x.to(cuda, torch.bfloat16)
    before = launched("fused_ff")
    with torch.inference_mode():
        got = m(x)
        torch.cuda.synchronize()
        assert launched("fused_ff") == before + 1
        bf = torch.bfloat16
        want = ff.fused_ln_geglu_ff_reference(
            x.reshape(-1, 256), m.ln_scale.to(bf), m.ln_bias.to(bf), m.w1.to(bf), m.b1.float(),
            m.w2.to(bf), m.b2.float()).reshape(x.shape)
    err = (got.float() - want.float()).abs()
    print(f"fused_ff D=256 T=128000: max abs err {err.max().item():.3e}, "
          f"mean {err.mean().item():.3e}")
    assert torch.isfinite(got.float()).all()
    assert err.max().item() <= BF16_MAX_ABS and err.mean().item() <= BF16_MEAN_ABS


@pytest.mark.gpu
def test_fused_ff_under_autograd_takes_the_unfused_math(cuda):
    """The kernel has no backward: where a gradient is asked for (shape
    editing differentiates through the aligner) ``FusedLNFF`` computes the
    unfused math, launching nothing; its gradient in x on the card equals
    the CPU's (float32 both). Without a gradient the same call launches."""
    from difffacto_torch.nn.layers import FusedLNFF

    cpu, gpu = _on_both(lambda: FusedLNFF(256, device="cpu",
                                          generator=torch.Generator().manual_seed(6)))
    x = torch.randn(256, 4, 256, generator=torch.Generator().manual_seed(7))
    grads = []
    before = launched("fused_ff")
    for m, dev in ((cpu, "cpu"), (gpu, cuda)):
        xi = x.clone().to(dev).requires_grad_(True)
        (m(xi) ** 2).sum().backward()
        grads.append(xi.grad.cpu())
    torch.cuda.synchronize()
    assert launched("fused_ff") == before
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-4, atol=1e-4)
    with torch.no_grad():  # the kernel takes bf16
        gpu.dtype = torch.bfloat16
        gpu(x.to(cuda, torch.bfloat16))
    torch.cuda.synchronize()
    assert launched("fused_ff") == before + 1


@pytest.mark.gpu
def test_pth_round_trip_on_the_card(cuda, tmp_path):
    """A full-width gen_chair ``.pth`` in the reference's layout loads into a
    model on the card as into one on the CPU: every parameter and buffer
    equal, on the card; the aligner on the card (float32) reproduces the
    reference module."""
    import os
    import sys

    from difffacto_torch import MODELS, Config, build_from_cfg
    from difffacto_torch.utils.torch_ingest import load_reference_checkpoint

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(root, "tools"))
    import reference_layout_torch as ref

    mods = ref.build_modules(seed=1)
    path = str(tmp_path / "gen_chair_reference_layout.pth")
    ref.save_pth(mods, path)
    mcfg = Config(os.path.join(root, "configs", "gen_chair.py")).model.dump()
    mcfg.update(npoints=256, ret_traj=False)
    models = {}
    for dev in ("cpu", cuda):
        models[str(dev)] = build_from_cfg(mcfg, MODELS, device=dev, seed=3)
        assert load_reference_checkpoint(path, models[str(dev)]) == []
    cpu, card = models["cpu"], models["cuda"]
    for (name, a), (_, b) in zip(list(cpu.named_parameters()) + list(cpu.named_buffers()),
                                 list(card.named_parameters()) + list(card.named_buffers())):
        assert b.is_cuda and torch.equal(b.cpu(), a), name
    rng = np.random.RandomState(2)
    code = torch.as_tensor(rng.randn(2, 4, 256), dtype=torch.float32)
    noise = torch.as_tensor(rng.randn(2, 32) * 0.01, dtype=torch.float32)
    valid = torch.ones(2, 4)
    with torch.no_grad():
        want = mods["aligner"](code, valid, noise)
        got = card.encoder_mod.aligner(code.to(cuda), valid.to(cuda), noise=noise.to(cuda))
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-3, atol=1e-3)


@pytest.mark.gpu
def test_card_runner_computes_in_float32_as_the_jax_runner(cuda, tmp_path):
    """The card Runner builds its model in float32, as the JAX Runner does
    (``difffacto_tpu/runner/runner.py:168``), and casts to bf16 only at the
    kernels' operands (ROADMAP C8, the dtype probe). On ``configs/bench_train_tpu.py``
    (gen_chair at full width) the loss on one batch, every draw injected, in
    eval mode: every module computes in float32, the flow prior's terms and
    the fit loss equal the CPU Runner's to 1e-4 (a model built in bf16 would
    round each operand by 2^-9 relative), the mse loss, which goes through the
    bf16 trunk kernel, to 2e-2. A model built in bf16 on the card fails."""
    import os

    from difffacto_torch import Config, Runner
    from difffacto_torch.models import ensure_attn_maps
    from difffacto_torch.runner.runner import device_batch

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    losses = {}
    for where in (cuda, torch.device("cpu")):
        cfg = Config(os.path.join(root, "configs", "bench_train_tpu.py"))
        cfg.work_dir = str(tmp_path / where.type)
        r = Runner(cfg=cfg, device=where)
        assert {getattr(m, "dtype", None) for m in r.model.modules()} == {None}
        batch = next(iter(r.train_loader))
        B, N = np.asarray(batch["ref"]).shape[:2]
        rng = np.random.RandomState(3)
        db = device_batch(batch, where, r._slim_train)
        db.update({k: torch.as_tensor(v, device=where) for k, v in dict(
            diffusion_t=rng.randint(0, 100, B), diffusion_noise=rng.randn(B, N, 3).astype(np.float32),
            part_code_eps=rng.randn(B, 4, 256).astype(np.float32)).items()})
        with torch.no_grad():
            out = r.model.loss(ensure_attn_maps(db), 0, False)
        losses[where.type] = {k: float(v.float().mean()) for k, v in out.items()}
    card, cpu = losses["cuda"], losses["cpu"]
    prior = [k for k in cpu if k in ("prior_loss", "fit_loss") or k.startswith(("log_p", "entropy"))]
    assert len(prior) == 10
    for k in prior:
        np.testing.assert_allclose(card[k], cpu[k], rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(card["mse_loss"], cpu["mse_loss"], rtol=2e-2)


@pytest.mark.gpu
def test_world_size_1_nccl_step_equals_the_plain_step(cuda, tmp_path):
    """One NCCL rank through the mesh step (gen_chair at full width, depth
    cut, N = 512, float32, B2/B3 once each): the all-reduces of the flat
    gradient and statistics buffer and of the scalars over one rank and the step's
    update equal the plain step's update of the same local gradients bit
    for bit (parameters, BatchNorm statistics, loss, gradient norm). Two
    independent steps are not compared bit for bit: B3 sums its weight
    gradients with f32 atomics, in no fixed order."""
    from torch_dist_ranks import spawn

    r = spawn("card", 1, tmp_path, backend="nccl")[0]
    np.testing.assert_array_equal(r["launches"], [1, 1])
    for k in ("params", "stats", "total", "gnorm"):
        np.testing.assert_array_equal(r[k], r[f"ref_{k}"])
    assert np.abs(r["params"] - r["before"]).max() > 0


@pytest.mark.gpu
def test_gloo_two_ranks_sharing_the_card_step_as_one(cuda, tmp_path):
    """Two gloo ranks on one card (collectives on CUDA tensors) take one dp
    step of the same model, 2 of
    the 4 shapes each, against the two slices' arithmetic on one rank:
    loss 1e-5 relative, gradient norm 1e-4 relative (B3's atomics), the
    mean |difference| of the parameters within a quarter of the mean
    |update| (phase 9's tolerance: Adam's first update is lr in size
    whatever the gradient), the statistics 1e-4 relative, both ranks equal,
    B2 and B3 once on each."""
    from torch_dist_ranks import spawn

    ranks = spawn("card", 2, tmp_path, backend="gloo")
    r = ranks[0]
    for x in ranks:
        np.testing.assert_array_equal(x["launches"], [1, 1])
    np.testing.assert_array_equal(ranks[1]["digest"], r["digest"])
    np.testing.assert_allclose(r["total"], r["ref_total"], rtol=1e-5)
    np.testing.assert_allclose(r["gnorm"], r["ref_gnorm"], rtol=1e-4)
    upd = np.abs(r["ref_params"] - r["before"]).mean()
    assert np.abs(r["params"] - r["ref_params"]).mean() <= 0.25 * upd
    np.testing.assert_allclose(r["stats"], r["ref_stats"], rtol=1e-4, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("radius, nsample", [(0.2, 64), (0.4, 64), (0.8, 128)])
def test_point_ops_on_the_card_match_the_cpu(cuda, radius, nsample):
    """PointNet++'s neighbourhood ops at its first level (32 clouds of 2048
    points, 512 FPS centres; f32, TF32 off on both): ``ball_query``'s
    indices equal the CPU's except where a candidate lies within 1e-6 of
    r^2, ``three_nn``'s equal except between points whose squared distances
    tie within 1e-5, the squared distances and ``three_interpolate`` within
    1e-5."""
    from difffacto_torch.ops import points

    rng = np.random.RandomState(0)
    xyz = torch.as_tensor(0.4 * rng.randn(32, 2048, 3), dtype=torch.float32)
    centres = points.fps(xyz, 512)
    got = points.ball_query(centres.to(cuda), xyz.to(cuda), radius, nsample).cpu()
    want = points.ball_query(centres, xyz, radius, nsample)
    d2 = points.square_distance(centres, xyz).double()
    for b, s in zip(*torch.nonzero((got != want).any(-1), as_tuple=True)):
        for i in set(got[b, s].tolist()) ^ set(want[b, s].tolist()):
            assert abs(d2[b, s, i].item() - radius * radius) <= 1e-6, (b, s, i)
    dist, idx = points.three_nn(xyz.to(cuda), centres.to(cuda))
    dist_cpu, idx_cpu = points.three_nn(xyz, centres)
    torch.testing.assert_close(dist.cpu() ** 2, dist_cpu ** 2, rtol=0, atol=1e-5)
    differ = idx.cpu() != idx_cpu
    if differ.any():
        assert (dist_cpu[differ] ** 2 - dist.cpu()[differ] ** 2).abs().max().item() <= 1e-5
    feats = torch.as_tensor(rng.randn(32, 16, 512), dtype=torch.float32)
    w = torch.as_tensor(rng.rand(32, 2048, 3), dtype=torch.float32)
    torch.testing.assert_close(points.three_interpolate(feats.to(cuda), idx_cpu.to(cuda),
                                                        w.to(cuda)).cpu(),
                               points.three_interpolate(feats, idx_cpu, w), rtol=0, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["PointNet2SSG", "PointNet2MSG"])
def test_pointnet2_forward_on_the_card_matches_the_cpu(cuda, kind):
    """A seeded PointNet++ encoder (4, 256, 1) in eval mode at 4 x 2048 x 7,
    FPS through the kernel (2 launches): the codes within a relative L2 of
    1e-4 of the CPU's (f32 both, TF32 off; sums in another order)."""
    from difffacto_torch import models

    rng = np.random.RandomState(1)
    x = torch.as_tensor(np.concatenate([0.4 * rng.randn(4, 2048, 3),
                                        np.eye(4)[rng.randint(0, 4, (4, 2048))]], -1),
                        dtype=torch.float32)
    cls = getattr(models, kind)
    card = cls(additioinal_dim=4, zdim=256, num_anchors=1, device=cuda)
    cpu = cls(additioinal_dim=4, zdim=256, num_anchors=1, device="cpu")
    before = launched("fps")
    with torch.no_grad():
        got = card(x.to(cuda)).cpu()
        want = cpu(x)
    assert launched("fps") == before + 2
    assert got.shape == want.shape == (4, 1, 256)
    assert ((got - want).norm() / want.norm()).item() <= 1e-4


@pytest.mark.gpu
def test_td_variant_generation_on_the_card_matches_the_cpu(cuda):
    """tests/configs/tiny_gen.py at the trunk kernel's widths (8 heads of 16,
    4 part tokens) on ``PartEncoderForTransformerDecoderKLLoss`` with the std
    in its tokens: every draw injected, the card's generation (one trunk
    launch a step) against the CPU's plain trunk, both in bf16, within 5e-3
    relative L2 (chip_smoke.py's E2E_REL_L2: bf16 steps apart in each of the
    denoiser calls)."""
    import os

    from difffacto_torch import MODELS, Config, build_from_cfg, sample_generation

    cfg = Config(os.path.join(os.path.dirname(__file__), "configs", "tiny_gen.py")).model.dump()
    cfg.update(dtype=torch.bfloat16, num_timesteps=10)
    cfg["encoder"].update(type="PartEncoderForTransformerDecoderKLLoss", include_std=True)
    cfg["diffusion"]["net"].update(n_heads=8, d_head=16)
    rng = np.random.RandomState(0)
    draws = dict(z=rng.randn(2, 4, 16), cimle_noise=rng.randn(2, 32), noise=rng.randn(2, 64, 3),
                 step_noise=rng.randn(10, 2, 64, 3))
    preds = {}
    for where in (cuda, "cpu"):
        model = build_from_cfg(dict(cfg), MODELS, device=where, seed=0)
        d = {k: torch.as_tensor(v, dtype=torch.float32, device=where) for k, v in draws.items()}
        before = launched("fused_core")
        preds[str(where)] = sample_generation(model, 2, **d)["pred"].float().cpu()
        if where == cuda:
            torch.cuda.synchronize()
            assert launched("fused_core") == before + 10
    card, cpu = preds["cuda"], preds["cpu"]
    assert torch.isfinite(card).all()
    assert ((card - cpu).norm() / cpu.norm()).item() < 5e-3


@pytest.mark.gpu
def test_anchored_generation_predict_on_the_card_matches_the_cpu(cuda):
    """``AnchoredGeneration`` (PCN, MeanVarianceRegressor, ComponentMixer with
    attention, PointwiseNet) at latent width 32: a predict with z, x_T and
    the step draws injected on the card and on the CPU, float32 both, within
    1e-4 relative L2 (chip_smoke.py's P14_PREDICT_REL_L2), no kernel launched."""
    from difffacto_torch.models import AnchoredGeneration

    cfg = dict(encoder=dict(type="PCN", point_dim=7, part_latent_dim=32),
               parameter_regressor=dict(type="MeanVarianceRegressor", latent_dim=32),
               decomposer=dict(type="ComponentMixer", part_latent_dim=32, include_attention=True,
                               include_global_feature=True),
               diffusion=dict(type="AnchoredDiffusion",
                              net=dict(type="PointwiseNet", point_dim=3, residual=False),
                              beta_1=1e-4, beta_T=0.02, mode="linear",
                              model_mean_type="epsilon"),
               sampler=dict(type="Uniform"), num_anchors=4, num_timesteps=10, npoints=256)
    rng = np.random.RandomState(1)
    pts = rng.randn(2, 256, 3).astype(np.float32)
    seg = np.repeat(np.arange(4), 64)[None].repeat(2, 0)
    batch = dict(input=pts, ref=pts, seg_mask=seg, attn_map=np.eye(4, dtype=np.float32)[seg])
    draws = dict(z=rng.randn(2, 4, 32), noise=rng.randn(2, 256, 3),
                 step_noise=rng.randn(10, 2, 256, 3))
    preds = {}
    for where in (cuda, "cpu"):
        model = AnchoredGeneration(**cfg, device=where, seed=0)
        d = {k: torch.as_tensor(v, dtype=torch.float32, device=where) for k, v in draws.items()}
        before = launched("fused_core", "fps", "emd_hybrid")
        out = model.predict({k: torch.as_tensor(v, device=where) for k, v in batch.items()}, **d)
        preds[str(where)] = out["pred"].float().cpu()
        assert launched("fused_core", "fps", "emd_hybrid") == before
    card, cpu = preds["cuda"], preds["cpu"]
    assert card.shape == (2, 256, 3) and torch.isfinite(card).all()
    assert ((card - cpu).norm() / cpu.norm()).item() < 1e-4


@pytest.mark.gpu
def test_ldmnet_chain_with_the_fused_ff_on_the_card_matches_the_cpu(cuda):
    """``LDMNet`` with two-attention blocks at inner width 256 (8 heads of
    32) in the ``LDM`` chain over (256, 4, 256) part latents with a 4-token
    context, as ``LatentDiffEdit`` samples: each block's FF is one fused-FF
    launch at D = 256 over 256 x 5 tokens on the card, its plain version
    on the CPU (float32 models, the kernel's operands bf16). x_T and the
    step draws injected; within 5e-3 relative L2 (chip_smoke.py's
    E2E_REL_L2)."""
    from difffacto_torch.models import build_diffusion
    from difffacto_torch.models.denoiser import LDMNet

    B, K, C, T, depth = 256, 4, 256, 10, 2
    diffusion = dict(type="LDM", beta_1=1e-4, beta_T=0.02)
    rng = np.random.RandomState(2)
    ctx = rng.randn(B, K, C + 64).astype(np.float32)
    x_T, steps = rng.randn(B, K, C), rng.randn(T, B, K, C)
    preds = {}
    for where in (cuda, "cpu"):
        net = LDMNet(C, C, n_heads=8, d_head=32, depth=depth, context_dim=C + 64, n_class=K,
                     device=where, generator=torch.Generator().manual_seed(3))
        with torch.no_grad():  # proj_out starts at zero
            net.proj_out.kernel.copy_(0.05 * torch.randn(
                C, C, generator=torch.Generator().manual_seed(4)))
        chain = build_diffusion(diffusion, T)
        put = lambda a: torch.as_tensor(a, dtype=torch.float32, device=where)  # noqa: E731
        before = launched("fused_ff")
        with torch.inference_mode():
            out = chain.p_sample_loop(lambda i, ts, c, *a: net(i, ts, c, *a),
                                      torch.zeros(B, K, C, device=where), ctx=put(ctx),
                                      noise=put(x_T), step_noise=put(steps))["pred"]
        preds[str(where)] = out.float().cpu()
        if where == cuda:
            torch.cuda.synchronize()
            assert launched("fused_ff") == before + T * depth
    card, cpu = preds["cuda"], preds["cpu"]
    assert torch.isfinite(card).all()
    assert ((card - cpu).norm() / cpu.norm()).item() < 5e-3


@pytest.mark.gpu
def test_supseg_predict_on_the_card_matches_the_cpu(cuda):
    """``AnchorDiffGenSuperSegments`` (PCN, the latent projection with the
    learned scale and a GroupNorm'd post-FF, ComponentMixer, PointwiseNet)
    at latent width 32: a predict with x_T and the step draws injected on
    the card and on the CPU, float32 both, within 1e-4 relative L2
    (chip_smoke.py's P14_PREDICT_REL_L2), no kernel launched."""
    from difffacto_torch.models import AnchorDiffGenSuperSegments

    cfg = dict(encoder=dict(type="PCN", point_dim=7, part_latent_dim=32),
               decomposer=dict(type="ComponentMixer", part_latent_dim=32, include_attention=True,
                               include_global_feature=True),
               diffusion=dict(type="AnchoredDiffusion",
                              net=dict(type="PointwiseNet", point_dim=3, residual=False),
                              beta_1=1e-4, beta_T=0.02, mode="linear",
                              model_mean_type="epsilon", include_anchors=False, res=False),
               sampler=dict(type="Uniform"), num_anchors=4, num_timesteps=10, npoints=256,
               part_dim=32, project_latent=True, learn_var=True, post_ff=True)
    rng = np.random.RandomState(5)
    pts = (0.3 * rng.randn(2, 256, 3)).astype(np.float32)
    seg = np.repeat(np.arange(4), 64)[None].repeat(2, 0)
    batch = dict(input=pts, ref=pts, seg_mask=seg, attn_map=np.eye(4, dtype=np.float32)[seg])
    draws = dict(noise=rng.randn(2, 256, 3), step_noise=rng.randn(10, 2, 256, 3))
    preds = {}
    for where in (cuda, "cpu"):
        model = AnchorDiffGenSuperSegments(**cfg, device=where, seed=0)
        d = {k: torch.as_tensor(v, dtype=torch.float32, device=where) for k, v in draws.items()}
        before = launched("fused_core", "fps", "emd_hybrid", "fused_ff")
        out = model.predict({k: torch.as_tensor(v, device=where) for k, v in batch.items()}, **d)
        preds[str(where)] = out["pred"].float().cpu()
        assert launched("fused_core", "fps", "emd_hybrid", "fused_ff") == before
    card, cpu = preds["cuda"], preds["cpu"]
    assert card.shape == (2, 256, 3) and torch.isfinite(card).all()
    assert ((card - cpu).norm() / cpu.norm()).item() < 1e-4
