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

torch.set_num_threads(1)

DH = 16

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
    before = fc.launches
    got = fc.fused_core(*args, DH**-0.5)
    torch.cuda.synchronize()
    assert fc.launches == before + 1
    want = fc.fused_core_reference(*args, DH**-0.5)
    assert got.shape == want.shape == (B, N, 128)
    assert torch.isfinite(got.float()).all()
    err = (got.float() - want.float()).abs()
    print(f"fused_core B={B} N={N} depth={depth} ({sched['total_tiles']} tiles on "
          f"{sched['grid']} blocks): max abs err {err.max().item():.3e}, "
          f"mean {err.mean().item():.3e}")
    assert err.max().item() <= BF16_MAX_ABS and err.mean().item() <= BF16_MEAN_ABS


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
    before = fps_mod.launches
    got = fps_mod.furthest_point_sample(x, m)
    torch.cuda.synchronize()
    assert fps_mod.launches == before + 1
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
    before = fps_mod.launches
    idx = fps_mod.latency_floor_probe(x, 2048)
    torch.cuda.synchronize()
    assert fps_mod.launches == before
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
    before = eh.launches
    got, rounds, bids = eh.emd_assignment_hybrid(a, b, auction_iters=150, return_work=True)
    torch.cuda.synchronize()
    assert eh.launches == before + 1
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
    if torch.equal(got, want):
        assert torch.equal(rounds, rounds_w) and torch.equal(bids, bids_w)
    if n == 512:
        from scipy.optimize import linear_sum_assignment

        for i in range(2):
            d = torch.cdist(a[i], b[i]).cpu().numpy()
            ri, ci = linear_sum_assignment(d)
            assert cg[i].item() <= 1.01 * d[ri, ci].mean()


def _hold_emd(a, b, label):
    """The kernel against its plain version with the gates above: in range,
    matched cost within 0.5 %, the bids invariant; the share of equal
    assignments is printed, not held."""
    before = eh.launches
    got, rounds, bids = eh.emd_assignment_hybrid(a, b, auction_iters=150, return_work=True)
    torch.cuda.synchronize()
    assert eh.launches == before + 1
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
    got, rounds, bids = eh.emd_assignment_hybrid(a, b, auction_iters=150, return_work=True)
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
    before = fct.launches_fwd, fct.launches_bwd
    y, g = fct.run_example(fct.fused_trunk_train, inp, par, p, 99, cuda)
    torch.cuda.synchronize()
    assert (fct.launches_fwd, fct.launches_bwd) == (before[0] + 1, before[1] + 1)
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
    before = ff.launches
    got = ff.fused_ln_geglu_ff(*args)
    torch.cuda.synchronize()
    assert ff.launches == before + 1
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
    before = fb.launches
    got = fb.fused_block(*args, DH**-0.5)
    torch.cuda.synchronize()
    assert fb.launches == before + 1
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

    counts = lambda: (fc.launches, fct.launches_fwd, fct.launches_bwd, fb.launches, ff.launches)
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
        assert fb.launches == before[3] + 2  # the part-token blocks still take the kernel
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
    before = fps_mod.launches
    got = separate_point_cloud(xyz.to(cuda), n, crop, fixed_points=center,
                               padding_zeros=padding_zeros, rng=np.random.RandomState(1))
    torch.cuda.synchronize()
    want = separate_point_cloud(xyz, n, crop, fixed_points=center, padding_zeros=padding_zeros,
                                rng=np.random.RandomState(1))
    assert fps_mod.launches == before + (2 if isinstance(crop, list) else 0)
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
