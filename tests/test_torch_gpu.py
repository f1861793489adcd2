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
                                               (2, 256, 32, 16)])
def test_fps_matches_plain_version_index_for_index(cuda, B, N, m, distinct):
    """The real shape, a ragged N, and fewer distinct points than samples (all
    remaining distances are 0, so index 0 repeats). Both sides compute
    (dx*dx + dy*dy) + dz*dz in f32 without FMA, so the indices are equal."""
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
# and sums its weight gradients with atomics; autograd through the plain
# version does neither. An H100 showed 2e-3 to 9e-3 in relative L2.
GRAD_REL_L2 = 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("n, p", [(512, 0.0), (512, 0.2), (200, 0.2)])
def test_fused_trunk_train_matches_plain_version(cuda, n, p):
    """Depth 3, a part absent in one row, a ragged N: the forward and dx, dK,
    dV and the 15 parameter gradients; one launch of each kernel."""
    inp = fct.example_inputs(B=2, N=n, depth=3, seed=1, mask=[[1, 1, 1, 1], [1, 1, 0, 1]])
    inp["cot"] = np.random.RandomState(2).randn(2, n, 128).astype(np.float32)
    par = fct.example_params(depth=3, seed=3)
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
    """More tiles than twice the card's SMs, a ragged N and absent parts: every
    block of the backward's persistent grid walks several tiles, reuses its
    scratch and adds many tiles into one dK/dV row."""
    B, n = 24, 1000
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
@pytest.mark.parametrize("D, T", [(128, 16 * 2048), (256, 1024), (256, 384), (128, 100)])
def test_fused_ff_matches_plain_version(cuda, D, T):
    """The denoiser's shape at batch 16, the aligner's at batch 256, a
    smaller aligner T, and a T that is not a multiple of the 64-token tile."""
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

