"""The two-attention trunk as one call: ``ops/fused_core.fused_core_two_attn``.

Its plain version (the CPU's side of the kernel's ``TWO`` form) against the
per-block composition ``TransformerNet._block_trunk``, the denoiser's
dispatch to it, and the benchmark's plain two-attention reference
(``benchmark/reference/generation_two_attn.py``) against the program's
``sample_generation``. CPU only, float32, on weights drawn by
``benchmark/inputs.weights``.
"""

import copy
import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "benchmark"))

import inputs  # noqa: E402
import program  # noqa: E402
from difffacto_torch import sample_generation  # noqa: E402
from difffacto_torch.models import TransformerNet  # noqa: E402
from difffacto_torch.models import denoiser as denoiser_mod  # noqa: E402
from difffacto_torch.ops import fused_core as fc  # noqa: E402
from reference.generation_two_attn import GenerationTwoAttn  # noqa: E402

torch.set_num_threads(min(4, torch.get_num_threads()))

DENOISER = dict(in_channels=3, out_channels=3, n_heads=8, d_head=16, depth=2, context_dim=262,
                n_class=4, class_cond=True, cat_params_to_x=True, single_attn=False,
                cat_class_to_x=True)
# float32 against float32: the same products and LayerNorms summed in another
# order (the kernel's two-pass variance against the module's E[x^2] - E[x]^2,
# f32 scores against the compute dtype's, which is f32 here), over two blocks
# of 128-wide sums at outputs up to |3|: a few float32 ulps, measured at most
# 1.2e-6 on the CPU; 1e-5 is about eight times that, far under any bf16 step.
F32_ATOL = 1e-5


def seeded(module, seed):
    """``module`` with every parameter drawn by ``benchmark/inputs.weights``."""
    layout = [(k, v.shape) for k, v in module.state_dict().items()]
    module.load_state_dict(inputs.weights(layout, seed, "cpu"))
    return module


def denoiser_args(B=2, N=64, seed=1):
    rng = np.random.RandomState(seed)
    a = dict(x=rng.randn(B, N, 3), t=np.array([3, 7][:B]), ctx=rng.randn(B, 4, 262),
             anchors=0.1 * rng.randn(B, N, 3), variances=np.abs(rng.randn(B, N, 3)) + 0.1,
             seg_mask=np.repeat(np.arange(4), N // 4)[None].repeat(B, 0),
             valid_id=np.array([[1, 1, 1, 1], [1, 0, 1, 1]][:B]))
    return [torch.as_tensor(v, dtype=torch.int64 if k in ("t", "seg_mask") else torch.float32)
            for k, v in a.items()]


def test_plain_version_matches_the_block_trunk(monkeypatch):
    """B 2, N 64, depth 2, a part absent in row 1: the two-attention entry's
    plain version, as ``TransformerNet`` calls it, against the same module's
    blocks one by one (the shape rule refused); within ``F32_ATOL`` (see
    there)."""
    net = seeded(TransformerNet(**DENOISER, device="cpu"), 5)
    args = denoiser_args()
    spy = _Spy(monkeypatch)
    with torch.no_grad():
        got = net(*args)
        monkeypatch.setattr(denoiser_mod, "trunk_kernel_takes", lambda *a: False)
        want = net(*args)
    assert spy.calls == ["fused_core_two_attn", "_block_trunk"]
    assert got.shape == want.shape == (2, 64, 3)
    err = (got - want).abs().max().item()
    print(f"two-attention trunk, plain version against the blocks: max abs {err:.3e}")
    assert err <= F32_ATOL


def test_plain_version_holds_each_attention():
    """The entry's plain version is the single-attention trunk's where the
    first attention adds nothing (Wout1 and bout1 zero), and differs where
    it does: both attentions are in it."""
    args = fc.operands(fc.example_inputs(2, 64, depth=2, two_attn=True, seed=3))
    n = len(fc.example_inputs(1, 1, 1))
    with torch.no_grad():
        two = fc.fused_core_two_attn(*args, 16**-0.5)
        bare = fc.fused_core(*args[:n], 16**-0.5)
        silent = list(args)
        silent[n + 5] = torch.zeros_like(args[n + 5])  # wout1
        silent[n + 6] = torch.zeros_like(args[n + 6])  # bout1
        quiet = fc.fused_core_two_attn(*silent, 16**-0.5)
    torch.testing.assert_close(quiet, bare, rtol=0, atol=0)
    assert (two - bare).abs().max().item() > 0.1


class _Spy:
    def __init__(self, monkeypatch):
        self.calls = []
        for name in ("fused_core", "fused_core_two_attn", "fused_core_headless"):
            real = getattr(denoiser_mod, name)
            monkeypatch.setattr(denoiser_mod, name, self._wrap(name, real))
        real_blocks = denoiser_mod.TransformerNet._block_trunk

        def blocks(net, *a, **k):
            self.calls.append("_block_trunk")
            return real_blocks(net, *a, **k)

        monkeypatch.setattr(denoiser_mod.TransformerNet, "_block_trunk", blocks)

    def _wrap(self, name, real):
        def spy(*a, **k):
            self.calls.append(name)
            return real(*a, **k)
        return spy


@pytest.mark.parametrize("case, want", [
    ("two_attn", "fused_core_two_attn"),
    ("single_attn", "fused_core"),
    ("two_attn_train", "_block_trunk"),
    ("two_attn_4x32", "_block_trunk"),
    ("two_attn_add_t_to_x", "_block_trunk"),
    ("two_attn_3_parts", "_block_trunk"),
])
def test_dispatch(monkeypatch, case, want):
    """Generation with two-attention blocks at B1's widths (inner 128, 8
    heads, 4 part tokens) takes the entry, once a call; training, other head
    counts, ``add_t_to_x`` and another number of part tokens run the blocks
    one by one; the single-attention denoiser keeps its own entry."""
    cfg = dict(DENOISER, depth=1)
    if case == "single_attn":
        cfg["single_attn"] = True
    if case.endswith("4x32"):
        cfg.update(n_heads=4, d_head=32)
    if case.endswith("add_t_to_x"):
        cfg["add_t_to_x"] = True
    K = 3 if case.endswith("3_parts") else 4
    if K == 3:
        cfg["n_class"] = 3
    net = seeded(TransformerNet(**cfg, dropout=0.1, device="cpu"), 7)
    x, t, ctx, anchors, variances, seg, valid = denoiser_args(N=48)
    ctx, valid, seg = ctx[:, :K], valid[:, :K], seg % K
    spy = _Spy(monkeypatch)
    train = case.endswith("train")
    with torch.set_grad_enabled(train):
        y = net(x, t, ctx, anchors, variances, seg, valid, train=train,
                generator=torch.Generator().manual_seed(0))
    assert spy.calls == [want] and y.shape == (2, 48, 3) and torch.isfinite(y).all()


def small_two_attn_config():
    """The gen_chair_two_attn configuration at N 64, T 3, run in float32."""
    with open(os.path.join(ROOT, "benchmark", "configs", "gen_chair_two_attn.json")) as f:
        cfg = json.load(f)
    cfg["model"].update(npoints=64, num_timesteps=3)
    cfg["dtype"] = "float32"
    return cfg


def test_reference_matches_the_program():
    """The benchmark's two-attention reference against the program's
    ``sample_generation`` at every published width, N 64, T 3, on seeded
    weights and draws, two of four parts absent in some rows: both float32
    (the program's trunk through the entry's plain version), within 1e-5
    relative L2 a shape (sums in other orders through 14 inverted flow layers,
    the aligner and 3 steps; measured 1.7e-7 on the CPU)."""
    cfg = small_two_attn_config()
    model = cfg["model"]
    seed, B = 2**31 + 11, 3
    net, weights = program.build(cfg, seed, torch.device("cpu"))
    d = inputs.draws(seed, 0, B, model, "cpu")
    valid = torch.tensor([[1, 1, 1, 0], [1, 1, 1, 1], [0, 1, 1, 0]], dtype=torch.float32)
    with torch.no_grad():
        got = sample_generation(net, B, valid_id=valid, **d)["pred"]
    want = GenerationTwoAttn(weights, copy.deepcopy(model)).sample(
        d["z"], d["cimle_noise"], valid, d["noise"], d["step_noise"])
    rel = ((got - want).flatten(1).norm(dim=1) / want.flatten(1).norm(dim=1)).max().item()
    print(f"reference against the program: largest relative L2 {rel:.3e}")
    assert torch.isfinite(got).all() and rel <= 1e-5


def test_reference_refuses_single_attention():
    cfg = small_two_attn_config()
    cfg["model"]["diffusion"]["net"]["single_attn"] = True
    with pytest.raises(NotImplementedError):
        GenerationTwoAttn({}, cfg["model"])


def test_weights_kept_until_a_parameter_changes():
    """The two-attention trunk's cast and stacked weights
    (``TransformerNet._kept_operand``) are built once and kept between
    generation steps; an in-place change of any parameter (an optimizer step,
    ``load_state_dict``) or a new storage rebuilds them, ``eval()`` drops them
    (the way to see a write through ``p.data``, which the version counters
    miss), and under autograd they are neither kept nor taken from the
    store."""
    net = seeded(TransformerNet(**DENOISER, device="cpu"), 5)
    out_w = lambda b: b.attn1.to_out.kernel  # noqa: E731
    args = denoiser_args()
    with torch.no_grad():
        first = net(*args)
        kept = net._kept
        assert len(kept) >= 20
        again = net(*args)
        assert net._kept is kept
        torch.testing.assert_close(again, first, rtol=0, atol=0)
        out_w(net.blocks[1]).mul_(2.0)
        moved = net(*args)
        assert net._kept is not kept and (moved - first).abs().max().item() > 1e-3
        kept = net._kept
        net.load_state_dict(seeded(TransformerNet(**DENOISER, device="cpu"), 5).state_dict())
        torch.testing.assert_close(net(*args), first, rtol=0, atol=0)
        assert net._kept is not kept
        out_w(net.blocks[0]).data.mul_(2.0)
        assert net(*args).equal(first)  # the counters miss it: the kept weights serve
        net.eval()
        assert net._kept == {}
        assert (net(*args) - first).abs().max().item() > 1e-3
        out_w(net.blocks[0]).data.mul_(0.5)
        net.eval()
        torch.testing.assert_close(net(*args), first, rtol=0, atol=0)
    kept, n = net._kept, len(net._kept)
    with torch.enable_grad():
        y = net(*args)
        assert net._kept is kept and len(kept) == n
        (y.sum()).backward()
        assert out_w(net.blocks[0]).grad is not None


def test_single_attention_trunk_keeps_nothing():
    """The single-attention trunk casts and stacks its weights every step
    (``TransformerNet._stacked``): an in-place change is seen at once, and
    nothing is kept."""
    net = seeded(TransformerNet(**dict(DENOISER, single_attn=True), device="cpu"), 5)
    args = denoiser_args()
    with torch.no_grad():
        first = net(*args)
        net.blocks[1].wout.mul_(2.0)
        assert (net(*args) - first).abs().max().item() > 1e-3
    assert net._kept == {}
