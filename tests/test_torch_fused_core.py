"""The port's denoiser trunk (difffacto_torch/ops/fused_core.py) against the
TPU kernel it replaces (difffacto_tpu/ops/fused_core.py), in each of its
four (head, tail) forms, and ``TransformerNet`` under the two switches that
pick them (``DIFFFACTO_FUSE_HEAD``, ``DIFFFACTO_FUSE_TAIL``) against the JAX
module under the same switches. The CUDA kernel is held against the plain
version in tests/test_torch_gpu.py."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from difffacto_tpu.ops.fused_core import fused_denoiser_core_call
from difffacto_torch.ops import fused_core as fc
from difffacto_torch.utils import trace

H, DH, M = 8, 16, 4


def jax_trunk(inp, heads=H, head=True, tail=None):
    """The Pallas kernel in interpret mode, with the block-diagonal K/V the
    JAX denoiser builds (difffacto_tpu/models/denoiser.py:217-234) for
    ``heads`` heads of 128 / heads channels; ``head=False`` passes x as h0,
    ``tail`` (pout_w, pout_b) fuses proj_out."""
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
        dh**-0.5, interpret=True, pin_w=j["pin_w"] if head else None,
        pin_b=j["pin_b"] if head else None,
        pout_w=None if tail is None else jnp.asarray(tail[0]),
        pout_b=None if tail is None else jnp.asarray(tail[1]),
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
    before = trace.counters()
    out = fc.fused_core(*fc.operands(inp), DH**-0.5)
    assert trace.counters() == before
    assert torch.equal(out, fc.fused_core_reference(*fc.operands(inp), DH**-0.5))


def tail_weights(out_ch, seed):
    rng = np.random.RandomState(seed)
    return ((rng.randn(H * DH, out_ch) * (H * DH) ** -0.5).astype(np.float32),
            (0.1 * rng.randn(out_ch)).astype(np.float32))


@pytest.mark.parametrize("head, out_ch", [(True, 3), (False, 3), (True, 6), (False, 8)])
def test_tail_forms_match_pallas_kernel(head, out_ch):
    """The trunk with proj_out fused (the TPU kernel's has_tail=True), with
    and without the head, at gen_chair's OUT = 3, the learned variance's 6
    and the kernel's widest 8; f32 at the 2e-4 band above."""
    inp = fc.example_inputs(B=2, N=128, depth=2, in_ch=13 if head else fc.D, seed=out_ch,
                            mask=[[1, 1, 1, 1], [1, 1, 0, 1]])
    pout = tail_weights(out_ch, seed=out_ch + 1)
    want = jax_trunk(inp, head=head, tail=pout)
    ops = fc.operands(inp)
    if not head:
        ops[1] = ops[2] = None
    got = fc.fused_core_reference(*ops, DH**-0.5, pout_w=torch.as_tensor(pout[0]),
                                  pout_b=torch.as_tensor(pout[1])).numpy()
    assert got.shape == (2, 128, out_ch)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tail_is_proj_out_after_the_trunk(dtype):
    """The plain version with the tail is the plain trunk followed by
    proj_out with f32 sums, rounded once to x's dtype."""
    ops = fc.operands(fc.example_inputs(B=2, N=64, depth=2, seed=5), dtype=dtype)
    pw, pb = (torch.as_tensor(a) for a in tail_weights(3, seed=6))
    pw = pw.to(dtype)
    h = fc.fused_core_reference(*ops, DH**-0.5)
    got = fc.fused_core_reference(*ops, DH**-0.5, pout_w=pw, pout_b=pb)
    assert got.dtype == dtype
    assert torch.equal(got, (h.float() @ pw.float() + pb).to(dtype))


def test_cpu_tail_wrappers_run_plain_version_without_counting():
    ops = fc.operands(fc.example_inputs(B=1, N=32, depth=1, in_ch=fc.D))
    pw, pb = (torch.as_tensor(a) for a in tail_weights(3, seed=2))
    counts = trace.counters()
    got = fc.fused_core_tail(*ops, pw, pb, DH**-0.5)
    got_hl = fc.fused_core_headless_tail(ops[0], *ops[3:], pw, pb, DH**-0.5)
    assert trace.counters() == counts
    assert torch.equal(got, fc.fused_core_reference(*ops, DH**-0.5, pout_w=pw, pout_b=pb))
    assert torch.equal(got_hl, fc.fused_core_reference(ops[0], None, None, *ops[3:], DH**-0.5,
                                                       pout_w=pw, pout_b=pb))


@pytest.mark.parametrize("fuse_head, fuse_tail", [("1", ""), ("0", ""), ("1", "1"), ("0", "1")])
def test_transformer_net_switches_match_jax(monkeypatch, fuse_head, fuse_tail):
    """``TransformerNet`` with ``DIFFFACTO_FUSE_HEAD`` and
    ``DIFFFACTO_FUSE_TAIL`` set as given, against the JAX module under the
    same settings, its Pallas trunk in interpret mode (as
    tests/test_ops.py::test_fused_head_tail_match_module_path runs it):
    float32, depth 2, N = 256, a part absent in row 1, at that test's 2e-4.
    Each setting reaches its own entry of the port's trunk."""
    from difffacto_tpu.models.denoiser import TransformerNet as JaxTransformerNet
    from difffacto_torch.models import TransformerNet, denoiser
    from difffacto_torch.utils.jax_params import load_jax_params
    from test_torch_modules import DENOISER, randomize

    monkeypatch.setenv("DIFFFACTO_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("DIFFFACTO_FUSE_HEAD", fuse_head)
    monkeypatch.setenv("DIFFFACTO_FUSE_TAIL", fuse_tail)
    rng = np.random.RandomState(7)
    B, N = 2, 256
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
    params = randomize(jnet.init(jax.random.PRNGKey(0), *jargs)["params"], seed=8)
    want = np.asarray(jnet.apply({"params": params}, *jargs))

    net = TransformerNet(**DENOISER, device="cpu")
    load_jax_params(net, params)
    entry = {("1", ""): "fused_core", ("0", ""): "fused_core_headless",
             ("1", "1"): "fused_core_tail", ("0", "1"): "fused_core_headless_tail"}
    calls = []
    wrapped = getattr(denoiser, entry[fuse_head, fuse_tail])
    monkeypatch.setattr(denoiser, entry[fuse_head, fuse_tail],
                        lambda *a, **k: calls.append(1) or wrapped(*a, **k))
    with torch.no_grad():
        got = net(*[torch.as_tensor(a) for a in args.values()]).numpy()
    assert calls == [1]
    assert got.shape == (B, N, 3)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
