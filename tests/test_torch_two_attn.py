"""The two-attention gen_chair slice (``single_attn=False``) against the JAX package.

The fused LN -> GEGLU FF (``ops/fused_ff``) and its module ``FusedLNFF``,
``CrossAttention`` on both of its paths, the two-attention block with and
without a context, the aligner and ``TransformerNet`` built with two-attention
blocks, and generation through them. Each JAX module is initialised, its
parameters randomised and bridged with ``load_jax_params``; inputs come from a
numpy seed. JAX runs its Pallas kernels in interpret mode
(``DIFFFACTO_PALLAS_INTERPRET=1``), so each side takes its kernel, the port
its plain version, where the other does. float32 within 2e-4 unless stated;
bf16 within the bounds measured below.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from difffacto_tpu.config import Config as JaxConfig
from difffacto_tpu.models.aligner import PartAlignerTransformer as JaxAligner
from difffacto_tpu.models.anchor_diff import AnchorDiffAE as JaxAnchorDiffAE
from difffacto_tpu.models.denoiser import TransformerNet as JaxTransformerNet
from difffacto_tpu.nn.attention import BasicTransformerBlock as JaxBlock
from difffacto_tpu.nn.attention import CrossAttention as JaxCrossAttention
from difffacto_tpu.nn.layers import FusedLNFF as JaxFusedLNFF
from difffacto_tpu.ops.fused_ff import fused_ln_geglu_ff as jax_fused_ff
from difffacto_tpu.utils.registry import MODELS as JAX_MODELS
from difffacto_tpu.utils.registry import build_from_cfg as jax_build
from difffacto_torch import Config, MODELS, build_from_cfg, load_jax_params, sample_generation
from difffacto_torch.models import PartAlignerTransformer, TransformerNet
from difffacto_torch.nn import layers as port_layers
from difffacto_torch.nn.attention import CrossAttention, transformer_block
from difffacto_torch.nn.layers import FusedLNFF
from difffacto_torch.ops import fused_ff
from difffacto_torch.ops.fused_core import operands
from test_torch_generation import CONFIG, VALID, B, N, T, chain_inputs, jax_chain, jax_prepare
from test_torch_modules import ALIGNER, DENOISER, randomize, t2n

TOL = dict(rtol=2e-4, atol=2e-4)
# bf16 against bf16: XLA and PyTorch round at the same points but may sum a
# product in another order, so a value may land one bf16 step apart (2^-8
# relative: 1.6e-2 at |2..4|), and later steps carry it. Measured on the CPU:
# the FF kernel at most 1.6e-2 (outputs up to |6|), the attention 0 on the
# small-context path and 1.6e-2 on the generic one (up to |3|), the denoiser
# 3.1e-2 and a relative L2 of 9.2e-3 (up to |3.3|). Each bound is twice that.
BF16_FF_ATOL, BF16_ATTN_ATOL, BF16_NET_ATOL, BF16_NET_REL_L2 = 3.125e-2, 3.125e-2, 6.25e-2, 2e-2


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("DIFFFACTO_PALLAS_INTERPRET", "1")


@pytest.fixture
def ff_calls(monkeypatch):
    """The token counts FusedLNFF hands to ``fused_ln_geglu_ff``: the
    kernel's calls, on the CPU its plain version's."""
    seen = []
    wrapped = port_layers.fused_ln_geglu_ff

    def spy(x, *args):
        seen.append(x.shape[0])
        return wrapped(x, *args)

    monkeypatch.setattr(port_layers, "fused_ln_geglu_ff", spy)
    return seen


@pytest.fixture
def trunk_calls(monkeypatch):
    """The token counts the denoiser hands to ``fused_core_two_attn``, the
    two-attention trunk's entry: the kernel's calls, on the CPU its plain
    version's."""
    from difffacto_torch.models import denoiser

    seen = []
    wrapped = denoiser.fused_core_two_attn

    def spy(x, *args):
        seen.append(x.shape[0] * x.shape[1])
        return wrapped(x, *args)

    monkeypatch.setattr(denoiser, "fused_core_two_attn", spy)
    return seen


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D, T", [(128, 256), (256, 128)])
def test_fused_ff_reference_matches_pallas_kernel(D, T, dtype):
    """The plain version against the Pallas kernel in interpret mode, at the
    denoiser's and the aligner's widths; x, the LayerNorm's parameters and
    the weights in ``dtype``, the biases f32, as on the card."""
    inp = fused_ff.example_inputs(T, D, seed=D)
    f32 = ("b1", "b2")
    jdt = jnp.dtype(dtype)
    want = np.asarray(jax_fused_ff(
        *[jnp.asarray(v, jnp.float32 if k in f32 else jdt) for k, v in inp.items()], 128, True))
    got = fused_ff.fused_ln_geglu_ff(*operands(inp, "cpu", getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype) and got.shape == (T, D)
    if dtype == "float32":
        np.testing.assert_allclose(t2n(got), want, **TOL)
    else:
        np.testing.assert_allclose(t2n(got.float()), want.astype(np.float32), rtol=0,
                                   atol=BF16_FF_ATOL)


@pytest.mark.parametrize("n, kernel", [(64, True), (2, False)])
def test_fused_lnff_matches_jax_on_both_branches(interpret, ff_calls, n, kernel):
    """B = 4: T = 256 takes the kernel (the port's plain version), T = 8 the
    unfused composition, on both sides."""
    x = np.random.RandomState(n).randn(4, n, 128).astype(np.float32)
    jff = JaxFusedLNFF(dim=128)
    params = randomize(jff.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], seed=n)
    want = np.asarray(jff.apply({"params": params}, jnp.asarray(x)))
    ff = FusedLNFF(128, device="cpu")
    load_jax_params(ff, params)
    with torch.no_grad():
        got = t2n(ff(torch.as_tensor(x)))
    assert ff_calls == ([4 * n] if kernel else [])
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("path", ["small_ctx", "generic"])
def test_cross_attention_matches_jax(path, dtype):
    """small_ctx: 64 point tokens to 4 part tokens (the denoiser's case), a
    part absent in row 1; generic: self-attention over the 4 part tokens
    (the aligner's case, N = M), a part absent in row 0."""
    rng = np.random.RandomState(7)
    if path == "small_ctx":
        dim, dh, x, ctx = 128, 16, rng.randn(2, 64, 128), rng.randn(2, 4, 22)
        mask = np.array([[1, 1, 1, 1], [1, 0, 1, 1]], np.float32)
    else:
        dim, dh, x, ctx = 256, 32, rng.randn(2, 4, 256), None
        mask = np.array([[0, 1, 1, 1], [1, 1, 1, 1]], np.float32)
    x = x.astype(np.float32)
    ctx = None if ctx is None else ctx.astype(np.float32)
    jdt = jnp.dtype(dtype)
    jattn = JaxCrossAttention(query_dim=dim, context_dim=None if ctx is None else 22, heads=8,
                              dim_head=dh, dtype=jdt)
    jin = [jnp.asarray(x), None if ctx is None else jnp.asarray(ctx), jnp.asarray(mask)]
    params = randomize(jattn.init(jax.random.PRNGKey(0), *jin)["params"], seed=8)
    want = np.asarray(jattn.apply({"params": params}, *jin)).astype(np.float32)
    attn = CrossAttention(dim, None if ctx is None else 22, 8, dh, dtype=getattr(torch, dtype),
                          device="cpu")
    load_jax_params(attn, params)
    with torch.no_grad():
        got = attn(torch.as_tensor(x), None if ctx is None else torch.as_tensor(ctx),
                   torch.as_tensor(mask))
    assert got.dtype == getattr(torch, dtype) and got.shape == x.shape
    if dtype == "float32":
        np.testing.assert_allclose(t2n(got), want, **TOL)
    else:
        np.testing.assert_allclose(t2n(got.float()), want, rtol=0, atol=BF16_ATTN_ATOL)


@pytest.mark.parametrize("with_ctx", [True, False])
def test_two_attention_block_matches_jax(interpret, ff_calls, with_ctx):
    """With a context (the denoiser: 64 tokens x 4 rows, so the FF kernel's
    T = 256) and without (the aligner: self-attention over 4 part tokens,
    T = 16, the unfused FF)."""
    rng = np.random.RandomState(9)
    n = 64 if with_ctx else 4
    x = rng.randn(4, n, 128).astype(np.float32)
    ctx = rng.randn(4, 4, 22).astype(np.float32) if with_ctx else None
    mask = np.array([[1, 1, 1, 1], [1, 0, 1, 1], [0, 1, 1, 1], [1, 1, 1, 0]], np.float32)
    jblk = JaxBlock(dim=128, n_heads=8, d_head=16, context_dim=22 if with_ctx else None,
                    single_attn=False)
    jin = [jnp.asarray(x), None if ctx is None else jnp.asarray(ctx), jnp.asarray(mask)]
    params = randomize(jblk.init(jax.random.PRNGKey(0), *jin)["params"], seed=10)
    want = np.asarray(jblk.apply({"params": params}, *jin))
    blk = transformer_block(128, 8, 16, context_dim=22 if with_ctx else None, device="cpu")
    load_jax_params(blk, params)
    with torch.no_grad():
        got = t2n(blk(torch.as_tensor(x), None if ctx is None else torch.as_tensor(ctx),
                      torch.as_tensor(mask)))
    assert ff_calls == ([4 * n] if with_ctx else [])
    np.testing.assert_allclose(got, want, **TOL)
    # Training (dropout 0 here) runs the unfused math under autograd, as the
    # JAX block trains (deterministic=False); it raised before it was ported.
    want_train = np.asarray(jblk.apply({"params": params}, *jin, None, False))
    got_train = blk(torch.as_tensor(x), None if ctx is None else torch.as_tensor(ctx),
                    torch.as_tensor(mask), train=True)
    assert got_train.requires_grad and ff_calls == ([4 * n] if with_ctx else [])
    np.testing.assert_allclose(t2n(got_train.detach()), want_train, **TOL)


def test_aligner_two_attention_matches_jax(interpret, ff_calls):
    """gen_chair's aligner (8 x 32 = 256 wide, CIMLE noise injected) with
    two-attention blocks, depth 2, at batch 32: T = 4 x 32 = 128 tokens, so
    every block takes the FF kernel on both sides. Parts absent in two rows."""
    cfg = dict(ALIGNER, single_attn=False, depth=2)
    rng = np.random.RandomState(11)
    code = rng.randn(32, 4, 256).astype(np.float32)
    valid = np.ones((32, 4), np.float32)
    valid[3, 1] = valid[17, 0] = valid[17, 2] = 0.0
    noise = rng.randn(32, 32).astype(np.float32)
    jal = JaxAligner(**cfg)
    jin = [jnp.asarray(a) for a in (code, valid, noise)]
    params = randomize(jal.init(jax.random.PRNGKey(0), *jin)["params"], 12)
    want = [np.asarray(a) for a in jal.apply({"params": params}, *jin)]
    al = PartAlignerTransformer(**cfg, device="cpu")
    load_jax_params(al, params)
    with torch.no_grad():
        got = [t2n(a) for a in al(*[torch.as_tensor(a) for a in (code, valid, noise)])]
    assert ff_calls == [128, 128]
    for g, w in zip(got, want):
        assert g.shape == (32, 4, 3)
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transformer_net_two_attention_matches_jax(interpret, ff_calls, trunk_calls, dtype):
    """gen_chair's denoiser widths with two-attention blocks, depth 2, a part
    absent in row 1: B x N = 256 tokens. The JAX module runs its blocks one by
    one, each FF through its kernel; the port runs the whole trunk as one call
    of the two-attention entry (its plain version here), with no FF call of
    its own. In bf16 the denoiser computes in bf16 with f32 parameters, as on
    the card."""
    rng = np.random.RandomState(13)
    Bn, Nn = 2, 128
    args = dict(
        x=rng.randn(Bn, Nn, 3).astype(np.float32),
        t=np.array([3, 7], np.int32),
        ctx=rng.randn(Bn, 4, 262).astype(np.float32),
        anchors=(0.1 * rng.randn(Bn, Nn, 3)).astype(np.float32),
        variances=(np.abs(rng.randn(Bn, Nn, 3)) * 0.5 + 0.1).astype(np.float32),
        seg_mask=np.repeat(np.arange(4), Nn // 4)[None].repeat(Bn, 0).astype(np.int32),
        valid_id=np.array([[1, 1, 1, 1], [1, 0, 1, 1]], np.float32),
    )
    cfg = dict(DENOISER, single_attn=False)
    jnet = JaxTransformerNet(**cfg, dtype=jnp.dtype(dtype))
    jargs = [jnp.asarray(a) for a in args.values()]
    params = randomize(jnet.init(jax.random.PRNGKey(0), *jargs)["params"], seed=14)
    want = np.asarray(jnet.apply({"params": params}, *jargs)).astype(np.float32)
    net = TransformerNet(**cfg, dtype=getattr(torch, dtype), device="cpu")
    load_jax_params(net, params)
    with torch.no_grad():
        got = t2n(net(*[torch.as_tensor(a) for a in args.values()]).float())
    assert got.shape == (Bn, Nn, 3) and ff_calls == [] and trunk_calls == [Bn * Nn]
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **TOL)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_NET_ATOL)
        assert np.linalg.norm(got - want) <= BF16_NET_REL_L2 * np.linalg.norm(want)


def two_attention(mcfg):
    """test_torch_generation's reduced gen_chair with single_attn=False in the
    aligner and in the denoiser."""
    mcfg.update(npoints=N, num_timesteps=T, ret_traj=False, cimle_sample_num=1)
    mcfg["diffusion"]["net"].update(depth=2, single_attn=False)
    mcfg["encoder"]["part_aligner"].update(depth=1, single_attn=False)
    mcfg["encoder"]["latent_flow_depth"] = 2
    return mcfg


def test_two_attention_generation_matches_jax(interpret, ff_calls, trunk_calls):
    """The slice: flow prior -> two-attention aligner -> T = 10 reverse steps
    through the two-attention denoiser, every draw injected, a part absent in
    two rows. The aligner's T = 4 x 3 takes the unfused FF, the denoiser's
    3 x 128 tokens the two-attention trunk's entry once a step. Tolerance as
    for test_torch_generation."""
    from __graft_entry__ import _example_batch

    jmodel = jax_build(two_attention(JaxConfig(CONFIG).model.dump()), JAX_MODELS)
    variables = jax.jit(lambda r, b: jmodel.init(r, b, 0, method=JaxAnchorDiffAE.loss))(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)},
        _example_batch(B=2, npoints=N),
    )
    variables = {"params": randomize(variables["params"], seed=3)}
    pmodel = build_from_cfg(two_attention(Config(CONFIG).model.dump()), MODELS, device="cpu")
    load_jax_params(pmodel, variables["params"])

    z = np.random.RandomState(16).randn(B, 4, 256).astype(np.float32)
    jctx, jmean, jvar, jseg, jvid, jlat = jax_prepare(
        jmodel, variables, z, VALID, np.zeros(4, np.float32))
    step_noise, x_T = chain_inputs(17)
    want = jax_chain(jmodel, variables, jmean, jctx, jvar, jseg, jvid, x_T, step_noise)
    out = sample_generation(
        pmodel, B, valid_id=torch.as_tensor(VALID), z=torch.as_tensor(z),
        cimle_noise=torch.as_tensor(jlat[3]), noise=torch.as_tensor(x_T),
        step_noise=torch.as_tensor(step_noise),
    )
    assert out["pred"].shape == (B, N, 3) and ff_calls == [] and trunk_calls == [B * N] * T
    np.testing.assert_array_equal(t2n(out["seg_mask"]), jseg)
    np.testing.assert_allclose(t2n(out["anchors"]), jmean, **TOL)
    np.testing.assert_allclose(t2n(out["pred"]), want, rtol=1e-4, atol=1e-4)
