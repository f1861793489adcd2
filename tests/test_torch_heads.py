"""Head counts other than 8 and the shape rules that route modules to the kernels.

The single-attention denoiser at (n_heads, d_head) = (4, 32) and (16, 8)
against the JAX package (its Pallas trunk in interpret mode), for generation
and for the training forward; the trunks' plain versions at those head counts
against the Pallas trunk; and the rules by which ``TransformerNet``,
``BasicTransformerBlock`` and ``FusedLNFF`` send a shape to a kernel wrapper
or to the unfused math. float32 on the CPU, weights through
``load_jax_params``, inputs from a numpy seed.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from difffacto_tpu.models.denoiser import TransformerNet as JaxTransformerNet
from difffacto_torch.models import TransformerNet, UNet
from difffacto_torch.models import denoiser as tden
from difffacto_torch.nn import attention as tatt
from difffacto_torch.nn import layers as tlay
from difffacto_torch.ops import fused_block as fb
from difffacto_torch.ops import fused_core as fc
from difffacto_torch.ops import fused_core_train as fct
from difffacto_torch.utils.jax_params import load_jax_params
from test_torch_fused_core import jax_trunk
from test_torch_modules import DENOISER, randomize, t2n

HEAD_SHAPES = [(4, 32), (16, 8)]


def denoiser_args(B=2, N=128):
    rng = np.random.RandomState(1)
    return dict(
        x=rng.randn(B, N, 3).astype(np.float32),
        t=np.array([3, 7], np.int32),
        ctx=rng.randn(B, 4, 262).astype(np.float32),
        anchors=(0.1 * rng.randn(B, N, 3)).astype(np.float32),
        variances=(np.abs(rng.randn(B, N, 3)) * 0.5 + 0.1).astype(np.float32),
        seg_mask=np.repeat(np.arange(4), N // 4)[None].repeat(B, 0).astype(np.int32),
        valid_id=np.array([[1, 1, 1, 1], [1, 0, 1, 1]], np.float32),
    )


@functools.lru_cache(maxsize=None)
def jax_denoiser(n_heads, d_head):
    """The JAX denoiser's parameters and its output on ``denoiser_args``. At
    dropout 0 its training forward is its generation forward bit for bit, so
    the JAX side runs once per head shape."""
    cfg = dict(DENOISER, n_heads=n_heads, d_head=d_head)
    jnet = JaxTransformerNet(**cfg)
    jargs = [jnp.asarray(a) for a in denoiser_args().values()]
    params = randomize(jnet.init(jax.random.PRNGKey(0), *jargs)["params"], seed=2)
    return params, np.asarray(jnet.apply({"params": params}, *jargs))


@pytest.mark.parametrize("train", [False, True], ids=["generation", "train_forward"])
@pytest.mark.parametrize("n_heads, d_head", HEAD_SHAPES)
def test_transformer_net_head_counts_match_jax(n_heads, d_head, train, monkeypatch):
    """Depth 2, B 2, N 128, a part absent in row 1; the training forward at
    dropout 0. Tolerance 2e-4, the trunk band of
    tests/test_ops.py::TestFusedDenoiserCore. A trunk that computes 8 heads
    whatever n_heads says fails it by far."""
    monkeypatch.setenv("DIFFFACTO_PALLAS_INTERPRET", "1")
    params, want = jax_denoiser(n_heads, d_head)
    net = TransformerNet(**dict(DENOISER, n_heads=n_heads, d_head=d_head), device="cpu")
    load_jax_params(net, params)
    with torch.no_grad():
        got = t2n(net(*[torch.as_tensor(a) for a in denoiser_args().values()], train=train))
    assert got.shape == (2, 128, 3)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("n_heads", [4, 16])
def test_plain_trunks_take_the_head_count(n_heads):
    """``fused_core_reference`` against the Pallas trunk (interpret mode) at
    the head count, 2e-4 as above; the training trunk's plain version at
    p = 0 equals it with proj_in applied outside (the same math, 1e-5)."""
    dh = 128 // n_heads
    inp = fc.example_inputs(B=2, N=128, depth=2, mask=[[1, 1, 1, 1], [1, 0, 1, 1]])
    got = fc.fused_core_reference(*fc.operands(inp), dh**-0.5, n_heads)
    np.testing.assert_allclose(got.numpy(), jax_trunk(inp, n_heads), rtol=2e-4, atol=2e-4)
    eight = fc.fused_core_reference(*fc.operands(inp), dh**-0.5)
    assert (got - eight).abs().max().item() > 1e-2  # the head count matters here

    x, pin_w, pin_b, k, v, mask, *par = fc.operands(inp)
    h0 = x @ pin_w + pin_b
    y = fct.fused_trunk_train_reference(0, h0, k, v, mask, *par, dh**-0.5, 0.0, n_heads)
    torch.testing.assert_close(y, got, rtol=1e-5, atol=1e-5)


class _Spy:
    """Counts the calls of a kernel wrapper and runs it."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **kw):
        self.calls += 1
        return self.fn(*a, **kw)


@pytest.mark.parametrize("width, heads, ctx_tokens, tokens, kernel", [
    (128, 8, 4, 2048, True),   # every shipped denoiser and UNet's part tokens
    (128, 8, 4, 384, True),
    (128, 8, 4, 100, False),   # pick_tile takes no tile of 100 tokens
    (128, 4, 4, 256, False),   # other head counts at width 128
    (128, 16, 4, 256, False),
    (128, 8, 3, 256, False),   # a UNet language code of 3 tokens
    (128, 8, 8, 256, False),
    (256, 8, 4, 256, False),   # another width
])
def test_block_and_trunk_shape_rules(width, heads, ctx_tokens, tokens, kernel, monkeypatch):
    """The rule, and that the flat block with a context calls ``fused_block``
    exactly where it holds; the trunk kernels' rule (``fused_block.takes``,
    which the denoiser applies) ignores the token count."""
    assert tatt.block_kernel_takes(width, heads, ctx_tokens, tokens) is kernel
    assert fb.takes(width, heads, ctx_tokens) is ((width, heads, ctx_tokens) == (128, 8, 4))
    spy = _Spy(tatt.fused_block)
    monkeypatch.setattr(tatt, "fused_block", spy)
    blk = tatt.BasicTransformerBlock(width, heads, width // heads, context_dim=16, device="cpu",
                                     generator=torch.Generator().manual_seed(0))
    x = torch.randn(1, tokens, width)
    with torch.no_grad():
        y = blk(x, torch.randn(1, ctx_tokens, 16), torch.ones(1, ctx_tokens))
    assert spy.calls == int(kernel) and y.shape == x.shape and torch.isfinite(y).all()


@pytest.mark.parametrize("width, tokens, kernel", [
    (128, 256, True), (256, 1024, True), (384, 256, False), (512, 256, False),
    (64, 256, False), (128, 100, False),
])
def test_ff_shape_rule(width, tokens, kernel, monkeypatch):
    """``FusedLNFF`` calls ``fused_ln_geglu_ff`` at D 128 or 256 where
    pick_tile takes the tokens, and the unfused math otherwise."""
    assert tlay.ff_kernel_takes(width, tokens) is kernel
    spy = _Spy(tlay.fused_ln_geglu_ff)
    monkeypatch.setattr(tlay, "fused_ln_geglu_ff", spy)
    ffn = tlay.FusedLNFF(width, device="cpu", generator=torch.Generator().manual_seed(0))
    x = torch.randn(1, tokens, width)
    with torch.no_grad():
        y = ffn(x)
    assert spy.calls == int(kernel) and y.shape == x.shape


@pytest.mark.parametrize("n_heads, d_head, kernel", [(8, 16, True), (4, 32, False)])
def test_transformer_net_calls_the_trunk_by_the_rule(n_heads, d_head, kernel, monkeypatch):
    """The denoiser calls ``fused_core`` (generation) and
    ``fused_trunk_train`` (training) only at 8 heads of 16; at 4 x 32 it runs
    its blocks one by one, and none of them calls ``fused_block`` (the
    one-block kernel takes 8 heads only)."""
    spies = {name: _Spy(getattr(tden, name)) for name in ("fused_core", "fused_trunk_train")}
    for name, spy in spies.items():
        monkeypatch.setattr(tden, name, spy)
    block_spy = _Spy(tatt.fused_block)
    monkeypatch.setattr(tatt, "fused_block", block_spy)
    net = TransformerNet(**dict(DENOISER, n_heads=n_heads, d_head=d_head), device="cpu")
    args = [torch.as_tensor(a) for a in denoiser_args().values()]
    with torch.no_grad():
        net(*args)
        net(*args, train=True)
    assert (spies["fused_core"].calls, spies["fused_trunk_train"].calls) == (
        (1, 1) if kernel else (0, 0))
    assert block_spy.calls == 0


def test_unet_with_a_three_token_language_code_takes_the_unfused_math(monkeypatch):
    """UNet's language blocks attend to 3 tokens: no one-block launch for
    them, the part-token blocks still take the kernel's wrapper."""
    spy = _Spy(tatt.fused_block)
    monkeypatch.setattr(tatt, "fused_block", spy)
    g = torch.Generator().manual_seed(0)
    net = UNet(3, 8, 16, depth=2, prior_dim=20, language_dim=12, language_cond=True,
               device="cpu", generator=g)
    B, N = 2, 128
    with torch.no_grad():
        y = net(torch.randn(B, N, 3), torch.tensor([1, 5]), torch.randn(B, 4, 20),
                valid_id=torch.ones(B, 4), language_code=torch.randn(B, 3, 12))
    assert spy.calls == 2 and y.shape == (B, N, 3) and torch.isfinite(y).all()
