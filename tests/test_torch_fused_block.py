"""The per-block kernel's plain version, the flat block with a context and the
UNet denoiser against the JAX package.

``ops/fused_block.fused_block_reference`` is held against the Pallas kernel
``fused_denoiser_block_call`` in interpret mode, both fed from the same K and V
(the JAX side in its block-diagonal layout). The flat single-attention block
with a context and ``UNet`` are held against their JAX modules on bridged
random weights, with ``DIFFFACTO_PALLAS_INTERPRET=1`` so that each side takes
its kernel, the port its plain version, where the other does. float32 within
2e-4; bf16 within the bounds measured below.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from difffacto_tpu.models.denoiser import UNet as JaxUNet
from difffacto_tpu.nn.attention import BasicTransformerBlock as JaxBlock
from difffacto_tpu.ops.fused_block import fused_denoiser_block_call
from difffacto_torch.models import TransformerNet, UNet
from difffacto_torch.nn import attention as port_attention
from difffacto_torch.nn.attention import BasicTransformerBlock
from difffacto_torch.ops import fused_block as fb
from difffacto_torch.utils.jax_params import load_jax_params
from difffacto_torch.utils.registry import NETS
from test_torch_modules import DENOISER, randomize, t2n

TOL = dict(rtol=2e-4, atol=2e-4)
# bf16 against bf16: the same rounding points, sums in another order, so a
# value may land one bf16 step apart (3.1e-2 at |4..8|) and later steps carry
# it. Measured on the CPU: the block 3.1e-2 (outputs up to |6|); UNet 5.3e-2,
# a mean of 8.5e-3 and a relative L2 of 7.3e-3 (outputs up to |4.6|; its
# time embedding goes through four bf16 products and two SiLUs, whose error
# every token shares). Each bound is about twice that.
BF16_BLOCK_ATOL, BF16_UNET_ATOL, BF16_UNET_REL_L2 = 6.25e-2, 0.125, 1.5e-2
MASK = np.array([[1, 1, 1, 1], [1, 0, 1, 1]], np.float32)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("DIFFFACTO_PALLAS_INTERPRET", "1")


@pytest.fixture
def block_calls(monkeypatch):
    """The token counts N the flat blocks hand to ``fused_block``."""
    seen = []
    wrapped = port_attention.fused_block

    def spy(x, *args):
        seen.append(x.shape[1])
        return wrapped(x, *args)

    monkeypatch.setattr(port_attention, "fused_block", spy)
    return seen


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_block_reference_matches_pallas_kernel(dtype):
    """B = 2, N = 256, part 1 absent in row 1; the operands in ``dtype``
    except bout, b1, b2 and the mask (f32), as on the card."""
    inp = fb.example_inputs(2, 256, seed=3, mask=MASK)
    f32_names = ("mask", "bout", "b1", "b2")
    jdt = jnp.dtype(dtype)
    j = {k: jnp.asarray(v, jnp.float32 if k in f32_names else jdt) for k, v in inp.items()}
    B, M, H, D = 2, fb.CTX, fb.HEADS, fb.D
    eye = jnp.eye(H, dtype=jdt)
    kh, vh = j["k"].reshape(B, M, H, D // H), j["v"].reshape(B, M, H, D // H)
    k_bd = jnp.einsum("bmhd,gh->bgdhm", kh, eye).reshape(B, D, H * M)
    v_bd = jnp.einsum("bmhd,hg->bhmgd", vh, eye).reshape(B, H * M, D)
    gsum = jnp.kron(eye, jnp.ones((M, M), jdt))
    want = fused_denoiser_block_call(
        j["x"], k_bd, v_bd, jnp.tile(j["mask"].astype(jdt), (1, H)), gsum, j["n2_scale"],
        j["n2_bias"], j["wq"], j["wout"], j["bout"], j["ff_scale"], j["ff_bias"], j["w1"],
        j["b1"], j["w2"], j["b2"], 0.25, tile=128, interpret=True)
    want = np.asarray(want).astype(np.float32)
    tdt = getattr(torch, dtype)
    got = fb.fused_block(
        *[torch.as_tensor(v).to(torch.float32 if k in f32_names else tdt) for k, v in inp.items()],
        0.25)
    assert got.dtype == tdt and got.shape == (2, 256, 128)
    if dtype == "float32":
        np.testing.assert_allclose(t2n(got), want, **TOL)
    else:
        np.testing.assert_allclose(t2n(got.float()), want, rtol=0, atol=BF16_BLOCK_ATOL)


@pytest.mark.parametrize("n, kernel", [(256, True), (100, False)])
def test_flat_block_with_context_matches_jax_on_both_branches(interpret, block_calls, n, kernel):
    """N = 256 (pick_tile(256) = 256) takes the kernel, N = 100 (no tile)
    the unfused math with the finfo.min mask; part 1 absent in row 1."""
    rng = np.random.RandomState(n)
    x = rng.randn(2, n, 128).astype(np.float32)
    ctx = rng.randn(2, 4, 22).astype(np.float32)
    jblk = JaxBlock(dim=128, n_heads=8, d_head=16, context_dim=22, single_attn=True)
    jin = [jnp.asarray(a) for a in (x, ctx, MASK)]
    params = randomize(jblk.init(jax.random.PRNGKey(0), *jin)["params"], seed=n)
    want = np.asarray(jblk.apply({"params": params}, *jin))
    blk = BasicTransformerBlock(128, 8, 16, context_dim=22, device="cpu")
    load_jax_params(blk, params)
    with torch.no_grad():
        got = t2n(blk(*[torch.as_tensor(a) for a in (x, ctx, MASK)]))
    assert block_calls == ([n] if kernel else [])
    np.testing.assert_allclose(got, want, **TOL)


UNET = dict(in_channels=3, n_heads=8, d_head=16, depth=2, embed_dim=128, prior_dim=22,
            language_dim=64)


def unet_inputs(language: bool):
    rng = np.random.RandomState(20)
    args = dict(
        x=rng.randn(2, 256, 3).astype(np.float32), t=np.array([5, 60], np.int32),
        ctx=rng.randn(2, 4, 22).astype(np.float32),
        valid_id=MASK, language_code=rng.randn(2, 4, 64).astype(np.float32) if language else None,
    )
    return args


def jax_unet(args, dtype):
    net = JaxUNet(**UNET, dtype=dtype)
    j = {k: None if v is None else jnp.asarray(v) for k, v in args.items()}
    params = randomize(net.init(jax.random.PRNGKey(0), **j)["params"], seed=21)
    return params, np.asarray(net.apply({"params": params}, **j)).astype(np.float32)


def port_unet(args, params, dtype=None):
    net = UNet(**UNET, language_cond=args["language_code"] is not None, dtype=dtype,
               device="cpu")
    load_jax_params(net, params)
    t = {k: None if v is None else torch.as_tensor(v) for k, v in args.items()}
    with torch.no_grad():
        out = net(t["x"], t["t"], t["ctx"], valid_id=t["valid_id"],
                  language_code=t["language_code"])
    return net, out


@pytest.mark.parametrize("language", [False, True])
def test_unet_matches_jax(interpret, block_calls, language):
    """Depth 2, N = 256, inner 128 (8 x 16), the prior tokens with part 1
    absent in row 1 and, in one case, a language code of 4 tokens: every
    flat block takes the kernel on both sides."""
    args = unet_inputs(language)
    params, want = jax_unet(args, None)
    _, got = port_unet(args, params)
    assert got.shape == (2, 256, 3) and got.dtype == torch.float32
    assert block_calls == [256] * (4 if language else 2)
    np.testing.assert_allclose(t2n(got), want, **TOL)


def test_unet_bf16_matches_jax(interpret):
    """The blocks in bf16 with f32 parameters, as on the card; the GroupNorm
    and the scale-shift LayerNorms stay f32 (they have no dtype)."""
    args = unet_inputs(False)
    params, want = jax_unet(args, jnp.bfloat16)
    _, got = port_unet(args, params, torch.bfloat16)
    got = t2n(got.float())
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_UNET_ATOL)
    assert np.linalg.norm(got - want) <= BF16_UNET_REL_L2 * np.linalg.norm(want)


def test_unet_tree_loads_strictly():
    """The UNet tree (GroupNorm_0, Dense_0/1, emb_i, ln_i, prior_block_i,
    lang_block_i) loads; a missing or a left-over key raises, and so does a
    language code the model was not built for."""
    args = unet_inputs(True)
    params, _ = jax_unet(args, None)
    net, _ = port_unet(args, params)
    assert NETS.get("UNet") is UNet
    missing = {k: v for k, v in params.items() if k != "lang_block_1"}
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(net, missing)
    with pytest.raises(KeyError, match="left over"):
        load_jax_params(net, dict(params, GroupNorm_1=params["GroupNorm_0"]))
    plain = UNet(**UNET, device="cpu")
    with pytest.raises(KeyError, match="left over"):
        load_jax_params(plain, params)
    t = {k: torch.as_tensor(v) for k, v in args.items()}
    with pytest.raises(ValueError):
        plain(t["x"], t["t"], t["ctx"], valid_id=t["valid_id"], language_code=t["language_code"])


def test_transformer_net_use_checkpoint_raises():
    """The JAX package cannot run use_checkpoint=True; the port refuses it
    rather than computing without it."""
    with pytest.raises(NotImplementedError, match="use_checkpoint"):
        TransformerNet(**DENOISER, use_checkpoint=True, device="cpu")
