"""The front's variants of the port against the JAX package, on the same weights.

The aligner's CIMLE noise types 1-4, the unfused transformer blocks (adaLN,
``gated_ff=False``, ``n_heads * d_head != dim``), the ``TransformerNet`` that
adds t to x (whose trunk runs the head-less kernel entry, here its plain
version) with the class one-hot left out and 6 output channels, and the part
encoder's ``encode_ref``. Each JAX module is initialised, its parameters
randomised and carried into the port by ``load_jax_params``; inputs come
from a numpy seed. float32 on the CPU; the JAX modules take their unfused
XLA paths there, and the tolerance is rtol = atol = 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difffacto_tpu.models.aligner import PartAlignerTransformer as JaxAligner
from difffacto_tpu.models.denoiser import TransformerNet as JaxTransformerNet
from difffacto_tpu.models.part_encoder import PartEncoderForTransformerDecoder as JaxPartEncoder
from difffacto_tpu.nn.attention import BasicTransformerBlock as JaxBlock
from test_torch_generation import randomize, t2n

import difffacto_torch.models.denoiser as pden
from difffacto_torch.models import PartAlignerTransformer, PartEncoderForTransformerDecoder
from difffacto_torch.models import TransformerNet
from difffacto_torch.nn.attention import TransformerBlock, transformer_block
from difffacto_torch.utils.jax_params import load_jax_params

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
VALID = np.array([[1, 1, 1, 1], [0, 1, 1, 1], [1, 1, 0, 0]], np.float32)
ALIGNER = dict(in_channels=16, out_channels=6, n_class=4, d_head=8, depth=2, n_heads=4,
               single_attn=True, class_cond=True, add_class_cond=True, cimle=True,
               noise_scale=10.0, noise_dim=32)


# ---------------------------------------------------------------- aligner
@pytest.mark.parametrize("single_attn", [True, False])
@pytest.mark.parametrize("noise_type, noise_width", [(1, 32), (1, 8), (1, None), (2, 32),
                                                     (3, 32), (4, 32)])
def test_aligner_noise_types_match_jax(noise_type, noise_width, single_attn):
    """Type 1 with a token as wide as the blocks (4 x 8 = 32: masked in),
    one of another width and none (both a zero token, masked out); 2 adaLN
    in every block; 3 the emb_layer shift and scale after pre_norm; 4 the
    emb_layer MLP before the concat. Parts absent in two rows."""
    cfg = dict(ALIGNER, cond_noise_type=noise_type, single_attn=single_attn)
    rng = np.random.RandomState(noise_type)
    code = rng.randn(3, 4, 16).astype(np.float32)
    noise = None if noise_width is None else (0.3 * rng.randn(3, noise_width)).astype(np.float32)
    jal = JaxAligner(**cfg)
    jin = [jnp.asarray(code), jnp.asarray(VALID), None if noise is None else jnp.asarray(noise)]
    params = randomize(jal.init(jax.random.PRNGKey(0), *jin)["params"], seed=7)
    want = [np.asarray(a) for a in jal.apply({"params": params}, *jin)]
    al = PartAlignerTransformer(**cfg, device="cpu")
    load_jax_params(al, params)
    with torch.no_grad():
        got = al(torch.as_tensor(code), torch.as_tensor(VALID),
                 None if noise is None else torch.as_tensor(noise))
    for g, w in zip(got, want):
        assert g.shape == (3, 4, 3)
        np.testing.assert_allclose(t2n(g), w, **TOL)


# ----------------------------------------------------------------- blocks
BLOCKS = {
    "adaln": dict(dim=32, n_heads=4, d_head=8, single_attn=True, adaln=True, y_dim=12),
    "adaln_two_attention": dict(dim=32, n_heads=4, d_head=8, adaln=True, y_dim=12),
    "glu_false": dict(dim=32, n_heads=4, d_head=8, single_attn=True, gated_ff=False),
    "heads_x_dhead_ne_dim": dict(dim=48, n_heads=2, d_head=8, single_attn=True),
    "heads_x_dhead_ne_dim_glu_false": dict(dim=48, n_heads=2, d_head=8, single_attn=True,
                                           gated_ff=False),
}


@pytest.mark.parametrize("with_ctx", [True, False])
@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_unfused_blocks_match_jax(kind, with_ctx):
    """Each block the JAX ``BasicTransformerBlock`` computes in its unfused
    layout, with a context of 4 tokens (10 wide) and a mask, and without one
    (self-attention over 6 tokens); ``transformer_block`` picks that layout."""
    cfg = BLOCKS[kind]
    rng = np.random.RandomState(len(kind))
    n = 24 if with_ctx else 6
    x = rng.randn(3, n, cfg["dim"]).astype(np.float32)
    ctx = rng.randn(3, 4, 10).astype(np.float32) if with_ctx else None
    mask = VALID if with_ctx else np.ones((3, n), np.float32)
    y = rng.randn(3, cfg.get("y_dim", 32)).astype(np.float32)
    jblk = JaxBlock(context_dim=10 if with_ctx else None, **cfg)
    jin = [jnp.asarray(x), None if ctx is None else jnp.asarray(ctx), jnp.asarray(mask),
           jnp.asarray(y)]
    params = randomize(jblk.init(jax.random.PRNGKey(0), *jin)["params"], seed=8)
    want = np.asarray(jblk.apply({"params": params}, *jin))
    blk = transformer_block(context_dim=10 if with_ctx else None, device="cpu", **cfg)
    assert isinstance(blk, TransformerBlock)
    load_jax_params(blk, params)
    with torch.no_grad():
        got = blk(torch.as_tensor(x), None if ctx is None else torch.as_tensor(ctx),
                  torch.as_tensor(mask), y=torch.as_tensor(y))
    np.testing.assert_allclose(t2n(got), want, **TOL)


# ----------------------------------------------------------------- denoiser
NET = dict(in_channels=3, n_heads=8, d_head=16, depth=2, context_dim=22, n_class=4,
           class_cond=True, cat_params_to_x=True, single_attn=True, cat_class_to_x=True,
           add_t_to_x=True)


def net_inputs(seed, B=2, N=32):
    rng = np.random.RandomState(seed)
    return dict(
        x=rng.randn(B, N, 3).astype(np.float32), t=np.array([0.02, 0.0031], np.float32),
        ctx=rng.randn(B, 4, 22).astype(np.float32),
        anchors=(0.1 * rng.randn(B, N, 3)).astype(np.float32),
        variances=(np.abs(rng.randn(B, N, 3)) * 0.5 + 0.1).astype(np.float32),
        seg_mask=np.repeat(np.arange(4), N // 4)[None].repeat(B, 0).astype(np.int32),
        valid_id=np.array([[1, 1, 1, 1], [1, 0, 1, 1]], np.float32),
    )


@pytest.mark.parametrize("changes", [dict(out_channels=3), dict(out_channels=6),
                                     dict(out_channels=6, add_class_cond=True)])
def test_transformer_net_adding_t_to_x_matches_jax(monkeypatch, changes):
    """The time embedding (128 wide) biases h0 instead of joining the
    context, and the trunk is the head-less entry's (its plain version on
    the CPU; the JAX module's unfused composition); 6 output channels for a
    learned variance; ``add_class_cond`` leaves out the class one-hot."""
    cfg = dict(NET, **changes)
    args = net_inputs(3)
    jnet = JaxTransformerNet(**cfg)
    jargs = [jnp.asarray(a) for a in args.values()]
    params = randomize(jnet.init(jax.random.PRNGKey(0), *jargs)["params"], seed=4)
    want = np.asarray(jnet.apply({"params": params}, *jargs))

    calls = []
    real = pden.fused_core_headless
    monkeypatch.setattr(pden, "fused_core_headless",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    net = TransformerNet(**cfg, device="cpu")
    assert net.blocks[0].wk.shape == (22 + (0 if cfg.get("add_class_cond") else 4), 128)
    load_jax_params(net, params)
    with torch.no_grad():
        got = t2n(net(*[torch.as_tensor(a) for a in args.values()]))
    assert calls == [(2, 32, 128)] and got.shape == (2, 32, cfg["out_channels"])
    np.testing.assert_allclose(got, want, **TOL)


def test_transformer_net_trains_with_t_added_to_x():
    """Under autograd (the training trunk's plain version on the CPU) the
    same weights give the JAX training forward's output, dropout off."""
    args = net_inputs(5)
    jnet = JaxTransformerNet(**NET, out_channels=3)
    jargs = [jnp.asarray(a) for a in args.values()]
    params = randomize(jnet.init(jax.random.PRNGKey(0), *jargs)["params"], seed=6)
    want = np.asarray(jnet.apply({"params": params}, *jargs, deterministic=False))
    net = TransformerNet(**NET, out_channels=3, device="cpu")
    load_jax_params(net, params)
    got = net(*[torch.as_tensor(a) for a in args.values()], train=True)
    got.sum().backward()
    assert net.time_embed.dense0.kernel.grad is not None
    np.testing.assert_allclose(t2n(got), want, **TOL)


def test_transformer_net_without_a_context_raises_as_jax_fails():
    with pytest.raises(NotImplementedError, match="denoiser.py:101-102"):
        TransformerNet(**dict(NET, context_dim=None), out_channels=3, device="cpu")
    jnet = JaxTransformerNet(**dict(NET, add_t_to_x=False), out_channels=3)
    args = net_inputs(7)
    with pytest.raises((TypeError, AttributeError, ValueError)):
        jnet.init(jax.random.PRNGKey(0), *[None if k == "ctx" else jnp.asarray(v)
                                           for k, v in args.items()])


# -------------------------------------------------------------- encode_ref
ENCODER = dict(
    encoder=dict(type="PointNetV2", zdim=16, point_dim=3, per_part_mlp=True),
    part_aligner=dict(type="PartAlignerTransformer", in_channels=16, out_channels=6, n_class=4,
                      d_head=8, depth=1, n_heads=2, single_attn=True, class_cond=True,
                      add_class_cond=True, cimle=True, noise_scale=10, cond_noise_type=0),
    n_class=4, fit_loss_type=4, include_part_code=True, include_params=True, gen=False,
    encode_ref=True,
)


def encoder_batch(seed, B=3, N=64):
    rng = np.random.RandomState(seed)
    seg = np.repeat(np.arange(4), N // 4)[None].repeat(B, 0).astype(np.int32)
    pts = (0.3 * rng.randn(B, N, 3)).astype(np.float32)
    return dict(input=pts, ref=(pts + 0.05 * rng.randn(B, N, 3)).astype(np.float32),
                present=VALID, ref_seg_mask=seg,
                ref_attn_map=np.eye(4, dtype=np.float32)[seg],
                part_shift=(0.1 * rng.randn(B, 4, 3)).astype(np.float32),
                part_scale=(0.3 + 0.2 * np.abs(rng.randn(B, 4, 3))).astype(np.float32))


def test_encode_ref_matches_jax():
    """The aligner reads the reference cloud's PointNet code on every part
    slot: ctx, the per-point mean and log-variance, the fit loss and the
    latents, eval mode, the CIMLE noise injected. Generation has no
    reference cloud, and raises there as the JAX package fails."""
    batch = encoder_batch(9)
    noise = np.random.RandomState(10).randn(3, 32).astype(np.float32)
    jenc = JaxPartEncoder(**ENCODER)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.jit(jenc.init)(jax.random.PRNGKey(0), jb, jnp.asarray(noise))
    variables = dict(variables, params=randomize(variables["params"], seed=11))
    want = jax.jit(jenc.apply)(variables, jb, jnp.asarray(noise))
    enc = PartEncoderForTransformerDecoder(**ENCODER, device="cpu")
    load_jax_params(enc, variables["params"], variables["batch_stats"])
    assert enc.ref_encoder.mlp_m.dense2.kernel.shape == (128, 16)
    with torch.no_grad():
        got = enc({k: torch.as_tensor(v) for k, v in batch.items()},
                  noise=torch.as_tensor(noise))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(t2n(g), np.asarray(w), **TOL)
    np.testing.assert_allclose(t2n(got[4]["fit_loss"]), np.asarray(want[4]["fit_loss"]), **TOL)
    for g, w in zip(got[5][1:3], want[5][1:3]):
        np.testing.assert_allclose(t2n(g), np.asarray(w), **TOL)
    with pytest.raises(NotImplementedError, match="part_encoder.py:123"):
        enc.sample_latents(2, 64, z=torch.zeros(2, 4, 16),
                           cimle_noise=torch.zeros(2, 32))
