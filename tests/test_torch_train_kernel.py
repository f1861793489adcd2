"""The training trunk's plain version against the JAX package's Pallas pair, and
the dropout mask function.

The JAX denoiser runs ``deterministic=False`` with ``DIFFFACTO_PALLAS_INTERPRET=1``,
so its trunk is the real forward and backward Pallas kernels in interpret mode
(dropout 0: the interpreter has no PRNG). The port's ``TransformerNet`` runs
``train=True`` on the CPU, where ``fused_trunk_train`` is its plain version and
``torch.autograd`` gives the gradients. float32, same weights through
``load_jax_params``, inputs from a numpy seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from difffacto_tpu.models.denoiser import TransformerNet as JaxTransformerNet
from difffacto_torch.models import TransformerNet
from difffacto_torch.ops import fused_core_train as fct
from difffacto_torch.utils.jax_params import flatten_jax_tree, load_jax_params
from test_torch_modules import DENOISER, randomize, t2n

B, N = 2, 128


def denoiser_inputs(seed=77):
    rng = np.random.RandomState(seed)
    return dict(
        x=rng.randn(B, N, 3).astype(np.float32),
        t=np.array([1.0, 3.0], np.float32),
        ctx=rng.randn(B, 4, 262).astype(np.float32),
        anchors=(0.1 * rng.randn(B, N, 3)).astype(np.float32),
        variances=(np.abs(rng.randn(B, N, 3)) * 0.5 + 0.1).astype(np.float32),
        seg_mask=np.repeat(np.arange(4), N // 4)[None].repeat(B, 0).astype(np.int32),
        valid_id=np.array([[1, 1, 1, 1], [1, 0, 1, 1]], np.float32),
    ), rng.randn(B, N, 3).astype(np.float32)


@pytest.fixture(scope="module")
def nets():
    args, cot = denoiser_inputs()
    jnet = JaxTransformerNet(**DENOISER)
    jargs = [jnp.asarray(a) for a in args.values()]
    params = randomize(jnet.init(jax.random.PRNGKey(0), *jargs)["params"], seed=2)
    net = TransformerNet(**DENOISER, device="cpu")
    load_jax_params(net, params)
    return jnet, params, net, args, cot


def test_train_forward_matches_pallas_interpret(nets, monkeypatch):
    """The training forward at dropout 0: 2e-4, the trunk band of
    tests/test_ops.py::TestFusedDenoiserCore."""
    monkeypatch.setenv("DIFFFACTO_PALLAS_INTERPRET", "1")
    jnet, params, net, args, _ = nets
    want = np.asarray(jnet.apply({"params": params}, *[jnp.asarray(a) for a in args.values()],
                                 deterministic=False, rngs={"dropout": jax.random.PRNGKey(5)}))
    with torch.no_grad():
        got = t2n(net(*[torch.as_tensor(a) for a in args.values()], train=True))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    with torch.no_grad():  # and the training forward equals the deterministic one
        det = t2n(net(*[torch.as_tensor(a) for a in args.values()]))
    np.testing.assert_allclose(got, det, rtol=1e-5, atol=1e-5)


def test_train_grads_match_pallas_interpret(nets, monkeypatch):
    """Gradients of sum(y * cot) to x, the context and every parameter against
    the Pallas backward kernel: rtol 5e-3, atol 5e-4, the band of
    tests/test_ops.py::TestFusedTrunkTrain."""
    monkeypatch.setenv("DIFFFACTO_PALLAS_INTERPRET", "1")
    jnet, params, net, args, cot = nets
    jargs = {k: jnp.asarray(a) for k, a in args.items()}

    def loss(params, x, ctx):
        a = dict(jargs, x=x, ctx=ctx)
        y = jnet.apply({"params": params}, *a.values(), deterministic=False,
                       rngs={"dropout": jax.random.PRNGKey(5)})
        return jnp.sum(y * jnp.asarray(cot))

    gp, gx, gctx = jax.grad(loss, argnums=(0, 1, 2))(params, jargs["x"], jargs["ctx"])

    targs = {k: torch.as_tensor(a) for k, a in args.items()}
    targs["x"].requires_grad_()
    targs["ctx"].requires_grad_()
    net.zero_grad()
    (net(*targs.values(), train=True) * torch.as_tensor(cot)).sum().backward()
    np.testing.assert_allclose(t2n(targs["x"].grad), np.asarray(gx), rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(t2n(targs["ctx"].grad), np.asarray(gctx), rtol=5e-3, atol=5e-4)
    want = flatten_jax_tree(gp)
    got = {n: t2n(p.grad) for n, p in net.named_parameters()}
    assert set(got) == set(want)
    for name in sorted(want):
        np.testing.assert_allclose(got[name], want[name], rtol=5e-3, atol=5e-4, err_msg=name)


def fmix32(h):
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    return h ^ (h >> 16)


def test_dropout_bits_equal_the_integer_hash():
    """The tensor code against the hash written out on Python ints (the CUDA
    kernel computes the same in uint32)."""
    bits = fct.dropout_bits(7, 3, 130, 1, 1, 512)
    for b, n, col in ((0, 0, 0), (1, 100, 300), (2, 129, 511)):
        h = fmix32((7 + 0x9E3779B9 * (b + 1)) & 0xFFFFFFFF)
        key = fmix32(h ^ ((n * 0x85EBCA77 + 1 * 2 + 1) & 0xFFFFFFFF))
        assert int(bits[b, n, col]) == fmix32((key + col * 0x9E3779B9) & 0xFFFFFFFF)
    assert int(bits.min()) >= 0 and int(bits.max()) < 2**32


@pytest.mark.parametrize("p", [0.2, 0.5])
def test_dropout_kept_share_and_scale(p):
    """64 x 1000 x 512 draws: the kept share is 1 - p within 0.002 (5 standard
    deviations are 4e-4), the multiplier is 1 / (1 - p) or 0, and sites,
    blocks and seeds give other masks."""
    m = fct.dropout_mult(11, 64, 1000, 2, 1, 512, p)
    assert abs((m > 0).float().mean().item() - (1 - p)) < 2e-3
    assert set(np.unique(m.numpy()).tolist()) == {0.0, float(np.float32(1 / (1 - p)))}
    small = fct.dropout_mult(11, 4, 100, 2, 1, 128, p)
    for other in (fct.dropout_mult(12, 4, 100, 2, 1, 128, p),
                  fct.dropout_mult(11, 4, 100, 2, 0, 128, p),
                  fct.dropout_mult(11, 4, 100, 1, 1, 128, p)):
        assert 0.2 < (small != other).float().mean().item() < 0.8


def test_dropout_mask_is_a_function_of_the_global_token():
    """A window of tokens starting at n0 sees the mask of the whole row."""
    whole = fct.dropout_mult(5, 2, 200, 3, 0, 128, 0.2)
    for n0, n in ((64, 64), (128, 72), (17, 5)):
        part = fct.dropout_mult(5, 2, n, 3, 0, 128, 0.2, n0=n0)
        assert torch.equal(part, whole[:, n0:n0 + n])


def test_reference_forward_and_backward_share_the_mask():
    """gradcheck in float64 at a tiny size and p = 0.3, over x, k, v and the
    vector parameters (the matrices would take 10^5 evaluations): the analytic
    gradient (autograd through the masked forward) equals finite differences of
    that forward only if both use one mask; two seeds give other outputs."""
    depth, b, n = 1, 1, 3
    inp = fct.example_inputs(b, n, depth, seed=1, mask=[[1, 0, 1, 1]])
    par = fct.example_params(depth, seed=2)
    t64 = lambda a: torch.as_tensor(a, dtype=torch.float64)
    x, k, v = (t64(inp[name]).requires_grad_() for name in ("x", "k", "v"))
    checked = ("pre_scale", "post_bias", "n2_scale", "bout", "ff_bias", "b2")
    params = {name: t64(a).requires_grad_(name in checked) for name, a in par.items()}
    mask = torch.as_tensor(inp["mask"])

    def fn(x, k, v, *vecs, seed=9):
        ps = dict(params, **dict(zip(checked, vecs)))
        return fct.fused_trunk_train_reference(seed, x, k, v, mask, *ps.values(), 0.25, 0.3)

    vecs = [params[name] for name in checked]
    assert torch.autograd.gradcheck(fn, (x, k, v, *vecs), eps=1e-6, atol=1e-5, rtol=1e-4)
    y1, y2 = fn(x, k, v, *vecs), fn(x, k, v, *vecs, seed=10)
    assert torch.equal(y1, fn(x, k, v, *vecs)) and not torch.equal(y1, y2)


def test_a_tensor_off_the_cpu_never_gets_the_plain_version():
    """Only a CPU tensor takes the plain version: any other device launches the
    kernels or raises (here a meta tensor, for which there is no kernel)."""
    with pytest.raises(ValueError, match="no kernel"):
        fct.fused_trunk_train(0, torch.zeros(1, 4, 128, device="meta"), None, None, None,
                              *[None] * 15, 0.25, 0.0)
