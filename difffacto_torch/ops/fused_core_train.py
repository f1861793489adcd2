"""The trainable denoiser trunk: forward and backward kernels, plain version, launch counts.

Replaces the TPU pair ``difffacto_tpu/ops/fused_core_train.py:_trunk_train_fwd_kernel``
and ``_trunk_train_bwd_kernel`` (``fused_trunk_train_call``) with the CUDA kernels
of ``csrc/fused_core_train.cu`` behind one ``torch.autograd.Function``. The trunk
is the one of ``ops/fused_core.py`` without proj_in, plus dropout after the
attention out-projection (site 0) and on the GEGLU activations (site 1).

K and V of the context are (depth, B, 4, 128) and the mask (B, 4), as in
``ops/fused_core.py``; dK and dV come back in that layout and autograd carries
them on to ``wk``, ``wv`` and the context.

The dropout masks are never stored: forward and backward regenerate them from
``dropout_bits``, a 32-bit integer hash of (seed, batch row, global token,
block, site, column) that the kernels and the plain version compute bit for
bit. The bits are not the TPU's, so the port is held against JAX at p = 0.

``fused_trunk_train`` launches the kernels for CUDA tensors and runs
``fused_trunk_train_reference`` (plain differentiable PyTorch with the kernel's
rounding points) for CPU tensors. Both kernels walk ``ops/fused_core.schedule``.
Under autograd the forward kernel also saves every block's input and
post-attention hidden and the hidden before the post-LN, (2 depth + 1, B, N,
128) bf16, which the backward kernel reads instead of recomputing the
forward. The backward sums its weight gradients with f32 vector reductions in
no fixed order, so they repeat only to f32 rounding from run to run.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from ..nn.functional import ln_affine
from ..utils import trace
from . import _build
from .fused_block import takes
from .fused_core import CTX, D, FF, HEADS, TILE, launch_schedule

PARAM_NAMES = ("pre_scale", "pre_bias", "post_scale", "post_bias", "n2_scale", "n2_bias", "wq",
               "wout", "bout", "ff_scale", "ff_bias", "w1", "b1", "w2", "b2")
F32_PARAMS = ("bout", "b1", "b2")  # the kernels read these in f32, the rest in bf16


_M32 = 0xFFFFFFFF


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """The murmur3 finalizer on uint32 values held in int64."""
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)


def dropout_bits(seed, B: int, N: int, block: int, site: int, cols: int, device="cpu",
                 n0: int = 0) -> torch.Tensor:
    """The 32 random bits of every (batch row, token n0 + n, column) of one
    dropout site, as int64 in [0, 2^32): (B, N, cols). ``seed`` is an int or a
    one-element integer tensor."""
    i64 = torch.int64
    seed = torch.as_tensor(seed, device=device).to(i64).reshape(()) & _M32
    b = torch.arange(1, B + 1, dtype=i64, device=device)
    h = _fmix32((seed + 0x9E3779B9 * b) & _M32)  # (B,)
    n = torch.arange(n0, n0 + N, dtype=i64, device=device)
    key = _fmix32(h[:, None] ^ ((n * 0x85EBCA77 + (block * 2 + site)) & _M32)[None])  # (B, N)
    c = (torch.arange(cols, dtype=i64, device=device) * 0x9E3779B9) & _M32
    return _fmix32((key[:, :, None] + c) & _M32)


def keep_threshold(p: float) -> int:
    """An element is kept when its bits are below round((1 - p) 2^32)."""
    return int(round((1.0 - p) * 4294967296.0))


def dropout_mult(seed, B, N, block, site, cols, p: float, device="cpu", n0: int = 0):
    """The dropout multiplier of one site: 1 / (1 - p) where kept, else 0, float32."""
    keep = dropout_bits(seed, B, N, block, site, cols, device, n0) < keep_threshold(p)
    scale = float(np.float32(1.0 / (1.0 - p)))
    return keep.to(torch.float32) * scale


def fused_trunk_train_reference(seed, x, k, v, mask, pre_scale, pre_bias, post_scale, post_bias,
                                n2_scale, n2_bias, wq, wout, bout, ff_scale, ff_bias, w1, b1,
                                w2, b2, scale: float, dropout_p: float = 0.0,
                                heads: int = HEADS) -> torch.Tensor:
    """Plain differentiable PyTorch trunk with the kernels' arithmetic.

    x (B, N, D) in the compute dtype; k, v (depth, B, M, D) with D split into
    ``heads`` heads; mask (B, M);
    per-block parameters stacked on a leading depth axis, in any float dtype
    (they are cast to x's dtype, the three biases to f32). Every product
    accumulates in f32, LayerNorm statistics are f32, and results round to x's
    dtype where the Pallas kernel rounds. Returns (B, N, D).
    """
    dt = x.dtype
    B, N = x.shape[:2]
    depth, _, M, Dm = k.shape
    dh = Dm // heads
    inner = w2.shape[1]
    f = lambda a: a.float() if a.dtype != torch.float64 else a
    c = lambda a: a.to(dt)

    def drop(o, block, site):
        if dropout_p <= 0.0:
            return o
        m = dropout_mult(seed, B, N, block, site, o.shape[-1], dropout_p, o.device)
        return o * m.to(o.dtype)

    h = ln_affine(x, c(pre_scale), c(pre_bias))
    for i in range(depth):
        a = ln_affine(h, c(n2_scale[i]), c(n2_bias[i]))
        q = (f(a) @ f(c(wq[i]))).to(dt).reshape(B, N, heads, dh)
        # attention to the M context tokens as nn/functional.py:small_ctx_attention does it
        # (one max-shift per token, weights and the weighted sum rounded), in f's precision
        ki, vi = f(c(k[i])).reshape(B, M, heads, dh), f(c(v[i])).reshape(B, M, heads, dh)
        m = f(mask)[:, None, None, :]
        s = torch.einsum("bnhd,bmhd->bnhm", f(q), ki) * scale + (m - 1.0) * 1e30
        e = torch.exp(s - s.reshape(B, N, -1).amax(-1)[:, :, None, None]) * m
        w = (e / torch.clamp(e.sum(-1, keepdim=True), min=1e-30)).to(dt)
        attn = torch.einsum("bnhm,bmhd->bnhd", f(w), vi).to(dt).reshape(B, N, Dm)
        o = drop(f(attn) @ f(c(wout[i])) + f(bout[i]), i, 0).to(dt)
        h = (f(h) + f(o)).to(dt)
        a = ln_affine(h, c(ff_scale[i]), c(ff_bias[i]))
        u, g = (f(a) @ f(c(w1[i])) + f(b1[i])).split(inner, dim=-1)
        act = drop(u * F.gelu(g, approximate="tanh"), i, 1).to(dt)
        o = (f(act) @ f(c(w2[i])) + f(b2[i])).to(dt)
        h = (f(h) + f(o)).to(dt)
    return ln_affine(h, c(post_scale), c(post_bias))


def example_params(depth: int, seed: int = 0):
    """Random trunk parameters at the gen_chair widths as float32 numpy arrays,
    in ``PARAM_NAMES`` order (weights scaled like lecun_normal)."""
    rng = np.random.RandomState(seed)
    r = lambda *s: rng.randn(*s).astype(np.float32)
    return dict(
        pre_scale=1 + 0.1 * r(D), pre_bias=0.1 * r(D),
        post_scale=1 + 0.1 * r(D), post_bias=0.1 * r(D),
        n2_scale=1 + 0.1 * r(depth, D), n2_bias=0.1 * r(depth, D),
        wq=r(depth, D, D) * D**-0.5, wout=r(depth, D, D) * D**-0.5, bout=0.1 * r(depth, D),
        ff_scale=1 + 0.1 * r(depth, D), ff_bias=0.1 * r(depth, D),
        w1=r(depth, D, 2 * FF) * D**-0.5, b1=0.1 * r(depth, 2 * FF),
        w2=r(depth, FF, D) * FF**-0.5, b2=0.1 * r(depth, D),
    )


def example_inputs(B: int, N: int, depth: int, seed: int = 0, mask=None):
    """Random x, k, v and the mask as float32 numpy arrays."""
    rng = np.random.RandomState(seed + 1000)
    r = lambda *s: rng.randn(*s).astype(np.float32)
    mask = np.ones((B, CTX), np.float32) if mask is None else np.asarray(mask, np.float32)
    return dict(x=r(B, N, D), k=r(depth, B, CTX, D), v=r(depth, B, CTX, D), mask=mask)


def run_example(fn, inp, par, dropout_p: float, seed, device, scale: float = 0.25):
    """One forward and backward of ``fn`` (``fused_trunk_train`` or its plain
    version) on ``example_inputs`` (plus a cotangent ``inp["cot"]``) and
    ``example_params``: bf16 activations on the card, f32 on the CPU, f32 master
    parameters. Returns (y, [dx, dk, dv, 15 parameter gradients]) in f32."""
    dt = torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32
    x, k, v = (torch.as_tensor(inp[n]).to(device, dt).requires_grad_() for n in ("x", "k", "v"))
    params = [torch.as_tensor(a).to(device).requires_grad_() for a in par.values()]
    y = fn(seed, x, k, v, torch.as_tensor(inp["mask"]).to(device), *params, scale, dropout_p)
    (y.float() * torch.as_tensor(inp["cot"]).to(device)).sum().backward()
    return y.detach().float(), [t.grad.float() for t in (x, k, v, *params)]


def grad_sizes(depth: int, B: int):
    """(name, shape) of every f32 gradient in the backward kernel's flat buffer, in its order."""
    kv = (depth, B, CTX, D)
    return (
        ("k", kv), ("v", kv), ("pre_scale", (D,)), ("pre_bias", (D,)), ("post_scale", (D,)),
        ("post_bias", (D,)), ("n2_scale", (depth, D)), ("n2_bias", (depth, D)),
        ("wq", (depth, D, D)), ("wout", (depth, D, D)), ("bout", (depth, D)),
        ("ff_scale", (depth, D)), ("ff_bias", (depth, D)), ("w1", (depth, D, 2 * FF)),
        ("b1", (depth, 2 * FF)), ("w2", (depth, FF, D)), ("b2", (depth, D)),
    )


def _check(name, t, shape, dtype):
    if t.dtype != dtype:
        raise TypeError(f"fused_trunk_train: {name} is {t.dtype}, the kernels take {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"fused_trunk_train: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"fused_trunk_train: {name} must be contiguous and 16-byte aligned")


def _seed_tensor(seed, device) -> torch.Tensor:
    return torch.as_tensor(seed, device=device).to(torch.int32).reshape(1).contiguous()


def _cast_operands(x, k, v, mask, params):
    """The kernels' operands: bf16 except the f32 biases and mask; checked."""
    bf, f32 = torch.bfloat16, torch.float32
    B, N, _ = x.shape
    depth = params[6].shape[0]
    shapes = dict(
        pre_scale=(D,), pre_bias=(D,), post_scale=(D,), post_bias=(D,), n2_scale=(depth, D),
        n2_bias=(depth, D), wq=(depth, D, D), wout=(depth, D, D), bout=(depth, D),
        ff_scale=(depth, D), ff_bias=(depth, D), w1=(depth, D, 2 * FF), b1=(depth, 2 * FF),
        w2=(depth, FF, D), b2=(depth, D),
    )
    ops = [x, k, v, mask.to(f32).contiguous()]
    for name, p in zip(PARAM_NAMES, params):
        ops.append(p.detach().to(f32 if name in F32_PARAMS else bf).contiguous())
    specs = [("x", (B, N, D), bf), ("k", (depth, B, CTX, D), bf), ("v", (depth, B, CTX, D), bf),
             ("mask", (B, CTX), f32)]
    specs += [(n, shapes[n], f32 if n in F32_PARAMS else bf) for n in PARAM_NAMES]
    for (name, shape, dtype), t in zip(specs, ops):
        _check(name, t, shape, dtype)
    if any(t.device != x.device for t in ops):
        raise ValueError("fused_trunk_train: operands must share one device")
    return ops, B, N, depth


def _pointers(ops):
    return (ctypes.c_void_p * len(ops))(*(t.data_ptr() for t in ops))


def _raise(lib, what, rc):
    raise RuntimeError(
        f"fused_trunk_train {what} kernel launch failed: "
        f"{lib.difffacto_cuda_error_string(rc).decode()}"
    )


def launch_forward(ops, seed_t, launch, save: bool = False):
    """Launch the forward kernel on the checked operands of ``_cast_operands``:
    (y, the saved activations for the backward or None)."""
    B, N, depth, scale, keep_scale, thresh, drop = launch
    x = ops[0]
    lib = _library()
    out = torch.empty((B, N, D), dtype=torch.bfloat16, device=x.device)
    acts = (torch.empty((2 * depth + 1, B, N, D), dtype=torch.bfloat16, device=x.device)
            if save else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.difffacto_trunk_train_fwd(
            _pointers(ops), seed_t.data_ptr(), out.data_ptr(),
            acts.data_ptr() if save else None, B, N, depth, scale, keep_scale, thresh, drop,
            *launch_schedule(B, N, x.device), stream)
    if rc != 0:
        _raise(lib, "forward", rc)
    trace.count("fused_trunk_train_fwd.launches")
    return out, acts


def launch_backward(ops, acts, dy, seed_t, launch, lib=None):
    """Launch the backward kernel on the forward's saved activations: dx (bf16)
    and the f32 gradients of k, v and the 15 parameters, in ``grad_sizes``
    order. ``lib`` is another build of the source, passed through ``bind``
    (default: the port's own)."""
    B, N, depth, scale, keep_scale, thresh, drop = launch
    x = ops[0]
    lib = lib or _library()
    sizes = grad_sizes(depth, B)
    flat = torch.zeros(sum(int(np.prod(s)) for _, s in sizes), dtype=torch.float32,
                       device=x.device)
    grid, tiles_per_row = launch_schedule(B, N, x.device)
    park = torch.empty((grid, lib.difffacto_trunk_train_park_floats()), dtype=torch.float32,
                       device=x.device)
    dx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.difffacto_trunk_train_bwd(
            _pointers(ops), dy.data_ptr(), seed_t.data_ptr(), acts.data_ptr(), dx.data_ptr(),
            park.data_ptr(), flat.data_ptr(), B, N, depth, scale, keep_scale, thresh, drop,
            grid, tiles_per_row, stream)
    if rc != 0:
        _raise(lib, "backward", rc)
    trace.count("fused_trunk_train_bwd.launches")
    grads, off = [], 0
    for _, shape in sizes:
        n = int(np.prod(shape))
        grads.append(flat[off:off + n].view(shape))
        off += n
    return dx, grads


def launch_args(x, k, v, mask, params, seed, scale: float, dropout_p: float):
    """The checked, cast operands, the seed on the device and the launch tuple."""
    ops, B, N, depth = _cast_operands(x, k, v, mask, params)
    drop = int(dropout_p > 0.0)
    thresh = keep_threshold(dropout_p) if drop else 0
    keep_scale = 1.0 / (1.0 - dropout_p) if drop else 1.0
    return ops, _seed_tensor(seed, x.device), (B, N, depth, float(scale), keep_scale, thresh, drop)


class _FusedTrunkTrain(torch.autograd.Function):
    """forward(seed, scale, dropout_p, x, k, v, mask, *15 parameters). Saves
    its (cast) inputs and the forward kernel's saved activations."""

    @staticmethod
    def forward(ctx, seed, scale, dropout_p, x, k, v, mask, *params):
        ops, seed_t, launch = launch_args(x, k, v, mask, params, seed, scale, dropout_p)
        out, acts = launch_forward(ops, seed_t, launch, save=True)
        ctx.save_for_backward(seed_t, acts, *ops)
        ctx.launch = launch
        ctx.param_dtypes = [p.dtype for p in params]
        return out

    @staticmethod
    def backward(ctx, dy):
        seed_t, acts, *ops = ctx.saved_tensors
        dx, (dk, dv, *dparams) = launch_backward(
            ops, acts, dy.to(torch.bfloat16).contiguous(), seed_t, ctx.launch)
        dparams = [g.to(dt) for g, dt in zip(dparams, ctx.param_dtypes)]
        return (None, None, None, dx, dk.to(ops[1].dtype), dv.to(ops[2].dtype), None, *dparams)


def fused_trunk_train(seed, x, k, v, mask, pre_scale, pre_bias, post_scale, post_bias, n2_scale,
                      n2_bias, wq, wout, bout, ff_scale, ff_bias, w1, b1, w2, b2, scale: float,
                      dropout_p: float = 0.0, heads: int = HEADS) -> torch.Tensor:
    """The differentiable trunk: the CUDA kernel pair for tensors on the card,
    the plain version for tensors on the CPU. On the card the shapes are
    those ``ops/fused_block.takes`` accepts (others raise
    ``NotImplementedError``). On the card x, k and v are bf16;
    the parameters may be the f32 masters (the function casts, and their
    gradients come back in their own dtype). ``seed`` is an int or a
    one-element integer tensor (on the card it is read on the device)."""
    params = (pre_scale, pre_bias, post_scale, post_bias, n2_scale, n2_bias, wq, wout, bout,
              ff_scale, ff_bias, w1, b1, w2, b2)
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"fused_trunk_train: dropout_p {dropout_p} is outside [0, 1)")
    if x.device.type == "cpu":
        return fused_trunk_train_reference(seed, x, k, v, mask, *params, scale, dropout_p, heads)
    if x.device.type != "cuda":
        raise ValueError(f"fused_trunk_train: no kernel for device {x.device}")
    if not takes(k.shape[-1], heads, k.shape[2]):
        raise NotImplementedError(
            f"fused_trunk_train: the kernels take D={D}, {HEADS} heads and M={CTX} context "
            f"tokens; got D={k.shape[-1]}, {heads} heads, M={k.shape[2]}")
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in (x, k, v, mask, *params))):
        ops, seed_t, launch = launch_args(x, k, v, mask, params, seed, scale, dropout_p)
        return launch_forward(ops, seed_t, launch)[0]  # nothing to save
    return _FusedTrunkTrain.apply(seed, scale, dropout_p, x, k, v, mask, *params)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' argument and result types on a loaded build
    of ``csrc/fused_core_train.cu``; returns it."""
    fn = lib.difffacto_trunk_train_fwd
    if not fn.argtypes:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        tail = [ci, ci, ci, cf, cf, ctypes.c_uint, ci, ci, ci, vp]
        fn.argtypes = [vp] * 4 + tail
        fn.restype = ci
        bwd = lib.difffacto_trunk_train_bwd
        bwd.argtypes = [vp] * 7 + tail
        bwd.restype = ci
        lib.difffacto_cuda_error_string.argtypes = [ci]
        lib.difffacto_cuda_error_string.restype = ctypes.c_char_p
        for name in ("difffacto_trunk_train_fwd_smem_bytes", "difffacto_trunk_train_bwd_smem_bytes",
                     "difffacto_trunk_train_park_floats"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ci
    return lib


def _library() -> ctypes.CDLL:
    return bind(_build.load("fused_core_train"))


def smem_bytes():
    """Dynamic shared memory of one thread block of the forward and of the backward kernel."""
    lib = _library()
    return lib.difffacto_trunk_train_fwd_smem_bytes(), lib.difffacto_trunk_train_bwd_smem_bytes()
