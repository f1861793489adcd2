"""One flat single-attention block with a context: kernel wrapper, plain version, launch count.

Replaces the TPU kernel ``difffacto_tpu/ops/fused_block.py:_block_kernel``
with the second entry point of ``csrc/fused_core.cu`` (``difffacto_fused_block``,
see the note there): the persistent trunk kernel's template at depth 1,
without proj_in and the pre- and post-LN, on the same walk
(``ops/fused_core.schedule``) and weight ring. For every token: LN -> q ->
attention to the M context tokens -> out-proj + bout -> residual -> LN ->
GEGLU FF -> residual.

K and V of the context come in as (B, M, D) and the mask as (B, M), not the
TPU's block-diagonal layout. ``fused_block`` launches the kernel for CUDA
tensors (D = 128, 8 heads, M = 4: the shapes the UNet denoiser gives it) and
runs ``fused_block_reference`` for CPU tensors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..nn.functional import ln_affine, small_ctx_attention
from . import _build
from .fused_ff import fused_ln_geglu_ff_reference

# The kernel's fixed shapes (csrc/fused_core.cu).
D, HEADS, CTX, FF = 128, 8, 4, 512

launches = 0  # kernel launches since the caller last set it to 0


def fused_block_reference(x, k, v, mask, n2_scale, n2_bias, wq, wout, bout, ff_scale, ff_bias,
                          w1, b1, w2, b2, scale: float, heads: int = HEADS) -> torch.Tensor:
    """Plain PyTorch block with the kernel's arithmetic.

    x (B, N, D) in the compute dtype; k, v (B, M, D); mask (B, M). Every
    product accumulates in f32 and LayerNorm statistics are f32; results
    round to x's dtype where the Pallas kernel rounds. Returns (B, N, D).
    """
    dt = x.dtype
    B, N, Dm = x.shape
    M = k.shape[1]
    dh = Dm // heads
    a = ln_affine(x, n2_scale, n2_bias)
    q = (a.float() @ wq.float()).to(dt).reshape(B, N, heads, dh)
    attn = small_ctx_attention(
        q, k.reshape(B, M, heads, dh), v.reshape(B, M, heads, dh), mask, scale
    ).reshape(B, N, Dm)
    o = (attn.float() @ wout.float() + bout.float()).to(dt)
    h = (x.float() + o.float()).to(dt)
    return fused_ln_geglu_ff_reference(h, ff_scale, ff_bias, w1, b1, w2, b2)


def example_inputs(B: int, N: int, seed: int = 0, mask=None):
    """Random block operands at the UNet denoiser's widths, as float32 numpy
    arrays in ``fused_block``'s argument order (weights scaled like
    lecun_normal); ``ops/fused_core.operands`` turns them into tensors."""
    rng = np.random.RandomState(seed)
    r = lambda *s: rng.randn(*s).astype(np.float32)
    mask = np.ones((B, CTX), np.float32) if mask is None else np.asarray(mask, np.float32)
    return dict(
        x=r(B, N, D), k=r(B, CTX, D), v=r(B, CTX, D), mask=mask,
        n2_scale=1 + 0.1 * r(D), n2_bias=0.1 * r(D),
        wq=r(D, D) * D**-0.5, wout=r(D, D) * D**-0.5, bout=0.1 * r(D),
        ff_scale=1 + 0.1 * r(D), ff_bias=0.1 * r(D),
        w1=r(D, 2 * FF) * D**-0.5, b1=0.1 * r(2 * FF), w2=r(FF, D) * FF**-0.5, b2=0.1 * r(D),
    )


def fused_block(x, k, v, mask, n2_scale, n2_bias, wq, wout, bout, ff_scale, ff_bias, w1, b1,
                w2, b2, scale: float, heads: int = HEADS) -> torch.Tensor:
    """The block: the CUDA kernel for tensors on the card, the plain version
    for tensors on the CPU. On the card every operand is bf16 except bout,
    b1, b2 and the mask, which are f32; other shapes than D = 128, 8 heads and
    M = 4 raise ``NotImplementedError``."""
    global launches
    args = (x, k, v, mask, n2_scale, n2_bias, wq, wout, bout, ff_scale, ff_bias, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return fused_block_reference(*args, scale, heads)
    if x.device.type != "cuda":
        raise ValueError(f"fused_block: no kernel for device {x.device}")
    B, N, Dm = x.shape
    M = k.shape[1]
    if (Dm, heads, M) != (D, HEADS, CTX):
        raise NotImplementedError(
            f"fused_block: the kernel takes D={D}, {HEADS} heads and M={CTX} context tokens; "
            f"got D={Dm}, {heads} heads, M={M}")
    bf, f32 = torch.bfloat16, torch.float32
    specs = (
        ("x", (B, N, D), bf), ("k", (B, CTX, D), bf), ("v", (B, CTX, D), bf),
        ("mask", (B, CTX), f32), ("n2_scale", (D,), bf), ("n2_bias", (D,), bf),
        ("wq", (D, D), bf), ("wout", (D, D), bf), ("bout", (D,), f32),
        ("ff_scale", (D,), bf), ("ff_bias", (D,), bf), ("w1", (D, 2 * FF), bf),
        ("b1", (2 * FF,), f32), ("w2", (FF, D), bf), ("b2", (D,), f32),
    )
    _build.check_operands("fused_block", specs, args)
    from .fused_core import launch_schedule  # fused_core imports this module

    lib = _library()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.difffacto_fused_block(
            *(t.data_ptr() for t in args), out.data_ptr(), B, N, float(scale),
            *launch_schedule(B, N, x.device), stream)
    _build.check_launch(lib, "fused_block", rc)
    launches += 1
    return out


def _library() -> ctypes.CDLL:
    lib = _build.load("fused_core")
    fn = lib.difffacto_fused_block
    if not fn.argtypes:
        fn.argtypes = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 2 + [ctypes.c_float]
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.difffacto_cuda_error_string.argtypes = [ctypes.c_int]
        lib.difffacto_cuda_error_string.restype = ctypes.c_char_p
    return lib
