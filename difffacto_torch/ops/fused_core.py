"""The denoiser trunk of one diffusion step: kernel wrapper, plain version, launch count.

Replaces the TPU kernel ``difffacto_tpu/ops/fused_core.py:_core_kernel`` with
the hand-written CUDA kernel ``csrc/fused_core.cu`` (see its note for the
design and the bound). The trunk is proj_in -> pre-LN -> depth x [LN -> q ->
attention to the 4 part tokens -> out-proj -> residual -> LN -> GEGLU FF ->
residual] -> post-LN; proj_out stays outside, as in the JAX default.

K and V of the context come in as (depth, B, 4, 128), not the TPU's
block-diagonal layout; the mask is (B, 4). ``fused_core`` launches the kernel
for CUDA tensors and runs ``fused_core_reference`` for CPU tensors.

The kernel is persistent: ``schedule`` computes its walk over (batch row,
128-token tile) work items, and the kernel walks the grid and the tiles per
row it is given.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..nn.functional import ln_affine
from . import _build
from .fused_block import fused_block_reference

# The kernel's fixed shapes (csrc/fused_core.cu).
D, HEADS, CTX, FF, MAX_IN = 128, 8, 4, 512, 16
TILE = 128  # tokens per work item

launches = 0  # kernel launches since the caller last set it to 0


def fused_core_reference(x, pin_w, pin_b, k, v, mask, pre_scale, pre_bias, post_scale,
                         post_bias, n2_scale, n2_bias, wq, wout, bout, ff_scale, ff_bias,
                         w1, b1, w2, b2, scale: float) -> torch.Tensor:
    """Plain PyTorch trunk with the kernel's arithmetic.

    x (B, N, IN) in the compute dtype; pin_w (IN, D); k, v (depth, B, M, D);
    mask (B, M); per-block parameters stacked on a leading depth axis. Every
    product accumulates in f32 and LayerNorm statistics are f32; results
    round to x's dtype where the Pallas kernel rounds. Returns (B, N, D).
    """
    h = (x.float() @ pin_w.float() + pin_b.float()).to(x.dtype)
    h = ln_affine(h, pre_scale, pre_bias)
    for i in range(k.shape[0]):
        h = fused_block_reference(h, k[i], v[i], mask, n2_scale[i], n2_bias[i], wq[i], wout[i],
                                  bout[i], ff_scale[i], ff_bias[i], w1[i], b1[i], w2[i], b2[i],
                                  scale, HEADS)
    return ln_affine(h, post_scale, post_bias)


F32_OPERANDS = ("pin_b", "mask", "bout", "b1", "b2")


def example_inputs(B: int, N: int, depth: int, in_ch: int = 13, seed: int = 0, mask=None):
    """Random trunk operands at the gen_chair widths, as float32 numpy arrays
    in ``fused_core``'s argument order (weights scaled like lecun_normal)."""
    rng = np.random.RandomState(seed)
    r = lambda *s: rng.randn(*s).astype(np.float32)
    mask = np.ones((B, CTX), np.float32) if mask is None else np.asarray(mask, np.float32)
    return dict(
        x=r(B, N, in_ch), pin_w=r(in_ch, D) * in_ch**-0.5, pin_b=r(D) * 0.1,
        k=r(depth, B, CTX, D), v=r(depth, B, CTX, D), mask=mask,
        pre_scale=1 + 0.1 * r(D), pre_bias=0.1 * r(D),
        post_scale=1 + 0.1 * r(D), post_bias=0.1 * r(D),
        n2_scale=1 + 0.1 * r(depth, D), n2_bias=0.1 * r(depth, D),
        wq=r(depth, D, D) * D**-0.5, wout=r(depth, D, D) * D**-0.5, bout=0.1 * r(depth, D),
        ff_scale=1 + 0.1 * r(depth, D), ff_bias=0.1 * r(depth, D),
        w1=r(depth, D, 2 * FF) * D**-0.5, b1=0.1 * r(depth, 2 * FF),
        w2=r(depth, FF, D) * FF**-0.5, b2=0.1 * r(depth, D),
    )


def operands(inputs, device="cpu", dtype=torch.float32):
    """``example_inputs`` as tensors: the biases and the mask in float32, the
    rest in ``dtype`` (bfloat16 for the kernel)."""
    return [
        torch.as_tensor(v).to(device, torch.float32 if k in F32_OPERANDS else dtype)
        for k, v in inputs.items()
    ]


def schedule(B: int, N: int, sms: int) -> dict:
    """The persistent kernel's walk, which the wrappers pass to it: one thread
    block per SM, or one per tile where there are fewer tiles. Block ``i``
    takes tiles i, i + grid, i + 2 grid, ... < total_tiles, and tile t is batch
    row t // tiles_per_row, tokens from TILE * (t % tiles_per_row)."""
    tiles_per_row = -(-N // TILE)
    total = B * tiles_per_row
    grid = min(sms, total)
    return dict(grid=grid, tiles_per_row=tiles_per_row, total_tiles=total,
                tiles_per_block=-(-total // grid))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_schedule(B: int, N: int, device: torch.device):
    """(grid, tiles_per_row) of ``schedule`` on ``device``'s card, as the C
    entry points take them."""
    s = schedule(B, N, _sms(device.index if device.index is not None else torch.cuda.current_device()))
    return s["grid"], s["tiles_per_row"]


def fused_core(x, pin_w, pin_b, k, v, mask, pre_scale, pre_bias, post_scale, post_bias,
               n2_scale, n2_bias, wq, wout, bout, ff_scale, ff_bias, w1, b1, w2, b2,
               scale: float) -> torch.Tensor:
    """The trunk: the CUDA kernel for tensors on the card, the plain version
    for tensors on the CPU. On the card every operand is bf16 except the
    biases pin_b, bout, b1, b2 and the mask, which are f32."""
    global launches
    args = (x, pin_w, pin_b, k, v, mask, pre_scale, pre_bias, post_scale, post_bias,
            n2_scale, n2_bias, wq, wout, bout, ff_scale, ff_bias, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return fused_core_reference(*args, scale)
    if x.device.type != "cuda":
        raise ValueError(f"fused_core: no kernel for device {x.device}")
    B, N, in_ch = x.shape
    depth = wq.shape[0]
    if not 1 <= in_ch <= MAX_IN:
        raise ValueError(f"fused_core: input width {in_ch} is outside 1..{MAX_IN}")
    if depth < 1:
        raise ValueError(f"fused_core: depth {depth} is below 1")
    bf, f32 = torch.bfloat16, torch.float32
    shapes = (
        ("x", (B, N, in_ch), bf), ("pin_w", (in_ch, D), bf), ("pin_b", (D,), f32),
        ("k", (depth, B, CTX, D), bf), ("v", (depth, B, CTX, D), bf), ("mask", (B, CTX), f32),
        ("pre_scale", (D,), bf), ("pre_bias", (D,), bf),
        ("post_scale", (D,), bf), ("post_bias", (D,), bf),
        ("n2_scale", (depth, D), bf), ("n2_bias", (depth, D), bf),
        ("wq", (depth, D, D), bf), ("wout", (depth, D, D), bf), ("bout", (depth, D), f32),
        ("ff_scale", (depth, D), bf), ("ff_bias", (depth, D), bf),
        ("w1", (depth, D, 2 * FF), bf), ("b1", (depth, 2 * FF), f32),
        ("w2", (depth, FF, D), bf), ("b2", (depth, D), f32),
    )
    _build.check_operands("fused_core", shapes, args)
    lib = _library()
    out = torch.empty((B, N, D), dtype=bf, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.difffacto_fused_core(
            *(t.data_ptr() for t in args), out.data_ptr(), B, N, in_ch, depth, float(scale),
            *launch_schedule(B, N, x.device), stream
        )
    _build.check_launch(lib, "fused_core", rc)
    launches += 1
    return out


def _library() -> ctypes.CDLL:
    lib = _build.load("fused_core")
    fn = lib.difffacto_fused_core
    if not fn.argtypes:
        fn.argtypes = ([ctypes.c_void_p] * 22 + [ctypes.c_int] * 4 + [ctypes.c_float]
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.difffacto_cuda_error_string.argtypes = [ctypes.c_int]
        lib.difffacto_cuda_error_string.restype = ctypes.c_char_p
        lib.difffacto_fused_core_smem_bytes.argtypes = []
        lib.difffacto_fused_core_smem_bytes.restype = ctypes.c_int
    return lib


def smem_bytes() -> int:
    """Dynamic shared memory of one thread block of the kernel."""
    return _library().difffacto_fused_core_smem_bytes()
