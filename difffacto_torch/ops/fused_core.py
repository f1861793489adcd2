"""The denoiser trunk of one diffusion step: kernel wrapper, plain version, launch count.

Replaces the TPU kernel ``difffacto_tpu/ops/fused_core.py:_core_kernel`` with
the hand-written CUDA kernel ``csrc/fused_core.cu`` (see its note for the
design and the bound). The trunk is proj_in -> pre-LN -> depth x [LN -> q ->
attention to the 4 part tokens -> out-proj -> residual -> LN -> GEGLU FF ->
residual] -> post-LN; proj_out stays outside, as in the JAX default.

K and V of the context come in as (depth, B, 4, 128), not the TPU's
block-diagonal layout; the mask is (B, 4). ``fused_core`` launches the kernel
for CUDA tensors, counting each launch in the recorder's ``fused_core.launches``
(``utils/trace.py``), and runs ``fused_core_reference`` for CPU tensors.

``fused_core_headless`` is the same trunk without proj_in (the TPU kernel's
``has_head=False`` form, ``difffacto_tpu/ops/fused_core.py:118-160``): x is
the hidden state h0 (B, N, 128) that the caller projected, as the denoiser
does when it adds the time embedding to h0 (``add_t_to_x``). It is a second
entry point of the same kernel (``Mode::HEADLESS`` of ``csrc/trunk.cuh``) and
counts its launches in ``fused_core_headless.launches``; its plain version is
``fused_core_reference`` with ``pin_w=None``.

``fused_core_tail`` and ``fused_core_headless_tail`` are those two with
proj_out fused (the TPU kernel's ``has_tail=True`` forms, which the JAX
denoiser takes under ``DIFFFACTO_FUSE_TAIL=1``): after the post-LN each
token's row goes through bf16(LN(h) W_out + b_out) with f32 sums, and the
kernel writes (B, N, OUT) for OUT <= 8. They count their launches in
``fused_core_tail.launches`` and ``fused_core_headless_tail.launches``; their
plain version is ``fused_core_reference`` with ``pout_w`` and ``pout_b``.

``fused_core_two_attn`` is the trunk with two-attention blocks
(``single_attn=False``): each block runs norm1 -> attn1 -> out-projection ->
residual before the single-attention block's body, attn1 cross-attending to
the same 4 part tokens with K1 and V1 of its own. It is the kernel's
``TWO`` form (``csrc/trunk.cuh``), a kernel of its own name
(``fused_core_two_attn_kernel``), counted in ``fused_core_two_attn.launches``;
its plain version is ``fused_core_reference`` with ``attn1``.

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
from ..utils import trace
from . import _build
from .fused_block import attention_residual_reference, fused_block_reference, takes

# The kernel's fixed shapes (csrc/fused_core.cu).
D, HEADS, CTX, FF, MAX_IN, MAX_OUT = 128, 8, 4, 512, 16, 8
TILE = 128  # tokens per work item


def fused_core_reference(x, pin_w, pin_b, k, v, mask, pre_scale, pre_bias, post_scale,
                         post_bias, n2_scale, n2_bias, wq, wout, bout, ff_scale, ff_bias,
                         w1, b1, w2, b2, scale: float, heads: int = HEADS, pout_w=None,
                         pout_b=None, attn1=None) -> torch.Tensor:
    """Plain PyTorch trunk with the kernel's arithmetic.

    x (B, N, IN) in the compute dtype; pin_w (IN, D), or None for the
    head-less trunk, whose x is h0 (B, N, D); k, v (depth, B, M, D)
    with D split into ``heads`` heads; mask (B, M); per-block parameters
    stacked on a leading depth axis; pout_w (D, OUT) and pout_b (OUT,) fuse
    proj_out (the tail); ``attn1`` (k1, v1, n1_scale, n1_bias, wq1, wout1,
    bout1), stacked alike, puts the first attention of a two-attention block
    ahead of each block. Every product accumulates in f32 and LayerNorm
    statistics are f32; results round to x's dtype where the Pallas kernel
    rounds. Returns (B, N, D), or (B, N, OUT) with the tail.
    """
    h = x if pin_w is None else (x.float() @ pin_w.float() + pin_b.float()).to(x.dtype)
    h = ln_affine(h, pre_scale, pre_bias)
    for i in range(k.shape[0]):
        if attn1 is not None:
            k1, v1, *first = (a[i] for a in attn1)
            h = attention_residual_reference(h, k1, v1, mask, *first, scale, heads)
        h = fused_block_reference(h, k[i], v[i], mask, n2_scale[i], n2_bias[i], wq[i], wout[i],
                                  bout[i], ff_scale[i], ff_bias[i], w1[i], b1[i], w2[i], b2[i],
                                  scale, heads)
    h = ln_affine(h, post_scale, post_bias)
    if pout_w is None:
        return h
    return (h.float() @ pout_w.float() + pout_b.float()).to(x.dtype)


F32_OPERANDS = ("pin_b", "mask", "bout", "b1", "b2", "bout1")


def example_inputs(B: int, N: int, depth: int, in_ch: int = 13, seed: int = 0, mask=None,
                   two_attn: bool = False):
    """Random trunk operands at the gen_chair widths, as float32 numpy arrays
    in ``fused_core``'s argument order (weights scaled like lecun_normal);
    with ``two_attn`` the first attention's operands follow, in
    ``fused_core_two_attn``'s order."""
    rng = np.random.RandomState(seed)
    r = lambda *s: rng.randn(*s).astype(np.float32)
    mask = np.ones((B, CTX), np.float32) if mask is None else np.asarray(mask, np.float32)
    out = dict(
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
    if two_attn:
        out.update(
            k1=r(depth, B, CTX, D), v1=r(depth, B, CTX, D),
            n1_scale=1 + 0.1 * r(depth, D), n1_bias=0.1 * r(depth, D),
            wq1=r(depth, D, D) * D**-0.5, wout1=r(depth, D, D) * D**-0.5,
            bout1=0.1 * r(depth, D),
        )
    return out


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
               scale: float, heads: int = HEADS) -> torch.Tensor:
    """The trunk: the CUDA kernel for tensors on the card, the plain version
    for tensors on the CPU. On the card every operand is bf16 except the
    biases pin_b, bout, b1, b2 and the mask, which are f32, and the shapes
    are those ``takes`` accepts (others raise ``NotImplementedError``)."""
    return _trunk("fused_core", x, (pin_w, pin_b), _rest(locals()), None, scale, heads)


def fused_core_headless(x, k, v, mask, pre_scale, pre_bias, post_scale, post_bias, n2_scale,
                        n2_bias, wq, wout, bout, ff_scale, ff_bias, w1, b1, w2, b2,
                        scale: float, heads: int = HEADS) -> torch.Tensor:
    """The trunk without proj_in: x is h0 (B, N, 128). The CUDA kernel's
    head-less entry for tensors on the card, ``fused_core_reference`` with
    ``pin_w=None`` for tensors on the CPU; operands as ``fused_core``'s."""
    return _trunk("fused_core_headless", x, None, _rest(locals()), None, scale, heads)


def fused_core_tail(x, pin_w, pin_b, k, v, mask, pre_scale, pre_bias, post_scale, post_bias,
                    n2_scale, n2_bias, wq, wout, bout, ff_scale, ff_bias, w1, b1, w2, b2,
                    pout_w, pout_b, scale: float, heads: int = HEADS) -> torch.Tensor:
    """``fused_core`` with proj_out fused: pout_w (128, OUT) bf16 and pout_b
    (OUT,) f32 on the card, OUT <= 8; returns (B, N, OUT)."""
    return _trunk("fused_core_tail", x, (pin_w, pin_b), _rest(locals()), (pout_w, pout_b),
                  scale, heads)


def fused_core_headless_tail(x, k, v, mask, pre_scale, pre_bias, post_scale, post_bias,
                             n2_scale, n2_bias, wq, wout, bout, ff_scale, ff_bias, w1, b1, w2,
                             b2, pout_w, pout_b, scale: float, heads: int = HEADS) -> torch.Tensor:
    """``fused_core_headless`` with proj_out fused, as ``fused_core_tail``."""
    return _trunk("fused_core_headless_tail", x, None, _rest(locals()), (pout_w, pout_b),
                  scale, heads)


def fused_core_two_attn(x, pin_w, pin_b, k, v, mask, pre_scale, pre_bias, post_scale,
                        post_bias, n2_scale, n2_bias, wq, wout, bout, ff_scale, ff_bias, w1, b1,
                        w2, b2, k1, v1, n1_scale, n1_bias, wq1, wout1, bout1, scale: float,
                        heads: int = HEADS) -> torch.Tensor:
    """``fused_core`` with two-attention blocks: k1, v1 (depth, B, 4, 128),
    n1_scale, n1_bias (depth, 128), wq1, wout1 (depth, 128, 128) bf16 and
    bout1 (depth, 128) f32 on the card, the first attention of every block."""
    attn1 = (k1, v1, n1_scale, n1_bias, wq1, wout1, bout1)
    return _trunk("fused_core_two_attn", x, (pin_w, pin_b), _rest(locals()), None, scale, heads,
                  attn1)


_REST = ("k", "v", "mask", "pre_scale", "pre_bias", "post_scale", "post_bias", "n2_scale",
         "n2_bias", "wq", "wout", "bout", "ff_scale", "ff_bias", "w1", "b1", "w2", "b2")


def _rest(args: dict) -> tuple:
    """The operands every entry shares, in the kernel's order, from an
    entry's arguments."""
    return tuple(args[n] for n in _REST)


def _trunk(name, x, head, rest, tail, scale, heads, attn1=None):
    """One of the five entries: head (pin_w, pin_b) or None for the head-less
    trunk, tail (pout_w, pout_b) or None, attn1 (the first attention's
    operands) or None. The plain version on the CPU, the kernel's
    ``difffacto_<name>`` on the card, counted in ``<name>.launches``."""
    pin_w, pin_b = head or (None, None)
    pout_w, pout_b = tail or (None, None)
    if x.device.type == "cpu":
        return fused_core_reference(x, pin_w, pin_b, *rest, scale, heads, pout_w=pout_w,
                                    pout_b=pout_b, attn1=attn1)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    k, wq = rest[0], rest[9]
    B, N, in_ch = x.shape
    depth = wq.shape[0]
    if not takes(k.shape[-1], heads, k.shape[2]) or (head is None and in_ch != D):
        raise NotImplementedError(
            f"{name}: the kernel takes D={D}, {HEADS} heads and M={CTX} context tokens; got "
            f"x {in_ch} wide, D={k.shape[-1]}, {heads} heads, M={k.shape[2]}")
    if head is not None and not 1 <= in_ch <= MAX_IN:
        raise ValueError(f"{name}: input width {in_ch} is outside 1..{MAX_IN}")
    if depth < 1:
        raise ValueError(f"{name}: depth {depth} is below 1")
    bf, f32 = torch.bfloat16, torch.float32
    out_ch = D
    shapes = (("x", (B, N, in_ch), bf),)
    operands = (x,)
    if head is not None:
        shapes += (("pin_w", (in_ch, D), bf), ("pin_b", (D,), f32))
        operands += head
    shapes += _trunk_shapes(B, depth)
    operands += tuple(rest)
    if attn1 is not None:
        shapes += _attn1_shapes(B, depth)
        operands += tuple(attn1)
    if tail is not None:
        out_ch = pout_w.shape[-1]
        if pout_w.dim() != 2 or not 1 <= out_ch <= MAX_OUT:
            raise ValueError(f"{name}: proj_out {tuple(pout_w.shape)} is not (128, 1..{MAX_OUT})")
        shapes += (("pout_w", (D, out_ch), bf), ("pout_b", (out_ch,), f32))
        operands += tail
    _build.check_operands(name, shapes, operands)
    lib = _library()
    out = torch.empty((B, N, out_ch), dtype=bf, device=x.device)
    sizes = (B, N) + ((in_ch,) if head is not None else ()) + (depth,) + (
        (out_ch,) if tail is not None else ())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, f"difffacto_{name}")(
            *(t.data_ptr() for t in operands), out.data_ptr(), *sizes, float(scale),
            *launch_schedule(B, N, x.device), stream)
    _build.check_launch(lib, name, rc)
    trace.count(name + ".launches")
    return out


def _trunk_shapes(B: int, depth: int):
    """(name, shape, dtype) of the trunk's operands after x and proj_in."""
    bf, f32 = torch.bfloat16, torch.float32
    return (
        ("k", (depth, B, CTX, D), bf), ("v", (depth, B, CTX, D), bf), ("mask", (B, CTX), f32),
        ("pre_scale", (D,), bf), ("pre_bias", (D,), bf),
        ("post_scale", (D,), bf), ("post_bias", (D,), bf),
        ("n2_scale", (depth, D), bf), ("n2_bias", (depth, D), bf),
        ("wq", (depth, D, D), bf), ("wout", (depth, D, D), bf), ("bout", (depth, D), f32),
        ("ff_scale", (depth, D), bf), ("ff_bias", (depth, D), bf),
        ("w1", (depth, D, 2 * FF), bf), ("b1", (depth, 2 * FF), f32),
        ("w2", (depth, FF, D), bf), ("b2", (depth, D), f32),
    )


def _attn1_shapes(B: int, depth: int):
    """(name, shape, dtype) of the first attention's operands."""
    bf, f32 = torch.bfloat16, torch.float32
    return (
        ("k1", (depth, B, CTX, D), bf), ("v1", (depth, B, CTX, D), bf),
        ("n1_scale", (depth, D), bf), ("n1_bias", (depth, D), bf),
        ("wq1", (depth, D, D), bf), ("wout1", (depth, D, D), bf), ("bout1", (depth, D), f32),
    )


# Each entry's (pointer operands, int sizes) before (scale, grid, tiles_per_row, stream).
_ENTRIES = {"difffacto_fused_core": (22, 4), "difffacto_fused_core_headless": (20, 3),
            "difffacto_fused_core_tail": (24, 5), "difffacto_fused_core_headless_tail": (22, 4),
            "difffacto_fused_core_two_attn": (29, 4)}


def _library() -> ctypes.CDLL:
    lib = _build.load("fused_core")
    if not lib.difffacto_fused_core.argtypes:
        for name, (pointers, ints) in _ENTRIES.items():
            fn = getattr(lib, name)
            fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * ints
                           + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        lib.difffacto_cuda_error_string.argtypes = [ctypes.c_int]
        lib.difffacto_cuda_error_string.restype = ctypes.c_char_p
        lib.difffacto_fused_core_smem_bytes.argtypes = [ctypes.c_int]
        lib.difffacto_fused_core_smem_bytes.restype = ctypes.c_int
    return lib


def smem_bytes(tail: bool = False) -> int:
    """Dynamic shared memory of one thread block of the kernel (of a tail entry)."""
    return _library().difffacto_fused_core_smem_bytes(int(tail))
