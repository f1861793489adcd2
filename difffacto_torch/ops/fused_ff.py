"""The fused LayerNorm -> GEGLU feed-forward -> residual: kernel wrapper, plain version, launch count.

Replaces the TPU kernel ``difffacto_tpu/ops/fused_ff.py:_kernel`` with the
hand-written CUDA kernel ``csrc/fused_ff.cu`` (see its note for the design and
the bound): ``x + (a * gelu_tanh(g)) W2 + b2`` with ``[a | g] = LN(x) W1 + b1``
for every token of x (T, D). ``fused_ln_geglu_ff`` launches the kernel for
CUDA tensors and runs ``fused_ln_geglu_ff_reference`` for CPU tensors. At
D = 128 the kernel is the persistent trunk template (``csrc/trunk.cuh``,
Mode::FF): it walks 128-token tiles by ``ops/fused_core.py:schedule(1, T,
sms)``, which the wrapper passes in. At D = 256 it splits the hidden width
over a cluster of thread blocks by ``wide_plan``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..nn.functional import gelu, ln_affine
from . import _build

WIDTHS = (128, 256)  # the model widths the kernel takes; FF = 4 D

launches = 0  # kernel launches since the caller last set it to 0


def takes(width: int) -> bool:
    """Whether the kernel takes this model width: the module sends every
    other width to the unfused math."""
    return width in WIDTHS


def pick_tile(T: int, preferred: int = 1024) -> int:
    """Largest power-of-two tile <= preferred dividing T (>= 128), else 0
    (``difffacto_tpu/ops/fused_ff.py:pick_tile``): the JAX package runs its
    fused kernels only where this is not 0, and the port dispatches alike."""
    t = preferred
    while t >= 128:
        if T % t == 0:
            return t
        t //= 2
    return 0


WIDE_TILE, WIDE_CLUSTER = 64, 8  # D = 256: tokens a cluster, blocks a cluster


def wide_plan(T: int, D: int = 256) -> dict:
    """The D = 256 kernel's launch: ``tiles`` clusters of ``WIDE_CLUSTER``
    blocks, cluster i taking tokens [64 i, 64 i + 64) (the last one masked).
    Block b of the grid is tile b // 8 and rank r = b % 8: it computes the
    GEGLU units [r slice, (r + 1) slice) of its tile (slice = 4 D / 8 = 128,
    u and g), and its f32 partial of all D output columns against those rows
    of W2; it receives the other 7 blocks' partials of its band of columns
    [r band, (r + 1) band) (band = D / 8 = 32) and sums the 8 in rank order."""
    tiles = -(-T // WIDE_TILE)
    return dict(tile=WIDE_TILE, cluster=WIDE_CLUSTER, tiles=tiles, grid=tiles * WIDE_CLUSTER,
                slice=4 * D // WIDE_CLUSTER, band=D // WIDE_CLUSTER)


def fused_ln_geglu_ff_sliced(x, ln_scale, ln_bias, w1, b1, w2, b2, cluster=WIDE_CLUSTER):
    """The D = 256 kernel's arithmetic in plain PyTorch: LN(x) rounded to x's
    dtype, each slice of 4 D / cluster GEGLU units computed on its own into
    an f32 partial of the output, the partials summed in slice order, then
    b2, the rounding and the residual as in ``fused_ln_geglu_ff_reference``."""
    dt = x.dtype
    FF = w2.shape[0]
    h = ln_affine(x, ln_scale, ln_bias).float()
    w1f, b1f, w2f = w1.float(), b1.float(), w2.float()
    sl = FF // cluster
    total = None
    for r in range(cluster):
        u = h @ w1f[:, r * sl:(r + 1) * sl] + b1f[r * sl:(r + 1) * sl]
        g = h @ w1f[:, FF + r * sl:FF + (r + 1) * sl] + b1f[FF + r * sl:FF + (r + 1) * sl]
        part = (u * gelu(g)).to(dt).float() @ w2f[r * sl:(r + 1) * sl]
        total = part if total is None else total + part
    out = (total + b2.float()).to(dt)
    return (x.float() + out.float()).to(dt)


def fused_ln_geglu_ff_reference(x, ln_scale, ln_bias, w1, b1, w2, b2) -> torch.Tensor:
    """Plain PyTorch version with the kernel's arithmetic.

    x (T, D) in the compute dtype; w1 (D, 2 FF), b1 (2 FF,), w2 (FF, D),
    b2 (D,). LayerNorm statistics are f32 and its output rounds to x's dtype;
    both products accumulate in f32 with the f32 biases; the GEGLU activation
    and the product's output round to x's dtype before the residual add.
    """
    dt = x.dtype
    h = ln_affine(x, ln_scale, ln_bias)
    a, g = (h.float() @ w1.float() + b1.float()).chunk(2, dim=-1)
    act = (a * gelu(g)).to(dt)
    out = (act.float() @ w2.float() + b2.float()).to(dt)
    return (x.float() + out.float()).to(dt)


def example_inputs(T: int, D: int, seed: int = 0):
    """Random operands at width D, as float32 numpy arrays in
    ``fused_ln_geglu_ff``'s argument order (weights scaled like
    lecun_normal); ``ops/fused_core.operands`` turns them into tensors."""
    rng = np.random.RandomState(seed)
    r = lambda *s: rng.randn(*s).astype(np.float32)
    return dict(x=r(T, D), ln_scale=1 + 0.1 * r(D), ln_bias=0.1 * r(D), w1=r(D, 8 * D) * D**-0.5,
                b1=0.1 * r(8 * D), w2=r(4 * D, D) * (4 * D) ** -0.5, b2=0.1 * r(D))


def fused_ln_geglu_ff(x, ln_scale, ln_bias, w1, b1, w2, b2) -> torch.Tensor:
    """x (T, D) -> x + FF(LN(x)): the CUDA kernel for tensors on the card, the
    plain version for tensors on the CPU. On the card every operand is bf16
    except b1 and b2, which are f32; D is 128 or 256 and any T from 1 to 2^31 - 1
    is taken."""
    global launches
    args = (x, ln_scale, ln_bias, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return fused_ln_geglu_ff_reference(*args)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ff: no kernel for device {x.device}")
    T, D = x.shape
    if not takes(D) or tuple(w1.shape) != (D, 8 * D):
        raise NotImplementedError(
            f"fused_ff: the kernel takes D in {WIDTHS} with FF = 4 D; got x {tuple(x.shape)}, "
            f"w1 {tuple(w1.shape)}")
    bf, f32 = torch.bfloat16, torch.float32
    specs = (("x", (T, D), bf), ("ln_scale", (D,), bf), ("ln_bias", (D,), bf),
             ("w1", (D, 8 * D), bf), ("b1", (8 * D,), f32), ("w2", (4 * D, D), bf),
             ("b2", (D,), f32))
    _build.check_operands("fused_ff", specs, args)
    from .fused_core import launch_schedule  # fused_core imports this module

    if D == 128:
        grid, tiles_per_row = launch_schedule(1, T, x.device)
    else:
        plan = wide_plan(T, D)
        grid, tiles_per_row = plan["grid"], plan["tiles"]
    lib = _library()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.difffacto_fused_ff(*(t.data_ptr() for t in args), out.data_ptr(), T, D, grid,
                                    tiles_per_row, stream)
    _build.check_launch(lib, "fused_ff", rc)
    launches += 1
    return out


def _library() -> ctypes.CDLL:
    lib = _build.load("fused_ff")
    fn = lib.difffacto_fused_ff
    if not fn.argtypes:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.difffacto_cuda_error_string.argtypes = [ctypes.c_int]
        lib.difffacto_cuda_error_string.restype = ctypes.c_char_p
        lib.difffacto_fused_ff_smem_bytes.argtypes = [ctypes.c_int]
        lib.difffacto_fused_ff_smem_bytes.restype = ctypes.c_int
    return lib


def smem_bytes(D: int) -> int:
    """Dynamic shared memory of one thread block of the kernel at width D."""
    return _library().difffacto_fused_ff_smem_bytes(D)
