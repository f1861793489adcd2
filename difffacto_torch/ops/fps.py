"""Furthest point sampling: kernel wrapper, plain version, launch count.

Replaces the TPU kernel ``difffacto_tpu/ops/fps_pallas.py:_fps_kernel`` with
the hand-written CUDA kernel ``csrc/fps.cu`` (see its note for the design and
the bound). Sampling starts at index 0; each step takes the point whose
distance to the chosen set is largest, ties to the lowest index; the
near-origin skip of the original CUDA extension is left out, as in the JAX
package. ``furthest_point_sample`` launches the kernel for CUDA tensors and
runs ``furthest_point_sample_reference`` for CPU tensors; both give the same
indices because both compute ``(dx*dx + dy*dy) + dz*dz`` in f32 without FMA.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0  # kernel launches since the caller last set it to 0


def furthest_point_sample_reference(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Plain PyTorch FPS with the kernel's arithmetic and tie rule.

    (B, N, 3) -> (B, npoint) int32 indices, on the device of ``xyz``.
    """
    x = xyz.float()
    B, N, _ = x.shape
    px, py, pz = x[..., 0], x[..., 1], x[..., 2]
    arange = torch.arange(N, device=x.device)
    rows = torch.arange(B, device=x.device)
    dists = torch.full((B, N), float("inf"), device=x.device)
    idx = torch.zeros((B, npoint), dtype=torch.int64, device=x.device)
    last = torch.zeros(B, dtype=torch.int64, device=x.device)
    for i in range(1, npoint):
        c = x[rows, last]  # (B, 3)
        dx, dy, dz = px - c[:, 0:1], py - c[:, 1:2], pz - c[:, 2:3]
        dists = torch.minimum(dists, (dx * dx + dy * dy) + dz * dz)
        top = dists.max(dim=1, keepdim=True).values
        last = torch.where(dists == top, arange, N).min(dim=1).values  # lowest index
        idx[:, i] = last
    return idx.to(torch.int32)


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Batched FPS: (B, N, 3) -> (B, npoint) int32 indices, starting at point 0.

    The CUDA kernel for tensors on the card, the plain version for tensors on
    the CPU. A failed build or launch raises.
    """
    global launches
    if xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"furthest_point_sample: xyz has shape {tuple(xyz.shape)}, expected (B, N, 3)")
    if npoint < 1:
        raise ValueError(f"furthest_point_sample: npoint is {npoint}")
    if xyz.device.type == "cpu":
        return furthest_point_sample_reference(xyz, npoint)
    if xyz.device.type != "cuda":
        raise ValueError(f"furthest_point_sample: no kernel for device {xyz.device}")
    B, N, _ = xyz.shape
    lib = _library()
    if N > lib.difffacto_fps_max_points():
        raise ValueError(
            f"furthest_point_sample: {N} points a cloud; the kernel holds at most "
            f"{lib.difffacto_fps_max_points()} in shared memory"
        )
    x = xyz.detach().float().contiguous()
    out = torch.empty((B, npoint), dtype=torch.int32, device=x.device)
    if B == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.difffacto_fps(x.data_ptr(), out.data_ptr(), B, N, npoint, stream)
    if rc != 0:
        raise RuntimeError(
            f"fps kernel launch failed: {lib.difffacto_cuda_error_string(rc).decode()}"
        )
    launches += 1
    return out


def _library() -> ctypes.CDLL:
    lib = _build.load("fps")
    fn = lib.difffacto_fps
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.difffacto_fps_max_points.argtypes = []
        lib.difffacto_fps_max_points.restype = ctypes.c_int
        lib.difffacto_cuda_error_string.argtypes = [ctypes.c_int]
        lib.difffacto_cuda_error_string.restype = ctypes.c_char_p
    return lib
