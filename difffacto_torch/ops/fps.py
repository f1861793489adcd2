"""Furthest point sampling: kernel wrapper, launch plan, plain version, launch count.

Replaces the TPU kernel ``difffacto_tpu/ops/fps_pallas.py:_fps_kernel`` with
the hand-written CUDA kernel ``csrc/fps.cu`` (see its note for the design and
the bound). Sampling starts at index 0; each step takes the point whose
distance to the chosen set is largest, ties to the lowest index; the
near-origin skip of the original CUDA extension is left out, as in the JAX
package. ``furthest_point_sample`` launches the kernel for CUDA tensors and
runs ``furthest_point_sample_reference`` for CPU tensors; both give the same
indices because both compute ``(dx*dx + dy*dy) + dz*dz`` in f32 without FMA.

``plan`` chooses the kernel's cluster size, threads and points a thread;
``furthest_point_sample_model`` runs the kernel's reduction (contiguous
ownership, warp, block, cluster) in plain PyTorch for the CPU tests.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..utils import trace
from . import _build

REG_POINTS = (16, 32)  # points a thread
BLOCK_POINTS = 8192  # the most points a block holds in registers
MAX_CLUSTER = 8  # blocks a cloud (the portable cluster size)
MIN_BLOCK_POINTS = 2048  # no cluster splits a cloud below this many points a block
# Every block keeps the cloud's x, y and z in shared memory beside 2064 bytes
# of candidate slots and barriers, in the 227 KB (232,448 bytes) it may use.
REG_MAX_POINTS = (232448 - 2064) // 12


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(B: int, N: int, sms: int, cluster: Optional[int] = None) -> dict:
    """The kernel's launch for B clouds of N points on a card with ``sms`` SMs.

    The cluster size C doubles from 1 while B * 2C blocks still fit on the
    SMs, each block keeps at least ``MIN_BLOCK_POINTS`` points and C stays at
    most 8; then it doubles further until the registers of C blocks hold the
    cloud (``BLOCK_POINTS`` each). ``cluster`` sets C instead, for
    measurements. Block r owns points [r npc, (r + 1) npc) with
    npc = ceil(N / C), thread t the run [t P, (t + 1) P), P = 16 where
    npc <= 4096, else 32. Each block's shared copy of the cloud bounds N at
    ``REG_MAX_POINTS``."""
    def held(c):  # the registers of c blocks hold the cloud
        return N <= c * BLOCK_POINTS and N <= REG_MAX_POINTS

    if cluster is None:
        C = 1
        while (C < MAX_CLUSTER and B * 2 * C <= sms
               and _cdiv(N, 2 * C) >= MIN_BLOCK_POINTS):
            C *= 2
        while not held(C) and C < MAX_CLUSTER:
            C *= 2
    else:
        if cluster not in (1, 2, 4, 8):
            raise ValueError(f"fps: cluster size {cluster}; the kernel takes 1, 2, 4 or 8")
        C = cluster
    if not held(C):
        raise ValueError(f"fps: {N} points a cloud; a cluster of {C} holds at most "
                         f"{min(C * BLOCK_POINTS, REG_MAX_POINTS)}")
    npc = _cdiv(N, C)
    P = REG_POINTS[1] if npc > BLOCK_POINTS // 2 else REG_POINTS[0]
    threads = max(32, _cdiv(_cdiv(npc, P), 32) * 32)
    return dict(cluster=C, points_per_block=npc, points_per_thread=P,
                threads=threads, grid=B * C, smem_bytes=12 * N + 2064)


def float_bits(x: torch.Tensor) -> torch.Tensor:
    """The f32 bit patterns of x as unsigned 32-bit values in int64."""
    return x.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _first_max(v: torch.Tensor, dim: int):
    """(largest value, lowest index holding it) along ``dim``."""
    top = v.max(dim=dim, keepdim=True).values
    ar = torch.arange(v.shape[dim]).view([-1 if d == dim % v.dim() else 1 for d in range(v.dim())])
    first = torch.where(v == top, ar, v.shape[dim]).min(dim=dim).values
    return top.squeeze(dim), first


def furthest_point_sample_model(xyz: torch.Tensor, npoint: int, cluster: int) -> torch.Tensor:
    """The kernel's steps in plain PyTorch, on the CPU: the kernel's
    arithmetic, its ownership (block r the points [r npc, (r + 1) npc),
    thread t the run [t P, (t + 1) P) of them), padding held at 0, and the
    argmax taken as the kernel takes it: per thread the first largest over
    its run, per warp the largest bits and then the lowest index holding
    them, then the same over the cluster's C x warps (bits, index) pairs.
    (B, N, 3) -> (B, npoint) int32."""
    x = xyz.float()
    B, N, _ = x.shape
    pl = plan(B, N, sms=0, cluster=cluster)
    C, npc, P, T = pl["cluster"], pl["points_per_block"], pl["points_per_thread"], pl["threads"]
    W = T // 32
    rows = torch.arange(B)
    px, py, pz = x[..., 0], x[..., 1], x[..., 2]
    dists = torch.full((B, N), float("inf"))
    idx = torch.zeros((B, npoint), dtype=torch.int64)
    last = torch.zeros(B, dtype=torch.int64)
    # The index each register slot stands for: rank r, thread t, slot j.
    slot_idx = (torch.arange(C).view(C, 1) * npc + torch.arange(T * P).view(1, -1)).view(C, W, 32, P)
    owned = (torch.arange(T * P) < npc).view(1, -1) & (slot_idx.view(C, -1) < N)
    for s in range(1, npoint):
        c = x[rows, last]
        dx, dy, dz = px - c[:, 0:1], py - c[:, 1:2], pz - c[:, 2:3]
        dists = torch.minimum(dists, (dx * dx + dy * dy) + dz * dz)
        bits = torch.zeros((B, C, T * P), dtype=torch.int64)  # padding: minimum 0
        flat = slot_idx.view(C, -1).clamp(max=N - 1)
        bits[:, owned] = float_bits(dists)[:, flat[owned]]
        v, j = _first_max(bits.view(B, C, W, 32, P), -1)  # per thread: its first largest
        ti = torch.gather(slot_idx.expand(B, C, W, 32, P), -1, j[..., None]).squeeze(-1)
        wmax = v.max(dim=-1, keepdim=True).values  # per warp: largest bits ...
        widx = torch.where(v == wmax, ti, 2**32 - 1).min(dim=-1).values  # ... lowest index
        cv, ci = wmax.reshape(B, C * W), widx.reshape(B, C * W)  # the cluster's pairs
        cmax = cv.max(dim=-1, keepdim=True).values
        last = torch.where(cv == cmax, ci, 2**32 - 1).min(dim=-1).values
        idx[:, s] = last
    return idx.to(torch.int32)


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

    The CUDA kernel for tensors on the card, launched by ``plan``, the plain
    version for tensors on the CPU. A failed build or launch raises.
    """
    if xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"furthest_point_sample: xyz has shape {tuple(xyz.shape)}, expected (B, N, 3)")
    if npoint < 1:
        raise ValueError(f"furthest_point_sample: npoint is {npoint}")
    if xyz.device.type == "cpu":
        return furthest_point_sample_reference(xyz, npoint)
    out = _launch(xyz, npoint, None, probe=False)
    trace.count("fps.launches")
    return out


def latency_floor_probe(xyz: torch.Tensor, npoint: int,
                        cluster: Optional[int] = None) -> torch.Tensor:
    """The kernel's steps with no distance sweep (``csrc/fps.cu``:
    ``fps_reg_kernel<P, false>``): the reduction, exchange, barrier and index
    store of npoint - 1 steps, for timing, at the plan's cluster size or at
    ``cluster``. Its indices are not FPS; it is not counted in ``fps.launches``."""
    return _launch(xyz, npoint, cluster, probe=True)


def _launch(xyz: torch.Tensor, npoint: int, cluster: Optional[int],
            probe: bool = False) -> torch.Tensor:
    """The kernel on a CUDA tensor at the plan's cluster size or at
    ``cluster``; not counted in ``fps.launches``. Measurements call it to force a
    cluster size."""
    if xyz.device.type != "cuda":
        raise ValueError(f"furthest_point_sample: no kernel for device {xyz.device}")
    B, N, _ = xyz.shape
    pl = plan(B, N, _sms(xyz.device), cluster)
    x = xyz.detach().float().contiguous()
    out = torch.empty((B, npoint), dtype=torch.int32, device=x.device)
    if B == 0:
        return out
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.difffacto_fps(x.data_ptr(), out.data_ptr(), B, N, npoint, pl["cluster"],
                               pl["threads"], pl["points_per_thread"], int(probe), stream)
    _build.check_launch(lib, "fps", rc)
    return out


def _sms(device: torch.device) -> int:
    return _sm_count(device.index if device.index is not None else torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _library() -> ctypes.CDLL:
    lib = _build.load("fps")
    fn = lib.difffacto_fps
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.difffacto_cuda_error_string.argtypes = [ctypes.c_int]
        lib.difffacto_cuda_error_string.restype = ctypes.c_char_p
    return lib
