"""Eval-grade EMD assignment: Sinkhorn warm start, then a dense auction.

Replaces the TPU kernel ``difffacto_tpu/ops/emd_pallas.py:_emd_hybrid_kernel``
with the hand-written CUDA kernel ``csrc/emd_hybrid.cu`` (see its note for
the design and the bound). Per pair of clouds: ``sinkhorn_iters`` annealed
log-domain Sinkhorn iterations (eps from ``eps_start`` down to ``eps``, times
``eps_decay`` every ``sinkhorn_inner``) give the column potential g; an
auction from price = -g at ``eps`` runs until every row holds an object or
``auction_iters`` rounds are spent; rows left over take their best object.
The assignment is what comes out; matched distances are computed by the
caller in f32 (``ops/emd.py``).

``emd_assignment_hybrid`` launches the kernel for CUDA tensors and runs
``emd_assignment_hybrid_reference`` for CPU tensors. The plain version
repeats the kernel's arithmetic (direct f32 distances, the same eps table,
the same tie rules) but sums its log-sum-exp in another order, so on
near-ties the two may choose other objects: their costs agree, their
assignments need not.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import _build

_NEG = -1e30
_LOW32 = 0xFFFFFFFF

launches = 0  # kernel launches since the caller last set it to 0


def eps_schedule(sinkhorn_iters: int, sinkhorn_inner: int, eps: float, eps_start: float,
                 eps_decay: float) -> np.ndarray:
    """eps of each Sinkhorn iteration in f32:
    ``max(eps_start * eps_decay ** (k // sinkhorn_inner), eps)``."""
    level = (np.arange(sinkhorn_iters) // sinkhorn_inner).astype(np.float32)
    e = np.float32(eps_start) * np.exp(level * np.float32(math.log(eps_decay)))
    return np.maximum(e.astype(np.float32), np.float32(eps))


def _sinkhorn_rows(xyz1: torch.Tensor, sinkhorn_rows: int):
    """The Sinkhorn runs on the first m rows. For m < n, xyz1 is permuted by a
    fixed permutation so that those rows are a uniform sample whatever order
    the points came in; the caller undoes it on the assignment."""
    n = xyz1.shape[1]
    granule = 256 if n % 256 == 0 else 128
    m = sinkhorn_rows if 0 < sinkhorn_rows < n else n
    m = max(granule, (m // granule) * granule)
    if m >= n:
        return xyz1, n, None
    perm = np.random.RandomState(1234).permutation(n)
    inv_perm = torch.as_tensor(np.argsort(perm), device=xyz1.device)
    return xyz1[:, torch.as_tensor(perm, device=xyz1.device)], m, inv_perm


def _check(xyz1, xyz2):
    if xyz1.dim() != 3 or xyz1.shape[-1] != 3 or xyz1.shape != xyz2.shape:
        raise ValueError(
            f"emd_assignment_hybrid: clouds have shapes {tuple(xyz1.shape)} and "
            f"{tuple(xyz2.shape)}, expected two of (B, n, 3)"
        )
    if xyz1.shape[1] % 128 != 0:
        raise ValueError(f"emd_assignment_hybrid: n = {xyz1.shape[1]} is not a multiple of 128")
    if xyz1.device != xyz2.device:
        raise ValueError("emd_assignment_hybrid: the two clouds must share one device")


def emd_assignment_hybrid_reference(
    xyz1: torch.Tensor, xyz2: torch.Tensor, *, sinkhorn_iters: int = 150,
    sinkhorn_inner: int = 30, auction_iters: int = 300, eps: float = 0.002,
    eps_start: float = 0.05, eps_decay: float = 0.4, sinkhorn_rows: int = 0,
    return_work: bool = False,
):
    """Plain PyTorch version of the kernel, on the device of its inputs.

    (B, n, 3) x (B, n, 3) -> assignment (B, n) int32 (x1 point -> x2 index),
    and with ``return_work`` the auction rounds each pair ran and the bids it
    computed (the unassigned rows of every round plus the rows force-assigned
    at the end), each (B,) int32.
    It holds the (B, n, n) distance matrix, so it is for checks, not for size.
    """
    _check(xyz1, xyz2)
    B, n, _ = xyz1.shape
    x1, m, inv_perm = _sinkhorn_rows(xyz1.float(), sinkhorn_rows)
    x2 = xyz2.float()
    dev = x1.device
    dx = x1[:, :, None, 0] - x2[:, None, :, 0]
    dy = x1[:, :, None, 1] - x2[:, None, :, 1]
    dz = x1[:, :, None, 2] - x2[:, None, :, 2]
    d = (dx * dx + dy * dy + dz * dz).sqrt()  # (B, n, n)
    del dx, dy, dz

    g = torch.zeros((B, n), device=dev)
    dm = d[:, :m]
    for e in eps_schedule(sinkhorn_iters, sinkhorn_inner, eps, eps_start, eps_decay):
        inv, e = float(np.float32(1.0) / e), float(e)
        z = (g[:, None, :] - dm) * inv
        zm = z.max(dim=2, keepdim=True).values
        f = -e * ((z - zm).exp().sum(dim=2).log() + zm[:, :, 0])  # (B, m)
        z = (f[:, :, None] - dm) * inv
        zm = z.max(dim=1, keepdim=True).values
        g = -e * ((z - zm).exp().sum(dim=1).clamp_min(1e-30).log() + zm[:, 0])  # (B, n)
    del dm, z, zm

    price = -g
    lane = torch.arange(n, device=dev, dtype=torch.int32)
    rows = torch.arange(n, device=dev)
    assign = torch.full((B, n), -1, dtype=torch.int64, device=dev)
    owner = torch.full((B, n), -1, dtype=torch.int64, device=dev)
    rounds = torch.zeros(B, dtype=torch.int32, device=dev)
    bids = torch.zeros(B, dtype=torch.int32, device=dev)
    for _ in range(auction_iters):
        unass = assign < 0
        active = unass.any(dim=1)
        if not active.any():
            break
        rounds += active
        bids += unass.sum(dim=1)
        best, bid, better = _best_two(d, price, lane)
        inc = best - better + eps
        # Per object the largest bid wins, the lowest row among equal bids: one
        # max over (bits of the bid, ~row), as the kernel's atomicMax takes it.
        key = (inc.view(torch.int32).long() << 32) | (_LOW32 - rows)
        slot = torch.where(unass, bid, n)
        win = torch.zeros((B, n + 1), dtype=torch.int64, device=dev)
        win = win.scatter_reduce_(1, slot, key, "amax", include_self=True)[:, :n]
        taken = win > 0
        win_inc = (win >> 32).to(torch.int32).view(torch.float32)
        win_row = _LOW32 - (win & _LOW32)
        price = price + torch.where(taken, win_inc, 0.0)
        # Evict the owners of taken objects, then seat the winners; slot n is a dummy.
        buf = torch.cat([assign, assign.new_zeros((B, 1))], dim=1)
        buf.scatter_(1, torch.where(taken & (owner >= 0), owner, n), -1)
        buf.scatter_(1, torch.where(taken, win_row, n), rows.expand(B, n))
        assign = buf[:, :n]
        owner = torch.where(taken, win_row, owner)
    # Rows still unassigned take their best object at the final prices.
    bids += (assign < 0).sum(dim=1)
    if (assign < 0).any():
        assign = torch.where(assign < 0, _best_two(d, price, lane)[1], assign)
    assign = assign.to(torch.int32)
    if inv_perm is not None:
        assign = assign[:, inv_perm]
    return (assign, rounds, bids) if return_work else assign


def _best_two(d, price, lane):
    """Per row: the best value -d - price, its lowest index, and the best
    value among the other objects."""
    n = d.shape[1]
    value = -d - price[:, None, :]
    best = value.max(dim=2, keepdim=True).values
    bid = torch.where(value >= best, lane, n).min(dim=2).values.long()
    better = value.masked_fill(lane == bid[..., None], _NEG).max(dim=2).values
    return best[..., 0], bid, better


def emd_assignment_hybrid(
    xyz1: torch.Tensor, xyz2: torch.Tensor, *, sinkhorn_iters: int = 150,
    sinkhorn_inner: int = 30, auction_iters: int = 300, eps: float = 0.002,
    eps_start: float = 0.05, eps_decay: float = 0.4, sinkhorn_rows: int = 0,
    return_work: bool = False,
):
    """(B, n, 3) x (B, n, 3) -> assignment (B, n) int32 (x1 point -> x2 index).

    The CUDA kernel for tensors on the card, the plain version for tensors
    on the CPU; a failed build or launch raises. n must be a multiple of 128.
    ``sinkhorn_rows`` (0 = all n) runs the warm start on a uniform row
    subsample of that size, rounded down to a multiple of 256 (128 where 256
    does not divide n). The TPU kernel's scheduling arguments (``tile``,
    ``auction_chunk``, ``cache_dist``) have no counterpart here. With
    ``return_work`` the auction rounds each pair ran and the bids it computed
    come back too, each (B,) int32.
    """
    global launches
    _check(xyz1, xyz2)
    kwargs = dict(sinkhorn_iters=sinkhorn_iters, sinkhorn_inner=sinkhorn_inner,
                  auction_iters=auction_iters, eps=eps, eps_start=eps_start,
                  eps_decay=eps_decay, sinkhorn_rows=sinkhorn_rows, return_work=return_work)
    if xyz1.device.type == "cpu":
        return emd_assignment_hybrid_reference(xyz1, xyz2, **kwargs)
    if xyz1.device.type != "cuda":
        raise ValueError(f"emd_assignment_hybrid: no kernel for device {xyz1.device}")
    B, n, _ = xyz1.shape
    dev = xyz1.device
    x1, m, inv_perm = _sinkhorn_rows(xyz1.detach().float(), sinkhorn_rows)
    x1, x2 = x1.contiguous(), xyz2.detach().float().contiguous()
    table = torch.as_tensor(
        eps_schedule(sinkhorn_iters, sinkhorn_inner, eps, eps_start, eps_decay), device=dev
    )
    out = torch.empty((B, n), dtype=torch.int32, device=dev)
    rounds = torch.empty(B, dtype=torch.int32, device=dev)
    bids = torch.empty(B, dtype=torch.int32, device=dev)
    if B > 0:
        lib = _library()
        ws_bytes = lib.difffacto_emd_hybrid_workspace_bytes(n)
        workspace = torch.empty(B * ws_bytes, dtype=torch.uint8, device=dev) if ws_bytes else None
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.difffacto_emd_hybrid(
                x1.data_ptr(), x2.data_ptr(), table.data_ptr(), out.data_ptr(), rounds.data_ptr(),
                bids.data_ptr(),
                workspace.data_ptr() if workspace is not None else None,
                B, n, m, sinkhorn_iters, auction_iters, float(eps), stream,
            )
        if rc != 0:
            raise RuntimeError(
                f"emd_hybrid kernel launch failed: {lib.difffacto_cuda_error_string(rc).decode()}"
            )
        launches += 1
    if inv_perm is not None:
        out = out[:, inv_perm]
    return (out, rounds, bids) if return_work else out


def _library() -> ctypes.CDLL:
    lib = _build.load("emd_hybrid")
    fn = lib.difffacto_emd_hybrid
    if not fn.argtypes:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.difffacto_emd_hybrid_workspace_bytes.argtypes = [ctypes.c_int]
        lib.difffacto_emd_hybrid_workspace_bytes.restype = ctypes.c_longlong
        lib.difffacto_cuda_error_string.argtypes = [ctypes.c_int]
        lib.difffacto_cuda_error_string.restype = ctypes.c_char_p
    return lib
