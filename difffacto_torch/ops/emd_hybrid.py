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
computes the same function the straightforward way: direct f32 distances
with exact square roots, natural-log sums shifted by their max and exact
exps, the same eps table and the same tie rules. The kernel works in base 2
with the approximate square root and exp of the special-function units,
shifts each sum by the point's own potential from the previous sweep and
redoes a point with the exact max only when that sum leaves its band. So the
two no longer agree bit for bit, and on near-ties they may choose other
objects: their costs agree, their assignments need not.
``sinkhorn_log2_reference`` models the kernel's sweep (the scaled base-2
potentials, the shift, the band and the redo) and ``best_two_strided`` its
warp-parallel bid (lanes over strided objects, then a butterfly of (best,
second, lowest index)), for the CPU tests.
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


def pair_distances(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """(B, m, 3) x (B, n, 3) f32 -> (B, m, n) L2 distances from direct differences."""
    dx = x1[:, :, None, 0] - x2[:, None, :, 0]
    dy = x1[:, :, None, 1] - x2[:, None, :, 1]
    dz = x1[:, :, None, 2] - x2[:, None, :, 2]
    return (dx * dx + dy * dy + dz * dz).sqrt()


def sinkhorn_reference(d: torch.Tensor, table) -> torch.Tensor:
    """The plain Sinkhorn over d (B, m, n): for each eps of ``table``, f over
    the rows, then g over the columns, each a natural-log sum shifted by its
    max. Returns g (B, n)."""
    g = torch.zeros((d.shape[0], d.shape[2]), device=d.device)
    for e in table:
        inv, e = float(np.float32(1.0) / e), float(e)
        z = (g[:, None, :] - d) * inv
        zm = z.max(dim=2, keepdim=True).values
        f = -e * ((z - zm).exp().sum(dim=2).log() + zm[:, :, 0])  # (B, m)
        z = (f[:, :, None] - d) * inv
        zm = z.max(dim=1, keepdim=True).values
        g = -e * ((z - zm).exp().sum(dim=1).clamp_min(1e-30).log() + zm[:, 0])  # (B, n)
    return g


LOG2E = np.float32(1.4426950408889634)
SUM_BAND = (2.0**-64, 2.0**64)  # a shifted sum outside it is redone with the exact max


def sinkhorn_log2_reference(d: torch.Tensor, table, force_redo=(), return_redone=False):
    """The kernel's Sinkhorn sweep on the CPU, over d (B, m, n): returns g (B, n).

    The potentials are held scaled by c = log2(e) / eps and rescaled when eps
    steps. A half-iteration gives each point w <- w - log2(S) with
    S = sum_k 2^(w_k - c d + w): the terms are shifted by the point's own
    scaled potential w from the previous sweep, with no max. Where S lies
    outside ``SUM_BAND`` or is not finite, the point is redone with the exact
    max: w = -(M + log2 sum_k 2^(z_k - M)), z_k = w_k - c d, M = max z. Sweep
    2 k is the row half of iteration k, 2 k + 1 its column half; the sweeps in
    ``force_redo`` redo every point. With ``return_redone`` the number of
    points redone in each sweep comes back too, as a list. The exps and
    square roots here are exact in f32; the kernel's approximate ones differ
    from them by a few ulp.
    """
    B, m, n = d.shape
    w = [torch.zeros((B, m), device=d.device), torch.zeros((B, n), device=d.device)]
    redone = []
    c = None
    for k, e in enumerate(table):
        ck = float(LOG2E / np.float32(e))
        if c is not None and ck != c:
            ratio = float(np.float32(ck) / np.float32(c))
            w = [w[0] * ratio, w[1] * ratio]
        c = ck
        for half, axis in ((0, 2), (1, 1)):  # rows sum over the columns, columns over the rows
            other = w[1][:, None, :] if half == 0 else w[0][:, :, None]
            z = other - c * d
            S = torch.exp2(z + w[half].unsqueeze(axis)).sum(dim=axis)
            redo = ~((S >= SUM_BAND[0]) & (S <= SUM_BAND[1]))
            if 2 * k + half in force_redo:
                redo = torch.ones_like(redo)
            M = z.max(dim=axis).values
            exact = -(M + torch.exp2(z - M.unsqueeze(axis)).sum(dim=axis).log2())
            w[half] = torch.where(redo, exact, w[half] - S.log2())
            redone.append(int(redo.sum()))
    g = w[1] / c if c is not None else w[1]
    return (g, redone) if return_redone else g


def auction_reference(d: torch.Tensor, g: torch.Tensor, auction_iters: int, eps: float):
    """The plain auction from price = -g over d (B, n, n): the assignment
    (B, n) int64, the rounds run and the bids computed (the unassigned rows of
    every round plus the rows force-assigned at the end), each (B,) int32."""
    B, n, _ = d.shape
    dev = d.device
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
    return assign, rounds, bids


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
    x1, m, inv_perm = _sinkhorn_rows(xyz1.float(), sinkhorn_rows)
    d = pair_distances(x1, xyz2.float())  # (B, n, n)
    table = eps_schedule(sinkhorn_iters, sinkhorn_inner, eps, eps_start, eps_decay)
    assign, rounds, bids = auction_reference(d, sinkhorn_reference(d[:, :m], table),
                                             auction_iters, eps)
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


_NO_INDEX = 2**31 - 1  # a lane that saw no value above -1e30 (INT_MAX in the kernel)


def best_two_strided(d, price, lanes: int = 32):
    """``_best_two`` as the kernel's warp computes it, for the CPU tests.

    Lane l scans objects l, l + lanes, ... with the serial rule (best and
    second start at -1e30; a value above the best makes the best the second,
    a value above only the second replaces it), then a butterfly over the
    lanes merges (best, second, index): the larger best wins, the lower index
    among equal bests, and the merged second is the larger of the winner's
    second and the loser's best. Returns (best, index, second) per row, as
    ``_best_two`` does; n must be a multiple of ``lanes``.
    """
    value = -d - price[:, None, :]
    B, R, n = value.shape
    v = value.reshape(B, R, n // lanes, lanes)  # v[..., k, l] is object l + lanes k
    neg = torch.tensor(_NEG, dtype=value.dtype)
    best = torch.maximum(v.max(dim=2).values, neg)  # (B, R, lanes)
    k = torch.arange(n // lanes)[:, None]
    first = torch.where(v == best[:, :, None], k, n).min(dim=2).values  # lowest k at the best
    lane = torch.arange(lanes)
    idx = torch.where(best > neg, lane + lanes * first, _NO_INDEX)
    rest = v.masked_fill(k == first[:, :, None], float("-inf"))
    second = torch.maximum(rest.max(dim=2).values, neg)
    o = lanes // 2
    while o:
        ob, os_, oj = best[..., lane ^ o], second[..., lane ^ o], idx[..., lane ^ o]
        take = (ob > best) | ((ob == best) & (oj < idx))
        second = torch.where(take, torch.maximum(os_, best), torch.maximum(second, ob))
        best = torch.where(take, ob, best)
        idx = torch.where(take, oj, idx)
        o //= 2
    idx = torch.where(idx == _NO_INDEX, 0, idx)  # no value above -1e30: the serial scan keeps 0
    return best[..., 0], idx[..., 0].long(), second[..., 0]


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
