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
potentials, the shift, the band, the redo and the terms that take the
kernel's exp2 in software, ``exp2_soft_reference``) and ``best_two_strided``
its warp-parallel bid (lanes over strided objects, then a butterfly of (best,
second, lowest index)), for the CPU tests.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..utils import trace
from . import _build

_NEG = -1e30
_LOW32 = 0xFFFFFFFF


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
ROWS = 4  # points a thread of the kernel sweeps at once, in its row slots
KSTEP = 4  # points of the other axis a step of the kernel's sweep takes
# exp2_soft's polynomial for 2^f on [-1/2, 1/2] (C1..C6; the constant term is
# 1) and the shift whose add leaves rint(z) + 127 in a float's low bits.
EXP2_POLY = tuple(float.fromhex(c) for c in (
    "0x1.62e430p-1", "0x1.ebfbdcp-3", "0x1.c6aee8p-5", "0x1.3b2d4cp-7", "0x1.5f3e52p-10",
    "0x1.41fbbcp-13"))
EXP2_SHIFT = 1.5 * 2.0**23 + 127.0


def exp2_soft_reference(z: torch.Tensor) -> torch.Tensor:
    """The kernel's exp2 on the FMA pipes (``csrc/emd_hybrid.cu:exp2_soft``),
    step for step in float32: z clamped at -127; t = z + EXP2_SHIFT,
    j = t - EXP2_SHIFT = rint(z), f = z - j in [-1/2, 1/2]; 2^f by Horner over
    ``EXP2_POLY``; times 2^j built from t's low bits in the exponent field (0
    at j = -127), a subnormal product flushed to 0. Each fused multiply-add is
    taken in float64 and rounded once to float32 (the product of two float32
    is exact there; a rare double rounding may move the last bit). For
    z < 128.5, as in the kernel."""
    z = z.float().clamp_min(-127.0)
    t = z + EXP2_SHIFT
    f = (z - (t - EXP2_SHIFT)).double()
    p = torch.full_like(f, EXP2_POLY[-1])
    for c in EXP2_POLY[-2::-1] + (1.0,):
        p = (p * f + c).float().double()
    scale = ((t.view(torch.int32) & 0xFF) << 23).view(torch.float32)
    y = p.float() * scale
    return torch.where(y < 2.0**-126, 0.0, y)


def sweep_threads(n: int) -> int:
    """Threads of a launch at n points: n / ROWS, up to 1024."""
    return min(n // ROWS, 1024)


def soft_per_step(n: int, count: int, soft: int) -> torch.Tensor:
    """For each of the ``count`` points one sweep updates in a launch at n
    points, how many of each step's KSTEP terms take the soft exp2, int64
    (count,): with T threads, point i lies in row slot r = (i mod ROWS T) // T
    of its thread, and of a step's ROWS x KSTEP terms, term (r, u) is soft
    where (ROWS - 1 - r) KSTEP + u < ``soft``."""
    T = sweep_threads(n)
    slot = (torch.arange(count) % (ROWS * T)) // T
    return (soft - (ROWS - 1 - slot) * KSTEP).clamp(0, KSTEP)


def soft_mask(n: int, count: int, others: int, soft: int) -> torch.Tensor:
    """Which terms of one sweep (``count`` points against ``others``) take
    the soft exp2 in a launch at n points, bool (count, others): term (i, k)
    where k mod KSTEP is below the point's ``soft_per_step``."""
    return torch.arange(others) % KSTEP < soft_per_step(n, count, soft)[:, None]


def sweep_counts(B: int, n: int, m: int, sinkhorn_iters: int, soft: int) -> dict:
    """The shifted sweep's terms in a launch of B pairs (m rows of n points
    in the Sinkhorn) and those the soft exp2 takes, as ``emd.*`` counts."""
    per_iter = (int(soft_per_step(n, m, soft).sum()) * (n // KSTEP)
                + int(soft_per_step(n, n, soft).sum()) * (m // KSTEP))
    return {"emd.sweep_terms": B * sinkhorn_iters * 2 * m * n,
            "emd.sweep_soft_terms": B * sinkhorn_iters * per_iter}


def sinkhorn_log2_reference(d: torch.Tensor, table, force_redo=(), return_redone=False,
                            soft=0):
    """The kernel's Sinkhorn sweep on the CPU, over d (B, m, n): returns g (B, n).

    The potentials are held scaled by c = log2(e) / eps and rescaled when eps
    steps. A half-iteration gives each point w <- w - log2(S) with
    S = sum_k 2^(w_k - c d + w): the terms are shifted by the point's own
    scaled potential w from the previous sweep, with no max. Where S lies
    outside ``SUM_BAND`` or is not finite, the point is redone with the exact
    max: w = -(M + log2 sum_k 2^(z_k - M)), z_k = w_k - c d, M = max z. Sweep
    2 k is the row half of iteration k, 2 k + 1 its column half; the sweeps in
    ``force_redo`` redo every point. With ``return_redone`` the number of
    points redone in each sweep comes back too, as a list. The terms to
    which the kernel gives its soft exp2 (``soft_mask`` with ``soft`` of each
    step's ROWS x KSTEP terms) take ``exp2_soft_reference`` in the shifted
    sum. The other exps and the square roots here are exact in f32; the
    kernel's approximate ones differ from them by a few ulp.
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
            arg = z + w[half].unsqueeze(axis)
            terms = torch.exp2(arg)
            if soft:
                mask = soft_mask(n, m, n, soft) if half == 0 else soft_mask(n, n, m, soft).T
                terms = torch.where(mask, exp2_soft_reference(arg), terms)
            S = terms.sum(dim=axis)
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
    come back too, each (B,) int32, and the kernel's Sinkhorn work: a dict of
    its clock cycles a pair (``cycles``, (B,) int64, read on the card) and the
    launch's ``sweep_counts``, or None where the plain version ran.
    """
    _check(xyz1, xyz2)
    kwargs = dict(sinkhorn_iters=sinkhorn_iters, sinkhorn_inner=sinkhorn_inner,
                  auction_iters=auction_iters, eps=eps, eps_start=eps_start,
                  eps_decay=eps_decay, sinkhorn_rows=sinkhorn_rows, return_work=return_work)
    if xyz1.device.type == "cpu":
        got = emd_assignment_hybrid_reference(xyz1, xyz2, **kwargs)
        return (*got, None) if return_work else got
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
    cycles = torch.empty(B, dtype=torch.int64, device=dev) if return_work else None
    lib = _library()
    if B > 0:
        ws_bytes = lib.difffacto_emd_hybrid_workspace_bytes(n)
        workspace = torch.empty(B * ws_bytes, dtype=torch.uint8, device=dev) if ws_bytes else None
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.difffacto_emd_hybrid(
                x1.data_ptr(), x2.data_ptr(), table.data_ptr(), out.data_ptr(), rounds.data_ptr(),
                bids.data_ptr(), cycles.data_ptr() if cycles is not None else None,
                workspace.data_ptr() if workspace is not None else None,
                B, n, m, sinkhorn_iters, auction_iters, float(eps), stream,
            )
        _build.check_launch(lib, "emd_hybrid", rc)
        trace.count("emd_hybrid.launches")
    if inv_perm is not None:
        out = out[:, inv_perm]
    if not return_work:
        return out
    sinkhorn = dict(sweep_counts(B, n, m, sinkhorn_iters, lib.difffacto_emd_hybrid_soft_terms()),
                    cycles=cycles)
    return out, rounds, bids, sinkhorn


def exp2_probe(z: torch.Tensor, soft: bool) -> torch.Tensor:
    """The kernel's exp2 over z (f32 on the card), for the tests:
    ``exp2_soft`` where ``soft``, else ``ex2.approx.ftz``."""
    z = z.float().contiguous()
    out = torch.empty_like(z)
    lib = _library()
    with torch.cuda.device(z.device):
        rc = lib.difffacto_emd_exp2_probe(z.data_ptr(), out.data_ptr(), z.numel(), int(soft),
                                          torch.cuda.current_stream(z.device).cuda_stream)
    _build.check_launch(lib, "emd_exp2_probe", rc)
    return out


def _library() -> ctypes.CDLL:
    lib = _build.load("emd_hybrid")
    fn = lib.difffacto_emd_hybrid
    if not fn.argtypes:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.difffacto_emd_hybrid_workspace_bytes.argtypes = [ctypes.c_int]
        lib.difffacto_emd_hybrid_workspace_bytes.restype = ctypes.c_longlong
        lib.difffacto_emd_hybrid_soft_terms.argtypes = []
        lib.difffacto_emd_hybrid_soft_terms.restype = ctypes.c_int
        lib.difffacto_emd_exp2_probe.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
        lib.difffacto_emd_exp2_probe.restype = ctypes.c_int
        lib.difffacto_cuda_error_string.argtypes = [ctypes.c_int]
        lib.difffacto_cuda_error_string.restype = ctypes.c_char_p
    return lib
