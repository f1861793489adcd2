"""Auction-algorithm approximate Earth Mover's Distance, and the eval dispatch.

The counterpart of ``difffacto_tpu/ops/emd.py``. The auction keeps the JAX
package's semantics, batched over pairs:

* value of object j for bidder i: ``3 - |x_i - y_j| - price_j``;
* every unassigned point bids ``best - better + eps`` on its best object;
* each object accepts the highest bid and evicts its previous owner; among
  bidders whose increment is within 1e-6 of the highest, the largest bidder
  index wins;
* on the final iteration all remaining bidders are force-assigned;
* the loop leaves early once every point is assigned.

``emd`` returns per-point squared distances to the matched point plus the
assignment. The gradient flows only to ``xyz1`` through the matched squared
distance.

``emd_cost_eval`` picks the eval implementation (see its docstring): the
Sinkhorn-warm-started auction of ``ops/emd_hybrid.py`` on the card, this
auction elsewhere.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ..utils import trace
from .points import gather_points_nd, square_distance

_NEG = -1e9


def _auction_single(d: torch.Tensor, eps: float, iters: int):
    """Run the auction given the L2-norm distance matrices d (B, n, n) or (n, n).

    Returns (assignment int64, price f32), each (B, n) or (n,). Pairs of a
    batch run in step; a pair whose points are all assigned no longer changes.
    """
    single = d.dim() == 2
    if single:
        d = d[None]
    B, n, _ = d.shape
    dev = d.device
    arange = torch.arange(n, device=dev)
    lane = arange.expand(B, n)
    assignment = torch.full((B, n), -1, dtype=torch.int64, device=dev)
    assignment_inv = torch.full((B, n), -1, dtype=torch.int64, device=dev)
    price = torch.zeros((B, n), dtype=d.dtype, device=dev)

    def scatter_max(fill, index, src, dtype):
        buf = torch.full((B, n + 1), fill, dtype=dtype, device=dev)
        return buf.scatter_reduce_(1, index, src, "amax", include_self=True)[:, :n]

    it = 0
    while it < iters and bool((assignment < 0).any()):
        last = it >= iters - 1
        unass = assignment < 0

        value = 3.0 - d - price[:, None, :]
        best = value.max(dim=2, keepdim=True).values
        bid = torch.where(value >= best, arange, n).min(dim=2).values  # lowest index
        better = value.masked_fill(arange == bid[..., None], float("-inf")).max(dim=2).values
        best = best[..., 0]
        inc = best - better + eps

        # Highest bid per object (only unassigned bidders take part; slot n is void).
        max_inc = scatter_max(_NEG, torch.where(unass, bid, n), inc, d.dtype)
        # The winner per object: the largest bidder index whose increment
        # reaches the maximum.
        is_top = unass & (inc >= torch.gather(max_inc, 1, bid) - 1e-6)
        max_idx = scatter_max(-1, torch.where(is_top, bid, n),
                              torch.where(is_top, lane, -1), torch.int64)
        winner = unass & (torch.gather(max_idx, 1, bid) == lane)
        if last:
            winner = winner | unass

        won_j = torch.where(winner, bid, n)
        # Evict previous owners of objects that changed hands (not on the last iteration).
        j_new_owner = scatter_max(-1, won_j, torch.where(winner, lane, -1), torch.int64)
        taken = j_new_owner >= 0
        if not last:
            evict_idx = torch.where(taken & (assignment_inv >= 0), assignment_inv, n)
            evicted = torch.zeros((B, n + 1), dtype=torch.bool, device=dev)
            evicted = evicted.scatter_(1, evict_idx, True)[:, :n]
            assignment = torch.where(evicted, -1, assignment)

        assignment = torch.where(winner, bid, assignment)
        assignment_inv = torch.where(taken, j_new_owner, assignment_inv)
        price = price + scatter_max(0.0, won_j, torch.where(winner, inc, 0.0), d.dtype)
        it += 1
    if single:
        return assignment[0], price[0]
    return assignment, price


def _matched_sqdist(xyz1, xyz2, assignment):
    matched = gather_points_nd(xyz2, assignment)
    return ((xyz1 - matched) ** 2).sum(dim=-1)


class _EMD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xyz1, xyz2, eps, iters):
        d = square_distance(xyz1, xyz2).clamp_min(0.0).sqrt()
        assignment, _ = _auction_single(d, eps, iters)
        ctx.save_for_backward(xyz1, xyz2, assignment)
        ctx.mark_non_differentiable(assignment)
        return _matched_sqdist(xyz1, xyz2, assignment), assignment

    @staticmethod
    def backward(ctx, g_dist, _g_assignment):
        xyz1, xyz2, assignment = ctx.saved_tensors
        matched = gather_points_nd(xyz2, assignment)
        # d/dxyz1 of |x1 - matched|^2 = 2 (x1 - matched); nothing flows to xyz2.
        g1 = 2.0 * (xyz1 - matched) * g_dist[..., None]
        return g1, torch.zeros_like(xyz2), None, None


def emd(xyz1: torch.Tensor, xyz2: torch.Tensor, eps: float = 0.005, iters: int = 50):
    """Approximate EMD: (B, n, 3) x (B, n, 3) -> (dist (B, n), assignment (B, n)).

    ``dist`` is the squared distance from each x1 point to its matched x2
    point; ``sqrt(dist).mean(1)`` is the metric. Reference knobs: eps=0.005,
    iters=50 for training; eps=0.002, iters=10000 for eval.
    """
    return _EMD.apply(xyz1, xyz2, eps, iters)


def emd_cost(xyz1: torch.Tensor, xyz2: torch.Tensor, eps: float = 0.002,
             iters: int = 10000) -> torch.Tensor:
    """Mean L2 matched distance per cloud -> (B,)."""
    dist, _ = emd(xyz1, xyz2, eps, iters)
    return dist.clamp_min(0.0).sqrt().mean(dim=1)


def resolved_emd_eval_config(n: Optional[int] = None, device=None):
    """Resolve the eval-EMD implementation knobs from the environment.

    Returns ``(impl, sinkhorn_iters, auction_iters, sinkhorn_rows)`` where
    impl is 'hybrid' or 'auction'. ``device`` is where the clouds lie ('cuda'
    when not given). Callers that memoize around ``emd_cost_eval`` key on
    this tuple.

    The JAX package's ``DIFFFACTO_EMD_AUCTION_CACHE`` and
    ``DIFFFACTO_EMD_AUCTION_CHUNK`` steer the TPU kernel's distance cache and
    loop scheduling and have no counterpart here: the CUDA kernel always
    recomputes f32 distances and runs one round at a time.
    """
    impl = os.environ.get("DIFFFACTO_EMD_IMPL", "")
    on_card = torch.device(device if device is not None else "cuda").type == "cuda"
    use_hybrid = (impl == "hybrid" or (impl == "" and on_card)) and (n is None or n % 128 == 0)
    return (
        "hybrid" if use_hybrid else "auction",
        int(os.environ.get("DIFFFACTO_EMD_SINKHORN_ITERS", 150)),
        int(os.environ.get("DIFFFACTO_EMD_AUCTION_ITERS", 150)),
        # warm-start Sinkhorn row subsample (0 = all rows): only g seeds the
        # auction, so an (m, n) Sinkhorn costs m/n of the square one.
        int(os.environ.get("DIFFFACTO_EMD_SINKHORN_ROWS", 0)),
    )


_HYBRID_NOTICE_SHOWN = False


def _hybrid_work(rounds: torch.Tensor, bids: torch.Tensor, cap: int, sinkhorn) -> dict:
    """The ``emd.*`` counts of one hybrid call from its per-pair rounds and
    bids and, where the kernel ran, its Sinkhorn work."""
    counts = {"emd.pairs": rounds.numel(), "emd.rounds": int(rounds.sum()),
              "emd.bids": int(bids.sum()), "emd.capped_pairs": int((rounds >= cap).sum())}
    if sinkhorn is not None:
        counts.update((k, v) for k, v in sinkhorn.items() if k != "cycles")
        counts["emd.sinkhorn_cycles"] = int(sinkhorn["cycles"].sum())
    return counts


def emd_cost_eval(xyz1: torch.Tensor, xyz2: torch.Tensor, eps: float = 0.002,
                  iters: int = 10000) -> torch.Tensor:
    """Eval-grade EMD cost with implementation selection -> (B,).

    ``DIFFFACTO_EMD_IMPL``:
      * ``hybrid`` — the Sinkhorn-warm-started auction (``ops/emd_hybrid.py``):
        O(10^2) dense iterations instead of the reference's 10^4. The default
        for CUDA tensors when n % 128 == 0, where it is the CUDA kernel. Asked
        for on CPU tensors, it runs the kernel's plain version.
      * ``auction`` — the auction above with the reference knobs (eps, iters).
        The default for CPU tensors, and what any n that 128 does not divide
        gets whatever the setting.
    The choice is printed once.

    While the recorder records (``utils/trace.py``) the hybrid's work is
    counted: ``emd.pairs``, ``emd.rounds`` and ``emd.bids`` (the auction's
    rounds and bids, summed over the pairs) and ``emd.capped_pairs`` (pairs
    whose auction reached ``auction_iters`` and force-assigned the rows
    left); where the kernel ran, also ``emd.sweep_terms`` and
    ``emd.sweep_soft_terms`` (its shifted sweep's terms, and those its soft
    exp2 took) and ``emd.sinkhorn_cycles`` (the clock cycles of each pair's
    Sinkhorn, summed). The kernel's per-pair counts stay on the device until
    read.
    """
    impl, sinkhorn_iters, auction_iters, skrows = resolved_emd_eval_config(
        xyz1.shape[1], xyz1.device
    )
    if impl == "hybrid":
        global _HYBRID_NOTICE_SHOWN
        if not _HYBRID_NOTICE_SHOWN:
            _HYBRID_NOTICE_SHOWN = True
            print(
                "[difffacto_torch] eval EMD: Sinkhorn+auction hybrid ("
                + ("CUDA kernel" if xyz1.device.type == "cuda" else "plain version on the CPU")
                + "; may read slightly higher than the reference's force-assign-biased "
                "auction). Set DIFFFACTO_EMD_IMPL=auction for exact reference parity."
            )
        from .emd_hybrid import emd_assignment_hybrid

        work = trace.on()
        assignment = emd_assignment_hybrid(
            xyz1, xyz2, eps=eps, sinkhorn_iters=sinkhorn_iters, auction_iters=auction_iters,
            sinkhorn_rows=skrows, return_work=work,
        )
        if work:
            assignment, rounds, bids, sinkhorn = assignment
            trace.defer(lambda: _hybrid_work(rounds, bids, auction_iters, sinkhorn))
        return _matched_sqdist(xyz1.float(), xyz2.float(), assignment).clamp_min(0.0).sqrt().mean(dim=1)
    return emd_cost(xyz1, xyz2, eps, iters)
