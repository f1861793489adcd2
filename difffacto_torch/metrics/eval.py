"""Generation-quality metric suite: MMD / COV / 1-NNA over CD and EMD, JSD,
bbox / part / snapping metrics, and the dataset-eval dispatcher.

The counterpart of ``difffacto_tpu/metrics/eval.py``: numpy in and numpy out
at this boundary, torch tensors on ``device`` inside. ``device`` defaults to
the card and raises where there is none; pass ``device="cpu"`` for the CPU.

Every pairwise sweep is a list of (i, j) pairs: the (ref x sample) rectangle,
the strict upper triangle of an X-vs-X sweep, or the diagonal of a paired
eval. One routine computes CD (torch ops) and EMD (``ops/emd.py:
emd_cost_eval``: the CUDA Sinkhorn+auction kernel on the card when 128
divides n, the auction at eps=0.002, iters=10000 otherwise) for such a list.
``batch_size`` pads the list, as in the JAX package, and is the chunk CD is
computed in. A pair's value does not depend on how pairs are grouped, so on
the card ``EMD_CHUNKS_PER_LAUNCH`` chunks go into one EMD kernel launch: one
thread block works on one pair, and a launch of ``batch_size`` pairs would
leave most of the card idle.

With ``mesh`` (a ``parallel.mesh.Mesh``; or the process default,
``set_default_eval_mesh``) the padded pair list's chunks of ``batch_size``
pairs are dealt out to the mesh's ranks in contiguous blocks, each rank
computes its block as one rank computes it, and the values are gathered on
every rank: the sweep's result is the one-rank sweep's bit for bit, as in
the JAX package. Every rank of the mesh calls the sweep with the same inputs.

Not carried over: the jit caches and the ``DIFFFACTO_PAIRWISE_ROWS``,
``_REF_BLOCK`` and ``_SELF_CHUNKS`` knobs, which exist in the JAX package to
bound XLA tracing and the length of one TPU dispatch. PyTorch runs eagerly
and needs neither.
"""

from __future__ import annotations

import hashlib
import os as _os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops.chamfer import chamfer_split
from ..ops.emd import emd_cost_eval, resolved_emd_eval_config
from ..ops.points import fps, gather_points_nd
from ..parallel.mesh import all_gather_cat
from ..utils import trace
from ..utils.device import resolve_device
from .iou import aabb_iou

# Chunks of ``batch_size`` pairs in one launch of the EMD kernel: 66 x 32 pairs
# are 16 thread blocks for each of an H100's 132 SMs.
EMD_CHUNKS_PER_LAUNCH = 66


def EMD_EPS() -> float:
    return float(_os.environ.get("DIFFFACTO_EMD_EPS", 0.002))


def EMD_ITERS() -> int:
    """Reference eval accuracy: 10000 iters. Tunable so CPU test runs can
    trade accuracy for speed. Read per call."""
    return int(_os.environ.get("DIFFFACTO_EMD_ITERS", 10000))


def _to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _emd_config(dev):
    return (resolved_emd_eval_config(None, dev), EMD_EPS(), EMD_ITERS())


# ------------------------------------------------------------- mesh support
_DEFAULT_EVAL_MESH = None


def set_default_eval_mesh(mesh) -> None:
    """Process-default mesh for the metric sweeps: the ``Runner`` sets it so
    the dataset ``evaluate`` hooks, which call the sweeps without it, shard
    too; an explicit ``mesh=`` overrides it."""
    global _DEFAULT_EVAL_MESH
    _DEFAULT_EVAL_MESH = mesh


def _eval_mesh(mesh):
    """The explicit mesh or the process default; None where it has one rank."""
    m = mesh if mesh is not None else _DEFAULT_EVAL_MESH
    return m if m is not None and m.size > 1 else None


# --------------------------------------------------------------- pairwise
def emd_pairs_per_launch(n: int, batch_size: int, dev) -> int:
    """Pairs that ``_pairs_cd_emd`` hands to one ``emd_cost_eval`` call."""
    hybrid_kernel = dev.type == "cuda" and resolved_emd_eval_config(n, dev)[0] == "hybrid"
    return batch_size * (EMD_CHUNKS_PER_LAUNCH if hybrid_kernel else 1)


def _pairs_cd_emd(a, b, mask_a, mask_b, ii, jj, batch_size, compute_emd, dev, verbose="",
                  mesh=None):
    """CD and EMD of the pairs (a[ii[k]], b[jj[k]]) -> two (P,) f32 arrays.

    a (S, N, 3), b (R, N, 3) and the masks (S, N), (R, N) are numpy arrays or
    None; masks weight the CD means only. The list is padded to a multiple of
    ``batch_size`` by repeating it from the start, and cropped again. With
    ``mesh`` (more than one rank) this rank takes its block of the padded
    list's chunks (the chunk count padded, the same way, to a multiple of
    the ranks) and the blocks are gathered.
    """
    P = len(ii)
    N = a.shape[1]
    a_t = torch.as_tensor(np.asarray(a, np.float32), device=dev)
    b_t = a_t if b is a else torch.as_tensor(np.asarray(b, np.float32), device=dev)

    def mask_t(m, pts):
        if m is None:
            return torch.ones(pts.shape[:2], dtype=torch.float32, device=dev)
        return torch.as_tensor(np.asarray(m, np.float32), device=dev)

    ma_t, mb_t = mask_t(mask_a, a_t), mask_t(mask_b, b_t)
    order = np.arange(P + (-P) % batch_size) % P
    if mesh is not None:
        per_rank = -(-len(order) // (batch_size * mesh.size)) * batch_size
        r = mesh.index()
        order = order[np.arange(r * per_rank, (r + 1) * per_rank) % len(order)]
    ii_t = torch.as_tensor(np.asarray(ii)[order], dtype=torch.int64, device=dev)
    jj_t = torch.as_tensor(np.asarray(jj)[order], dtype=torch.int64, device=dev)

    group = emd_pairs_per_launch(N, batch_size, dev)
    cds, emds = [], []
    for s in range(0, len(order), group):
        ic, jc = ii_t[s:s + group], jj_t[s:s + group]
        xa, xb = a_t[ic], b_t[jc]
        for c in range(0, len(ic), batch_size):
            dl, dr = chamfer_split(xa[c:c + batch_size], xb[c:c + batch_size])
            wa, wb = ma_t[ic[c:c + batch_size]], mb_t[jc[c:c + batch_size]]
            cds.append((dl * wa).sum(1) / wa.sum(1) + (dr * wb).sum(1) / wb.sum(1))
        if compute_emd:
            emds.append(emd_cost_eval(xa, xb, EMD_EPS(), EMD_ITERS()))
        if verbose:
            print(f"{verbose} {min(s + group, P)}/{P}")
    cd = torch.cat(cds)
    emd = torch.cat(emds) if compute_emd else torch.zeros_like(cd)
    if mesh is not None:
        cd, emd = all_gather_cat(cd, mesh.group), all_gather_cat(emd, mesh.group)
    return _to_np(cd)[:P], _to_np(emd)[:P]


def pairwise_cd_emd(
    sample: np.ndarray,
    ref: np.ndarray,
    batch_size: int = 32,
    compute_emd: bool = True,
    mask_sample: Optional[np.ndarray] = None,
    mask_ref: Optional[np.ndarray] = None,
    verbose: bool = False,
    device="cuda",
    mesh=None,
):
    """All-pairs CD and EMD matrices: (S, N, 3) x (R, N, 3) -> (S, R) each.

    Row i holds d(sample_i, ref_j). Masks weight the CD means only, like the
    reference (EMD there is computed on the full clouds even when masked).
    The refs are padded to a multiple of ``batch_size`` by modular indexing
    (the pad may exceed R when R < batch_size) and the result is cropped.
    """
    dev = resolve_device(device)
    sample, ref = np.asarray(sample), np.asarray(ref)
    S, R = sample.shape[0], ref.shape[0]
    Rp = R + (-R) % batch_size
    ii = np.repeat(np.arange(S), Rp)
    jj = np.tile(np.arange(Rp) % R, S)
    cd, emd = _pairs_cd_emd(
        sample, ref, mask_sample, mask_ref, ii, jj, batch_size, compute_emd, dev,
        verbose="pairwise" if verbose else "", mesh=_eval_mesh(mesh),
    )
    return cd.reshape(S, Rp)[:, :R], emd.reshape(S, Rp)[:, :R]


# --------------------------------------------------- symmetric self-pairwise
def pairwise_self_cd_emd(
    pts: np.ndarray,
    batch_size: int = 32,
    compute_emd: bool = True,
    mask: Optional[np.ndarray] = None,
    verbose: bool = False,
    device="cuda",
    mesh=None,
):
    """X-vs-X pairwise CD and EMD: (S, N, 3) -> symmetric (S, S) matrices.

    CD and EMD are symmetric, so only the strict upper triangle is computed
    and mirrored; the reference sweeps all S^2 ordered pairs, paying twice
    for values that differ only by the auction's approximation noise (the
    diagonal is ~0 and unused: every consumer masks it).
    ``DIFFFACTO_EVAL_SYMMETRIC=0`` restores the full sweep (see
    compute_all_metrics).
    """
    dev = resolve_device(device)
    pts = np.asarray(pts)
    S = pts.shape[0]
    cd_m = np.zeros((S, S), np.float64)
    emd_m = np.zeros((S, S), np.float64)
    if S < 2:
        return cd_m, emd_m
    iu, ju = np.triu_indices(S, k=1)
    cd_v, emd_v = _pairs_cd_emd(
        pts, pts, mask, mask, iu, ju, batch_size, compute_emd, dev,
        verbose="pairwise-self" if verbose else "", mesh=_eval_mesh(mesh),
    )
    cd_m[iu, ju] = cd_v
    cd_m[ju, iu] = cd_v
    emd_m[iu, ju] = emd_v
    emd_m[ju, iu] = emd_v
    return cd_m, emd_m


# ------------------------------------------------------------------ 1-NNA
def knn(Mxx, Mxy, Myy, k: int = 1, sqrt: bool = False, one_way: bool = False) -> Dict[str, float]:
    """Leave-one-out k-NN two-sample classification accuracy
    (evaluation_utils.py:205-242)."""
    Mxx, Mxy, Myy = map(np.asarray, (Mxx, Mxy, Myy))
    n0, n1 = Mxx.shape[0], Myy.shape[0]
    label = np.concatenate([np.ones(n0), np.zeros(n1)])
    M = np.concatenate(
        [
            np.concatenate([Mxx, Mxy], axis=1),
            np.concatenate([Mxy.T, Myy], axis=1),
        ],
        axis=0,
    )
    if sqrt:
        M = np.sqrt(np.abs(M))
    M = M + np.diag(np.full(n0 + n1, np.inf))
    idx = np.argsort(M, axis=0)[:k]  # smallest k per column
    count = label[idx].sum(axis=0)
    pred = (count >= (k / 2.0)).astype(np.float64)
    if one_way:
        pred = pred[:n0]
        label = pred[:n0]
    tp = float((pred * label).sum())
    fp = float((pred * (1 - label)).sum())
    fn = float(((1 - pred) * label).sum())
    tn = float(((1 - pred) * (1 - label)).sum())
    return {
        "tp": tp,
        "fp": fp,
        "fn": fn,
        "tn": tn,
        "precision": tp / (tp + fp + 1e-10),
        "recall": tp / (tp + fn + 1e-10),
        "acc_t": tp / (tp + fn + 1e-10),
        "acc_f": tn / (tn + fp + 1e-10),
        "acc": float((pred == label).mean()),
    }


def lgan_mmd_cov(all_dist: np.ndarray, thresh: float = 1000.0) -> Dict[str, float]:
    """MMD / COV from a (S, R) distance matrix (evaluation_utils.py:245-268)."""
    all_dist = np.asarray(all_dist)
    N_ref = all_dist.shape[1]
    min_val_fromsmp = all_dist.min(axis=1)
    min_val = all_dist.min(axis=0)
    min_idx = all_dist.argmin(axis=0)
    order = np.argsort(min_val)
    sorted_idx = min_idx[order]
    outlier = min_val[order] > thresh
    if outlier.any():
        sorted_idx = sorted_idx.copy()
        sorted_idx[outlier] = sorted_idx[0]
    return {
        "lgan_mmd": float(min_val.mean()),
        "lgan_cov": float(len(np.unique(sorted_idx)) / N_ref),
        "lgan_mmd_smp": float(min_val_fromsmp.mean()),
    }


def compute_all_metrics(
    sample_pcs,
    ref_pcs,
    batch_size: int = 32,
    one_way: bool = False,
    mask=None,
    compute_emd: bool = True,
    ref_self_cache: Optional[dict] = None,
    device="cuda",
    mesh=None,
) -> Dict[str, float]:
    """MMD/COV/1-NNA over CD and EMD (evaluation_utils.py:500-541).

    Matches the reference's orientation: pairwise matrices are built as
    (ref x sample) and transposed for MMD/COV.

    ``ref_self_cache``: caller-owned dict memoizing the ref-vs-ref pairwise
    block across calls. That block depends only on the (fixed) reference set
    but is a large share of a repeated eval: a 400-shape val set is ~80k EMD
    pairs recomputed identically per checkpoint in a convergence curve. The
    key fingerprints the ref bytes and every knob that changes the values
    (batch size, EMD impl/eps/iters, sweep mode, device kind), so a stale hit
    is impossible.

    Each sweep is recorded as a span ``sweep`` (``utils/trace.py``) whose
    ``block`` is ``rs`` (ref x sample), ``ss`` or ``rr`` (only where the
    cache misses); each ends with its matrices on the host.
    """
    dev = resolve_device(device)
    sample_pcs, ref_pcs = _to_np(sample_pcs), _to_np(ref_pcs)
    results: Dict[str, float] = {}
    with trace.span("sweep", block="rs"):
        M_rs_cd, M_rs_emd = pairwise_cd_emd(
            ref_pcs, sample_pcs, batch_size, compute_emd=compute_emd, mask_ref=mask, device=dev,
            mesh=mesh,
        )
    for name, M in (("CD", M_rs_cd), ("EMD", M_rs_emd)):
        if not compute_emd and name == "EMD":
            continue
        res = lgan_mmd_cov(M.T)
        results.update({f"{k}-{name}": v for k, v in res.items()})

    # The X-vs-X matrices feed only the 1-NNA (diagonal masked); CD/EMD are
    # symmetric, so by default only the upper triangle is computed
    # (pairwise_self_cd_emd). DIFFFACTO_EVAL_SYMMETRIC=0 restores the
    # reference's full ordered sweep: the two differ only by the auction's
    # approximation noise on mirrored pairs.
    symmetric = _os.environ.get("DIFFFACTO_EVAL_SYMMETRIC", "1") != "0"
    cache_key = None
    if ref_self_cache is not None:
        cache_key = (
            hashlib.blake2b(np.ascontiguousarray(ref_pcs).tobytes(), digest_size=16).hexdigest(),
            ref_pcs.shape,
            batch_size,
            compute_emd,
            symmetric,
            _emd_config(dev) if compute_emd else None,
        )

    def self_sweep(pts, m, block):
        with trace.span("sweep", block=block):
            if symmetric:
                return pairwise_self_cd_emd(pts, batch_size, compute_emd=compute_emd, mask=m,
                                            device=dev, mesh=mesh)
            return pairwise_cd_emd(pts, pts, batch_size, compute_emd=compute_emd,
                                   mask_sample=m, mask_ref=m, device=dev, mesh=mesh)

    if cache_key is not None and cache_key in ref_self_cache:
        M_rr_cd, M_rr_emd = ref_self_cache[cache_key]
    else:
        M_rr_cd, M_rr_emd = self_sweep(ref_pcs, None, "rr")
        if cache_key is not None:
            ref_self_cache[cache_key] = (M_rr_cd, M_rr_emd)
    if one_way:
        S = M_rs_cd.shape[1]
        M_ss_cd = np.full((S, S), np.inf)
        M_ss_emd = np.full((S, S), np.inf)
    else:
        M_ss_cd, M_ss_emd = self_sweep(sample_pcs, mask, "ss")
    one_nn_cd = knn(M_rr_cd, M_rs_cd, M_ss_cd, 1, sqrt=False, one_way=one_way)
    results.update({f"1-NN-CD-{k}": v for k, v in one_nn_cd.items() if "acc" in k})
    if compute_emd:
        one_nn_emd = knn(M_rr_emd, M_rs_emd, M_ss_emd, 1, sqrt=False, one_way=one_way)
        results.update({f"1-NN-EMD-{k}": v for k, v in one_nn_emd.items() if "acc" in k})
    return results


def emd_cd_paired(sample_pcs, ref_pcs, batch_size: int = 32, reduced: bool = True, device="cuda",
                  mesh=None):
    """Paired reconstruction MMD-CD / MMD-EMD (evaluation_utils.py:106-140):
    pair k is (sample_k, ref_k)."""
    dev = resolve_device(device)
    sample_pcs, ref_pcs = _to_np(sample_pcs), _to_np(ref_pcs)
    k = np.arange(sample_pcs.shape[0])
    cd, emd = _pairs_cd_emd(sample_pcs, ref_pcs, None, None, k, k, batch_size, True, dev,
                            mesh=_eval_mesh(mesh))
    if reduced:
        return {"MMD-CD": float(cd.mean()), "MMD-EMD": float(emd.mean())}
    return {"MMD-CD": cd, "MMD-EMD": emd}


# -------------------------------------------------------------------- JSD
def _unit_cube_grid(resolution: int, clip_sphere: bool = False):
    spacing = 1.0 / (resolution - 1)
    ax = np.arange(resolution) * spacing - 0.5
    grid = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), axis=-1).reshape(-1, 3)
    if clip_sphere:
        grid = grid[np.linalg.norm(grid, axis=1) <= 0.5]
    return grid.astype(np.float32), spacing


def _occupancy_counts(pclouds: np.ndarray, resolution: int) -> np.ndarray:
    """Per-cell point counts over the SPHERE-CLIPPED grid, every point counted
    (evaluation_utils.py:604-616 ``grid_counters`` with ``in_sphere=True``:
    the JSD distribution is raw point counts — NOT unique-per-cloud bernoulli
    activations, those feed only the unused entropy return — and points
    outside the unit sphere bin to the nearest in-sphere cell center)."""
    from scipy.spatial import cKDTree

    grid, _ = _unit_cube_grid(resolution, clip_sphere=True)
    tree = cKDTree(grid)
    occ = np.zeros(len(grid))
    for pc in pclouds:
        idx = tree.query(np.asarray(pc))[1]
        np.add.at(occ, idx, 1)
    return occ


def jsd_between_point_cloud_sets(sample_pcs, ref_pcs, resolution: int = 28) -> float:
    """Occupancy-grid Jensen-Shannon divergence (evaluation_utils.py:568-583)."""

    def grid_var(pcs):
        counts = _occupancy_counts(np.asarray(pcs), resolution)
        return counts

    P = grid_var(sample_pcs)
    Q = grid_var(ref_pcs)
    P_ = P / max(P.sum(), 1e-12)
    Q_ = Q / max(Q.sum(), 1e-12)
    M = 0.5 * (P_ + Q_)

    def kl(a, b):
        idx = (a > 0) & (b > 0)
        return float(np.sum(a[idx] * np.log2(a[idx] / b[idx])))

    return 0.5 * (kl(P_, M) + kl(Q_, M))


# ------------------------------------------------- part-aware extra metrics
def _bbox_norm_np(pc: np.ndarray) -> np.ndarray:
    mx, mn = pc.max(0), pc.min(0)
    shift = (mx + mn) / 2
    scale = (mx - mn).max() / 2
    return (pc - shift) / scale


def _part_bboxes(pcs, masks, n_class, thresh=1.0):
    """Per-shape dict part -> (min (3,), max (3,)) from quantile bboxes
    (evaluation_utils.py:295-333)."""
    out = []
    for pc, m in zip(pcs, masks):
        pc = _bbox_norm_np(np.asarray(pc))
        d = {}
        for j in range(n_class):
            idx = np.asarray(m) == j
            if idx.any():
                pts = pc[idx]
                if pts.shape[0] > 100:
                    d[j] = (
                        np.quantile(pts, 1 - thresh, axis=0),
                        np.quantile(pts, thresh, axis=0),
                    )
        out.append(d)
    return out


def _part_chamfer_dist(n_class, A, B, rng):
    """Chamfer between boxes via uniform box samples (evaluation_utils.py:23-40)."""
    dists = []
    for i in range(n_class):
        a, b = A.get(i), B.get(i)
        if (a is not None) != (b is not None):
            return float("inf")
        if a is None:
            continue
        pa = rng.rand(512, 3) * (a[1] - a[0]) + a[0]
        pb = rng.rand(512, 3) * (b[1] - b[0]) + b[0]
        d = ((pa[:, None] - pb[None]) ** 2).sum(-1)
        dists.append(d.min(1).mean() + d.min(0).mean())
    return float(np.mean(dists)) if dists else float("inf")


def _part_l2_dist(n_class, A, B):
    dists = []
    for i in range(n_class):
        a, b = A.get(i), B.get(i)
        if (a is not None) != (b is not None):
            return float("inf")
        if a is None:
            continue
        sa, ha = (a[1] - a[0]) / 2, (a[1] + a[0]) / 2
        sb, hb = (b[1] - b[0]) / 2, (b[1] + b[0]) / 2
        dists.append(float(((np.concatenate([sa, ha]) - np.concatenate([sb, hb])) ** 2).mean()))
    return float(np.mean(dists)) if dists else float("inf")


def _part_iou_dist(n_class, A, B):
    ious = []
    for i in range(n_class):
        a, b = A.get(i), B.get(i)
        if (a is not None) != (b is not None):
            return float("inf")
        if a is None:
            continue
        iou3d, _ = aabb_iou(a[0], a[1], b[0], b[1])
        ious.append(iou3d)
    return 1.0 - float(np.mean(ious)) if ious else float("inf")


def compute_bbox_metric(
    preds, preds_mask, refs, refs_mask, batch_size=32, n_class=4, thresh=1.0,
    metric="chamfer", no_nn=False, cov_thresh=100,
) -> Dict[str, float]:
    """MMD/COV/1-NNA over per-part bbox distances (evaluation_utils.py:287-344)."""
    pred_params = _part_bboxes(preds, preds_mask, n_class, thresh)
    ref_params = _part_bboxes(refs, refs_mask, n_class, thresh)
    rng = np.random.RandomState(0)
    if metric == "chamfer":
        dist = lambda A, B: _part_chamfer_dist(n_class, A, B, rng)
    elif metric == "l2":
        dist = lambda A, B: _part_l2_dist(n_class, A, B)
    elif metric == "iou":
        dist = lambda A, B: _part_iou_dist(n_class, A, B)
    else:
        raise NotImplementedError(metric)

    name = f"bbox_{metric}" if metric != "chamfer" else "bbox_chamfer"
    M, S = len(pred_params), len(ref_params)
    rs = np.zeros((S, M))
    for i in range(S):
        for j in range(M):
            rs[i, j] = dist(ref_params[i], pred_params[j])
    results = {}
    res = lgan_mmd_cov(rs.T, thresh=cov_thresh)
    results.update({f"{k}-{name}": v for k, v in res.items()})
    if not no_nn:
        rr = np.zeros((S, S))
        ss = np.zeros((M, M))
        for i in range(S):
            for j in range(S):
                rr[i, j] = dist(ref_params[i], ref_params[j])
        for i in range(M):
            for j in range(M):
                ss[i, j] = dist(pred_params[i], pred_params[j])
        nn = knn(rr, rs, ss, 1)
        results.update({f"1-NN-{name}-{k}": v for k, v in nn.items() if "acc" in k})
    return {f"bbox_{k}": v for k, v in results.items()}


def compute_snapping_metric(preds, preds_mask, cls: str = "Chair") -> Dict[str, float]:
    """Part-connectivity gap: CD over the 50 closest cross-part point pairs
    (evaluation_utils.py:385-419)."""
    if cls == "Chair":
        connected = [(0, [1, 2]), (1, [2]), (3, [0, 1])]
    elif cls == "Airplane":
        connected = [(1, [0]), (2, [0]), (3, [0, 1])]
    else:
        return {}
    dists = {p[0]: [] for p in connected}
    preds, preds_mask = _to_np(preds), _to_np(preds_mask)
    for k in range(preds.shape[0]):
        pred, m = preds[k], preds_mask[k]
        for i, js in connected:
            ia = m == i
            min_d = []
            for j in js:
                ib = m == j
                if ia.any() and ib.any():
                    A, B = pred[ia], pred[ib]
                    d = ((A[:, None] - B[None]) ** 2).sum(-1)
                    na = min(50, d.shape[0])
                    nb = min(50, d.shape[1])
                    idA = np.argsort(d.min(1))[:na]
                    idB = np.argsort(d.min(0))[:nb]
                    mA, mB = A[idA], B[idB]
                    dd = ((mA[:, None] - mB[None]) ** 2).sum(-1)
                    min_d.append(dd.min(1).mean() + dd.min(0).mean())
            if min_d:
                dists[i].append(min(min_d))
    return {
        f"snapping_{cls}_{k}": float(np.mean(v)) if v else float("nan")
        for k, v in dists.items()
    }


def compute_part_metric(
    preds, preds_mask, refs, refs_mask, batch_size=32, n_class=4, device="cuda"
) -> Dict[str, float]:
    """Per-part clouds padded/trimmed to 512 -> per-part compute_all_metrics,
    presence-weighted (evaluation_utils.py:423-498)."""
    preds, preds_mask = _to_np(preds), _to_np(preds_mask)
    refs, refs_mask = _to_np(refs), _to_np(refs_mask)

    def collect(pcs, masks, with_mask):
        clouds = [[] for _ in range(n_class)]
        ms = [[] for _ in range(n_class)]
        for pc, m in zip(pcs, masks):
            for j in range(n_class):
                idx = m == j
                if idx.any():
                    pts = pc[idx]
                    if pts.shape[0] > 100:
                        mask = np.ones(512, np.float32)
                        if pts.shape[0] < 512:
                            mask[pts.shape[0]:] = 0
                        while pts.shape[0] < 512:
                            pts = np.concatenate([pts, pts], axis=0)
                        pts = pts[:512]
                        clouds[j].append(pts)
                        ms[j].append(mask)
        clouds = [np.stack(c) if c else np.zeros((0, 512, 3), np.float32) for c in clouds]
        ms = [np.stack(c) if c else np.zeros((0, 512), np.float32) for c in ms]
        return clouds, ms

    pred_parts, pred_masks = collect(preds, preds_mask, True)
    ref_parts, _ = collect(refs, refs_mask, False)
    weights = np.array([r.shape[0] for r in ref_parts], np.float64)
    weights = weights / weights.sum()

    def bbox_norm_batch(pc):
        mx = pc.max(1, keepdims=True)
        mn = pc.min(1, keepdims=True)
        return (pc - (mx + mn) / 2) / ((mx - mn) / 2)

    metrics = []
    for i in range(n_class):
        if pred_parts[i].shape[0] == 0 or ref_parts[i].shape[0] == 0:
            metrics.append({})
            continue
        m = compute_all_metrics(
            bbox_norm_batch(pred_parts[i]),
            bbox_norm_batch(ref_parts[i]),
            batch_size,
            mask=pred_masks[i],
            device=device,
        )
        metrics.append(m)
    keys = next((m.keys() for m in metrics if m), [])
    out = {f"part_weighted_{k}": 0.0 for k in keys}
    for i, m in enumerate(metrics):
        for k, v in m.items():
            out[f"part_weighted_{k}"] += v * weights[i]
    return out


# --------------------------------------------------------- dataset dispatch
def _resample(pts: np.ndarray, seg: np.ndarray, dev, number: int = 2048):
    """FPS (B, N, 3) down to ``number`` points and keep the seg mask aligned."""
    sub, idx = fps(torch.as_tensor(pts, dtype=torch.float32, device=dev), number, ret_id=True)
    seg_t = torch.as_tensor(seg, device=dev)
    return _to_np(sub), _to_np(gather_points_nd(seg_t[..., None], idx))[..., 0]


def evaluate_batches(
    results: List[Dict[str, np.ndarray]],
    save_num_batch: int,
    eval_mode: str = "ae",
    save_only: bool = False,
    num_class: int = 4,
    class_choice: str = "Chair",
    using_whole_chair_only: bool = False,
    batch_size: int = 32,
    device="cuda",
):
    """The dataset.evaluate(...) hook logic (shapenet_seg.py:300-396).

    ``results`` is a list of per-batch prediction dicts with numpy values.
    Returns (save_dict, metrics).
    """
    dev = resolve_device(device)
    save_dict: Dict[str, list] = {}
    preds, preds_mask, refs, refs_mask = [], [], [], []

    for idx, pred_dict in enumerate(results):
        pred_dict = dict(pred_dict)
        if save_only:
            if idx < save_num_batch:
                for k, v in pred_dict.items():
                    save_dict.setdefault(k, []).append(_to_np(v) if not isinstance(v, list) else v)
            continue
        shift = _to_np(pred_dict.pop("shift"))
        scale = _to_np(pred_dict.pop("scale"))

        pred = _to_np(pred_dict["pred"])
        pred_mask = _to_np(pred_dict["pred_seg_mask"])
        ref = _to_np(pred_dict["input_ref"])
        ref_mask = _to_np(pred_dict["ref_seg_mask"])
        if pred.shape[1] > 2048:
            pred, pred_mask = _resample(pred, pred_mask, dev)
        if ref.shape[1] > 2048:
            ref, ref_mask = _resample(ref, ref_mask, dev)
        if eval_mode == "ae":
            pred = pred * scale + shift
            ref = ref * scale + shift
        else:
            pred = np.stack([_bbox_norm_np(p) for p in pred])
            ref = np.stack([_bbox_norm_np(r) for r in ref])
            if using_whole_chair_only:
                present = _to_np(pred_dict["present"])[:, :3].sum(1) == 3
                pred, ref = pred[present], ref[present]
        preds.append(pred)
        refs.append(ref)
        preds_mask.append(pred_mask)
        refs_mask.append(ref_mask)
        if idx < save_num_batch:
            for k, v in pred_dict.items():
                v = _to_np(v) if not isinstance(v, list) else v
                if not isinstance(v, list) and v.ndim >= 1 and v.shape[-1] == 3:
                    v = v * scale + shift
                save_dict.setdefault(k, []).append(v)

    ssave = {
        k: (np.concatenate(v, axis=0) if isinstance(v[0], np.ndarray) else sum(v, []))
        for k, v in save_dict.items()
    }
    if save_only:
        return ssave, dict(l=0)

    preds = np.concatenate(preds)
    refs = np.concatenate(refs)
    preds_mask = np.concatenate(preds_mask)
    refs_mask = np.concatenate(refs_mask)

    if eval_mode == "ae":
        metrics = emd_cd_paired(preds, refs, batch_size, device=dev)
    elif eval_mode == "gen_part":
        metrics = compute_all_metrics(preds, refs, batch_size, device=dev)
        metrics.update(compute_snapping_metric(preds, preds_mask, cls=class_choice))
        metrics.update(
            {
                f"oracle_{k}": v
                for k, v in compute_snapping_metric(refs, refs_mask, cls=class_choice).items()
            }
        )
        metrics.update(
            compute_part_metric(
                preds, preds_mask, refs, refs_mask, batch_size, num_class, device=dev
            )
        )
        metrics.update(
            compute_bbox_metric(
                preds, preds_mask, refs, refs_mask, batch_size, num_class, metric="chamfer"
            )
        )
    elif eval_mode == "gen":
        metrics = compute_all_metrics(preds, refs, batch_size, device=dev)
    else:
        raise ValueError(eval_mode)
    return ssave, metrics
