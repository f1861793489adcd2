"""Plain reference of the val_gen protocol: FPS, bbox normalisation,
Chamfer, the exact EMD, and MMD / COV / 1-NNA.

Written from the published evaluation (github.com/diffFacto/diffFacto,
``evaluation/evaluation_utils.py``: ``lgan_mmd_cov``, ``knn``,
``compute_all_metrics``) and PointFlow's protocol that it follows. It
imports nothing of the program under test.

* ``fps``: furthest point sampling from point 0, squared distances
  ``(dx*dx + dy*dy) + dz*dz`` in float32, ties to the lowest index.
* ``chamfer``: for pairs (i, j), mean over a of min_b |a - b|^2 plus the same
  the other way, from direct differences in float32, means in float64.
* ``emd_exact``: the optimal bijection's mean L2 distance
  (``scipy.optimize.linear_sum_assignment`` on float64 distances).
* ``metrics``: MMD and COV from the (ref x sample) matrices, 1-NNA from the
  three blocks, as the published ``compute_all_metrics`` orders them.

``precision="bfloat16"`` is the control: the clouds, the distances and the
matrices rounded to bfloat16, the step below the float32 that the protocol
states.
"""

from __future__ import annotations

import numpy as np
import torch


def _round(x, precision: str):
    if precision == "float32":
        return x
    if precision != "bfloat16":
        raise ValueError(f"unknown precision {precision!r}")
    if isinstance(x, np.ndarray):
        return torch.as_tensor(x).to(torch.bfloat16).to(torch.float64).numpy().astype(x.dtype)
    return x.to(torch.bfloat16).to(x.dtype)


def fps(xyz: torch.Tensor, npoint: int, precision: str = "float32") -> torch.Tensor:
    """(B, N, 3) -> (B, npoint) int64 indices."""
    x = _round(xyz.float(), precision)
    B, N, _ = x.shape
    arange = torch.arange(N, device=x.device)
    rows = torch.arange(B, device=x.device)
    dists = torch.full((B, N), float("inf"), device=x.device)
    idx = torch.zeros((B, npoint), dtype=torch.int64, device=x.device)
    last = torch.zeros(B, dtype=torch.int64, device=x.device)
    for i in range(1, npoint):
        c = x[rows, last]
        dx, dy, dz = (x[..., k] - c[:, k:k + 1] for k in range(3))
        d = _round((dx * dx + dy * dy) + dz * dz, precision)
        dists = torch.minimum(dists, d)
        top = dists.max(dim=1, keepdim=True).values
        last = torch.where(dists == top, arange, N).min(dim=1).values
        idx[:, i] = last
    return idx


def bbox_normalize(pc: np.ndarray) -> np.ndarray:
    """Each cloud centred on its bounding box and scaled by half its longest side."""
    hi, lo = pc.max(axis=1, keepdims=True), pc.min(axis=1, keepdims=True)
    return (pc - (lo + hi) / 2) / ((hi - lo).max(axis=-1, keepdims=True) / 2)


def resample(clouds: np.ndarray, npoint: int, device, precision: str = "float32") -> np.ndarray:
    """FPS to ``npoint`` where a cloud has more, then bbox-normalised."""
    clouds = np.asarray(clouds, np.float32)
    if clouds.shape[1] > npoint:
        x = torch.as_tensor(clouds, device=device)
        idx = fps(x, npoint, precision)
        clouds = torch.gather(x, 1, idx[..., None].expand(-1, -1, 3)).cpu().numpy()
    return bbox_normalize(clouds)


def chamfer(a: np.ndarray, b: np.ndarray, ii, jj, device, precision: str = "float32",
            chunk: int = 16) -> np.ndarray:
    """Chamfer of the pairs (a[ii[k]], b[jj[k]]) -> (P,) float64."""
    at = _round(torch.as_tensor(np.asarray(a, np.float32), device=device), precision)
    bt = _round(torch.as_tensor(np.asarray(b, np.float32), device=device), precision)
    ii = torch.as_tensor(np.asarray(ii), device=device)
    jj = torch.as_tensor(np.asarray(jj), device=device)
    out = []
    for s in range(0, len(ii), chunk):
        x, y = at[ii[s:s + chunk]], bt[jj[s:s + chunk]]
        d = torch.zeros(x.shape[0], x.shape[1], y.shape[1], device=device)
        for k in range(3):
            diff = x[:, :, None, k] - y[:, None, :, k]
            d = d + diff * diff
        d = _round(d, precision)
        out.append(d.min(dim=2).values.double().mean(1) + d.min(dim=1).values.double().mean(1))
    return torch.cat(out).cpu().numpy()


def emd_exact(a: np.ndarray, b: np.ndarray, precision: str = "float32") -> float:
    """The optimal matching's mean L2 distance between two (n, 3) clouds."""
    from scipy.optimize import linear_sum_assignment

    a, b = _round(np.asarray(a, np.float64), precision), _round(np.asarray(b, np.float64), precision)
    d = np.sqrt(((a[:, None] - b[None]) ** 2).sum(-1))
    r, c = linear_sum_assignment(_round(d, precision))
    return float(d[r, c].mean())


def lgan_mmd_cov(all_dist: np.ndarray) -> dict:
    """MMD and COV from a (sample x ref) matrix."""
    n_ref = all_dist.shape[1]
    min_val_fromsmp = all_dist.min(axis=1)
    min_val = all_dist.min(axis=0)
    min_idx = all_dist.argmin(axis=0)
    return {"lgan_mmd": float(min_val.mean()),
            "lgan_cov": float(len(np.unique(min_idx)) / n_ref),
            "lgan_mmd_smp": float(min_val_fromsmp.mean())}


def knn_acc(Mxx, Mxy, Myy) -> dict:
    """Leave-one-out 1-NN accuracy of refs (label 1) against samples."""
    n0, n1 = Mxx.shape[0], Myy.shape[0]
    label = np.concatenate([np.ones(n0), np.zeros(n1)])
    M = np.concatenate([np.concatenate([Mxx, Mxy], 1), np.concatenate([Mxy.T, Myy], 1)], 0)
    M = M + np.diag(np.full(n0 + n1, np.inf))
    idx = np.argsort(M, axis=0)[:1]
    pred = (label[idx].sum(axis=0) >= 0.5).astype(np.float64)
    tp = float((pred * label).sum())
    fp = float((pred * (1 - label)).sum())
    fn = float(((1 - pred) * label).sum())
    tn = float(((1 - pred) * (1 - label)).sum())
    return {"acc_t": tp / (tp + fn + 1e-10), "acc_f": tn / (tn + fp + 1e-10),
            "acc": float((pred == label).mean())}


def metrics(rs: dict, rr: dict, ss: dict) -> dict:
    """The 12 numbers of the protocol from the (ref x sample), (ref x ref) and
    (sample x sample) matrices, each a dict {"CD": M, "EMD": M}."""
    out = {}
    for name in ("CD", "EMD"):
        out.update({f"{k}-{name}": v for k, v in lgan_mmd_cov(rs[name].T).items()})
    for name in ("CD", "EMD"):
        acc = knn_acc(rr[name], rs[name], ss[name])
        out.update({f"1-NN-{name}-{k}": v for k, v in acc.items()})
    return out
