"""The METRICS registry: distance and loss objects built from configs.

Port of ``difffacto_tpu/metrics/common.py`` (the reference's
``metrics/common.py``, ``chamfer_dist`` and ``emd_module``). The distances go
through the port's ops (``ops/chamfer.chamfer_split``, ``ops/emd.emd``), and
the GAN losses of ``models/gan.py`` are registered under their type strings.
``ignore_zeros`` drops the all-zero rows of a batch of one on the host, as
the JAX package does: the kept length depends on the data.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..models import gan as _gan
from ..ops.chamfer import chamfer_split
from ..ops.emd import emd as emd_fn
from ..utils.registry import METRICS


def _drop_zero_rows(xyz: torch.Tensor) -> torch.Tensor:
    """The points of a batch of one whose coordinates are not all zero
    (``common.py:23-31``): padding rows."""
    keep = np.abs(xyz[0].detach().cpu().numpy()).sum(-1) != 0
    return xyz[:, torch.as_tensor(np.nonzero(keep)[0], device=xyz.device)]


class _Chamfer:
    def __init__(self, ignore_zeros=False, reduce=True):
        self.ignore_zeros = ignore_zeros
        self.reduce = reduce

    def _split(self, xyz1, xyz2):
        if self.ignore_zeros and xyz1.shape[0] == 1:
            xyz1, xyz2 = _drop_zero_rows(xyz1), _drop_zero_rows(xyz2)
        return chamfer_split(xyz1, xyz2)


@METRICS.register_module()
class ChamferDistanceL2(_Chamfer):
    """The mean squared nearest-neighbour distance both ways, summed
    (``common.py:34-48``)."""

    def __call__(self, xyz1, xyz2):
        d1, d2 = self._split(xyz1, xyz2)
        return d1.mean() + d2.mean() if self.reduce else d1 + d2


@METRICS.register_module()
class ChamferDistanceL2_split(_Chamfer):
    """Both directions apart (``common.py:51-65``)."""

    def __call__(self, xyz1, xyz2):
        d1, d2 = self._split(xyz1, xyz2)
        return (d1.mean(), d2.mean()) if self.reduce else (d1, d2)


@METRICS.register_module()
class ChamferDistanceL1(_Chamfer):
    """The mean nearest-neighbour distance (square roots), averaged over the
    two directions (``common.py:68-85``)."""

    def __call__(self, xyz1, xyz2):
        d1, d2 = self._split(xyz1, xyz2)
        d1, d2 = torch.sqrt(d1.clamp_min(0.0)), torch.sqrt(d2.clamp_min(0.0))
        return (d1.mean() + d2.mean()) / 2 if self.reduce else (d1 + d2) / 2


@METRICS.register_module()
class EMD:
    """The auction EMD (``common.py:88-100``): (dist, assignment), or with
    ``dist_only`` the mean matched distance of each cloud."""

    def __init__(self, eps, iters, dist_only=False):
        self.eps = eps
        self.iters = iters
        self.dist_only = dist_only

    def __call__(self, input1, input2):
        dist, assignment = emd_fn(input1, input2, self.eps, self.iters)
        if self.dist_only:
            return torch.sqrt(dist.clamp_min(0.0)).mean(1)
        return dist, assignment


@METRICS.register_module()
class SmoothCrossEntropy:
    """Label-smoothed cross entropy over the class axis 1 (``common.py:103-117``)."""

    def __init__(self, alpha=0.1):
        self.alpha = alpha

    def __call__(self, pred, target):
        n_class = pred.shape[1]
        one_hot = F.one_hot(target.reshape(-1).long(), n_class).to(pred.dtype)
        one_hot = (one_hot * (1.0 - self.alpha + self.alpha / n_class)
                   + (1.0 - one_hot) * self.alpha / n_class)
        return -(one_hot * F.log_softmax(pred, dim=1)).sum(1).mean()


@METRICS.register_module()
class NegativeGaussianLogLikelihood:
    """(``common.py:120-141``). The reference's quirk is kept: with a tensor
    ``var`` and reduction "mean" the per-sample variance term is not averaged."""

    def __init__(self, dim=3, reduction="mean"):
        self.dim = dim
        self.log_z = 0.5 * dim * math.log(2 * math.pi)
        self.reduction = reduction

    def __call__(self, z, mu, var=None):
        if var is None or isinstance(var, float):
            var_term, var = 0.0, 1.0
        else:
            var_term = 0.5 * torch.log(var).sum(-1)
        quad = (z - mu) ** 2 / var
        if self.reduction == "mean":
            return self.log_z + var_term + quad.mean() / 2
        return self.log_z + var_term + quad / 2


@METRICS.register_module()
class CrossEntropy:
    """Cross entropy of two-class distributions where both the prediction and
    the target pass through a sigmoid (``common.py:144-159``, a reference
    quirk)."""

    def __init__(self, n_class=2, reduce=True):
        self.n_class = n_class
        self.reduce = reduce

    def __call__(self, pred, target):
        p, t = torch.sigmoid(pred), torch.sigmoid(target)
        pred_dist = torch.stack([p, 1 - p], dim=1)
        target_dist = torch.stack([t, 1 - t], dim=1)
        loss = -(target_dist * torch.log(pred_dist.clamp_min(1e-30))).sum(1)
        return loss.mean() if self.reduce else loss


@METRICS.register_module()
class L2Loss:
    """``var`` is taken and ignored, as in the reference (``common.py:162-172``)."""

    def __init__(self, reduction="mean"):
        self.reduction = reduction

    def __call__(self, source, target, var=None):
        diff = (source - target) ** 2
        return diff.mean() if self.reduction == "mean" else diff.mean(-1)


@METRICS.register_module()
class L1Loss:
    def __init__(self, reduction="mean"):
        self.reduction = reduction

    def __call__(self, source, target):
        return (source - target).abs().mean()


@METRICS.register_module()
class SpectralContrastiveLoss:
    """-2 a.p + (a.n)^2 over L2-normalised (anchor, positive, negative)
    triplets, inp (B, 3, D) (``common.py:184-197``)."""

    def __call__(self, inp):
        norm = lambda t: t / torch.linalg.norm(t, dim=1, keepdim=True).clamp_min(1e-12)
        anchor, pos, neg = norm(inp[:, 0]), norm(inp[:, 1]), norm(inp[:, 2])
        return (-2.0 * (anchor * pos).sum(1) + (anchor * neg).sum(1) ** 2).mean()


METRICS.register_module(name="dis_loss", module=_gan.dis_loss)
METRICS.register_module(name="gen_loss", module=_gan.gen_loss)
METRICS.register_module(name="gradient_penalty", module=_gan.gradient_penalty)
