"""Meshes of ranks and the collectives of the port's multi-GPU paths.

Port of ``difffacto_tpu/parallel/mesh.py`` with ``torch.distributed``. The
JAX package runs one program over a mesh of devices; the port runs one
process a rank (``torch.distributed.run``), each on its own card over NCCL,
or over gloo where ranks share a card or run on the CPU. A ``Mesh`` lays its
ranks out row-major over the axes ("data",) or ("data", "points"), as the JAX
``make_mesh`` reshapes its devices, and holds a process group over all of
its ranks and one along each axis through this rank.

Parameters replicate (``replicate`` broadcasts them from the mesh's first
rank), the batch shards on "data" (``shard_batch``), and on a "points" axis
the point-axis arrays shard their second dimension too. Tensor, pipeline and
expert axes are absent, as in the JAX package: the model is a few million
parameters. A point shard of the reverse chain needs no collective (each
point token cross-attends to 4 replicated context tokens); a point shard of
the training loss reduces over the points where ``parallel/axes.py`` says.

The port uses four collectives (all-reduce, all-gather, broadcast,
barrier). Gloo runs all four on CUDA tensors where ranks share a card, so
they are called directly under either backend.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# Batch keys whose second dimension is the point axis (shardable over a
# ("data", "points") mesh); every other key is per shape and shards on "data".
POINT_AXIS_BATCH_KEYS = frozenset(
    {"input", "ref", "seg_mask", "ref_seg_mask", "attn_map", "ref_attn_map", "diffusion_noise"}
)


@dataclasses.dataclass
class Mesh:
    """``ranks`` (global ranks, row-major over ``axis_names``), ``shape``
    (axis -> size), this process's global ``rank``, ``group`` over every rank
    of the mesh and ``groups`` (axis -> this rank's group along the axis).
    A rank outside ``ranks`` holds no group (``member`` is False)."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    ranks: Tuple[int, ...]
    rank: int
    group: Any
    groups: Dict[str, Any]

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def member(self) -> bool:
        return self.rank in self.ranks

    def index(self, axis: Optional[str] = None) -> int:
        """This rank's position along ``axis`` (None: in the whole mesh)."""
        linear = self.ranks.index(self.rank)
        if axis is None:
            return linear
        dims = [self.shape[a] for a in self.axis_names]
        return int(np.unravel_index(linear, dims)[self.axis_names.index(axis)])

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)


def make_mesh(ranks: Optional[Sequence[int]] = None, axis_names: Sequence[str] = ("data",),
              mesh_shape: Optional[Tuple[int, ...]] = None) -> Mesh:
    """A mesh over ``ranks`` (default: every rank of the default group).

    Layouts as the JAX ``make_mesh`` takes them: one axis of any name, or
    ("data", "points") with ``mesh_shape`` (default (1, len(ranks))); any
    other pair raises NotImplementedError, a shape whose product is not the
    rank count ValueError. Every rank of the default group must call it with
    the same arguments, members or not: ``torch.distributed.new_group`` is a
    collective of the default group.
    """
    axis_names = tuple(axis_names)
    if len(axis_names) > 1 and axis_names != ("data", "points"):
        raise NotImplementedError(
            "supported meshes: 1-D ('data',) and 2-D ('data', 'points'); DiffFacto has no "
            "tensor, pipeline or expert axes at this scale")
    if ranks is None:
        ranks = range(dist.get_world_size())
    ranks = tuple(int(r) for r in ranks)
    if len(axis_names) == 1:
        mesh_shape = (len(ranks),)
    elif mesh_shape is None:
        mesh_shape = (1, len(ranks))
    mesh_shape = tuple(int(s) for s in mesh_shape)
    if int(np.prod(mesh_shape)) != len(ranks):
        raise ValueError(f"mesh_shape {mesh_shape} != {len(ranks)} ranks")

    rank = dist.get_rank()
    world = tuple(range(dist.get_world_size()))
    group = dist.group.WORLD if ranks == world else dist.new_group(list(ranks))
    grid = np.asarray(ranks).reshape(mesh_shape)
    groups = {}
    for ax, name in enumerate(axis_names):
        for line in np.moveaxis(grid, ax, -1).reshape(-1, mesh_shape[ax]).tolist():
            g = group if tuple(line) == ranks else dist.new_group(line)
            if rank in line:
                groups[name] = g
    member = rank in ranks
    return Mesh(axis_names, dict(zip(axis_names, mesh_shape)), ranks, rank,
                group if member else None, groups)


def shard_batch(mesh: Mesh, batch: Dict) -> Dict:
    """This rank's slice of a global batch dict (numpy arrays or tensors).

    Arrays shard their first dimension over the mesh's first axis; under a
    "points" axis the point-axis keys (``POINT_AXIS_BATCH_KEYS``) also cut
    their second dimension. A ragged batch (its size not a multiple of the
    data axis) stays whole on every rank, as the JAX package replicates it:
    the step's mean over the ranks then averages the same batch's
    gradients, so no gradient is counted twice. Entries without a shape
    (lists of names) stay whole.
    """
    data = mesh.axis_names[0]
    nd, npts = mesh.shape[data], mesh.axis_size("points")
    d = mesh.index(data)
    p = mesh.index("points") if npts > 1 else 0
    out = {}
    for k, x in batch.items():
        if not hasattr(x, "shape") or len(x.shape) < 1 or x.shape[0] % nd:
            out[k] = x
            continue
        b = x.shape[0] // nd
        x = x[d * b:(d + 1) * b]
        if npts > 1 and k in POINT_AXIS_BATCH_KEYS and len(x.shape) >= 2 \
                and x.shape[1] % npts == 0:
            n = x.shape[1] // npts
            x = x[:, p * n:(p + 1) * n]
        out[k] = x
    return out


# ---------------------------------------------------------------- collectives
def all_reduce_(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of a contiguous tensor over ``group``."""
    dist.all_reduce(x, op=op, group=group)
    return x


def all_gather_stack(x: torch.Tensor, group) -> torch.Tensor:
    """(group size, *x.shape): every rank's ``x`` in group-rank order."""
    x = x.contiguous()
    out = torch.empty((dist.get_world_size(group),) + tuple(x.shape), dtype=x.dtype,
                      device=x.device)
    dist.all_gather(list(out.unbind(0)), x, group=group)
    return out


def all_gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along ``dim`` in
    group-rank order."""
    g = all_gather_stack(x, group)
    return torch.cat(g.unbind(0), dim=dim)


def _flat(tensors: Sequence[torch.Tensor], fn) -> None:
    """``fn`` on one flat buffer per dtype, written back into ``tensors``."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            fn(flat)
            for t, v in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(v.view_as(t))


def all_reduce_mean_(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Replace each tensor by its mean over the mesh's ranks: one all-reduce
    of one flat buffer per dtype."""
    _flat(tensors, lambda flat: all_reduce_(flat, mesh.group).div_(mesh.size))


def replicate(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Give every rank of the mesh its first rank's parameters and buffers."""
    _flat(list(module.parameters()) + list(module.buffers()),
          lambda flat: dist.broadcast(flat, src=mesh.ranks[0], group=mesh.group))
    return module


def barrier(mesh: Mesh) -> None:
    dist.barrier(group=mesh.group)


def pmean_metrics(metrics: Dict[str, torch.Tensor], mesh: Optional[Mesh] = None):
    """The mean over the mesh's ranks of each logged scalar (0-dim tensors)."""
    if mesh is None:
        return metrics
    vals = torch.stack([torch.as_tensor(v).float().reshape(()) for v in metrics.values()])
    all_reduce_mean_([vals], mesh)
    return dict(zip(metrics, vals.unbind(0)))


# ------------------------------------------------------------------- launch
def rank_device(cpu: bool = False) -> torch.device:
    """The device of this ``torch.distributed.run`` rank: the CPU with
    ``cpu``, else ``cuda:LOCAL_RANK``, the node's ranks sharing its cards
    where it runs more ranks than it has (``LOCAL_RANK`` modulo the count).
    Raises where no card is visible: a rank never carries on on the CPU
    unasked."""
    if cpu:
        return torch.device("cpu")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError("this rank sees no CUDA card; pass --cpu to run the ranks on the CPU")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)) % count)


def default_backend(device) -> str:
    """NCCL where each rank of the node has a card of its own, else gloo (the
    CPU, or ranks sharing a card: NCCL refuses two ranks on one device)."""
    device = torch.device(device)
    if device.type != "cuda":
        return "gloo"
    ranks_here = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    return "nccl" if ranks_here <= torch.cuda.device_count() else "gloo"


def initialize_distributed(device, strict: bool = False) -> bool:
    """Join the ranks that ``torch.distributed.run`` started (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` from the environment)
    over ``default_backend(device)``, ``device`` being this rank's.

    Returns True once
    the process group exists. Without that environment, or where joining
    fails, it raises with ``strict`` (an explicit ``--launcher pytorch``: a
    rank that trained alone against a shared work_dir would corrupt the
    run), and otherwise prints why and returns False.
    """
    if dist.is_initialized():
        return True
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    try:
        if missing:
            raise RuntimeError(f"no torch.distributed.run environment ({', '.join(missing)} "
                               "unset)")
        dist.init_process_group(default_backend(device), init_method="env://")
        return True
    except (ValueError, RuntimeError) as e:
        if strict:
            raise RuntimeError(
                f"--launcher pytorch requested but the process group did not start: {e}") from e
        print(f"[difffacto_torch] distributed init skipped: {e}", flush=True)
        return False
