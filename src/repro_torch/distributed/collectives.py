"""The collectives of the port's programs over a rank mesh: the
expert-parallel MoE block's and the sharded dense model's.

Each function issues one ``torch.distributed`` collective over this rank's
process group for a set of mesh axes (``launch/mesh.py``), with the
semantics of a ``jax.lax`` collective (the one the reference's
``shard_map`` body issues, or one XLA's partitioner places), and counts
it in every active ``launch.hlo_analysis.counting_collectives`` under
XLA's name for its kind, its group's size and its result's bytes.  Axes
of size 1 issue nothing and count nothing (XLA removes such collectives
too).

The route depends on the group's backend alone.  NCCL takes the tensors
where they are.  Gloo on a CUDA tensor stages the payload through host
memory: a copy to the host, the collective there, a copy back
(``stats["host_staged"]``); gloo on a host tensor runs in place
(``stats["direct"]``).  Gloo takes the list forms of ``all_gather`` and
``reduce_scatter``, and ``all_to_all_single``, which both backends take.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.distributed as dist

from ..launch.hlo_analysis import record_collective
from ..obs import default_registry

stats = default_registry().group("collectives", ("direct", "host_staged"))

Axes = Union[str, Tuple[str, ...]]


def _group(mesh, axes: Axes):
    """(process group, size) over the axes of ``axes`` larger than 1, or
    (None, 1) when there is none."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    axes = tuple(a for a in axes if mesh.shape.get(a, 1) > 1)
    if not axes:
        return None, 1
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    return mesh.group(axes), size


def _staged(x: torch.Tensor, group) -> bool:
    staged = x.device.type == "cuda" and dist.get_backend(group) == "gloo"
    stats["host_staged" if staged else "direct"] += 1
    return staged


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def all_gather(x: torch.Tensor, mesh, axes: Axes, dim: int, path: str = "") -> torch.Tensor:
    """``lax.all_gather(x, axes, axis=dim, tiled=True)``: the group's
    blocks concatenated along ``dim`` in the order of their coordinates."""
    group, size = _group(mesh, axes)
    if group is None:
        return x
    src = x.cpu() if _staged(x, group) else x
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src.contiguous(), group=group)
    out = torch.cat(parts, dim).to(x.device)
    record_collective("all-gather", _nbytes(out), size, path)
    return out


def psum(x: torch.Tensor, mesh, axes: Axes, path: str = "") -> torch.Tensor:
    """``lax.psum(x, axes)``: the sum over the group, on every rank."""
    group, size = _group(mesh, axes)
    if group is None:
        return x
    out = x.cpu().clone() if _staged(x, group) else x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    record_collective("all-reduce", _nbytes(out), size, path)
    return out.to(x.device)


def all_to_all(x: torch.Tensor, mesh, axis: str, path: str = "") -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_axis=0, concat_axis=0, tiled=False)``
    of ``x [n, ...]`` over the ``n`` ranks of ``axis``: block ``j`` of the
    result is block ``i`` of rank ``j``'s ``x``, where ``i`` is this rank's
    coordinate."""
    group, size = _group(mesh, axis)
    if group is None:
        return x
    if x.shape[0] != size:
        raise ValueError(f"all_to_all of {tuple(x.shape)} over {size} ranks")
    src = (x.cpu() if _staged(x, group) else x).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    record_collective("all-to-all", _nbytes(out), size, path)
    return out.to(x.device)


def reduce_scatter(x: torch.Tensor, mesh, axes: Axes, dim: int, path: str = "") -> torch.Tensor:
    """``lax.psum_scatter(x, axes, scatter_dimension=dim, tiled=True)``:
    the sum over the group, cut into as many blocks along ``dim`` as the
    group has ranks; each rank keeps the block at its coordinate."""
    group, size = _group(mesh, axes)
    if group is None:
        return x
    if x.shape[dim] % size:
        raise ValueError(f"reduce_scatter of {tuple(x.shape)} along {dim} over {size} ranks")
    src = x.cpu() if _staged(x, group) else x
    parts = [p.contiguous() for p in src.chunk(size, dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, op=dist.ReduceOp.SUM, group=group)
    record_collective("reduce-scatter", _nbytes(out), size, path)
    return out.to(x.device)
