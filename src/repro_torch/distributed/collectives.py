"""The collectives of the port's programs over a rank mesh: the
expert-parallel MoE block's and the sharded dense model's, forward and
backward.

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

**Backward.**  Each collective is a ``torch.autograd.Function`` whose
backward is its transpose over the same group, counted like a forward
one under its path with ``/bwd`` added: ``all_gather`` along ``dim`` →
``reduce_scatter`` along ``dim``; ``reduce_scatter`` → ``all_gather``;
``all_to_all`` → ``all_to_all``; ``psum`` → ``psum``.  Collectives that a
checkpointed layer issues again while the backward pass recomputes it
(:func:`recomputing`) count under ``/bwd`` too.

These transposes hold under one convention for the cotangent of a value
that several ranks hold alike (a gathered sequence, a layer's weights
gathered over ``data``, the loss): **each of those ranks holds a share,
and the shares sum to the cotangent.**  No gather then needs to know
whether what follows it runs alike on every rank of the group (``ln_f``
after ``loss/x``, the combine after ``loss/vocab``) or on disjoint parts
(heads, ``d_ff`` columns, vocabulary blocks): duplicated code gives each
rank a share, and the reduce-scatter sums the shares back to the
cotangent once, not once per rank.  A ``psum``'s result is held alike,
so its cotangent arrives as shares and the transpose sums them: ``psum``.
The convention starts at the loss, which every rank of the mesh holds
alike: :func:`seed_shares` passes back 1/N of its cotangent on each of
the N ranks.  It ends at the parameters: a leaf that several ranks hold
alike ends the backward pass with a share on each, which
``actctx.sum_replicated`` sums over the axes it is held alike along.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Tuple, Union

import torch
import torch.distributed as dist

from ..launch.hlo_analysis import record_collective
from ..obs import default_registry

stats = default_registry().group("collectives", ("direct", "host_staged"))

Axes = Union[str, Tuple[str, ...]]

_RECOMPUTING: list = []


@contextmanager
def recomputing():
    """While active, collectives count as the backward pass's (``/bwd``):
    the context a checkpoint recomputes its function under."""
    _RECOMPUTING.append(True)
    try:
        yield
    finally:
        _RECOMPUTING.pop()


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


def _record(kind: str, out: torch.Tensor, size: int, path: str, backward: bool = False):
    if backward or _RECOMPUTING:
        path = f"{path}/bwd"
    record_collective(kind, out.numel() * out.element_size(), size, path)


def _gather(x: torch.Tensor, group, size: int, dim: int) -> torch.Tensor:
    src = x.cpu() if _staged(x, group) else x
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src.contiguous(), group=group)
    return torch.cat(parts, dim).to(x.device)


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    out = x.cpu().clone() if _staged(x, group) else x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out.to(x.device)


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    src = (x.cpu() if _staged(x, group) else x).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(x.device)


def _scatter(x: torch.Tensor, group, size: int, dim: int) -> torch.Tensor:
    src = x.cpu() if _staged(x, group) else x
    parts = [p.contiguous() for p in src.chunk(size, dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, op=dist.ReduceOp.SUM, group=group)
    return out.to(x.device)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, dim, path):
        ctx.args = (group, size, dim, path)
        out = _gather(x, group, size, dim)
        _record("all-gather", out, size, path)
        return out

    @staticmethod
    def backward(ctx, g):
        group, size, dim, path = ctx.args
        out = _scatter(g, group, size, dim)
        _record("reduce-scatter", out, size, path, backward=True)
        return out, None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, dim, path):
        ctx.args = (group, size, dim, path)
        out = _scatter(x, group, size, dim)
        _record("reduce-scatter", out, size, path)
        return out

    @staticmethod
    def backward(ctx, g):
        group, size, dim, path = ctx.args
        out = _gather(g, group, size, dim)
        _record("all-gather", out, size, path, backward=True)
        return out, None, None, None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, path):
        ctx.args = (group, size, path)
        out = _sum(x, group)
        _record("all-reduce", out, size, path)
        return out

    @staticmethod
    def backward(ctx, g):
        group, size, path = ctx.args
        out = _sum(g, group)
        _record("all-reduce", out, size, path, backward=True)
        return out, None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, path):
        ctx.args = (group, size, path)
        out = _exchange(x, group)
        _record("all-to-all", out, size, path)
        return out

    @staticmethod
    def backward(ctx, g):
        group, size, path = ctx.args
        out = _exchange(g, group)
        _record("all-to-all", out, size, path, backward=True)
        return out, None, None, None


class _Shares(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def all_gather(x: torch.Tensor, mesh, axes: Axes, dim: int, path: str = "") -> torch.Tensor:
    """``lax.all_gather(x, axes, axis=dim, tiled=True)``: the group's
    blocks concatenated along ``dim`` in the order of their coordinates."""
    group, size = _group(mesh, axes)
    if group is None:
        return x
    return _AllGather.apply(x, group, size, dim, path)


def psum(x: torch.Tensor, mesh, axes: Axes, path: str = "") -> torch.Tensor:
    """``lax.psum(x, axes)``: the sum over the group, on every rank."""
    group, size = _group(mesh, axes)
    if group is None:
        return x
    return _Psum.apply(x, group, size, path)


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
    return _AllToAll.apply(x, group, size, path)


def reduce_scatter(x: torch.Tensor, mesh, axes: Axes, dim: int, path: str = "") -> torch.Tensor:
    """``lax.psum_scatter(x, axes, scatter_dimension=dim, tiled=True)``:
    the sum over the group, cut into as many blocks along ``dim`` as the
    group has ranks; each rank keeps the block at its coordinate."""
    group, size = _group(mesh, axes)
    if group is None:
        return x
    if x.shape[dim] % size:
        raise ValueError(f"reduce_scatter of {tuple(x.shape)} along {dim} over {size} ranks")
    return _ReduceScatter.apply(x, group, size, dim, path)


def seed_shares(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x``, which every rank of ``mesh`` holds alike (a loss), as the
    root of a backward pass under the module's convention: each of the N
    ranks passes back 1/N of its cotangent.  Issues no collective."""
    n = 1
    for size in mesh.shape.values():
        n *= size
    return _Shares.apply(x, n) if n > 1 else x
