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
memory: a copy to pinned host memory, the collective there, a copy back
(``stats["host_staged"]``; ``staging`` adds up the seconds of each of the
three, the card synchronised before each copy is timed); gloo on a host
tensor runs in place (``stats["direct"]``).  Both backends take
``all_gather_into_tensor``, the list form of ``reduce_scatter`` and
``all_to_all_single``.  On a recording mesh (``launch/mesh.py::
recording_mesh``) the group is a ``Recording`` marker: the collective
returns an empty ``meta`` tensor of its result's shape and is counted as
on real ranks, with no copy and no ``torch.distributed`` call.  Neither
route stands in for the other: a marker given a tensor that is not on
``meta`` raises, and so does a process group given a ``meta`` tensor.
Each op counts as crossing pods (``Collective.crosses_pod``) where its
group's axes include ``pod``.

**Backward.**  Each collective is a ``torch.autograd.Function`` whose
backward is its transpose over the same group, counted like a forward
one under its path with ``/bwd`` added: ``all_gather`` along ``dim`` →
``reduce_scatter`` along ``dim``; ``reduce_scatter`` → ``all_gather``;
``all_to_all`` → ``all_to_all``; ``psum`` → ``psum``.  Collectives that a
checkpointed layer issues again while the backward pass recomputes it
(:func:`recomputing`) count under ``/bwd`` too.  :func:`pmax` (the
sharded decode's row maxima, counted as an ``all-reduce``) is forward
only: its backward raises ``NotImplementedError``, since no train step
reaches it.

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

import time
from contextlib import contextmanager
from typing import Tuple, Union

import torch
import torch.distributed as dist

from ..launch.hlo_analysis import record_collective
from ..launch.mesh import Recording
from ..obs import default_registry

stats = default_registry().group("collectives", ("direct", "host_staged"))
staging = default_registry().group("collectives_staging", ("to_host_s", "op_s", "to_device_s"))

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
    """(process group, size, whether it spans ``pod``) over the axes of
    ``axes`` larger than 1, or (None, 1, False) when there is none."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    axes = tuple(a for a in axes if mesh.shape.get(a, 1) > 1)
    if not axes:
        return None, 1, False
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    return mesh.group(axes), size, "pod" in axes


def _recorded(x: torch.Tensor, group) -> bool:
    """Whether ``group`` is a recording marker; raises where the group and
    ``x``'s device disagree (a marker with a tensor off ``meta``, a process
    group with a ``meta`` tensor)."""
    recorded = isinstance(group, Recording)
    if recorded != (x.device.type == "meta"):
        raise ValueError(f"a collective over {group} given a tensor on {x.device}: a "
                         "recording mesh runs on meta tensors, a process group on no others")
    return recorded


def _staged(x: torch.Tensor, group) -> bool:
    staged = x.device.type == "cuda" and dist.get_backend(group) == "gloo"
    stats["host_staged" if staged else "direct"] += 1
    return staged


def _to_host(x: torch.Tensor, staged: bool, copy: bool = False) -> torch.Tensor:
    """``x``, contiguous, where the group's backend takes it: where gloo
    stages it, a copy in pinned host memory (the caching host allocator's
    blocks, so no fresh pages a call, and the copies at the card's DMA
    rate); else ``x`` (a copy of it with ``copy``)."""
    if not staged:
        return x.clone(memory_format=torch.contiguous_format) if copy else x.contiguous()
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    out.copy_(x)
    staging["to_host_s"] += time.perf_counter() - t0
    return out


def _empty(shape, like: torch.Tensor, staged: bool) -> torch.Tensor:
    """A result buffer beside ``like``: pinned where gloo stages it."""
    return torch.empty(shape, dtype=like.dtype, device=like.device, pin_memory=staged)


def _run(collective, *args, **kwargs):
    """The backend's collective, timed."""
    t0 = time.perf_counter()
    collective(*args, **kwargs)
    staging["op_s"] += time.perf_counter() - t0


def _to_device(out: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``out`` back on ``like``'s device."""
    if out.device == like.device:
        return out
    t0 = time.perf_counter()
    out = out.to(like.device)
    torch.cuda.synchronize(like.device)
    staging["to_device_s"] += time.perf_counter() - t0
    return out


def _record(kind: str, out: torch.Tensor, size: int, path: str, crosses_pod: bool,
            backward: bool = False):
    if backward or _RECOMPUTING:
        path = f"{path}/bwd"
    record_collective(kind, out.numel() * out.element_size(), size, path, crosses_pod)


def _gather(x: torch.Tensor, group, size: int, dim: int) -> torch.Tensor:
    """The blocks stacked ``[size, ...]`` by one ``all_gather_into_tensor``
    into one buffer (pinned where staged), laid along ``dim`` on ``x``'s
    device."""
    if _recorded(x, group):
        shape = list(x.shape)
        shape[dim] *= size
        return x.new_empty(shape)
    staged = _staged(x, group)
    src = _to_host(x, staged)
    out = _empty((size * x.shape[0],) + tuple(x.shape[1:]), src, staged)
    _run(dist.all_gather_into_tensor, out, src, group=group)
    whole = _to_device(out, x).view((size,) + tuple(x.shape))
    return whole.movedim(0, dim).flatten(dim, dim + 1)


def _reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    if _recorded(x, group):
        return torch.empty_like(x)
    out = _to_host(x, _staged(x, group), copy=True)
    _run(dist.all_reduce, out, op=op, group=group)
    return _to_device(out, x)


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    if _recorded(x, group):
        return torch.empty_like(x)
    staged = _staged(x, group)
    src = _to_host(x, staged)
    out = _empty(src.shape, src, staged)
    _run(dist.all_to_all_single, out, src, group=group)
    return _to_device(out, x)


def _scatter(x: torch.Tensor, group, size: int, dim: int) -> torch.Tensor:
    """The blocks along ``dim`` stacked ``[size, ...]`` on ``x``'s device
    first, so the host holds one contiguous buffer (pinned where staged)
    whose rows are the list form's inputs."""
    if _recorded(x, group):
        shape = list(x.shape)
        shape[dim] //= size
        return x.new_empty(shape)
    staged = _staged(x, group)
    src = _to_host(x.unflatten(dim, (size, -1)).movedim(dim, 0), staged)
    out = _empty(src.shape[1:], src, staged)
    _run(dist.reduce_scatter, out, list(src.unbind(0)), op=dist.ReduceOp.SUM, group=group)
    return _to_device(out, x)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, dim, path, pod):
        ctx.args = (group, size, dim, path, pod)
        out = _gather(x, group, size, dim)
        _record("all-gather", out, size, path, pod)
        return out

    @staticmethod
    def backward(ctx, g):
        group, size, dim, path, pod = ctx.args
        out = _scatter(g, group, size, dim)
        _record("reduce-scatter", out, size, path, pod, backward=True)
        return out, None, None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, dim, path, pod):
        ctx.args = (group, size, dim, path, pod)
        out = _scatter(x, group, size, dim)
        _record("reduce-scatter", out, size, path, pod)
        return out

    @staticmethod
    def backward(ctx, g):
        group, size, dim, path, pod = ctx.args
        out = _gather(g, group, size, dim)
        _record("all-gather", out, size, path, pod, backward=True)
        return out, None, None, None, None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, path, pod):
        ctx.args = (group, size, path, pod)
        out = _reduce(x, group)
        _record("all-reduce", out, size, path, pod)
        return out

    @staticmethod
    def backward(ctx, g):
        group, size, path, pod = ctx.args
        out = _reduce(g, group)
        _record("all-reduce", out, size, path, pod, backward=True)
        return out, None, None, None, None


class _Pmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, path, pod):
        out = _reduce(x, group, dist.ReduceOp.MAX)
        _record("all-reduce", out, size, path, pod)
        return out

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError("pmax has no backward: no train step reaches it")


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, path, pod):
        ctx.args = (group, size, path, pod)
        out = _exchange(x, group)
        _record("all-to-all", out, size, path, pod)
        return out

    @staticmethod
    def backward(ctx, g):
        group, size, path, pod = ctx.args
        out = _exchange(g, group)
        _record("all-to-all", out, size, path, pod, backward=True)
        return out, None, None, None, None


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
    group, size, pod = _group(mesh, axes)
    if group is None:
        return x
    return _AllGather.apply(x, group, size, dim, path, pod)


def psum(x: torch.Tensor, mesh, axes: Axes, path: str = "") -> torch.Tensor:
    """``lax.psum(x, axes)``: the sum over the group, on every rank."""
    group, size, pod = _group(mesh, axes)
    if group is None:
        return x
    return _Psum.apply(x, group, size, path, pod)


def pmax(x: torch.Tensor, mesh, axes: Axes, path: str = "") -> torch.Tensor:
    """``lax.pmax(x, axes)``: the elementwise maximum over the group, on
    every rank (forward only)."""
    group, size, pod = _group(mesh, axes)
    if group is None:
        return x
    return _Pmax.apply(x, group, size, path, pod)


def all_to_all(x: torch.Tensor, mesh, axis: str, path: str = "") -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_axis=0, concat_axis=0, tiled=False)``
    of ``x [n, ...]`` over the ``n`` ranks of ``axis``: block ``j`` of the
    result is block ``i`` of rank ``j``'s ``x``, where ``i`` is this rank's
    coordinate."""
    group, size, pod = _group(mesh, axis)
    if group is None:
        return x
    if x.shape[0] != size:
        raise ValueError(f"all_to_all of {tuple(x.shape)} over {size} ranks")
    return _AllToAll.apply(x, group, size, path, pod)


def reduce_scatter(x: torch.Tensor, mesh, axes: Axes, dim: int, path: str = "") -> torch.Tensor:
    """``lax.psum_scatter(x, axes, scatter_dimension=dim, tiled=True)``:
    the sum over the group, cut into as many blocks along ``dim`` as the
    group has ranks; each rank keeps the block at its coordinate."""
    group, size, pod = _group(mesh, axes)
    if group is None:
        return x
    if x.shape[dim] % size:
        raise ValueError(f"reduce_scatter of {tuple(x.shape)} along {dim} over {size} ranks")
    return _ReduceScatter.apply(x, group, size, dim, path, pod)


def seed_shares(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x``, which every rank of ``mesh`` holds alike (a loss), as the
    root of a backward pass under the module's convention: each of the N
    ranks passes back 1/N of its cotangent.  Issues no collective."""
    n = 1
    for size in mesh.shape.values():
        n *= size
    return _Shares.apply(x, n) if n > 1 else x
