"""Activation-sharding context.

Model code is mesh-agnostic; a launcher establishes a context
(``activation_sharding(mesh, rules)``), and ``constrain(x, logical_axes)``
resolves a spec for ``x`` under the active rules, with the reference's
``only_if`` and ``require_axis`` rules (:func:`resolve`).  With no context
active, where the rules resolve nothing, or on a mesh of one device, it
returns ``x`` unchanged.  Off a rank mesh the port places no tensor
across devices by a spec, so a spec that resolves on a larger mesh
raises.

On a rank mesh (``launch/mesh.py::_make_mesh``) each rank holds its block
of every tensor, and the layers move the blocks themselves.  Two readers
act on the context there.  The dense model (``models/model.py``) takes
its sharded path under the rules' layout of the residual stream
(:func:`rank_layout`: the batch over the rules' ``batch`` axes, the
sequence over ``model``), each parameter a block by ``PARAM_RULES``; the
:class:`RankLayout` it hands the layers issues that path's collectives.
The MoE block with ``moe_impl="a2a"`` takes the expert-parallel dispatch,
which cuts its input by the rules' ``batch`` and ``seq`` entries itself
(``models/moe.py::a2a_layout``).  ``constrain`` on a rank mesh returns
``x``: the block it is given already lies where its spec says.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from .sharding import PARAM_RULES, Spec, block_index, spec_for

_STATE: list = []


@contextmanager
def activation_sharding(mesh, rules: Dict[str, Any]):
    _STATE.append((mesh, dict(rules)))
    try:
        yield
    finally:
        _STATE.pop()


def active() -> Optional[Tuple[Any, Dict[str, Any]]]:
    return _STATE[-1] if _STATE else None


def _n_devices(mesh) -> int:
    return math.prod(mesh.shape.values())


def resolve(shape: Tuple[int, ...], logical_axes: Tuple[Optional[str], ...],
            only_if: Optional[str] = None, require_axis: Optional[str] = None
            ) -> Optional[Spec]:
    """The spec :func:`constrain` applies to a tensor of ``shape`` under
    the active rules, or None where it applies none.

    ``only_if`` names a boolean policy flag that must be present in the
    rules (e.g. "megatron_blocks"); ``require_axis`` names a logical axis
    that must be mapped by the rules for the constraint to apply at all —
    otherwise a partially-resolved spec (e.g. batch only) would silently
    force the *other* dims replicated, changing baseline behavior."""
    ctx = active()
    if ctx is None:
        return None
    mesh, rules = ctx
    if only_if is not None and not rules.get(only_if):
        return None
    if require_axis is not None and require_axis not in rules:
        return None
    return spec_for(tuple(shape), logical_axes, mesh, rules) or None


def constrain(
    x,
    logical_axes: Tuple[Optional[str], ...],
    only_if: Optional[str] = None,
    require_axis: Optional[str] = None,
):
    """Apply a sharding constraint from logical axes under the active rules
    (:func:`resolve`)."""
    spec = resolve(tuple(x.shape), logical_axes, only_if, require_axis)
    if spec is None:
        return x
    mesh = active()[0]
    if _n_devices(mesh) == 1 or getattr(mesh, "is_rank_mesh", False):
        return x
    raise NotImplementedError(
        f"constrain{tuple(x.shape)} to {spec} over {mesh.shape}: the port places no "
        "tensor across devices"
    )


@dataclass(frozen=True)
class RankLayout:
    """Where a dense model's tensors lie on the ranks of a rank mesh.

    The residual stream ``[B, S, d]`` is split along the batch over the
    mesh axes ``batch`` (``()``: every rank holds the whole batch) and,
    when ``seq_sharded``, along the sequence over ``model``: this rank
    holds rows ``b0:b0 + b_loc`` and positions ``s0:s0 + s_loc``.  Each
    parameter is this rank's block by ``PARAM_RULES``: heads, kv heads,
    ``d_ff`` and the vocabulary split over ``model`` where they divide it
    (the layers read which from the blocks' shapes); ``d_model`` over
    ``data`` (FSDP), gathered by :meth:`gather_params` just before use.
    Every method issues its collectives through
    ``distributed/collectives.py``, counted under ``path``."""

    mesh: Any
    batch: Tuple[str, ...]
    seq_sharded: bool
    b: int
    s: int

    @property
    def n_model(self) -> int:
        return self.mesh.shape.get("model", 1)

    @property
    def mi(self) -> int:
        """This rank's coordinate along ``model``."""
        return self.mesh.coords.get("model", 0)

    @property
    def b0(self) -> int:
        return block_index((self.b,), (self.batch or None,), self.mesh.shape,
                           self.mesh.coords)[0].indices(self.b)[0]

    @property
    def b_loc(self) -> int:
        return self.b // math.prod(self.mesh.shape[a] for a in self.batch)

    @property
    def s_loc(self) -> int:
        return self.s // self.n_model if self.seq_sharded else self.s

    @property
    def s0(self) -> int:
        return self.mi * self.s_loc if self.seq_sharded else 0

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole-batch tensor."""
        return x[self.b0:self.b0 + self.b_loc]

    def gather_params(self, tree: Dict[str, Any], defs: Dict[str, Any], path: str):
        """``tree`` (this rank's blocks, declared by ``defs``) with every
        dimension split over axes other than ``model`` made whole, by one
        all-gather of all such blocks at once; blocks split over ``model``
        only, or not at all, are returned as they are."""
        from ..models.params import flatten, unflatten
        from .collectives import all_gather

        paths, leaves = zip(*flatten(tree))
        out = dict(zip(paths, leaves))
        moved, axes = [], None
        for p, leaf in zip(paths, leaves):
            decl = _leaf(defs, p)
            spec = spec_for(decl.shape, decl.axes, self.mesh, PARAM_RULES)
            split = [(i, e) for i, e in enumerate(spec) if e not in (None, "model")]
            if not split:
                continue
            if len(split) > 1 or (axes is not None and split[0][1] != axes):
                raise NotImplementedError(f"{'/'.join(p)}: spec {spec} gathers over more "
                                          "than one set of axes")
            dim, axes = split[0]
            moved.append((p, dim, leaf.movedim(dim, 0)))
        if not moved:
            return tree
        flat = torch.cat([m.reshape(-1) for _, _, m in moved])
        whole = all_gather(flat, self.mesh, axes, 0, path)
        n = whole.numel() // flat.numel()
        whole = whole.view(n, flat.numel())
        at = 0
        for p, dim, m in moved:
            part = whole[:, at:at + m.numel()].reshape((n * m.shape[0],) + tuple(m.shape[1:]))
            out[p] = part.movedim(0, dim)
            at += m.numel()
        return unflatten(paths, [out[p] for p in paths])

    def gather_seq(self, x: torch.Tensor, path: str) -> torch.Tensor:
        """``[b, s_loc, ...]`` → ``[b, S, ...]``: the sequence gathered
        over ``model`` (this block itself when the sequence is whole)."""
        from .collectives import all_gather

        return all_gather(x, self.mesh, "model", 1, path) if self.seq_sharded else x

    def scatter_seq(self, y: torch.Tensor, partial: bool, path: str) -> torch.Tensor:
        """``[b, S, ...]`` → this rank's block of the residual stream.
        ``partial``: ``y`` is this rank's share of a sum over ``model``
        (a row-parallel product), summed by a reduce-scatter along the
        sequence (or a sum when the sequence is whole); else every rank
        holds the whole ``y`` and keeps its positions."""
        from .collectives import psum, reduce_scatter

        if partial:
            return (reduce_scatter(y, self.mesh, "model", 1, path) if self.seq_sharded
                    else psum(y, self.mesh, "model", path))
        return y[:, self.s0:self.s0 + self.s_loc]


def _leaf(defs, path):
    for k in path:
        defs = defs[k]
    return defs


def residual_axes(b: int, s: int, d: int, mesh, rules: Dict[str, Any]
                  ) -> Tuple[Tuple[str, ...], Optional[str]]:
    """(the mesh axes the batch of a ``[b, s, d]`` residual stream splits
    over, the axis its sequence splits over or None): ``spec_for`` of
    ``("batch", "seq", None)`` under ``rules``."""
    spec = spec_for((b, s, d), ("batch", "seq", None), mesh, rules) + (None, None)
    return (spec[0] if isinstance(spec[0], tuple) else (spec[0],) if spec[0] else ()), spec[1]


def rank_layout(b: int, s: int, d: int) -> Optional[RankLayout]:
    """The layout of a ``[b, s, d]`` residual stream under the active
    context, where its mesh is a rank mesh of more than one rank (else
    None), by :func:`residual_axes`.  Raises for rules that split the
    batch over ``model`` or the sequence over another axis: the other
    policies' layouts are not ported."""
    ctx = active()
    if ctx is None or not getattr(ctx[0], "is_rank_mesh", False) or _n_devices(ctx[0]) == 1:
        return None
    mesh, rules = ctx
    batch, seq = residual_axes(b, s, d, mesh, rules)
    if "model" in batch or seq not in (None, "model"):
        raise NotImplementedError(f"the sharded model with the batch over {batch} and the "
                                  f"sequence over {seq}")
    return RankLayout(mesh, batch, seq == "model", b, s)
