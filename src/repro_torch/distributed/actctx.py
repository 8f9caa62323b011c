"""Activation-sharding context.

Model code is mesh-agnostic; a launcher establishes a context
(``activation_sharding(mesh, rules, param_rules)``), and
``constrain(x, logical_axes)`` resolves a spec for ``x`` under the active
rules, with the reference's ``only_if`` and ``require_axis`` rules
(:func:`resolve`).  With no context active, where the rules resolve
nothing, or on a mesh of one device, it returns ``x`` unchanged.  Off a
rank mesh the port places no tensor across devices by a spec, so a spec
that resolves on a larger mesh raises.

On a rank mesh (``launch/mesh.py::_make_mesh``) each rank holds its block
of every tensor, and the layers move the blocks themselves.  Two readers
act on the context there.  Every model family (``models/model.py``)
takes its sharded path under the rules' layout of the residual stream
(:func:`rank_layout`: the batch over the rules' ``batch`` axes, the
sequence over ``model`` where the rules put it there; a VLM's stream holds
its vision prefix, and an encoder-decoder's encoder and decoder each take
the layout of their own sequence, one :func:`rank_layout` call each), each
parameter a block by the context's ``param_rules`` (``PARAM_RULES``, or
the small-DP policy's ``{}``: every leaf whole); the :class:`RankLayout`
it hands the layers issues that path's collectives.  Under the decode rules
(``sharding.decode_rules``) the same layout holds one token a row, the
sequence whole, and :func:`cache_layout` adds the decode cache's block of
positions (``kv_seq`` over ``model``), or of the mamba states' channels
(``d_inner`` over ``model``), to it.  The MoE block with
``moe_impl="a2a"`` takes the expert-parallel dispatch: in the sharded
model on the residual stream's block, which ``models/moe.py::a2a_layout``
gives it; in a ``replicated`` context (the expert-parallel block's own
runs, ``launch/expert.py``, whose model is whole on every rank but its
expert stacks) it cuts its whole input by the rules' ``batch`` and
``seq`` entries itself.  ``constrain`` on a rank mesh returns
``x``: the block it is given already lies where its spec says.

A train step on a rank mesh ends its backward pass with each leaf's
gradient as shares (``distributed/collectives.py``'s convention): the
gathers' transposes have already summed them over the axes the leaf is
split over.  :func:`sum_replicated` sums each leaf over the axes it is
held alike along — ``pod`` always, every axis under small-DP, ``model``
for a leaf not split over it (the norms, kv heads that do not divide the
axis) — GSPMD's gradient sync, after which each rank holds its block of
the global gradient; :func:`whole_sq_sums` gives the optimizer the whole
leaves' sums of squares, each counted once.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass, replace
from typing import Any, Dict, Optional, Tuple

import torch

from .sharding import PARAM_RULES, Spec, block_index, spec_for

_STATE: list = []


@contextmanager
def activation_sharding(mesh, rules: Dict[str, Any], param_rules: Optional[Dict[str, Any]] = None,
                        replicated: bool = False):
    """``rules``: the activation rules; ``param_rules``: where the
    parameters lie on a rank mesh (default ``PARAM_RULES``), the second
    value of ``launch/dryrun.py::policy_rules``.  ``replicated``: the
    model is whole on every rank but for the expert stacks that
    ``models/moe.py::rank_shard`` cuts (the expert-parallel block's own
    runs, ``launch/expert.py``), so no model takes :func:`rank_layout`'s
    sharded path."""
    _STATE.append((mesh, dict(rules), PARAM_RULES if param_rules is None else dict(param_rules),
                   replicated))
    try:
        yield
    finally:
        _STATE.pop()


def active() -> Optional[Tuple[Any, Dict[str, Any]]]:
    """(mesh, activation rules) of the active context, or None."""
    return _STATE[-1][:2] if _STATE else None


def rank_params() -> Optional[Tuple[Any, Dict[str, Any]]]:
    """(mesh, parameter rules) of the active context where its mesh is a
    rank mesh of more than one rank and the context is not
    ``replicated``, else None."""
    if not _STATE or not _on_ranks(_STATE[-1][0]) or _STATE[-1][3]:
        return None
    return _STATE[-1][0], _STATE[-1][2]


def _on_ranks(mesh) -> bool:
    return getattr(mesh, "is_rank_mesh", False) and _n_devices(mesh) > 1


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
    """Where a model's tensors lie on the ranks of a rank mesh.

    The residual stream ``[B, S, d]`` is split along the batch over the
    mesh axes ``batch`` (``()``: every rank holds the whole batch) and,
    when ``seq_sharded``, along the sequence over ``model``: this rank
    holds rows ``b0:b0 + b_loc`` and positions ``s0:s0 + s_loc``.  Each
    parameter is this rank's block by ``param_rules``: under
    ``PARAM_RULES`` heads, kv heads, ``d_ff``, the vocabulary, the
    experts and ``d_inner`` split over ``model`` where they divide it (the layers read
    which from the blocks' shapes), ``d_model`` over ``data`` (FSDP),
    gathered by
    :meth:`gather_params` just before use; under the small-DP policy's
    ``{}`` every leaf whole.  Every method issues its collectives through
    ``distributed/collectives.py``, counted under ``path``.

    A decode layout (:func:`cache_layout`) also places the caches ``[L,
    B, s_max, nkv, hd]``: this rank's rows of the batch, as the residual
    stream's, and when ``kv_sharded`` its block of positions ``kv0:kv0 +
    kv_loc`` over ``model`` (else every position), of every kv head; the
    mamba states ``[L, B, k - 1, d_inner]`` and ``[L, B, d_inner, N]``:
    its rows, and when ``di_sharded`` its block of channels ``di0:di0 +
    di_loc`` over ``model``, the parameters' block (else every channel).
    A hybrid's layout holds both blocks, one ``cache_layout`` call for
    each kind.  A ``stationary`` decode layout keeps the parameters'
    ``d_model`` blocks in place, where the batch does not split over
    ``data`` (:meth:`d_block`, :meth:`contract`, :meth:`whole_d`): an
    SSM's layers, or every slot of a hybrid period (attention, mamba, MLP
    and MoE), sum their in-projections' partial products over ``data``
    and gather their outputs' blocks over it.  An MoE or hybrid model's
    decode layout keeps its expert stacks' ``d_model`` blocks in place
    under the gather dispatch (``experts_stationary``:
    :func:`keeps_expert_blocks`)."""

    mesh: Any
    batch: Tuple[str, ...]
    seq_sharded: bool
    b: int
    s: int
    param_rules: Dict[str, Any]
    s_max: int = 0
    kv_sharded: bool = False
    d_inner: int = 0
    di_sharded: bool = False
    stationary: bool = False
    experts_stationary: bool = False

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

    @property
    def kv_loc(self) -> int:
        return self.s_max // self.n_model if self.kv_sharded else self.s_max

    @property
    def kv0(self) -> int:
        return self.mi * self.kv_loc if self.kv_sharded else 0

    @property
    def di_loc(self) -> int:
        return self.d_inner // self.n_model if self.di_sharded else self.d_inner

    @property
    def di0(self) -> int:
        return self.mi * self.di_loc if self.di_sharded else 0

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole-batch tensor."""
        return x[self.b0:self.b0 + self.b_loc]

    def d_block(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``x``'s last dimension (``d_model``) over
        ``data``."""
        n = x.shape[-1] // self.mesh.shape.get("data", 1)
        i = self.mesh.coords.get("data", 0)
        return x[..., i * n:(i + 1) * n]

    def contract(self, x: torch.Tensor, w: torch.Tensor, path: str) -> torch.Tensor:
        """``x @ w`` over ``d_model`` of ``x``, this rank's block of it
        (:meth:`d_block`), and ``w``, this rank's block of its rows: the
        float32 partial products summed over ``data`` and rounded to
        ``x``'s dtype once, where one rank's product rounds once."""
        from .collectives import psum

        return psum(x.float() @ w.float(), self.mesh, "data", path).to(x.dtype)

    def whole_d(self, y: torch.Tensor, path: str) -> torch.Tensor:
        """``[..., d / data ranks]`` → ``[..., d]``: this rank's block of
        ``d_model`` gathered over ``data``."""
        from .collectives import all_gather

        return all_gather(y, self.mesh, "data", y.dim() - 1, path)

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
            spec = spec_for(decl.shape, decl.axes, self.mesh, self.param_rules)
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
    context, where its mesh is a rank mesh of more than one rank and the
    context is not ``replicated`` (else None), by :func:`residual_axes`:
    the baseline's and ``opt``'s (the batch over ``data``, or ``("pod",
    "data")``, the sequence over ``model``) and small-DP's (the batch over
    every axis it divides, the sequence whole, every leaf whole).  Raises
    for the sequence over another axis than ``model``, and for the batch
    over ``model`` while the parameter rules split leaves over it."""
    if not _STATE or not _on_ranks(_STATE[-1][0]) or _STATE[-1][3]:
        return None
    mesh, rules, param_rules, _ = _STATE[-1]
    batch, seq = residual_axes(b, s, d, mesh, rules)
    if seq not in (None, "model") or ("model" in batch and "model" in param_rules.values()):
        raise NotImplementedError(f"the sharded model with the batch over {batch}, the "
                                  f"sequence over {seq} and parameters by {param_rules}")
    return RankLayout(mesh, batch, seq == "model", b, s, param_rules)


def cache_layout(lay: RankLayout, decl, rules: Dict[str, Any]) -> RankLayout:
    """``lay`` with the block of the cache leaf that ``decl`` declares
    under ``rules``, by ``spec_for``: an attention cache ``[L, B, s_max,
    nkv, hd]`` (axes ``("layers", "batch", "kv_seq", "kv_heads",
    "head_dim")``), ``kv_seq`` over ``model`` where the decode rules put it
    there and it divides, else whole; a mamba state (``conv`` or ``h``),
    ``d_inner`` over ``model`` where it divides, as the parameters split
    it; a cross-attention cache ``[L, B, enc_seq, nkv, hd]`` (its positions
    declared ``None``), every position and kv head: ``lay`` as it is.
    Raises where the cache's batch would lie otherwise than the residual
    stream's, its positions or channels over another axis, its kv heads
    split, or its channels otherwise than the parameters' (the layer runs
    on the parameters' block)."""
    spec = spec_for(decl.shape, decl.axes, lay.mesh, rules) + (None,) * len(decl.shape)
    batch = spec[1] if isinstance(spec[1], tuple) else (spec[1],) if spec[1] else ()
    at = next((decl.axes.index(a) for a in ("kv_seq", "d_inner") if a in decl.axes), None)
    rest = [e for i, e in enumerate(spec[:len(decl.shape)]) if i not in (1, at)]
    if at is None:
        if batch != lay.batch or any(rest):
            raise NotImplementedError(f"cross caches by {spec[:len(decl.shape)]} beside the "
                                      f"batch over {lay.batch}")
        return lay
    params = spec_for((decl.shape[at],), ("d_inner",), lay.mesh, lay.param_rules)
    if (batch != lay.batch or spec[at] not in (None, "model") or any(rest)
            or (decl.axes[at] == "d_inner" and (spec[at],) != (params + (None,))[:1])):
        raise NotImplementedError(f"caches by {spec[:len(decl.shape)]} beside the batch over "
                                  f"{lay.batch} and parameters by {lay.param_rules}")
    if decl.axes[at] == "d_inner":
        return replace(lay, d_inner=decl.shape[at], di_sharded=spec[at] == "model")
    return replace(lay, s_max=decl.shape[at], kv_sharded=spec[at] == "model")


def keeps_d_blocks(lay: RankLayout, d_model: int) -> bool:
    """Whether a decode layout should keep the parameters' ``d_model``
    blocks in place: the batch does not split over ``data`` (every rank of
    it holds the same rows), while the parameter rules split ``d_model``
    over it.  Gathering each layer's weights there would move them all to
    compute what each rank computes alike; the partial products over
    ``d_model`` summed over ``data`` move a row's activations instead, as
    GSPMD partitions the reference's decode cell."""
    return ("data" not in lay.batch and spec_for((d_model,), ("d_model",), lay.mesh,
                                                 lay.param_rules) == ("data",))


def keeps_expert_blocks(mesh, param_rules: Dict[str, Any], d_model: int) -> bool:
    """Whether an MoE decode tick under the gather dispatch should keep its
    expert stacks' ``d_model`` blocks in place: the parameter rules split
    ``d_model`` over a ``data`` axis of more than one rank.  A tick routes
    a few rows into ``capacity`` rows an expert; gathering every expert's
    weights over ``data`` each tick moves far more than the rows'
    activations and the in-projections' partial products do, which is what
    GSPMD moves for the reference's decode cell."""
    return (mesh.shape.get("data", 1) > 1
            and spec_for((d_model,), ("d_model",), mesh, param_rules) == ("data",))


def replicated_axes(decl, mesh, param_rules: Dict[str, Any]) -> Tuple[str, ...]:
    """The axes of ``mesh`` (of more than one rank, in mesh order) along
    which every rank holds the same block of the leaf ``decl`` declares:
    those its spec under ``param_rules`` does not split it over."""
    split = set()
    for entry in spec_for(decl.shape, decl.axes, mesh, param_rules):
        if entry is not None:
            split.update(entry if isinstance(entry, tuple) else (entry,))
    return tuple(a for a in mesh.axis_names if mesh.shape[a] > 1 and a not in split)


def sum_replicated(grads, defs, mesh, param_rules: Dict[str, Any], path: str = "grads"):
    """``grads`` (this rank's shares of its blocks, declared by ``defs``)
    with each leaf summed over its :func:`replicated_axes`: one ``psum``
    for each set of axes, of the leaves that share it flattened together,
    the sets in the order their first leaf comes in ``flatten``."""
    from ..models.params import flatten, unflatten
    from .collectives import psum

    paths, leaves = zip(*flatten(grads))
    decls = dict(flatten(defs))
    sets: Dict[Tuple[str, ...], list] = {}
    for i, p in enumerate(paths):
        axes = replicated_axes(decls[p], mesh, param_rules)
        if axes:
            sets.setdefault(axes, []).append(i)
    out = list(leaves)
    for axes, idx in sets.items():
        flat = psum(torch.cat([out[i].reshape(-1) for i in idx]), mesh, axes, path)
        at = 0
        for i in idx:
            n = out[i].numel()
            out[i] = flat[at:at + n].view(out[i].shape).to(out[i].dtype)
            at += n
    return unflatten(paths, out)


def whole_sq_sums(sq: torch.Tensor, defs, mesh, param_rules: Dict[str, Any],
                  path: str = "grad_norm") -> torch.Tensor:
    """``sq``, the sums of squares of this rank's blocks of each leaf (a
    vector in ``flatten`` order of ``defs``), → those of the whole leaves:
    each leaf counted on the ranks at coordinate 0 of its
    :func:`replicated_axes`, then one ``psum`` over the mesh, so a block
    that several ranks hold counts once.  Where no leaf is split, ``sq``
    already holds them."""
    from ..models.params import flatten
    from .collectives import psum

    axes = tuple(a for a in mesh.axis_names if mesh.shape[a] > 1)
    reps = [replicated_axes(decl, mesh, param_rules) for _, decl in flatten(defs)]
    if all(r == axes for r in reps):
        return sq
    keep = torch.tensor([all(mesh.coords[a] == 0 for a in r) for r in reps], device=sq.device)
    return psum(torch.where(keep, sq, 0.0), mesh, axes, path)
