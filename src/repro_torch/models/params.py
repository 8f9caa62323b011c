"""Parameter definition machinery.

A model is declared once as a nested dict of :class:`P` descriptors (shape
+ *logical axis names* + initializer).  Everything else derives from that
single declaration:

* ``init_params``       — real tensors on a device, from a ``torch.Generator``
* ``abstract_params``   — the same tree on the ``meta`` device (no memory)
* ``param_axes``        — the logical-axis tuples, for a later sharding slice

Logical axis vocabulary: ``layers period vocab d_model heads kv_heads
head_dim d_ff experts d_inner ssm_state dt_rank conv``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Optional, Tuple

import torch


@dataclass(frozen=True)
class P:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones | mamba_a
    stddev: float = 0.02

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


Tree = Any  # nested dict of P / tensors

#: Elements generated at a time for one leaf: a float32 slice of at most
#: 256 MB, so a full-width leaf (``stack/mlp/w_gate`` of mistral-nemo-12b
#: is 40 × 5120 × 14336) never needs a float32 copy of itself.
_SLICE_ELEMS = 1 << 26


def dtype_of(name) -> torch.dtype:
    """``"bfloat16"`` / ``"float32"`` (a config's dtype names) → torch."""
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


def tree_map_defs(fn: Callable[[P], Any], defs: Tree) -> Tree:
    if isinstance(defs, P):
        return fn(defs)
    return {k: tree_map_defs(fn, v) for k, v in defs.items()}


def flatten(tree: Tree, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) in sorted key order — the order ``jax.tree_util``
    flattens a dict in."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flatten(tree[k], path + (k,))
    else:
        yield path, tree


def unflatten(paths, leaves) -> Tree:
    """The dict tree holding each leaf at its path (inverse of :func:`flatten`)."""
    out: dict = {}
    for path, leaf in zip(paths, leaves, strict=True):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out


def _init_leaf(p: P, generator: torch.Generator, dtype, device, index=None) -> torch.Tensor:
    if p.init in ("zeros", "ones", "mamba_a"):
        if p.init == "mamba_a":
            # A_log init: log of 1..N broadcast over channels (mamba1).
            n = p.shape[-1]
            a = torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=device))
            whole = a.expand(p.shape).to(dtype).contiguous()
        else:
            fill = torch.zeros if p.init == "zeros" else torch.ones
            whole = fill(p.shape, dtype=dtype, device=device)
        return whole if index is None else whole[index].contiguous()
    if p.init != "normal":
        raise ValueError(f"unknown init {p.init!r}")
    # float32 normals scaled, then cast, as the reference does — one slice
    # along the first axis at a time, generated where the generator lives.
    # With ``index`` (slices, one per axis) every slice is drawn whole and
    # only its part of the block kept, so the block holds the numbers the
    # whole leaf would.
    shape = p.shape if index is None else torch.empty(p.shape, device="meta")[index].shape
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.numel() == 0:
        return out
    flat = out.view(shape[0], -1) if out.dim() > 1 else out.view(-1, 1)
    lo, hi, _ = (slice(None) if index is None else index[0]).indices(p.shape[0])
    cols = math.prod(p.shape[1:])
    rows = max(1, _SLICE_ELEMS // max(cols, 1))
    for r0 in range(0, p.shape[0], rows):
        r1 = min(r0 + rows, p.shape[0])
        z = torch.randn((r1 - r0, cols), generator=generator,
                        dtype=torch.float32, device=generator.device).mul_(p.stddev)
        a, b = max(r0, lo), min(r1, hi)
        if index is None:
            flat[r0:r1].copy_(z)
        elif a < b:
            block = (slice(a - r0, b - r0),) + tuple(index[1:])
            out[a - lo:b - lo].copy_(z.view((r1 - r0,) + tuple(p.shape[1:]))[block])
        del z    # before the next slice is drawn: one slice alive at a time
    return out


def init_params(defs: Tree, generator: torch.Generator, dtype, device="cuda",
                shard: Optional[Callable] = None) -> Tree:
    """Real parameters on ``device``: each ``normal`` leaf draws from
    ``generator`` (on whatever device it lives), leaves in sorted-path
    order.  ``shard(path, P)`` → a tuple of slices (or None: the whole
    leaf) keeps only that block of a leaf, holding the numbers the whole
    tree would (a rank's shards, ``models/moe.py::rank_shard``); the
    whole leaf is never held, only one generated slice of it at a time."""
    dtype = dtype_of(dtype)
    paths, defs_ = zip(*flatten(defs))
    return unflatten(paths, [_init_leaf(p, generator, dtype, device,
                                        shard(path, p) if shard else None)
                             for path, p in zip(paths, defs_)])


def abstract_params(defs: Tree, dtype) -> Tree:
    dtype = dtype_of(dtype)
    return tree_map_defs(lambda p: torch.empty(p.shape, dtype=dtype, device="meta"), defs)


def param_axes(defs: Tree) -> Tree:
    """Same-structure tree of logical-axis tuples."""
    return tree_map_defs(lambda p: p.axes, defs)


def count_params(defs: Tree) -> int:
    return sum(math.prod(p.shape) for _, p in flatten(defs))
