"""Logical-axis → mesh-axis sharding rules.

Models declare *logical* axes (``d_model``, ``heads``, ``d_ff``, ``experts``
…); this module maps them onto the production mesh:

* ``model`` axis (16-way, intra-pod ICI): tensor parallel — heads / d_ff /
  vocab / experts / d_inner; KV-cache *sequence* for decode (flash-decode
  style — works for every GQA width incl. kv_heads < 16).
* ``data`` axis (16-way): batch; FSDP for parameters on ``d_model`` (ZeRO-3
  style — weights gathered per layer inside the scan, grads reduce-scattered).
* ``pod`` axis (2-way, DCN): pure data parallel — batch only; parameters are
  replicated across pods and gradient sync over DCN is scheduled by the BASS
  controller (see ``distributed.dcn``).

A logical axis is only sharded when the dimension divides the mesh axis;
otherwise it degrades to replication (e.g. kv_heads=2 on a 16-way model
axis) — recorded so the roofline can call out the waste.

These are pure functions of a mesh's axis sizes (any object whose
``shape`` maps axis names to sizes: ``launch.mesh.Mesh``, or a stand-in).
A spec is a tuple with one entry per dimension — ``None``, a mesh axis or
a tuple of axes — in ``PartitionSpec``'s normal form: trailing ``None``s
dropped and a one-axis tuple written as that axis; ``NamedSharding`` pairs one with its mesh.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

Tree = Any
Mesh = Any
Spec = Tuple[Any, ...]


@dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh.  ``device`` is the mesh's one device, where it
    has one: where a tensor so sharded lives on a single card."""

    mesh: Mesh
    spec: Spec

    @property
    def device(self):
        return self.mesh.device

# logical axis -> mesh axis name, per context
PARAM_RULES: Dict[str, str] = {
    "d_model": "data",          # FSDP
    "heads": "model",
    "kv_heads": "model",
    "d_ff": "model",
    "vocab": "model",
    "experts": "model",
    "d_inner": "model",
}

ACT_RULES_TRAIN: Dict[str, str] = {
    "batch": ("pod", "data"),
    "seq": "model",             # sequence parallelism for long prefill
    "vocab": "model",
}

# §Perf iteration 1: attention computes per-head (a2a seq→heads at the qkv
# projections) instead of re-gathering seq-sharded K/V per chunk.
ACT_RULES_TRAIN_OPT: Dict[str, str] = {
    **ACT_RULES_TRAIN,
    "heads": "model",
    "kv_heads": "model",
    "d_ff": "model",      # §Perf it.4: Megatron MLP (gather x, not weights)
    "megatron_blocks": True,  # §Perf it.5: one bf16 gather per block
}

# §Perf iteration 3: small models (≲1 B params) waste a 16-way tensor axis;
# run pure data parallel over every mesh axis instead (candidate list: full
# product first, then without the pod axis).
ACT_RULES_SMALL_DP: Dict[str, Any] = {
    "batch": [("pod", "data", "model"), ("data", "model"), ("data",)],
}

# Matching parameter policy: replicate everything (a ≲1 B model fits on one
# chip many times over; optimizer state stays sharded over data via the
# optimizer tree's own rules if desired — here full DP keeps it simple).
PARAM_RULES_SMALL_DP: Dict[str, Any] = {}

ACT_RULES_DECODE: Dict[str, str] = {
    "batch": ("pod", "data"),
    "kv_seq": "model",          # flash-decode: shard the KV cache on length
    "d_inner": "model",
    "vocab": "model",
}


def decode_rules(mesh: Mesh) -> Dict[str, Any]:
    """:data:`ACT_RULES_DECODE` with the batch over ``("pod", "data")``
    on a mesh with a ``pod`` axis, else ``("data",)``: the rules of a
    decode cell (``launch/dryrun.py::policy_rules``) and of the caches a
    prefill cell writes (the reference's ``build_cell``)."""
    return {**ACT_RULES_DECODE, "batch": ("pod", "data") if "pod" in mesh.shape else ("data",)}


def _axis_size(mesh: Mesh, axis) -> int:
    if isinstance(axis, tuple):
        out = 1
        for a in axis:
            out *= mesh.shape[a]
        return out
    return mesh.shape[axis]


def spec_for(
    shape: Tuple[int, ...],
    axes: Tuple[Optional[str], ...],
    mesh: Mesh,
    rules: Dict[str, Any],
) -> Spec:
    """Rules values may be a mesh axis, a tuple of axes, or a *list of
    candidates* (first divisible & unused wins — e.g. batch prefers
    ("pod","data","model") and degrades to ("data","model") on meshes whose
    full product doesn't divide the dimension)."""
    entries = []
    used = set()
    for dim, ax in zip(shape, axes):
        rule = rules.get(ax) if ax else None
        if rule is None:
            entries.append(None)
            continue
        candidates = rule if isinstance(rule, list) else [rule]
        chosen = None
        for mesh_axis in candidates:
            key = tuple(mesh_axis) if isinstance(mesh_axis, tuple) else (mesh_axis,)
            if any(k in used for k in key):
                continue  # a mesh axis may appear once per spec
            if any(k not in mesh.shape for k in key):
                continue
            if dim % _axis_size(mesh, mesh_axis) != 0:
                continue  # indivisible → try next candidate
            chosen = mesh_axis
            used.update(key)
            break
        entries.append(chosen)
    while entries and entries[-1] is None:
        entries.pop()
    # PartitionSpec's normal form: a one-axis tuple is that axis.
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries)


def block_index(shape: Tuple[int, ...], spec: Spec, mesh_shape: Dict[str, int],
                coords: Dict[str, int]) -> Tuple[slice, ...]:
    """The slices of the block of a ``shape`` leaf that the rank at
    ``coords`` (axis → index) holds under ``spec``: an entry naming one
    axis or a tuple of axes cuts its dimension into as many equal blocks
    as those axes hold ranks, numbered row-major over the tuple's axes in
    its order, as ``NamedSharding`` places them (an axis the mesh lacks
    counts one rank).  Dimensions past the spec are whole."""
    out = [slice(None)] * len(shape)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        n, idx = 1, 0
        for a in axes:
            size = mesh_shape.get(a, 1)
            n, idx = n * size, idx * size + (coords[a] if size > 1 else 0)
        if shape[i] % n:
            raise ValueError(f"{tuple(shape)}: {shape[i]} does not split over {entry} ({n})")
        blk = shape[i] // n
        if n > 1:
            out[i] = slice(idx * blk, (idx + 1) * blk)
    return tuple(out)


def rank_index(shape: Tuple[int, ...], axes: Tuple[Optional[str], ...], mesh: Mesh,
               coords: Dict[str, int], param_rules=None) -> Tuple[slice, ...]:
    """A rank's slices of a parameter with logical ``axes``, by
    :func:`spec_for` under ``param_rules`` (default :data:`PARAM_RULES`;
    the small-DP policy's :data:`PARAM_RULES_SMALL_DP` keeps every leaf
    whole)."""
    rules = PARAM_RULES if param_rules is None else param_rules
    return block_index(shape, spec_for(shape, axes, mesh, rules), mesh.shape, coords)


def rank_shard(mesh: Mesh, param_rules=None):
    """For ``init_params(shard=...)``: every leaf → this rank's slices of
    it (:func:`rank_index` under ``param_rules``) on the rank mesh
    ``mesh``."""
    coords = mesh.coords
    return lambda path, p: rank_index(p.shape, p.axes, mesh, coords, param_rules)


def param_shardings(defs: Tree, mesh: Mesh, rules=None) -> Tree:
    from ..models.params import tree_map_defs

    rules = PARAM_RULES if rules is None else rules
    return tree_map_defs(
        lambda p: NamedSharding(mesh, spec_for(p.shape, p.axes, mesh, rules)), defs
    )


def cache_shardings(cache_defs: Tree, mesh: Mesh, rules=None) -> Tree:
    from ..models.params import tree_map_defs

    rules = ACT_RULES_DECODE if rules is None else rules
    return tree_map_defs(
        lambda p: NamedSharding(mesh, spec_for(p.shape, p.axes, mesh, rules)), cache_defs
    )


def replication_report(defs: Tree, mesh: Mesh, rules=None) -> Dict[str, int]:
    """Bytes that *failed* to shard per logical axis (roofline callouts)."""
    from ..models.params import P, tree_map_defs

    rules = PARAM_RULES if rules is None else rules
    report: Dict[str, int] = {}

    def visit(p):
        for dim, ax in zip(p.shape, p.axes):
            mesh_axis = rules.get(ax) if ax else None
            if mesh_axis is not None and dim % _axis_size(mesh, mesh_axis) != 0:
                report[ax] = report.get(ax, 0) + 1
        return None

    tree_map_defs(visit, defs)
    return report
