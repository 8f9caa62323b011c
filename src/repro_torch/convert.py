"""Carry scheduling state and model parameters across from the reference
package.

The functions here read the reference's objects by attribute only and
import nothing of it, so the port and the reference can run side by side
in one process (the parity tests) without either depending on the other.

:func:`canon` is the bit-exact image of a schedule that those comparisons
diff, :func:`canon_fetches` that of an epoch's shard fetches: every float
as ``float.hex``.
"""
from __future__ import annotations

from typing import Iterable

import numpy as np

from .core.tasks import BackgroundFlow, Instance, Task
from .core.timeslot import TimeSlotLedger
from .core.topology import Fabric


def fabric_from_reference(fab) -> Fabric:
    """Replay a reference ``Fabric``'s construction: its nodes in order with
    their roles, then its links in insertion order — ``add_uplink`` for a
    link that is some node's first ``parent_chain`` hop, ``add_link``
    otherwise.  The order matters: adjacency lists follow link insertion,
    and tree-LCA routing (``tree_routing_ok``) exists only for uplinks."""
    out = Fabric()
    uplinks = {}
    for n in fab.nodes:
        out.add_node(n, fab.role(n))
        chain = fab.parent_chain(n)
        if chain:
            uplinks[chain[0][1]] = (n, chain[0][0])
    for name, link in fab.links.items():
        up = uplinks.get(name)
        if up is not None and up == (link.a, link.b):
            out.add_uplink(name, link.a, link.b, link.capacity)
        else:
            out.add_link(name, link.a, link.b, link.capacity)
    return out


def instance_from_reference(inst) -> Instance:
    """A port ``Instance`` with the same fabric, tasks, workers, idle map,
    slot duration and background flows."""
    return Instance(
        fabric=fabric_from_reference(inst.fabric),
        workers=list(inst.workers),
        idle=dict(inst.idle),
        tasks=[
            Task(t.tid, t.size, t.compute, tuple(t.replicas), t.kind)
            for t in inst.tasks
        ],
        slot_duration=inst.slot_duration,
        background=[
            BackgroundFlow(b.src, b.dst, b.fraction, b.start, b.end)
            for b in inst.background
        ],
    )


def ledger_from_reference(led, fabric: Fabric) -> TimeSlotLedger:
    """A port ledger over ``fabric`` holding the reference ledger's
    ``reserved`` window, capacities, origin and slot duration."""
    out = TimeSlotLedger(fabric, led.slot_duration, max(1, led.reserved.shape[1]))
    out.reserved = np.array(led.reserved, dtype=np.float64)
    out.capacity = np.array(led.capacity, dtype=np.float64)
    out.base_slot = int(led.base_slot)
    return out


def canon(assignments: Iterable) -> tuple:
    """Hashable bit-exact image of a schedule (floats via ``hex``)."""
    out = []
    for a in sorted(assignments, key=lambda a: a.tid):
        t = a.transfer
        out.append((
            a.tid, a.node, a.source,
            a.start.hex(), a.finish.hex(),
            None if a.bw_needed is None else float(a.bw_needed).hex(),
            None if t is None else (
                t.links, float(t.start).hex(), float(t.end).hex(),
                tuple((s, float(f).hex()) for s, f in t.slot_fracs),
            ),
        ))
    return tuple(out)


def canon_fetches(fetches: Iterable) -> tuple:
    """Hashable bit-exact image of ``plan_epoch``'s fetch assignments."""
    return tuple(
        (f.shard_id, f.worker, f.source, float(f.start).hex(), float(f.ready).hex(),
         tuple(f.slots))
        for f in sorted(fetches, key=lambda f: f.shard_id)
    )


def params_from_jax(tree, device="cuda", dtype=None):
    """The port's parameter tree from the reference's, given with numpy
    leaves (``jax.tree_util.tree_map(np.asarray, params)``).  The layouts
    are the same, stacked ``[L, ...]`` leaves included, so each leaf is a
    copy, placed on ``device`` (default the card; pass ``"cpu"`` on a
    machine without one).  A bfloat16 leaf (``ml_dtypes.bfloat16``) moves
    through its bit pattern, so nothing rounds; ``dtype`` then casts every
    leaf (default: keep each leaf's own type)."""
    import torch

    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=device, dtype=dtype or t.dtype)


def shard_moe_params(params, mesh, coords):
    """A rank's shards of global MoE parameters (the reference's numpy
    leaves, as ``params_from_jax`` takes them, or tensors) for the
    expert-parallel dispatch: each leaf of one block's dict (the keys of
    ``models/moe.py::A2A_PARAM_SPECS``), or of every ``moe`` subtree of a
    model tree, cut by those specs at ``coords`` (axis → index) of
    ``mesh`` (its ``shape``); the other leaves whole.  Leaves are views."""
    from .models.moe import A2A_PARAM_SPECS, shard_index

    def walk(tree, block):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, k == "moe")
            elif block and k in A2A_PARAM_SPECS:
                out[k] = v[shard_index(k, v.shape, mesh.shape, coords)]
            else:
                out[k] = v
        return out

    return walk(params, "router" in params)


def shard_params(params, axes, mesh, coords, param_rules=None):
    """A rank's blocks of global parameters (the reference's numpy leaves,
    as ``params_from_jax`` takes them, or tensors): every leaf cut by
    ``spec_for`` of its logical axes (``axes``, the same tree of tuples,
    ``Model.axes()``) under ``param_rules`` (default ``PARAM_RULES``; the
    value ``launch/dryrun.py::policy_rules`` returns) at ``coords`` (axis
    → index) of ``mesh`` (its ``shape``), as the reference's
    ``param_shardings`` places it.  Leaves are views."""
    from .distributed.sharding import rank_index

    if isinstance(params, dict):
        return {k: shard_params(v, axes[k], mesh, coords, param_rules)
                for k, v in params.items()}
    return params[rank_index(tuple(params.shape), axes, mesh, coords, param_rules)]
