"""Carry scheduling state across from the reference package.

The functions here read the reference's objects by attribute only and
import nothing of it, so the port and the reference can run side by side
in one process (the parity tests) without either depending on the other.

:func:`canon` is the bit-exact image of a schedule that those comparisons
diff: every float as ``float.hex``.
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
