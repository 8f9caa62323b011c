"""``repro_torch.net`` — the SDN data plane under the scheduling control plane.

The control plane (``repro_torch.core``) decides *who* computes and *when*
bytes move; this package models *how they get there*: k-shortest-path
multipath routing (``paths``), per-switch flow tables (``flowtable``),
link/switch/host failure events with failure-aware rerouting (``events``),
topology builders with real path diversity (``fattree``), and the
:class:`DataPlane` that ``ClusterController`` drives (``dataplane``).
"""
from .dataplane import DataPlane
from .events import (
    HostDown,
    HostUp,
    LinkDown,
    LinkUp,
    NetworkEvent,
    RerouteRecord,
    SwitchDown,
    SwitchUp,
)
from .fattree import fat_tree_fabric, oversubscribed_leaf_spine
from .flowtable import FlowRule, FlowTable, FlowTables
from .paths import PathEngine, UnroutableError, k_shortest_paths

__all__ = [
    "DataPlane",
    "FlowRule",
    "HostDown",
    "HostUp",
    "FlowTable",
    "FlowTables",
    "LinkDown",
    "LinkUp",
    "NetworkEvent",
    "PathEngine",
    "RerouteRecord",
    "SwitchDown",
    "SwitchUp",
    "UnroutableError",
    "fat_tree_fabric",
    "k_shortest_paths",
    "oversubscribed_leaf_spine",
]
