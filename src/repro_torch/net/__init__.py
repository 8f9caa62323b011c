"""``repro_torch.net`` — the SDN data plane under the scheduling control plane.

The control plane (``repro_torch.core``) decides *who* computes and *when*
bytes move; this package models *how they get there*: k-shortest-path
multipath routing (``paths``), per-switch flow tables (``flowtable``),
link/switch/host failure events with failure-aware rerouting (``events``),
topology builders with real path diversity (``fattree``), the
:class:`DataPlane` that ``ClusterController`` drives (``dataplane``), and
the telemetry plane (``telemetry``): per-link counter polling, EWMA/windowed
bandwidth estimators, and the measured-bandwidth :class:`BeliefState` that
``telemetry=True`` policies schedule against (DESIGN.md §9).
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
from .telemetry import (
    BeliefState,
    EwmaEstimator,
    LinkStatsMonitor,
    WindowRateEstimator,
)

__all__ = [
    "BeliefState",
    "DataPlane",
    "EwmaEstimator",
    "LinkStatsMonitor",
    "WindowRateEstimator",
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
