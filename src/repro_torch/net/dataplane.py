"""The SDN data plane: link liveness + path engine + flow tables.

One :class:`DataPlane` sits under each ``ClusterController``.  It owns

* the **liveness overlay** — failed links/switches are state *here*, not
  mutations of the shared ``Fabric`` (the fabric stays the wiring diagram;
  the data plane knows what is currently forwarding);
* the **path engine** — k-shortest-path candidates per endpoint pair,
  filtered through the overlay by :meth:`candidates`;
* the **flow tables** — the per-switch rules of every in-flight transfer.

With no failures injected, :meth:`candidates` returns the cached engine
set whose first element is ``Fabric.path(src, dst)`` verbatim — so a
controller that never sees churn behaves byte-identically to the
pre-data-plane code.
"""
from __future__ import annotations

from typing import Dict, FrozenSet, Optional, Sequence, Set, Tuple

from ..core.timeslot import TimeSlotLedger
from ..core.topology import Fabric
from .flowtable import FlowTables
from .paths import Path, PathEngine, UnroutableError


class DataPlane:
    def __init__(self, fabric: Fabric, k: int = 4) -> None:
        self.fabric = fabric
        self.engine = PathEngine(fabric, k=k)
        self.tables = FlowTables(fabric)
        self.dead_links: Set[str] = set()    # individually failed
        self.dead_switches: Set[str] = set()
        self.dead_hosts: Set[str] = set()    # crashed workers/sources
        self._dead_all: Optional[FrozenSet[str]] = None  # overlay cache
        #: Monotone counter bumped on every liveness mutation — cheap cache
        #: key for consumers (the wavefront planner) whose candidate sets
        #: depend on the current dead set.
        self.liveness_version = 0

    # -- liveness overlay ---------------------------------------------------
    def fail_link(self, name: str) -> None:
        self.fabric.link(name)  # KeyError on unknown link
        self.dead_links.add(name)
        self._dead_all = None
        self.liveness_version += 1

    def recover_link(self, name: str) -> None:
        self.dead_links.discard(name)
        self._dead_all = None
        self.liveness_version += 1

    def fail_switch(self, node: str) -> None:
        if not self.fabric.has_node(node):
            raise ValueError(f"unknown node {node!r}")
        self.dead_switches.add(node)
        self._dead_all = None
        self.liveness_version += 1

    def recover_switch(self, node: str) -> None:
        self.dead_switches.discard(node)
        self._dead_all = None
        self.liveness_version += 1

    def fail_host(self, node: str) -> None:
        """Host crash: its NIC links die with it (kept distinct from
        ``dead_switches`` so 'host crashed' is semantically visible)."""
        if not self.fabric.has_node(node):
            raise ValueError(f"unknown node {node!r}")
        self.dead_hosts.add(node)
        self._dead_all = None
        self.liveness_version += 1

    def recover_host(self, node: str) -> None:
        self.dead_hosts.discard(node)
        self._dead_all = None
        self.liveness_version += 1

    def all_dead_links(self) -> FrozenSet[str]:
        """Explicitly failed links plus every link touching a dead switch
        or crashed host."""
        if self._dead_all is None:
            dead = set(self.dead_links)
            for sw in self.dead_switches:
                dead.update(self.fabric.incident_links(sw))
            for h in self.dead_hosts:
                dead.update(self.fabric.incident_links(h))
            self._dead_all = frozenset(dead)
        return self._dead_all

    def has_failures(self) -> bool:
        return bool(self.dead_links or self.dead_switches or self.dead_hosts)

    # -- liveness serialization (controller crash-recovery) -----------------
    def dump_liveness(self) -> dict:
        """Plain-data liveness overlay for controller snapshots (DESIGN.md
        §11).  Sets are dumped sorted so the bytes are deterministic; the
        path engine's caches are pure memoization and are not serialized —
        a restored plane recomputes identical candidates cold."""
        return {
            "dead_links": sorted(self.dead_links),
            "dead_switches": sorted(self.dead_switches),
            "dead_hosts": sorted(self.dead_hosts),
            "version": self.liveness_version,
        }

    def load_liveness(self, state: dict) -> None:
        """Restore a :meth:`dump_liveness` overlay in place."""
        self.dead_links = set(state["dead_links"])
        self.dead_switches = set(state["dead_switches"])
        self.dead_hosts = set(state["dead_hosts"])
        self._dead_all = None
        self.liveness_version = state["version"]

    def link_alive(self, name: str) -> bool:
        return name not in self.all_dead_links()

    def host_alive(self, node: str) -> bool:
        """A host can send/receive iff it is up and has a live incident link."""
        if node in self.dead_switches or node in self.dead_hosts:
            return False
        dead = self.all_dead_links()
        return any(l not in dead for l in self.fabric.incident_links(node))

    # -- routing ------------------------------------------------------------
    def candidates(
        self, src: str, dst: str, k: Optional[int] = None
    ) -> Tuple[Path, ...]:
        """Surviving candidate paths src→dst (raises UnroutableError)."""
        down = self.dead_switches
        if (src in down or dst in down
                or src in self.dead_hosts or dst in self.dead_hosts):
            raise UnroutableError(f"endpoint down: {src!r} -> {dst!r}")
        return self.engine.route(src, dst, self.all_dead_links(), k=k)

    def candidates_batch(
        self, pairs: Sequence[Tuple[str, str]], k: Optional[int] = None
    ) -> Dict[Tuple[str, str], Tuple[Path, ...]]:
        """Surviving candidates for many pairs in one engine pass.

        Pairs with a dead endpoint or no surviving path map to ``()``
        instead of raising — the batched reroute engine drops dead
        replicas per victim and raises only when a victim has none left.
        """
        dead = self.all_dead_links()
        down = self.dead_switches | self.dead_hosts
        live = [p for p in pairs if p[0] not in down and p[1] not in down]
        out = self.engine.route_batch(live, dead, k=k)
        for p in pairs:
            out.setdefault(p, ())
        return out

    def usable(self, src: str, dst: str) -> bool:
        try:
            self.candidates(src, dst, k=1)
            return True
        except UnroutableError:
            return False

    def best_path(
        self, ledger: TimeSlotLedger, src: str, dst: str, t: float,
        k: Optional[int] = None,
    ) -> Path:
        """Best surviving path by residual bandwidth at ``t``."""
        cands = self.candidates(src, dst, k=k)
        return cands[self.engine.best(ledger, cands, t)]
