"""Per-switch flow tables — transfers represented as OpenFlow-style rules.

The TS ledger answers *when/how much*; the flow tables answer *where*: once
the controller picks a path for a transfer, every node along it gets a
match→out-port rule, exactly the artifact an OpenFlow controller would push
to its switches.  A transfer is therefore inspectable as installed state
(``dump``), not just as ledger rows — and rerouting is the literal SDN
operation of uninstalling one rule set and installing another.

Matches are ``(flow src, flow dst)`` endpoint pairs; the cookie is the
installing transfer's id so a reroute can surgically remove its own rules.
Later installs for the same match win on lookup (higher priority), matching
OpenFlow's overlapping-rule semantics.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Hashable, List, Optional, Sequence, Tuple

from ..core.topology import Fabric


@dataclass(frozen=True)
class FlowRule:
    """One match→action entry in a node's flow table."""

    node: str                   # switch/host holding the rule
    match: Tuple[str, str]      # (flow src, flow dst) endpoint pair
    out_port: str               # link name the packet is forwarded on
    cookie: Hashable            # installing transfer's id
    priority: int = 0           # later installs win (higher priority)


class FlowTable:
    """A single node's flow table.

    Rules are bucketed by cookie (one transfer = one cookie, and a node
    appears at most once on a path), so the reroute storm's mass
    uninstalls are one dict pop instead of a scan of every rule the node
    carries.  Bucket order is install order, so ``dump``/``lookup``
    iterate rules exactly as the historical flat list did.
    """

    def __init__(self, node: str) -> None:
        self.node = node
        self._rules: Dict[Hashable, List[FlowRule]] = {}
        self._n = 0

    def install(self, rule: FlowRule) -> None:
        self._rules.setdefault(rule.cookie, []).append(rule)
        self._n += 1

    def uninstall(self, cookie: Hashable) -> int:
        gone = len(self._rules.pop(cookie, ()))
        self._n -= gone
        return gone

    def lookup(self, src: str, dst: str) -> Optional[FlowRule]:
        """Highest-priority rule matching the endpoint pair (ties: latest)."""
        hits = [r for rs in self._rules.values() for r in rs
                if r.match == (src, dst)]
        if not hits:
            return None
        return max(enumerate(hits), key=lambda ir: (ir[1].priority, ir[0]))[1]

    def dump(self) -> List[FlowRule]:
        return [r for rs in self._rules.values() for r in rs]

    def __len__(self) -> int:
        return self._n


class FlowTables:
    """All nodes' flow tables + path compilation (the controller's rule base)."""

    def __init__(self, fabric: Fabric) -> None:
        self.fabric = fabric
        self._tables: Dict[str, FlowTable] = {}
        # cookie → nodes holding its rules, so a reroute storm's mass
        # uninstalls touch only the tables that actually carry the cookie
        # instead of scanning every table in the fabric.
        self._cookie_nodes: Dict[Hashable, Tuple[str, ...]] = {}
        self._prio = 0

    def table(self, node: str) -> FlowTable:
        if node not in self._tables:
            if not self.fabric.has_node(node):
                raise ValueError(f"unknown node {node!r}")
            self._tables[node] = FlowTable(node)
        return self._tables[node]

    # -- rule lifecycle -----------------------------------------------------
    def install_path(
        self, cookie: Hashable, src: str, dst: str, links: Sequence[str]
    ) -> List[FlowRule]:
        """Compile a link path into per-hop rules and install them.

        Every node on the path except the destination gets a
        ``(src, dst) → next link`` rule; one transfer = one cookie, so the
        whole set uninstalls atomically.
        """
        nodes = self.fabric.path_nodes(src, links)
        self._prio += 1
        out = []
        for hop, link in zip(nodes[:-1], links):
            rule = FlowRule(hop, (src, dst), link, cookie, priority=self._prio)
            self.table(hop).install(rule)
            out.append(rule)
        held = self._cookie_nodes.get(cookie, ())
        self._cookie_nodes[cookie] = held + tuple(nodes[:-1])
        return out

    def uninstall(self, cookie: Hashable) -> int:
        """Remove every rule the cookie installed; returns the count."""
        nodes = self._cookie_nodes.pop(cookie, ())
        return sum(
            self._tables[n].uninstall(cookie) for n in dict.fromkeys(nodes)
        )

    # -- full-state serialization (controller crash-recovery) ---------------
    def dump_state(self) -> dict:
        """Plain-data serialization of every installed rule, preserving
        table order, per-cookie bucket order and the priority counter, so
        :meth:`load_state` rebuilds tables whose ``dump``/``lookup``/
        ``trace`` answers are byte-identical (DESIGN.md §11)."""
        return {
            "tables": [
                (
                    node,
                    [
                        (cookie, [(r.match, r.out_port, r.priority)
                                  for r in rules])
                        for cookie, rules in t._rules.items()
                    ],
                )
                for node, t in self._tables.items()
            ],
            "cookie_nodes": list(self._cookie_nodes.items()),
            "prio": self._prio,
        }

    def load_state(self, state: dict) -> None:
        """Restore a :meth:`dump_state` dict in place (replaces every
        currently-installed rule)."""
        self._tables = {}
        for node, buckets in state["tables"]:
            t = self.table(node)
            for cookie, rules in buckets:
                for match, out_port, priority in rules:
                    t.install(FlowRule(node, tuple(match), out_port, cookie,
                                       priority=priority))
        self._cookie_nodes = {c: tuple(ns) for c, ns in state["cookie_nodes"]}
        self._prio = state["prio"]

    # -- inspection ---------------------------------------------------------
    def dump(self, node: Optional[str] = None) -> List[FlowRule]:
        if node is not None:
            return self.table(node).dump()
        return [r for n in sorted(self._tables) for r in self._tables[n].dump()]

    def lookup(self, node: str, src: str, dst: str) -> Optional[FlowRule]:
        return self.table(node).lookup(src, dst)

    def trace(self, src: str, dst: str, max_hops: int = 64) -> Tuple[str, ...]:
        """Follow installed rules hop-by-hop from ``src``; returns the link
        sequence actually programmed into the data plane (what a packet
        would traverse).  Raises if the rules don't reach ``dst``."""
        cur, out = src, []
        for _ in range(max_hops):
            if cur == dst:
                return tuple(out)
            rule = self.lookup(cur, src, dst)
            if rule is None:
                raise LookupError(
                    f"no rule for ({src!r}, {dst!r}) at {cur!r} after {out}"
                )
            out.append(rule.out_port)
            cur = self.fabric.link(rule.out_port).other(cur)
        raise LookupError(f"rule loop tracing ({src!r}, {dst!r}): {out}")

    def n_rules(self) -> int:
        return sum(len(t) for t in self._tables.values())
