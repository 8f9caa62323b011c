"""Fabric topology model — the SDN controller's global network view.

The paper's OpenFlow controller knows every link and its real-time residual
bandwidth.  ``Fabric`` is that view: a graph of nodes (compute hosts, switches,
routers) and directed-capacity links, with shortest-path routing resolved once
and cached.  Builders are provided for

* the paper's Fig. 2 testbed (4 workers, 2 OpenFlow switches, 1 router),
* generic two-tier leaf/spine clusters (Table-I-scale experiments), and
* TPU-fleet DCN fabrics (hosts per pod, pods per fleet) used by the training
  control plane — ICI inside a pod is compiler-scheduled and is *not* modelled
  here (see DESIGN.md §2).

Bandwidths are in Mbps for the Hadoop experiments (paper units) but the class
is unit-agnostic: ``bytes/sec`` works equally for the DCN builders.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


class UnroutableError(ValueError):
    """No (surviving) path exists between two endpoints.

    Raised by ``Fabric.path`` on disconnected pairs and by the routing
    layer — ``repro.net.paths`` and the controller's failure-aware
    rerouting — when every candidate path is down.  Subclasses
    ``ValueError`` (the historical ``Fabric.path`` exception) so existing
    callers keep working.  Defined here so ``core`` can raise/catch it
    without importing ``net``.
    """


@dataclass(frozen=True)
class Link:
    """An undirected link with a symmetric capacity (paper's model)."""

    name: str
    a: str
    b: str
    capacity: float  # bandwidth units (Mbps in the paper)

    def other(self, node: str) -> str:
        return self.b if node == self.a else self.a


class Fabric:
    """Graph of nodes + links with cached shortest paths (hop-count metric).

    The SDN controller's view: every link is known, and a path between any two
    nodes resolves to the ordered list of link names whose time-slot calendars
    must be reserved together (paper §IV.A: path residue = min over links).
    """

    #: Node roles: ``host`` (compute/storage endpoint — schedulable),
    #: ``switch`` (forwarding only), ``infra`` (master/controller — carries
    #: no data traffic and must never join the worker set).
    ROLES = ("host", "switch", "infra")

    def __init__(self) -> None:
        self._links: Dict[str, Link] = {}
        self._adj: Dict[str, List[str]] = {}
        self._roles: Dict[str, str] = {}
        self._path_cache: Dict[Tuple[str, str], Tuple[str, ...]] = {}
        self._parent: Dict[str, Tuple[str, str]] = {}  # child -> (parent, link)
        self._nontree_links: set = set()  # links added outside add_uplink
        self._version = 0

    # -- construction -----------------------------------------------------
    def add_node(self, name: str, role: Optional[str] = None) -> None:
        """Register a node.  ``role`` tags it explicitly (``host`` |
        ``switch`` | ``infra``); new nodes default to ``host``, and passing
        a role re-tags an existing node (builders promote switches that were
        first seen as uplink parents)."""
        if role is not None and role not in self.ROLES:
            raise ValueError(f"unknown node role {role!r} (want one of {self.ROLES})")
        if name not in self._adj:
            self._adj[name] = []
            self._roles[name] = role or "host"
        elif role is not None:
            self._roles[name] = role

    def add_link(self, name: str, a: str, b: str, capacity: float) -> None:
        if name in self._links:
            raise ValueError(f"duplicate link {name!r}")
        self.add_node(a)
        self.add_node(b)
        self._links[name] = Link(name, a, b, capacity)
        self._adj[a].append(name)
        self._adj[b].append(name)
        # Mutation invalidates every cached routing artifact: the Dijkstra
        # path cache AND the tree-LCA shortcut — a cross link can make tree
        # walks non-minimal, so any non-uplink edge disables them for good
        # (``add_uplink`` re-registers its edge as a tree edge below).
        self._path_cache.clear()
        self._nontree_links.add(name)
        self._version += 1

    def add_uplink(
        self,
        name: str,
        child: str,
        parent: str,
        capacity: float,
        role: Optional[str] = None,
    ) -> None:
        """Tree edge: enables O(depth) LCA routing (all builders are trees).

        Paths between tree members avoid per-pair Dijkstra — essential at
        4 000+ hosts where the controller routes tens of thousands of flows.

        ``role`` tags the *child* (default ``host``; a child already tagged,
        e.g. a switch first seen as some other uplink's parent, keeps its
        tag).  The parent is tagged ``switch`` when first seen — uplink
        parents forward traffic by construction.
        """
        self.add_node(parent, "switch" if parent not in self._adj else None)
        self.add_node(child, role)
        self.add_link(name, child, parent, capacity)
        self._nontree_links.discard(name)
        self._parent[child] = (parent, name)

    # -- queries -----------------------------------------------------------
    @property
    def version(self) -> int:
        """Monotonic mutation counter — path engines key their caches on it."""
        return self._version

    @property
    def links(self) -> Dict[str, Link]:
        return dict(self._links)

    @property
    def nodes(self) -> List[str]:
        return list(self._adj)

    def role(self, name: str) -> str:
        """The node's explicit role tag (``host`` | ``switch`` | ``infra``)."""
        return self._roles[name]

    def nodes_with_role(self, role: str) -> List[str]:
        return [n for n in self._adj if self._roles[n] == role]

    def link(self, name: str) -> Link:
        return self._links[name]

    def has_node(self, name: str) -> bool:
        return name in self._adj

    def incident_links(self, node: str) -> Tuple[str, ...]:
        """Names of every link touching ``node`` (insertion order)."""
        return tuple(self._adj[node])

    def neighbors(self, node: str) -> Tuple[str, ...]:
        return tuple(self._links[l].other(node) for l in self._adj[node])

    def path_nodes(self, src: str, links: Sequence[str]) -> Tuple[str, ...]:
        """Node sequence visited by walking ``links`` (a path) from ``src``."""
        out = [src]
        cur = src
        for name in links:
            cur = self._links[name].other(cur)
            out.append(cur)
        return tuple(out)

    def path(self, src: str, dst: str) -> Tuple[str, ...]:
        """Ordered link names on the min-hop path src→dst.

        Tree members resolve via an LCA walk in O(depth); general graphs
        fall back to hop-count Dijkstra with a path cache.
        """
        if src == dst:
            return ()
        tree = self._tree_path(src, dst)
        if tree is not None:
            return tree
        key = (src, dst)
        cached = self._path_cache.get(key)
        if cached is not None:
            return cached
        # Dijkstra with hop-count metric; deterministic tie-break on node name.
        dist: Dict[str, int] = {src: 0}
        prev: Dict[str, Tuple[str, str]] = {}  # node -> (prev node, via link)
        pq: List[Tuple[int, str]] = [(0, src)]
        while pq:
            d, u = heapq.heappop(pq)
            if u == dst:
                break
            if d > dist.get(u, 1 << 30):
                continue
            for lname in sorted(self._adj[u]):
                link = self._links[lname]
                v = link.other(u)
                nd = d + 1
                if nd < dist.get(v, 1 << 30):
                    dist[v] = nd
                    prev[v] = (u, lname)
                    heapq.heappush(pq, (nd, v))
        if dst not in prev and dst != src:
            raise UnroutableError(f"no path {src!r} -> {dst!r}")
        rev: List[str] = []
        node = dst
        while node != src:
            pnode, via = prev[node]
            rev.append(via)
            node = pnode
        out = tuple(reversed(rev))
        self._path_cache[key] = out
        return out

    def _tree_path(self, src: str, dst: str) -> Optional[Tuple[str, ...]]:
        """LCA path when both endpoints live in the builder's tree.

        Declines (→ Dijkstra fallback) as soon as any non-uplink edge
        exists: a cross link can shorten paths the tree walk would miss
        (the ``add_link``-after-``path()`` staleness bug).
        """
        par = self._parent
        if not par or self._nontree_links:
            return None
        # Ancestor chains (node, link-to-parent) up to the root.
        def chain(n: str) -> Optional[List[Tuple[str, str]]]:
            out = []
            seen = {n}
            while n in par:
                p, l = par[n]
                out.append((p, l))
                if p in seen:
                    return None  # defensive: not a tree
                seen.add(p)
                n = p
            return out

        ca, cb = chain(src), chain(dst)
        if ca is None or cb is None:
            return None
        roots_a = {src} | {p for p, _ in ca}
        roots_b = {dst} | {p for p, _ in cb}
        if (ca and cb and ca[-1][0] != cb[-1][0]) and not (
            dst in roots_a or src in roots_b
        ):
            return None  # different trees
        if dst in roots_a:
            up = []
            n = src
            while n != dst:
                p, l = par[n]
                up.append(l)
                n = p
            return tuple(up)
        if src in roots_b:
            down = []
            n = dst
            while n != src:
                p, l = par[n]
                down.append(l)
                n = p
            return tuple(reversed(down))
        anc_b = {dst: 0}
        for i, (p, _) in enumerate(cb):
            anc_b[p] = i + 1
        up = []
        n = src
        while n not in anc_b:
            if n not in par:
                return None
            p, l = par[n]
            up.append(l)
            n = p
        down = [l for _, l in cb[: anc_b[n]]]
        return tuple(up + list(reversed(down)))

    def tree_routing_ok(self) -> bool:
        """True when LCA tree walks are valid routing (every link is an
        uplink) — the precondition under which :meth:`parent_chain` lets a
        caller resolve min-hop paths without touching Dijkstra.  Mirrors
        the gate inside :meth:`_tree_path`, so external fast-path routers
        (``core.wavefront``) agree with :meth:`path` on when the shortcut
        applies."""
        return bool(self._parent) and not self._nontree_links

    def parent_chain(self, node: str) -> Tuple[Tuple[str, str], ...]:
        """``((parent, uplink-name), …)`` from ``node`` up to its tree
        root (empty for a root).  With :meth:`tree_routing_ok`, the
        min-hop path ``a→b`` is ``a``'s chain up to the lowest common
        ancestor followed by ``b``'s chain below it, reversed — exactly
        what :meth:`path` computes."""
        out = []
        n = node
        seen = {n}
        while n in self._parent:
            p, link = self._parent[n]
            out.append((p, link))
            if p in seen:  # defensive: parent links form a cycle
                raise ValueError(f"parent chain of {node!r} is not a tree")
            seen.add(p)
            n = p
        return tuple(out)

    def path_capacity(self, src: str, dst: str) -> float:
        """Static bottleneck capacity of the src→dst path."""
        names = self.path(src, dst)
        if not names:
            return float("inf")
        return min(self._links[n].capacity for n in names)


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------

def paper_fig2_fabric(link_mbps: float = 100.0) -> Fabric:
    """The Fig. 2 testbed: 4 worker nodes, 2 OpenFlow switches, a router.

    Link naming follows the paper: Link1..Link4 are node uplinks, Link7/Link8
    the switch→router trunks ("we may also choose ND3 … Link 1, Link 7, Link 8
    and Link 3"), Link5/Link6 the master/controller uplinks (no data traffic).
    """
    f = Fabric()
    f.add_uplink("Link1", "N1", "SwA", link_mbps)
    f.add_uplink("Link2", "N2", "SwA", link_mbps)
    f.add_uplink("Link3", "N3", "SwB", link_mbps)
    f.add_uplink("Link4", "N4", "SwB", link_mbps)
    f.add_uplink("Link5", "Master", "Router", link_mbps, role="infra")
    f.add_uplink("Link6", "Controller", "Router", link_mbps, role="infra")
    f.add_uplink("Link7", "SwA", "Router", link_mbps)
    f.add_uplink("Link8", "SwB", "Router", link_mbps)
    return f


def two_tier_fabric(
    n_leaves: int,
    hosts_per_leaf: int,
    host_mbps: float = 100.0,
    trunk_mbps: float = 1000.0,
) -> Fabric:
    """Generic leaf/spine: hosts ``H<i>`` under leaves ``Sw<j>`` under one spine."""
    f = Fabric()
    for j in range(n_leaves):
        f.add_uplink(f"Trunk{j}", f"Sw{j}", "Spine", trunk_mbps, role="switch")
        for i in range(hosts_per_leaf):
            h = j * hosts_per_leaf + i
            f.add_uplink(f"Up{h}", f"H{h}", f"Sw{j}", host_mbps)
    return f


def tpu_dcn_fabric(
    n_pods: int,
    hosts_per_pod: int,
    nic_gbytes: float = 25e9,
    pod_trunk_gbytes: float = 400e9,
) -> Fabric:
    """TPU-fleet DCN view: hosts ``pod<p>/host<h>`` behind per-pod aggregation.

    Capacities in bytes/s (defaults: 25 GB/s NIC, 400 GB/s pod trunk), so
    transfer sizes are plain bytes.  ICI inside a pod is *not* modelled here (XLA's job);
    this fabric carries input shards, cross-pod grad sync, KV migration and
    checkpoint traffic — the flows BASS actually controls.
    """
    f = Fabric()
    for p in range(n_pods):
        agg = f"pod{p}/agg"
        f.add_uplink(f"pod{p}/trunk", agg, "dcn-core", pod_trunk_gbytes, role="switch")
        for h in range(hosts_per_pod):
            name = f"pod{p}/host{h}"
            f.add_uplink(f"pod{p}/nic{h}", name, agg, nic_gbytes)
    return f


def storage_hosts(fabric: Fabric) -> List[str]:
    """Compute/storage endpoints — nodes explicitly tagged ``role="host"``.

    The role tag is set at construction (``add_node``/``add_uplink``), so
    new builders cannot silently leak switches or infra nodes into the
    worker set the way the old name-prefix filter could.
    """
    return fabric.nodes_with_role("host")
