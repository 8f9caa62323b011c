"""Multipath topology builders — fabrics with genuine path diversity.

Every builder in ``core.topology`` is a tree: one path per pair, nothing to
load-balance, nothing to fail over to.  These builders produce the
data-center shapes the multipath engine exists for:

* :func:`fat_tree_fabric` — the standard k-ary fat-tree (Al-Fares et al.,
  SIGCOMM'08): ``k`` pods of ``k/2`` edge + ``k/2`` aggregation switches,
  ``(k/2)²`` cores, full bisection bandwidth, ``(k/2)²`` equal-cost paths
  between hosts in different pods.
* :func:`oversubscribed_leaf_spine` — a two-tier Clos where every leaf
  uplinks to every spine; host:uplink capacity ratio sets the wired
  oversubscription, and ``n_spines`` sets the path diversity (ECMP width).

Both are built from raw ``add_link`` edges (they are not trees), so
``Fabric.path`` transparently uses Dijkstra and the k-shortest engine sees
every parallel path.  Naming is deterministic; roles are tagged so
``storage_hosts`` returns exactly the compute endpoints.

:func:`pod_partition` derives the pod structure back *out* of a built
fabric — which links are pod-internal, which cross the core — so the
hierarchical controller (``core.hierarchy``) can shard its ledger and
host ownership along the topology instead of guessing.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from ..core.topology import Fabric


def fat_tree_fabric(k: int, link_mbps: float = 100.0) -> Fabric:
    """k-ary fat-tree: ``k`` pods, ``k²/4`` cores, ``k³/4`` hosts.

    Nodes: hosts ``pod<p>/h<e>_<i>``, edge ``pod<p>/edge<e>``, aggregation
    ``pod<p>/agg<a>``, cores ``core<g>_<j>`` (group ``g`` wires to agg
    index ``g`` of every pod).  All links share one capacity — the classic
    rearrangeably-nonblocking configuration.
    """
    if k < 2 or k % 2:
        raise ValueError(f"fat-tree arity must be even and >= 2, got {k}")
    half = k // 2
    f = Fabric()
    for g in range(half):
        for j in range(half):
            f.add_node(f"core{g}_{j}", "switch")
    for p in range(k):
        for a in range(half):
            agg = f"pod{p}/agg{a}"
            f.add_node(agg, "switch")
            for j in range(half):
                f.add_link(f"ac/p{p}a{a}c{j}", agg, f"core{a}_{j}", link_mbps)
        for e in range(half):
            edge = f"pod{p}/edge{e}"
            f.add_node(edge, "switch")
            for a in range(half):
                f.add_link(f"ea/p{p}e{e}a{a}", edge, f"pod{p}/agg{a}", link_mbps)
            for i in range(half):
                host = f"pod{p}/h{e}_{i}"
                f.add_node(host, "host")
                f.add_link(f"eh/p{p}e{e}h{i}", host, edge, link_mbps)
    return f


@dataclass(frozen=True)
class PodPartition:
    """Topology-derived pod structure of a fabric.

    * ``pods`` — pod ids, sorted (the ``podN`` prefix of the node names);
    * ``pod_links[p]`` — link names with *both* endpoints inside pod ``p``
      (edge–host and edge–agg tiers of a fat-tree, host NICs of a DCN pod);
    * ``boundary_links`` — every remaining link: at least one endpoint is a
      core/spine node or the endpoints live in different pods.  Exactly the
      links a cross-pod path must traverse — the root controller's slice;
    * ``pod_hosts[p]`` / ``host_pod`` — host ownership both ways.

    The shard contract (DESIGN.md §12): ``pod_links`` are pairwise disjoint,
    disjoint from ``boundary_links``, and their union is ``fabric.links`` —
    so a per-pod ledger shard plus the boundary shard partition the flat
    ledger's rows with nothing shared and nothing dropped, and any path
    between same-pod hosts stays inside that pod's shard.
    """

    pods: Tuple[str, ...]
    pod_links: Dict[str, Tuple[str, ...]]
    boundary_links: Tuple[str, ...]
    pod_hosts: Dict[str, Tuple[str, ...]]
    host_pod: Dict[str, str]

    def pod_of(self, host: str) -> Optional[str]:
        return self.host_pod.get(host)

    def groups(self) -> Dict[str, Tuple[str, ...]]:
        """Shard name → link names, boundary shard included — the exact
        ``groups`` argument ``timeslot.ShardedLedger`` takes."""
        out = dict(self.pod_links)
        out["__boundary__"] = self.boundary_links
        return out


def _node_pod(name: str) -> Optional[str]:
    """Pod id of a node by naming convention: ``pod<p>/...`` → ``pod<p>``.

    Every pod-structured builder in this repo (``fat_tree_fabric`` here,
    ``tpu_dcn_fabric`` in ``core.topology``) names pod members with a
    ``podN/`` prefix; cores/spines (``core0_1``, ``dcn-core``) carry none.
    """
    if name.startswith("pod"):
        head, sep, _ = name.partition("/")
        if sep:
            return head
    return None


def pod_partition(fabric: Fabric) -> PodPartition:
    """Classify a fabric's links and hosts into pods by topology.

    A link is pod-internal iff both endpoints resolve to the same pod;
    everything else (core uplinks, anything touching an unpodded switch)
    is a boundary link.  Raises ``ValueError`` when the fabric has no pods
    at all — a flat fabric has nothing to shard.
    """
    pod_links: Dict[str, list] = {}
    boundary: list = []
    for name in sorted(fabric.links):
        link = fabric.link(name)
        pa, pb = _node_pod(link.a), _node_pod(link.b)
        if pa is not None and pa == pb:
            pod_links.setdefault(pa, []).append(name)
        else:
            boundary.append(name)
    if not pod_links:
        raise ValueError("fabric has no pod-structured links to partition")
    pod_hosts: Dict[str, list] = {p: [] for p in pod_links}
    host_pod: Dict[str, str] = {}
    for name in sorted(fabric.nodes):
        if fabric.role(name) != "host":
            continue
        p = _node_pod(name)
        if p is not None and p in pod_hosts:
            pod_hosts[p].append(name)
            host_pod[name] = p
    pods = tuple(sorted(pod_links))
    return PodPartition(
        pods=pods,
        pod_links={p: tuple(v) for p, v in pod_links.items()},
        boundary_links=tuple(boundary),
        pod_hosts={p: tuple(v) for p, v in pod_hosts.items()},
        host_pod=host_pod,
    )


def oversubscribed_leaf_spine(
    n_leaves: int,
    n_spines: int,
    hosts_per_leaf: int,
    host_mbps: float = 100.0,
    spine_mbps: float = 400.0,
) -> Fabric:
    """Two-tier Clos with wired oversubscription.

    Hosts ``H<i>`` under leaves ``Leaf<j>``; every leaf connects to every
    spine (``ls/L<j>S<s>``), giving ``n_spines`` equal-cost leaf-to-leaf
    paths.  Oversubscription ratio =
    ``hosts_per_leaf·host_mbps / (n_spines·spine_mbps)``.  Host naming
    matches ``two_tier_fabric`` (``H0..``) so Table-I-style workloads drop
    in unchanged.
    """
    if n_leaves < 1 or n_spines < 1 or hosts_per_leaf < 1:
        raise ValueError("n_leaves, n_spines, hosts_per_leaf must be >= 1")
    f = Fabric()
    for s in range(n_spines):
        f.add_node(f"Spine{s}", "switch")
    for j in range(n_leaves):
        leaf = f"Leaf{j}"
        f.add_node(leaf, "switch")
        for s in range(n_spines):
            f.add_link(f"ls/L{j}S{s}", leaf, f"Spine{s}", spine_mbps)
        for i in range(hosts_per_leaf):
            h = j * hosts_per_leaf + i
            f.add_node(f"H{h}", "host")
            f.add_link(f"up/H{h}", f"H{h}", leaf, host_mbps)
    return f
