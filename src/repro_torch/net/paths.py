"""k-shortest-path engine — the data plane's multipath routing table.

The control plane (``core.topology.Fabric``) resolves *one* min-hop path
per node pair; real SDN data planes hold several candidates per pair so the
controller can load-balance (ECMP), steer around congestion, and fail over
when a link dies.  This module provides:

* :func:`k_shortest_paths` — Yen's algorithm over a ``Fabric`` with
  hop-count metric.  ``k=1`` returns exactly ``Fabric.path(src, dst)``
  (byte-identical — the regression the tier-1 tests pin), so single-path
  callers lose nothing by routing through the engine.
* :class:`PathEngine` — a per-fabric cache of candidate sets keyed on the
  fabric's mutation ``version``, with dead-link-aware :meth:`route` (the
  failure-rerouting entry) and vectorized scoring: candidates materialize
  as ``[n_paths, n_links]`` incidence rows so one
  :meth:`~repro.core.timeslot.TimeSlotLedger.path_bandwidth_batch` pass
  prices every path.

Ties break deterministically everywhere: Dijkstra relaxes links in sorted
name order with a lexicographic node tie-break (same discipline as
``Fabric.path``), and Yen's candidate pool orders by (hop count, link-name
sequence).
"""
from __future__ import annotations

import heapq
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..core.timeslot import TimeSlotLedger
from ..core.topology import Fabric, UnroutableError  # noqa: F401  (re-export)

Path = Tuple[str, ...]


#: link name -> additive link cost; ``None`` means hop count (cost 1/link),
#: which keeps the historical integer arithmetic bit-for-bit.
LinkCost = Optional[callable]


def _dijkstra(
    fabric: Fabric,
    src: str,
    dst: str,
    banned_links: FrozenSet[str],
    banned_nodes: FrozenSet[str],
    link_cost: LinkCost = None,
) -> Optional[Path]:
    """Min-cost Dijkstra that can exclude links/nodes (Yen spur searches).

    With ``link_cost=None`` (hop metric) this mirrors ``Fabric.path``'s
    relaxation order exactly so that with no exclusions the two agree
    link-for-link; a cost callable generalizes the metric while keeping
    the deterministic tie-breaks (sorted link relaxation, lexicographic
    node order in the heap).
    """
    if src == dst:
        return ()
    inf = float("inf") if link_cost is not None else (1 << 30)
    dist: Dict[str, float] = {src: 0}
    prev: Dict[str, Tuple[str, str]] = {}
    pq: List[Tuple[float, str]] = [(0, src)]
    while pq:
        d, u = heapq.heappop(pq)
        if u == dst:
            break
        if d > dist.get(u, inf):
            continue
        for lname in sorted(fabric.incident_links(u)):
            if lname in banned_links:
                continue
            v = fabric.link(lname).other(u)
            if v in banned_nodes:
                continue
            nd = d + (1 if link_cost is None else link_cost(lname))
            if nd < dist.get(v, inf):
                dist[v] = nd
                prev[v] = (u, lname)
                heapq.heappush(pq, (nd, v))
    if dst not in prev:
        return None
    rev: List[str] = []
    node = dst
    while node != src:
        pnode, via = prev[node]
        rev.append(via)
        node = pnode
    return tuple(reversed(rev))


def k_shortest_paths(
    fabric: Fabric,
    src: str,
    dst: str,
    k: int,
    banned_links: Iterable[str] = (),
    banned_nodes: Iterable[str] = (),
    link_cost: LinkCost = None,
) -> Tuple[Path, ...]:
    """Up to ``k`` loop-free min-cost paths src→dst (Yen's algorithm).

    The metric is hop count unless ``link_cost`` gives a per-link additive
    cost.  Fewer than ``k`` paths are returned when the graph holds fewer;
    :class:`UnroutableError` is raised when there is none at all.  With no
    exclusions and the hop metric the first path is
    ``Fabric.path(src, dst)`` verbatim.
    """
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    bl, bn = frozenset(banned_links), frozenset(banned_nodes)
    if src == dst:
        return ((),)
    if not bl and not bn and link_cost is None:
        first: Optional[Path] = fabric.path(src, dst)
    else:
        first = _dijkstra(fabric, src, dst, bl, bn, link_cost)
    if first is None:
        raise UnroutableError(f"no surviving path {src!r} -> {dst!r}")

    def path_cost(p: Path) -> float:
        # Hop metric: cost == len(p), so the historical (hops, path) pool
        # key survives as the degenerate case of (cost, hops, path).
        return len(p) if link_cost is None else sum(link_cost(l) for l in p)

    found: List[Path] = [first]
    seen = {first}
    pool: List[Tuple[float, int, Path]] = []  # (cost, hops, path) heap
    while len(found) < k:
        prev_path = found[-1]
        prev_nodes = fabric.path_nodes(src, prev_path)
        for j in range(len(prev_path)):
            spur_node = prev_nodes[j]
            root = prev_path[:j]
            # Paths already found that share this root may not be rediscovered:
            # ban their next link out of the spur node.
            spur_bl = set(bl)
            for p in found:
                if len(p) > j and p[:j] == root:
                    spur_bl.add(p[j])
            spur_bn = bn | set(prev_nodes[:j])
            spur = _dijkstra(fabric, spur_node, dst, frozenset(spur_bl),
                             spur_bn, link_cost)
            if spur is None:
                continue
            cand = root + spur
            if cand not in seen:
                seen.add(cand)
                heapq.heappush(pool, (path_cost(cand), len(cand), cand))
        if not pool:
            break
        _, _, best = heapq.heappop(pool)
        found.append(best)
    return tuple(found)


class PathEngine:
    """Cached k-shortest-path candidate sets over one :class:`Fabric`.

    Caches key on ``(src, dst, k)`` and are dropped wholesale whenever the
    fabric's ``version`` moves (link added) — the engine can never serve a
    pre-mutation path.

    ``cost`` selects the path metric:

    * ``"hop"`` (default) — hop count; byte-identical to the historical
      engine, and ``k=1`` returns ``Fabric.path`` verbatim.
    * ``"ospf"`` — OSPF-style inverse capacity (``ref_bw / capacity``,
      ``ref_bw`` = the fabric's fattest link), static per fabric version.
      On uniform-capacity fabrics every link costs 1.0 and the metric
      degenerates to hop count, tie-breaks included.
    * ``"residual"`` — inverse *residual* bandwidth against a live ledger
      at query time ``self.at`` (``ref_bw / max(residual_bw, eps)``):
      congested links price up and enumeration steers around bookings.
      Requires ``ledger=``; candidate sets are recomputed per call (the
      metric moves with the ledger) so this mode trades the cache for
      freshness — use it for explicit what-if queries, not hot paths.
    """

    COSTS = ("hop", "ospf", "residual")

    def __init__(self, fabric: Fabric, k: int = 4, cost: str = "hop",
                 ledger: Optional[TimeSlotLedger] = None) -> None:
        if cost not in self.COSTS:
            raise ValueError(f"cost must be one of {self.COSTS}, got {cost!r}")
        if cost == "residual" and ledger is None:
            raise ValueError('cost="residual" needs a ledger to read from')
        self.fabric = fabric
        self.k = int(k)
        self.cost = cost
        self.ledger = ledger
        #: Query time for the ``"residual"`` metric (sim seconds).
        self.at = 0.0
        self._cache: Dict[Tuple[str, str, int], Tuple[Path, ...]] = {}
        # Detour results under a specific dead-link set; keyed on the set
        # so liveness changes miss naturally (and the fast path below never
        # consults it).
        self._fail_cache: Dict[
            Tuple[str, str, int, FrozenSet[str]], Tuple[Path, ...]
        ] = {}
        # Surviving-candidate filter results keyed on the dead set — the
        # failure-storm hot path asks for the same pair under the same
        # overlay thousands of times per event.
        self._alive_cache: Dict[
            Tuple[str, str, int, FrozenSet[str]], Tuple[Path, ...]
        ] = {}
        # Dead-set-aware incidence: per candidate set, each path's links as
        # an integer id array (engine-local link index), so one boolean
        # gather prices a whole dead set against every candidate.
        self._link_idx: Dict[str, int] = {
            n: i for i, n in enumerate(sorted(fabric.links))
        }
        self._path_ids: Dict[Tuple[str, str, int], Tuple[np.ndarray, ...]] = {}
        self._version = fabric.version

    def _fresh(self) -> None:
        if self.fabric.version != self._version:
            self._cache.clear()
            self._fail_cache.clear()
            self._alive_cache.clear()
            self._path_ids.clear()
            self._link_idx = {
                n: i for i, n in enumerate(sorted(self.fabric.links))
            }
            self._version = self.fabric.version

    def _ids(self, src: str, dst: str, kk: int) -> Tuple[np.ndarray, ...]:
        """Each cached candidate's links as an id array (incidence rows)."""
        key = (src, dst, kk)
        hit = self._path_ids.get(key)
        if hit is None:
            li = self._link_idx
            hit = tuple(
                np.fromiter((li[n] for n in p), dtype=np.intp, count=len(p))
                for p in self.paths(src, dst, kk)
            )
            self._path_ids[key] = hit
        return hit

    def dead_vector(self, dead_links: Iterable[str]) -> np.ndarray:
        """Boolean liveness vector over the engine's link index."""
        vec = np.zeros(len(self._link_idx), dtype=bool)
        li = self._link_idx
        for n in dead_links:
            i = li.get(n)
            if i is not None:
                vec[i] = True
        return vec

    def _link_cost(self) -> LinkCost:
        """The engine's metric as a per-link cost callable (None = hop)."""
        if self.cost == "hop":
            return None
        fab = self.fabric
        caps = {n: fab.link(n).capacity for n in fab.links}
        ref = max(caps.values())
        if self.cost == "ospf":
            return lambda l: ref / caps[l]
        led, at = self.ledger, self.at
        eps = 1e-9

        def residual(l: str) -> float:
            bw = led.path_bandwidth(led.rows((l,)), at)
            return ref / (bw if bw > eps else eps)

        return residual

    def paths(self, src: str, dst: str, k: Optional[int] = None) -> Tuple[Path, ...]:
        """The cached candidate set (all links assumed alive).

        The ``"residual"`` metric bypasses the cache: its costs move with
        the ledger, so every call re-enumerates at the current ``at``."""
        kk = self.k if k is None else int(k)
        self._fresh()
        if self.cost == "residual":
            return k_shortest_paths(self.fabric, src, dst, kk,
                                    link_cost=self._link_cost())
        key = (src, dst, kk)
        hit = self._cache.get(key)
        if hit is None:
            hit = k_shortest_paths(self.fabric, src, dst, kk,
                                   link_cost=self._link_cost())
            self._cache[key] = hit
        return hit

    def route(
        self,
        src: str,
        dst: str,
        dead_links: Iterable[str] = (),
        k: Optional[int] = None,
    ) -> Tuple[Path, ...]:
        """Surviving candidates src→dst given ``dead_links``.

        Fast path: filter the cached candidate set.  If every cached
        candidate died, re-run Yen with the dead links excluded — a detour
        longer than the cached k-set can still exist.  Raises
        :class:`UnroutableError` when nothing survives.
        """
        dead = frozenset(dead_links)
        cands = self.paths(src, dst, k)
        if not dead:
            return cands
        kk = self.k if k is None else int(k)
        hit = self._alive(src, dst, kk, dead, None)
        if not hit:
            raise UnroutableError(f"no surviving path {src!r} -> {dst!r}")
        return hit

    def _alive(
        self,
        src: str,
        dst: str,
        kk: int,
        dead: FrozenSet[str],
        dead_vec: Optional[np.ndarray],
    ) -> Tuple[Path, ...]:
        """Cached surviving-candidate lookup shared by :meth:`route` and
        :meth:`route_batch` (one eviction bound, one key shape — the two
        entry points can never drift apart)."""
        key = (src, dst, kk, dead)
        hit = self._alive_cache.get(key)
        if hit is None:
            if dead_vec is None:
                dead_vec = self.dead_vector(dead)
            hit = self._survivors(src, dst, kk, dead, dead_vec)
            if len(self._alive_cache) > (1 << 18):
                self._alive_cache.clear()
            self._alive_cache[key] = hit
        return hit

    def _survivors(
        self,
        src: str,
        dst: str,
        kk: int,
        dead: FrozenSet[str],
        dead_vec: np.ndarray,
    ) -> Tuple[Path, ...]:
        """Incidence-filtered surviving candidates; Yen detour fallback.

        Returns ``()`` when *nothing* survives — cached too, so a pair
        proven unroutable under this dead set costs one dict hit on every
        later ask (the failure-storm candidate enumeration re-asks)."""
        cands = self.paths(src, dst, kk)
        ids = self._ids(src, dst, kk)
        alive = tuple(
            p for p, pid in zip(cands, ids)
            if not pid.size or not dead_vec[pid].any()
        )
        if alive:
            return alive
        key = (src, dst, kk, dead)
        hit = self._fail_cache.get(key)
        if hit is None:
            try:
                hit = k_shortest_paths(
                    self.fabric, src, dst, kk, banned_links=dead,
                    link_cost=self._link_cost(),
                )
            except UnroutableError:
                hit = ()
            if len(self._fail_cache) > (1 << 18):
                self._fail_cache.clear()  # bound flap-accumulated detours
            self._fail_cache[key] = hit
        return hit

    def route_batch(
        self,
        pairs: Sequence[Tuple[str, str]],
        dead_links: Iterable[str] = (),
        k: Optional[int] = None,
    ) -> Dict[Tuple[str, str], Tuple[Path, ...]]:
        """Surviving candidates for many endpoint pairs under one dead set.

        One liveness vector prices every pair's cached incidence rows; the
        per-(pair, dead-set) results land in the same cache :meth:`route`
        consults, so a failure storm's repeated pairs are one dict hit
        each.  Unroutable pairs map to ``()`` instead of raising — batch
        callers decide per pair (the reroute engine drops dead replicas
        from a candidate set and raises only when *every* replica died).
        """
        self._fresh()
        dead = frozenset(dead_links)
        kk = self.k if k is None else int(k)
        out: Dict[Tuple[str, str], Tuple[Path, ...]] = {}
        dead_vec: Optional[np.ndarray] = None
        if dead:
            dead_vec = self.dead_vector(dead)
        for src, dst in pairs:
            if (src, dst) in out:
                continue
            if not dead:
                try:
                    out[(src, dst)] = self.paths(src, dst, kk)
                except UnroutableError:
                    out[(src, dst)] = ()
                continue
            out[(src, dst)] = self._alive(src, dst, kk, dead, dead_vec)
        return out

    # -- vectorized scoring -------------------------------------------------
    def incidence(
        self, ledger: TimeSlotLedger, paths: Sequence[Path]
    ) -> np.ndarray:
        """``[n_paths, n_links]`` 0/1 incidence matrix in ledger row order."""
        m = np.zeros((len(paths), len(ledger.capacity)))
        for i, p in enumerate(paths):
            if p:
                m[i, list(ledger.rows(p))] = 1.0
        return m

    def score(
        self, ledger: TimeSlotLedger, paths: Sequence[Path], t: float
    ) -> np.ndarray:
        """Residual path bandwidth of every candidate at ``t`` — one
        :meth:`TimeSlotLedger.path_bandwidth_batch` numpy pass."""
        return ledger.path_bandwidth_batch([ledger.rows(p) for p in paths], t)

    def best(
        self, ledger: TimeSlotLedger, paths: Sequence[Path], t: float
    ) -> int:
        """Index of the best candidate: most residual bandwidth, ties to
        fewer hops then candidate order (Yen order is deterministic)."""
        bws = self.score(ledger, paths, t)
        return min(range(len(paths)), key=lambda i: (-bws[i], len(paths[i]), i))
