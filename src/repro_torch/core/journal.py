"""Write-ahead journal + full-fidelity snapshots for the controller
(control-plane crash-recovery, DESIGN.md §11).

The paper's centralized SDN controller is a single point of failure: every
scheduling decision, ledger booking and flow rule lives in one process.
This module makes that state *durable* the way real control planes do —
with a write-ahead log of externally-visible mutations plus periodic full
snapshots:

* :class:`Journal` — an append-only log of :class:`JournalRecord` entries.
  ``ClusterController`` appends one record per public entry-point call
  (``submit``, ``inject_flow``, ``fail_*``/``recover_*``, ``straggle``,
  ``reserve_transfer_at``, ``fail_controller``/``recover_controller``,
  ``attach_telemetry``/``attach_heartbeats``, ``run_until``/``run``) with
  the call's *resolved* arguments (``at=None`` defaults are materialized,
  auto-assigned job ids are recorded), so replaying the log through the
  same entry points is a pure function of the records.
* :class:`ControllerSnapshot` — a complete serialization of a controller
  at journal position ``lsn``: event queue + sequence counter, jobs +
  assignments + live speculations (deep-copied together so the
  primary/backup identity links survive), the rolling ledger window,
  dataplane liveness, flow tables + expiry heap, retry/blacklist state,
  telemetry estimator + belief, heartbeat state and the behavioral obs
  counters.  ``ClusterController.snapshot()`` produces one;
  ``ClusterController.recover_from(fabric, snapshot, journal)`` restores
  it and replays ``journal.since(snapshot.lsn)`` — byte-identical to a
  controller that never crashed (property-tested in
  ``tests/test_recovery.py``).

Both containers round-trip through :meth:`to_bytes`/:meth:`from_bytes`
(pickle) so they can be written to disk like a real WAL segment — nothing
here holds a live reference to the fabric, the registry or any callable.
"""
from __future__ import annotations

import pickle
from dataclasses import dataclass, field
from typing import List, Tuple


@dataclass(frozen=True)
class JournalRecord:
    """One journaled entry-point call: ``op`` names the controller method,
    ``args`` are its resolved positional arguments (plain picklable data).
    ``lsn`` is the record's 0-based log sequence number."""

    lsn: int
    op: str
    args: Tuple = ()


@dataclass
class Journal:
    """Append-only write-ahead log of controller entry-point calls."""

    records: List[JournalRecord] = field(default_factory=list)

    @property
    def lsn(self) -> int:
        """The next record's sequence number (== records written so far)."""
        return len(self.records)

    def append(self, op: str, *args) -> JournalRecord:
        rec = JournalRecord(lsn=len(self.records), op=op, args=args)
        self.records.append(rec)
        return rec

    def since(self, lsn: int) -> List[JournalRecord]:
        """Records with sequence number >= ``lsn`` (the replay suffix for a
        snapshot taken at ``lsn``)."""
        return self.records[lsn:]

    def to_bytes(self) -> bytes:
        return pickle.dumps(self.records, protocol=pickle.HIGHEST_PROTOCOL)

    @classmethod
    def from_bytes(cls, data: bytes) -> "Journal":
        return cls(records=pickle.loads(data))

    def __len__(self) -> int:
        return len(self.records)


@dataclass
class ShardedJournal:
    """Per-shard WAL segments under one global sequence (DESIGN.md §12).

    The hierarchical controller journals each entry-point call into the
    *segment* of the shard it touches (a job bound for one pod lands in
    that pod's segment; clock advances and cross-pod placements land in
    the root segment), while ``lsn`` assignment stays global — so each
    segment can be written/shipped independently like a real per-shard WAL
    file, and :meth:`merged` restores the exact total order replay needs.
    """

    #: segment name -> append-ordered records (lsn-increasing within each).
    segments: dict = field(default_factory=dict)
    _next_lsn: int = 0

    ROOT = "__root__"

    @property
    def lsn(self) -> int:
        return self._next_lsn

    def append(self, op: str, *args, shard: str = ROOT) -> JournalRecord:
        rec = JournalRecord(lsn=self._next_lsn, op=op, args=args)
        self._next_lsn += 1
        self.segments.setdefault(shard, []).append(rec)
        return rec

    def segment(self, shard: str) -> List[JournalRecord]:
        return self.segments.get(shard, [])

    def merged(self) -> List[JournalRecord]:
        """All records across segments in global ``lsn`` order — the replay
        stream.  Each segment is already lsn-sorted, so this is a k-way
        merge; sorting the concatenation is equivalent and simpler."""
        out = [r for seg in self.segments.values() for r in seg]
        out.sort(key=lambda r: r.lsn)
        return out

    def since(self, lsn: int) -> List[JournalRecord]:
        return [r for r in self.merged() if r.lsn >= lsn]

    def to_bytes(self) -> bytes:
        return pickle.dumps((self.segments, self._next_lsn),
                            protocol=pickle.HIGHEST_PROTOCOL)

    @classmethod
    def from_bytes(cls, data: bytes) -> "ShardedJournal":
        segments, next_lsn = pickle.loads(data)
        return cls(segments=segments, _next_lsn=next_lsn)

    def __len__(self) -> int:
        return self._next_lsn


@dataclass
class ControllerSnapshot:
    """A full-fidelity controller serialization at journal position ``lsn``.

    ``payload`` is a plain-data dict assembled by
    ``ClusterController.snapshot()`` (see its docstring for the coverage
    matrix); treat it as opaque — the only supported consumers are
    ``ClusterController.recover_from`` and the byte round-trip below.
    """

    lsn: int
    payload: dict

    def to_bytes(self) -> bytes:
        return pickle.dumps((self.lsn, self.payload),
                            protocol=pickle.HIGHEST_PROTOCOL)

    @classmethod
    def from_bytes(cls, data: bytes) -> "ControllerSnapshot":
        lsn, payload = pickle.loads(data)
        return cls(lsn=lsn, payload=payload)
