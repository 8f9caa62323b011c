"""BASS-driven input-shard placement — the paper's technique as a
first-class feature of the training data path.

Every epoch, the controller must decide which data-parallel worker fetches
which input shard from which replica host, and *when* the DCN transfer
runs.  This is exactly the paper's Hadoop problem:

* a shard's replica holders            ↔ ``Task.replicas``
* per-worker ingest backlog (seconds)  ↔ ``ΥI_j`` (ProgressRate-estimated)
* shard fetch over host NICs + trunks  ↔ ``TM`` with TS-slot reservation
* epoch ingest completion              ↔ the makespan (Eq. 5)

``plan_epoch`` runs Algorithm 1 (or a baseline, for the ablation bench) and
returns per-worker fetch schedules; ``prefetch_epoch`` applies the Pre-BASS
refinement so transfers land *before* the step that consumes them.  Traffic
class: Q2 (data input) — below gradient sync, above checkpoints (Ex. 3).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.bass import schedule_bass
from ..core.prebass import schedule_prebass
from ..core.tasks import Instance, Schedule, Task
from ..core.topology import Fabric, tpu_dcn_fabric


@dataclass(frozen=True)
class ShardMeta:
    shard_id: int
    size_bytes: float
    replicas: Tuple[str, ...]        # host names holding the shard


@dataclass
class FetchAssignment:
    shard_id: int
    worker: str
    source: Optional[str]            # None = local read
    start: float
    ready: float                     # transfer end (0 for local)
    slots: Tuple[int, ...]


def plan_epoch(
    fabric: Fabric,
    workers: Sequence[str],
    backlog: Dict[str, float],
    shards: Sequence[ShardMeta],
    decomp_seconds_per_shard: float = 0.05,
    scheduler=schedule_bass,
    slot_duration: float = 0.1,
) -> Tuple[List[FetchAssignment], Schedule]:
    """Assign every shard to a worker with bandwidth-aware BASS.

    ``decomp_seconds_per_shard`` models the host-side work after the bytes
    arrive (decompress + H2D) — the ``TP`` of Eq. (2).
    """
    tasks = [
        Task(
            tid=s.shard_id,
            size=s.size_bytes,
            compute=decomp_seconds_per_shard,
            replicas=s.replicas,
        )
        for s in shards
    ]
    inst = Instance(
        fabric=fabric,
        workers=list(workers),
        idle=dict(backlog),
        tasks=tasks,
        slot_duration=slot_duration,
    )
    sched = scheduler(inst)
    out = [
        FetchAssignment(
            shard_id=a.tid,
            worker=a.node,
            source=a.source,
            start=a.transfer.start if a.transfer else a.start,
            ready=a.transfer.end if a.transfer else 0.0,
            slots=a.transfer.slots if a.transfer else (),
        )
        for a in sched.assignments
    ]
    return out, sched


def prefetch_epoch(
    fabric: Fabric,
    workers: Sequence[str],
    backlog: Dict[str, float],
    shards: Sequence[ShardMeta],
    **kw,
) -> Tuple[List[FetchAssignment], Schedule]:
    """Pre-BASS variant: transfers pulled as early as the ledger allows."""
    return plan_epoch(
        fabric, workers, backlog, shards, scheduler=schedule_prebass, **kw
    )


def uniform_shards(
    n_shards: int,
    hosts: Sequence[str],
    size_bytes: float,
    replication: int = 3,
    seed: int = 0,
) -> List[ShardMeta]:
    rng = np.random.default_rng(seed)
    hosts = list(hosts)
    return [
        ShardMeta(
            shard_id=i,
            size_bytes=size_bytes,
            replicas=tuple(rng.choice(hosts, size=min(replication, len(hosts)), replace=False)),
        )
        for i in range(n_shards)
    ]
