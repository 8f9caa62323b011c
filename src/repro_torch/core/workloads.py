"""Table-I-style workload generators (Wordcount / Sort, §V).

The paper's testbed: 6 nodes in 5 physical systems behind 2 OVS switches,
replicas = 3, 64 MB blocks, 100 Mbps links, a repetitively-executed
background job supplying each test's initial workload; data sizes 150 MB,
300 MB, 600 MB, 1 GB, 5 GB; Wordcount is CPU-heavy, Sort is shuffle/IO-heavy.

We regenerate instances with the same shape.  Absolute seconds cannot match
a 2013 physical testbed; the *reproducible claims* are (a) BASS ≤ BAR ≤ HDS
job completion on every row and (b) BASS may win with a lower locality ratio
(§V.B's argument).  ``benchmarks/bench_table1.py`` prints our table next to
the paper's for comparison.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .tasks import BackgroundFlow, Instance, Task
from .topology import Fabric, two_tier_fabric

MB = 8.0                     # Mbit per MB
BLOCK_MB = 64.0              # HDFS block size (§V.A)
LINK_MBPS = 100.0            # max link rate (§V.A)
DATA_SIZES_MB = {"150M": 150, "300M": 300, "600M": 600, "1G": 1024, "5G": 5120}


@dataclass(frozen=True)
class JobSpec:
    """Calibration of a job type (per 64 MB block / per reduce wave)."""

    name: str
    map_cpu: float            # TP per map task, seconds
    reduce_cpu: float         # TP per reduce task, seconds
    shuffle_frac: float       # shuffle bytes as a fraction of input
    n_reducers: int


WORDCOUNT = JobSpec("wordcount", map_cpu=22.0, reduce_cpu=16.0, shuffle_frac=0.08, n_reducers=2)
SORT = JobSpec("sort", map_cpu=6.0, reduce_cpu=20.0, shuffle_frac=1.0, n_reducers=4)


def testbed_fabric() -> Fabric:
    """6 workers behind 2 switches (paper's 2-OVS testbed)."""
    return two_tier_fabric(n_leaves=2, hosts_per_leaf=3, host_mbps=LINK_MBPS,
                           trunk_mbps=LINK_MBPS)


def make_instance(
    job: JobSpec,
    data_size_mb: float,
    seed: int,
    replication: int = 3,
    background_load: float = 30.0,
) -> Tuple[Instance, List[Task], float]:
    """Build (map instance, reduce tasks, shuffle size per reduce)."""
    rng = np.random.default_rng(seed)
    fabric = testbed_fabric()
    workers = [f"H{i}" for i in range(6)]
    n_blocks = max(1, math.ceil(data_size_mb / BLOCK_MB))

    tasks: List[Task] = []
    for i in range(n_blocks):
        reps = tuple(rng.choice(workers, size=replication, replace=False))
        last_mb = data_size_mb - BLOCK_MB * (n_blocks - 1)
        size_mb = BLOCK_MB if i < n_blocks - 1 else max(last_mb, 1.0)
        # mild heterogeneity in per-block compute (stragglers exist in practice)
        cpu = job.map_cpu * (size_mb / BLOCK_MB) * float(rng.uniform(0.9, 1.15))
        tasks.append(Task(tid=i + 1, size=size_mb * MB, compute=cpu, replicas=reps))

    # Background job ⇒ uneven initial idle times AND ongoing cross-traffic
    # (paper: "repetitively execute a background job to provide each test
    # with initial workload").  The flows occupy 40–80 % of their paths in
    # recurring bursts over the whole horizon; the SDN ledger sees them.
    idle = {w: float(rng.uniform(0.0, background_load)) for w in workers}
    horizon = 240.0 + n_blocks * (job.map_cpu + 8.0)  # covers map + reduce tail
    background: List[BackgroundFlow] = []
    t = 0.0
    while t < horizon:
        src, dst = rng.choice(workers, size=2, replace=False)
        dur = float(rng.uniform(4.0, 12.0))
        background.append(
            BackgroundFlow(str(src), str(dst), float(rng.uniform(0.4, 0.8)),
                           t, min(t + dur, horizon))
        )
        t += dur * float(rng.uniform(0.4, 0.9))

    inst = Instance(fabric=fabric, workers=workers, idle=idle, tasks=tasks,
                    slot_duration=1.0, background=background)

    shuffle_total_mb = data_size_mb * job.shuffle_frac
    per_reduce_mb = shuffle_total_mb / job.n_reducers
    reduce_tasks = [
        Task(
            tid=10_000 + r,
            size=per_reduce_mb * MB,
            compute=job.reduce_cpu * max(per_reduce_mb / BLOCK_MB, 0.25),
            # shuffle output is spread across mappers: no locality in general —
            # model the reduce input's "home" as a random mapper subset.
            replicas=tuple(rng.choice(workers, size=2, replace=False)),
            kind="reduce",
        )
        for r in range(job.n_reducers)
    ]
    return inst, reduce_tasks, per_reduce_mb * MB


# Paper Table I ground truth (JT seconds + LR) for side-by-side reporting.
PAPER_TABLE1 = {
    "wordcount": {
        "150M": {"BASS": 78, "BAR": 78, "HDS": 78},
        "300M": {"BASS": 128, "BAR": 146, "HDS": 156},
        "600M": {"BASS": 231, "BAR": 259, "HDS": 269},
        "1G": {"BASS": 298, "BAR": 305, "HDS": 311},
        "5G": {"BASS": 1302, "BAR": 1377, "HDS": 1396},
    },
    "sort": {
        "150M": {"BASS": 55, "BAR": 67, "HDS": 74},
        "300M": {"BASS": 91, "BAR": 110, "HDS": 117},
        "600M": {"BASS": 144, "BAR": 155, "HDS": 168},
        "1G": {"BASS": 262, "BAR": 285, "HDS": 323},
        "5G": {"BASS": 1572, "BAR": 1632, "HDS": 1859},
    },
}
