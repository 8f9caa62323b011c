"""Schedule-dump tool: byte-exact dumps of the paper + fleet workloads,
through the port.

The counterpart of the reference's ``benchmarks/tools/dump_schedules.py``:
the same workloads, sections and serialization, run through
``repro_torch``, so that every section other than ``backend_*`` diffs
empty against the reference tool's dump (floats serialized via
``float.hex``).  Within one dump the paired blocks must be byte-identical
as in the reference: the storm section per reroute engine, the
``compaction_*`` / ``failstorm_compacted`` sections compacted vs
never-compacted (DESIGN.md §7), the ``faultstorm_*`` sections per reroute
engine (DESIGN.md §10), the ``recovery_*`` twins (DESIGN.md §11) and the
``hierarchy_*`` flat vs sharded blocks (DESIGN.md §12).

The ``backend_*`` sections emit the same workloads under the ``numpy``
backend and the ``cuda`` backend (the planning-scan kernel against the
ledger mirror on the card): paired blocks must be byte-identical within
one dump.  Without a CUDA device they are replaced by a marker block.

Every other section runs on ``--backend`` (default ``cuda``; pass
``numpy`` or ``torch`` on a machine without a card)::

    PYTHONPATH=src python -m repro_torch.tools.dump_schedules OUTFILE [--backend numpy]

The fleet instance and the storm builders of the reference's benchmarks
are copied here, so that the tool imports nothing of the reference.
"""
from __future__ import annotations

import argparse
import io
import random
from dataclasses import replace

import numpy as np

from ..core import SCHEDULERS, Instance, Task, tpu_dcn_fabric
from ..core.controller import BassPolicy, ClusterController, RetryPolicy
from ..core.examples_fig import example1_instance
from ..core.faults import FaultPlan
from ..core.hierarchy import HierarchicalController
from ..core.journal import ControllerSnapshot, Journal
from ..core.topology import storage_hosts
from ..core.workloads import SORT, WORDCOUNT, make_instance
from ..kernels import ts_plan
from ..net.fattree import fat_tree_fabric

#: The reference's fleet configurations (``bench_sched_scale.CONFIGS``):
#: (pods, hosts per pod, tasks).
CONFIGS = [
    (2, 128, 4000),      # 256 hosts
    (4, 256, 10000),     # 1 024 hosts
    (16, 256, 40000),    # 4 096 hosts
    (64, 256, 100000),   # 16 384 hosts
]

# The reference's fault-storm constants (``bench_faults``).
SEED = 7
T0, T1 = 0.5, 3.0         # fault window: inside the ~2-wave run
MTTR = 2.0                # crashed hosts recover this much later
SLOW = (4.0, 8.0)         # straggler slowdown factor range

# The reference's failover constants (``bench_failover_scale``).
T_KILL = 0.5
DEAD_CORE = "core0_0"


def fleet_instance(pods: int, hosts: int, n_tasks: int) -> Instance:
    """The reference's fleet workload (``bench_sched_scale``): a
    ``pods × hosts`` TPU-fleet DCN, 256–640 MB shards with 3 seeded
    replicas, 0.1 s slots."""
    n_hosts = pods * hosts
    fab = tpu_dcn_fabric(n_pods=pods, hosts_per_pod=hosts)
    workers = [f"pod{p}/host{h}" for p in range(pods) for h in range(hosts)]
    rng = np.random.default_rng(0)
    idx = rng.integers(0, n_hosts, size=(n_tasks, 3))
    tasks = [
        Task(
            tid=i,
            size=float(256e6 + (i % 7) * 64e6),     # 256–640 MB shards
            compute=float(0.05),
            replicas=tuple(workers[j] for j in idx[i]),
        )
        for i in range(n_tasks)
    ]
    idle = {w: float(rng.uniform(0, 2.0)) for w in workers}
    return Instance(fabric=fab, workers=workers, idle=idle, tasks=tasks,
                    slot_duration=0.1)


def fault_storm_setup(k: int, n_tasks: int):
    """The reference's fault-storm workload (``bench_faults.storm_setup``):
    sources in the lower pods, workers in the upper pods — every placement
    moves a shard across the core — with compute long enough that
    stragglers and mid-task host kills dominate the makespan."""
    fab = fat_tree_fabric(k, link_mbps=100.0)
    hosts = storage_hosts(fab)
    half = len(hosts) // 2
    sources, workers = hosts[:half], hosts[half:]
    rng = np.random.default_rng(0)
    idx = rng.integers(0, len(sources), size=(n_tasks, 3))
    tasks = [
        Task(
            tid=i,
            size=float(32 + (i % 5) * 16),
            compute=2.0,
            replicas=tuple(sources[j] for j in idx[i]),
        )
        for i in range(n_tasks)
    ]
    return fab, workers, tasks


def failover_storm_setup(k: int, n_tasks: int):
    """The reference's spine-kill workload
    (``bench_failover_scale.storm_setup``): sources in the lower pods,
    workers in the upper pods, every placement crosses the core layer."""
    fab = fat_tree_fabric(k, link_mbps=100.0)
    hosts = storage_hosts(fab)
    half = len(hosts) // 2
    sources, workers = hosts[:half], hosts[half:]
    rng = np.random.default_rng(0)
    idx = rng.integers(0, len(sources), size=(n_tasks, 3))
    tasks = [
        Task(
            tid=i,
            size=float(256 + (i % 7) * 64),   # ~26–64 slots at 100 units
            compute=0.05,
            replicas=tuple(sources[j] for j in idx[i]),
        )
        for i in range(n_tasks)
    ]
    idle = {w: float(rng.uniform(0, 2.0)) for w in workers}
    return fab, workers, tasks, idle


def fx(v):
    if v is None:
        return "None"
    return float(v).hex()


def dump_schedule(out, label, sched):
    out.write(f"== {label}\n")
    for a in sorted(sched.assignments, key=lambda a: a.tid):
        t = a.transfer
        if t is None:
            tr = "-"
        else:
            fr = ";".join(f"{s}:{fx(f)}" for s, f in t.slot_fracs)
            tr = f"links={','.join(map(str, t.links))} start={fx(t.start)} end={fx(t.end)} fracs={fr}"
        out.write(
            f"{a.tid} node={a.node} src={a.source} start={fx(a.start)} "
            f"finish={fx(a.finish)} bw={fx(a.bw_needed)} {tr}\n"
        )


def dump_fig2(out):
    fig2 = example1_instance()
    for name in ("bass", "prebass", "hds", "bar"):
        dump_schedule(out, f"fig2_{name}", SCHEDULERS[name](fig2))


def dump_table1(out):
    for jobname, job in (("wordcount", WORDCOUNT), ("sort", SORT)):
        for mb in (150, 600):
            for seed in (0, 1):
                inst, _, _ = make_instance(job, mb, seed=seed)
                for name in ("bass", "prebass", "hds", "bar"):
                    dump_schedule(
                        out,
                        f"table1_{jobname}_{mb}_{seed}_{name}",
                        SCHEDULERS[name](inst),
                    )


def dump_fleet(out):
    for pods, hosts, n in CONFIGS[:3]:  # fleet configs up to 4 096 hosts
        inst = fleet_instance(pods, hosts, n)
        dump_schedule(out, f"fleet_{pods * hosts}h_{n}t_bass",
                      SCHEDULERS["bass"](inst))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", help="file to write the dump to")
    ap.add_argument("--backend", default="cuda", choices=("cuda", "torch", "numpy"),
                    help="ts_plan backend of every section but backend_*")
    args = ap.parse_args(argv)
    ts_plan.set_backend(args.backend)
    with open(args.out, "w") as out:
        dump_fig2(out)
        dump_table1(out)
        dump_fleet(out)
        for engine in ("batched", "sequential"):
            dump_failure_storm(out, engine)
        dump_compaction(out)
        # Same storm under aggressive vs no compaction: the two blocks
        # (and the default-stride ``failstorm_batched`` one above) must
        # be byte-identical to each other.
        dump_failure_storm(out, "batched", stride=4,
                           label="failstorm_compacted")
        dump_failure_storm(out, "batched", stride=None,
                           label="failstorm_uncompacted")
        dump_backend_parity(out)
        # Seeded fault storm (DESIGN.md §10) under both reroute engines:
        # the paired blocks must be byte-identical to each other within
        # one dump (host kills, retries, blacklisting and LATE
        # speculation are engine-invariant) as well as across code
        # changes.
        for engine in ("batched", "sequential"):
            dump_fault_storm(out, engine)
        # Crash-recovery equivalence (DESIGN.md §11): the same fault storm
        # dumped from a never-killed journaled controller and from a twin
        # rebuilt via snapshot bytes + journal replay — the paired blocks
        # are asserted byte-identical before they are written.
        dump_recovery(out)
        # Flat vs sharded control plane (DESIGN.md §12): the same arrival
        # streams through the flat ClusterController and the exact-mode
        # HierarchicalController — the paired ``hierarchy_*`` blocks are
        # asserted byte-identical before they are written (single-pod AND
        # cross-pod workloads, rebalancer off).
        dump_hierarchy(out)


def dump_recovery(out):
    """Mid-storm checkpoint + kill: the ``recovery_uncrashed`` twin runs
    the journaled storm straight through; the ``recovery_crashed`` twin is
    rebuilt from the checkpoint's snapshot bytes plus a replay of the
    journal suffix.  Schedules, fault counters and ha counters must match
    byte-for-byte (asserted here, not just diffed across runs)."""
    fab, workers, tasks = fault_storm_setup(4, 16)
    ctrl = ClusterController(
        fab, workers, BassPolicy(multipath=True), slot_duration=0.1,
        retry=RetryPolicy(max_attempts=4, backoff_s=0.5),
        speculation=True,
    )
    ctrl.attach_journal()
    ctrl.submit(tasks, at=0.0)
    ctrl.run_until(0.0)
    # The fault storm plus one in-sim controller crash, so the dumped
    # bytes also cover the headless window + mailbox drain path.
    FaultPlan.generate(
        SEED, workers, T0, T1, n_crashes=2, mttr=MTTR,
        n_stragglers=4, slow_factor=SLOW,
        n_ctrl_crashes=1, ctrl_mttr=1.0,
    ).apply(ctrl)
    ctrl.run_until(1.5)          # mid-storm checkpoint: the kill point
    snap = ctrl.snapshot()
    ctrl.run()                   # never-killed twin finishes the storm

    rec = ClusterController.recover_from(
        fab, ControllerSnapshot.from_bytes(snap.to_bytes()),
        Journal.from_bytes(ctrl.journal.to_bytes()),
    )

    bodies = []
    for c in (ctrl, rec):
        buf = io.StringIO()
        dump_schedule(buf, "x", c.schedule())
        body = buf.getvalue().split("\n", 1)[1]
        for key in sorted(c.fault_stats):
            body += f"{key}={fx(c.fault_stats[key])}\n"
        for key in sorted(c.ha_stats):
            body += f"{key}={fx(c.ha_stats[key])}\n"
        bodies.append(body)
    assert bodies[0] == bodies[1], (
        "recovery dump pair diverged: snapshot+replay is not equivalent"
    )
    for label, body in (("recovery_uncrashed", bodies[0]),
                        ("recovery_crashed", bodies[1])):
        out.write(f"== {label}\n")
        out.write(body)


def dump_hierarchy(out):
    """Flat vs pod-sharded controller on identical arrival streams: the
    paired ``hierarchy_<case>_flat`` / ``hierarchy_<case>_sharded`` blocks
    must be byte-identical within one dump — the exact-mode parity
    contract of ``core.hierarchy`` (lazy minnow, per-pod ledger shards and
    the boundary shard are all invisible in every emitted coordinate)."""

    def stream(hosts, seed, pod=None):
        rng = random.Random(seed)
        pool = [h for h in hosts if pod is None or h.startswith(pod + "/")]
        jobs = []
        for j in range(8):
            jobs.append((
                [
                    Task(
                        j * 100 + i,
                        size=rng.uniform(40, 400),
                        compute=rng.uniform(1, 20),
                        replicas=tuple(rng.sample(pool, 3)),
                    )
                    for i in range(rng.randint(1, 10))
                ],
                j * 2.5,
            ))
        return jobs

    cases = [
        ("fattree_cross_pod", fat_tree_fabric(4), None, 11),
        ("fattree_single_pod", fat_tree_fabric(4), "pod2", 23),
        ("tpu_dcn_cross_pod", tpu_dcn_fabric(n_pods=4, hosts_per_pod=8),
         None, 7),
    ]
    for case, fab, pod, seed in cases:
        hosts = storage_hosts(fab)
        jobs = stream(hosts, seed, pod)
        bodies = []
        for ctl in (ClusterController(fab, hosts, "bass"),
                    HierarchicalController(fab, hosts)):
            for tasks, at in jobs:
                ctl.submit(tasks, at=at)
            ctl.run()
            buf = io.StringIO()
            dump_schedule(buf, "x", ctl.schedule())
            bodies.append(buf.getvalue().split("\n", 1)[1])
        assert bodies[0] == bodies[1], (
            f"hierarchy dump pair diverged on {case}: sharded control "
            "plane is not byte-identical to flat"
        )
        for mode, body in (("flat", bodies[0]), ("sharded", bodies[1])):
            out.write(f"== hierarchy_{case}_{mode}\n")
            out.write(body)


def dump_fault_storm(out, engine):
    """Seeded host-kill + straggler storm: schedule + fault counters
    under one reroute engine, speculation on."""
    fab, workers, tasks = fault_storm_setup(4, 16)
    ctrl = ClusterController(
        fab, workers, BassPolicy(multipath=True), slot_duration=0.1,
        retry=RetryPolicy(max_attempts=4, backoff_s=0.5),
        speculation=True,
    )
    ctrl.reroute_engine = engine
    ctrl.submit(tasks, at=0.0)
    ctrl.run_until(0.0)
    FaultPlan.generate(
        SEED, workers, T0, T1, n_crashes=2, mttr=MTTR,
        n_stragglers=4, slow_factor=SLOW,
    ).apply(ctrl)
    ctrl.run()
    label = f"faultstorm_{engine}"
    dump_schedule(out, label, ctrl.schedule())
    out.write(f"== {label}_counters\n")
    for key in sorted(ctrl.fault_stats):
        out.write(f"{key}={fx(ctrl.fault_stats[key])}\n")


def dump_backend_parity(out):
    """The same workloads under the ``numpy`` backend and the ``cuda``
    backend (the planning-scan kernel against the ledger mirror on the
    card): paired ``backend_*`` blocks must be byte-identical within one
    dump — the kernel's bit-exactness contract, end to end through the
    scheduler.  Replaced by a marker block when no CUDA device is
    present."""
    import torch

    if not torch.cuda.is_available():
        out.write("== backend_parity_skipped_no_cuda\n")
        return
    pods, hosts, n = CONFIGS[0]
    prev = ts_plan.get_backend()
    try:
        for be in ("numpy", "cuda"):
            ts_plan.set_backend(be)
            dump_schedule(
                out, f"backend_{be}_fig2_bass",
                SCHEDULERS["bass"](example1_instance()),
            )
            dump_schedule(
                out, f"backend_{be}_fleet_{pods * hosts}h_{n}t",
                SCHEDULERS["bass"](fleet_instance(pods, hosts, n)),
            )
    finally:
        ts_plan.set_backend(prev)


def dump_compaction(out):
    """Fig-2 and Table-I streams through a live controller, compacted
    (retire_stride=4) vs never-compacted: paired blocks byte-identical."""
    cases = [("fig2", example1_instance())]
    inst, _, _ = make_instance(SORT, 150, seed=0)
    cases.append(("table1_sort_150_0", inst))
    for label, inst in cases:
        for mode, stride in (("compacted", 4), ("uncompacted", None)):
            ctrl = ClusterController.from_instance(inst)
            ctrl.state.ledger.retire_stride = stride
            half = len(inst.tasks) // 2
            ctrl.submit(inst.tasks[:half], at=0.0)
            # The second half arrives a compaction-stride later, so the
            # compacting controller has already shifted its origin.
            ctrl.submit(
                [replace(t, tid=t.tid + 10_000) for t in inst.tasks[half:]],
                at=40.0,
            )
            ctrl.run()
            dump_schedule(out, f"compaction_{label}_{mode}",
                          ctrl.schedule())


def dump_failure_storm(out, engine, stride=256, label=None):
    """Spine-kill fleet storm: schedule + reroute log under one engine."""
    fab, workers, tasks, idle = failover_storm_setup(4, 600)
    ctrl = ClusterController(
        fab, workers, BassPolicy(multipath=True), idle=idle,
        slot_duration=0.1,
    )
    ctrl.reroute_engine = engine
    ctrl.state.ledger.retire_stride = stride
    ctrl.submit(tasks, at=0.0)
    ctrl.fail_switch(DEAD_CORE, at=T_KILL)
    ctrl.fail_link("ea/p3e0a0", at=1.0)
    ctrl.run_until(2.0)
    label = label or f"failstorm_{engine}"
    dump_schedule(out, label, ctrl.schedule())
    out.write(f"== {label}_reroute_log\n")
    for r in ctrl.reroute_log:
        out.write(
            f"{r.flow} at={fx(r.at)} dead={','.join(r.dead_links)} "
            f"{r.src}->{r.dst} old={'/'.join(r.old_path)} "
            f"new={'/'.join(r.new_path)} delivered={fx(r.delivered)} "
            f"remaining={fx(r.remaining)} old_end={fx(r.old_end)} "
            f"new_end={fx(r.new_end)}\n"
        )


if __name__ == "__main__":
    main()
