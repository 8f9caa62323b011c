"""The port's hierarchical (pod-sharded) controller held against the JAX
package.

* Exact mode is byte-identical to the flat controller, in the port and
  against the reference, on a cross-pod and a single-pod stream; it places
  task by task and never hands the ``ShardedLedger`` to the mirror-backed
  scans.
* Affine mode on the reference benchmark's smoke leg (k 4, 64 jobs × 32
  tasks) equals the reference on both backends, with the rebalancer off
  and on (root-routed cross-pod placements through the sharded ledger),
  and with a short retire stride (every shard's origin shifts under its
  live mirror).
* The sharded journal and the snapshot / ``recover_from`` round trip.
* The router over an exact-mode hierarchical controller decides as over
  the flat one, and as the reference's router does.

The port runs on the ``torch`` (one ledger mirror per pod on a CPU device)
and ``numpy`` backends.
"""
import random

import numpy as np
import pytest

import repro.core.controller as ref_ctl
import repro.core.hierarchy as ref_hier
import repro.core.journal as ref_journal
import repro.core.tasks as ref_tasks
import repro.core.topology as ref_topo
import repro.net.fattree as ref_fattree
import repro_torch.core.controller as ctl
import repro_torch.core.hierarchy as hier
import repro_torch.core.journal as journal
import repro_torch.core.tasks as tasks_mod
import repro_torch.core.topology as topo
import repro_torch.net.fattree as fattree
from repro_torch import convert
from repro_torch.kernels import ts_plan

PORT = dict(ctl=ctl, hier=hier, journal=journal, tasks=tasks_mod, topo=topo,
            fattree=fattree)
REF = dict(ctl=ref_ctl, hier=ref_hier, journal=ref_journal, tasks=ref_tasks,
           topo=ref_topo, fattree=ref_fattree)


@pytest.fixture(params=["torch", "numpy"])
def backend(request):
    prev = ts_plan.get_backend()
    ts_plan.set_backend(request.param)
    yield request.param
    ts_plan.set_backend(prev)


def _ledger_canon(led):
    return tuple(
        (name, sh.reserved.tobytes(), sh.base_slot, sh.retired_slots)
        for name, sh in sorted(led.shards.items())
    )


# -- exact mode ----------------------------------------------------------------


def _cross_pod_stream(pkg, hosts):
    """``bench_hierarchy._parity_check``'s k 4 cross-pod stream."""
    rng = random.Random(3)
    jobs = []
    for j in range(12):
        tasks = [
            pkg["tasks"].Task(j * 100 + i, size=rng.uniform(40, 400),
                              compute=rng.uniform(1, 20),
                              replicas=tuple(rng.sample(hosts, 3)))
            for i in range(rng.randint(1, 8))
        ]
        jobs.append((tasks, j * 2.0))
    return jobs


def _single_pod_stream(pkg, hosts, pod="pod2", seed=23):
    rng = random.Random(seed)
    pool = [h for h in hosts if h.startswith(pod + "/")]
    return [
        ([pkg["tasks"].Task(j * 100 + i, size=rng.uniform(40, 400),
                            compute=rng.uniform(1, 20),
                            replicas=tuple(rng.sample(pool, 3)))
          for i in range(rng.randint(1, 10))], j * 2.5)
        for j in range(8)
    ]


STREAMS = {"cross_pod": _cross_pod_stream, "single_pod": _single_pod_stream}


def _exact_pair(pkg, stream):
    fab = pkg["fattree"].fat_tree_fabric(4)
    hosts = pkg["topo"].storage_hosts(fab)
    jobs = STREAMS[stream](pkg, hosts)
    flat = pkg["ctl"].ClusterController(fab, hosts, "bass")
    for tasks, at in jobs:
        flat.submit(tasks, at=at)
    flat.run()
    calls = dict(ts_plan.calls)
    h = pkg["hier"].HierarchicalController(fab, hosts)
    for tasks, at in jobs:
        h.submit(tasks, at=at)
    h.run()
    scans = {k: ts_plan.calls[k] - calls[k] for k in ("wave_scan", "col_scan")}
    return flat, h, scans


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_exact_mode_matches_flat_and_reference(backend, stream):
    flat, h, scans = _exact_pair(PORT, stream)
    rflat, rh, _ = _exact_pair(REF, stream)
    got = convert.canon(h.schedule().assignments)
    assert got == convert.canon(flat.schedule().assignments)
    assert got == convert.canon(rh.schedule().assignments)
    assert got == convert.canon(rflat.schedule().assignments)
    assert len(got) > 10
    assert _ledger_canon(h.ledger) == _ledger_canon(rh.ledger)
    assert np.array_equal(h.ledger.reserved, flat.state.ledger.reserved)
    # Exact mode places task by task: the sharded facade never reaches the
    # mirror-backed scans (a ShardedLedger has no device mirror).
    assert scans == {"wave_scan": 0, "col_scan": 0}
    assert not hasattr(h.ledger, "device_mirror")


# -- affine mode ---------------------------------------------------------------


def _smoke_jobs(pkg, hosts, n_jobs=64, per_job=32, dt=0.1, seed=0):
    """``bench_hierarchy._jobs`` at its ``SMOKE_LEG`` size: job ``j``
    arrives at ``j*dt`` with its replicas in one rotating pod."""
    rng = random.Random(seed)
    by_pod = {}
    for h in hosts:
        by_pod.setdefault(h.split("/", 1)[0], []).append(h)
    pods = sorted(by_pod)
    jobs, tid = [], 0
    for j in range(n_jobs):
        pool = by_pod[pods[j % len(pods)]]
        jobs.append(([
            pkg["tasks"].Task(tid + i, size=float(rng.uniform(64e6, 256e6)), compute=0.05,
                              replicas=tuple(rng.sample(pool, min(3, len(pool)))))
            for i in range(per_job)
        ], j * dt))
        tid += per_job
    return jobs


AFFINE = {
    "plain": dict(),
    "rebalance": dict(rebalance_interval=0.5),
    "retire": dict(rebalance_interval=0.5, retire_stride=4),
}


def _affine_run(pkg, case):
    kw = dict(AFFINE[case])
    stride = kw.pop("retire_stride", None)
    fab = pkg["fattree"].fat_tree_fabric(4, link_mbps=25e9)
    hosts = pkg["topo"].storage_hosts(fab)
    h = pkg["hier"].HierarchicalController(fab, hosts, affinity=True,
                                           slot_duration=0.1, **kw)
    if stride is not None:
        h.ledger.retire_stride = stride
    waves = ts_plan.calls["wave_scan"]
    for tasks, at in _smoke_jobs(pkg, hosts):
        h.submit(tasks, at=at)
        h.run_until(at)
    h.run()
    return h, ts_plan.calls["wave_scan"] - waves


@pytest.mark.parametrize("case", sorted(AFFINE))
def test_affine_smoke_leg_matches_reference(backend, case):
    h, waves = _affine_run(PORT, case)
    rh, _ = _affine_run(REF, case)
    got = convert.canon(h.schedule().assignments)
    assert len(got) == 64 * 32
    assert got == convert.canon(rh.schedule().assignments)
    assert _ledger_canon(h.ledger) == _ledger_canon(rh.ledger)
    assert dict(h._stats) == dict(rh._stats)
    assert waves > 0  # the pods' wavefronts went through the scan
    if case != "plain":
        # Root-routed placements booked through the sharded facade.
        assert h._stats["rehomed"] > 0 and h._stats["cross_pod"] > 0
    if case == "retire":
        assert all(sh.base_slot > 0 for sh in h.ledger.shards.values())
    if backend == "torch":
        mirrors = [pc.shard._mirror for pc in h.pods.values()]
        assert all(m is not None for m in mirrors)
        assert len({id(m) for m in mirrors}) == len(h.pods)


def test_affine_torch_equals_numpy_per_pod_mirror():
    """Each pod's shard carries its own mirror on the ``torch`` backend;
    after the run every mirror holds its shard's window exactly."""
    prev = ts_plan.get_backend()
    try:
        out = {}
        for be in ("torch", "numpy"):
            ts_plan.set_backend(be)
            h, _ = _affine_run(PORT, "retire")
            out[be] = (convert.canon(h.schedule().assignments), _ledger_canon(h.ledger))
            if be == "torch":
                for pc in h.pods.values():
                    mir = pc.shard._mirror
                    mir.sync()
                    assert mir.base == pc.shard.base_slot
                    assert np.array_equal(mir.host_view(), pc.shard.reserved)
    finally:
        ts_plan.set_backend(prev)
    assert out["torch"] == out["numpy"]


# -- sharded journal, snapshot and recovery ------------------------------------


def _recovery_pair(pkg, affinity):
    fab = pkg["fattree"].fat_tree_fabric(4)
    hosts = pkg["topo"].storage_hosts(fab)
    kw = dict(affinity=affinity)
    if affinity:
        kw["rebalance_interval"] = 3.0
    rng = random.Random(61)
    jobs = []
    for i in range(8):
        r = random.Random(6100 + i)
        jobs.append(([
            pkg["tasks"].Task(i * 100 + k, size=r.uniform(40, 400), compute=r.uniform(1, 20),
                              replicas=tuple(r.sample(hosts, 3)))
            for k in range(rng.randint(1, 10))
        ], i * 2.0))
    h1 = pkg["hier"].HierarchicalController(fab, hosts, **kw)
    jrn = h1.attach_journal()
    for tasks, at in jobs[:4]:
        h1.submit(tasks, at=at)
    h1.run_until(5.0)
    snap = h1.snapshot()
    blob = snap.to_bytes()
    for tasks, at in jobs[4:]:
        h1.submit(tasks, at=at)
    h1.run()
    J = pkg["journal"]
    h2 = pkg["hier"].HierarchicalController.recover_from(
        fab, J.ControllerSnapshot.from_bytes(blob),
        J.ShardedJournal.from_bytes(jrn.to_bytes()))
    return h1, h2, jrn, blob


@pytest.mark.parametrize("affinity", [False, True], ids=["exact", "affine"])
def test_recovery_twin_matches_and_equals_reference(backend, affinity):
    h1, h2, jrn, blob = _recovery_pair(PORT, affinity)
    r1, r2, rjrn, _ = _recovery_pair(REF, affinity)
    got = convert.canon(h1.schedule().assignments)
    assert got == convert.canon(h2.schedule().assignments)
    assert got == convert.canon(r1.schedule().assignments)
    assert got == convert.canon(r2.schedule().assignments)
    assert _ledger_canon(h1.ledger) == _ledger_canon(h2.ledger) == _ledger_canon(r1.ledger)
    assert isinstance(jrn, journal.ShardedJournal)
    assert [(r.lsn, r.op) for r in jrn.merged()] == [(r.lsn, r.op) for r in rjrn.merged()]
    assert sorted(jrn.segments) == sorted(rjrn.segments)
    assert b"repro." not in blob and b"repro_torch.core" in blob


def test_sharded_journal_segments_route_by_pod(backend):
    fab = fattree.fat_tree_fabric(4)
    hosts = topo.storage_hosts(fab)
    aff = hier.HierarchicalController(fab, hosts, affinity=True)
    jrn = aff.attach_journal()
    assert isinstance(jrn, journal.ShardedJournal)
    pod0 = [h for h in hosts if h.startswith("pod0/")]
    pod3 = [h for h in hosts if h.startswith("pod3/")]
    aff.submit([tasks_mod.Task(i, 100.0, 2.0, tuple(pod0[:3])) for i in range(3)], at=0.0)
    aff.submit([tasks_mod.Task(100 + i, 100.0, 2.0, tuple(pod3[:3])) for i in range(3)],
               at=1.0)
    aff.run()
    assert "pod0" in jrn.segments and "pod3" in jrn.segments
    assert journal.ShardedJournal.ROOT in jrn.segments
    lsns = [r.lsn for r in jrn.merged()]
    assert lsns == list(range(len(lsns)))
    back = journal.ShardedJournal.from_bytes(jrn.to_bytes())
    assert [r.lsn for r in back.merged()] == lsns


def test_journal_replay_without_snapshot(backend):
    fab = topo.tpu_dcn_fabric(n_pods=2, hosts_per_pod=4)
    hosts = topo.storage_hosts(fab)
    h1 = hier.HierarchicalController(fab, hosts)
    jrn = h1.attach_journal()
    for tasks, at in _cross_pod_stream(PORT, hosts):
        h1.submit(tasks, at=at)
    h1.run()
    h2 = hier.HierarchicalController(fab, hosts)
    for rec in jrn.merged():
        if rec.op == "submit":
            h2.submit(list(rec.args[2]), at=rec.args[0], jid=rec.args[1])
        elif rec.op == "run_until":
            h2.run_until(rec.args[0])
        elif rec.op == "run":
            h2.run()
    assert convert.canon(h1.schedule().assignments) == convert.canon(
        h2.schedule().assignments)


# -- the router over a hierarchical controller ---------------------------------


def _router_decisions(pkg_router, pkg_request, pkg_hier, pkg_topo, hierarchical):
    fab = pkg_topo.tpu_dcn_fabric(n_pods=2, hosts_per_pod=2)
    reps = pkg_topo.storage_hosts(fab)
    if hierarchical:
        c = pkg_hier.HierarchicalController(fab, reps, slot_duration=0.05,
                                            horizon_slots=2048)
        router = pkg_router(reps, controller=c, decode_s_per_token=0.001,
                            bytes_per_ctx_token=2e6)
    else:
        router = pkg_router(reps, fabric=fab, decode_s_per_token=0.001,
                            bytes_per_ctx_token=2e6)
    rng = np.random.default_rng(5)
    out = []
    for i in range(40):
        # ``tests/test_serving.py``'s draw order: prefix, tokens, max_new.
        ph, tok, mx = (int(rng.integers(0, 4)), int(rng.integers(4, 64)),
                       int(rng.integers(10, 400)))
        req = pkg_request(rid=i, prompt=np.zeros(tok, dtype=np.int32), max_new=mx,
                          prefix_hash=ph)
        router.update_backlog({rep: float(rng.uniform(0.0, 0.2)) for rep in router.replicas})
        d = router.route(req, now=i * 0.01)
        out.append((d.replica, d.migrated_from, float(d.ready_at).hex(), d.slots))
    return out


@pytest.mark.parametrize("hierarchical", [False, True], ids=["flat", "hierarchical"])
def test_router_over_hierarchical_controller_matches_flat(backend, hierarchical):
    from repro.serving import BassRouter as RefRouter
    from repro.serving import Request as RefRequest
    from repro_torch.serving import BassRouter, Request

    got = _router_decisions(BassRouter, Request, hier, topo, hierarchical)
    flat = _router_decisions(BassRouter, Request, hier, topo, False)
    want = _router_decisions(RefRouter, RefRequest, ref_hier, ref_topo, hierarchical)
    assert got == flat == want
    assert len({d[0] for d in got}) > 1
