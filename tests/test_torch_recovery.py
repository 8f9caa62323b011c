"""The port's write-ahead journal, snapshots, crash recovery and fault
plans held against the JAX package.

* The controller's journal, snapshot, telemetry and heartbeat entry points
  (and a full restore of a snapshot that carries telemetry and heartbeats)
  work in the port and give what the reference gives.
* ``FaultPlan.generate`` draws the reference's script from the same seed.
* At every crash point of the reference suite's seeded storm, a twin
  rebuilt from snapshot bytes plus a journal replay equals the never-crashed
  controller, and both equal the reference's run, byte for byte.
* A ``ClusterState.restore`` that crosses a retire while the ledger mirror
  is live is followed by a wave equal to the ``numpy`` backend's.

The port runs on the ``torch`` (ledger mirror on a CPU device) and ``numpy``
backends.
"""
import functools

import numpy as np
import pytest

import repro.core.controller as ref_ctl
import repro.core.examples_fig as ref_fig
import repro.core.faults as ref_faults
import repro.core.journal as ref_journal
import repro.core.tasks as ref_tasks
import repro.core.topology as ref_topo
import repro.net.fattree as ref_fattree
import repro_torch.core.controller as ctl
import repro_torch.core.examples_fig as fig
import repro_torch.core.faults as faults
import repro_torch.core.journal as journal
import repro_torch.core.tasks as tasks_mod
import repro_torch.core.topology as topo
import repro_torch.net.fattree as fattree
from repro_torch.kernels import ts_plan

SEED = 7

#: Each package's modules, so that one helper builds the same run in either.
PORT = dict(ctl=ctl, fig=fig, faults=faults, journal=journal, tasks=tasks_mod,
            topo=topo, fattree=fattree)
REF = dict(ctl=ref_ctl, fig=ref_fig, faults=ref_faults, journal=ref_journal,
           tasks=ref_tasks, topo=ref_topo, fattree=ref_fattree)


@pytest.fixture(params=["torch", "numpy"])
def backend(request):
    prev = ts_plan.get_backend()
    ts_plan.set_backend(request.param)
    yield request.param
    ts_plan.set_backend(prev)


# -- canon (the reference suite's) ----------------------------------------------

_CANON_EXCLUDE = ("wavefront.", "recovery.")


def canon(c):
    sched = []
    for a in c.schedule().assignments:
        t = a.transfer
        sched.append((
            a.tid, a.node, a.source, a.start.hex(), a.finish.hex(),
            None if t is None else (t.links, t.start.hex(), t.end.hex(),
                                    tuple((s, f.hex()) for s, f in t.slot_fracs)),
        ))
    reroutes = [
        (float(r.at).hex(), r.flow, r.dead_links, r.src, r.dst, r.old_path,
         r.new_path, float(r.delivered).hex(), float(r.remaining).hex(),
         float(r.old_end).hex(), float(r.new_end).hex())
        for r in c.reroute_log
    ]
    counters = {k: v for k, v in sorted(c.obs.snapshot(trace_tail=0)["counters"].items())
                if not k.startswith(_CANON_EXCLUDE)}
    led = c.state.ledger
    return {
        "sched": sched, "reroutes": reroutes, "counters": counters,
        "ledger": (led.reserved.tobytes(), led.base_slot, led.retired_slots),
        "tables": _plain(tuple(c.dataplane.tables.dump())), "shed": list(c.shed_jobs),
    }


def _plain(x):
    """A package-free image of journal arguments and estimator state: the
    port's and the reference's dataclasses by type name and fields."""
    import dataclasses

    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            _plain(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x).__name__, [_plain(v) for v in x]
    if isinstance(x, float):
        return x.hex()
    if hasattr(x, "__dict__") and not isinstance(x, type):
        return (type(x).__name__, _plain(vars(x)))
    return x


# -- F1: the controller's recovery entry points on Example 1 --------------------


def _example1(pkg):
    inst = pkg["fig"].example1_instance()
    c = pkg["ctl"].ClusterController.from_instance(inst)
    return c, inst


def _drive_example1(pkg, crash_at=None):
    """Journal, telemetry and heartbeats attached; half the tasks, a
    mid-run snapshot, the other half.  With ``crash_at``, returns the
    twin recovered from the snapshot bytes plus the journal instead."""
    c, inst = _example1(pkg)
    jrn = c.attach_journal()
    c.attach_telemetry(estimator="window")
    c.attach_heartbeats(interval=1.0, grace_s=100.0)
    c.submit(inst.tasks[:5], at=0.0)
    c.run_until(6.0)
    snap = c.snapshot()
    blob = snap.to_bytes()
    c.submit(inst.tasks[5:], at=8.0)
    c.run()
    if crash_at is None:
        return c, jrn, snap, blob
    J = pkg["journal"]
    twin = pkg["ctl"].ClusterController.recover_from(
        inst.fabric, J.ControllerSnapshot.from_bytes(blob),
        J.Journal.from_bytes(jrn.to_bytes()))
    return c, twin


def test_f1_attach_journal(backend):
    port, jrn, _, _ = _drive_example1(PORT)
    ref, rjrn, _, _ = _drive_example1(REF)
    assert isinstance(jrn, journal.Journal) and jrn.lsn == rjrn.lsn > 0
    assert [(r.lsn, r.op, _plain(r.args)) for r in jrn.records] == [
        (r.lsn, r.op, _plain(r.args)) for r in rjrn.records]
    back = journal.Journal.from_bytes(jrn.to_bytes())
    assert [(r.lsn, r.op) for r in back.records] == [(r.lsn, r.op) for r in jrn.records]
    assert canon(port) == canon(ref)


def test_f1_snapshot(backend):
    _, _, snap, blob = _drive_example1(PORT)
    _, _, rsnap, _ = _drive_example1(REF)
    assert isinstance(snap, journal.ControllerSnapshot) and snap.lsn == rsnap.lsn
    # A port snapshot pickles port classes only, never the reference's.
    assert b"repro_torch.core" in blob and b"repro." not in blob
    got = dict(snap.payload)
    want = dict(rsnap.payload)
    assert sorted(got) == sorted(want)
    for key in ("now", "ledger", "state", "events", "seq", "next_jid", "jobs",
                "telemetry", "heartbeats", "liveness", "flows"):
        assert _plain(got[key]) == _plain(want[key]), key


def test_f1_attach_telemetry(backend):
    port, _, _, _ = _drive_example1(PORT)
    ref, _, _, _ = _drive_example1(REF)
    from repro_torch.net.telemetry import LinkStatsMonitor

    assert isinstance(port.telemetry, LinkStatsMonitor)
    assert port.state.belief is port.telemetry.belief
    assert _plain(port.telemetry.dump_state()) == _plain(ref.telemetry.dump_state())
    assert _plain(port.telemetry.snapshot()) == _plain(ref.telemetry.snapshot())


def test_f1_attach_heartbeats(backend):
    port, _, _, _ = _drive_example1(PORT)
    ref, _, _, _ = _drive_example1(REF)
    from repro_torch.runtime.ft import HeartbeatMonitor

    assert isinstance(port.heartbeats, HeartbeatMonitor)
    assert _plain(list(port.heartbeats.hosts.values())) == _plain(
        list(ref.heartbeats.hosts.values()))
    assert (port._hb_interval, port._hb_last) == (ref._hb_interval, ref._hb_last)


def test_f1_restore_full_with_telemetry_and_heartbeats(backend):
    port, twin = _drive_example1(PORT, crash_at=True)
    ref, rtwin = _drive_example1(REF, crash_at=True)
    assert twin.telemetry is not None and twin.heartbeats is not None
    assert canon(twin) == canon(port) == canon(ref) == canon(rtwin)
    assert _plain(twin.telemetry.dump_state()) == _plain(rtwin.telemetry.dump_state())
    assert _plain(list(twin.heartbeats.hosts.values())) == _plain(
        list(rtwin.heartbeats.hosts.values()))
    assert twin.schedule().makespan == 35.0


# -- fault plans ----------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 100, 12345])
@pytest.mark.parametrize("shape", [
    dict(n_crashes=2, mttr=2.0, n_stragglers=4),
    dict(n_crashes=6, mttr=0.0, n_stragglers=16, slow_factor=(4.0, 8.0)),
    dict(n_flaps=3, flap_duration=0.7, n_ctrl_crashes=2, ctrl_mttr=0.0),
    dict(n_crashes=1, mttr=1.5, n_stragglers=2, n_flaps=2, n_ctrl_crashes=1),
])
def test_fault_plan_generate_matches_reference(seed, shape):
    hosts = [f"h{i}" for i in range(40)]
    links = [f"l{i}" for i in range(12)]
    got = faults.FaultPlan.generate(seed, hosts, 0.5, 3.0, links=links, **shape)
    want = ref_faults.FaultPlan.generate(seed, hosts, 0.5, 3.0, links=links, **shape)
    assert got.seed == want.seed
    assert _plain(list(got.events)) == _plain(list(want.events))
    assert len(got.events) > 0
    assert str(got) == str(want)


def test_fault_exports_match_reference():
    import repro.core as ref_core
    import repro_torch.core as core

    for name in ("FaultPlan", "HostCrash", "LinkFlap", "StragglerOnset"):
        assert getattr(core, name) is getattr(faults, name)
        assert getattr(ref_core, name) is getattr(ref_faults, name)
    assert faults.ControllerCrash.__name__ == ref_faults.ControllerCrash.__name__


# -- crash-point equivalence over the reference suite's storm -----------------


def storm_fixture(pkg, n_tasks=12):
    fab = pkg["fattree"].fat_tree_fabric(4, link_mbps=100.0)
    hosts = pkg["topo"].storage_hosts(fab)
    half = len(hosts) // 2
    sources, workers = hosts[:half], hosts[half:]
    rng = np.random.default_rng(0)
    idx = rng.integers(0, len(sources), size=(n_tasks, 3))
    tasks = [pkg["tasks"].Task(tid=i, size=float(32 + (i % 5) * 16), compute=2.0,
                               replicas=tuple(sources[j] for j in idx[i]))
             for i in range(n_tasks)]
    return fab, workers, tasks


def build(pkg, fab, workers, **kw):
    C = pkg["ctl"]
    kw.setdefault("slot_duration", 0.1)
    kw.setdefault("retry", C.RetryPolicy(max_attempts=4, backoff_s=0.5))
    return C.ClusterController(fab, workers, C.BassPolicy(multipath=True), **kw)


def storm_script(pkg, fab, workers, tasks):
    plan = pkg["faults"].FaultPlan.generate(
        SEED, workers, 0.5, 3.0, n_crashes=2, mttr=2.0,
        n_stragglers=3, slow_factor=(4.0, 8.0), n_ctrl_crashes=1, ctrl_mttr=0.8,
    )
    first = fab.path(tasks[0].replicas[0], workers[0])
    flow = pkg["tasks"].BackgroundFlow(tasks[0].replicas[0], workers[0], 0.3, 0.4, 1.2)
    return [
        lambda c: c.attach_telemetry(estimator="window"),
        lambda c: c.submit(tasks[: len(tasks) // 2], at=0.0),
        lambda c: c.run_until(0.0),
        lambda c: c.inject_flow(flow),
        lambda c: c.reserve_transfer_at(0.6, 24.0, first, tag="sync"),
        plan.apply,
        lambda c: c.run_until(1.0),
        lambda c: c.submit(tasks[len(tasks) // 2:], at=1.5),
        lambda c: c.run(),
    ]


N_STEPS = 9


@functools.lru_cache(maxsize=None)
def _reference_storm():
    fab, workers, tasks = storm_fixture(REF)
    c = build(REF, fab, workers)
    c.attach_journal()
    for step in storm_script(REF, fab, workers, tasks):
        step(c)
    return canon(c)


@pytest.mark.parametrize("crash_at", range(N_STEPS + 1))
def test_crash_point_twin_matches_uncrashed_and_reference(backend, crash_at):
    fab, workers, tasks = storm_fixture(PORT)
    steps = storm_script(PORT, fab, workers, tasks)
    assert len(steps) == N_STEPS
    a = build(PORT, fab, workers)
    a.attach_journal()
    for step in steps[:crash_at]:
        step(a)
    snap = a.snapshot()
    for step in steps[crash_at:]:
        step(a)
    want = canon(a)
    snap2 = journal.ControllerSnapshot.from_bytes(snap.to_bytes())
    jrn = journal.Journal.from_bytes(a.journal.to_bytes())
    b = ctl.ClusterController.recover_from(fab, snap2, jrn)
    assert canon(b) == want == _reference_storm()
    got = b.obs.snapshot(trace_tail=0)["counters"]
    assert got["recovery.recoveries"] == 1
    assert got["recovery.replayed"] == jrn.lsn - snap2.lsn
    assert want["reroutes"] or want["counters"]["faults.killed"] > 0


def test_snapshot_pickles_no_reference_class(backend):
    fab, workers, tasks = storm_fixture(PORT)
    a = build(PORT, fab, workers)
    a.attach_journal()
    for step in storm_script(PORT, fab, workers, tasks)[:7]:
        step(a)
    for blob in (a.snapshot().to_bytes(), a.journal.to_bytes()):
        assert b"repro." not in blob
        mods = {m for m in _pickled_modules(blob)}
        assert mods and all(not m.startswith("repro.") for m in mods)


def _pickled_modules(blob):
    import pickletools

    for op, arg, _pos in pickletools.genops(blob):
        if op.name in ("GLOBAL", "STACK_GLOBAL") and isinstance(arg, str):
            yield arg.split(" ")[0]
        elif op.name in ("SHORT_BINUNICODE", "BINUNICODE") and str(arg).startswith("repro"):
            yield str(arg)


# -- ClusterState.restore across a retire, with the mirror live -----------------


def _retire_restore_run(backend, cross):
    """Wave 1 (mirror uploaded at origin 0), snapshot, (with ``cross``)
    retire past wave 1's transfers, wave 2 (mirror synced), restore the
    snapshot, wave 3: the restore must invalidate the mirror, or wave 3
    scans wave 2's bookings (a restore across a retire also moves the
    origin back, which re-uploads by itself)."""
    prev = ts_plan.get_backend()
    ts_plan.set_backend(backend)
    try:
        fab, workers, tasks = storm_fixture(PORT, n_tasks=24)
        state = ctl.ClusterState(fab, workers, slot_duration=0.1, horizon_slots=64)
        pol = ctl.BassPolicy(multipath=True)
        waves0 = ts_plan.calls["wave_scan"]
        first = pol.place_batch(tasks[:8], state)
        snap = state.snapshot()
        led = state.ledger
        if cross:
            end = max(a.transfer.end for a in first if a.transfer is not None)
            cut = led.slot_of(end) + 8
            state.advance(cut * led.slot_duration)
            led.retire_to(cut)
            assert led.base_slot == cut and led.retired_slots > 0
        second = pol.place_batch(tasks[8:16], state)
        state.restore(snap)
        assert (led.base_slot, led.retired_slots) == (0, 0)
        third = pol.place_batch(tasks[16:], state)
        waves = ts_plan.calls["wave_scan"] - waves0
        mirror = led._mirror
    finally:
        ts_plan.set_backend(prev)
    from repro_torch import convert

    return dict(first=convert.canon(first), second=convert.canon(second),
                third=convert.canon(third), waves=waves,
                ledger=(led.reserved.tobytes(), led.base_slot, led.retired_slots),
                mirror=mirror)


@pytest.mark.parametrize("cross", [True, False], ids=["across_retire", "same_origin"])
def test_restore_with_live_mirror_equals_numpy(cross):
    got = _retire_restore_run("torch", cross)
    want = _retire_restore_run("numpy", cross)
    assert got["mirror"] is not None and want["mirror"] is None
    assert got["waves"] == want["waves"] >= 3
    for key in ("first", "second", "third", "ledger"):
        assert got[key] == want[key], key


def test_state_restore_invalidates_a_live_mirror():
    prev = ts_plan.get_backend()
    ts_plan.set_backend("torch")
    try:
        fab, workers, tasks = storm_fixture(PORT, n_tasks=8)
        state = ctl.ClusterState(fab, workers, slot_duration=0.1, horizon_slots=64)
        ctl.BassPolicy(multipath=True).place_batch(tasks, state)
        mir = state.ledger._mirror
        assert mir is not None
        snap = state.snapshot()
        state.ledger.retire_to(state.ledger.slot_of(5.0))
        mir.sync()
        uploads = _mirror_stats()["mirror_uploads"]
        state.restore(snap)
        mir.sync()
        assert _mirror_stats()["mirror_uploads"] > uploads
        assert np.array_equal(mir.arr.cpu().numpy()[:, :state.ledger.reserved.shape[1]],
                              state.ledger.reserved)
    finally:
        ts_plan.set_backend(prev)


def _mirror_stats():
    from repro_torch.kernels import ts_plan_device

    return dict(ts_plan_device.stats)
