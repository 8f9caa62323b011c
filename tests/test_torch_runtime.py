"""The port's runtime (heartbeats, restart supervision, elastic mesh
shapes, progress tracking) and its cross-pod DCN sync bookkeeping held
against the JAX package, on seeded scripts with injected clocks, bit for
bit.
"""
import dataclasses

import numpy as np
import pytest

import repro.runtime as ref_runtime
import repro_torch.runtime as runtime
from repro_torch.kernels import ts_plan


@pytest.fixture(params=["torch", "numpy"])
def backend(request):
    prev = ts_plan.get_backend()
    ts_plan.set_backend(request.param)
    yield request.param
    ts_plan.set_backend(prev)


def _hosts(mon):
    return [(h.name, float(h.last_beat).hex(), h.alive) for h in mon.hosts.values()]


# -- heartbeats ------------------------------------------------------------------


def _heartbeat_script(rt, seed):
    """Seeded beats, sweeps, a controller outage (``suspend_accrual``) and
    revivals on an injected clock; the log of every observable."""
    rng = np.random.default_rng(seed)
    t = [0.0]
    hosts = [f"h{i}" for i in range(12)]
    mon = rt.HeartbeatMonitor(hosts, grace_s=1.5, clock=lambda: t[0])
    log = []
    for step in range(60):
        t[0] += float(rng.uniform(0.05, 0.6))
        for h in hosts:
            if rng.random() < 0.7:
                mon.beat(h)
        if step % 7 == 3:
            dead = [h for h in hosts if not mon.hosts[h].alive]
            if dead:
                mon.revive(dead[int(rng.integers(0, len(dead)))])
        if step == 30:
            t[0] += 5.0
            mon.suspend_accrual(float(rng.uniform(3.0, 6.0)))
        log.append((float(t[0]).hex(), mon.sweep(), sorted(mon.alive()), _hosts(mon)))
    mon.suspend_accrual(0.0)
    mon.suspend_accrual(-1.0)
    log.append(_hosts(mon))
    return log


@pytest.mark.parametrize("seed", range(4))
def test_heartbeat_monitor_matches_reference(seed):
    got = _heartbeat_script(runtime, seed)
    assert got == _heartbeat_script(ref_runtime, seed)
    assert any(sweep for _t, sweep, _a, _h in got[:-1])  # some host died


def test_heartbeat_suspend_accrual_caps_at_now():
    for rt in (runtime, ref_runtime):
        t = [10.0]
        mon = rt.HeartbeatMonitor(["a", "b"], grace_s=1.0, clock=lambda: t[0])
        t[0] = 12.0
        mon.suspend_accrual(50.0)
        assert all(st.last_beat == 12.0 for st in mon.hosts.values())
        assert mon.sweep() == []


# -- supervisor and elastic mesh -------------------------------------------------


def _supervisor_script(rt):
    mon = rt.HeartbeatMonitor([f"h{i}" for i in range(6)], grace_s=5.0)
    calls = []
    sup = rt.TrainSupervisor(mon, chips_per_host=4, model_axis=4,
                             rebuild=calls.append, restore=lambda: 40 + len(calls))
    for h in mon.hosts:
        mon.beat(h, now=0.0)
    out = [sup.on_tick(10, now=1.0)]
    for k, lost in enumerate(("h5", "h2")):
        now = 8.0 * (k + 1)
        for h in mon.hosts:
            if h != lost and mon.hosts[h].alive:
                mon.beat(h, now=now - 0.5)
        out.append(sup.on_tick(11 + k, now=now))
    for h in list(mon.hosts):
        if mon.hosts[h].alive and h != "h0":
            mon.hosts[h].last_beat = -100.0
    with pytest.raises(RuntimeError, match="unrecoverable"):
        sup.on_tick(20, now=30.0)
    return ([None if e is None else dataclasses.astuple(e) for e in out], calls,
            [dataclasses.astuple(e) for e in sup.events])


def test_train_supervisor_matches_reference():
    got = _supervisor_script(runtime)
    assert got == _supervisor_script(ref_runtime)
    events = got[0]
    assert events[0] is None and events[1][2] == ("h5",) and events[2][2] == ("h2",)
    assert got[1] == [(5, 4), (4, 4)]


@pytest.mark.parametrize("n_chips", [0, 3, 8, 16, 255, 256, 257, 512, 1000])
@pytest.mark.parametrize("model_axis,prefer_pods", [(4, None), (16, None), (16, 2), (8, 4)])
def test_elastic_mesh_shape_matches_reference(n_chips, model_axis, prefer_pods):
    assert runtime.elastic_mesh_shape(n_chips, model_axis, prefer_pods) == \
        ref_runtime.elastic_mesh_shape(n_chips, model_axis, prefer_pods)


# -- progress tracking -----------------------------------------------------------


def _progress_script(rt, seed):
    rng = np.random.default_rng(seed)
    tr = rt.ProgressTracker(straggler_factor=2.0)
    log = []
    for i in range(10):
        tr.start(i, f"w{i % 4}", now=float(rng.uniform(0.0, 2.0)))
    for k in range(8):
        now = 3.0 + k
        live = [i for i in range(10) if i != 3 or k <= 4]
        for i in live:
            if rng.random() < 0.6:
                tr.update(i, float(rng.uniform(-0.1, 1.1)), now=now)
        if k == 4:
            tr.finish(3)
            tr.finish(99)
            live.remove(3)
        log.append((
            [float(tr.remaining(i, now=now)).hex() for i in live],
            {w: float(v).hex() for w, v in tr.worker_idle_times(now=now).items()},
            tr.stragglers(now=now),
        ))
    return log


@pytest.mark.parametrize("seed", range(3))
def test_progress_tracker_matches_reference(seed):
    assert _progress_script(runtime, seed) == _progress_script(ref_runtime, seed)


def test_progress_rate_formula():
    tr = runtime.ProgressTracker()
    tr.start(1, "w0", now=0.0)
    tr.update(1, 0.25, now=10.0)
    assert tr.remaining(1, now=10.0) == pytest.approx(30.0)
    assert runtime.TaskProgress(1, "w0", 0.0).score == 0.0


# -- cross-pod DCN sync (tests/test_dcn.py's first three tests) ------------------


def _sync_pair(**kw):
    from repro.distributed.dcn import CrossPodSync as RefSync
    from repro_torch.distributed import CrossPodSync

    return CrossPodSync(**kw), RefSync(**kw)


def _plan(p):
    return (p.links, float(p.start).hex(), float(p.end).hex(),
            tuple((s, float(f).hex()) for s, f in p.slot_fracs))


def test_reserved_flows_serialize_on_trunk(backend):
    sync, ref = _sync_pair(n_pods=2, hosts_per_pod=4, grad_bytes=100e9)
    flows = [(sync.reserve_step(k, not_before=0.0), ref.reserve_step(k, not_before=0.0))
             for k in (1, 2, 3)]
    for f, rf in flows:
        assert (f.step, float(f.bytes).hex(), _plan(f.plan)) == (
            rf.step, float(rf.bytes).hex(), _plan(rf.plan))
    (f1, _), (f2, _), _ = flows
    assert f2.plan.start >= f1.plan.end - 1e-9
    assert (sync.ledger.reserved <= 1.0 + 1e-6).all()
    assert sync.ledger.reserved.tobytes() == ref.ledger.reserved.tobytes()


def test_compression_quarters_wire_bytes():
    a, ra = _sync_pair(n_pods=2, hosts_per_pod=4, grad_bytes=80e9, compress=False)
    b, rb = _sync_pair(n_pods=2, hosts_per_pod=4, grad_bytes=80e9, compress=True)
    assert a.wire_bytes() == pytest.approx(4.0 * b.wire_bytes())
    assert (a.wire_bytes(), b.wire_bytes()) == (ra.wire_bytes(), rb.wire_bytes())


def test_projected_sync_seconds_matches_ledger_bandwidth():
    sync, ref = _sync_pair(n_pods=2, hosts_per_pod=4, grad_bytes=100e9)
    t = sync.projected_sync_seconds()
    assert t == pytest.approx(100e9 / 400e9, rel=1e-6)
    assert float(t).hex() == float(ref.projected_sync_seconds()).hex()


def test_registered_steps_and_trunk_failure_match_reference(backend):
    sync, ref = _sync_pair(n_pods=4, hosts_per_pod=4, grad_bytes=60e9, compress=True)
    out = []
    for s in (sync, ref):
        s.register_steps(0, 6, cadence_s=0.4)
        new = s.advance_to(0.9)
        s.fail_link("pod1/trunk", at=1.0)
        s.recover_link("pod1/trunk", at=1.6)
        later = s.advance_to(3.0)
        out.append((sorted(new), sorted(later),
                    {k: _plan(f.plan) for k, f in sorted(s.flows.items())},
                    s.ledger.reserved.tobytes()))
    assert out[0] == out[1]
    assert len(out[0][2]) == 6
