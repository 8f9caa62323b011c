"""The port's telemetry plane held against the JAX package.

The per-link counter monitor (``LinkStatsMonitor``: cumulative bytes,
``missed_slots`` across a retire), the EWMA and sliding-window estimators
(including a counter reset), the measured-bandwidth ``BeliefState``, and
``telemetry=True`` BASS and Pre-BASS schedules on a driven controller, all
equal to the reference bit for bit.  The port runs on the ``torch`` and
``numpy`` backends.
"""
import numpy as np
import pytest

import repro.core.controller as ref_ctl
import repro.core.tasks as ref_tasks
import repro.core.timeslot as ref_timeslot
import repro.core.topology as ref_topo
import repro.net.telemetry as ref_tel
import repro_torch.core.controller as ctl
import repro_torch.core.tasks as tasks_mod
import repro_torch.core.timeslot as timeslot
import repro_torch.core.topology as topo
import repro_torch.net.telemetry as tel
from repro_torch import convert
from repro_torch.kernels import ts_plan

PORT = dict(ctl=ctl, tasks=tasks_mod, timeslot=timeslot, topo=topo, tel=tel)
REF = dict(ctl=ref_ctl, tasks=ref_tasks, timeslot=ref_timeslot, topo=ref_topo, tel=ref_tel)
HOSTS = ["H0", "H1", "H2", "H3"]


@pytest.fixture(params=["torch", "numpy"])
def backend(request):
    prev = ts_plan.get_backend()
    ts_plan.set_backend(request.param)
    yield request.param
    ts_plan.set_backend(prev)


def _hex(a):
    return np.asarray(a, dtype=np.float64).tobytes()


# -- estimators ------------------------------------------------------------------


def _estimator(pkg, kind):
    cap = np.random.default_rng(11).uniform(50.0, 150.0, size=5)
    return (pkg["tel"].EwmaEstimator(5, alpha=0.3) if kind == "ewma"
            else pkg["tel"].WindowRateEstimator(5, cap, window=3.0))


def _estimator_trace(pkg, kind):
    """A seeded counter stream with a reset (counters go backwards once)."""
    rng = np.random.default_rng(11)
    est = _estimator(pkg, kind)
    cum = np.zeros(5)
    out = []
    for k in range(24):
        occ = rng.uniform(0.0, 1.0, size=5)
        cum = cum + rng.uniform(0.0, 60.0, size=5)
        if k == 13:
            cum = rng.uniform(0.0, 10.0, size=5)  # controller restart
        est.update(0.5 * k, occ, cum.copy())
        out.append(_hex(est.utilization()))
    return out, est


@pytest.mark.parametrize("kind", ["ewma", "window"])
def test_estimators_match_reference(kind):
    got, est = _estimator_trace(PORT, kind)
    want, rest = _estimator_trace(REF, kind)
    assert got == want
    if kind == "window":
        assert est.resets == rest.resets == 1
    state, rstate = est.dump_state(), rest.dump_state()
    assert sorted(state) == sorted(rstate)
    back = _estimator(PORT, kind)
    back.load_state(state)
    assert _hex(back.utilization()) == _hex(est.utilization())


def test_make_estimator_matches_reference():
    cap = np.array([100.0, 40.0])
    for name in ("ewma", "window"):
        assert type(tel.make_estimator(name, 2, cap)).__name__ == type(
            ref_tel.make_estimator(name, 2, cap)).__name__
    with pytest.raises(ValueError):
        tel.make_estimator("kalman", 2, cap)


# -- the monitor and the belief --------------------------------------------------


def _booked_ledger(pkg):
    led = pkg["timeslot"].TimeSlotLedger(pkg["topo"].two_tier_fabric(2, 2, 100.0, 100.0),
                                         1.0, 64)
    for src, dst, size, nb in [("H0", "H2", 180.0, 0.0), ("H1", "H3", 90.0, 1.0),
                               ("H0", "H3", 250.0, 2.0), ("H2", "H1", 70.0, 4.5)]:
        rows = led.rows(led.fabric.path(src, dst))
        led.commit(led.plan_transfer(size, rows, not_before=nb))
    return led


def _monitor_trace(pkg, estimator):
    led = _booked_ledger(pkg)
    mon = pkg["tel"].LinkStatsMonitor(led, poll_interval=1.0, estimator=estimator)
    paths = [led.rows(led.fabric.path(a, b)) for a in HOSTS for b in HOSTS if a != b]
    out = []
    for t in (0.0, 0.5, 1.0, 2.75, 3.0):
        belief = mon.poll(t)
        slot = led.slot_of(t)
        out.append((
            _hex(mon.cum_bytes), _hex(belief.util),
            [float(belief.residual_fraction(r, slot)).hex() for r in paths],
            [float(belief.path_bandwidth(r, t)).hex() for r in paths],
            [float(belief.min_path_bandwidth(r, t, t + 1.0)).hex() for r in paths],
            _hex(belief.path_bandwidth_batch(paths, t)),
        ))
    led.retire(6.0)  # drops slots the monitor never sampled
    mon.poll(7.0)
    out.append((_hex(mon.cum_bytes), dict(mon.stats)))
    return out, mon


@pytest.mark.parametrize("estimator", ["ewma", "window"])
def test_monitor_and_belief_match_reference(estimator):
    got, mon = _monitor_trace(PORT, estimator)
    want, rmon = _monitor_trace(REF, estimator)
    assert got == want
    assert mon.stats["missed_slots"] >= 1
    snap, rsnap = mon.snapshot(), rmon.snapshot()
    assert {k: v for k, v in snap.items()} == {k: v for k, v in rsnap.items()}


def test_belief_empty_path_edge_semantics():
    for mod in (tel, ref_tel):
        belief = mod.BeliefState(np.array([100.0, 50.0]))
        belief.util[:] = [0.3, 0.9]
        assert belief.residual_fraction([], 0) == 1.0
        assert belief.path_bandwidth([], 0.0) == float("inf")
    got = tel.BeliefState(np.array([100.0, 50.0]))
    want = ref_tel.BeliefState(np.array([100.0, 50.0]))
    got.util[:] = want.util[:] = [0.3, 0.9]
    assert _hex(got.path_bandwidth_batch([[], [1], [0, 1]], 0.0)) == _hex(
        want.path_bandwidth_batch([[], [1], [0, 1]], 0.0))


def test_monitor_state_round_trip_matches_reference():
    led, rled = _booked_ledger(PORT), _booked_ledger(REF)
    mon = tel.LinkStatsMonitor(led, poll_interval=0.5, estimator="window")
    rmon = ref_tel.LinkStatsMonitor(rled, poll_interval=0.5, estimator="window")
    for t in (0.0, 1.5, 2.25):
        mon.poll(t)
        rmon.poll(t)
    back = tel.LinkStatsMonitor.load_state(led, mon.dump_state())
    rback = ref_tel.LinkStatsMonitor.load_state(rled, rmon.dump_state())
    for m in (back, rback):
        m.poll(4.0)
    assert _hex(back.cum_bytes) == _hex(rback.cum_bytes)
    assert _hex(back.belief.util) == _hex(rback.belief.util)


# -- telemetry=True schedules on a driven controller -----------------------------


def _driven(pkg, policy, poll, estimator, **est_kwargs):
    C, T = pkg["ctl"], pkg["tasks"]
    pol = C.BassPolicy(telemetry=True) if policy == "bass" else C.PreBassPolicy(telemetry=True)
    c = C.ClusterController(pkg["topo"].two_tier_fabric(2, 3),
                            [f"H{i}" for i in range(6)], pol,
                            idle={"H0": 6.0, "H1": 3.0})
    c.attach_telemetry(poll_interval=poll, estimator=estimator, **est_kwargs)
    rng = np.random.default_rng(3)
    tid = 0
    for j in range(3):
        tasks = []
        for _ in range(5):
            reps = tuple(rng.choice([f"H{i}" for i in range(3)], 2, replace=False))
            tasks.append(T.Task(tid, float(rng.integers(50, 300)), 2.0, reps))
            tid += 1
        c.submit(tasks, at=j * 4.0)
    c.inject_flow(T.BackgroundFlow("H0", "H4", 0.6, 1.0, 9.0))
    c.inject_flow(T.BackgroundFlow("H1", "H5", 0.9, 2.0, 14.0))
    c.run()
    counters = {k: v for k, v in c.obs.snapshot(trace_tail=0)["counters"].items()
                if k.startswith("telemetry.")}
    return convert.canon(c.schedule().assignments), _hex(c.telemetry.belief.util), counters


@pytest.mark.parametrize("policy", ["bass", "prebass"])
@pytest.mark.parametrize("poll,estimator,kw", [
    (0.5, "ewma", {}),
    (2.0, "ewma", {"alpha": 1.0}),
    (1.0, "window", {"window": 3.0}),
], ids=["ewma", "ewma_instant", "window"])
def test_telemetry_schedules_match_reference(backend, policy, poll, estimator, kw):
    got = _driven(PORT, policy, poll, estimator, **kw)
    want = _driven(REF, policy, poll, estimator, **kw)
    assert got == want
    assert got[2]["telemetry.polls"] > 1


def test_stale_belief_misroutes_as_in_reference(backend):
    """The reference suite's staleness probe: a belief polled before a
    saturating flow offloads into the congested trunk; the committed plan
    is booked on the true ledger."""
    def probe(pkg, telemetry, poll):
        C, T = pkg["ctl"], pkg["tasks"]
        c = C.ClusterController(pkg["topo"].two_tier_fabric(2, 2), HOSTS,
                                C.BassPolicy(telemetry=telemetry),
                                idle={"H0": 10.0, "H1": 10.0, "H2": 10.0, "H3": 0.0})
        c.attach_telemetry(poll_interval=poll)
        c.inject_flow(T.BackgroundFlow("H0", "H2", 0.95, 0.5, 50.0))
        c.submit([T.Task(0, 200.0, 3.0, ("H0",))], at=1.0)
        c.run()
        return convert.canon(c.schedule().assignments)

    for telemetry in (False, True):
        assert probe(PORT, telemetry, 100.0) == probe(REF, telemetry, 100.0)
    stale = probe(PORT, True, 100.0)
    assert stale[0][1] == "H3" and stale != probe(PORT, False, 100.0)
