"""The port's ledger mirror: ``host_view()`` equals ``ledger.reserved``
after every mutator (commit, occupy, release, release_after, commit_batch,
retire with an origin shift, width growth, direct ``reserved`` assignment).

These are the journal/sync scenarios the JAX package pins for its own
mirror, run here on a CPU torch device; bit-exact throughout.  Each one
also checks a wave scan through the synced mirror against the numpy
reference scan on the same ledger.
"""
import numpy as np
import pytest

from repro_torch.core.timeslot import TimeSlotLedger, TransferPlan
from repro_torch.core.topology import two_tier_fabric
from repro_torch.kernels import ts_plan, ts_plan_device


@pytest.fixture(autouse=True)
def _torch_backend():
    prev = ts_plan.get_backend()
    ts_plan.set_backend("torch")
    yield
    ts_plan.set_backend(prev)


def _ledger(horizon=64):
    fab = two_tier_fabric(2, 4, 100.0, 100.0)
    return TimeSlotLedger(fab, 1.0, horizon)


def _plan(led, rows, slot_fracs):
    start = slot_fracs[0][0] * led.slot_duration
    end = (slot_fracs[-1][0] + 1) * led.slot_duration
    return TransferPlan(tuple(rows), start, end, tuple(slot_fracs))


def _check(mirror, led):
    mirror.sync()
    assert np.array_equal(mirror.host_view(), led.reserved)
    # A wave through the synced mirror scans exactly what the ledger holds.
    rows = led.path_rows("H0", "H5")
    pad = np.array([rows, rows], dtype=np.intp)
    sz = np.array([led.base_slot, led.base_slot + 3], dtype=np.int64)
    args = (pad, np.array([100.0, 30.0]), sz, sz * 1.0,
            np.array([250.0, 40.0]), 16, np.array([1.0, 1.0]))
    ref = ts_plan.wave_scan_numpy(led, *args)
    got = ts_plan.wave_scan(led, *args)
    for r, g in zip(ref, got):
        assert np.array_equal(r, g)


def test_mirror_tracks_api_mutations():
    led = _ledger()
    mirror = led.device_mirror()
    assert mirror.device.type == "cpu"
    rows = led.path_rows("H0", "H5")
    _check(mirror, led)  # initial upload

    p1 = _plan(led, rows, [(2, 0.5), (3, 0.25)])
    led.commit(p1)
    p2 = _plan(led, rows, [(4, 1.0)])  # scalar fast path
    led.commit(p2)
    cells = ts_plan_device.stats["mirror_cells"]
    _check(mirror, led)
    assert ts_plan_device.stats["mirror_cells"] > cells

    led.occupy(rows[:2], 6.0, 9.0, 0.25)
    _check(mirror, led)

    led.release(p1)
    _check(mirror, led)

    p3 = _plan(led, rows, [(5, 0.5), (6, 0.5), (7, 0.5)])
    led.commit(p3)
    led.release_after(p3, 6.0)
    _check(mirror, led)

    other = led.path_rows("H1", "H6")
    led.commit_batch(
        [_plan(led, other, [(8, 0.5)]), _plan(led, rows, [(9, 0.25)])]
    )
    _check(mirror, led)


def test_mirror_survives_growth_and_origin_shift():
    led = _ledger(16)
    mirror = led.device_mirror()
    rows = led.path_rows("H0", "H5")
    led.commit(_plan(led, rows, [(3, 0.5)]))
    _check(mirror, led)

    led.commit(_plan(led, rows, [(40, 0.5)]))  # grows the window
    _check(mirror, led)

    led.commit(_plan(led, rows, [(700, 0.25)]))  # beyond the 256 bucket
    _check(mirror, led)

    led.retire_to(39)  # partial retire: origin shift, no invalidation
    led.commit(_plan(led, rows, [(41, 0.125)]))
    up0 = ts_plan_device.stats["mirror_uploads"]
    _check(mirror, led)
    assert mirror.base == 39
    assert ts_plan_device.stats["mirror_uploads"] == up0  # re-based in place

    led.retire_to(2000)  # full-past: reset through the setter → re-upload
    up0 = ts_plan_device.stats["mirror_uploads"]
    _check(mirror, led)
    assert ts_plan_device.stats["mirror_uploads"] == up0 + 1


def test_mirror_invalidated_by_direct_assignment():
    led = _ledger()
    mirror = led.device_mirror()
    rows = led.path_rows("H0", "H5")
    led.commit(_plan(led, rows, [(2, 0.5)]))
    _check(mirror, led)
    snap = led.reserved.copy()
    led.commit(_plan(led, rows, [(3, 0.5)]))
    led.reserved = snap  # controller restore(): setter must invalidate
    _check(mirror, led)
    led.reserved[list(rows), 5] = 0.5  # out-of-contract direct write...
    led.mirror_invalidate()            # ...declared, as reroute's paths do
    _check(mirror, led)


def test_mirror_pressure_valve_reuploads():
    """Past a quarter of the window in journaled cells, the journal is
    dropped and the next sync uploads the whole window instead."""
    led = _ledger(16)
    mirror = led.device_mirror()
    _check(mirror, led)
    up0 = ts_plan_device.stats["mirror_uploads"]
    for s in range(12):
        for a, b in (("H0", "H5"), ("H1", "H6"), ("H2", "H7"), ("H3", "H4")):
            led.commit(_plan(led, led.path_rows(a, b), [(s, 0.125)]))
    _check(mirror, led)
    assert ts_plan_device.stats["mirror_uploads"] == up0 + 1


def test_mirror_rehomes_when_the_device_changes():
    led = _ledger()
    mirror = led.device_mirror()
    _check(mirror, led)
    mirror.move_to("cpu")
    assert mirror.arr is None
    _check(mirror, led)
