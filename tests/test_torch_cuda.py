"""The K1 kernel on the card: each gather form against its plain PyTorch
version on CPU copies of the same inputs, and the scheduling slice on the
``cuda`` backend against the numpy reference — bit for bit throughout.

Every test here needs a Hopper card and skips without one.  On a machine
with one: ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ts_plan, ts_plan_device

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("the kernels are built for capability (9, 0) only")
    prev = ts_plan.get_backend()
    ts_plan.set_backend("cuda")
    yield torch.device("cuda", torch.cuda.current_device())
    ts_plan.set_backend(prev)


def _bits(x):
    x = x.cpu()
    return x.view(torch.int64) if x.dtype == torch.float64 else x


def _same(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype
        assert torch.equal(_bits(g), _bits(r))


def _mirror(rng, R, Wm):
    M = rng.random((R, Wm))
    u = rng.random((R, Wm))
    M[u < 0.3] = 0.0
    M[u > 0.9] = 1.0
    return M


SHAPES = [(1, 1, 1), (9, 4, 64), (33, 9, 200), (1024, 4, 64), (3, 2, 4096)]


@pytest.mark.parametrize("n,L,W", SHAPES)
def test_window_form_matches_plain(card, n, L, W):
    rng = np.random.default_rng(n + L + W)
    R, Wm, dur = 64, W + 100, 0.1
    M = _mirror(rng, R, Wm)
    pad = rng.integers(0, R, size=(n, L))
    off = rng.integers(0, Wm - W + 1, size=n)
    sz = off + 500
    t0 = sz * dur - rng.uniform(0, dur, size=n)
    first = rng.uniform(1e-3, dur, size=n)
    caps = rng.uniform(1.0, 37.0, size=n)
    sizes = rng.uniform(0.0, 0.05 * W * 37.0, size=n)
    sizes[0] = 0.0
    host = [torch.from_numpy(np.ascontiguousarray(x))
            for x in (M, pad, off, caps, first, sizes, sz, t0)]
    got = ts_plan_device.scan_window(*(h.to(card) for h in host), dur, W)
    _same(got, ts_plan.wave_scan_torch(*host, dur, W))


@pytest.mark.parametrize("n,L,W", SHAPES)
def test_columns_form_matches_plain(card, n, L, W):
    rng = np.random.default_rng(n * L + W)
    R, Wm = 64, W + 100
    host = [torch.from_numpy(np.ascontiguousarray(x)) for x in (
        _mirror(rng, R, Wm), rng.integers(0, R, size=(n, L)),
        rng.integers(0, Wm, size=(n, W)), rng.uniform(1.0, 37.0, size=n),
        rng.uniform(0.0, 0.13, size=(n, W)), rng.uniform(0.0, 0.05 * W * 37.0, size=n),
    )]
    got = ts_plan_device.scan_columns(*(h.to(card) for h in host))
    _same(got, ts_plan.col_scan_torch(*host))


@pytest.mark.parametrize("cap", [None, 3.7])
@pytest.mark.parametrize("n,L,W", SHAPES)
def test_dense_form_matches_numpy(card, n, L, W, cap):
    rng = np.random.default_rng(7 * n + W)
    booked = rng.random((n, L, W))
    overlay = (rng.random((n, L, W)) < 0.2).astype(np.float64)
    caps = rng.uniform(1.0, 37.0, size=n)
    secs = rng.uniform(0.0, 1.3, size=(n, W))
    sizes = rng.uniform(0.5, 0.3 * W * 37.0, size=n)
    launches = ts_plan_device.stats["launches_dense"]
    got = ts_plan.plan_scan(booked, caps, secs, sizes, cap, overlay)
    assert ts_plan_device.stats["launches_dense"] == launches + 1
    ref = ts_plan.plan_scan_numpy(booked, caps, secs, sizes, cap, overlay)
    for g, r in zip(got, ref):
        assert np.array_equal(np.asarray(g).view(np.int64) if g.dtype == np.float64 else g,
                              np.asarray(r).view(np.int64) if r.dtype == np.float64 else r)


def test_fleet_slice_on_the_card_matches_numpy(card):
    from repro_torch.convert import canon
    from repro_torch.core import ClusterController, Instance, Task, tpu_dcn_fabric

    def instance():
        fab = tpu_dcn_fabric(n_pods=2, hosts_per_pod=32)
        workers = [f"pod{p}/host{h}" for p in range(2) for h in range(32)]
        rng = np.random.default_rng(0)
        idx = rng.integers(0, 64, size=(3000, 3))
        tasks = [Task(i, float(256e6 + (i % 7) * 64e6), 0.05,
                      tuple(workers[j] for j in idx[i])) for i in range(3000)]
        idle = {w: float(rng.uniform(0, 2.0)) for w in workers}
        return Instance(fab, workers, idle, tasks, slot_duration=0.1)

    def run(backend):
        ts_plan.set_backend(backend)
        inst = instance()
        ctrl = ClusterController.from_instance(inst)
        for i in range(0, 3000, 1024):
            ctrl.submit(inst.tasks[i:i + 1024], at=0.0)
            ctrl.run_until(0.0)
        return ctrl

    ts_plan_device.stats.reset()
    waves = ts_plan.calls["wave_scan"]
    on_card = run("cuda")
    assert ts_plan_device.stats["launches_window"] == ts_plan.calls["wave_scan"] - waves > 0
    reference = run("numpy")
    assert canon(on_card.schedule().assignments) == canon(reference.schedule().assignments)
    mirror = on_card.state.ledger.device_mirror()
    assert mirror.device.type == "cuda"
    mirror.sync()
    assert np.array_equal(mirror.host_view(), on_card.state.ledger.reserved)


def test_multipath_and_switch_kill_on_the_card_match_numpy(card):
    """Pairs-mode waves (``wave_select`` on the card) and a core switch
    killed under in-flight transfers (column scans on the card)."""
    from repro_torch.convert import canon
    from repro_torch.core import BassPolicy, ClusterController, Task, storage_hosts
    from repro_torch.net import fat_tree_fabric

    def run(backend):
        ts_plan.set_backend(backend)
        fab = fat_tree_fabric(4)
        hosts = storage_hosts(fab)
        sources, workers = hosts[:8], hosts[8:]
        rng = np.random.default_rng(11)
        idle = {w: float(rng.uniform(0, 2.0)) for w in workers}
        ctrl = ClusterController(fab, workers, BassPolicy(multipath=True, k_paths=3),
                                 idle=idle, slot_duration=0.1)
        tasks = [Task(i, float(rng.uniform(100, 700)), 0.05,
                      tuple(rng.choice(sources, 3, replace=False))) for i in range(160)]
        ctrl.submit(tasks[:80], at=0.0)
        ctrl.run_until(0.0)
        ctrl.fail_switch("core0_0", at=0.5)
        ctrl.submit(tasks[80:], at=1.0)
        ctrl.run()
        return ctrl

    ts_plan_device.stats.reset()
    selects = ts_plan.calls["wave_select"]
    on_card = run("cuda")
    assert ts_plan.calls["wave_select"] > selects
    assert ts_plan_device.stats["launches_columns"] > 0
    reference = run("numpy")
    assert canon(on_card.schedule().assignments) == canon(reference.schedule().assignments)
    assert len(on_card.reroute_log) == len(reference.reroute_log) > 0
    for a, b in zip(on_card.reroute_log, reference.reroute_log):
        assert (a.flow, a.old_path, a.new_path, float(a.delivered).hex(),
                float(a.remaining).hex()) == (b.flow, b.old_path, b.new_path,
                                              float(b.delivered).hex(),
                                              float(b.remaining).hex())
