"""The port's planning scan held against the JAX package's.

Inputs come from seeded numpy and go through the reference
(``repro.kernels.ts_plan``: the numpy oracle, and the Pallas TPU kernel in
interpret mode) and through the port's ``numpy`` and ``torch`` backends on
CPU tensors.  The tolerance is bit-exact throughout: ``np.array_equal`` on
float64.  The port is not held against ``repro.kernels.ts_plan_device``'s
f64 pipelines, whose scoped ``enable_x64`` import this jax no longer has.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core.timeslot import TimeSlotLedger as RefLedger
from repro.core.timeslot import TransferPlan as RefPlan
from repro.core.topology import two_tier_fabric as ref_two_tier
from repro.kernels import ts_plan as ref_ts_plan
from repro_torch.core.timeslot import TimeSlotLedger, TransferPlan
from repro_torch.core.topology import two_tier_fabric
from repro_torch.kernels import ts_plan, ts_plan_device

SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")


@pytest.fixture(autouse=True)
def _torch_backend():
    prev = ts_plan.get_backend()
    ts_plan.set_backend("torch")
    yield
    ts_plan.set_backend(prev)


def _inputs(seed, n, L, W, dyadic=False):
    rng = np.random.default_rng(seed)
    if dyadic:
        booked = rng.integers(0, 9, size=(n, L, W)) / 8.0
        caps = 2.0 ** rng.integers(0, 5, size=n)
        secs = np.ones((n, W))
        secs[:, 0] = 0.5
        sizes = rng.integers(1, 40, size=n).astype(np.float64)
    else:
        booked = rng.random((n, L, W))
        caps = rng.uniform(1.0, 37.0, size=n)
        secs = rng.uniform(0.0, 1.3, size=(n, W))
        sizes = rng.uniform(0.5, 60.0, size=n)
    return booked, caps, secs, sizes


def _assert_same(ref, got, names=("resid", "bw", "cum", "hit", "end")):
    assert len(ref) == len(got)
    for name, r, g in zip(names, ref, got):
        r = np.asarray(r, np.float64)
        g = np.asarray(g, np.float64)
        assert r.shape == g.shape, name
        assert np.array_equal(r, g), name


def _ports(booked, caps, secs, sizes, cap=None, overlay=None):
    """The port's three ways to the dense scan on the CPU."""
    t = lambda x: None if x is None else torch.from_numpy(np.asarray(x))  # noqa: E731
    plain = ts_plan.plan_scan_torch(t(booked), t(caps), t(secs), t(sizes), cap, t(overlay))
    return {
        "numpy": ts_plan.plan_scan_numpy(booked, caps, secs, sizes, cap, overlay),
        "plain": tuple(x.numpy() for x in plain),
        "device_cpu": ts_plan_device.plan_scan(
            booked, caps, secs, sizes, cap, overlay, device="cpu"
        ),
        "dispatch": ts_plan.plan_scan(booked, caps, secs, sizes, cap, overlay),
    }


# -- the dense scan: bit-exact on arbitrary float64 inputs -------------------


@pytest.mark.parametrize("n", [1, 7, 8, 9, 33])
@pytest.mark.parametrize("L", [1, 8, 9])
@pytest.mark.parametrize("W", [1, 64, 200])
def test_plan_scan_bitwise_any_input(n, L, W):
    booked, caps, secs, sizes = _inputs(3 * n + L + W, n, L, W)
    ref = ref_ts_plan.plan_scan_numpy(booked, caps, secs, sizes)
    for got in _ports(booked, caps, secs, sizes).values():
        _assert_same(ref, got)


@pytest.mark.parametrize("with_overlay", [False, True])
@pytest.mark.parametrize("cap", [None, 16.0, 3.7])
def test_plan_scan_overlay_and_cap_combos(cap, with_overlay):
    booked, caps, secs, sizes = _inputs(11, 9, 3, 48)
    rng = np.random.default_rng(99)
    overlay = (
        (rng.random(booked.shape) < 0.2).astype(np.float64)
        if with_overlay else None
    )
    ref = ref_ts_plan.plan_scan_numpy(booked, caps, secs, sizes, cap, overlay)
    for got in _ports(booked, caps, secs, sizes, cap, overlay).values():
        _assert_same(ref, got)


@pytest.mark.parametrize(
    "n,W", [(1, 4096), (2, 300), (8, 64), (40, 16), (7, 1)]
)
def test_hit_count_both_regimes(n, W):
    # _hit_count searches per row for few long rows and counts otherwise;
    # the plain version always counts.  Both must give the reference hits.
    booked, caps, secs, sizes = _inputs(n * W, n, 2, W)
    sizes = np.concatenate([sizes[: n - 1], [1e9]])  # one never-fitting row
    ref = ref_ts_plan.plan_scan_numpy(booked, caps, secs, sizes)
    assert ref[3][-1] == W
    for got in _ports(booked, caps, secs, sizes).values():
        _assert_same(ref, got)


# -- against the TPU kernel itself (Pallas, interpret mode) ------------------


@pytest.mark.parametrize(
    "n,L,W",
    [
        (7, 3, 127),   # below every pad boundary of the TPU kernel
        (8, 8, 128),   # exactly on the BN / L-pad / lane boundaries
        (9, 9, 129),   # just past all three
        (24, 4, 256),  # multi-block grid, two full lanes
    ],
)
@pytest.mark.parametrize("cap", [None, 16.0])
def test_plain_matches_pallas_kernel(n, L, W, cap):
    # The TPU kernel is float32 with a tree prefix sum, exact only on
    # float64-safe (dyadic) inputs; there the port must match it exactly.
    booked, caps, secs, sizes = _inputs(n + L + W, n, L, W, dyadic=True)
    ref = ref_ts_plan.plan_scan_pallas(
        booked, caps, secs, sizes, cap, interpret=True
    )
    _assert_same(ref, _ports(booked, caps, secs, sizes, cap)["plain"])


def test_plain_matches_pallas_kernel_overlay():
    booked, caps, secs, sizes = _inputs(21, 9, 3, 130, dyadic=True)
    overlay = np.zeros_like(booked)
    overlay[::2, 0, ::3] = 1.0
    ref = ref_ts_plan.plan_scan_pallas(
        booked, caps, secs, sizes, None, overlay, interpret=True
    )
    _assert_same(ref, _ports(booked, caps, secs, sizes, None, overlay)["plain"])


# -- the plain version's prefix sum ------------------------------------------


@pytest.mark.parametrize("n,W", [(5, 1), (33, 64), (7, 4096), (2, 65536)])
def test_cpu_cumsum_matches_numpy(n, W):
    """CPU float64 ``torch.cumsum`` adds in order, like ``np.cumsum`` — the
    property that makes the plain version an exact oracle."""
    rng = np.random.default_rng(W)
    x = rng.uniform(0.0, 1.3, size=(n, W)) * rng.uniform(1.0, 37.0, size=(n, 1))
    got = torch.cumsum(torch.from_numpy(x), dim=1).numpy()
    assert np.array_equal(np.cumsum(x, axis=1), got)


# -- fused pipelines through the mirror ---------------------------------------


def _twin_ledgers():
    """A reference ledger and a port ledger with the same bookings."""
    ref = RefLedger(ref_two_tier(2, 4, 100.0, 100.0), 1.0, 64)
    led = TimeSlotLedger(two_tier_fabric(2, 4, 100.0, 100.0), 1.0, 64)
    rng = np.random.default_rng(5)
    for s in range(12):
        frac = float(rng.integers(1, 7)) / 8.0 + float(rng.random()) / 64.0
        for L, P in ((ref, RefPlan), (led, TransferPlan)):
            rows = L.path_rows("H0", "H5")
            L.commit(P(tuple(rows), float(s), float(s + 1), ((s, frac),)))
    assert np.array_equal(ref.reserved, led.reserved)
    return ref, led


def _wave_inputs(led):
    rows_a = led.path_rows("H0", "H5")
    rows_b = led.path_rows("H2", "H7")
    pad = np.array([rows_a, rows_b, rows_b, rows_a], dtype=np.intp)
    caps = np.array([100.0, 50.0, 100.0, 37.5])
    sz = np.array([0, 2, 5, 9], dtype=np.int64)
    t0c = np.array([0.0, 2.25, 5.0, 9.5])
    sizes = np.array([120.0, 60.0, 0.0, 1e6])
    first = np.array([1.0, 0.75, 1.0, 0.5])
    return pad, caps, sz, t0c, sizes, first


@pytest.mark.parametrize("w", [1, 16, 64, 256])
def test_wave_scan_parity(w):
    ref_led, led = _twin_ledgers()
    args = _wave_inputs(led)
    pad, caps, sz, t0c, sizes, first = args
    ref = ref_ts_plan.wave_scan_numpy(ref_led, pad, caps, sz, t0c, sizes, w, first)
    _assert_same(ref, ts_plan.wave_scan(led, pad, caps, sz, t0c, sizes, w, first))
    _assert_same(ref, ts_plan.wave_scan_numpy(led, pad, caps, sz, t0c, sizes, w, first))
    uploads = ts_plan_device.stats["mirror_uploads"]
    ts_plan.wave_scan(led, pad, caps, sz, t0c, sizes, w, first)
    # a second wave on an unchanged ledger re-uses the resident mirror
    assert ts_plan_device.stats["mirror_uploads"] == uploads


def test_col_scan_parity():
    ref_led, led = _twin_ledgers()
    pad, caps, _sz, _t0c, sizes, _first = _wave_inputs(led)
    cols = np.array(
        [[0, 1, 5, 9, 13], [2, 3, 4, 8, 20], [5, 6, 7, 30, 31], [9, 10, 11, 12, 40]],
        dtype=np.int64,
    )
    secs = np.random.default_rng(3).uniform(0.2, 1.0, size=cols.shape)
    booked = ref_led.reserved[
        pad[:, :, None], (cols - ref_led.base_slot)[:, None, :]
    ]
    ref = ref_ts_plan.plan_scan_numpy(booked, caps, secs, sizes + 1.0)
    _assert_same(ref, ts_plan.col_scan(led, pad, cols, caps, secs, sizes + 1.0))


# -- winner selection ----------------------------------------------------------


def test_wave_select_tie_parity():
    rng = np.random.default_rng(7)
    counts = [1, 2, 5, 8, 3]
    nc = sum(counts)
    # Exact float ties on purpose: draw ends from a tiny dyadic pool.
    end = rng.integers(0, 3, size=nc) / 4.0
    end[4] = np.inf  # whole-segment unfit ties on rank alone
    end[5] = np.inf
    lens = rng.integers(1, 4, size=nc)
    srcs = rng.integers(0, 3, size=nc).astype(str)
    ranks = np.empty(nc, dtype=np.int64)
    expect = []
    pos = 0
    for cnt in counts:
        order = sorted(range(cnt), key=lambda c: (lens[pos + c], srcs[pos + c], c))
        for r, c in enumerate(order):
            ranks[pos + c] = r
        expect.append(
            min(range(cnt), key=lambda c: (end[pos + c], lens[pos + c], srcs[pos + c], c))
        )
        pos += cnt
    ref = ref_ts_plan.wave_select_numpy(end, ranks, counts)
    assert np.array_equal(ref, np.array(expect))
    assert np.array_equal(ts_plan.wave_select_numpy(end, ranks, counts), ref)
    assert np.array_equal(ts_plan.wave_select(end, ranks, counts), ref)


# -- backend selection ---------------------------------------------------------


def test_unknown_backend_rejected():
    with pytest.raises(ValueError):
        ts_plan.set_backend("auto")


def test_default_backend_is_the_kernel_and_never_falls_back():
    """A fresh process starts on ``cuda``; without a card the first scan
    raises instead of answering through numpy or the plain version."""
    code = (
        "import numpy as np, torch\n"
        "from repro_torch.kernels import ts_plan\n"
        "assert ts_plan.get_backend() == 'cuda', ts_plan.get_backend()\n"
        "if not torch.cuda.is_available():\n"
        "    b = np.zeros((2, 1, 4)); c = np.ones(2); s = np.ones((2, 4))\n"
        "    try:\n"
        "        ts_plan.plan_scan(b, c, s, c)\n"
        "    except RuntimeError as e:\n"
        "        assert 'CUDA' in str(e), e\n"
        "    else:\n"
        "        raise SystemExit('cuda backend answered without a card')\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": SRC}, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
