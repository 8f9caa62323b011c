"""The readers of the program's spans (``metrics/prefill.*``, ``tick.*``,
``train.*_ms``, ``device.idle.train.optim``): nothing on an untraced CPU
run of either driver, the hand-worked number on a timeline of known
intervals, and nothing where the window lost a record, lacks a device
interval it needs or the program has no timeline."""
import types

import pytest

from portbench.harness import bench
from portbench.test_portbench_harness import (SERVE, SERVE_SMOKE, TRAIN, TRAIN_SMOKE, execute,
                                              one_thread, spec)  # noqa: F401 (fixtures)
from repro_torch.obs import SpanRecord, Timeline, default_registry

SERVE_METRICS = ("prefill.attn_ms", "prefill.mlp_ms", "prefill.norm_ms", "prefill.cache_ms",
                 "tick.enqueue_ms", "tick.device_ms")
TRAIN_METRICS = ("train.fwd_ms", "train.bwd_ms", "train.optim_ms", "device.idle.train.optim")
#: By hand from the timelines below (seconds there, milliseconds and % here).
#: The device readers count only the trace's busy time inside a span.
EXPECTED = {"prefill.attn_ms": 140.0, "prefill.mlp_ms": 150.0, "prefill.norm_ms": 75.0,
            "prefill.cache_ms": 100.0, "tick.enqueue_ms": 250.0, "tick.device_ms": 300.0,
            "train.fwd_ms": 1175.0, "train.bwd_ms": 1350.0, "train.optim_ms": 550.0,
            "device.idle.train.optim": 6.0}
#: The readers that need no device interval.
HOST_ONLY = ("tick.enqueue_ms", "device.idle.train.optim")


def test_the_new_metrics_are_the_programs_spans(spec):
    new = {m["name"]: m for m in spec["per_layer"] if m["name"] in EXPECTED}
    assert list(new) == list(SERVE_METRICS + TRAIN_METRICS)
    assert [m["name"] for m in spec["per_layer"][-len(new):]] == list(new)
    for name, m in new.items():
        cells = [SERVE, "nemo12b.shortdoc"] if name in SERVE_METRICS else [
            TRAIN, "internvl2-1b.train-accum4"]
        assert m["source"] == "program_span" and m["workloads"] == cells
        assert m["unit"] == ("%" if name.startswith("device") else "ms")


@pytest.fixture(scope="module")
def untraced(spec):
    return {SERVE: execute(spec, SERVE, **SERVE_SMOKE)[0],
            TRAIN: execute(spec, TRAIN, **TRAIN_SMOKE)[0]}


@pytest.mark.parametrize("name", SERVE_METRICS + TRAIN_METRICS)
def test_a_reader_reads_nothing_on_an_untraced_cpu_run(untraced, name):
    run = untraced[SERVE if name in SERVE_METRICS else TRAIN]
    assert run.window[1] > run.window[0] and run.attempted > 0
    assert bench.read_metric(name, run) is None


class _Trace:
    """What the readers take of a ``DeviceTrace``: its window, its idle
    gaps and the busy intervals between them."""

    def __init__(self, window, gaps):
        self.window, self._gaps = window, gaps

    def idle_gaps(self):
        return list(self._gaps)

    def busy(self):
        edges = [self.window[0]] + [t for gap in self._gaps for t in gap] + [self.window[1]]
        return [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]


def _timeline(rows) -> Timeline:
    """``rows``: (name, parent row or None, host start, end, device
    interval or None[, thread, 0 if not given]); ids are the rows' places
    from 1."""
    tl = Timeline()
    for i, (name, parent, start, end, dev, *thread) in enumerate(rows):
        rec = SpanRecord(name, i + 1, parent, None, *thread)
        rec.start, rec.end = start, end
        if dev is not None:
            rec.dev_start, rec.dev_end = dev
        tl.records.append(rec)
    return tl


def _admission(first: int, t: float, norms, attn, mlp, pad, write):
    """An admission's rows from row ``first`` at time ``t``: its prefill of
    one layer (device times as given) and its cache work."""
    a, p = first, first + 1
    return [("engine.admit", None, t, t + 1.0, (t, t + 1.0)),
            ("model.prefill", a, t, t + 0.8, (t, t + 0.8)),
            ("layer.norm", p, t, t + 0.1, (t, t + norms[0])),
            ("layer.attn", p, t + 0.1, t + 0.4, (t + 0.1, t + 0.1 + attn)),
            ("layer.norm", p, t + 0.4, t + 0.45, (t + 0.4, t + 0.4 + norms[1])),
            ("layer.mlp", p, t + 0.45, t + 0.7, (t + 0.45, t + 0.45 + mlp)),
            ("prefill.pad", p, t + 0.7, t + 0.8, (t + 0.7, t + 0.7 + pad)),
            ("engine.write_slot", a, t + 0.8, t + 0.9, (t + 0.8, t + 0.8 + write))]


def serve_rows():
    rows = _admission(1, 1.0, (0.05, 0.04), 0.28, 0.24, 0.08, 0.06)
    rows += _admission(9, 3.0, (0.03, 0.03), 0.20, 0.16, 0.04, 0.02)
    rows += [("engine.tick", None, 5.0, 5.5, (5.0, 5.5)),                # row 17
             ("model.decode", 17, 5.05, 5.35, (5.1, 5.45)),
             ("engine.tick", None, 6.0, 6.4, (6.0, 6.4)),                # row 19
             ("model.decode", 19, 6.0, 6.2, (6.05, 6.35))]
    # after the window: not counted
    rows += _admission(21, 20.0, (0.5, 0.5), 0.5, 0.5, 0.5, 0.5)
    return rows


def train_rows():
    return [("train.step", None, 0.0, 4.0, (0.0, 4.2)),                     # row 1
            ("train.forward", 1, 0.1, 1.0, (0.2, 1.1)),
            ("train.backward", 1, 1.0, 2.0, (1.1, 2.3)),
            ("train.forward", 1, 2.0, 2.5, (2.3, 2.8)),
            ("train.backward", 1, 2.5, 3.0, (2.8, 3.4)),
            ("train.optim", 1, 3.0, 4.0, (3.4, 4.2)),
            ("train.step", None, 5.0, 8.0, (5.0, 8.0)),                     # row 7
            ("train.forward", 7, 5.0, 6.0, (5.1, 6.1)),
            ("train.backward", 7, 6.0, 7.0, (6.1, 7.3)),
            ("train.optim", 7, 7.0, 8.0, (7.3, 7.9)),                       # row 10
            ("optim.leaf", 10, 7.5, 7.7, None),
            ("data.batch", None, 7.25, 7.35, None, 1),                      # another thread
            ("train.step", None, 12.0, 13.0, (12.0, 13.0)),                 # after the window
            ("train.forward", 13, 12.0, 13.0, (12.0, 13.0))]


#: Idle gaps of the trace: under the first step (0.05), optim (0.2),
#: optim (0.1), nothing open (0.4), the second forward (0.05), optim (0.2:
#: another thread's span is open then) and a span under it (0.1).  In the
#: serving rows: inside the second admission's attention (whole), its MLP
#: (0.1) and the first tick's decode (0.05).
GAPS = [(0.0, 0.05), (3.1, 3.3), (3.5, 3.6), (4.5, 4.9), (5.2, 5.25), (7.2, 7.4),
        (7.55, 7.65)]


def synthetic_run(monkeypatch, name, *, lost=False, no_device=False):
    rows = serve_rows() if name in SERVE_METRICS else train_rows()
    tl = _timeline(rows)
    if lost:
        tl.dropped, tl.dropped_until = 1, 0.5
    if no_device:
        part = "model.decode" if name in SERVE_METRICS else "train.optim"
        part = {"prefill.attn_ms": "layer.attn", "prefill.mlp_ms": "layer.mlp",
                "prefill.norm_ms": "layer.norm", "prefill.cache_ms": "engine.write_slot",
                "train.fwd_ms": "train.forward", "train.bwd_ms": "train.backward"}.get(name, part)
        rec = next(r for r in tl.records if r.name == part)
        rec.dev_start = rec.dev_end = None
    monkeypatch.setattr(default_registry(), "timeline", tl)
    return types.SimpleNamespace(window=(0.0, 10.0), device_trace=_Trace((0.0, 10.0), GAPS))


@pytest.mark.parametrize("name", SERVE_METRICS + TRAIN_METRICS)
def test_a_reader_reads_the_hand_worked_number(monkeypatch, name):
    run = synthetic_run(monkeypatch, name)
    assert bench.read_metric(name, run) == pytest.approx(EXPECTED[name], rel=1e-9)


@pytest.mark.parametrize("case", ["lost", "no_device", "no_timeline"])
@pytest.mark.parametrize("name", SERVE_METRICS + TRAIN_METRICS)
def test_a_reader_reads_nothing_without_the_whole_window(monkeypatch, name, case):
    run = synthetic_run(monkeypatch, name, lost=case == "lost", no_device=case == "no_device")
    if case == "no_timeline":     # the program before its timeline
        monkeypatch.delattr(default_registry(), "timeline")
    got = bench.read_metric(name, run)
    if case == "no_device" and name in HOST_ONLY:
        assert got == pytest.approx(EXPECTED[name], rel=1e-9)
    else:
        assert got is None
