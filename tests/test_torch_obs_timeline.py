"""The port's span timeline (``repro_torch.obs``): recorded exactly while
a ``torch.profiler`` session collects, one record a span entry with its
parent, thread and key; the serving engine's and the train step's span
trees at
``TINY`` on the CPU (host times only: no device marks without CUDA); the
bounded ring's drops; the window's queries; and that recording changes no
number the program computes."""
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.kernels import ts_plan
from repro_torch.launch.serve import TINY as SERVE_TINY
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import TINY as TRAIN_TINY
from repro_torch.models.model import Model
from repro_torch.models.params import flatten
from repro_torch.obs import Registry, Span, SpanRecord, Timeline, Window, default_registry
from repro_torch.obs import device as obs_device
from repro_torch.optim import AdamW, constant
from repro_torch.serving import BassRouter, Request, ServeEngine

TIMELINE = default_registry().timeline
LAYER = ("layer.norm", "layer.attn", "layer.norm", "layer.mlp")


@pytest.fixture(autouse=True)
def fresh_timeline():
    ts_plan.set_backend("numpy")
    TIMELINE.clear()
    yield
    TIMELINE.clear()


def recording():
    return profile(activities=[ProfilerActivity.CPU])


def serve_once(seed: int = 0):
    """One routed admission and one tick at ``TINY`` → the tokens served."""
    model = Model(SERVE_TINY)
    params = model.init(torch.Generator().manual_seed(seed), "cpu")
    engine = ServeEngine(model, params, 2, 32, device="cpu")
    router = BassRouter(["replica0"])
    req = Request(rid=7, prompt=np.arange(2, 12, dtype=np.int32), max_new=3)
    router.route(req)
    engine.admit(req)
    engine.tick()
    return list(req.tokens_out)


def train_once(accum: int = 2, steps: int = 1):
    """``steps`` steps of ``make_train_step`` at ``TINY`` → (losses, the
    parameters' leaves)."""
    model = Model(TRAIN_TINY)
    params = model.init(torch.Generator().manual_seed(3), "cpu")
    opt = AdamW(lr=constant(1e-2))
    state = opt.init(params)
    step = make_train_step(model, opt, accum=accum, donate=True)
    g = torch.Generator().manual_seed(4)
    losses = []
    for _ in range(steps):
        batch = {"tokens": torch.randint(2, TRAIN_TINY.vocab_size, (4, 16), generator=g)}
        params, state, metrics = step(params, state, batch)
        losses.append(metrics["loss"])
    return losses, [leaf for _, leaf in flatten(params)]


def window() -> Window:
    win = TIMELINE.window(float("-inf"), float("inf"))
    assert win is not None
    return win


def children(win: Window, rec: SpanRecord):
    return [r for r in win.records if r.parent == rec.id]


def registry(tl: Timeline) -> Registry:
    reg = Registry()
    reg.timeline = tl
    return reg


def test_nothing_is_recorded_without_a_profiler():
    serve_once()
    train_once(steps=1)
    assert len(TIMELINE.records) == 0 and TIMELINE.dropped == 0
    assert TIMELINE.window(float("-inf"), float("inf")) is None
    # the cumulative counters go on as before
    snap = default_registry().snapshot()
    assert snap["spans"]["engine.admit"]["count"] >= 1
    assert set(snap["spans"]["engine.admit"]) == {"count", "total_s"}


def test_an_admission_and_a_tick_give_the_span_tree():
    with recording():
        serve_once()
    win = window()
    roots = [r for r in win.records if r.parent is None]
    assert [(r.name, r.key) for r in roots] == [("router.route", 7), ("engine.admit", 7),
                                                ("engine.tick", 0)]
    route, admit, tick = roots
    assert [r.name for r in children(win, admit)] == ["model.prefill", "engine.write_slot"]
    prefill = children(win, admit)[0]
    assert [r.name for r in children(win, tick)] == ["model.decode"]
    n = SERVE_TINY.n_layers
    assert [(r.name, r.key) for r in children(win, prefill)] == [
        (name, layer) for layer in range(n) for name in LAYER] + [("prefill.pad", None)]
    # the decode step's layers carry no spans: nothing reads them
    assert not children(win, children(win, tick)[0])
    # no device marks on the CPU: host times only
    assert all(r.dev_start is None and r.dev_end is None for r in win.records)
    assert win.under("layer.attn", "model.prefill") == [r for r in children(win, prefill)
                                                        if r.name == "layer.attn"]
    assert win.under("layer.norm", "engine.tick") == []


def test_a_train_step_with_two_microbatches_gives_its_span_tree():
    with recording():
        train_once(accum=2, steps=1)
    win = window()
    steps = win.named("train.step")
    assert [r.key for r in steps] == [0]
    kids = [(r.name, r.key) for r in children(win, steps[0])]
    assert kids == [("train.forward", 0), ("train.backward", 0), ("train.forward", 1),
                    ("train.backward", 1), ("train.optim", None)]
    # the layers mark their parts in a prefill only, neither in the loss's
    # forward nor in the backward's recompute
    assert not any(r.name.startswith("layer.") for r in win.records)
    assert not children(win, win.named("train.optim")[0])
    assert {r.thread for r in win.records} == {threading.get_ident()}


def test_host_intervals_nest():
    with recording():
        serve_once()
        train_once(accum=2, steps=1)
    win = window()
    by_id = {r.id: r for r in win.records}
    assert len(by_id) == len(win.records) > 20
    for rec in win.records:
        assert rec.start <= rec.end
        if rec.parent is not None:
            up = by_id[rec.parent]
            assert up.start <= rec.start and rec.end <= up.end
    for a, b in zip(win.records, win.records[1:]):     # siblings do not overlap
        if a.parent == b.parent:
            assert a.end <= b.start


@pytest.mark.parametrize("path", ["serve", "train"])
def test_recording_changes_no_number(path):
    run = serve_once if path == "serve" else (lambda: train_once(accum=2, steps=2))
    off = run()
    with recording():
        on = run()
    assert len(TIMELINE.records) > 0
    if path == "serve":
        assert on == off
    else:
        assert all(torch.equal(a, b) for a, b in zip(on[0], off[0]))
        assert all(torch.equal(a, b) for a, b in zip(on[1], off[1]))


def _ring(capacity: int) -> Timeline:
    tl = Timeline(capacity)
    tl.probe = lambda: True
    return tl


@pytest.mark.parametrize("entries, kept, dropped", [(3, 3, 0), (4, 4, 0), (7, 4, 3)])
def test_the_ring_drops_its_oldest_records_and_counts_them(entries, kept, dropped):
    tl = _ring(4)
    sp = registry(tl).span("s")
    ends = []
    for i in range(entries):
        with sp(i):
            pass
        ends.append(tl.records[-1].end)
    assert [r.key for r in tl.records] == list(range(entries - kept, entries))
    assert tl.dropped == dropped and sp.count == entries
    if dropped:
        assert tl.dropped_until == ends[dropped - 1]
        assert tl.window(ends[dropped - 1], ends[-1]) is None       # lost a record
        win = tl.window(ends[dropped - 1] + 1e-9, ends[-1])
        assert win is not None and [r.key for r in win.records] == list(range(dropped, entries))
    else:
        assert tl.window(0.0, ends[-1]) is not None


def test_a_record_dropped_while_open_loses_every_later_window():
    tl = _ring(2)
    reg = registry(tl)
    with reg.span("outer")("o"):
        for i in range(3):
            with reg.span("inner")(i):
                pass
    assert tl.dropped == 2 and tl.dropped_until == float("inf")
    assert tl.window(0.0, float("inf")) is None


def test_spans_nest_by_thread_and_keys_are_consumed():
    tl = _ring(64)
    reg = registry(tl)
    outer, inner = reg.span("outer"), reg.span("inner")
    with outer("a"):
        with inner():
            pass
        with inner(5):
            with inner(6):              # each entry its own: a span inside itself
                pass
        other = threading.Thread(target=lambda: inner("t").__enter__().__exit__())
        other.start()
        other.join()
    with inner():
        pass
    with inner:                         # entered without a call: counted, not recorded
        pass
    recs = list(tl.records)
    assert [(r.name, r.key, r.parent) for r in recs] == [
        ("outer", "a", None), ("inner", None, recs[0].id), ("inner", 5, recs[0].id),
        ("inner", 6, recs[2].id), ("inner", "t", None), ("inner", None, None)]
    assert all(r.end is not None for r in recs) and inner.count == 6
    assert recs[2].start <= recs[3].start <= recs[3].end <= recs[2].end
    assert {r.thread for r in recs} == {threading.get_ident(), other.ident}
    assert [r.key for r in recs if r.thread == other.ident] == ["t"]


def test_the_window_answers_its_readers_questions():
    recs = []
    for i, (name, parent, start, end, dev, thread) in enumerate([
            ("step", None, 0.0, 10.0, (0.5, 9.0), 1),
            ("optim", 1, 6.0, 9.0, (6.5, 8.5), 1),
            ("leaf", 2, 7.0, 8.0, None, 1),
            ("batch", None, 8.4, 8.6, None, 2),
            ("step", None, 12.0, 20.0, (12.5, 19.0), 1)]):
        r = SpanRecord(name, i + 1, parent, i, thread)
        r.start, r.end = start, end
        if dev:
            r.dev_start, r.dev_end = dev
        recs.append(r)
    win = Window(recs, 0.0, 15.0)
    assert [r.key for r in win.named("step")] == [0, 4]
    assert [r.name for r in win.ancestors(recs[2])] == ["optim", "step"]
    assert win.under("leaf", "step") == [recs[2]] and win.under("leaf", "nothing") == []
    # one thread's spans: the other thread's batch, ended at 8.6, hides
    # nothing of the first's
    assert [win.innermost(t, 1) for t in (7.5, 8.5, 8.7, 9.5, 11.0, 13.0)] == [
        recs[2], recs[1], recs[1], recs[0], None, recs[4]]
    assert [win.innermost(t, 2) for t in (8.5, 8.7)] == [recs[3], None]
    assert win.innermost(8.5, 3) is None
    assert win.host_s(recs[:2]) == 13.0
    # only the busy time inside each device interval counts
    assert win.device_s(recs[:2], [(0.0, 100.0)]) == 8.5 + 2.0
    busy = [(0.0, 1.0), (2.0, 3.0), (7.0, 8.0), (8.4, 8.45), (9.5, 13.0)]
    assert win.device_s(recs[:2], busy) == pytest.approx((0.5 + 1.0 + 1.0 + 0.05)
                                                         + (1.0 + 0.05))
    assert win.device_s(recs[:2], []) == 0.0
    assert win.device_s(recs[:3], busy) is None


def test_a_span_without_a_timeline_only_counts():
    sp = Span("plain")
    with sp("ignored"):
        pass
    assert sp.count == 1 and sp.total_s >= 0 and sp.timeline is None
    assert Registry().span("x").timeline is None
    assert default_registry().span("engine.admit").device is True


def test_the_switch_is_the_profilers():
    assert TIMELINE.probe is torch._C._autograd._profiler_enabled
    assert isinstance(TIMELINE.clock, obs_device.CudaClock)
    assert obs_device.install() is TIMELINE and not TIMELINE.probe()
    with recording():
        assert TIMELINE.probe()
    # without CUDA in use a device span records host times only
    assert TIMELINE.clock.mark() is None
