"""Unified observability registry — counters, gauges, spans, flight recorder.

Every layer of the scheduler (controller event loop, wavefront planner,
reroute engine, TS ledger, device kernels, telemetry monitor) used to keep
its own ad-hoc stats dict.  This module gives them one home:

* :class:`Counter` / :class:`Gauge` — single named values.
* :class:`CounterGroup` — a ``MutableMapping[str, int|float]`` over named
  counters.  It is a drop-in replacement for the old plain dicts
  (``group["hits"] += 1``, ``dict(group)``, iteration, ``.get``) so the
  existing call sites and test assertions keep working unchanged.
* :class:`Span` — cumulative wall-clock timing with a context manager;
  a span of a registry that has a :class:`Timeline` also records each
  entry made through a call (``with span(key):``) as a
  :class:`SpanRecord` there while the timeline's switch is on.
* :class:`Timeline` — the process's bounded ring of span intervals (on
  :func:`default_registry`), with host and device times on one clock;
  :meth:`Timeline.window` hands a window of it to a reader
  (:class:`Window`).
* :class:`FlightRecorder` — a bounded ring of structured decision events,
  dumpable to JSONL.  Disabled by default so the scheduling hot path pays
  one attribute read per decision.
* :class:`Registry` — the per-controller container with a single
  :meth:`Registry.snapshot` that folds in lazily-evaluated *providers*
  (ledger occupancy, job metrics, kernel compile-cache stats, telemetry
  monitor state) alongside the registered counters.

The module is stdlib-only: importing it (and anything that imports it)
must never pull in jax — ``tests/test_obs.py`` enforces that in a
subprocess.
"""
from __future__ import annotations

import bisect
import itertools
import json
import threading
import time
from collections import deque
from collections.abc import MutableMapping
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple


class Counter:
    """A single monotonically-adjustable numeric cell."""

    __slots__ = ("name", "value")

    def __init__(self, name: str, value: float = 0):
        self.name = name
        self.value = value

    def inc(self, delta: float = 1) -> None:
        self.value += delta

    def set(self, value: float) -> None:
        self.value = value

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Counter({self.name}={self.value})"


class Gauge:
    """A last-write-wins numeric cell (queue depths, horizon widths...)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str, value: float = 0.0):
        self.name = name
        self.value = value

    def set(self, value: float) -> None:
        self.value = value

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Gauge({self.name}={self.value})"


class CounterGroup(MutableMapping):
    """Named counters behaving exactly like the stats dicts they replace.

    ``group["x"] += 1`` routes through ``__getitem__``/``__setitem__`` onto
    the underlying :class:`Counter` cells, so code written against the old
    plain-dict stats keeps working, while the registry snapshot sees live
    values.  New keys may be created by assignment, as with a dict.
    """

    __slots__ = ("prefix", "_cells")

    def __init__(self, keys: Iterable[str] = (), prefix: str = ""):
        self.prefix = prefix
        self._cells: Dict[str, Counter] = {
            k: Counter(f"{prefix}.{k}" if prefix else k) for k in keys
        }

    def __getitem__(self, key: str):
        return self._cells[key].value

    def __setitem__(self, key: str, value) -> None:
        cell = self._cells.get(key)
        if cell is None:
            name = f"{self.prefix}.{key}" if self.prefix else key
            self._cells[key] = Counter(name, value)
        else:
            cell.value = value

    def __delitem__(self, key: str) -> None:
        del self._cells[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._cells)

    def __len__(self) -> int:
        return len(self._cells)

    def inc(self, key: str, delta: float = 1) -> None:
        self._cells[key].inc(delta)

    def reset(self) -> None:
        for cell in self._cells.values():
            cell.value = 0

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"CounterGroup({self.prefix!r}, {dict(self)!r})"


class Span:
    """Cumulative wall-clock timing for a named code region.

    Use as a context manager::

        with obs.span("controller.drain"):
            ...

    ``count`` is the number of completed entries, ``total_s`` the summed
    wall time.  Reentrant use nests naively (each exit adds its own
    elapsed time); the scheduler only uses it non-reentrantly.

    Entered through a call, ``with span(key):`` (``span()`` without a
    key), each entry is its own object and counts alike; where the span
    belongs to a registry with a :class:`Timeline` and the timeline's
    ``probe()`` is true at entry, that entry is also recorded there with
    its key; ``device`` spans mark the device too (the timeline's
    ``clock``).
    """

    __slots__ = ("name", "count", "total_s", "timeline", "device", "_t0")

    def __init__(self, name: str, timeline: Optional["Timeline"] = None,
                 device: bool = False):
        self.name = name
        self.count = 0
        self.total_s = 0.0
        self.timeline = timeline
        self.device = device
        self._t0 = 0.0

    def __call__(self, key=None) -> "_Entry":
        return _Entry(self, key)

    def __enter__(self) -> "Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.total_s += time.perf_counter() - self._t0
        self.count += 1

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Span({self.name}: {self.count}x {self.total_s:.6f}s)"


class _Entry:
    """One entry of a :class:`Span` (``span(key)``): its start and its
    record on the timeline, if any."""

    __slots__ = ("span", "key", "t0", "rec")

    def __init__(self, span: Span, key):
        self.span, self.key, self.rec = span, key, None

    def __enter__(self) -> "_Entry":
        sp = self.span
        tl = sp.timeline
        if tl is not None and tl.probe():
            self.rec = tl.open(sp.name, self.key, sp.device)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        sp = self.span
        sp.total_s += time.perf_counter() - self.t0
        sp.count += 1
        if self.rec is not None:
            sp.timeline.close(self.rec)


class SpanRecord:
    """One entry of a span on a :class:`Timeline`.

    ``parent`` is the ``id`` of the innermost span open on the entering
    thread then (None at the top), ``thread`` that thread's identifier,
    ``key`` what the caller gave (a request id, a tick, a step, a
    microbatch, a layer).  ``start`` and ``end`` are
    host times on ``time.perf_counter`` (``end`` None while open);
    ``dev_start`` and ``dev_end`` the device's, on the same clock, once
    :meth:`Timeline.window` has resolved them (None where no device marked
    the span).  ``mark0`` and ``mark1`` hold the clock's unresolved marks
    of entry and exit.
    """

    __slots__ = ("name", "id", "parent", "thread", "key", "start", "end", "dev_start",
                 "dev_end", "mark0", "mark1")

    def __init__(self, name: str, id: int, parent: Optional[int], key, thread: int = 0):
        self.name = name
        self.id = id
        self.parent = parent
        self.thread = thread
        self.key = key
        self.start = 0.0
        self.end: Optional[float] = None
        self.dev_start: Optional[float] = None
        self.dev_end: Optional[float] = None
        self.mark0 = self.mark1 = None

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"SpanRecord({self.name}#{self.id} <{self.parent} key={self.key!r} "
                f"{self.start:.6f}-{self.end})")


def _never() -> bool:
    return False


class Timeline:
    """A bounded ring of :class:`SpanRecord`, one a span entry, in the
    order of entry.

    Nothing is written while ``probe()`` is false, and it is false until
    the torch side installs the profiler's switch (``obs/device.py``): a
    span then costs that call.  ``clock``, installed with it, marks a
    device span's entry and exit on the device (``mark()`` → a mark, or
    None where the device is not in use; ``release(*marks)``) and places a
    window's marks on ``perf_counter`` (``resolve(records)``).

    A full ring drops its oldest record for the new one and counts it:
    ``dropped``, and ``dropped_until``, the latest host time a dropped
    record reached (infinite for one dropped while open), so that a
    window starting after it lost nothing.
    """

    def __init__(self, capacity: int = 1 << 18):
        self.capacity = capacity
        self.records: deque = deque()
        self.dropped = 0
        self.dropped_until = float("-inf")
        self.probe: Callable[[], bool] = _never
        self.clock = None
        self._ids = itertools.count(1)
        self._local = threading.local()

    def _stack(self) -> List[SpanRecord]:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def open(self, name: str, key, device: bool) -> SpanRecord:
        stack = self._stack()
        rec = SpanRecord(name, next(self._ids), stack[-1].id if stack else None, key,
                         threading.get_ident())
        if len(self.records) >= self.capacity:
            self._drop(self.records.popleft())
        self.records.append(rec)
        stack.append(rec)
        rec.start = time.perf_counter()
        if device and self.clock is not None:
            rec.mark0 = self.clock.mark()
        return rec

    def close(self, rec: SpanRecord) -> None:
        if rec.mark0 is not None:
            rec.mark1 = self.clock.mark()
        rec.end = time.perf_counter()
        stack = self._stack()
        if stack and stack[-1] is rec:
            stack.pop()
        elif rec in stack:
            stack.remove(rec)

    def _drop(self, rec: SpanRecord) -> None:
        self.dropped += 1
        self.dropped_until = max(self.dropped_until,
                                 float("inf") if rec.end is None else rec.end)
        if rec.mark1 is not None:
            self.clock.release(rec.mark0, rec.mark1)
            rec.mark0 = rec.mark1 = None

    def clear(self) -> None:
        """Forget every record and drop (a new recording starts afresh)."""
        for rec in self.records:
            if rec.mark1 is not None:
                self.clock.release(rec.mark0, rec.mark1)
        self.records.clear()
        self.dropped = 0
        self.dropped_until = float("-inf")

    def window(self, t0: float, t1: float) -> Optional["Window"]:
        """The closed records that meet [t0, t1], their device times
        resolved (call it after the device has finished), or None where
        none does or the ring dropped one that did."""
        if self.dropped and self.dropped_until >= t0:
            return None
        recs = [r for r in self.records if r.end is not None and r.end >= t0 and r.start <= t1]
        if not recs:
            return None
        if self.clock is not None:
            self.clock.resolve(recs)
        return Window(recs, t0, t1)


class Window:
    """The records of a :meth:`Timeline.window` and the questions its
    readers ask of them.  A span is in the window where it starts in
    [t0, t1); its ancestors are looked up among the window's records."""

    def __init__(self, records: List[SpanRecord], t0: float, t1: float):
        self.records = sorted(records, key=lambda r: r.start)
        self.t0, self.t1 = t0, t1
        self._by_id = {r.id: r for r in self.records}
        self._threads: Dict[int, List[SpanRecord]] = {}
        for r in self.records:
            self._threads.setdefault(r.thread, []).append(r)

    def named(self, name: str) -> List[SpanRecord]:
        """The spans of ``name`` that start in the window."""
        return [r for r in self.records if r.name == name and self.t0 <= r.start < self.t1]

    def ancestors(self, rec: SpanRecord) -> Iterator[SpanRecord]:
        while rec.parent is not None and rec.parent in self._by_id:
            rec = self._by_id[rec.parent]
            yield rec

    def under(self, name: str, ancestor: str) -> List[SpanRecord]:
        """The spans of ``name`` in the window with an ancestor ``ancestor``."""
        return [r for r in self.named(name)
                if any(a.name == ancestor for a in self.ancestors(r))]

    def innermost(self, t: float, thread: int) -> Optional[SpanRecord]:
        """The innermost span that ``thread`` has open at ``t``: of its
        spans, the last to start at or before it, or the nearest of that
        one's ancestors still open there."""
        recs = self._threads.get(thread, [])
        i = bisect.bisect_right([r.start for r in recs], t) - 1
        rec = recs[i] if i >= 0 else None
        while rec is not None and rec.end < t:
            rec = self._by_id.get(rec.parent)
        return rec

    @staticmethod
    def host_s(recs: Iterable[SpanRecord]) -> float:
        return sum(r.end - r.start for r in recs)

    @staticmethod
    def device_s(recs: Iterable[SpanRecord], busy: List[Tuple[float, float]]) -> Optional[float]:
        """The device's busy time inside the device intervals of ``recs``
        (which do not overlap), summed: ``busy`` holds the intervals in
        which an operation ran on the device, sorted and disjoint, on the
        same clock; the device's waits inside a span are left out.  None
        where a record lacks its device interval."""
        starts = [a for a, _ in busy]
        before = [0.0]                       # busy time before each interval
        for a, b in busy:
            before.append(before[-1] + b - a)

        def upto(t: float) -> float:         # busy time before ``t``
            i = bisect.bisect_right(starts, t)
            return before[i] - max(busy[i - 1][1] - t, 0.0) if i else 0.0

        total = 0.0
        for r in recs:
            if r.dev_start is None or r.dev_end is None:
                return None
            total += upto(r.dev_end) - upto(r.dev_start)
        return total


class FlightRecorder:
    """Bounded ring buffer of structured scheduling-decision events.

    Disabled by default: the scheduling hot path checks ``enabled`` (one
    attribute read) before building the event dict, so an idle recorder
    costs nothing.  When enabled, each :meth:`record` appends a plain dict
    ``{"kind": kind, **fields}``; the ring keeps the most recent
    ``capacity`` events.
    """

    __slots__ = ("enabled", "capacity", "events", "dropped")

    def __init__(self, capacity: int = 4096, enabled: bool = False):
        self.enabled = enabled
        self.capacity = capacity
        self.events: deque = deque(maxlen=capacity)
        self.dropped = 0

    def enable(self) -> "FlightRecorder":
        self.enabled = True
        return self

    def disable(self) -> "FlightRecorder":
        self.enabled = False
        return self

    def record(self, kind: str, **fields) -> None:
        if not self.enabled:
            return
        if len(self.events) == self.capacity:
            self.dropped += 1
        ev = {"kind": kind}
        ev.update(fields)
        self.events.append(ev)

    def clear(self) -> None:
        self.events.clear()
        self.dropped = 0

    def tail(self, n: int = 50) -> List[dict]:
        return list(self.events)[-n:]

    def dump_jsonl(self, path) -> int:
        """Write the buffered events as JSON Lines; returns the count."""
        with open(path, "w") as fh:
            for ev in self.events:
                fh.write(json.dumps(ev) + "\n")
        return len(self.events)


class Registry:
    """Per-controller container for counters, gauges, spans and the trace.

    ``snapshot()`` is the single machine-readable view: registered scalar
    metrics plus any *provider* sections — zero-argument callables
    evaluated lazily at snapshot time (ledger occupancy, per-job metrics,
    kernel cache stats...).  Provider failures are captured in-place
    rather than propagated, so one broken layer cannot take down the
    whole snapshot.
    """

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._groups: Dict[str, CounterGroup] = {}
        self._spans: Dict[str, Span] = {}
        self._providers: Dict[str, Callable[[], object]] = {}
        self.trace = FlightRecorder()
        #: Where this registry's spans record their entries (only the
        #: process-wide :func:`default_registry` has one).
        self.timeline: Optional[Timeline] = None

    # -- construction / lookup ------------------------------------------
    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name)
        return g

    def group(self, prefix: str, keys: Iterable[str] = ()) -> CounterGroup:
        g = self._groups.get(prefix)
        if g is None:
            g = self._groups[prefix] = CounterGroup(keys, prefix=prefix)
        return g

    def span(self, name: str, device: bool = False) -> Span:
        """The span ``name`` (made on first use, ``device`` as given then)."""
        s = self._spans.get(name)
        if s is None:
            s = self._spans[name] = Span(name, self.timeline, device)
        return s

    def register_provider(self, name: str, fn: Callable[[], object]) -> None:
        """Attach a lazily-evaluated snapshot section (last write wins)."""
        self._providers[name] = fn

    # -- serialization (controller crash-recovery) ----------------------
    def dump_values(self) -> dict:
        """Plain-data dump of every counter, gauge and group cell for
        controller snapshots (DESIGN.md §11).  Spans and the flight
        recorder are deliberately excluded: they measure wall-clock and
        debugging artifacts of *this* process, not replayable scheduler
        behavior, so recovery equivalence is not defined over them."""
        return {
            "counters": {n: c.value for n, c in self._counters.items()},
            "gauges": {n: g.value for n, g in self._gauges.items()},
            "groups": {prefix: dict(g) for prefix, g in self._groups.items()},
        }

    def load_values(self, state: dict) -> None:
        """Restore a :meth:`dump_values` dump in place.

        Writes through :meth:`group`/:meth:`counter`/:meth:`gauge`, so
        cells already registered by the restoring controller's constructor
        are updated rather than duplicated, and later ``group()`` calls
        (e.g. a telemetry monitor re-attaching its stats group) observe the
        restored values.
        """
        for prefix, cells in state["groups"].items():
            g = self.group(prefix)
            for key, value in cells.items():
                g[key] = value
        for name, value in state["counters"].items():
            self.counter(name).value = value
        for name, value in state["gauges"].items():
            self.gauge(name).value = value

    # -- reporting ------------------------------------------------------
    def snapshot(self, trace_tail: int = 200) -> dict:
        counters = {c.name: c.value for c in self._counters.values()}
        for g in self._groups.values():
            for cell in g._cells.values():
                counters[cell.name] = cell.value
        snap: dict = {
            "counters": counters,
            "gauges": {g.name: g.value for g in self._gauges.values()},
            "spans": {
                s.name: {"count": s.count, "total_s": s.total_s}
                for s in self._spans.values()
            },
            "trace": self.trace.tail(trace_tail),
        }
        for name, fn in self._providers.items():
            try:
                snap[name] = fn()
            except Exception as exc:  # one broken layer must not kill the snapshot
                snap[name] = {"error": f"{type(exc).__name__}: {exc}"}
        return snap


_DEFAULT: Optional[Registry] = None


def default_registry() -> Registry:
    """Process-wide registry for module-global stats (device kernels) and
    the process's :class:`Timeline` of spans."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = Registry()
        _DEFAULT.timeline = Timeline()
    return _DEFAULT
