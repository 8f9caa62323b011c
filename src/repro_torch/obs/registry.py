"""Unified observability registry — counters, gauges, spans, flight recorder.

Every layer of the scheduler (controller event loop, wavefront planner,
reroute engine, TS ledger, device kernels, telemetry monitor) used to keep
its own ad-hoc stats dict.  This module gives them one home:

* :class:`Counter` / :class:`Gauge` — single named values.
* :class:`CounterGroup` — a ``MutableMapping[str, int|float]`` over named
  counters.  It is a drop-in replacement for the old plain dicts
  (``group["hits"] += 1``, ``dict(group)``, iteration, ``.get``) so the
  existing call sites and test assertions keep working unchanged.
* :class:`Span` — cumulative wall-clock timing with a context manager.
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

import json
import time
from collections import deque
from collections.abc import MutableMapping
from typing import Callable, Dict, Iterable, Iterator, List, Optional


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
    """

    __slots__ = ("name", "count", "total_s", "_t0")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total_s = 0.0
        self._t0 = 0.0

    def __enter__(self) -> "Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.total_s += time.perf_counter() - self._t0
        self.count += 1

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Span({self.name}: {self.count}x {self.total_s:.6f}s)"


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

    def span(self, name: str) -> Span:
        s = self._spans.get(name)
        if s is None:
            s = self._spans[name] = Span(name)
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
    """Process-wide registry for module-global stats (device kernels)."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = Registry()
    return _DEFAULT
