"""The timeline's torch side: its switch and its device clock.

Importing this module installs both on the default registry's
:class:`~repro_torch.obs.registry.Timeline` (:func:`install`):

* the switch is ``torch._C._autograd._profiler_enabled``, so spans record
  exactly while a ``torch.profiler`` session collects, and otherwise cost
  that call;
* the clock marks a device span's entry and exit with a pair of timing
  events recorded on the current CUDA stream, drawn from a pool and
  returned to it once resolved (or dropped from the ring).

No ``record_function`` or NVTX range is made: the profiler would list it
among the device's operations and fill the idle gaps inside it.

Events are placed on ``time.perf_counter`` through two anchors a recording
session: its first mark synchronises, records an anchor event and reads
``perf_counter``; :meth:`CudaClock.resolve`, after the caller has
synchronised, takes a second anchor and places every mark between the two,
linearly in the device's elapsed time, then ends the session.  Where CUDA
is not initialised (the CPU, ``meta`` tensors) a device span records host
times only.
"""
from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional

import torch

from .registry import Span, SpanRecord, Timeline, default_registry


class _Session:
    """A recording session's anchors: (host time, event) at its first mark
    and at its resolve."""

    __slots__ = ("host0", "ev0", "ev1", "_scale")

    def __init__(self, host0: float, ev0):
        self.host0, self.ev0, self.ev1, self._scale = host0, ev0, None, 1.0

    def close(self, host1: float, ev1) -> None:
        self.ev1 = ev1
        dev_s = self.ev0.elapsed_time(ev1) / 1e3
        if dev_s > 0:
            self._scale = (host1 - self.host0) / dev_s

    def at(self, ev) -> float:
        """``ev``'s device time on ``perf_counter``."""
        return self.host0 + self.ev0.elapsed_time(ev) / 1e3 * self._scale


class CudaClock:
    """Marks device spans with CUDA timing events (module docstring).  A
    mark is an event recorded on the current stream; the events are
    ``torch._C._CudaEventBase``, recorded on a cached stream object, which
    keeps a mark to one driver call and no Python object made."""

    def __init__(self):
        self._pool: list = []
        self._streams: Dict[tuple, torch.cuda.Stream] = {}
        self._sessions: List[_Session] = []
        self._open: Optional[_Session] = None

    def _stream(self) -> torch.cuda.Stream:
        key = torch._C._cuda_getCurrentStream(torch._C._cuda_getDevice())
        stream = self._streams.get(key)
        if stream is None:
            stream = self._streams[key] = torch.cuda.Stream(
                stream_id=key[0], device_index=key[1], device_type=key[2])
        return stream

    def _record(self):
        ev = self._pool.pop() if self._pool else torch._C._CudaEventBase(enable_timing=True)
        ev.record(self._stream())
        return ev

    def mark(self):
        if not torch.cuda.is_initialized():
            return None
        if self._open is None:
            torch.cuda.synchronize()
            ev = self._record()
            self._open = _Session(time.perf_counter(), ev)
            self._sessions.append(self._open)
        return self._record()

    def release(self, *marks) -> None:
        self._pool.extend(marks)

    def resolve(self, records: List[SpanRecord]) -> None:
        """Place the closed records' marks on ``perf_counter``, each through
        the session it started in; ends the open session, so that the next
        mark anchors anew."""
        todo = [r for r in records if r.mark1 is not None]
        if not todo:
            return
        torch.cuda.synchronize()
        if self._open is not None:
            ev = self._record()
            host1 = time.perf_counter()
            ev.synchronize()
            self._open.close(host1, ev)
            self._open = None
        starts = [s.host0 for s in self._sessions]
        for r in todo:
            session = self._sessions[max(bisect.bisect_right(starts, r.start) - 1, 0)]
            r.dev_start, r.dev_end = session.at(r.mark0), session.at(r.mark1)
            self.release(r.mark0, r.mark1)
            r.mark0 = r.mark1 = None


def install() -> Timeline:
    """Give the default registry's timeline the profiler's switch and a
    :class:`CudaClock`; idempotent."""
    tl = default_registry().timeline
    tl.probe = torch._C._autograd._profiler_enabled
    if tl.clock is None:
        tl.clock = CudaClock()
    return tl


def span(name: str, device: bool = True) -> Span:
    """The default registry's span ``name``, recorded on its timeline;
    ``device``: mark the device too."""
    return default_registry().span(name, device=device)


install()
