"""Unified observability: counters, gauges, spans, traces, snapshots.

See :mod:`repro.obs.registry` for the primitives and DESIGN.md §9 for how
the controller, wavefront, reroute, ledger, device-kernel, and telemetry
layers report through one :meth:`Registry.snapshot`.  stdlib-only — this
package must never import jax (or numpy): it is imported by
``repro.core`` and by the device-kernel module at load time.  The
timeline's torch side (its switch and device clock) is
:mod:`repro_torch.obs.device`, which the model, serving and training
modules import; this package never imports it.
"""
from .registry import (
    Counter,
    CounterGroup,
    FlightRecorder,
    Gauge,
    Registry,
    Span,
    SpanRecord,
    Timeline,
    Window,
    default_registry,
)

__all__ = [
    "Counter",
    "CounterGroup",
    "FlightRecorder",
    "Gauge",
    "Registry",
    "Span",
    "SpanRecord",
    "Timeline",
    "Window",
    "default_registry",
]
