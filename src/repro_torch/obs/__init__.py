"""Unified observability: counters, gauges, spans, traces, snapshots.

See :mod:`repro.obs.registry` for the primitives and DESIGN.md §9 for how
the controller, wavefront, reroute, ledger, device-kernel, and telemetry
layers report through one :meth:`Registry.snapshot`.  stdlib-only — this
package must never import jax (or numpy): it is imported by
``repro.core`` and by the device-kernel module at load time.
"""
from .registry import (
    Counter,
    CounterGroup,
    FlightRecorder,
    Gauge,
    Registry,
    Span,
    default_registry,
)

__all__ = [
    "Counter",
    "CounterGroup",
    "FlightRecorder",
    "Gauge",
    "Registry",
    "Span",
    "default_registry",
]
