"""Activation-sharding context.

Model code is mesh-agnostic; a launcher establishes a context
(``activation_sharding(mesh, rules)``), and ``constrain(x, logical_axes)``
resolves a spec for ``x`` under the active rules, with the reference's
``only_if`` and ``require_axis`` rules.  With no context active, where the
rules resolve nothing, or on a mesh of one device, it returns ``x``
unchanged.  The port places no tensor across devices by a spec, so a spec
that resolves on a larger mesh raises.  The port's models do not call it
(see ``models/layers.py``).  What reads the context is the MoE block: under
a rank mesh (``launch/mesh.py::_make_mesh``) with ``moe_impl="a2a"`` it
takes the expert-parallel dispatch, which cuts its input by the rules'
``batch`` and ``seq`` entries itself (``models/moe.py::a2a_layout``).
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Dict, Optional, Tuple

from .sharding import spec_for

_STATE: list = []


@contextmanager
def activation_sharding(mesh, rules: Dict[str, Any]):
    _STATE.append((mesh, dict(rules)))
    try:
        yield
    finally:
        _STATE.pop()


def active() -> Optional[Tuple[Any, Dict[str, Any]]]:
    return _STATE[-1] if _STATE else None


def constrain(
    x,
    logical_axes: Tuple[Optional[str], ...],
    only_if: Optional[str] = None,
    require_axis: Optional[str] = None,
):
    """Apply a sharding constraint from logical axes under the active rules.

    ``only_if`` names a boolean policy flag that must be present in the
    rules (e.g. "megatron_blocks"); ``require_axis`` names a logical axis
    that must be mapped by the rules for the constraint to apply at all —
    otherwise a partially-resolved spec (e.g. batch only) would silently
    force the *other* dims replicated, changing baseline behavior."""
    ctx = active()
    if ctx is None:
        return x
    mesh, rules = ctx
    if only_if is not None and not rules.get(only_if):
        return x
    if require_axis is not None and require_axis not in rules:
        return x
    spec = spec_for(tuple(x.shape), logical_axes, mesh, rules)
    n_devices = 1
    for size in mesh.shape.values():
        n_devices *= size
    if not spec or n_devices == 1:
        return x
    raise NotImplementedError(
        f"constrain{tuple(x.shape)} to {spec} over {mesh.shape}: the port places no "
        "tensor across devices"
    )
