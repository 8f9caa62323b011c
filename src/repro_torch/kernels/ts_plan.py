"""Time-slot planning scan — the ledger/wavefront inner kernel.

The greedy paper-policy transfer plan (``TimeSlotLedger.plan_transfer``)
reduces, per candidate path, to a fixed four-step scan over a slot window:

1. **residue**   ``resid = 1 - max over path links of booked``,
2. **bandwidth** ``bw = resid * bottleneck_capacity`` (optionally capped),
3. **cumsum**    ``cum = cumsum(bw * secs)`` (cumulative deliverable,
   first slot possibly partial),
4. **searchsorted** ``hit = #{j : cum[j] < size - EPS}`` (first slot at
   which the transfer completes; ``hit == W`` means "does not fit").

:func:`plan_scan` runs that scan for every candidate of a
``[n_cand, n_links_padded, window]`` gather of the ledger; :func:`wave_scan`
(gather → scan → plan-end extraction, the wavefront engine's per-wave
pipeline) and :func:`col_scan` (compressed-column gather → scan, the
reroute engine's escalation rounds) extend the same contract to whole
pipelines, and :func:`wave_select` picks each wave's winners.

**Backends** (``set_backend``):

* ``cuda`` (the **default**): the hand-written Hopper kernel in
  ``csrc/ts_plan.cu`` behind ``ts_plan_device``, gathering straight from
  the CUDA-resident ledger mirror.  With no CUDA device the first scan
  raises; nothing falls back.  Every call goes to the kernel whatever its
  size: the reference's ``auto`` rule sent calls under 2**15 cells to
  numpy, which at fleet scale is almost every wave.
* ``torch``: the same pipelines as plain PyTorch on CPU tensors (the
  ``*_torch`` functions below) — the kernel's oracle, run by the CPU
  tests.  CPU float64 ``torch.cumsum`` accumulates in order, like
  ``np.cumsum``; a test pins the two bit-identical.
* ``numpy``: the **reference**, kept verbatim from the JAX package.

All three are bit-identical on any float64 input: every elementwise step
is exactly rounded and the prefix sum runs in slot order on each.  Callers
on a machine without a card select ``numpy`` or ``torch`` themselves.

Both the numpy and device paths are **origin-free**: ``booked`` arrives
as an already-gathered window (or absolute slots translated against
``base_slot`` right at the gather), so the rolling-horizon coordinate map
is applied entirely by the callers.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from ..obs import default_registry

EPS = 1e-9  # must equal repro.core.timeslot._EPS


def _hit_count(cum: np.ndarray, sizes: np.ndarray) -> np.ndarray:
    """``hit[k] = #{j : cum[k, j] < sizes[k] - EPS}`` — searchsorted-left
    on each row.  Rows are nondecreasing by construction (reserved
    fractions ≤ 1 ⇒ ``bw ≥ 0``, and ``secs ≥ 0``), so a per-row binary
    search returns the identical count; it wins when the batch is a few
    long rows (escalated windows), while the vectorized count wins when
    the batch is wide and the rows short (wave scans).  A regression test
    pins the two bit-identical on both regimes."""
    n, w = cum.shape
    targets = sizes - EPS
    if n * 8 <= w:
        out = np.empty(n, dtype=np.int64)
        for k in range(n):
            out[k] = np.searchsorted(cum[k], targets[k])
        return out
    return (cum < targets[:, None]).sum(axis=1)


def plan_scan_numpy(
    booked: np.ndarray,        # [n_cand, L, W] reserved fractions (gathered)
    caps: np.ndarray,          # [n_cand] bottleneck capacity per candidate
    secs: np.ndarray,          # [n_cand, W] usable seconds per slot
    sizes: np.ndarray,         # [n_cand] bytes (capacity-units·sec) to move
    bandwidth_cap: Optional[float] = None,
    overlay: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Reference scan; row ``k`` is bit-identical to ``plan_transfer`` run
    on candidate ``k`` alone (same expressions, numpy ``cumsum`` is a
    sequential accumulation per row).

    ``overlay`` (same shape as ``booked``, or broadcastable) is an extra
    reserved-fraction layer folded in as an elementwise max — a masked
    scan for callers that want cells priced as busier than the ledger
    records without mutating it (liveness masks, what-if overlays).
    ``max`` is exact in floating point, so an overlay of 0/1 cells
    reproduces the overlaid ledger bit-for-bit.  (The reroute engine
    ultimately prices its phantom-full view by *enumerating* only
    owner-clean columns — see ``core/reroute.py`` — so nothing in the
    scheduling core depends on this parameter; it is contract-tested on
    both backends.)
    """
    if overlay is not None:
        booked = np.maximum(booked, overlay)
    resid = 1.0 - booked.max(axis=1)
    bw = resid * caps[:, None]
    if bandwidth_cap is not None:
        bw = np.minimum(bw, bandwidth_cap)
    cum = np.cumsum(bw * secs, axis=1)
    hit = _hit_count(cum, sizes)
    return resid, bw, cum, hit


def _pad_to(x: np.ndarray, shape) -> np.ndarray:
    if tuple(x.shape) == tuple(shape):
        return x  # already aligned: no copy
    pads = [(0, t - s) for s, t in zip(x.shape, shape)]
    return np.pad(x, pads)


# -- plain PyTorch version of the kernel (CPU tensors) -----------------------


def plan_scan_torch(booked, caps, secs, sizes, bandwidth_cap=None, overlay=None):
    """:func:`plan_scan_numpy` in PyTorch — the same expressions on float64
    tensors, returning ``(resid, bw, cum, hit)`` with ``hit`` int64."""
    import torch

    if overlay is not None:
        booked = torch.maximum(booked, overlay)
    resid = 1.0 - booked.amax(dim=1)
    bw = resid * caps[:, None]
    if bandwidth_cap is not None:
        bw = torch.minimum(bw, bw.new_tensor(float(bandwidth_cap)))
    cum = torch.cumsum(bw * secs, dim=1)
    hit = (cum < (sizes - EPS)[:, None]).sum(dim=1)
    return resid, bw, cum, hit


def extract_end_torch(dur, t0c, sizes, sz, cum, bw, hit, w):
    """:func:`_extract_end` in PyTorch (``sz`` and ``hit`` int64)."""
    import torch

    ar = torch.arange(sizes.shape[0], device=sizes.device)
    hidx = hit.clamp(max=w - 1)
    before = torch.where(hit > 0, cum[ar, (hit - 1).clamp(min=0)], 0.0)
    t_in = torch.maximum(t0c, (sz + hit).to(torch.float64) * dur)
    end = t_in + (sizes - before) / bw[ar, hidx]
    end = torch.where(hit < w, end, float("inf"))
    end = torch.where(sizes <= 0, t0c, end)
    return end


def wave_scan_torch(M, pad, off, caps, first_secs, sizes, sz, t0c, dur, w):
    """The window form: gather ``M[pad[k, l], off[k] + j]`` for ``j < w``,
    scan with ``secs = dur`` except ``first_secs`` in slot 0, and extract
    plan ends.  Returns ``(resid, bw, cum, hit, end)``."""
    import torch

    iota = torch.arange(w, device=M.device)
    booked = M[pad[:, :, None], (off[:, None] + iota)[:, None, :]]
    secs = torch.full((pad.shape[0], w), dur, dtype=torch.float64, device=M.device)
    secs[:, 0] = first_secs
    resid, bw, cum, hit = plan_scan_torch(booked, caps, secs, sizes)
    end = extract_end_torch(dur, t0c, sizes, sz, cum, bw, hit, w)
    return resid, bw, cum, hit, end


def col_scan_torch(M, pad, cols, caps, secs, sizes):
    """The columns form: gather ``M[pad[k, l], cols[k, j]]`` and scan."""
    booked = M[pad[:, :, None], cols[:, None, :]]
    return plan_scan_torch(booked, caps, secs, sizes)


# -- backend selection -------------------------------------------------------

_VALID_BACKENDS = ("cuda", "torch", "numpy")
_backend = "cuda"

#: Calls into each dispatching entry point, whatever the backend — a run
#: reads ``launches`` in ``device_stats()`` against these.
calls = default_registry().group(
    "ts_plan", ("plan_scan", "wave_scan", "col_scan", "wave_select")
)


def set_backend(name: str) -> None:
    if name not in _VALID_BACKENDS:
        raise ValueError(
            f"unknown ts_plan backend {name!r} (want {sorted(_VALID_BACKENDS)})"
        )
    global _backend
    _backend = name


def get_backend() -> str:
    return _backend


def _device() -> Optional[str]:
    """The torch device of the selected backend (``None`` for numpy)."""
    return None if _backend == "numpy" else ("cpu" if _backend == "torch" else "cuda")


def device_stats() -> dict:
    """Kernel-build / launch / mirror counters of the device backend
    (empty when it was never engaged)."""
    import sys

    mod = sys.modules.get(__package__ + ".ts_plan_device")
    return dict(mod.stats) if mod is not None else {}


def plan_scan(booked, caps, secs, sizes, bandwidth_cap=None, overlay=None):
    """Dispatch to the selected backend."""
    calls["plan_scan"] += 1
    dev = _device()
    if dev is not None:
        from . import ts_plan_device

        return ts_plan_device.plan_scan(
            booked, caps, secs, sizes, bandwidth_cap, overlay, device=dev
        )
    return plan_scan_numpy(booked, caps, secs, sizes, bandwidth_cap, overlay)


# -- fused pipelines ---------------------------------------------------------


def _extract_end(dur, t0c, sizes, sz, cum, bw, hit, w):
    """Plan-end extraction from scan curves — the exact tail arithmetic of
    ``plan_transfer`` vectorized over candidates (``end = t_in +
    remaining / bw[hit]``; unfit rows → inf, empty transfers → t0)."""
    n = len(sizes)
    ar = np.arange(n)
    hidx = np.minimum(hit, w - 1)
    before = np.where(hit > 0, cum[ar, np.maximum(hit - 1, 0)], 0.0)
    t_in = np.maximum(t0c, (sz + hit) * dur)
    with np.errstate(divide="ignore", invalid="ignore"):
        end = t_in + (sizes - before) / bw[ar, hidx]
    end = np.where(hit < w, end, np.inf)
    end = np.where(sizes <= 0, t0c, end)
    return end


def wave_scan_numpy(ledger, pad, caps, sz, t0c, sizes, w, first_secs):
    """Reference wave pipeline: host gather (``booked_window``) → scan →
    plan-end extraction.  ``sz`` is the per-candidate (frontier-skipped)
    absolute scan-base slot, ``first_secs`` the usable seconds of each
    candidate's first scanned slot."""
    booked = ledger.booked_window(pad, sz, w)
    n = len(caps)
    secs = np.full((n, w), ledger.slot_duration)
    secs[:, 0] = first_secs
    resid, bw, cum, hit = plan_scan_numpy(booked, caps, secs, sizes)
    end = _extract_end(ledger.slot_duration, t0c, sizes, sz, cum, bw, hit, w)
    return resid, bw, cum, hit, end


def wave_scan(ledger, pad, caps, sz, t0c, sizes, w, first_secs):
    """The wavefront engine's fused per-wave pipeline: gather the
    ``[n_cand, L, w]`` window (on the device backends, from the ledger
    mirror), scan, and extract plan ends — one kernel launch per wave.  Returns ``(resid, bw, cum, hit, end)``, bit-identical across
    backends."""
    calls["wave_scan"] += 1
    dev = _device()
    if dev is not None:
        from . import ts_plan_device

        return ts_plan_device.wave_scan(
            ledger, pad, caps, sz, t0c, sizes, w, first_secs, device=dev
        )
    return wave_scan_numpy(ledger, pad, caps, sz, t0c, sizes, w, first_secs)


def col_scan(ledger, pad, cols, caps, secs, sizes):
    """The reroute engine's compressed-column round: gather each
    candidate's collected joint columns (``cols`` holds *absolute* slots)
    and scan.  The device path gathers from the ledger mirror; the numpy
    path is the reference gather expression, bit for bit."""
    calls["col_scan"] += 1
    dev = _device()
    if dev is not None:
        from . import ts_plan_device

        return ts_plan_device.col_scan(
            ledger, pad, cols, caps, secs, sizes, device=dev
        )
    booked = ledger.reserved[
        pad[:, :, None], (cols - ledger.base_slot)[:, None, :]
    ]
    return plan_scan_numpy(booked, caps, secs, sizes)


def wave_select_numpy(
    end: np.ndarray, rank: np.ndarray, counts: Sequence[int]
) -> np.ndarray:
    """Per-segment argmin of ``(end, rank)`` — the host winner loop.
    ``rank`` is each candidate's precomputed position in its segment's
    tie-break order, so minimizing ``(end, rank)`` equals minimizing the
    scorer's full lexicographic key ``(end, hops, src, index)`` exactly
    (float equality is exact; ranks are unique within a segment).
    Returns the winner's *local* index per segment."""
    out = np.empty(len(counts), dtype=np.int64)
    pos = 0
    for s, cnt in enumerate(counts):
        best = pos
        for c in range(pos + 1, pos + cnt):
            if end[c] < end[best] or (
                end[c] == end[best] and rank[c] < rank[best]
            ):
                best = c
        out[s] = best - pos
        pos += cnt
    return out


def wave_select(
    end: np.ndarray, rank: np.ndarray, counts: Sequence[int]
) -> np.ndarray:
    """Winner selection over a wave's candidate segments — three
    ``scatter_reduce("amin")`` passes on the backend's device, the host
    loop under numpy; tie-breaking parity is contract-tested."""
    calls["wave_select"] += 1
    dev = _device()
    if dev is not None:
        from . import ts_plan_device

        return ts_plan_device.wave_select(end, rank, counts, device=dev)
    return wave_select_numpy(end, rank, counts)
