"""Device-side planning pipelines and the ledger mirror (PyTorch + CUDA).

This module is the implementation behind ``ts_plan``'s ``cuda`` and
``torch`` backends.  It imports torch, so it is only ever imported lazily,
from inside ``ts_plan`` entry points or by tests; the numpy scheduling core
never pays for it.

Two layers live here:

* **Kernel wrappers** (:func:`scan_window`, :func:`scan_columns`,
  :func:`scan_dense`): one per way of gathering ``booked``, all launching
  the one kernel template of ``csrc/ts_plan.cu``.  A wrapper given CUDA
  tensors checks them, allocates the outputs, launches on the current
  stream, raises on a CUDA error, and counts the launch in
  ``stats["launches"]``.  Given CPU tensors it runs the plain PyTorch
  version from ``ts_plan`` instead; nothing else ever selects it, and no
  failure on the card falls back to it.
* **Pipelines over the ledger**: :func:`wave_scan` (mirror gather → scan →
  plan-end extraction in one launch), :func:`col_scan` (compressed-column
  gather → scan), :func:`plan_scan` (a pre-gathered window) and
  :func:`wave_select` (per-segment winners by three
  ``scatter_reduce("amin")`` passes), on an explicit ``torch.device``,
  plus :class:`DeviceMirror`, the device-resident copy of
  ``TimeSlotLedger.reserved`` kept in step by a journal of cell writes
  (DESIGN.md §8).

Every output is bit-identical to the numpy reference on any float64 input
(``csrc/ts_plan.cu`` says how the kernel keeps that).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..obs import default_registry
from . import _build, ts_plan

#: ``traces``: kernel-library builds (nvcc runs); ``cache_hits``: a library
#: already built for the same sources was loaded instead; ``launches``:
#: kernel launches (all three gather forms), with the per-form counts
#: beside it; the ``mirror_*`` cells count ledger-mirror traffic.
stats = default_registry().group(
    "ts_plan_device",
    (
        "traces", "cache_hits", "mirror_syncs", "mirror_cells",
        "mirror_uploads", "launches", "launches_window", "launches_columns",
        "launches_dense",
    ),
)

_F64 = torch.float64
_I64 = torch.int64


def _bucket(n: int, lo: int = 8) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


# -- kernel wrappers ---------------------------------------------------------


_KINDS = dict(
    M=_F64, pad=_I64, off=_I64, cols=_I64, caps=_F64, first_secs=_F64,
    secs=_F64, sizes=_F64, sz=_I64, t0c=_F64, booked=_F64,
)


def _check(dev, **tensors) -> None:
    """Each tensor on ``dev``, of its kind's dtype, contiguous, and of the
    given shape (``None``: any)."""
    for name, (t, shp) in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != _KINDS[name]:
            raise TypeError(f"{name} is {t.dtype}, expected {_KINDS[name]}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if shp is not None and tuple(t.shape) != tuple(shp):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shp}")


def _outputs(n, w, dev, with_end):
    outs = [torch.empty((n, w), dtype=_F64, device=dev) for _ in range(3)]
    outs.append(torch.empty(n, dtype=_I64, device=dev))
    if with_end:
        outs.append(torch.empty(n, dtype=_F64, device=dev))
    return outs


def _launched(form: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"ts_plan_{form} kernel launch failed: CUDA error {err}")
    stats["launches"] += 1
    stats["launches_" + form] += 1


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def scan_window(M, pad, off, caps, first_secs, sizes, sz, t0c, dur: float, w: int):
    """Window form: ``booked[k, l, j] = M[pad[k, l], off[k] + j]`` for
    ``j < w``, then scan and plan-end extraction.  The caller guarantees
    ``pad < M.shape[0]`` and ``0 <= off``, ``off + w <= M.shape[1]``.
    Returns ``(resid, bw, cum, hit, end)``."""
    n, L = pad.shape
    if M.device.type == "cpu":
        return ts_plan.wave_scan_torch(
            M, pad, off, caps, first_secs, sizes, sz, t0c, dur, w
        )
    dev = M.device
    _check(dev, M=(M, None), pad=(pad, (n, L)), off=(off, (n,)),
           caps=(caps, (n,)), first_secs=(first_secs, (n,)),
           sizes=(sizes, (n,)), sz=(sz, (n,)), t0c=(t0c, (n,)))
    if M.dim() != 2:
        raise ValueError("M must be a [rows, width] mirror")
    outs = _outputs(n, w, dev, True)
    err = _build.library().ts_plan_window(
        M.data_ptr(), M.shape[1], pad.data_ptr(), off.data_ptr(),
        caps.data_ptr(), first_secs.data_ptr(), sizes.data_ptr(),
        sz.data_ptr(), t0c.data_ptr(), float(dur), n, L, w,
        *(o.data_ptr() for o in outs), _stream(dev),
    )
    _launched("window", err)
    return tuple(outs)


def scan_columns(M, pad, cols, caps, secs, sizes):
    """Columns form: ``booked[k, l, j] = M[pad[k, l], cols[k, j]]``, then
    scan.  The caller guarantees every index lies inside ``M``.  Returns
    ``(resid, bw, cum, hit)``."""
    n, L = pad.shape
    W = cols.shape[1]
    if M.device.type == "cpu":
        return ts_plan.col_scan_torch(M, pad, cols, caps, secs, sizes)
    dev = M.device
    _check(dev, M=(M, None), pad=(pad, (n, L)),
           cols=(cols, (n, W)), caps=(caps, (n,)), secs=(secs, (n, W)),
           sizes=(sizes, (n,)))
    if M.dim() != 2:
        raise ValueError("M must be a [rows, width] mirror")
    outs = _outputs(n, W, dev, False)
    err = _build.library().ts_plan_columns(
        M.data_ptr(), M.shape[1], pad.data_ptr(), cols.data_ptr(),
        caps.data_ptr(), secs.data_ptr(), sizes.data_ptr(), n, L, W,
        *(o.data_ptr() for o in outs), _stream(dev),
    )
    _launched("columns", err)
    return tuple(outs)


def scan_dense(booked, caps, secs, sizes, bandwidth_cap=None):
    """Dense form: ``booked`` given as ``[n, L, W]``.  Returns
    ``(resid, bw, cum, hit)``."""
    n, L, W = booked.shape
    if booked.device.type == "cpu":
        return ts_plan.plan_scan_torch(booked, caps, secs, sizes, bandwidth_cap)
    dev = booked.device
    _check(dev, booked=(booked, None), caps=(caps, (n,)),
           secs=(secs, (n, W)), sizes=(sizes, (n,)))
    outs = _outputs(n, W, dev, False)
    err = _build.library().ts_plan_dense(
        booked.data_ptr(), caps.data_ptr(), secs.data_ptr(), sizes.data_ptr(),
        0.0 if bandwidth_cap is None else float(bandwidth_cap),
        0 if bandwidth_cap is None else 1, n, L, W,
        *(o.data_ptr() for o in outs), _stream(dev),
    )
    _launched("dense", err)
    return tuple(outs)


# -- pipelines over the ledger -----------------------------------------------


def _resolve(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ts_plan backend 'cuda' needs a CUDA device; select 'torch' "
                "or 'numpy' on a machine without one"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _up(x, dtype, dev):
    return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=dev)


def _down(outs):
    return tuple(t.cpu().numpy() for t in outs)


def _check_rows(rows: np.ndarray, nrows: int) -> None:
    if int(rows.min()) < 0 or int(rows.max()) >= nrows:
        raise IndexError(f"ledger row out of range [0, {nrows})")


def plan_scan(booked, caps, secs, sizes, bandwidth_cap=None, overlay=None,
              device="cuda"):
    """Scan a pre-gathered ``[n, L, W]`` window; bit-identical to
    ``plan_scan_numpy``.  The overlay is folded in on the device."""
    dev = _resolve(device)
    bk = _up(booked, _F64, dev)
    if overlay is not None:
        bk = torch.maximum(bk, _up(overlay, _F64, dev)).contiguous()
    outs = scan_dense(
        bk, _up(caps, _F64, dev), _up(secs, _F64, dev), _up(sizes, _F64, dev),
        bandwidth_cap,
    )
    return _down(outs)


def _mirror_for(ledger, dev) -> "DeviceMirror":
    """The ledger's mirror, synced, on ``dev``."""
    mir = ledger.device_mirror()
    if mir.device != dev:
        mir.move_to(dev)
    mir.sync()
    return mir


def wave_scan(ledger, pad, caps, sz, t0c, sizes, w, first_secs, device="cuda"):
    """Wave pipeline: mirror gather → scan → plan-end extraction, one
    launch."""
    dev = _resolve(device)
    sz = np.asarray(sz, np.int64)
    ledger._ensure(int(sz.max()) + w - 1)
    mir = _mirror_for(ledger, dev)
    rows = np.asarray(pad, np.int64)
    off = np.maximum(sz - mir.base, 0)
    _check_rows(rows, mir.arr.shape[0])
    if int(off.max()) + w > mir.width:
        raise IndexError("wave window runs past the mirror")
    outs = scan_window(
        mir.arr, _up(rows, _I64, dev), _up(off, _I64, dev), _up(caps, _F64, dev),
        _up(first_secs, _F64, dev), _up(sizes, _F64, dev), _up(sz, _I64, dev),
        _up(t0c, _F64, dev), float(ledger.slot_duration), w,
    )
    return _down(outs)


def col_scan(ledger, pad, cols, caps, secs, sizes, device="cuda"):
    """Compressed-column round for the reroute engine (``cols`` holds
    absolute slots), gathered from the mirror."""
    dev = _resolve(device)
    ledger._ensure(int(cols.max()))
    mir = _mirror_for(ledger, dev)
    rows = np.asarray(pad, np.int64)
    cc = np.asarray(cols, np.int64) - mir.base
    _check_rows(rows, mir.arr.shape[0])
    if int(cc.min()) < 0 or int(cc.max()) >= mir.width:
        raise IndexError("column outside the mirror window")
    outs = scan_columns(
        mir.arr, _up(rows, _I64, dev), _up(cc, _I64, dev), _up(caps, _F64, dev),
        _up(secs, _F64, dev), _up(sizes, _F64, dev),
    )
    return _down(outs)


def wave_select(
    end: np.ndarray, rank: np.ndarray, counts: Sequence[int], device="cuda"
) -> np.ndarray:
    """Per-segment argmin of ``(end, rank)`` by three ``scatter_reduce``
    passes (min end; min rank among exact-float end ties; the one position
    carrying both minima).  Exactly the host loop: float equality is exact
    and ranks are unique within a segment."""
    dev = _resolve(device)
    nc, ns = len(end), len(counts)
    e = _up(end, _F64, dev)
    r = _up(rank, _I64, dev)
    cnt = np.asarray(counts, np.int64)
    seg = _up(np.repeat(np.arange(ns, dtype=np.int64), cnt), _I64, dev)

    def seg_min(vals, fill):
        out = torch.full((ns,), fill, dtype=vals.dtype, device=dev)
        return out.scatter_reduce(0, seg, vals, "amin", include_self=False)

    emin = seg_min(e, float("inf"))
    tie = e == emin[seg]
    big = torch.iinfo(torch.int64).max
    rmin = seg_min(torch.where(tie, r, big), big)
    pos = torch.arange(nc, dtype=_I64, device=dev)
    win = seg_min(torch.where(tie & (r == rmin[seg]), pos, nc), nc).cpu().numpy()
    starts = np.zeros(ns, np.int64)
    np.cumsum(cnt[:-1], out=starts[1:])
    return win - starts


# -- device-resident ledger mirror -------------------------------------------


class DeviceMirror:
    """Device-resident copy of a ledger's live ``reserved`` window.

    The ledger's mutators journal every cell write (``note_flat`` /
    ``note_grid``) with the *final* post-clamp value; :meth:`sync` folds
    the journal into the device tensor with one keep-last dedup on the host
    and one ``index_put_``, re-basing for origin shifts with a zero-filled
    shifted copy.  Direct writes that bypass the mutators must call
    :meth:`invalidate` (``TimeSlotLedger.mirror_invalidate``) — the next
    sync then re-uploads the full window.  See DESIGN.md §8.
    """

    def __init__(self, ledger):
        self._ledger = ledger
        #: Where the mirror lives: the selected backend's device when it
        #: was attached; :func:`wave_scan` re-homes it if that changes.
        self.device = _resolve(ts_plan._device() or "cpu")
        self._arr = None
        self._base = 0
        self._width = 0  # device width (pow-2 bucket of the ledger width)
        self._rows: list = []
        self._slots: list = []
        self._vals: list = []
        self._cells = 0
        self._stale = True

    @property
    def base(self) -> int:
        return self._base

    @property
    def width(self) -> int:
        return self._width

    @property
    def arr(self):
        return self._arr

    def move_to(self, device) -> None:
        """Re-home the mirror (the next sync re-uploads there)."""
        self.device = _resolve(device)
        self._arr = None
        self.invalidate()

    # -- journal hooks (ledger mutators; slots are absolute) ----------------
    def note_flat(self, rows, slots, vals) -> None:
        if self._stale:
            return
        rows = np.asarray(rows, np.int64).ravel()
        self._rows.append(rows)
        self._slots.append(np.asarray(slots, np.int64).ravel())
        self._vals.append(np.asarray(vals, np.float64).ravel())
        self._cells += rows.size
        # Pressure valve: past a quarter of the window, one upload is
        # cheaper than the journal bookkeeping.
        if self._cells * 4 > self._ledger.reserved.size:
            self.invalidate()

    def note_grid(self, rows, slots, vals) -> None:
        """An outer-product write: ``reserved[rows][:, slots] = vals``
        with ``vals`` of shape ``[len(rows), len(slots)]``."""
        if self._stale:
            return
        rows = np.asarray(rows, np.int64).ravel()
        slots = np.asarray(slots, np.int64).ravel()
        self.note_flat(
            np.repeat(rows, slots.size),
            np.tile(slots, rows.size),
            np.asarray(vals, np.float64).ravel(),
        )

    def invalidate(self) -> None:
        self._rows.clear()
        self._slots.clear()
        self._vals.clear()
        self._cells = 0
        self._stale = True

    # -- sync ---------------------------------------------------------------
    def sync(self) -> None:
        """Bring the device window up to date with the ledger (journal
        replay, or full re-upload after invalidation / shrink)."""
        led = self._ledger
        res = led.reserved
        nrows, W = res.shape
        base = led.base_slot
        Wb = _bucket(W, 256)
        stats["mirror_syncs"] += 1
        if (
            self._stale
            or self._arr is None
            or Wb < self._width
            or self._arr.shape[0] != nrows
            or base < self._base
        ):
            self._upload(res, Wb, base)
            return
        arr = self._arr
        if base != self._base or Wb != self._width:
            # take(mode="fill"): new[:, j] = old[:, drop + j], 0 past the end.
            drop = base - self._base
            moved = torch.zeros((nrows, Wb), dtype=_F64, device=self.device)
            keep = min(self._width - drop, Wb)
            if keep > 0:
                moved[:, :keep] = arr[:, drop:drop + keep]
            arr = moved
        if self._rows:
            rows = np.concatenate(self._rows)
            cc = np.concatenate(self._slots) - base
            vals = np.concatenate(self._vals)
            keep = (cc >= 0) & (cc < Wb)  # retired cells fell off the window
            if not keep.all():
                rows, cc, vals = rows[keep], cc[keep], vals[keep]
            if rows.size:
                # Keep-last dedup: the journal holds final values, so the
                # latest note for a cell wins.
                keys = rows * np.int64(Wb) + cc
                _u, idx = np.unique(keys[::-1], return_index=True)
                sel = keys.size - 1 - idx
                arr.index_put_(
                    (_up(rows[sel], _I64, self.device),
                     _up(cc[sel], _I64, self.device)),
                    _up(vals[sel], _F64, self.device),
                )
                stats["mirror_cells"] += int(sel.size)
            self._rows.clear()
            self._slots.clear()
            self._vals.clear()
            self._cells = 0
        self._arr = arr
        self._base = base
        self._width = Wb

    def _upload(self, res, Wb, base) -> None:
        buf = torch.zeros((res.shape[0], Wb), dtype=_F64)
        buf[:, : res.shape[1]] = torch.from_numpy(np.ascontiguousarray(res))
        self._arr = buf.to(self.device)
        self._base = base
        self._width = Wb
        self._rows.clear()
        self._slots.clear()
        self._vals.clear()
        self._cells = 0
        self._stale = False
        stats["mirror_uploads"] += 1

    def host_view(self) -> np.ndarray:
        """Host copy of the device window, trimmed to the ledger width
        (test hook: must equal ``ledger.reserved`` after ``sync``)."""
        W = self._ledger.reserved.shape[1]
        return self._arr[:, :W].cpu().numpy().copy()
