"""SDN telemetry plane: measured-bandwidth belief state.

The paper's BASS scheduler assumes the controller *knows* per-link
available bandwidth; every policy in this repo historically read the
:class:`~repro.core.timeslot.TimeSlotLedger` as oracle ground truth.  A
real SDN controller instead polls switch counters and schedules on noisy,
stale estimates (Aljoby et al., *SDN-Enabled Online and Dynamic Bandwidth
Allocation*: measure → estimate → allocate).  This module is that loop:

* :class:`LinkStatsMonitor` — driven by the ``ClusterController`` event
  loop ("poll" events).  Each poll samples, per link, the instantaneous
  occupancy fraction of the current slot *and* advances cumulative
  byte counters by integrating ``reserved × capacity`` over the elapsed
  interval — the two signals a switch's port counters give you.
* Estimators — :class:`EwmaEstimator` smooths occupancy samples;
  :class:`WindowRateEstimator` differentiates the cumulative byte
  counters over a sliding window.  Both expose a per-link utilization
  vector in ``[0, 1]``.
* :class:`BeliefState` — the controller's picture of the network.  It
  mirrors the ledger's read-side query surface (``residual_fraction``,
  ``path_bandwidth``, ``path_bandwidth_batch``, ``min_path_bandwidth``)
  but answers from the estimated utilization vector: flat in time,
  stale between polls.

Separation contract (DESIGN.md §9): policies opting in via
``BassPolicy(telemetry=True)`` *score* candidates against the belief,
but every commit still plans and books on the true ledger — belief can
misrank, it can never corrupt data-plane state.  With telemetry off the
belief is never consulted and schedules stay byte-identical.

This module must stay importable without jax (numpy + stdlib only).
"""
from __future__ import annotations

from collections import deque
from typing import Optional, Sequence, Union

import numpy as np

_EPS = 1e-9


class BeliefState:
    """Estimated network state mirroring the ledger's read-side queries.

    The belief is a per-link utilization vector ``util`` (fraction of
    capacity in use) plus the static capacity vector — flat in time: the
    monitor's last estimate is assumed to hold for any queried instant.
    Edge semantics (empty paths, float types) match the ledger exactly so
    the zero-staleness limit is *bit*-equal (see tests/test_telemetry.py).
    """

    __slots__ = ("capacity", "util", "as_of", "polls")

    def __init__(self, capacity: Sequence[float]):
        self.capacity = np.asarray(capacity, dtype=float)
        self.util = np.zeros(len(self.capacity))
        self.as_of = float("-inf")  # sim time of the last poll
        self.polls = 0

    # -- ledger read-side surface ---------------------------------------
    def residual_fraction(self, rows: Sequence[int], slot: int) -> float:
        """Believed min residual fraction over ``rows`` (slot-invariant)."""
        if not rows:
            return 1.0
        return float(1.0 - self.util[list(rows)].max())

    def path_bandwidth(self, rows: Sequence[int], t: float) -> float:
        """Believed ``BW_rl`` of a path = min over links of residual bw."""
        if not rows:
            return float("inf")
        idx = list(rows)
        resid = (1.0 - self.util[idx]) * self.capacity[idx]
        return float(resid.min())

    def path_bandwidth_batch(
        self, rows_list: Sequence[Sequence[int]], t: float
    ) -> np.ndarray:
        """Believed ``BW_rl`` for many candidate paths in one numpy pass."""
        n = len(rows_list)
        out = np.full(n, float("inf"))
        live = [i for i in range(n) if rows_list[i]]
        if not live:
            return out
        pad = _padded_rows([rows_list[i] for i in live])
        resid = (1.0 - self.util[pad]) * self.capacity[pad]
        out[live] = resid.min(axis=1)
        return out

    def min_path_bandwidth(self, rows: Sequence[int], t0: float, t1: float) -> float:
        """Flat in time: the window minimum is just the current estimate."""
        return self.path_bandwidth(rows, t0)


def _padded_rows(rows_list: Sequence[Sequence[int]]) -> np.ndarray:
    # Same padding trick as TimeSlotLedger._padded_rows: repeat the
    # candidate's own first link so min-reductions are unaffected.
    width = max(len(r) for r in rows_list)
    pad = np.empty((len(rows_list), width), dtype=np.intp)
    for i, r in enumerate(rows_list):
        pad[i, : len(r)] = r
        pad[i, len(r):] = r[0]
    return pad


class EwmaEstimator:
    """Exponentially-weighted moving average over occupancy samples.

    ``alpha`` is the weight of the newest sample; the first sample primes
    the state exactly, so with ``alpha=1.0`` the estimate always equals
    the last instantaneous occupancy — the zero-staleness identity used
    by the exactness tests.
    """

    name = "ewma"

    def __init__(self, n_links: int, alpha: float = 0.5):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = float(alpha)
        self._u = np.zeros(n_links)
        self._primed = False

    def update(self, t: float, occupancy: np.ndarray, cum_bytes: np.ndarray) -> None:
        if not self._primed:
            self._u = occupancy.astype(float, copy=True)
            self._primed = True
        elif self.alpha == 1.0:
            # exact tracking: copy, don't blend (keeps floats bit-equal)
            self._u[:] = occupancy
        else:
            self._u = self.alpha * occupancy + (1.0 - self.alpha) * self._u

    def utilization(self) -> np.ndarray:
        return self._u

    # -- serialization (controller crash-recovery) ----------------------
    def dump_state(self) -> dict:
        return {
            "kind": self.name,
            "alpha": self.alpha,
            "u": self._u.copy(),
            "primed": self._primed,
        }

    def load_state(self, state: dict) -> None:
        self.alpha = state["alpha"]
        self._u = state["u"].copy()
        self._primed = state["primed"]


class WindowRateEstimator:
    """Sliding-window rate from cumulative byte counters.

    Utilization = (bytes moved over the window) / (capacity × window
    seconds), the way a monitoring loop differentiates port counters.
    Before two samples exist it falls back to the last instantaneous
    occupancy so a cold belief is not blind.
    """

    name = "window"

    def __init__(self, n_links: int, capacity: Sequence[float], window: float = 4.0):
        if window <= 0:
            raise ValueError(f"window must be positive, got {window}")
        self.window = float(window)
        self.capacity = np.asarray(capacity, dtype=float)
        self._samples: deque = deque()  # (t, cum_bytes.copy())
        self._occ = np.zeros(n_links)
        #: Counter discontinuities survived (controller restarts zero the
        #: synthetic port counters; a real switch reboot does the same).
        self.resets = 0

    def update(self, t: float, occupancy: np.ndarray, cum_bytes: np.ndarray) -> None:
        self._occ = occupancy.astype(float, copy=True)
        # Monotonic-counter discontinuity (a counter went *backwards*, e.g.
        # a switch/controller restart zeroed it): differencing across the
        # reset would produce a negative rate, so drop the pre-reset
        # history and start a fresh window from this sample — utilization
        # falls back to instantaneous occupancy until two post-reset
        # samples exist.
        if self._samples and bool(np.any(cum_bytes < self._samples[-1][1] - _EPS)):
            self._samples.clear()
            self.resets += 1
        self._samples.append((t, cum_bytes.copy()))
        # Keep one sample at or before the window edge so the finite
        # difference always spans >= the window once enough history exists.
        while len(self._samples) > 2 and self._samples[1][0] <= t - self.window:
            self._samples.popleft()

    def utilization(self) -> np.ndarray:
        if len(self._samples) < 2:
            return self._occ
        t0, b0 = self._samples[0]
        t1, b1 = self._samples[-1]
        dt = t1 - t0
        if dt <= _EPS:
            return self._occ
        u = (b1 - b0) / (self.capacity * dt)
        return np.clip(u, 0.0, 1.0)

    # -- serialization (controller crash-recovery) ----------------------
    def dump_state(self) -> dict:
        return {
            "kind": self.name,
            "window": self.window,
            "occ": self._occ.copy(),
            "samples": [(t, b.copy()) for t, b in self._samples],
            "resets": self.resets,
        }

    def load_state(self, state: dict) -> None:
        self.window = state["window"]
        self._occ = state["occ"].copy()
        self._samples = deque((t, b.copy()) for t, b in state["samples"])
        self.resets = state["resets"]


ESTIMATORS = {"ewma": EwmaEstimator, "window": WindowRateEstimator}


def make_estimator(
    kind: str, n_links: int, capacity: Sequence[float], **kwargs
) -> Union[EwmaEstimator, WindowRateEstimator]:
    if kind == "ewma":
        return EwmaEstimator(n_links, **kwargs)
    if kind == "window":
        return WindowRateEstimator(n_links, capacity, **kwargs)
    raise ValueError(f"unknown estimator {kind!r} (have: {sorted(ESTIMATORS)})")


class LinkStatsMonitor:
    """Samples per-link counters from the ledger and feeds an estimator.

    The monitor is the data-plane-facing half of the telemetry loop: it
    never *writes* the ledger, it only reads ``reserved``/``capacity`` to
    synthesize what real switch counters would report —

    * instantaneous occupancy of the slot containing the poll instant;
    * cumulative bytes per link, advanced by integrating
      ``reserved × capacity`` over the interval since the previous poll
      (partial slots pro-rated; slots already retired by the rolling
      horizon are skipped and counted in ``stats["missed_slots"]``).

    ``poll(t)`` pushes both signals into the estimator and refreshes the
    attached :class:`BeliefState` in place, so policy code holding a
    reference always sees the newest estimate.
    """

    def __init__(
        self,
        ledger,
        poll_interval: Optional[float] = None,
        estimator: Union[str, object] = "ewma",
        obs=None,
        **est_kwargs,
    ):
        self.ledger = ledger
        self.poll_interval = (
            float(poll_interval) if poll_interval is not None else ledger.slot_duration
        )
        if self.poll_interval <= 0:
            raise ValueError(f"poll_interval must be positive, got {self.poll_interval}")
        n = len(ledger.capacity)
        if isinstance(estimator, str):
            estimator = make_estimator(estimator, n, ledger.capacity, **est_kwargs)
        elif est_kwargs:
            raise TypeError("estimator kwargs only apply when estimator is a name")
        self.estimator = estimator
        self.belief = BeliefState(ledger.capacity)
        self.cum_bytes = np.zeros(n)
        self.last_poll = float("-inf")
        self._last_t: Optional[float] = None
        if obs is not None:
            self.stats = obs.group(
                "telemetry", ("polls", "missed_slots", "samples_dropped")
            )
        else:
            from ..obs import CounterGroup

            self.stats = CounterGroup(
                ("polls", "missed_slots", "samples_dropped"), prefix="telemetry"
            )

    # -- counter synthesis ----------------------------------------------
    def _occupancy(self, t: float) -> np.ndarray:
        led = self.ledger
        res = led.reserved
        p = led.slot_of(t) - led.base_slot
        if p < 0 or p >= res.shape[1]:
            return np.zeros(res.shape[0])
        return res[:, p].copy()

    def _advance_counters(self, t: float) -> None:
        """Integrate reserved×capacity over [last_t, t) into cum_bytes."""
        t0 = self._last_t
        self._last_t = t
        if t0 is None or t <= t0:
            return
        led = self.ledger
        res, cap, dur, base = led.reserved, led.capacity, led.slot_duration, led.base_slot
        width = res.shape[1]
        s0, s1 = led.slot_of(t0), led.slot_of(t)

        def frac_col(s: int) -> Optional[np.ndarray]:
            p = s - base
            if p < 0:
                self.stats["missed_slots"] += 1  # retired before we sampled it
                return None
            if p >= width:
                return None  # beyond the booked horizon: nothing reserved
            return res[:, p]

        if s0 == s1:
            c = frac_col(s0)
            if c is not None:
                self.cum_bytes += c * cap * (t - t0)
            return
        # head partial slot
        c = frac_col(s0)
        if c is not None:
            self.cum_bytes += c * cap * ((s0 + 1) * dur - t0)
        # full interior slots [s0+1, s1)
        lo, hi = s0 + 1, s1
        plo, phi = max(lo - base, 0), min(hi - base, width)
        if lo < base:
            self.stats["missed_slots"] += min(base, hi) - lo
        if phi > plo:
            self.cum_bytes += res[:, plo:phi].sum(axis=1) * cap * dur
        # tail partial slot
        c = frac_col(s1)
        if c is not None:
            self.cum_bytes += c * cap * (t - s1 * dur)

    # -- the poll -------------------------------------------------------
    def poll(self, t: float) -> BeliefState:
        """Sample counters at sim time ``t`` and refresh the belief."""
        self._advance_counters(t)
        occ = self._occupancy(t)
        self.estimator.update(t, occ, self.cum_bytes)
        self.belief.util = self.estimator.utilization()
        self.belief.as_of = t
        self.belief.polls += 1
        self.last_poll = t
        self.stats["polls"] += 1
        return self.belief

    def snapshot(self) -> dict:
        """Obs-registry provider section."""
        return {
            "poll_interval": self.poll_interval,
            "estimator": getattr(self.estimator, "name", type(self.estimator).__name__),
            "polls": self.stats["polls"],
            "missed_slots": self.stats["missed_slots"],
            "last_poll": self.last_poll,
            "belief_as_of": self.belief.as_of,
            "mean_util": float(self.belief.util.mean()) if len(self.belief.util) else 0.0,
            "max_util": float(self.belief.util.max()) if len(self.belief.util) else 0.0,
            "resets": getattr(self.estimator, "resets", 0),
        }

    # -- serialization (controller crash-recovery) ----------------------
    def dump_state(self) -> dict:
        """Plain-data serialization of the telemetry loop (DESIGN.md §11):
        poll cursor, synthesized counters, estimator internals and belief.
        The ledger reference and the obs group are reattached by
        :meth:`load_state` — they belong to the restoring controller."""
        est = self.estimator
        if not hasattr(est, "dump_state"):
            raise TypeError(
                f"estimator {type(est).__name__} does not support dump_state; "
                "snapshotting requires a serializable estimator"
            )
        return {
            "poll_interval": self.poll_interval,
            "estimator": est.dump_state(),
            "cum_bytes": self.cum_bytes.copy(),
            "last_poll": self.last_poll,
            "last_t": self._last_t,
            "belief": {
                "util": self.belief.util.copy(),
                "as_of": self.belief.as_of,
                "polls": self.belief.polls,
            },
        }

    @classmethod
    def load_state(cls, ledger, state: dict, obs=None) -> "LinkStatsMonitor":
        """Rebuild a monitor against ``ledger`` from a :meth:`dump_state`
        dict.  Stats counters live in the obs registry and are restored by
        ``Registry.load_values`` — passing the same ``obs`` here makes the
        rebuilt monitor's group share those cells."""
        est_state = state["estimator"]
        est = make_estimator(
            est_state["kind"], len(ledger.capacity), ledger.capacity
        )
        est.load_state(est_state)
        mon = cls(
            ledger, poll_interval=state["poll_interval"], estimator=est, obs=obs
        )
        mon.cum_bytes = state["cum_bytes"].copy()
        mon.last_poll = state["last_poll"]
        mon._last_t = state["last_t"]
        b = state["belief"]
        mon.belief.util = b["util"].copy()
        mon.belief.as_of = b["as_of"]
        mon.belief.polls = b["polls"]
        return mon
