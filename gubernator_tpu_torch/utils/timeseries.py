"""Bounded per-daemon time-series rings for the SLO observatory.

The port of `gubernator_tpu/utils/timeseries.py`. Every SLI the
observatory reads (admission excess ratio, flush p99, shard imbalance,
...) is a point-in-time value; a burn rate ("how fast is the error
budget draining over the last 5 minutes against the last hour?") needs
its history, kept bounded and cheap on the serving host:

  - fixed-capacity circular buffers of (monotonic_ts, value): memory is
    capacity * 2 floats per series, forever;
  - pure host Python (no torch, no numpy): the sampler runs on a
    background thread and does no device work, and the reductions run
    on scrapes and debug reads;
  - reductions windowed by time, not count: specs say "5m window", and
    the sampler's cadence is a setting, so count-based windows would
    rescale every window when the cadence changes.

Every reduction returns None on an empty window, so that a caller can
tell "no data yet" from a real zero.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Callable


class Ring:
    """Fixed-capacity circular buffer of (monotonic_ts, value) samples.

    Thread-safe: one sampler thread pushes, scrape and debug threads
    reduce. The lock is per ring and never held across user code.
    """

    __slots__ = ("capacity", "_ts", "_vals", "_n", "_head", "_lock")

    def __init__(self, capacity: int = 720):
        if capacity < 1:
            raise ValueError(f"ring capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._ts = [0.0] * self.capacity
        self._vals = [0.0] * self.capacity
        self._n = 0  # samples stored (<= capacity)
        self._head = 0  # next write position
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return self._n

    def push(self, value: float, ts: float | None = None) -> None:
        """Append one sample; evicts the oldest once full."""
        ts = time.monotonic() if ts is None else float(ts)
        with self._lock:
            self._ts[self._head] = ts
            self._vals[self._head] = float(value)
            self._head = (self._head + 1) % self.capacity
            if self._n < self.capacity:
                self._n += 1

    def samples(self) -> list[tuple[float, float]]:
        """All stored samples, oldest first."""
        with self._lock:
            n, head, cap = self._n, self._head, self.capacity
            start = (head - n) % cap
            idx = [(start + i) % cap for i in range(n)]
            return [(self._ts[i], self._vals[i]) for i in idx]

    def window(self, window_s: float, now: float | None = None) -> list[tuple[float, float]]:
        """Samples with ts > now - window_s, oldest first."""
        now = time.monotonic() if now is None else float(now)
        cutoff = now - float(window_s)
        return [(t, v) for t, v in self.samples() if t > cutoff]

    def last(self) -> tuple[float, float] | None:
        """Newest (ts, value), or None when empty."""
        with self._lock:
            if self._n == 0:
                return None
            i = (self._head - 1) % self.capacity
            return (self._ts[i], self._vals[i])

    # -- windowed reductions (None on an empty window) -----------------------

    def mean(self, window_s: float, now: float | None = None) -> float | None:
        vals = [v for _, v in self.window(window_s, now)]
        return sum(vals) / len(vals) if vals else None

    def quantile(self, q: float, window_s: float, now: float | None = None) -> float | None:
        """Windowed quantile, numpy-default (linear) interpolation."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile q must be in [0, 1], got {q}")
        vals = sorted(v for _, v in self.window(window_s, now))
        if not vals:
            return None
        pos = q * (len(vals) - 1)
        lo = math.floor(pos)
        hi = math.ceil(pos)
        frac = pos - lo
        return vals[lo] * (1.0 - frac) + vals[hi] * frac

    def rate(self, window_s: float, now: float | None = None) -> float | None:
        """Per-second delta rate over the window, for monotonically
        increasing counter samples. A negative delta (a counter reset
        mid-ring) clamps to 0."""
        win = self.window(window_s, now)
        if len(win) < 2:
            return None
        (t0, v0), (t1, v1) = win[0], win[-1]
        dt = t1 - t0
        if dt <= 0.0:
            return None
        return max(v1 - v0, 0.0) / dt

    def bad_fraction(self, predicate: Callable[[float], bool], window_s: float,
                     now: float | None = None) -> float | None:
        """Fraction of windowed samples for which predicate(value) is
        true: the SLI -> bad-event mapping the burn-rate engine uses."""
        vals = [v for _, v in self.window(window_s, now)]
        if not vals:
            return None
        return sum(1 for v in vals if predicate(v)) / len(vals)


class RingSet:
    """Named rings sharing one capacity: the series store the SLO
    sampler writes and the burn-rate engine reads. Rings are created on
    first push, so the sampler pushes whatever SLIs the deployment has
    (shard skew exists only on a mesh) without a registration step."""

    def __init__(self, capacity: int = 720):
        self.capacity = int(capacity)
        self._rings: dict[str, Ring] = {}
        self._lock = threading.Lock()

    def ring(self, name: str) -> Ring:
        with self._lock:
            r = self._rings.get(name)
            if r is None:
                r = self._rings[name] = Ring(self.capacity)
            return r

    def get(self, name: str) -> Ring | None:
        with self._lock:
            return self._rings.get(name)

    def push(self, name: str, value: float, ts: float | None = None) -> None:
        self.ring(name).push(value, ts)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._rings)

    def snapshot(self, window_s: float | None = None) -> dict:
        """JSON-shaped dump for /debug/slo: per series the sample count,
        the newest value and (with `window_s`) the windowed mean."""
        out: dict[str, dict] = {}
        for name in self.names():
            r = self.ring(name)
            last = r.last()
            row: dict = {"n": len(r), "last": None if last is None else round(last[1], 6)}
            if window_s is not None:
                m = r.mean(window_s)
                row["mean"] = None if m is None else round(m, 6)
            out[name] = row
        return out
