"""Device-tier telemetry plumbing: the flight recorder.

The port of `gubernator_tpu/runtime/telemetry.py`, less its compile
listener and the serving scope that listener reads: the JAX package
counts XLA compiles that land inside a serving dispatch, and the port
compiles nothing while it serves (its kernels build once, at first
use), so `gubernator_engine_cold_compile_count` and the compile families
stay 0.

FlightRecorder: a fixed-size ring of the last K flush/tick records
(width, waves, carry, duration, layout). When a latency spike is
already minutes old, the histograms say *that* it happened; the
recorder says *what the engine was doing*. The engine's
`debug_snapshot()` serves it.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Optional


class FlightRecorder:
    """Fixed-size ring buffer of the last K flush/tick records.

    record() is one lock hold + one deque append per FLUSH (never per
    request); snapshot() returns newest-last copies. `seq` is a
    monotonic record id so a poller can detect how many records it
    missed between reads."""

    def __init__(self, capacity: int = 128):
        self._buf: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._seq = 0

    @property
    def capacity(self) -> int:
        return self._buf.maxlen or 0

    def record(self, **fields) -> None:
        with self._lock:
            self._seq += 1
            self._buf.append({"seq": self._seq, "ts": time.time(), **fields})

    def snapshot(self) -> list:
        with self._lock:
            return list(self._buf)

    def last(self) -> Optional[dict]:
        with self._lock:
            return self._buf[-1] if self._buf else None
