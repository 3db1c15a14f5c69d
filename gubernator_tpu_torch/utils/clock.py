"""Freezable millisecond clock.

Production code asks `now_ms()`; tests and the chip smoke run freeze the
clock and advance it deterministically (the reference's holster clock,
functional_test.go `clock.Freeze`/`Advance`). Engines and the service
also take a `now_fn`, so a caller can inject its own clock instead.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

_lock = threading.Lock()
_frozen_ms: Optional[int] = None


def now_ms() -> int:
    """Current epoch milliseconds, honoring a frozen clock."""
    with _lock:
        if _frozen_ms is not None:
            return _frozen_ms
    return time.time_ns() // 1_000_000


class freeze:
    """Context manager freezing the clock, with `advance()`.

    Usage::

        with freeze() as clk:
            ...
            clk.advance(ms=100)
    """

    def __init__(self, at_ms: Optional[int] = None):
        self._at = at_ms

    def __enter__(self) -> "freeze":
        global _frozen_ms
        with _lock:
            self._prev = _frozen_ms
            _frozen_ms = self._at if self._at is not None else time.time_ns() // 1_000_000
        return self

    def __exit__(self, *exc) -> None:
        global _frozen_ms
        with _lock:
            _frozen_ms = self._prev

    def advance(self, ms: int) -> int:
        global _frozen_ms
        with _lock:
            if _frozen_ms is None:
                raise RuntimeError("clock is not frozen")
            _frozen_ms += ms
            return _frozen_ms

    @property
    def ms(self) -> int:
        with _lock:
            if _frozen_ms is None:
                raise RuntimeError("clock is not frozen")
            return _frozen_ms
