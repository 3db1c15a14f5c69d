"""Self-watchdog: named heartbeats for every long-lived loop.

The port of `gubernator_tpu/runtime/watchdog.py`. The engine's loops
(the pump, the completion thread, the page demoter, the GLOBAL sync
thread) fail SILENTLY: a wedged completion thread just stops draining
its queue, the pump blocks on the pipeline semaphore, and from the
outside the node looks healthy while every decision times out.

The watchdog inverts liveness detection: each loop calls
`wd.beat(name, ...)` once per iteration, and a monitor thread flags any
heartbeat older than its deadline into `stalled`. `serving_stalled()` is
True when a loop marked `serving=True` (the pump / completion pair on
the decision path) is stalled; the SLO layer burns the availability
budget on it.

Heartbeats are plain dict stores (atomic under the interpreter lock),
safe from threads and asyncio tasks alike. Loops with a long natural
cadence pass `period_s`, so their deadline is `stall + period`. The
clock is injectable (`clock=`, default `time.monotonic`), so tests
drive stalls with no sleeping.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional


class Watchdog:
    """Monitor thread + heartbeat table. start()/stop() lifecycle is
    owned by whoever builds it; loops only ever call beat()."""

    def __init__(self, stall_ms: float = 5000.0,
                 clock: Callable[[], float] = time.monotonic):
        self.stall_s = max(float(stall_ms), 1.0) / 1000.0
        self._clock = clock
        # name -> (last_beat, serving, period_s). Replaced wholesale on
        # every beat; readers snapshot via dict(...) so iteration never
        # races a writer.
        self._beats: dict[str, tuple[float, bool, float]] = {}
        self._stalled: dict[str, bool] = {}
        self._stall_events: dict[str, int] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- producer side ------------------------------------------------------

    def beat(
        self, name: str, *, serving: bool = False, period_s: float = 0.0
    ) -> None:
        """Record one loop iteration. First beat auto-registers the
        loop: a loop that never starts simply never appears (a missing
        row, not a false 'healthy')."""
        self._beats[name] = (self._clock(), serving, float(period_s))

    def unregister(self, name: str) -> None:
        """Drop a loop that shut down cleanly so its final heartbeat
        doesn't age into a false stall."""
        self._beats.pop(name, None)
        self._stalled.pop(name, None)

    def beats(self) -> dict:
        """{loop name: the clock value of its last beat}: the loops
        that have beaten."""
        return {n: b[0] for n, b in dict(self._beats).items()}

    # -- monitor side -------------------------------------------------------

    def _deadline_s(self, period_s: float) -> float:
        # A loop beating every period_s sits at age <= period_s in
        # steady state; stall_s on top is the wedge margin.
        return self.stall_s + max(period_s, 0.0)

    def check(self, now: Optional[float] = None) -> dict[str, bool]:
        """One evaluation pass; also called directly by tests so stall
        detection needs no sleeping."""
        now = self._clock() if now is None else now
        for name, (ts, _serving, period_s) in dict(self._beats).items():
            stalled = (now - ts) > self._deadline_s(period_s)
            if stalled and not self._stalled.get(name, False):
                self._stall_events[name] = self._stall_events.get(name, 0) + 1
            self._stalled[name] = stalled
        # beats removed by unregister leave no stalled residue
        for name in list(self._stalled):
            if name not in self._beats:
                del self._stalled[name]
        return dict(self._stalled)

    def _loop(self) -> None:
        poll = min(max(self.stall_s / 4.0, 0.01), 1.0)
        while not self._stop.wait(poll):
            self.beat("watchdog-monitor", period_s=poll)
            self.check()

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="gubernator-torch-watchdog", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

    # -- consumers ----------------------------------------------------------

    def stalled_loops(self) -> list[str]:
        return sorted(n for n, s in self._stalled.items() if s)

    def serving_stalled(self) -> bool:
        """True when any serving-path loop is stalled — the hook the
        availability SLO burns on."""
        beats = dict(self._beats)
        return any(
            self._stalled.get(n, False) and beats.get(n, (0, False, 0))[1]
            for n in self._stalled
        )

    def snapshot(self) -> dict:
        """JSON-shaped per-loop heartbeat table."""
        now = self._clock()
        loops = {}
        for name, (ts, serving, period_s) in sorted(dict(self._beats).items()):
            loops[name] = {
                "age_ms": round((now - ts) * 1000.0, 1),
                "deadline_ms": round(self._deadline_s(period_s) * 1000.0, 1),
                "serving": serving,
                "stalled": bool(self._stalled.get(name, False)),
                "stall_events": int(self._stall_events.get(name, 0)),
            }
        return {
            "stall_ms": round(self.stall_s * 1000.0, 1),
            "serving_stalled": self.serving_stalled(),
            "loops": loops,
        }
