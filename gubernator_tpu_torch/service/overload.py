"""Overload control plane: bounded intake, fair shedding, brownout.

The port of `gubernator_tpu/service/overload.py`. Without it the
engine's intake is an unbounded queue: a flood (or a retry storm
amplifying one) grows the queue without limit, work whose caller has
given up is still executed, and one hot tenant starves everyone queued
behind it. Off (nothing set on `engine.overload`), the engine is the
engine without this module, answer for answer.

- `IntakeGovernor`: set as `engine.overload` (the engine duck-types the
  seam, as it does its watchdog). `admit()` runs before a request is
  enqueued: an already expired deadline (the absolute `deadline_ms`
  metadata) is refused outright, intake past `limit` is shed with the
  typed retryable ERR_OVERLOADED and a `retry_after_ms`, and when the
  engine's queue-wait signal stays above `target_ms` a CoDel-style
  controller sheds with a probability weighted per tenant (tenant = the
  rate-limit namespace `req.name`) so that a flooding tenant sheds
  first. Heavy hitters are attributed with the metrics' HotKeySketch.
  The pump calls `deadline_expired()` at pickup, so queued work whose
  caller already gave up never reaches the device.

- `RetryBudget`: a token-bucket retry budget (each first attempt
  deposits `ratio` tokens, each retry spends one), so client retries
  can never multiply an overload by more than 1 + ratio.

- `OverloadManager`: the brownout ladder. A thread folds the SLO burn
  rates (fast burn or exhausted), the watchdog's serving-stall flag and
  the governor's sustained-overload state into one level: normal (0),
  shed observability extras (1), degraded-local for would-be forwards
  (2), shed heavy tenants (3), escalating after a short bad streak and
  recovering after a longer good streak (hysteresis). The level is the
  `gubernator_overload_level` gauge and `debug_info()`.

Shed answers are stamped with decision path `shed` and counted through
the service's DecisionRecorder, so the admission observatory sees shed
traffic.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import Optional

from gubernator_tpu_torch.api.keys import key_hash128
from gubernator_tpu_torch.api.types import ERR_OVERLOADED, RETRY_AFTER_MD_KEY, RateLimitResp
from gubernator_tpu_torch.metrics import HotKeySketch
from gubernator_tpu_torch.service.admission import PATH_SHED, stamp_decision
from gubernator_tpu_torch.utils import clock as _clock

log = logging.getLogger("gubernator_tpu_torch.overload")

# Absolute caller deadline, epoch ms (request metadata).
DEADLINE_MD_KEY = "deadline_ms"

# A caller deadline that expired before the request reached the device.
# Deliberately NOT retryable: the caller already gave up, and sending the
# same dead request again only adds load.
ERR_DEADLINE_EXPIRED = "DEADLINE_EXCEEDED: caller deadline expired; request not applied"

# Shed reason labels (gubernator_intake_shed_counter{reason=...}).
SHED_QUEUE_FULL = "queue_full"  # intake depth >= limit
SHED_DEADLINE = "deadline_expired"  # refused at admit or dropped at pickup
SHED_CODEL = "codel"  # standing queue above target; fair-share shed
SHED_TENANT = "tenant"  # same controller, dominant-tenant multiplier
SHED_BROWNOUT = "brownout"  # ladder level 3: heavy tenant shed outright
SHED_REASONS = (SHED_QUEUE_FULL, SHED_DEADLINE, SHED_CODEL, SHED_TENANT, SHED_BROWNOUT)

# Brownout ladder levels, least to most degraded.
LEVEL_NORMAL = 0
LEVEL_SHED_OBSERVABILITY = 1
LEVEL_DEGRADED_LOCAL = 2
LEVEL_SHED_TENANTS = 3
LEVEL_NAMES = ("normal", "shed_observability", "degraded_local", "shed_tenants")

# The controller's and the ladder's fixed settings: the JAX package's
# defaults, which no caller there changes either.
CODEL_INTERVAL_S = 0.1  # the CoDel interval over which the minimum wait is taken
FAIRNESS_WINDOW_S = 1.0  # the tenant-share window folded into the EWMA
RAMP_S = 1.0  # sustained overload over which the shed probability ramps up
P_BASE = 0.05  # shed probability as a standing queue is first seen
P_MAX = 0.9  # the shed probability's ceiling
HEAVY_SHARE = 0.5  # a tenant's window share that makes it heavy (level 3 sheds it)
TENANT_K = 128  # tenants tracked by the fairness EWMA and the heavy-hitter sketch
ESCALATE_AFTER = 2  # bad ladder steps in a row that raise the level by one


def request_deadline_ms(req) -> Optional[int]:
    """The absolute epoch-ms deadline a request carries, or None."""
    md = getattr(req, "metadata", None)
    if not md:
        return None
    raw = md.get(DEADLINE_MD_KEY)
    if raw is None:
        return None
    try:
        return int(float(raw))
    except (TypeError, ValueError):
        return None


class RetryBudget:
    """Token-bucket retry budget: every first attempt deposits `ratio`
    tokens (capped at `burst`), every retry spends one. While the server
    is healthy the bucket sits full and retries are free; under
    sustained overload it drains and retries are capped at `ratio` of
    the offered first attempts."""

    def __init__(self, ratio: float = 0.1, burst: float = 10.0):
        self.ratio = max(0.0, min(float(ratio), 1.0))
        self.burst = max(1.0, float(burst))
        self._lock = threading.Lock()
        self._tokens = self.burst  # start full: a first failure may retry
        self._attempts = 0
        self._retries = 0
        self._denied = 0

    def record(self, n: int = 1) -> None:
        """Account `n` first attempts (refills the bucket)."""
        with self._lock:
            self._attempts += n
            self._tokens = min(self.burst, self._tokens + n * self.ratio)

    def try_spend(self, cost: float = 1.0) -> bool:
        """Spend budget for one retry; False means drop the retry."""
        with self._lock:
            if self._tokens >= cost:
                self._tokens -= cost
                self._retries += 1
                return True
            self._denied += 1
            return False

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "ratio": self.ratio,
                "burst": self.burst,
                "tokens": round(self._tokens, 3),
                "attempts": self._attempts,
                "retries": self._retries,
                "denied": self._denied,
            }


class IntakeGovernor:
    """Per-engine intake admission controller.

    `admit(req, depth)` is called by the engine before it enqueues
    (`check_async`, and each member of `check_bulk`); it returns
    `(shed_resp_or_None, deadline_ms_or_None)`. A response short-circuits
    the request without touching the queue; a deadline rides on the
    slot or future so that the pump can drop it at pickup
    (`deadline_expired()`, `refuse_expired()`).

    The CoDel-style controller watches the engine's queue wait through
    `observe_wait()`: per CODEL_INTERVAL_S it tracks the MINIMUM wait (a
    transient burst has a small minimum, a standing queue does not).
    While the interval minimum stays above target, the shed probability
    ramps from P_BASE to P_MAX over RAMP_S of sustained overload,
    weighted per tenant by its recent share of intake (an EWMA over
    FAIRNESS_WINDOW_S windows, clamped to [0.25, 4.0]) so that the
    flooder sheds first. Ladder level 3 also sheds heavy-hitter tenants
    (window share >= HEAVY_SHARE) outright.

    `rng` (a function returning a float in [0, 1)) and `now` (the
    controller's monotonic clock) are injectable; deadlines are read on
    `utils.clock.now_ms()`. The tenant sketch and the recorder are only
    touched outside the governor's lock."""

    def __init__(self, limit: int = 8192, target_ms: float = 20.0, *, metrics=None,
                 recorder=None, rng=None, now=time.monotonic):
        self.limit = max(1, int(limit))
        self.target_s = max(float(target_ms), 0.001) / 1000.0
        self.metrics = metrics
        self.recorder = recorder
        self._rng = rng if rng is not None else random.random
        self._now = now
        self._lock = threading.Lock()
        # CoDel interval state.
        self._interval_min: Optional[float] = None
        self._interval_end = now() + CODEL_INTERVAL_S
        self._over_since: Optional[float] = None
        self._wait_ewma = 0.0
        # Tenant fairness: `_tenant_window` counts admits in the current
        # window; at rollover it folds into the `_tenant_rates` EWMA, from
        # which `_tenant_mult` (shed weight) and `_heavy` (level-3 shed
        # set) are rebuilt as fresh objects (admit reads them by swap,
        # never mutated in place).
        self._tenant_window: dict = {}
        self._tenant_rates: dict = {}
        self._tenant_mult: dict = {}
        self._heavy: frozenset = frozenset()
        self._window_end = now() + FAIRNESS_WINDOW_S
        self._level = LEVEL_NORMAL
        self._shed_counts = {r: 0 for r in SHED_REASONS}
        # Heavy-hitter attribution, fed outside the intake lock and
        # suppressed at ladder level >= 1 (an observability extra, not a
        # control input).
        self.tenant_sketch = HotKeySketch(
            "overload_intake_tenants",
            "per-tenant intake admits (debug-only sketch)",
            k=TENANT_K,
        )
        self._hash_cache: dict = {}  # tenant -> (hi, lo), rebuilt when full
        self._shed_children = None
        if metrics is not None:
            self._shed_children = {r: metrics.intake_shed_counter.labels(r)
                                   for r in SHED_REASONS}

    # -- admission -----------------------------------------------------------

    def admit(self, req, depth: int):
        """Admission control of one request about to be enqueued.
        Returns `(resp, deadline_ms)`: a response is the final answer
        (shed or refused, never enqueued); a deadline (present and not
        expired) must ride on the slot for the pickup-time check."""
        dl = request_deadline_ms(req)
        if dl is not None and _clock.now_ms() >= dl:
            return self.refuse_expired(req), None
        tenant = req.name or "<none>"
        now = self._now()
        reason = None
        with self._lock:
            self._maybe_roll(now)
            self._tenant_window[tenant] = self._tenant_window.get(tenant, 0) + 1
            level = self._level
            if depth >= self.limit:
                reason = SHED_QUEUE_FULL
            elif level >= LEVEL_SHED_TENANTS and tenant in self._heavy:
                reason = SHED_BROWNOUT
            else:
                p = self._shed_p_locked(now)
                if p > 0.0:
                    mult = self._tenant_mult.get(tenant, 1.0)
                    if self._rng() < min(P_MAX, p * mult):
                        reason = SHED_TENANT if mult > 1.5 else SHED_CODEL
            retry_ms = self._retry_after_ms_locked()
        if level < LEVEL_SHED_OBSERVABILITY:
            self.tenant_sketch.update([(self._tenant_hash(tenant), 1, 0, tenant)])
        if reason is None:
            return None, dl
        return self._shed(req, reason, retry_ms), dl

    def deadline_expired(self, deadline_ms: int) -> bool:
        """Pickup-time check of a slot's stored deadline."""
        return _clock.now_ms() >= deadline_ms

    def refuse_expired(self, req) -> RateLimitResp:
        """The terminal (non-retryable) refusal of an expired deadline,
        at admit and at pickup."""
        resp = RateLimitResp(error=ERR_DEADLINE_EXPIRED, metadata={})
        stamp_decision(resp, PATH_SHED)
        self._count_shed(SHED_DEADLINE)
        self._record(req, resp)
        return resp

    def _shed(self, req, reason: str, retry_ms: int) -> RateLimitResp:
        resp = RateLimitResp(error=ERR_OVERLOADED, metadata={RETRY_AFTER_MD_KEY: str(retry_ms)})
        stamp_decision(resp, PATH_SHED)
        self._count_shed(reason)
        self._record(req, resp)
        return resp

    def _count_shed(self, reason: str) -> None:
        with self._lock:
            self._shed_counts[reason] += 1
        ch = self._shed_children
        if ch is not None:
            ch[reason].inc()

    def _record(self, req, resp) -> None:
        rec = self.recorder
        if rec is not None:
            rec.record_decision(PATH_SHED, resp, key=req.hash_key())

    def _tenant_hash(self, tenant: str):
        h = self._hash_cache.get(tenant)
        if h is None:
            if len(self._hash_cache) >= 4096:
                self._hash_cache = {}
            h = key_hash128(tenant)
            self._hash_cache[tenant] = h
        return h

    # -- queue-wait controller -----------------------------------------------

    def observe_wait(self, wait_s: float) -> None:
        """Fed by the engine's pump with each picked-up entry's queue
        wait (the signal the queue_wait histogram observes)."""
        now = self._now()
        with self._lock:
            self._wait_ewma += 0.1 * (wait_s - self._wait_ewma)
            if self._interval_min is None or wait_s < self._interval_min:
                self._interval_min = wait_s
            self._maybe_roll(now)

    def _maybe_roll(self, now: float) -> None:
        """Roll the CoDel interval and the fairness window (lock held).
        Both admit() and observe_wait() drive it, so the controller does
        not go stale when only one side is active."""
        if now >= self._interval_end:
            # An interval with no pump observations has no evidence of a
            # standing queue (idle or drained): under target. Depth-based
            # shedding still covers a stalled pump.
            if self._interval_min is not None and self._interval_min > self.target_s:
                if self._over_since is None:
                    self._over_since = now
            else:
                self._over_since = None
            self._interval_min = None
            self._interval_end = now + CODEL_INTERVAL_S
        if now >= self._window_end:
            self._roll_window_locked()
            self._window_end = now + FAIRNESS_WINDOW_S

    def _roll_window_locked(self) -> None:
        counts, self._tenant_window = self._tenant_window, {}
        rates = {}
        for t, r in self._tenant_rates.items():
            nr = 0.5 * r + 0.5 * counts.pop(t, 0)
            if nr >= 0.25:
                rates[t] = nr
        for t, c in counts.items():
            rates[t] = 0.5 * c
        if len(rates) > TENANT_K:
            keep = sorted(rates, key=rates.get, reverse=True)
            rates = {t: rates[t] for t in keep[:TENANT_K]}
        self._tenant_rates = rates
        total = sum(rates.values())
        n = len(rates)
        if total > 0.0 and n > 1:
            self._tenant_mult = {t: min(4.0, max(0.25, (r / total) * n))
                                 for t, r in rates.items()}
            self._heavy = frozenset(t for t, r in rates.items() if r / total >= HEAVY_SHARE)
        else:
            # a single tenant has no one to be fair against: plain CoDel
            self._tenant_mult = {}
            self._heavy = frozenset()

    def _shed_p_locked(self, now: float) -> float:
        if self._over_since is None:
            return 0.0
        frac = min(1.0, (now - self._over_since) / RAMP_S)
        return min(P_MAX, P_BASE + frac * P_MAX)

    def _retry_after_ms_locked(self) -> int:
        base_ms = 2.0 * max(self._wait_ewma, self.target_s) * 1000.0
        return max(25, min(int(base_ms), 5000))

    # -- ladder / introspection ----------------------------------------------

    def set_level(self, level: int) -> None:
        with self._lock:
            self._level = max(LEVEL_NORMAL, min(int(level), LEVEL_SHED_TENANTS))

    def overloaded(self) -> dict:
        """The controller's state for the ladder: a sustained standing
        queue."""
        now = self._now()
        with self._lock:
            self._maybe_roll(now)
            over = self._over_since
            return {"overloaded": over is not None,
                    "sustained_s": (now - over) if over is not None else 0.0}

    def snapshot(self) -> dict:
        now = self._now()
        with self._lock:
            self._maybe_roll(now)
            over = self._over_since
            snap = {
                "limit": self.limit,
                "target_ms": round(self.target_s * 1000.0, 3),
                "level": self._level,
                "overloaded": over is not None,
                "sustained_s": round((now - over) if over is not None else 0.0, 3),
                "wait_ewma_ms": round(self._wait_ewma * 1000.0, 3),
                "shed_p": round(self._shed_p_locked(now), 4),
                "retry_after_ms": self._retry_after_ms_locked(),
                "shed": dict(self._shed_counts),
                "tenant_mult": {t: round(m, 3) for t, m in sorted(self._tenant_mult.items())},
                "heavy_tenants": sorted(self._heavy),
            }
        sk = self.tenant_sketch.snapshot()
        snap["hot_tenants"] = [{"tenant": e["key"], "admits": e["hits"]}
                               for e in sk["entries"][:8]]
        return snap


class OverloadManager:
    """The brownout ladder: folds the SLO burn rates, the watchdog's
    serving-stall flag and the governor's sustained-overload state into
    one published level, with escalation streaks and recovery
    hysteresis. Owns the IntakeGovernor set on the engine."""

    def __init__(self, svc, governor: IntakeGovernor, *, slo=None, watchdog=None,
                 interval_s: float = 0.25, hysteresis: int = 8):
        self.svc = svc
        self.governor = governor
        self.slo = slo
        self.watchdog = watchdog
        self.interval_s = max(float(interval_s), 0.01)
        self.hysteresis = max(1, int(hysteresis))
        self._level = LEVEL_NORMAL
        self._since_ms = _clock.now_ms()
        self._bad_streak = 0
        self._good_streak = 0
        self._last_signals: dict = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._transition_children = None
        m = getattr(svc, "metrics", None)
        if m is not None:
            self._transition_children = {lv: m.overload_transitions.labels(str(lv))
                                         for lv in range(len(LEVEL_NAMES))}

    # -- level effects -------------------------------------------------------

    @property
    def level(self) -> int:
        return self._level

    def degrade_forwards(self) -> bool:
        """Level >= 2: answer would-be peer forwards locally (the
        degraded-local path) instead of queueing onto a sick mesh."""
        return self._level >= LEVEL_DEGRADED_LOCAL

    # -- evaluation ----------------------------------------------------------

    def evaluate(self) -> int:
        """One ladder step: gather the signals, update the streaks, move
        at most one level. The ladder thread calls it; so may a test."""
        sigs = {"slo_fast_burn": [], "serving_stalled": False, "intake_overloaded": False}
        slo = self.slo if self.slo is not None else getattr(self.svc, "slo", None)
        if slo is not None:
            try:
                rows = slo.evaluate()
            except Exception:  # a broken SLO source must not take down the ladder
                rows = []
            for r in rows:
                if r.get("state") in ("fast_burn", "exhausted"):
                    sigs["slo_fast_burn"].append(r.get("id"))
        wd = self.watchdog
        if wd is not None:
            sigs["serving_stalled"] = bool(wd.serving_stalled())
        sigs["intake_overloaded"] = self.governor.overloaded()["overloaded"]
        pressure = bool(sigs["slo_fast_burn"] or sigs["serving_stalled"]
                        or sigs["intake_overloaded"])
        if pressure:
            self._good_streak = 0
            self._bad_streak += 1
            if self._bad_streak >= ESCALATE_AFTER and self._level < LEVEL_SHED_TENANTS:
                self._set_level(self._level + 1)
                self._bad_streak = 0
        else:
            self._bad_streak = 0
            self._good_streak += 1
            if self._good_streak >= self.hysteresis and self._level > LEVEL_NORMAL:
                self._set_level(self._level - 1)
                self._good_streak = 0
        self._last_signals = sigs
        return self._level

    def _set_level(self, level: int) -> None:
        prev, self._level = self._level, level
        self._since_ms = _clock.now_ms()
        self.governor.set_level(level)
        ch = self._transition_children
        if ch is not None:
            ch[level].inc()
        (log.warning if level > prev else log.info)(
            "overload ladder %s: level %d (%s) -> %d (%s)",
            "escalated" if level > prev else "recovered",
            prev, LEVEL_NAMES[prev], level, LEVEL_NAMES[level],
        )

    # -- publication ---------------------------------------------------------

    def metrics_sync(self, m) -> None:
        """Scrape bridge (Metrics.add_sync through V1Service)."""
        m.overload_level.set(self._level)

    def debug_info(self) -> dict:
        """The /debug/overload payload."""
        return {
            "enabled": True,
            "level": self._level,
            "level_name": LEVEL_NAMES[self._level],
            "since_ms": self._since_ms,
            "escalate_after": ESCALATE_AFTER,
            "hysteresis": self.hysteresis,
            "signals": dict(self._last_signals),
            "intake": self.governor.snapshot(),
        }

    # -- lifecycle -----------------------------------------------------------

    def _loop(self) -> None:
        if self.watchdog is not None:
            self.watchdog.beat("overload-ladder", period_s=self.interval_s)
        while not self._stop.wait(self.interval_s):
            if self.watchdog is not None:
                self.watchdog.beat("overload-ladder", period_s=self.interval_s)
            try:
                self.evaluate()
            except Exception:
                # a broken signal source must not kill the ladder; the beat
                # above keeps the loop itself observable
                log.exception("overload ladder evaluation failed")

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="gubernator-torch-overload-ladder", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)
        if self.watchdog is not None:
            self.watchdog.unregister("overload-ladder")
