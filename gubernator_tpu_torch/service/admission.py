"""Decision provenance: which path answered, how stale it was.

The port of `gubernator_tpu/service/admission.py`: one canonical path
enum, a metadata stamping helper every answer-constructing site in
service/ calls, and a bounded flight recorder of decisions.

- `stamp_decision(resp, path, staleness_ms)` — response METADATA, only
  attached when the caller passes a metadata dict to write into
  (servers gate it on `stage_metadata`);
- `DecisionRecorder.record_decision / record_columnar` — the
  `gubernator_admission_decisions{path,status}` counters, the
  `gubernator_over_limit_counter{path}` children, and the ring. Always
  on: counters are O(1) dict bumps, the ring is bounded.

A ring entry's `trace_id` comes from `current_trace_id()`, the seam the
tracing slice fills; until it lands every entry's is "".

Everything here is host-side stdlib + numpy — never any device work
(the recorder sits on serving paths AND scrape paths).
"""

from __future__ import annotations

import collections
import threading
from typing import Optional

from gubernator_tpu_torch.api.keys import key_hash128
from gubernator_tpu_torch.utils import clock as _clock

# The provenance enum. Every answer a client can receive names exactly
# one of these as the path that produced it:
PATH_OWNER = "owner"  # this node owns the key; local engine decided
PATH_REPLICA = "replica"  # GLOBAL non-owner answered from replicated state
PATH_DEGRADED_LOCAL = "degraded_local"  # owner circuit open; local answer
PATH_LEASE = "lease"  # holder-side zero-RPC debit from a leased slice
PATH_FASTPATH = "fastpath"  # columnar edge fastpath (owner-local decide)
PATH_FORWARDED = "forwarded"  # answered by the owner over peer forwarding
PATH_SHED = "shed"  # overload governor refused it (never reached a table)

PATHS = (
    PATH_OWNER,
    PATH_REPLICA,
    PATH_DEGRADED_LOCAL,
    PATH_LEASE,
    PATH_FASTPATH,
    PATH_FORWARDED,
    PATH_SHED,
)

# Response-metadata keys (the `stage_metadata` surface; the wire
# carries metadata verbatim).
DECISION_PATH_MD_KEY = "decision_path"
DECISION_STALENESS_MD_KEY = "decision_staleness_ms"

_STATUS_LABELS = ("under_limit", "over_limit")


def current_trace_id() -> str:
    """The trace id of the span the caller runs in: the one seam of this
    module that the tracing slice replaces. No tracing yet: ""."""
    return ""


def status_label(resp) -> str:
    """Counter label for a response: under_limit | over_limit | error."""
    if getattr(resp, "error", ""):
        return "error"
    s = int(getattr(resp, "status", 0))
    return _STATUS_LABELS[1] if s == 1 else _STATUS_LABELS[0]


def stamp_decision(resp, path: str, staleness_ms: Optional[int] = None):
    """Stamp provenance metadata on a response (in place) and return it.
    `staleness_ms` is the answer's staleness bound: 0 for authoritative
    owner answers, the broadcast age for replica answers, the grant age
    for lease debits, unknown (omitted) when the caller cannot bound
    it."""
    md = resp.metadata
    if md is None:
        return resp
    md[DECISION_PATH_MD_KEY] = path
    if staleness_ms is not None:
        md[DECISION_STALENESS_MD_KEY] = str(max(0, int(staleness_ms)))
    return resp


class DecisionRecorder:
    """Decision counters + bounded flight recorder.

    Counters are pre-resolved per (path, status) pair so the object
    hot path pays one dict lookup and one locked add per response. The
    ring holds the last `ring_size` decisions as plain dicts (key hash
    pair, path, status, remaining, staleness_ms, trace_id, ts_ms) —
    joinable with the tracing spans via trace_id and with the engine
    flight recorder via the key hash pair."""

    def __init__(self, metrics, ring_size: int = 256):
        self.metrics = metrics
        self.ring: collections.deque = collections.deque(
            maxlen=max(int(ring_size), 1)
        )
        self._lock = threading.Lock()
        self._children: dict = {}
        self._over_children: dict = {}
        self._counts: dict = {}  # (path, status) -> int, for snapshot()

    # -- counting ------------------------------------------------------------

    def _child(self, path: str, label: str):
        # Cache get and insert both run under the lock (two racing
        # threads used to each create a child and inc their own, with
        # one cached — splitting counts across counter objects). The
        # labels() call itself stays OUTSIDE: it takes the metrics
        # registry lock, which must never nest under ours.
        with self._lock:
            c = self._children.get((path, label))
        if c is None:
            c = self.metrics.admission_decisions.labels(path, label)
            with self._lock:
                c = self._children.setdefault((path, label), c)
        return c

    def _over_child(self, path: str):
        with self._lock:
            c = self._over_children.get(path)
        if c is None:
            c = self.metrics.over_limit_counter.labels(path)
            with self._lock:
                c = self._over_children.setdefault(path, c)
        return c

    def _count(self, path: str, label: str, n: int = 1) -> None:
        self._child(path, label).inc(n)
        if label == "over_limit":
            self._over_child(path).inc(n)
        with self._lock:
            self._counts[(path, label)] = (
                self._counts.get((path, label), 0) + n
            )

    # -- recording -----------------------------------------------------------

    def record_decision(
        self,
        path: str,
        resp,
        *,
        key: Optional[str] = None,
        key_hi: int = 0,
        key_lo: int = 0,
        staleness_ms: int = 0,
    ) -> None:
        """Count one object-path decision and append it to the ring."""
        label = status_label(resp)
        self._count(path, label)
        if key is not None:
            key_hi, key_lo = key_hash128(key)
        entry = {
            "key_hi": int(key_hi),
            "key_lo": int(key_lo),
            "path": path,
            "status": label,
            "remaining": int(getattr(resp, "remaining", 0)),
            "staleness_ms": max(0, int(staleness_ms)),
            "trace_id": current_trace_id(),
            "ts_ms": _clock.now_ms(),
        }
        with self._lock:
            self.ring.append(entry)

    def record_columnar(
        self,
        path: str,
        statuses,
        remaining,
        mask=None,
        staleness_ms: int = 0,
        sample_key=None,
    ) -> None:
        """Vectorized recording for the columnar fastpath: numpy sums
        feed the counters (no per-item Python), and ONE sample row per
        call (the last served lane) feeds the ring — bounded cost at
        any batch width. `sample_key(idx) -> hash_key string` is only
        invoked for that single sampled lane, so callers never pay a
        per-item key materialization."""
        import numpy as np

        statuses = np.asarray(statuses)
        if mask is None:
            mask = np.ones(statuses.shape, dtype=bool)
        else:
            mask = np.asarray(mask, dtype=bool)
        n = int(mask.sum())
        if n == 0:
            return
        over = int(((statuses == 1) & mask).sum())
        if over:
            self._count(path, "over_limit", over)
        if n - over:
            self._count(path, "under_limit", n - over)
        idx = int(np.flatnonzero(mask)[-1])
        key_hi = key_lo = 0
        if sample_key is not None:
            try:
                key_hi, key_lo = key_hash128(sample_key(idx))
            except Exception:  # the ring sample is best-effort; the counters landed
                pass
        entry = {
            "key_hi": int(key_hi),
            "key_lo": int(key_lo),
            "path": path,
            "status": (
                "over_limit" if int(statuses[idx]) == 1 else "under_limit"
            ),
            "remaining": int(np.asarray(remaining)[idx]),
            "staleness_ms": max(0, int(staleness_ms)),
            "trace_id": current_trace_id(),
            "ts_ms": _clock.now_ms(),
        }
        with self._lock:
            self.ring.append(entry)

    # -- introspection -------------------------------------------------------

    def snapshot(self) -> dict:
        """/debug/admission payload: per-(path, status) totals plus the
        ring, newest last. Pure host-side copies."""
        with self._lock:
            counts = {
                f"{path}:{label}": n
                for (path, label), n in sorted(self._counts.items())
            }
            ring = list(self.ring)
        return {
            "decisions": counts,
            "ring_size": self.ring.maxlen,
            "ring": ring,
        }
