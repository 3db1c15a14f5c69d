"""Fleet SLO observatory: declarative specs and multi-window burn rates.

The port of `gubernator_tpu/service/slo.py`. The engine and the service
export point-in-time SLIs (flush and device-sync histograms, shard skew,
the admission excess ratio, the watchdog's stall flags); this module
tracks them over time with the standard multi-window multi-burn-rate
construction (Google SRE workbook ch. 5):

  - a background sampler pushes each SLI into a bounded time-series
    ring (utils/timeseries.py) every `interval_s`, reading ONLY cached
    snapshots and host counters: a sampler tick does no device work
    (the engine's `cached_admission()` / `cached_census()` never scan),
    so the observatory is free at any cadence;
  - each SloSpec maps its ring to a bad-event fraction (comparator and
    threshold against the raw SLI value) and an objective; the burn
    rate over a window is bad fraction / (1 - objective), so 1.0 means
    "burning exactly at budget";
  - the alert state machine fires `fast_burn` when BOTH fast windows
    (default 5m and 1h) exceed the fast factor (14.4), `slow_burn` when
    both slow windows (30m / 6h) exceed 6.0, and `exhausted` when the
    budget window's remaining budget reaches 0.

It exports through the gubernator_slo_* metric families (the service's
`_slo_sync` scrape bridge), `V1Service.slo_debug_info()` (the JAX
package's /debug/slo payload) and the compact `fleet_info()` blob. The
watchdog (runtime/watchdog.py) feeds the availability SLI: a stalled
serving loop zeroes `serving_ok`.

Sources the port does not have yet (the auditor, leases, the standby,
the cross-node GLOBAL manager, the forwarder's breakers) are read
through `getattr(svc, ..., None)` and push nothing while absent, as in
the JAX package.
"""

from __future__ import annotations

import json
import logging
import math
import threading
import time
from dataclasses import dataclass
from typing import Optional

from gubernator_tpu_torch.utils.timeseries import RingSet

log = logging.getLogger(__name__)

# Alert states, least to most severe; the numeric value of
# gubernator_slo_alert_state.
STATES = ("ok", "slow_burn", "fast_burn", "exhausted")

_COMPARATORS = ("gt", "ge", "lt", "le")


@dataclass(frozen=True)
class SloSpec:
    """One declarative SLO: which SLI ring, what counts as a bad
    sample, the objective, and the evaluation windows."""

    id: str
    sli: str  # ring name in the observatory's RingSet
    objective: float  # e.g. 0.999 -> error budget 0.001
    threshold: float = 0.0
    comparator: str = "gt"  # sample is BAD when <value> <cmp> <threshold>
    fast_windows: tuple = (300.0, 3600.0)  # 5m / 1h
    slow_windows: tuple = (1800.0, 21600.0)  # 30m / 6h
    fast_factor: float = 14.4
    slow_factor: float = 6.0
    budget_window_s: float = 21600.0  # budget accounted over 6h
    description: str = ""

    def validate(self) -> None:
        if not self.id or not self.sli:
            raise ValueError("SLO spec needs non-empty 'id' and 'sli'")
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"SLO {self.id!r}: objective must be in (0, 1), got {self.objective}"
            )
        if self.comparator not in _COMPARATORS:
            raise ValueError(
                f"SLO {self.id!r}: comparator must be one of {_COMPARATORS}, "
                f"got {self.comparator!r}"
            )
        for name, pair in (("fast_windows", self.fast_windows),
                           ("slow_windows", self.slow_windows)):
            if len(pair) != 2 or not all(isinstance(w, (int, float)) and w > 0 for w in pair):
                raise ValueError(
                    f"SLO {self.id!r}: {name} must be two positive durations, got {pair!r}"
                )
        if self.budget_window_s <= 0:
            raise ValueError(f"SLO {self.id!r}: budget_window_s must be > 0")

    def is_bad(self, value: float) -> bool:
        if self.comparator == "gt":
            return value > self.threshold
        if self.comparator == "ge":
            return value >= self.threshold
        if self.comparator == "lt":
            return value < self.threshold
        return value <= self.threshold


def default_specs() -> tuple:
    """The built-in SLO catalog (the JAX package's seven ids, with their
    objectives, thresholds and texts)."""
    return (
        SloSpec(
            id="availability",
            sli="serving_ok",
            objective=0.999,
            threshold=1.0,
            comparator="lt",
            description="Serving loops alive: the watchdog saw the pump "
            "and completion heartbeats within their stall deadline.",
        ),
        SloSpec(
            id="admission-accuracy",
            sli="admission_debt_ratio",
            objective=0.999,
            threshold=0.1,
            comparator="gt",
            description="Unreconciled admission debt — lease outstanding "
            "+ GLOBAL in-flight hits, the published over-admission bound "
            "(/debug/admission `bound`) — stays under 10% of the "
            "capacity admitted this window. A partitioned owner strands "
            "debt at the edges and burns this SLO until the heal drains "
            "it.",
        ),
        SloSpec(
            id="enforcement-fidelity",
            sli="false_over_limit_keys",
            objective=0.999,
            threshold=0.0,
            comparator="gt",
            description="No sampled key is refused at a current replica "
            "while the owner still has budget (auditor false-OVER_LIMIT).",
        ),
        SloSpec(
            id="flush-latency",
            sli="flush_p99_s",
            objective=0.99,
            threshold=0.1,
            comparator="gt",
            description="Engine flush p99 stays under 100ms.",
        ),
        SloSpec(
            id="propagation-freshness",
            sli="propagation_lag_p99_s",
            objective=0.99,
            threshold=5.0,
            comparator="gt",
            description="GLOBAL propagation lag p99 stays under 5s "
            "(origin stamp to replica apply).",
        ),
        SloSpec(
            id="durability",
            sli="standby_loss_bound_hits",
            objective=0.999,
            threshold=1000.0,
            comparator="gt",
            description="The published hard-kill loss bound — hits "
            "dirtied since the last acked standby delta ship "
            "(/debug/standby `loss_bound_hits`) — stays under 1000. A "
            "dead or partitioned successor stops acks, the bound grows "
            "with traffic, and this SLO burns until the standby leg "
            "heals or promotes.",
        ),
        SloSpec(
            id="shard-balance",
            sli="shard_imbalance_ratio",
            objective=0.99,
            threshold=1.5,
            comparator="gt",
            description="Mesh shard skew (max/mean across decisions, "
            "occupancy, resident frames) stays under 1.5x.",
        ),
    )


_SPEC_FIELDS = {f.name for f in SloSpec.__dataclass_fields__.values()}


def parse_slo_specs(text: str) -> tuple:
    """A JSON list of spec dicts (the JAX package's GUBER_SLO_SPECS). An
    entry whose id matches a built-in overrides it field by field (unset
    fields keep the built-in's values); a new id appends. Raises
    ValueError on malformed JSON or spec shape."""
    if not text or not text.strip():
        return default_specs()
    try:
        raw = json.loads(text)
    except ValueError as e:
        raise ValueError(f"not valid JSON ({e})") from None
    if not isinstance(raw, list):
        raise ValueError("must be a JSON LIST of spec objects")
    base = {s.id: s for s in default_specs()}
    order = list(base)
    for i, entry in enumerate(raw):
        if not isinstance(entry, dict) or "id" not in entry:
            raise ValueError(f"entry {i} must be an object with an 'id'")
        unknown = set(entry) - _SPEC_FIELDS
        if unknown:
            raise ValueError(f"entry {entry['id']!r} has unknown fields {sorted(unknown)}")
        for k in ("fast_windows", "slow_windows"):
            if k in entry:
                entry[k] = tuple(float(w) for w in entry[k])
        sid = entry["id"]
        if sid in base:
            base[sid] = SloSpec(**{**base[sid].__dict__, **entry})
        else:
            if "sli" not in entry or "objective" not in entry:
                raise ValueError(f"new SLO {sid!r} needs at least 'sli' and 'objective'")
            base[sid] = SloSpec(**entry)
            order.append(sid)
    specs = tuple(base[sid] for sid in order)
    for s in specs:
        s.validate()
    return specs


def _window_label(seconds: float) -> str:
    """Stable window label for the burn-rate gauge ('5m', '1h'); '<n>s'
    for a duration that is not a whole number of minutes."""
    s = float(seconds)
    if s % 3600 == 0:
        return f"{int(s // 3600)}h"
    if s % 60 == 0:
        return f"{int(s // 60)}m"
    return f"{s:g}s"


class SloObservatory:
    """Sampler thread and burn-rate evaluator for one node. The sampler
    reads only cached snapshots and host counters; evaluation is ring
    arithmetic. Both are safe from any thread at any cadence."""

    def __init__(self, svc, interval_s: float = 5.0, specs: Optional[tuple] = None,
                 watchdog=None):
        self.svc = svc
        self.interval_s = max(float(interval_s), 0.1)
        self.specs = tuple(specs) if specs is not None else default_specs()
        self.watchdog = watchdog
        # Ring capacity: the largest window any spec evaluates at this
        # cadence, bounded so that a very short interval cannot balloon.
        horizon = max(
            [self.interval_s]
            + [max(max(s.fast_windows), max(s.slow_windows), s.budget_window_s)
               for s in self.specs]
        )
        cap = int(min(max(math.ceil(horizon / self.interval_s) + 8, 720), 8640))
        self.rings = RingSet(cap)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._ticks = 0

    # -- sampling (no device work) -------------------------------------------

    def sample_once(self, now: Optional[float] = None) -> None:
        """One sampling pass. Each source is a host read: the engine's
        `cached_admission()` returns its cache or None (it never scans);
        histogram summaries are host dict walks; the pager's move counts
        and the watchdog table are plain attributes. An SLI whose source
        is absent pushes nothing: its windows read as empty, which the
        evaluator reports as data-less rather than healthy."""
        now = time.monotonic() if now is None else now
        svc = self.svc
        push = self.rings.push

        # Availability: the watchdog's view of the serving loops.
        wd = self.watchdog
        if wd is not None:
            push("serving_ok", 0.0 if wd.serving_stalled() else 1.0, now)

        eng = getattr(svc, "engine", None)
        limit_hits = None
        if eng is not None:
            if hasattr(eng, "cached_admission"):
                adm = eng.cached_admission()
                if adm is not None:
                    push("admission_excess_ratio", float(adm.get("excess_ratio", 0.0)), now)
                    limit_hits = float(adm.get("limit_hits", 0) or 0)
            em = getattr(eng, "metrics", None)
            if em is not None:
                fd = getattr(em, "flush_duration", None)
                if fd is not None:
                    push("flush_p99_s", float(fd.summary()["p99"]), now)
                ds = getattr(em, "device_sync", None)
                if ds is not None:
                    push("device_sync_p99_s", float(ds.summary()["p99"]), now)
            if hasattr(eng, "shard_stats"):
                ss = eng.shard_stats()
                if ss is not None and ss.get("imbalance_ratio") is not None:
                    push("shard_imbalance_ratio", float(ss["imbalance_ratio"]), now)
            pager = getattr(eng, "_pager", None)
            if pager is not None:
                # cumulative move counts; rate() makes them a churn series
                push("page_demotes", float(pager.demotes), now)
                push("page_promotes", float(pager.promotes), now)

        m = getattr(svc, "metrics", None)
        if m is not None and hasattr(m, "global_propagation_lag"):
            lag = m.global_propagation_lag.summary()
            if lag.get("count"):
                push("propagation_lag_p99_s", float(lag["p99"]), now)

        auditor = getattr(svc, "auditor", None)
        if auditor is not None:
            s = auditor.summary()
            adm = s.get("admission") or {}
            if "false_over_limit_keys" in adm:
                push("false_over_limit_keys", float(adm["false_over_limit_keys"]), now)
            push("divergence_total", float(sum((s.get("divergence") or {}).values())), now)
            push("max_staleness_ms", float(s.get("max_staleness_ms", 0)), now)

        lm = getattr(svc, "lease_mgr", None)
        if lm is not None:
            push("lease_outstanding_hits", float(lm.outstanding_hits()), now)

        sb = getattr(svc, "standby", None)
        if sb is not None:
            push("standby_loss_bound_hits", float(sb.loss_bound_hits()), now)

        # Admission debt: lease outstanding plus GLOBAL in-flight hits as
        # a fraction of the capacity the cached admission scan saw
        # admitted this window.
        gm = getattr(svc, "global_mgr", None)
        debt = 0.0
        have_debt = False
        if lm is not None:
            debt += float(lm.outstanding_hits())
            have_debt = True
        if gm is not None and hasattr(gm, "inflight_hits"):
            debt += float(gm.inflight_hits())
            have_debt = True
        if have_debt and limit_hits:
            push("admission_debt_ratio", debt / limit_hits, now)

        fwd = getattr(svc, "forwarder", None)
        if fwd is not None and hasattr(fwd, "breaker_summary"):
            summary = fwd.breaker_summary()
            if summary:
                open_n = sum(1 for st in summary.values() if st != "closed")
                push("breaker_open_fraction", open_n / len(summary), now)

        self._ticks += 1

    # -- evaluation ----------------------------------------------------------

    def evaluate_spec(self, spec: SloSpec, now: Optional[float] = None) -> dict:
        """Burn rates and alert state of one spec, from its ring."""
        now = time.monotonic() if now is None else now
        ring = self.rings.get(spec.sli)
        budget = 1.0 - spec.objective

        def burn(window_s: float) -> Optional[float]:
            if ring is None:
                return None
            frac = ring.bad_fraction(spec.is_bad, window_s, now)
            return None if frac is None else frac / budget

        windows = {}
        for w in (*spec.fast_windows, *spec.slow_windows, spec.budget_window_s):
            lbl = _window_label(w)
            if lbl not in windows:
                b = burn(w)
                windows[lbl] = None if b is None else round(b, 4)

        budget_burn = burn(spec.budget_window_s)
        remaining = None if budget_burn is None else round(max(1.0 - budget_burn, 0.0), 4)

        def pair_fires(pair, factor) -> bool:
            burns = [burn(w) for w in pair]
            return all(b is not None and b > factor for b in burns)

        if remaining is not None and remaining <= 0.0:
            state = "exhausted"
        elif pair_fires(spec.fast_windows, spec.fast_factor):
            state = "fast_burn"
        elif pair_fires(spec.slow_windows, spec.slow_factor):
            state = "slow_burn"
        else:
            state = "ok"
        last = None if ring is None else ring.last()
        return {
            "id": spec.id,
            "sli": spec.sli,
            "objective": spec.objective,
            "state": state,
            "state_value": STATES.index(state),
            "burn_rates": windows,
            "error_budget_remaining": remaining,
            "samples": 0 if ring is None else len(ring),
            "last": None if last is None else round(last[1], 6),
        }

    def evaluate(self, now: Optional[float] = None) -> list:
        now = time.monotonic() if now is None else now
        return [self.evaluate_spec(s, now) for s in self.specs]

    # -- exports -------------------------------------------------------------

    def debug_info(self) -> dict:
        """The /debug/slo payload: every SLO's evaluation, the rings'
        summaries, the watchdog's table and the worst budget."""
        evals = self.evaluate()
        out = {
            "v": 1,
            "sample_interval_s": self.interval_s,
            "ticks": self._ticks,
            "slos": evals,
            "slis": self.rings.snapshot(window_s=300.0),
        }
        if self.watchdog is not None:
            out["watchdog"] = self.watchdog.snapshot()
        remaining = [(e["error_budget_remaining"], e["id"]) for e in evals
                     if e["error_budget_remaining"] is not None]
        worst = min(remaining) if remaining else None
        out["budget"] = {
            "min_remaining": None if worst is None else worst[0],
            "worst_slo": None if worst is None else worst[1],
            "alerting": sorted(e["id"] for e in evals if e["state"] != "ok"),
        }
        return out

    def fleet_info(self) -> dict:
        """The compact per-SLO state and budget (no ring dumps)."""
        evals = self.evaluate()
        info = {
            "slos": {
                e["id"]: {"state": e["state"],
                          "error_budget_remaining": e["error_budget_remaining"]}
                for e in evals
            },
        }
        if self.watchdog is not None:
            info["serving_stalled"] = self.watchdog.serving_stalled()
            info["stalled_loops"] = self.watchdog.stalled_loops()
        return info

    def metrics_sync(self, m) -> None:
        """Scrape bridge: burn rates, budget remaining, alert state, and
        the watchdog's per-loop stall flags. Ring and dict arithmetic,
        no device work."""
        for e in self.evaluate():
            for lbl, b in e["burn_rates"].items():
                if b is not None:
                    m.slo_burn_rate.labels(e["id"], lbl).set(b)
            if e["error_budget_remaining"] is not None:
                m.slo_error_budget_remaining.labels(e["id"]).set(e["error_budget_remaining"])
            m.slo_alert_state.labels(e["id"]).set(e["state_value"])
        wd = self.watchdog
        if wd is not None:
            for name, row in wd.snapshot()["loops"].items():
                m.thread_stalled.labels(name).set(1 if row["stalled"] else 0)

    # -- lifecycle -----------------------------------------------------------

    def _loop(self) -> None:
        # the first beat up front: the loop is in the watchdog's table
        # from its start, not one interval later
        if self.watchdog is not None:
            self.watchdog.beat("slo-sampler", period_s=self.interval_s)
        while not self._stop.wait(self.interval_s):
            if self.watchdog is not None:
                self.watchdog.beat("slo-sampler", period_s=self.interval_s)
            try:
                self.sample_once()
            except Exception:
                # a broken source must not kill the sampler: the SLI it
                # feeds goes data-less, which debug_info shows
                log.exception("SLO sampling pass failed")

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="gubernator-torch-slo-sampler", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)
        if self.watchdog is not None:
            self.watchdog.unregister("slo-sampler")
