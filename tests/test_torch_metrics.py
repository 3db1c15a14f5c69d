"""The port's observability primitives against the JAX package's.

Each class of the port's `metrics.py`, `runtime/telemetry.py`,
`runtime/watchdog.py` and `service/admission.py` gets the same seeded
inputs (numpy `default_rng`) as its JAX counterpart, and their outputs
are compared exactly: rendered lines in both formats, summaries,
snapshots, the decision counters and ring. Wall-clock fields (a flight
record's `ts`, a ring entry's `ts_ms`, an exemplar's timestamp, a
summary's `_created`) are left out. Tolerance: none.

The exposition: a default `Metrics().render()` of each package parses
under prometheus_client's text parser into the same families, types and
sample names, and the port's OpenMetrics render parses under
prometheus_client's OpenMetrics parser (the JAX package's does not: its
bare counters and `_created` gauge families clash there; ROADMAP.md §3).
"""

import re
import types

import numpy as np
import pytest
from prometheus_client.openmetrics.parser import text_string_to_metric_families as om_parse
from prometheus_client.parser import text_string_to_metric_families as text_parse

from gubernator_tpu import metrics as jm
from gubernator_tpu.api.types import RateLimitResp as JResp
from gubernator_tpu.runtime import telemetry as jtel
from gubernator_tpu.runtime import watchdog as jwd
from gubernator_tpu.service import admission as jadm
from gubernator_tpu_torch import metrics as pm
from gubernator_tpu_torch.api.types import RateLimitResp
from gubernator_tpu_torch.runtime import telemetry as ptel
from gubernator_tpu_torch.runtime import watchdog as pwd
from gubernator_tpu_torch.service import admission as padm

_EXEMPLAR_TS = re.compile(r'( # \{trace_id="[^"]*"\} \S+) \S+$')


def _no_ts(lines):
    """Rendered lines with an exemplar's wall-clock timestamp removed."""
    return [_EXEMPLAR_TS.sub(r"\1", line) for line in lines]


def _observations(seed, n=400):
    rng = np.random.default_rng(seed)
    vals = np.concatenate([
        rng.lognormal(-9.0, 2.5, n),          # seconds, 1e-7 .. 1e-1
        rng.integers(0, 5000, n // 4),         # counts
        [0.0, 1e-6, 2e-6, 3e-6, 1.0, 2.0, 2.0 ** 30, 1e12],  # bucket edges, +Inf
    ])
    labels = rng.choice(["object", "columnar", 'odd"label\\'], len(vals))
    tids = rng.choice(["", "", "", "abc123", "ffee"], len(vals))
    return vals.tolist(), labels.tolist(), tids.tolist()


@pytest.mark.parametrize("scale,n_buckets,labeled", [
    (1e-6, 24, True), (1.0, 12, False), (1 / 256, 10, False), (64.0, 26, True),
])
def test_log2_histogram_matches_jax(scale, n_buckets, labeled):
    """Same observations, labeled and not, with exemplars: equal lines
    in both formats, summary and per-label summaries."""
    lab = ("path",) if labeled else ()
    j = jm.Log2Histogram("h", "doc", scale=scale, n_buckets=n_buckets, labelnames=lab)
    p = pm.Log2Histogram("h", "doc", scale=scale, n_buckets=n_buckets, labelnames=lab)
    vals, labels, tids = _observations(int(n_buckets + scale * 7))
    for v, lbl, tid in zip(vals, labels, tids):
        for h in (j, p):
            (h.labels(lbl) if labeled else h).observe(v, tid)
    assert p.render_lines() == j.render_lines()
    assert _no_ts(p.render_lines(openmetrics=True)) == _no_ts(j.render_lines(openmetrics=True))
    assert p.summary() == j.summary()
    assert p.summary(qs=(0.5, 0.9, 0.999)) == j.summary(qs=(0.5, 0.9, 0.999))
    assert p.label_summaries() == j.label_summaries()
    assert p.sample_names() == j.sample_names()


def test_empty_histogram_and_bad_labels_match_jax():
    for mod in (jm, pm):
        h = mod.Log2Histogram("e", "doc", labelnames=("stage",))
        with pytest.raises(ValueError):
            h.labels("a", "b")
    j, p = jm.Log2Histogram("e", "doc"), pm.Log2Histogram("e", "doc")
    assert p.render_lines() == j.render_lines()
    assert p.summary() == j.summary()


@pytest.mark.parametrize("cls", ["CensusSnapshotHistogram", "AdmissionExcessHistogram"])
def test_snapshot_histograms_match_jax(cls):
    """Each update replaces the series: equal lines after every one."""
    rng = np.random.default_rng(5)
    j = getattr(jm, cls)("s", "doc")
    p = getattr(pm, cls)("s", "doc")
    assert p.render_lines() == j.render_lines()
    for _ in range(4):
        hist = rng.integers(0, 1000, 32).tolist()
        total = int(rng.integers(0, 10 ** 9))
        j.update(hist, total)
        p.update(hist, total)
        assert p.render_lines() == j.render_lines()
        assert p.render_lines(openmetrics=True) == j.render_lines(openmetrics=True)


@pytest.mark.parametrize("k", [0, 3, 16, 128])
def test_hotkey_sketch_matches_jax(k):
    """Skewed per-flush rows (some with names, some over limit) through
    the space-saving sketch at several k (evictions at small k): equal
    snapshots, rendered gauges and summaries; the resolver names keys
    whose strings never crossed an update."""
    rng = np.random.default_rng(k + 11)
    j = jm.HotKeySketch("gubernator_hotkey_hits", "doc", k=k)
    p = pm.HotKeySketch("gubernator_hotkey_hits", "doc", k=k)
    names = {}
    for s in (j, p):
        s.set_resolver(lambda hi, lo: names.get((hi, lo)))
    w = np.arange(1, 61, dtype=np.float64) ** -1.2
    for flush in range(30):
        rows = []
        for key in rng.choice(60, 25, p=w / w.sum()).tolist():
            hi, lo = int(key) * 7919 - 2 ** 40, -int(key)
            name = f'k"{key}' if rng.random() < 0.5 else None
            if key % 5 == 0:
                names[(hi, lo)] = f"resolved-{key}"
            rows.append(((hi, lo), int(rng.integers(0, 4)), int(rng.integers(0, 2)), name))
        j.update(rows)
        p.update(rows)
        if flush == 20:
            for s in (j, p):
                s.configure(max(k // 2, 0))
    assert p.snapshot() == j.snapshot()
    assert p.render_lines() == j.render_lines()
    assert p.summary() == j.summary()
    assert p.k == j.k


def test_flight_recorder_matches_jax():
    """Past its capacity: the same records, sequence numbers and last
    record, wall-clock `ts` left out."""
    j, p = jtel.FlightRecorder(capacity=16), ptel.FlightRecorder(capacity=16)
    rng = np.random.default_rng(3)
    for i in range(40):
        rec = dict(path=["object", "columnar"][i % 2], n=int(rng.integers(1, 1000)),
                   waves=int(rng.integers(1, 32)), widths=rng.integers(1, 64, 3).tolist())
        j.record(**rec)
        p.record(**rec)

    def strip(recs):
        return [{k: v for k, v in r.items() if k != "ts"} for r in recs]

    assert strip(p.snapshot()) == strip(j.snapshot())
    assert strip([p.last()]) == strip([j.last()])
    assert p.capacity == j.capacity == 16
    assert ptel.FlightRecorder().last() is None


def test_watchdog_matches_jax(monkeypatch):
    """The same beats at the same instants of a fake clock (the port's
    injected, the JAX module's `time` swapped for it): equal check
    results, stalled loops, serving_stalled and snapshots through a
    stall, a recovery and an unregister."""
    clock = types.SimpleNamespace(t=1000.0)
    monkeypatch.setattr(jwd, "time", types.SimpleNamespace(monotonic=lambda: clock.t))
    j = jwd.Watchdog(stall_ms=500)
    p = pwd.Watchdog(stall_ms=500, clock=lambda: clock.t)
    script = [
        ("beat", "engine-pump", True, 0.0), ("beat", "engine-complete", True, 0.0),
        ("beat", "page-demoter", False, 2.0), ("beat", "ici-sync", False, 0.1),
        ("adv", 0.3), ("check",), ("beat", "engine-pump", True, 0.0),
        ("adv", 0.35), ("check",),  # engine-complete stalls (0.65 s > 0.5)
        ("adv", 1.0), ("check",), ("beat", "engine-complete", True, 0.0), ("check",),
        ("adv", 2.0), ("check",), ("unregister", "ici-sync"), ("check",),
        ("beat", "engine-pump", True, 0.0), ("beat", "engine-complete", True, 0.0),
        ("check",),
    ]
    for step in script:
        if step[0] == "beat":
            for wd in (j, p):
                wd.beat(step[1], serving=step[2], period_s=step[3])
        elif step[0] == "adv":
            clock.t += step[1]
        elif step[0] == "unregister":
            for wd in (j, p):
                wd.unregister(step[1])
        else:
            assert p.check() == j.check()
        assert p.stalled_loops() == j.stalled_loops()
        assert p.serving_stalled() == j.serving_stalled()
        assert p.snapshot() == j.snapshot()
    assert p.check(now=clock.t + 100.0) == j.check(now=clock.t + 100.0)
    assert p.snapshot() == j.snapshot()
    assert p.serving_stalled() and p.stalled_loops() == ["engine-complete", "engine-pump",
                                                         "page-demoter"]


def test_watchdog_thread_beats_and_stops():
    """The monitor thread beats itself and evaluates; stop() joins it."""
    p = pwd.Watchdog(stall_ms=40)
    p.start()
    p.start()  # idempotent
    p.beat("engine-pump", serving=True)
    import time

    deadline = time.monotonic() + 5.0
    while "watchdog-monitor" not in p.beats() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert "watchdog-monitor" in p.beats()
    while not p.serving_stalled() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert p.serving_stalled()
    p.stop()
    assert p._thread is None


def _decisions(seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(300):
        kind = rng.choice(["obj", "obj", "col"])
        if kind == "obj":
            st = int(rng.integers(0, 2))
            err = "bad" if rng.random() < 0.05 else ""
            out.append(("obj", str(rng.choice(padm.PATHS)), st, int(rng.integers(0, 99)), err,
                        f"ns_k{int(rng.integers(0, 50))}", int(rng.integers(0, 40))))
        else:
            n = int(rng.integers(1, 20))
            statuses = rng.integers(0, 2, n)
            remaining = rng.integers(0, 100, n)
            mask = rng.random(n) < 0.7 if rng.random() < 0.5 else None
            out.append(("col", str(rng.choice(["fastpath", "replica"])), statuses, remaining,
                        mask, int(rng.integers(0, 9))))
    return out


def test_decision_recorder_matches_jax():
    """Object and columnar decisions into both recorders (a ring
    smaller than the stream): equal counts, ring contents (wall-clock
    `ts_ms` left out) and rendered decision / over-limit counters."""
    jmet, pmet = jm.Metrics(), pm.Metrics()
    jr = jadm.DecisionRecorder(jmet, ring_size=64)
    pr = padm.DecisionRecorder(pmet, ring_size=64)
    for d in _decisions(9):
        if d[0] == "obj":
            _k, path, st, rem, err, key, stale = d
            jr.record_decision(path, JResp(status=st, remaining=rem, error=err), key=key,
                               staleness_ms=stale)
            pr.record_decision(path, RateLimitResp(status=st, remaining=rem, error=err), key=key,
                               staleness_ms=stale)
        else:
            _k, path, statuses, remaining, mask, stale = d
            for rec in (jr, pr):
                rec.record_columnar(path, statuses, remaining, mask=mask, staleness_ms=stale,
                                    sample_key=lambda j: f"ns_col{j}")
    js, ps = jr.snapshot(), pr.snapshot()
    for s in (js, ps):
        for e in s["ring"]:
            e.pop("ts_ms")
    assert ps == js
    assert len(ps["ring"]) == 64

    def lines(m, name):
        return [ln for ln in m.render().decode().splitlines() if ln.startswith(name)]

    for name in ("gubernator_admission_decisions", "gubernator_over_limit_counter"):
        assert lines(pmet, name) == lines(jmet, name)


def test_stamp_and_status_label_match_jax():
    for st, err in ((0, ""), (1, ""), (1, "boom")):
        j, p = JResp(status=st, error=err), RateLimitResp(status=st, error=err)
        assert padm.status_label(p) == jadm.status_label(j)
        for stale in (None, 0, -4, 17):
            jadm.stamp_decision(j, "replica", stale)
            padm.stamp_decision(p, "replica", stale)
            assert p.metadata == j.metadata
    assert padm.PATHS == jadm.PATHS
    assert padm.current_trace_id() == ""


def test_catalog_names_match_jax():
    assert pm.catalog_names() == jm.catalog_names()
    assert pm.OPENMETRICS_CONTENT_TYPE == jm.OPENMETRICS_CONTENT_TYPE


def _feed(m):
    """The same few updates to either package's Metrics."""
    m.func_duration.labels("V1Instance.GetRateLimits").observe(0.25)
    m.circuit_state.labels('peer"1').set(2)
    m.concurrent_checks.inc()
    m.getratelimit_counter.labels("local").inc(3)
    m.admission_decisions.labels("owner", "over_limit").inc()
    m.table_slot_age_seconds.update(list(range(32)), 12345)
    m.global_sync_leg_duration.labels("owner_apply").observe(0.002, "t1")


def _families(text):
    return {(f.name, f.type): sorted({s.name for s in f.samples}) for f in text_parse(text)}


def test_default_render_parses_to_the_same_families():
    """A default Metrics and one after the same updates, each rendered
    by both packages: equal families, types and sample names under
    prometheus_client's text parser; the plain text equal line for line
    but the HELP of the backend families and the _created values."""
    for fed in (False, True):
        j, p = jm.Metrics(), pm.Metrics()
        if fed:
            _feed(j)
            _feed(p)
        jt, pt = j.render().decode(), p.render().decode()
        assert _families(pt) == _families(jt)
        mask = re.compile(r"_created(\{[^}]*\})? \S+$")
        ours = [mask.sub(r"_created\1", ln) for ln in pt.splitlines()]
        theirs = [mask.sub(r"_created\1", ln) for ln in jt.splitlines()]
        diff = [(a, b) for a, b in zip(ours, theirs) if a != b]
        assert len(ours) == len(theirs)
        assert all(a.startswith("# HELP ") and a.split()[2] == b.split()[2] for a, b in diff)
        assert {a.split()[2] for a, _ in diff} <= {
            "gubernator_engine_cold_compile_count", "gubernator_device_unattributed_bytes",
            "gubernator_kernel_backend", "gubernator_pallas_block_lanes"}


def test_openmetrics_render_parses():
    """The port's OpenMetrics render (exemplars on) parses under the
    OpenMetrics parser, ends `# EOF`, and holds the text render's
    families: a bare counter's samples gain `_total`, a summary's
    `_created` stays in its family."""
    p = pm.Metrics()
    _feed(p)
    body, ctype = p.render_negotiated("application/openmetrics-text; version=1.0.0")
    assert ctype == pm.OPENMETRICS_CONTENT_TYPE
    text = body.decode()
    assert text.endswith("# EOF\n")
    assert '# {trace_id="t1"}' in text
    fams = {f.name: f for f in om_parse(text)}
    plain = {name for name, typ in _families(p.render().decode()) if not name.endswith("_created")}
    assert set(fams) == plain
    assert {s.name for s in fams["gubernator_getratelimit_counter"].samples} == {
        "gubernator_getratelimit_counter_total"}
    assert fams["gubernator_func_duration"].type == "summary"
    plain_body, plain_type = p.render_negotiated("text/plain")
    assert plain_type == pm.CONTENT_TYPE_LATEST and b"trace_id" not in plain_body


def test_registry_refuses_duplicate_sample_names():
    p = pm.Metrics()
    with pytest.raises(ValueError):
        p.bare_counter("gubernator_getratelimit_counter", "again")
    with pytest.raises(ValueError):
        p.register_renderable(pm.Log2Histogram("gubernator_func_duration_count", "clash"))
    with pytest.raises(ValueError):
        pm.Gauge("gubernator_cache_size", "again", registry=p.registry)


def test_sync_callback_failure_is_logged_once_and_others_run(caplog):
    """A failing bridge is logged on its first failure (and every
    1000th), and does not stop the callbacks after it."""
    p = pm.Metrics()
    seen = []

    def broken(_m):
        raise RuntimeError("bridge down")

    p.add_sync(broken)
    p.add_sync(lambda m: seen.append(m))
    with caplog.at_level("ERROR", logger="gubernator_tpu_torch.metrics"):
        for _ in range(3):
            p.render()
    assert len(seen) == 3 and seen[0] is p
    assert sum("bridge" in r.getMessage() or "failed" in r.getMessage()
               for r in caplog.records) == 1
