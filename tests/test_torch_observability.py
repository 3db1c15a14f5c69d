"""The port's serving-path telemetry against the JAX package's.

Both packages serve the same seeded calls (`test_torch_engine.make_calls`:
Zipf keys, token and leaky, Gregorian and invalid items, a key hotter
than the wave cap) through their V1Service, each with a Metrics wired
to its engine (`wire_engine_telemetry`, as the JAX daemon's composition
root does), one call (one bulk) at a time so that the flush structure
is deterministic: over fused and narrow, DeviceEngine flat and paged,
IciEngine with and without GLOBAL items, and over wire bytes through
the columnar edge (the JAX side with `fast_edge = True`). Compared
exactly, from each package's rendered `/metrics` text: the counters
(`getratelimit_counter{calltype}`, `over_limit_counter` bare and by
path, `cache_access_count{type}`, `unexpired_evictions_count`,
`command_counter`, `check_error_counter`, `admission_decisions`), the
bucket counts of `flush_waves`, `batch_width{path}` and
`ici_tick_groups`, and the `_count` of every `stage_duration{stage}`,
`flush_duration{path}` and `device_sync_duration{path}`; then
`hotkeys_snapshot()`, `shard_stats()["decisions"]`, the decision
recorder, `device_memory()` and the flight recorder's flushes. Time-
valued sums are not compared. With `stage_metadata` every answer
carries the JAX package's stage names in its order and its
`decision_path` stamps, and the answers equal a run with it off.
Tolerance: none.

The JAX IciEngines are built once per module (about 6 s each) and
emptied, with fresh telemetry, before each test.
"""

import asyncio

import jax
import numpy as np
import pytest
from prometheus_client.parser import text_string_to_metric_families as text_parse

from gubernator_tpu.api.types import RateLimitReq as JReq
from gubernator_tpu.metrics import Metrics as JMetrics
from gubernator_tpu.metrics import wire_engine_telemetry as jwire_telemetry
from gubernator_tpu.parallel import ici as jici
from gubernator_tpu.runtime.engine import DeviceEngine as JEngine
from gubernator_tpu.runtime.engine import EngineConfig as JConfig
from gubernator_tpu.runtime.engine import EngineMetrics as JEngineMetrics
from gubernator_tpu.runtime.ici_engine import IciEngine as JIciEngine
from gubernator_tpu.runtime.ici_engine import IciEngineConfig as JIciConfig
from gubernator_tpu.service.grpc_service import serve_get_rate_limits_bytes as jserve
from gubernator_tpu.service.server import V1Service as JService
from gubernator_tpu_torch.api.types import RateLimitReq
from gubernator_tpu_torch.metrics import Metrics, wire_engine_telemetry
from gubernator_tpu_torch.runtime.engine import DeviceEngine, EngineConfig
from gubernator_tpu_torch.runtime.ici_engine import IciEngine, IciEngineConfig
from gubernator_tpu_torch.runtime.watchdog import Watchdog
from gubernator_tpu_torch.service.server import V1Service, serve_get_rate_limits_bytes
from test_torch_edge import to_bytes
from test_torch_engine import Clock, _resp_tuple, make_calls

NDEV = 8
GLOBAL = 2
FLAT = dict(num_groups=256, batch_size=64, batch_wait_s=0.002)
# 16 logical pages of 16 groups, 8 frames: a wave of 8 lanes touches at
# most 8 pages, so the calls page in and out without a budget error
PAGED = dict(num_groups=256, batch_size=8, batch_wait_s=0.002, page_groups=16,
             page_budget=8, page_demote_interval_s=0)
ICI = dict(num_groups=64, ways=4, num_slots=256, replica_ways=4, batch_size=32,
           batch_wait_s=0.001, sync_wait_s=3600.0)

COUNTERS = (
    "gubernator_getratelimit_counter", "gubernator_over_limit_counter",
    "gubernator_cache_access_count", "gubernator_unexpired_evictions_count",
    "gubernator_command_counter", "gubernator_check_error_counter",
    "gubernator_admission_decisions",
)
BUCKETS = ("gubernator_engine_flush_waves", "gubernator_engine_batch_width",
           "gubernator_ici_tick_groups")
COUNTS = ("gubernator_engine_stage_duration", "gubernator_engine_flush_duration",
          "gubernator_engine_device_sync_duration", "gubernator_engine_queue_wait_duration",
          "gubernator_collective_tick_duration", "gubernator_ici_tick_duration",
          "gubernator_func_duration")


def samples(metrics) -> dict:
    """{(sample name, sorted labels): value} of the compared families,
    from the rendered text."""
    out = {}
    for fam in text_parse(metrics.render().decode()):
        for s in fam.samples:
            keep = (
                (fam.name in COUNTERS and s.name == fam.name)
                or (fam.name in BUCKETS and s.name.endswith("_bucket"))
                or (fam.name in COUNTS and s.name.endswith("_count"))
            )
            if keep:
                out[(s.name, tuple(sorted(s.labels.items())))] = s.value
    return out


def assert_telemetry_equal(psvc, jsvc, peng, jeng, *, names=True):
    ps, js = samples(psvc.metrics), samples(jsvc.metrics)
    assert ps == js, {k: (ps.get(k), js.get(k)) for k in set(ps) | set(js)
                      if ps.get(k) != js.get(k)}
    ph, jh = peng.hotkeys_snapshot(), jeng.hotkeys_snapshot()
    if not names:  # the JAX IciEngine's columnar path records no key strings
        for snap in (ph, jh):
            for e in snap["entries"]:
                e.pop("key")
    assert ph == jh
    pr, jr = psvc.recorder.snapshot(), jsvc.recorder.snapshot()
    assert pr["decisions"] == jr["decisions"]
    assert [{k: v for k, v in e.items() if k != "ts_ms"} for e in pr["ring"]] == \
        [{k: v for k, v in e.items() if k != "ts_ms"} for e in jr["ring"]]
    if peng.topo.n_dev > 1:
        assert peng.shard_stats()["decisions"] == jeng.shard_stats()["decisions"]
    else:
        assert peng.shard_stats() is None and jeng.shard_stats() is None
    assert peng.device_memory() == jeng.device_memory()

    def flushes(eng, empty_wave=0):
        return [(r["path"], r["n"], r["waves"] or empty_wave, r["carry"]) if "n" in r
                else (r["path"], r["groups"], r["backlog"], r["overflow_keys"])
                for r in eng.metrics.recorder.snapshot()]

    # A flush whose every item failed to encode: the JAX engine runs one
    # wave of padding lanes, the port none (ROADMAP.md §3).
    assert flushes(peng, empty_wave=1) == flushes(jeng)
    st, em = peng.stats(), peng.metrics
    assert em.cache_hits == st["cache_hits"] and em.over_limit == st["over_limit"]
    assert em.batches == st["flushes"] + st["columnar_flushes"]


def services(peng, jeng, clock, **kw):
    """Both V1Services, each with a Metrics wired to its engine."""
    psvc = V1Service(peng, now_fn=clock, metrics=Metrics(), **kw)
    wire_engine_telemetry(psvc.metrics, peng)
    jmet = JMetrics()
    jwire_telemetry(jmet, jeng)
    jsvc = JService(jeng, metrics=jmet, now_fn=clock, **kw)
    return psvc, jsvc


def serve_objects(psvc, jsvc, clock, calls, advance=(0, 7, 900, 31_000)):
    for c, items in enumerate(calls):
        jr = asyncio.run(jsvc.get_rate_limits([JReq(**kw) for kw in items]))
        pr = asyncio.run(psvc.get_rate_limits([RateLimitReq(**kw) for kw in items]))
        for i, (a, b) in enumerate(zip(jr, pr)):
            assert _resp_tuple(b) == _resp_tuple(a), (c, i, items[i])
        clock.ms += advance[c % len(advance)]


def edge_calls(seed, n_calls, n_items):
    """`make_calls` without the items that send a whole call to the
    object path: invalid ones, and in all calls but the last the key
    hotter than the wave cap (the edge declines that call). Gregorian
    items splice."""
    calls = make_calls(seed, n_calls, n_items)
    return [[kw for kw in items if kw["name"] and (c == len(calls) - 1 or kw["unique_key"] != "hot")]
            for c, items in enumerate(calls)]


def serve_bytes(psvc, jsvc, clock, calls):
    for c, items in enumerate(calls):
        data = to_bytes([JReq(**kw) for kw in items])
        assert asyncio.run(serve_get_rate_limits_bytes(psvc, data)) == \
            asyncio.run(jserve(jsvc, data)), c
        clock.ms += (0, 7, 900, 31_000)[c % 4]


@pytest.mark.parametrize("layout", ["fused", "narrow"])
@pytest.mark.parametrize("paged", [False, True], ids=["flat", "paged"])
def test_device_engine_telemetry_matches_jax(layout, paged):
    """The object path, then wire bytes through the edge, on a
    DeviceEngine: equal answers, bytes and telemetry."""
    clock = Clock()
    cfg = dict(PAGED if paged else FLAT, layout=layout)
    peng = DeviceEngine(EngineConfig(device="cpu", **cfg), now_fn=clock)
    jeng = JEngine(JConfig(**cfg), now_fn=clock)
    try:
        psvc, jsvc = services(peng, jeng, clock)
        jsvc.fast_edge = True
        n_items = 60 if paged else 120
        serve_objects(psvc, jsvc, clock, make_calls(31 + paged, 4, n_items))
        assert_telemetry_equal(psvc, jsvc, peng, jeng)
        # paged: calls small enough that the edge's first wave fits B = 8
        serve_bytes(psvc, jsvc, clock, edge_calls(41 + paged, 4, 6 if paged else n_items))
        assert_telemetry_equal(psvc, jsvc, peng, jeng)
        st = peng.stats()
        assert st["columnar_flushes"] > 0 and st["flushes"] > 0
        if paged:
            assert st["promotes"] > 0 and st["demotes"] > 0
    finally:
        peng.close()
        jeng.close()


_JAX = {}


@pytest.fixture(scope="module")
def jax_ici():
    """The module's JAX IciEngine, built on first use, closed at the end."""
    yield _JAX
    for eng, _clock, _empty in _JAX.values():
        eng.close()
    _JAX.clear()


def ici_pair(jax_ici, layout):
    """A fresh port IciEngine and the module's JAX IciEngine of the same
    layout, emptied (table, replica tier, cursor, sync counters), with
    fresh telemetry (EngineMetrics, shard counts), at NOW."""
    cfg = dict(ICI, layout=layout)
    if layout not in jax_ici:
        clock = Clock()
        jeng = JIciEngine(JIciConfig(devices=jax.devices()[:NDEV], **cfg), now_fn=clock)
        jax_ici[layout] = (jeng, clock, jeng.snapshot())
    jeng, clock, empty = jax_ici[layout]
    clock.ms = Clock().ms
    jeng.restore(empty)
    jeng.ici_state = jici.create_ici_state(jeng.mesh, cfg["num_slots"], cfg["replica_ways"],
                                           layout=layout)
    jeng._home_rr = 0
    jeng._capped_ticks = 0
    jeng.overflow_keys = jeng.overflow_drops = jeng.sync_backlog = jeng.full_ticks = 0
    jeng.metrics = JEngineMetrics()
    jeng.metrics.hotkeys.configure(jeng.cfg.hotkeys_k)
    jeng.metrics.hotkeys.set_resolver(jeng.key_string)
    jeng._shard_decisions[:] = 0
    jeng._snapshot_staging_bytes = 0
    jeng._key_strings.clear()
    peng = IciEngine(IciEngineConfig(devices=["cpu"] * NDEV, **cfg), now_fn=clock)
    return peng, jeng, clock


@pytest.mark.parametrize("layout,share", [("fused", 0.0), ("narrow", 0.5)])
def test_ici_engine_telemetry_matches_jax(jax_ici, layout, share):
    """IciEngine with no GLOBAL items and with half of them GLOBAL: the
    object path with sync ticks between calls, then wire bytes through
    the edge (GLOBAL columns go to the replica tier): equal answers,
    bytes and telemetry, tick histograms and shard decisions included."""
    peng, jeng, clock = ici_pair(jax_ici, layout)
    try:
        psvc, jsvc = services(peng, jeng, clock)
        jsvc.fast_edge = True
        rng = np.random.default_rng(50)
        calls = make_calls(51, 4, 60)
        for items in calls:
            for it in items:
                if rng.random() < share:
                    it["behavior"] = it.get("behavior", 0) | GLOBAL
        for c, items in enumerate(calls):
            serve_objects(psvc, jsvc, clock, [items])
            if c % 2:
                peng.sync_now()
                jeng.sync_now()
        assert_telemetry_equal(psvc, jsvc, peng, jeng)
        bcalls = [[kw for kw in items if kw["name"] and kw["unique_key"] != "hot"]
                  for items in calls]
        serve_bytes(psvc, jsvc, clock, bcalls)
        peng.sync_now()
        jeng.sync_now()
        assert_telemetry_equal(psvc, jsvc, peng, jeng, names=False)
        assert peng.stats()["columnar_flushes"] > 0
        assert sum(peng.shard_stats()["decisions"]) > 0
    finally:
        peng.close()


@pytest.mark.parametrize("engine", ["device", "ici"])
def test_stage_metadata_matches_jax(jax_ici, engine):
    """With stage_metadata every answer carries stage_breakdown_us with
    the JAX package's stage names in its order and the same
    decision_path stamps; the edge stands aside (bytes take the object
    path); the answers equal a port run with it off."""
    if engine == "device":
        clock = Clock()
        peng = DeviceEngine(EngineConfig(device="cpu", stage_metadata=True, **FLAT),
                            now_fn=clock)
        jeng = JEngine(JConfig(stage_metadata=True, **FLAT), now_fn=clock)
        off = DeviceEngine(EngineConfig(device="cpu", **FLAT), now_fn=clock)
    else:
        peng, jeng, clock = ici_pair(jax_ici, "fused")
        jeng.cfg.stage_metadata = True
        jeng._stage_md = True
        peng.close()
        peng = IciEngine(IciEngineConfig(devices=["cpu"] * NDEV, stage_metadata=True, **ICI),
                         now_fn=clock)
        off = IciEngine(IciEngineConfig(devices=["cpu"] * NDEV, **ICI), now_fn=clock)
    try:
        psvc, jsvc = services(peng, jeng, clock)
        osvc = V1Service(off, now_fn=clock)
        jsvc.fast_edge = True
        for c, items in enumerate(make_calls(61, 3, 80)):
            jr = asyncio.run(jsvc.get_rate_limits([JReq(**kw) for kw in items]))
            pr = asyncio.run(psvc.get_rate_limits([RateLimitReq(**kw) for kw in items]))
            orr = asyncio.run(osvc.get_rate_limits([RateLimitReq(**kw) for kw in items]))
            for i, (a, b, o) in enumerate(zip(jr, pr, orr)):
                assert _resp_tuple(b)[:5] == _resp_tuple(a)[:5] == _resp_tuple(o)[:5], (c, i)
                assert set(b.metadata) == set(a.metadata), (c, i)
                assert o.metadata == {}
                for k in b.metadata:
                    if k == "stage_breakdown_us":
                        stages = [p.split("=")[0] for p in b.metadata[k].split(",")]
                        assert stages == [p.split("=")[0] for p in a.metadata[k].split(",")]
                        assert all(int(p.split("=")[1]) >= 0 for p in b.metadata[k].split(","))
                    else:
                        assert b.metadata[k] == a.metadata[k], (c, i, k)
            assert any("stage_breakdown_us" in r.metadata for r in pr)
            clock.ms += 250
        data = to_bytes([JReq(**kw) for kw in edge_calls(62, 1, 40)[0]])
        asyncio.run(serve_get_rate_limits_bytes(psvc, data))
        asyncio.run(jserve(jsvc, data))
        assert peng.stats()["columnar_flushes"] == 0
        assert samples(psvc.metrics) == samples(jsvc.metrics)
    finally:
        peng.close()
        off.close()
        if engine == "device":
            jeng.close()
        else:
            jeng.cfg.stage_metadata = False
            jeng._stage_md = False


@pytest.mark.parametrize("depth", [1, 2])
def test_flush_of_encode_errors_only_answers(depth):
    """A call whose only item fails to encode (a Gregorian weeks
    duration) makes a flush with no wave: its bulk resolves with the
    JAX package's error at both pipeline depths (at depth 2 it hung:
    no ticket reached the completion thread, which sweeps the bulks),
    and the flush is counted with no wave and no launch."""
    clock = Clock()
    peng = DeviceEngine(EngineConfig(device="cpu", pipeline_depth=depth, **FLAT), now_fn=clock)
    jeng = JEngine(JConfig(pipeline_depth=depth, **FLAT), now_fn=clock)
    try:
        psvc, jsvc = services(peng, jeng, clock)
        item = dict(name="rl", unique_key="weeks", hits=1, behavior=4, duration=3, limit=5)
        for _ in range(2):
            pr = peng.check_bulk([RateLimitReq(**item)]).result(timeout=30)
            jr = jeng.check_bulk([JReq(**item)]).result(timeout=30)
            assert [_resp_tuple(r) for r in pr] == [_resp_tuple(r) for r in jr]
            assert pr[0].error
            serve_objects(psvc, jsvc, clock, [[item]])
        st = peng.stats()
        assert st["flushes"] == 4 and st["waves"] == 0 and st["requests"] == 0
        assert samples(psvc.metrics) == samples(jsvc.metrics)
        assert [r["waves"] for r in peng.metrics.recorder.snapshot()] == [0] * 4
        assert [r["waves"] for r in jeng.metrics.recorder.snapshot()] == [1] * 4
    finally:
        peng.close()
        jeng.close()


def test_engine_loops_beat_the_watchdog():
    """A Watchdog set on an engine hears the pump, the completion
    thread, the demoter and the GLOBAL sync thread; none stalls while
    they run, and a loop that stops beating is flagged."""
    clock = Clock()
    wd = Watchdog(stall_ms=60_000)
    eng = DeviceEngine(EngineConfig(device="cpu", **dict(PAGED, page_demote_interval_s=0.05)),
                       now_fn=clock)
    ici = IciEngine(IciEngineConfig(devices=["cpu"] * NDEV, **dict(ICI, sync_wait_s=0.02)),
                    now_fn=clock)
    try:
        eng.watchdog = wd
        ici.watchdog = wd
        eng.check_batch([RateLimitReq(name="n", unique_key="k", hits=1, limit=5,
                                      duration=60_000)])
        import time

        want = {"engine-pump", "engine-complete", "page-demoter", "ici-sync"}
        deadline = time.monotonic() + 10.0
        while not want <= set(wd.beats()) and time.monotonic() < deadline:
            time.sleep(0.02)
        assert want <= set(wd.beats())
        assert wd.check() and not wd.serving_stalled() and wd.stalled_loops() == []
        snap = wd.snapshot()
        assert snap["loops"]["engine-pump"]["serving"] is True
        assert snap["loops"]["page-demoter"]["deadline_ms"] > snap["stall_ms"]
        wd.beat("engine-pump", serving=True)
        assert wd.check(now=time.monotonic() + 3600.0)["engine-pump"]
        assert wd.serving_stalled()
    finally:
        eng.close()
        ici.close()


def test_debug_snapshot_and_admission_views():
    """debug_snapshot's counters, histograms and flight recorder match
    the JAX engine's shape; admission_debug_info and device_debug_info
    carry the recorder's counts and the memory snapshot."""
    clock = Clock()
    peng = DeviceEngine(EngineConfig(device="cpu", **FLAT), now_fn=clock)
    jeng = JEngine(JConfig(**FLAT), now_fn=clock)
    try:
        psvc, jsvc = services(peng, jeng, clock)
        serve_objects(psvc, jsvc, clock, make_calls(71, 2, 50))
        pd, jd = peng.debug_snapshot(), jeng.debug_snapshot()
        assert set(pd) == set(jd)
        assert pd["counters"] == jd["counters"]
        assert set(pd["histograms"]) == set(jd["histograms"])
        assert pd["kernel_backend"] == "torch" and pd["pallas_block"] == 0
        assert pd["occupancy"] == jd["occupancy"]
        pa, ja = psvc.admission_debug_info(), jsvc.admission_debug_info()
        assert pa["decisions"] == ja["decisions"] and pa["bound"] == ja["bound"]
        assert pa["window"]["excess_hits"] == ja["window"]["excess_hits"]
        assert "ring" not in psvc.admission_debug_info(include_ring=False)
        dev = psvc.device_debug_info()
        assert dev["memory"] == jsvc.device_debug_info()["memory"]
        assert "transfers" not in dev and dev["compile"]["compiles"] == 0
        assert peng.queue_depth() == 0 and peng.live_count() == jeng.live_count()
        peng.snapshot()
        jeng.snapshot()
        assert peng.device_memory() == jeng.device_memory()
    finally:
        peng.close()
        jeng.close()
