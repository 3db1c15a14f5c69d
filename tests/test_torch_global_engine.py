"""The port's IciEngine with its GLOBAL replica tier against the JAX
package's IciEngine.

Both engines run 8 shards (the port's on `cpu`, JAX's on the 8 host
devices of tests/conftest.py) with a sharded table and a replica tier of
8 replicas, their sync threads parked (`sync_wait_s` 3600) and ticked by
hand (`sync_now()`) at the same points under one fake clock. Compared
after the same traffic: every answer, the sharded snapshot, the replica
stack, `pending`, `tick`, and the sync counters (overflow_keys,
overflow_drops, sync_backlog, full_ticks); over the object path
(V1Service, GLOBAL-only with force_global and mixed calls), over
`check_columns`, and over wire bytes (`serve_get_rate_limits_bytes`,
the JAX side with `fast_edge = True`); with `inject_globals`; and the
replica tier of `table_census` / `admission_snapshot`. The JAX engine of
each configuration is built once per module (about 6 s each) and reset
before each test. Tolerance: none.

Known difference: the JAX IciEngine's columnar path does not record key
strings (its replica split predates the key dictionary); the port's
records them as on every engine, so the edge comparisons leave
`key_strings` out.
"""

import asyncio
import threading
import time

import jax
import numpy as np
import pytest
import torch

from gubernator_tpu import wire as jwire
from gubernator_tpu.api.types import RateLimitReq as JReq
from gubernator_tpu.api.types import RateLimitResp as JResp
from gubernator_tpu.api.types import UpdatePeerGlobal as JGlobal
from gubernator_tpu.parallel import ici as jici
from gubernator_tpu.runtime.ici_engine import IciEngine as JIciEngine
from gubernator_tpu.runtime.ici_engine import IciEngineConfig as JIciConfig
from gubernator_tpu.service.grpc_service import serve_get_rate_limits_bytes as jserve
from gubernator_tpu.service.server import V1Service as JService
from gubernator_tpu_torch import wire
from gubernator_tpu_torch.api.types import RateLimitReq, RateLimitResp, UpdatePeerGlobal
from gubernator_tpu_torch.ops.layout import RequestBatch
from gubernator_tpu_torch.runtime.engine import TableCommittedError
from gubernator_tpu_torch.runtime.ici_engine import IciEngine, IciEngineConfig
from gubernator_tpu_torch.service.server import V1Service, serve_get_rate_limits_bytes
from test_torch_edge import to_bytes
from test_torch_engine import Clock, _resp_tuple, assert_snapshots_equal, make_calls

NDEV = 8
GLOBAL = 2
BASE = dict(num_groups=64, ways=4, num_slots=256, replica_ways=4, batch_size=32,
            batch_wait_s=0.001, sync_wait_s=3600.0)
# The capped cases of tests/test_ici_overflow.py:182-253 (32 replica
# slots in 8 groups, one group per tick) and tests/test_ici_backstop.py:
# 89-143 (a full tick every 3 capped ticks), on one configuration.
CAPPED = dict(num_groups=64, ways=2, num_slots=32, replica_ways=4, batch_size=128,
              batch_wait_s=0.001, sync_wait_s=3600.0, max_sync_groups=1, full_tick_every=3)

_JAX = {}


@pytest.fixture(scope="module")
def jax_engines():
    """name -> (JAX IciEngine, its clock, its empty snapshot), built on
    first use, closed at the module's end."""
    yield _JAX
    for eng, _clock, _empty in _JAX.values():
        eng.close()
    _JAX.clear()


def pair(jax_engines, name, cfg):
    """(port engine, JAX engine, clock): a fresh port IciEngine and the
    module's JAX IciEngine of configuration `cfg`, emptied (sharded
    table, replica tier, home cursor, sync counters), at NOW."""
    if name not in jax_engines:
        clock = Clock()
        jeng = JIciEngine(JIciConfig(devices=jax.devices()[:NDEV], **cfg), now_fn=clock)
        jax_engines[name] = (jeng, clock, jeng.snapshot())
    jeng, clock, empty = jax_engines[name]
    clock.ms = Clock().ms
    jeng.restore(empty)
    jeng.ici_state = jici.create_ici_state(jeng.mesh, cfg["num_slots"], cfg["replica_ways"],
                                           layout=jeng.cfg.layout)
    jeng._home_rr = 0
    jeng._capped_ticks = 0
    jeng.overflow_keys = jeng.overflow_drops = jeng.sync_backlog = jeng.full_ticks = 0
    peng = IciEngine(IciEngineConfig(devices=["cpu"] * NDEV, **cfg), now_fn=clock)
    return peng, jeng, clock


COUNTERS = ("overflow_keys", "overflow_drops", "sync_backlog", "full_ticks")


def assert_same(peng, jeng, tag, key_strings=True):
    """Replica stack, pending, tick, sync counters and the sharded
    snapshot equal."""
    ps, js = peng.ici_state, jeng.ici_state
    for name, a, r in (("table", ps.table.data, js.table.data), ("pending", ps.pending, js.pending),
                       ("tick", ps.tick, js.tick)):
        a, r = a.numpy(), np.asarray(r)
        assert a.dtype == r.dtype and np.array_equal(a, r), (tag, name, np.argwhere(a != r)[:4])
    assert [getattr(peng, c) for c in COUNTERS] == [getattr(jeng, c) for c in COUNTERS], tag
    assert {c: peng.stats()[c] for c in COUNTERS} == {c: getattr(jeng, c) for c in COUNTERS}
    psnap, jsnap = peng.snapshot(), jeng.snapshot()
    if not key_strings:
        psnap.pop("key_strings")
        jsnap.pop("key_strings")
    assert_snapshots_equal(jsnap, psnap)


def tick_both(peng, jeng, tag, key_strings=True):
    peng.sync_now()
    jeng.sync_now()
    assert_same(peng, jeng, tag, key_strings)


def global_calls(seed, n_calls, share, n_items=60):
    """`make_calls` (Zipf keys, Gregorian and invalid items, a key
    hotter than max_waves) with a `share` of the items GLOBAL."""
    rng = np.random.default_rng(seed + 1000)
    calls = make_calls(seed, n_calls, n_items)
    for items in calls:
        for it in items:
            if rng.random() < share:
                it["behavior"] = it.get("behavior", 0) | GLOBAL
    return calls


@pytest.mark.parametrize("force_global,share", [(True, 0.0), (False, 0.5)])
def test_v1service_global_matches_jax(jax_engines, force_global, share):
    """GLOBAL-only calls (force_global) and mixed calls, one flush
    feeding both tiers, with ticks between calls: equal answers and
    states after every tick, replicas exercised (pending deltas, several
    homes per hot key)."""
    peng, jeng, clock = pair(jax_engines, "base", BASE)
    psvc = V1Service(peng, now_fn=clock, force_global=force_global)
    jsvc = JService(jeng, now_fn=clock, force_global=force_global)
    try:
        for c, items in enumerate(global_calls(7, 6, share)):
            jr = asyncio.run(jsvc.get_rate_limits([JReq(**kw) for kw in items]))
            pr = asyncio.run(psvc.get_rate_limits([RateLimitReq(**kw) for kw in items]))
            for i, (a, b) in enumerate(zip(jr, pr)):
                assert _resp_tuple(b) == _resp_tuple(a), (c, i, items[i])
            if c == 0:
                assert int((peng.ici_state.pending != 0).sum()) > 0
            clock.ms += (0, 7, 900, 31_000)[c % 4]
            if c % 2 == 1:
                tick_both(peng, jeng, f"call {c}")
        assert_same(peng, jeng, "end")
        st = peng.stats()
        assert st["requests"] > 0 and st["waves"] > 0
    finally:
        peng.close()


def test_check_columns_global_matches_jax(jax_engines):
    """`check_columns` on a replica topology: the batch split between
    the sharded waves and the replica waves, homes from the shared
    cursor; equal arrays and states, and the same refusals (too many
    waves) with the same cursor afterwards."""
    peng, jeng, clock = pair(jax_engines, "base", BASE)
    try:
        for c, items in enumerate(global_calls(17, 5, 0.5, n_items=40)):
            items = [kw for kw in items if kw["name"] and not kw.get("behavior", 0) & 4]
            data = to_bytes([JReq(**kw) for kw in items])
            got = peng.check_columns(wire.parse_requests(data))
            want = jeng.check_columns(jwire.parse_requests(data))
            if want is None:
                assert got is None, c
            else:
                for g, w in zip(got, want):
                    assert np.array_equal(np.asarray(g, np.int64), np.asarray(w, np.int64)), c
            assert peng._home_rr == jeng._home_rr, c
            clock.ms += 250
            tick_both(peng, jeng, f"call {c}", key_strings=False)
        assert peng.stats()["columnar_flushes"] > 0
    finally:
        peng.close()


@pytest.mark.parametrize("force_global", [False, True])
def test_edge_bytes_global_match_jax(jax_engines, force_global):
    """Wire bytes through both packages' serving cores (the JAX side's
    fast edge on): GLOBAL items served columnar by the replica tier,
    Gregorian ones spliced through the object path; equal response bytes
    and states after every tick."""
    peng, jeng, clock = pair(jax_engines, "base", BASE)
    psvc = V1Service(peng, now_fn=clock, force_global=force_global)
    jsvc = JService(jeng, now_fn=clock, force_global=force_global)
    jsvc.fast_edge = True
    try:
        for c, items in enumerate(global_calls(27, 6, 0.5, n_items=30)):
            # valid items (an invalid one sends the call to the object path)
            items = [kw for kw in items if kw["unique_key"] != "hot" and kw["name"]]
            data = to_bytes([JReq(**kw) for kw in items])
            assert asyncio.run(serve_get_rate_limits_bytes(psvc, data)) == \
                asyncio.run(jserve(jsvc, data)), c
            clock.ms += 1_000
            if c % 2 == 1:
                tick_both(peng, jeng, f"call {c}", key_strings=False)
        assert peng.stats()["columnar_flushes"] > 0
    finally:
        peng.close()


def test_one_tick_converges_every_replica(jax_engines):
    """Hits on a few GLOBAL keys land on every home; after one tick
    every replica holds the same rows (the owners' layout), no pending
    is left, and each key answers the same remaining on every home."""
    peng, jeng, clock = pair(jax_engines, "base", BASE)
    try:
        reqs = [dict(name="cv", unique_key=f"k{i % 5}", hits=1, limit=100, duration=600_000,
                     behavior=GLOBAL, algorithm=(i % 5) % 2) for i in range(40)]
        peng.check_batch([RateLimitReq(**kw) for kw in reqs])
        jeng.check_batch([JReq(**kw) for kw in reqs])
        assert int((peng.ici_state.pending != 0).sum()) > 0
        tick_both(peng, jeng, "tick")
        data = peng.ici_state.table.data
        assert all(torch.equal(data[d], data[0]) for d in range(NDEV))
        assert int(peng.ici_state.pending.abs().sum()) == 0
        probe = [RateLimitReq(name="cv", unique_key="k0", hits=0, limit=100, duration=600_000,
                              behavior=GLOBAL) for _ in range(NDEV)]
        rem = {r.remaining for r in peng.check_batch(probe)}
        assert rem == {92}, rem  # 8 hits on k0, seen on every home
    finally:
        peng.close()


def test_overflow_and_backlog_counters_match_jax(jax_engines):
    """tests/test_ici_overflow.py's two engine cases on one capped
    engine (32 replica slots, one group per tick): 8 keys leave a
    backlog that drains (tick by tick, or at the backstop's full tick);
    then 100 keys overflow the groups, kept or dropped; every tick's
    counters and state equal JAX's."""
    peng, jeng, clock = pair(jax_engines, "capped", CAPPED)
    try:
        few = [dict(name="bkl", unique_key=f"b{i}", behavior=GLOBAL, duration=600_000,
                    limit=100, hits=1) for i in range(8)]
        peng.check_batch([RateLimitReq(**kw) for kw in few])
        jeng.check_batch([JReq(**kw) for kw in few])
        tick_both(peng, jeng, "backlog 0")
        assert peng.sync_backlog > 0
        for k in range(16):
            tick_both(peng, jeng, f"backlog {k + 1}")
            if peng.sync_backlog == 0:
                break
        assert peng.sync_backlog == 0
        many = [dict(name="ovf", unique_key=f"g{i}", behavior=GLOBAL, duration=600_000,
                     limit=100, hits=1) for i in range(100)]
        for rnd in range(2):
            peng.check_batch([RateLimitReq(**kw) for kw in many])
            jeng.check_batch([JReq(**kw) for kw in many])
            for k in range(4):
                tick_both(peng, jeng, f"overflow {rnd}.{k}")
        assert peng.overflow_keys > 0 or peng.overflow_drops > 0
    finally:
        peng.close()


def test_backstop_full_ticks_match_jax(jax_engines):
    """Capped ticks with the backstop: every third tick is a full one
    (full_ticks 1 after 3, 2 after 6), the states equal JAX's after
    each; an uncapped configuration builds no backstop."""
    peng, jeng, clock = pair(jax_engines, "capped", CAPPED)
    try:
        assert peng._rtier.sync_full is not None and jeng._rtier.sync_full is not None
        reqs = [dict(name="bs", unique_key=f"b{i}", behavior=GLOBAL, duration=600_000,
                     limit=50, hits=2) for i in range(24)]
        for t in range(6):
            peng.check_batch([RateLimitReq(**kw) for kw in reqs[t::3]])
            jeng.check_batch([JReq(**kw) for kw in reqs[t::3]])
            tick_both(peng, jeng, f"tick {t}")
            assert peng.full_ticks == (t + 1) // 3
    finally:
        peng.close()
    clock = Clock()
    uncapped = IciEngine(IciEngineConfig(devices=["cpu"] * NDEV,
                                         **dict(CAPPED, max_sync_groups=None)), now_fn=clock)
    try:
        assert uncapped._rtier.sync_full is None
        uncapped.sync_now()
        assert uncapped.full_ticks == 0
    finally:
        uncapped.close()


def test_inject_globals_matches_jax(jax_engines):
    """An authoritative push lands on every replica (existing keys,
    new keys, both algorithms) and supersedes their pending; later
    answers and states equal JAX's."""
    peng, jeng, clock = pair(jax_engines, "base", BASE)
    try:
        reqs = [dict(name="ij", unique_key=f"k{i % 12}", hits=1, limit=50, duration=60_000,
                     behavior=GLOBAL, algorithm=(i // 12) % 2) for i in range(36)]
        peng.check_batch([RateLimitReq(**kw) for kw in reqs])
        jeng.check_batch([JReq(**kw) for kw in reqs])
        pushes = [(f"ij_k{i}", i % 2, 50, 50 - 7 * (i % 5), clock.ms + 30_000 + i)
                  for i in range(0, 16, 2)]
        peng.inject_globals([UpdatePeerGlobal(
            key=k, algorithm=a, duration=60_000,
            status=RateLimitResp(status=0, limit=lim, remaining=rem, reset_time=rt))
            for k, a, lim, rem, rt in pushes])
        jeng.inject_globals([JGlobal(
            key=k, algorithm=a, duration=60_000,
            status=JResp(status=0, limit=lim, remaining=rem, reset_time=rt))
            for k, a, lim, rem, rt in pushes])
        assert_same(peng, jeng, "inject")
        clock.ms += 10
        pr = peng.check_batch([RateLimitReq(**kw) for kw in reqs[:16]])
        jr = jeng.check_batch([JReq(**kw) for kw in reqs[:16]])
        assert [_resp_tuple(r) for r in pr] == [_resp_tuple(r) for r in jr]
        tick_both(peng, jeng, "after inject")
        peng.inject_globals([])
    finally:
        peng.close()


def test_census_and_admission_replica_tier_match_jax(jax_engines):
    """The replica tier of table_census and admission_snapshot (replica
    0 of the stack) equals JAX's after GLOBAL traffic and a tick, and so
    do the combined snapshots."""
    peng, jeng, clock = pair(jax_engines, "base", BASE)
    try:
        for items in global_calls(37, 3, 0.6, n_items=40):
            peng.check_batch([RateLimitReq(**kw) for kw in items])
            jeng.check_batch([JReq(**kw) for kw in items])
            clock.ms += 5_000
        tick_both(peng, jeng, "tick")
        clock.ms += 120_000
        pc, jc = peng.table_census(max_age_s=0), jeng.table_census(max_age_s=0)
        assert pc["tiers"]["replica"]["live"] > 0
        assert pc["tiers"]["replica"] == jc["tiers"]["replica"]
        for k in ("live", "slots", "waste", "cold", "age_ms_hist", "idle_ms_hist"):
            assert pc[k] == jc[k], k
        pa, ja = peng.admission_snapshot(max_age_s=0), jeng.admission_snapshot(max_age_s=0)
        assert pa == ja
        assert pa["tiers"]["replica"]["keys"] > 0
    finally:
        peng.close()


def test_sync_thread_ticks_and_stops_on_close():
    """At a short cadence the sync thread converges the replicas by
    itself; close() stops it."""
    clock = Clock()
    eng = IciEngine(IciEngineConfig(devices=["cpu"] * NDEV, **dict(BASE, sync_wait_s=0.02)),
                    now_fn=clock)
    try:
        assert eng._sync_thread.is_alive()
        reqs = [RateLimitReq(name="th", unique_key=f"k{i % 3}", hits=1, limit=100,
                             duration=600_000, behavior=GLOBAL) for i in range(24)]
        eng.check_batch(reqs)
        deadline = time.monotonic() + 20
        while int(eng.ici_state.tick[0]) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert int(eng.ici_state.tick[0]) >= 2
        with eng._lock:
            data = eng.ici_state.table.data.clone()
            pending = int(eng.ici_state.pending.abs().sum())
        assert pending == 0 and all(torch.equal(data[d], data[0]) for d in range(NDEV))
    finally:
        eng.close()
    assert not eng._sync_thread.is_alive()
    names = [t.name for t in threading.enumerate()]
    assert eng._sync_thread.name not in names


def test_failed_replica_wave_recreates_the_tier():
    """A replica wave that raises empties the replica tier (its pending
    could no longer match its table, as JAX rebuilds its donated state);
    with a sharded wave committed before it the error is
    TableCommittedError, else the error itself; the engine serves on."""
    clock = Clock()
    eng = IciEngine(IciEngineConfig(devices=["cpu"] * NDEV, **dict(BASE, pipeline_depth=1)),
                    now_fn=clock)
    rt = eng._rtier
    real = rt.run_wave
    try:
        g = dict(name="f", unique_key="g", hits=1, limit=10, duration=60_000, behavior=GLOBAL)
        assert eng.check_batch([RateLimitReq(**g)])[0].remaining == 9
        old = rt.state

        def boom(*_a):
            raise RuntimeError("replica wave failed")

        rt.run_wave = boom
        mixed = eng.check_batch([RateLimitReq(name="f", unique_key="s", hits=1, limit=10,
                                              duration=60_000), RateLimitReq(**g)])
        assert all("replica wave failed" in r.error for r in mixed)
        assert rt.state is not old and int(rt.state.table.data.abs().sum()) == 0
        only = eng.check_batch([RateLimitReq(**g)])
        assert only[0].error == "replica wave failed"
        # the flush's sharded wave committed before the replica wave failed
        hb = RequestBatch.zeros(1)
        hb.active[0] = True
        with pytest.raises(TableCommittedError):
            eng._execute_waves(hb, [(0, 1)], clock.ms, RequestBatch.zeros(1), [(0, 1)])
        rt.run_wave = real
        assert eng.check_batch([RateLimitReq(**g)])[0].remaining == 9
    finally:
        rt.run_wave = real
        eng.close()
