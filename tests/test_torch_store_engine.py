"""The port's engine with a Store attached against the JAX package's.

The cases of tests/test_store_fuzz.py (a seeded fuzz through a restart,
capacity eviction continuing from the store, an eviction-heavy fuzz on a
direct-mapped table, same-flush eviction read-through, hit-then-reset
removing the entry, a store outage being a miss, a key's own hits
surviving its displacement inside one flush), the columnar edge with a
store (`serve_get_rate_limits_bytes` against the JAX package's with its
fast edge on), each for the fused and narrow layouts, flat and paged;
and the mesh tier (`IciEngine`, 8 shards), whose store receives exactly
the keys the JAX IciEngine's store receives. Every answer, the store's
entries with its get and change counts, and the final wide table must
be equal (tests/test_torch_store.py's harness). Tolerance: none.

The mesh's store path reads `gather_rows(table, out.slot)` at the
psum'd slot, as the JAX package does (ROADMAP.md §3): only the lanes of
the last shard pass the write-behind's key check, and a key displaced
between its own waves restarts fresh.
"""

import dataclasses
import random

import jax
import numpy as np
import pytest

import gubernator_tpu.store.store as jst
from gubernator_tpu.api.types import RateLimitReq as JReq
from gubernator_tpu.parallel import ici as jici
from gubernator_tpu.runtime.ici_engine import IciEngine as JIciEngine
from gubernator_tpu.runtime.ici_engine import IciEngineConfig as JIciConfig
from gubernator_tpu.service.grpc_service import serve_get_rate_limits_bytes as jserve
from gubernator_tpu.service.server import V1Service as JService
import gubernator_tpu_torch.store.store as pst
from gubernator_tpu_torch.api.keys import group_of, key_hash128
from gubernator_tpu_torch.api.types import RateLimitReq
from gubernator_tpu_torch.runtime.ici_engine import IciEngine, IciEngineConfig
from gubernator_tpu_torch.service.server import V1Service, serve_get_rate_limits_bytes
from test_torch_edge import outcome, random_call, to_bytes
from test_torch_store import (  # noqa: F401 - jax_engines is a fixture
    LEAKY,
    NOW,
    RESET,
    DRAIN,
    TOKEN,
    VARIANT_IDS,
    VARIANTS,
    Clock,
    jax_engines,
    run_both,
)


def _colliding_keys(num_groups: int, n: int, prefix: str = "ev", name: str = "sf"):
    """n keys of one slot group."""
    target, found, i = None, [], 0
    while len(found) < n:
        k = f"{prefix}{i}"
        i += 1
        g = group_of(key_hash128(f"{name}_{k}")[1], num_groups)
        if target is None:
            target = g
        if g == target:
            found.append(k)
    return found


def _sf(s, key, hits, behavior=0, **kw):
    kw.setdefault("duration", 600_000)
    kw.setdefault("limit", 100)
    return s.req(key, name="sf", hits=hits, behavior=behavior, **kw)


def case_fuzz_through_restart(s, seed):
    rng = random.Random(seed)
    store = s.store()
    eng = s.engine()
    s.st.attach_store(eng, store)
    keys = [f"sf{i}" for i in range(12)]
    for _ in range(200):
        if rng.random() < 0.1:
            s.clock.ms += rng.choice([5, 500, 70_000])
        behavior = 0
        if rng.random() < 0.1:
            behavior |= RESET
        if rng.random() < 0.15:
            behavior |= DRAIN
        s.check(eng, [s.req(rng.choice(keys), name="sf",
                            algorithm=rng.choice([TOKEN, LEAKY]), behavior=behavior,
                            duration=rng.choice([100, 60_000]), limit=rng.choice([3, 10, 50]),
                            hits=rng.choice([-1, 0, 1, 2, 5, 60]))])
    s.note_store(store)
    s.note_table(eng)
    eng2 = s.engine()  # the restart: a fresh table over the same store
    s.st.attach_store(eng2, store)
    for key in keys:
        for algo in (TOKEN, LEAKY):
            s.check(eng2, [s.req(key, name="sf", algorithm=algo, duration=60_000, limit=50)])
    s.note_store(store)
    s.note_table(eng2)


def case_capacity_eviction_continues(s):
    store = s.store()
    eng = s.engine()
    s.st.attach_store(eng, store)
    a, b = _colliding_keys(4, 2)
    s.check(eng, [_sf(s, a, 30)])
    s.clock.ms += 10
    s.check(eng, [_sf(s, b, 5)])  # evicts a (direct-mapped)
    s.clock.ms += 10
    assert s.check(eng, [_sf(s, a, 1)])[0][2] == 69
    assert s.evictions(eng) >= 1
    s.clock.ms += 10
    s.check(eng, [_sf(s, b, 1)])
    s.clock.ms += 10
    s.check(eng, [_sf(s, a, 4)])
    s.note_store(store)
    s.note_table(eng)


def case_eviction_interleave_fuzz(s):
    rng = random.Random(13)
    store = s.store()
    eng = s.engine()
    s.st.attach_store(eng, store)
    keys = _colliding_keys(4, 5)
    for _ in range(150):
        if rng.random() < 0.1:
            s.clock.ms += rng.choice([7, 900])
        behavior = RESET if rng.random() < 0.08 else 0
        s.check(eng, [s.req(rng.choice(keys), name="sf", algorithm=rng.choice([TOKEN, LEAKY]),
                            behavior=behavior, duration=rng.choice([100, 600_000]),
                            limit=rng.choice([10, 50]), hits=rng.choice([0, 1, 2, 5]))])
    s.note_store(store)
    s.note_table(eng)


def case_same_flush_eviction_readthrough(s):
    store = s.store()
    eng = s.engine()
    s.st.attach_store(eng, store)
    a, b = _colliding_keys(4, 2)
    s.check(eng, [_sf(s, a, 30)])
    s.clock.ms += 5
    s.check(eng, [_sf(s, b, 1)])
    s.clock.ms += 5
    s.check(eng, [_sf(s, a, 1)])
    s.clock.ms += 5
    got = s.check(eng, [_sf(s, b, 1), _sf(s, a, 1)])  # b's wave 0 displaces a again
    assert got[1][2] == 68
    assert store.get(_sf(s, a, 0)).remaining == 68
    s.note_store(store)
    s.note_table(eng)


def case_hit_then_reset_removes(s):
    store = s.store()
    eng = s.engine()
    s.st.attach_store(eng, store)
    k = "reset-key"
    s.check(eng, [_sf(s, k, 3)])
    got = s.check(eng, [_sf(s, k, 1), _sf(s, k, 1, RESET)])
    assert [g[2] for g in got] == [96, 100]
    assert store.get(_sf(s, k, 0)) is None, "store entry resurrected"
    got = s.check(eng, [_sf(s, k, 1, RESET), _sf(s, k, 1)])
    assert [g[2] for g in got] == [99, 98]
    assert store.get(_sf(s, k, 0)).remaining == 98
    s.note_store(store)
    s.note_table(eng)


def case_outage_is_a_miss(s):
    class FlakyStore(s.st.MemoryStore):
        def __init__(self):
            super().__init__()
            self.fail = False

        def get(self, req):
            if self.fail:
                raise ConnectionError("store down")
            return super().get(req)

    store = s.store(FlakyStore)
    eng = s.engine()
    s.st.attach_store(eng, store)
    a, b = _colliding_keys(4, 2)
    assert s.check(eng, [_sf(s, a, 10)])[0][2] == 90
    store.fail = True
    got = s.check(eng, [_sf(s, b, 1), _sf(s, a, 1)])
    assert got[0][4] == "" and got[1][4] == ""
    store.fail = False
    assert s.check(eng, [_sf(s, b, 1)])[0][2] == 98
    s.note_store(store)
    s.note_table(eng)


def case_own_hits_survive_displacement(s):
    store = s.store()
    eng = s.engine()
    s.st.attach_store(eng, store)
    a, b = _colliding_keys(4, 2)
    s.check(eng, [_sf(s, a, 10)])
    s.clock.ms += 5
    s.check(eng, [_sf(s, b, 20)])
    s.clock.ms += 5
    got = s.check(eng, [_sf(s, a, 1), _sf(s, b, 1), _sf(s, a, 1)])
    assert [g[2] for g in got] == [89, 79, 88]
    assert store.get(_sf(s, a, 0)).remaining == 88
    s.clock.ms += 5
    s.check(eng, [_sf(s, a, 1, RESET), _sf(s, b, 1), _sf(s, a, 1)])
    s.note_store(store)
    s.note_table(eng)


DIRECT_CASES = [case_capacity_eviction_continues, case_eviction_interleave_fuzz,
                case_same_flush_eviction_readthrough, case_outage_is_a_miss,
                case_own_hits_survive_displacement]


@pytest.mark.parametrize("layout,paged", VARIANTS, ids=VARIANT_IDS)
@pytest.mark.parametrize("seed", [7, 8])
def test_fuzz_through_restart_matches_jax(seed, layout, paged, jax_engines):
    run_both(case_fuzz_through_restart, "wide", layout, paged, jax_engines, seed=seed)


@pytest.mark.parametrize("layout,paged", VARIANTS, ids=VARIANT_IDS)
@pytest.mark.parametrize("case", DIRECT_CASES, ids=lambda c: c.__name__[5:])
def test_direct_mapped_case_matches_jax(case, layout, paged, jax_engines):
    run_both(case, "direct", layout, paged, jax_engines)


@pytest.mark.parametrize("layout,paged", VARIANTS, ids=VARIANT_IDS)
def test_hit_then_reset_matches_jax(layout, paged, jax_engines):
    run_both(case_hit_then_reset_removes, "wide", layout, paged, jax_engines)


# ---------------------------------------------------------------------------
# the columnar edge with a store


def _seed_store(s, store, rng):
    """Snapshots of half the edge calls' keys: token and leaky, some
    expired, some carrying invalidation marks on either side of NOW."""
    for name in ("rl", "café", ""):
        for i in range(0, 30, 2):
            algo = rng.choice([TOKEN, LEAKY])
            limit = rng.choice([3, 10, 100])
            store.data[f"{name}_k{i}"] = s.snap(
                key=f"{name}_k{i}", algorithm=algo, limit=limit,
                duration=rng.choice([100, 60_000]),
                remaining=rng.randrange(0, limit + 1) << (20 if algo == LEAKY else 0),
                stamp=NOW - rng.randrange(0, 5000),
                expire_at=NOW + rng.choice([-50, 200, 60_000]),
                invalid_at=rng.choice([0, 0, 0, NOW - 10, NOW + 150]),
                burst=limit if algo == LEAKY else 0,
            )


def _edge_call(rng, n):
    """random_call's items the columnar edge takes (Gregorian ones are
    spliced back in): no GLOBAL bit, no metadata, no item that fails
    validation."""
    return [r for r in random_call(rng, n)
            if not r.behavior & 2 and not r.metadata and r.name and r.unique_key]


def case_columnar_edge(s, seed):
    rng = random.Random(seed)
    store = s.store()
    _seed_store(s, store, rng)
    eng = s.engine()
    s.st.attach_store(eng, store)
    if s.port:
        svc, serve = V1Service(eng, now_fn=s.clock), serve_get_rate_limits_bytes
    else:
        svc, serve = JService(eng, now_fn=s.clock), jserve
        svc.fast_edge = True
    for _ in range(6):
        s.note("bytes", outcome(serve, svc, to_bytes(_edge_call(rng, 40))))
        s.clock.ms += rng.choice([7, 120, 900])
    if s.port:
        assert eng.stats()["columnar_flushes"] > 0
    s.note_store(store)
    s.note_table(eng)


@pytest.mark.parametrize("layout,paged", VARIANTS, ids=VARIANT_IDS)
def test_columnar_edge_with_store_matches_jax(layout, paged, jax_engines):
    run_both(case_columnar_edge, "edge", layout, paged, jax_engines, seed=21)


# ---------------------------------------------------------------------------
# the mesh tier: the store receives the JAX IciEngine's key set

NDEV = 8
MESH = dict(num_groups=64, ways=1, num_slots=256, replica_ways=4, batch_size=64,
            batch_wait_s=0.001, sync_wait_s=3600.0)
MESH_PAGED = dict(page_groups=4, page_budget=16, page_demote_interval_s=0)


@pytest.fixture(scope="module")
def jax_ici():
    engines = {}
    yield engines
    for eng, _ in engines.values():
        eng.close()


def _ici_pair(jax_ici, paged, clock):
    cfg = dict(MESH, **(MESH_PAGED if paged else {}))
    if paged not in jax_ici:
        jeng = JIciEngine(JIciConfig(devices=jax.devices()[:NDEV], **cfg), now_fn=clock)
        jax_ici[paged] = (jeng, jeng.snapshot())
    jeng, empty = jax_ici[paged]
    jeng.store = None
    jeng.restore(empty)
    jeng._home_rr = 0
    return IciEngine(IciEngineConfig(devices=["cpu"] * NDEV, **cfg), now_fn=clock), jeng


def _state(store):
    return {k: dataclasses.astuple(v) for k, v in store.data.items()}, store.get_calls, \
        store.change_calls


def _shard_of_last(key, name="sf"):
    return group_of(key_hash128(f"{name}_{key}")[1], MESH["num_groups"]) // (
        MESH["num_groups"] // NDEV) == NDEV - 1


@pytest.mark.parametrize("paged", [False, True], ids=["flat", "paged"])
def test_ici_store_matches_jax_mesh_property(paged, jax_ici):
    """64 keys in one batch, half of them in the store (read through and
    injected on every shard), then a key displaced between its own
    waves, then wire bytes through the columnar edge, then a Loader
    restore into the emptied engines: the store's entries, its counts,
    every answer and the sharded snapshot equal the JAX IciEngine's.
    The store takes fewer of the 32 new keys than were served (the
    psum'd slot), and the displaced key restarts fresh."""
    clock = Clock()
    peng, jeng = _ici_pair(jax_ici, paged, clock)
    peng_empty = peng.snapshot()
    pstore, jstore = pst.MemoryStore(), jst.MemoryStore()
    for m, st in ((pst, pstore), (jst, jstore)):
        for i in range(0, 64, 2):  # half the first batch's keys read through
            st.data[f"sf_m{i}"] = m.ItemSnapshot(
                key=f"sf_m{i}", limit=10, duration=60_000, remaining=i % 10,
                stamp=NOW - 100, expire_at=NOW + 60_000)
    pst.attach_store(peng, pstore)
    jst.attach_store(jeng, jstore)
    try:
        def both(reqs):
            got = []
            for eng, Req in ((jeng, JReq), (peng, RateLimitReq)):
                rs = [Req(**dataclasses.asdict(r)) for r in reqs]
                got.append([(x.status, x.limit, x.remaining, x.reset_time, x.error)
                            for x in eng.check_batch(rs)])
            assert got[0] == got[1]
            assert _state(pstore) == _state(jstore)
            return got[1]

        both([RateLimitReq(name="sf", unique_key=f"m{i}", hits=1, limit=10, duration=60_000)
              for i in range(64)])
        assert peng.stats()["store_injected"] == 32
        assert set(pstore.data) == set(jstore.data)
        assert len({k for k, v in pstore.data.items() if v.stamp == NOW}) < 32
        clock.ms += 10
        a, b = next((a, b) for a, b in (_colliding_keys(MESH["num_groups"], 2, prefix=p)
                                        for p in ("x", "y", "z", "w", "v"))
                    if not _shard_of_last(a))
        both([RateLimitReq(name="sf", unique_key=a, hits=30, limit=100, duration=600_000)])
        clock.ms += 10
        got = both([RateLimitReq(name="sf", unique_key=k, hits=1, limit=100, duration=600_000)
                    for k in (a, b, a)])
        assert got[2][2] == 99  # a's row at the psum'd slot fails the key check
        clock.ms += 10
        rng = random.Random(4)
        for _ in range(3):
            data = to_bytes(_edge_call(rng, 30))
            assert outcome(serve_get_rate_limits_bytes, V1Service(peng, now_fn=clock), data) \
                == outcome(jserve, _fast(JService(jeng, now_fn=clock)), data)
            assert _state(pstore) == _state(jstore)
        ps, js = peng.snapshot(), jeng.snapshot()
        for f in js:
            if f != "key_strings":  # the JAX IciEngine's columns record none
                assert (ps[f] == js[f]).all(), f
        assert peng.stats()["columnar_flushes"] > 0
        # the Loader restore of the store's entries through the sharded inject
        items = sorted(pstore.data.values(), key=lambda it: it.key)
        peng.restore(peng_empty)
        jeng.restore(jax_ici[paged][1])
        pst.load_engine(peng, pst.MemoryLoader(items))
        jst.load_engine(jeng, jst.MemoryLoader(
            [jst.ItemSnapshot(*dataclasses.astuple(it)) for it in items]))
        ps, js = peng.snapshot(), jeng.snapshot()
        for f in js:
            if f != "key_strings":
                assert (ps[f] == js[f]).all(), f
    finally:
        peng.close()


def _fast(svc):
    svc.fast_edge = True
    return svc


GLOBAL = 2
SYNC_COUNTERS = ("overflow_keys", "overflow_drops", "sync_backlog", "full_ticks")


@pytest.mark.parametrize("paged", [False, True], ids=["flat", "paged"])
def test_ici_global_with_store_matches_jax(paged, jax_ici):
    """GLOBAL calls with a Store attached (the replica tier beside the
    store path): seeded calls over 40 keys, 40% of the items GLOBAL,
    half the keys already in the store, a sync tick after every second
    call. Every answer, the store's entries and its get and change
    counts, the sync counters, the replica stack (table, pending, tick)
    and the sharded snapshot with its key strings equal the JAX
    IciEngine's. Replica lanes never persist (both packages)."""
    clock = Clock()
    peng, jeng = _ici_pair(jax_ici, paged, clock)
    # the module's JAX engine keeps the clock of the test that built it
    jeng_clock, jeng.now_fn = jeng.now_fn, clock
    jeng.ici_state = jici.create_ici_state(jeng.mesh, MESH["num_slots"], MESH["replica_ways"],
                                           layout=jeng.cfg.layout)
    jeng._capped_ticks = 0
    jeng.overflow_keys = jeng.overflow_drops = jeng.sync_backlog = jeng.full_ticks = 0
    pstore, jstore = pst.MemoryStore(), jst.MemoryStore()
    for m, st in ((pst, pstore), (jst, jstore)):
        for i in range(0, 40, 2):
            st.data[f"sf_g{i}"] = m.ItemSnapshot(
                key=f"sf_g{i}", limit=10, duration=60_000, remaining=i % 10,
                stamp=NOW - 100, expire_at=NOW + 60_000)
    pst.attach_store(peng, pstore)
    jst.attach_store(jeng, jstore)
    rng = random.Random(12 + paged)
    try:
        for c in range(6):
            reqs = [dict(name="sf", unique_key=f"g{rng.randrange(40)}",
                         hits=rng.choice([0, 1, 1, 2, 5]), limit=rng.choice([5, 10, 100]),
                         duration=60_000, algorithm=int(rng.random() < 0.3),
                         behavior=(GLOBAL if rng.random() < 0.4 else 0)
                         | rng.choice([0, 0, 0, RESET, DRAIN]))
                    for _ in range(30)]
            got = [[(x.status, x.limit, x.remaining, x.reset_time, x.error)
                    for x in eng.check_batch([Req(**kw) for kw in reqs])]
                   for eng, Req in ((jeng, JReq), (peng, RateLimitReq))]
            assert got[0] == got[1], c
            assert _state(pstore) == _state(jstore), c
            clock.ms += 13
            if c % 2:
                peng.sync_now()
                jeng.sync_now()
                assert [getattr(peng, k) for k in SYNC_COUNTERS] == \
                    [getattr(jeng, k) for k in SYNC_COUNTERS], c
        assert peng.stats()["replica_waves"] > 0 and peng.stats()["store_injected"] > 0
        assert all(not k.startswith("sf_g") or k in pstore.data for k in jstore.data)
        ps_, js_ = peng.ici_state, jeng.ici_state
        for name in ("table", "pending", "tick"):
            a = getattr(ps_, name)
            a = (a.data if name == "table" else a).numpy()
            r = getattr(js_, name)
            r = np.asarray(r.data if name == "table" else r)
            assert a.dtype == r.dtype and np.array_equal(a, r), name
        ps, js = peng.snapshot(), jeng.snapshot()
        assert ps["key_strings"] == js["key_strings"]
        for f in js:
            if f != "key_strings":
                assert (ps[f] == js[f]).all(), f
    finally:
        peng.close()
        jeng.store = None
        jeng.now_fn = jeng_clock
