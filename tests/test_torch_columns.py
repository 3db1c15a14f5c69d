"""The port's columnar engine entry (`MeshEngine.check_columns`) against
the JAX package's.

The same seeded GetRateLimitsReq bytes are parsed by each package and
decided by `check_columns`: the JAX DeviceEngine (flat, fused; one per
module, emptied by `restore` before each test) against the port's
engine in every configuration it serves (fused and narrow, flat and
paged with demand paging, and IciEngine over 8 CPU shards). The four
(status, limit, remaining, reset_time) arrays must be equal, the `None`
answers (more waves than `max_waves`) must agree, and the snapshots
(logical image and `key_strings`) must be equal. The port's columnar
answers also equal its own object path (tests/test_fastpath.py:39 and
:281 for the JAX package). Tolerance: none.
"""

import dataclasses
import random

import numpy as np
import pytest

from gubernator_tpu import native as jnative
from gubernator_tpu import wire as jwire
from gubernator_tpu.api.types import Algorithm, Behavior
from gubernator_tpu.api.types import RateLimitReq as JReq
from gubernator_tpu.runtime.engine import DeviceEngine as JEngine
from gubernator_tpu.runtime.engine import EngineConfig as JConfig
from gubernator_tpu.service import pb
from gubernator_tpu_torch import wire
from gubernator_tpu_torch.api.keys import key_hash128_batch_raw
from gubernator_tpu_torch.api.types import RateLimitReq
from gubernator_tpu_torch.runtime.engine import DeviceEngine, EngineConfig
from gubernator_tpu_torch.runtime.ici_engine import IciEngine, IciEngineConfig

NOW = 1_753_700_000_000
NUM_GROUPS = 256
BATCH = 64


class Clock:
    def __init__(self):
        self.ms = NOW

    def __call__(self):
        return self.ms


@pytest.fixture(scope="module")
def jax_engine():
    """(engine, clock, empty snapshot): one JAX engine for the module."""
    clock = Clock()
    eng = JEngine(JConfig(num_groups=NUM_GROUPS, batch_size=BATCH, batch_wait_s=0.001),
                  now_fn=clock)
    empty = eng.snapshot()
    try:
        yield eng, clock, empty
    finally:
        eng.close()


@pytest.fixture
def jeng(jax_engine):
    eng, clock, empty = jax_engine
    eng.restore(empty)
    clock.ms = NOW
    return eng, clock


PORT_CONFIGS = {
    "fused": dict(layout="fused"),
    "narrow": dict(layout="narrow"),
    # 16 logical pages, 8 frames: waves promote and demote (on demand
    # only: no background demoter, so the pager's moves are deterministic)
    "fused-paged": dict(layout="fused", page_groups=16, page_budget=8, page_demote_interval_s=0),
    "narrow-paged": dict(layout="narrow", page_groups=16, page_budget=8,
                         page_demote_interval_s=0),
    "mesh-fused": dict(layout="fused", mesh=True),
    "mesh-narrow-paged": dict(layout="narrow", page_groups=16, page_budget=16, mesh=True,
                              page_demote_interval_s=0),
}


def port_engine(clock, mesh=False, **kw):
    base = dict(num_groups=NUM_GROUPS, batch_size=BATCH, batch_wait_s=0.001)
    base.update(kw)
    if mesh:
        return IciEngine(IciEngineConfig(devices=["cpu"] * 8, **base), now_fn=clock)
    return DeviceEngine(EngineConfig(device="cpu", **base), now_fn=clock)


def to_bytes(reqs) -> bytes:
    msg = pb.pb.GetRateLimitsReq()
    for r in reqs:
        msg.requests.append(pb.req_to_pb(r))
    return msg.SerializeToString()


def random_batch(rng, keys, n):
    out = []
    for _ in range(n):
        behavior = 0
        if rng.random() < 0.1:
            behavior |= Behavior.RESET_REMAINING
        if rng.random() < 0.1:
            behavior |= Behavior.DRAIN_OVER_LIMIT
        r = JReq(
            name="fp", unique_key=rng.choice(keys),
            algorithm=rng.choice([Algorithm.TOKEN_BUCKET, Algorithm.LEAKY_BUCKET]),
            behavior=behavior, duration=rng.choice([100, 60_000, 2**45]),
            limit=rng.choice([3, 10, 50, -2, 2**40]), hits=rng.choice([0, 1, 2, 5, 60, -1]),
            burst=rng.choice([0, 0, 7]),
        )
        u = rng.random()
        if u < 0.1:
            r.created_at = 0
        elif u < 0.2:
            r.created_at = NOW - rng.randrange(3000)
        out.append(r)
    return out


def assert_out_equal(p, j, tag):
    if j is None:
        assert p is None, tag
        return
    assert p is not None, tag
    for a, b, f in zip(p, j, ("status", "limit", "remaining", "reset_time")):
        assert np.array_equal(np.asarray(a, np.int64), np.asarray(b, np.int64)), (tag, f)


def assert_snapshots_equal(ps, js):
    assert set(ps) == set(js)
    for f in js:
        if f == "key_strings":
            assert ps[f] == js[f]
        else:
            assert np.array_equal(ps[f], js[f]), f


@pytest.mark.parametrize("config", list(PORT_CONFIGS))
def test_check_columns_matches_jax(jeng, config):
    jax_eng, clock = jeng
    peng = port_engine(clock, **PORT_CONFIGS[config])
    rng = random.Random(3)
    keys = [f"k{i}" for i in range(40)]
    try:
        for step in range(20):
            if rng.random() < 0.3:
                clock.ms += rng.choice([5, 700, 70_000])
            # a few keys per step (a wave's pages fit the frames), many
            # over the run (pages move)
            sub = rng.sample(keys, 5)
            n = 40 if step == 7 else rng.randint(1, 24)
            batch = random_batch(rng, sub if step != 7 else sub[:1], n)
            data = to_bytes(batch)
            j = jax_eng.check_columns(jwire.parse_requests(data), now=clock())
            p = peng.check_columns(wire.parse_requests(data), now=clock())
            assert_out_equal(p, j, (config, step))
        assert_snapshots_equal(peng.snapshot(), jax_eng.snapshot())
        st = peng.stats()
        assert st["columnar_flushes"] == 19 and st["flushes"] == 0  # step 7: 40 waves, None
        assert st["kernel_launches"] == 0  # a CPU table: the plain version
        if "paged" in config and not config.startswith("mesh"):
            assert st["demotes"] > 0
    finally:
        peng.close()


def test_select_subset_matches_jax(jeng):
    """`select` + `hashes` (the edge's Gregorian split): a subset
    decided with the full batch's hashes, results in `select`'s order;
    the key strings come from the original columns."""
    jax_eng, clock = jeng
    peng = port_engine(clock)
    rng = random.Random(9)
    try:
        for step in range(10):
            batch = random_batch(rng, [f"s{i}" for i in range(8)], 20)
            data = to_bytes(batch)
            jc, pc = jwire.parse_requests(data), wire.parse_requests(data)
            sel = np.sort(np.array(rng.sample(range(20), 12)))
            jh = jnative.hash128_batch_raw(jc.key_data.tobytes(), jc.key_offsets, NUM_GROUPS)
            ph = key_hash128_batch_raw(pc.key_data.tobytes(), pc.key_offsets, NUM_GROUPS)
            for a, b in zip(ph, jh):
                assert np.array_equal(a, b)
            j = jax_eng.check_columns(jc, now=clock(), select=sel, hashes=jh)
            p = peng.check_columns(pc, now=clock(), select=sel, hashes=ph)
            assert_out_equal(p, j, step)
            assert len(p[0]) == 12
        assert_snapshots_equal(peng.snapshot(), jax_eng.snapshot())
        assert peng.check_columns(pc, select=np.array([], np.int64), hashes=ph) is None
    finally:
        peng.close()


def _port_reqs(batch):
    """Port request objects, created_at 0 as absent (as V1Service hands
    them to the engine, and as the columnar path reads them)."""
    out = []
    for r in batch:
        kw = {f.name: getattr(r, f.name) for f in dataclasses.fields(r)}
        kw["created_at"] = kw["created_at"] or None
        out.append(RateLimitReq(**kw))
    return out


@pytest.mark.parametrize("seed", [3, 4])
def test_columns_match_object_path(seed):
    """The port's columnar answers equal its own object path's on the
    same stream (in-batch duplicates included)."""
    rng = random.Random(seed)
    clock = Clock()
    col, obj = port_engine(clock), port_engine(clock)
    keys = [f"fp{i}" for i in range(10)]
    try:
        for step in range(30):
            if rng.random() < 0.2:
                clock.ms += rng.choice([5, 700, 70_000])
            batch = random_batch(rng, keys, rng.randint(1, 40))
            got = col.check_columns(wire.parse_requests(to_bytes(batch)), now=clock())
            want = obj.check_batch(_port_reqs(batch))
            assert got is not None
            for i, w in enumerate(want):
                assert (int(got[0][i]), int(got[1][i]), int(got[2][i]), int(got[3][i])) == (
                    w.status, w.limit, w.remaining, w.reset_time), (seed, step, i)
        assert_snapshots_equal(col.snapshot(), obj.snapshot())
    finally:
        col.close()
        obj.close()


def test_columns_duplicate_key_sequencing():
    """Same key N times in one batch: strictly sequential consumption,
    and over-limit does not consume."""
    clock = Clock()
    eng = port_engine(clock)
    try:
        reqs = [JReq(name="fp", unique_key="dup", duration=60_000, limit=10, hits=4)
                for _ in range(4)]
        status, _limit, remaining, _ = eng.check_columns(wire.parse_requests(to_bytes(reqs)))
        assert list(remaining) == [6, 2, 2, 2]
        assert list(status) == [0, 0, 1, 1]
    finally:
        eng.close()


def test_bounds_decline_without_committing():
    """More waves than `max_waves`, or more lanes in a wave than
    `batch_size`: None, and nothing reaches the table or the stats."""
    clock = Clock()
    eng = port_engine(clock, batch_size=8, max_waves=4)
    try:
        before = eng.snapshot()
        deep = [JReq(name="b", unique_key="hot", hits=1, limit=9, duration=1000)] * 5
        wide = [JReq(name="b", unique_key=f"w{i}", hits=1, limit=9, duration=1000)
                for i in range(40)]
        assert eng.check_columns(wire.parse_requests(to_bytes(deep))) is None
        assert eng.check_columns(wire.parse_requests(to_bytes(wide))) is None
        after = eng.snapshot()
        for f in before:
            if f != "key_strings":
                assert np.array_equal(before[f], after[f]), f
        assert eng.stats()["columnar_flushes"] == 0
        assert eng.check_columns(wire.parse_requests(b"")) is None
    finally:
        eng.close()


def test_mesh_refuses_global_columns():
    """A GLOBAL column on IciEngine is no longer refused: check_columns
    splits the batch between the sharded waves and the replica tier,
    as the JAX IciEngine's `_check_columns_replica_split` does. The
    whole batch, then its non-GLOBAL lane alone (`select`, the edge's
    Gregorian split), then its GLOBAL lane alone: equal answers, replica
    stack and sharded table."""
    from gubernator_tpu.runtime.ici_engine import IciEngine as JIciEngine
    from gubernator_tpu.runtime.ici_engine import IciEngineConfig as JIciConfig

    clock = Clock()
    eng = port_engine(clock, mesh=True, sync_wait_s=3600)
    jeng = JIciEngine(JIciConfig(num_groups=NUM_GROUPS, batch_size=BATCH, batch_wait_s=0.001,
                                 sync_wait_s=3600), now_fn=clock)
    try:
        reqs = [JReq(name="g", unique_key="a", hits=1, limit=5, duration=1000),
                JReq(name="g", unique_key="b", hits=1, limit=5, duration=1000,
                     behavior=Behavior.GLOBAL)]
        data = to_bytes(reqs)
        cols, jcols = wire.parse_requests(data), jwire.parse_requests(data)
        hashes = key_hash128_batch_raw(cols.key_data.tobytes(), cols.key_offsets, NUM_GROUPS)
        jhashes = jnative.hash128_batch_raw(jcols.key_data.tobytes(), jcols.key_offsets,
                                            NUM_GROUPS)
        got = [eng.check_columns(cols)]
        want = [jeng.check_columns(jcols)]
        for sel in (np.array([0]), np.array([1])):
            got.append(eng.check_columns(cols, select=sel, hashes=hashes))
            want.append(jeng.check_columns(jcols, select=sel, hashes=jhashes))
        for g, w in zip(got, want):
            assert [np.asarray(x, np.int64).tolist() for x in g] == \
                [np.asarray(x, np.int64).tolist() for x in w]
        assert [int(g[2][-1]) for g in got] == [4, 3, 4]  # b answered on homes 0 then 1
        assert eng.stats()["requests"] == 4 and eng.stats()["columnar_flushes"] == 3
        assert np.array_equal(eng.ici_state.table.data.numpy(), np.asarray(jeng.ici_state.table.data))
        assert np.array_equal(eng.ici_state.pending.numpy(), np.asarray(jeng.ici_state.pending))
        ps, js = eng.snapshot(), jeng.snapshot()
        for f in js:
            if f != "key_strings":  # JAX's replica split records no key strings
                assert np.array_equal(ps[f], js[f]), f
    finally:
        eng.close()
        jeng.close()
