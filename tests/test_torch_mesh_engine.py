"""The port's IciEngine (the engine core over the owner-sharded mesh)
against its DeviceEngine, as tests/test_mesh_engine.py holds the JAX
mesh engine against the JAX single-chip engine: on one device the
sharded tier must be bit-exact with one table, flat and paged, through
demote/promote churn, and across a snapshot handover between a flat
engine and a paged mesh engine. The mesh is 8 shards on `cpu` (the JAX
package fakes 8 devices on one CPU). The DeviceEngine itself is held
against the JAX engines in tests/test_torch_engine.py and
tests/test_torch_paged_engine.py. Tolerance: none.
"""

import asyncio
import random

import numpy as np
import pytest

from gubernator_tpu.runtime.ici_engine import IciEngineConfig as JIciConfig
from gubernator_tpu_torch.api.types import Behavior, RateLimitReq
from gubernator_tpu_torch.runtime.engine import DeviceEngine, EngineConfig
from gubernator_tpu_torch.runtime.ici_engine import IciEngine, IciEngineConfig
from gubernator_tpu_torch.service.server import V1Service
from test_torch_engine import Clock, _resp_tuple, assert_snapshots_equal

NUM_GROUPS = 256
PAGE_GROUPS = 16  # -> 16 logical pages, 2 per shard
SHARDS = ["cpu"] * 8


def single(clock, layout="fused", **kw):
    return DeviceEngine(
        EngineConfig(device="cpu", layout=layout, num_groups=NUM_GROUPS, batch_size=32,
                     batch_wait_s=0.001, **kw),
        now_fn=clock,
    )


def mesh(clock, layout="fused", paged=False, **kw):
    if paged:
        kw.setdefault("page_groups", PAGE_GROUPS)
        kw.setdefault("page_budget", 16)
        kw.setdefault("page_demote_interval_s", 0)  # demand demotes only: deterministic
    return IciEngine(
        IciEngineConfig(devices=SHARDS, layout=layout, num_groups=NUM_GROUPS,
                        batch_size=32, batch_wait_s=0.001, **kw),
        now_fn=clock,
    )


def fuzz_calls(rng, n_calls, keys=40):
    """Calls of 1-23 items: duplicates, RESET_REMAINING, both algorithms
    (tests/test_mesh_engine.py `_fuzz_reqs`)."""
    calls = []
    for _ in range(n_calls):
        calls.append([
            dict(
                name=rng.choice(["ma", "mb"]), unique_key=f"acct:{rng.randrange(keys)}",
                algorithm=rng.choice([0, 1]),
                behavior=8 if rng.random() < 0.08 else 0,
                duration=rng.choice([5_000, 60_000, 600_000]),
                limit=rng.choice([1, 10, 100]), hits=rng.choice([0, 1, 1, 2, 5, 50]),
                burst=rng.choice([0, 0, 10]),
            )
            for _ in range(rng.randrange(1, 24))
        ])
    return calls


def answers(eng, items):
    return [_resp_tuple(r) for r in eng.check_batch([RateLimitReq(**kw) for kw in items])]


@pytest.mark.parametrize("layout", ["fused", "narrow"])
def test_mesh_matches_single_table(layout):
    """The same fuzz stream (duplicates, resets, clock jumps, both
    algorithms) through the flat DeviceEngine, the flat IciEngine and the
    paged IciEngine: every response at every step, and the final
    snapshot (the logical image), bit-exact."""
    clock = Clock()
    rng = random.Random({"fused": 31, "narrow": 32}[layout])
    one, flat, paged = single(clock, layout), mesh(clock, layout), mesh(clock, layout, paged=True)
    try:
        for c, items in enumerate(fuzz_calls(rng, 6)):
            clock.ms += rng.choice([1, 700, 6_000])
            want = answers(one, items)
            assert answers(flat, items) == want, f"flat mesh diverged ({layout}, call {c})"
            assert answers(paged, items) == want, f"paged mesh diverged ({layout}, call {c})"
        snap = one.snapshot()
        assert_snapshots_equal(snap, flat.snapshot())
        assert_snapshots_equal(snap, paged.snapshot())
        assert flat.stats()["n_dev"] == 8 and flat.n_dev == 8 and flat.mesh.size == 8
        assert flat.stats()["waves"] == one.stats()["waves"]
    finally:
        one.close()
        flat.close()
        paged.close()


def test_paged_mesh_zero_loss_through_churn():
    """Budget 8 frames = ONE frame per shard against 16 logical pages:
    single-key calls force demotes and promotes within a shard. Every
    response matches a flat single-table twin (which never demotes), and
    a zero-hit read of every key afterwards agrees too; each page lives
    in its own shard's frames."""
    clock = Clock()
    one, paged = single(clock), mesh(clock, paged=True, page_budget=8)
    rng = random.Random(77)
    keys = [f"churn:{i}" for i in range(48)]
    try:
        for round_ in range(2):
            clock.ms += 500
            rng.shuffle(keys)
            for k in keys:
                item = [dict(name="churn", unique_key=k, duration=600_000, limit=1000, hits=1)]
                assert answers(paged, item) == answers(one, item), (round_, k)
        st = paged.stats()
        assert st["demotes"] > 0 and st["promotes"] > 0, st
        pager = paged._pager
        with paged._lock:
            for lp in np.nonzero(pager.page_map >= 0)[0].tolist():
                assert pager.shard_of_frame(pager.page_map[lp]) == pager.shard_of_page(lp)
            assert pager.pages_snapshot()["frames_per_shard"] == 1
        for k in keys:
            item = [dict(name="churn", unique_key=k, duration=600_000, limit=1000, hits=0)]
            assert answers(paged, item) == answers(one, item), k
        assert_snapshots_equal(one.snapshot(), paged.snapshot())
    finally:
        one.close()
        paged.close()


def test_handover_flat_single_to_paged_mesh_and_back():
    """Counters written on a flat single-table engine move by snapshot
    into a paged mesh engine (pages fill each shard's frames, the rest go
    to the host tier) and keep counting exactly; the paged mesh's
    snapshot (the logical image of per-shard frames and the host tier)
    restores into a fresh flat engine with the counts intact."""
    clock = Clock()
    keys = [f"ho:{i}" for i in range(24)]

    def hit(eng, k, hits):
        return eng.check_batch([RateLimitReq(name="ho", unique_key=k, duration=600_000,
                                             limit=1000, hits=hits)])[0]

    flat, paged, flat2 = single(clock), mesh(clock, paged=True, page_budget=8), single(clock)
    try:
        for i, k in enumerate(keys):
            hit(flat, k, 3 + i % 4)
        paged.restore(flat.snapshot())
        assert paged.stats()["host_pages"] > 0, "the image must overflow the budget"
        for i, k in enumerate(keys):
            assert hit(paged, k, 1).remaining == 1000 - (3 + i % 4) - 1, k
        flat2.restore(paged.snapshot())
        for i, k in enumerate(keys):
            assert hit(flat2, k, 0).remaining == 1000 - (3 + i % 4) - 1, k
    finally:
        flat.close()
        paged.close()
        flat2.close()


def test_global_requests_are_refused():
    """GLOBAL traffic is no longer refused: the replica tier answers it
    (parallel/ici.py). Each submission route the refusal once covered
    (check_async, a check_batch mixing a sharded and a GLOBAL item,
    V1Service) answers as the JAX IciEngine does on the same requests
    and clock, and leaves the same replica stack and sharded table."""
    from gubernator_tpu.api.types import RateLimitReq as JReq
    from gubernator_tpu.runtime.ici_engine import IciEngine as JIciEngine
    from gubernator_tpu.service.server import V1Service as JService

    clock = Clock()
    eng = mesh(clock, sync_wait_s=3600)
    jeng = JIciEngine(JIciConfig(num_groups=NUM_GROUPS, batch_size=32, batch_wait_s=0.001,
                                 sync_wait_s=3600), now_fn=clock)
    try:
        assert IciEngine.routes_global_internally and not DeviceEngine.routes_global_internally
        g = dict(name="g", unique_key="k", hits=1, limit=5, duration=1000,
                 behavior=int(Behavior.GLOBAL))
        x = dict(name="g", unique_key="x", hits=1)
        got = [eng.check_async(RateLimitReq(**g)).result(timeout=30)]
        want = [jeng.check_async(JReq(**g)).result(timeout=30)]
        got += eng.check_batch([RateLimitReq(**x), RateLimitReq(**g)])
        want += jeng.check_batch([JReq(**x), JReq(**g)])
        got += asyncio.run(V1Service(eng, now_fn=clock).get_rate_limits([RateLimitReq(**g)]))
        want += asyncio.run(JService(jeng, now_fn=clock).get_rate_limits([JReq(**g)]))
        assert [_resp_tuple(r) for r in got] == [_resp_tuple(r) for r in want]
        # three GLOBAL hits on homes 0, 1, 2 (round robin), no tick yet:
        # each replica saw one
        assert not any(r.error for r in got) and [r.remaining for r in got] == [4, 0, 4, 4]
        assert eng.stats()["requests"] == 4
        for a, r in ((eng.ici_state.table.data, jeng.ici_state.table.data),
                     (eng.ici_state.pending, jeng.ici_state.pending)):
            assert np.array_equal(a.numpy(), np.asarray(r))
        assert_snapshots_equal(jeng.snapshot(), eng.snapshot())
    finally:
        eng.close()
        jeng.close()


def test_mesh_engine_config_is_checked():
    """Shards on two cards and a shard count that divides neither the
    groups nor the page budget are refused; the background demoter runs
    at the JAX package's defaults (every 2 s, one free frame per
    shard)."""
    clock = Clock()
    with pytest.raises(NotImplementedError, match="several"):
        IciEngine(IciEngineConfig(devices=["cuda:0", "cuda:1"], num_groups=64))
    with pytest.raises(ValueError, match="divide"):
        IciEngine(IciEngineConfig(devices=SHARDS, num_groups=60))
    with pytest.raises(ValueError, match="multiple of mesh size"):
        mesh(clock, paged=True, page_budget=12)
    with pytest.raises(ValueError, match="logical page count"):
        mesh(clock, paged=True, page_groups=64, page_budget=8)
    eng = mesh(clock, paged=True, page_demote_interval_s=1.0)
    try:
        assert eng._demote_thread is not None and eng._demote_thread.is_alive()
    finally:
        eng.close()
    assert IciEngineConfig().page_demote_interval_s == JIciConfig().page_demote_interval_s == 2.0
    assert IciEngineConfig().page_free_target == JIciConfig().page_free_target == 1
