"""The port's paged DeviceEngine + V1Service against the JAX package's.

Geometry of tests/test_paged_engine.py: 256 groups, 32 groups per page
(8 logical pages), and a resident budget under the keyspace, so pages
demote and promote while serving. The same seeded calls go through the
JAX paged engine, the port's paged engine (on the CPU, demand demotes
only) and the port's flat engine, on one frozen clock. Every response,
the final `snapshot()` (the logical wide image) and the pager's state
(`pages_snapshot()`) must be equal. Tolerance: none.
"""

import asyncio

import numpy as np
import pytest

from gubernator_tpu.api.types import RateLimitReq as JReq
from gubernator_tpu.ops import paged as jpaged
from gubernator_tpu.runtime.engine import DeviceEngine as JEngine
from gubernator_tpu.runtime.engine import EngineConfig as JConfig
from gubernator_tpu.service.server import V1Service as JService
from gubernator_tpu_torch.api.keys import key_hash128_batch
from gubernator_tpu_torch.api.types import RateLimitReq
from gubernator_tpu_torch.ops import paged
from gubernator_tpu_torch.runtime.engine import DeviceEngine, EngineConfig
from gubernator_tpu_torch.runtime.pager import PageBudgetError
from gubernator_tpu_torch.service.server import V1Service
from test_torch_engine import Clock, _resp_tuple, assert_snapshots_equal

NUM_GROUPS = 256
PAGE_GROUPS = 32  # -> 8 logical pages
BUDGET = 3
BATCH = 64


def _cfg(paged=True, budget=BUDGET, **kw):
    kw = dict(num_groups=NUM_GROUPS, batch_size=BATCH, batch_wait_s=0.002, **kw)
    if paged:
        kw.update(page_groups=PAGE_GROUPS, page_budget=budget, page_demote_interval_s=0)
    return kw


def port_engine(clock, layout="fused", **kw):
    eng = DeviceEngine(EngineConfig(device="cpu", layout=layout, **_cfg(**kw)), now_fn=clock)
    return V1Service(eng, now_fn=clock), eng


def jax_engine(clock, layout="fused", **kw):
    eng = JEngine(JConfig(layout=layout, **_cfg(**kw)), now_fn=clock)
    return JService(eng, now_fn=clock), eng


def make_calls(seed, n_calls):
    """Calls of 1-3 items over 40 keys (so one wave touches at most 3
    pages, the budget): token and leaky, RESET_REMAINING and
    DRAIN_OVER_LIMIT, a repeated key inside a call now and then."""
    rng = np.random.default_rng(seed)
    calls = []
    for _ in range(n_calls):
        n = int(rng.integers(1, 4))
        keys = rng.integers(0, 40, n)
        if n > 1 and rng.random() < 0.2:
            keys[-1] = keys[0]
        calls.append([
            dict(
                name="pg", unique_key=f"acct:{int(k)}",
                algorithm=int(rng.random() < 0.3),
                behavior=int(rng.choice([0] * 8 + [8, 32])),
                duration=int(rng.choice([1000, 60_000, 600_000])),
                limit=int(rng.choice([1, 10, 100])),
                hits=int(rng.choice([0, 1, 1, 2, 5, 50])),
                burst=int(rng.choice([0, 0, 10])),
            )
            for k in keys
        ])
    return calls


def serve(services, clock, calls, advance=(0, 7, 900, 31_000)):
    """Each call through every service; all must answer alike."""
    for c, items in enumerate(calls):
        answers = []
        for svc, jax_side in services:
            cls = JReq if jax_side else RateLimitReq
            answers.append([
                _resp_tuple(r)
                for r in asyncio.run(svc.get_rate_limits([cls(**kw) for kw in items]))
            ])
        for a in answers[1:]:
            assert a == answers[0], (c, items)
        clock.ms += advance[c % len(advance)]


def pages(eng):
    with eng._lock:
        return eng._pager.pages_snapshot()


def assert_pager_views_equal(peng, jeng):
    """The pager's host-side views and the paged table's wide views
    (over the physical frames) equal the JAX engine's."""
    groups = np.arange(NUM_GROUPS)
    with peng._lock, jeng._lock:
        pp, jp = peng._pager, jeng._pager
        assert [paged.logical_page_of(g, PAGE_GROUPS) for g in range(0, NUM_GROUPS, 7)] == [
            jpaged.logical_page_of(g, PAGE_GROUPS) for g in range(0, NUM_GROUPS, 7)]
        assert np.array_equal(pp.phys_groups(groups), jp.phys_groups(groups))
        assert pp.host_live_keys() == jp.host_live_keys()
        ph, jh = pp.host_tier_copy(), jp.host_tier_copy()
        assert sorted(ph) == sorted(jh)
        for lp in ph:
            for f, a in ph[lp].items():
                assert np.array_equal(a, jh[lp][f]), (lp, f)
        pt, jt = peng.table, jeng.table
        assert pt.num_slots == jt.num_slots
        for f in ("used", "key_hi", "key_lo"):
            assert np.array_equal(getattr(pt, f).numpy(), np.asarray(getattr(jt, f))), f


@pytest.mark.parametrize("layout", ["fused", "narrow"])
def test_paged_engine_matches_jax_and_flat(layout):
    clock = Clock()
    jsvc, jeng = jax_engine(clock, layout)
    psvc, peng = port_engine(clock, layout)
    fsvc, feng = port_engine(clock, layout, paged=False)
    try:
        serve([(jsvc, True), (psvc, False), (fsvc, False)], clock, make_calls(51, 30))
        js, ps, fs = jeng.snapshot(), peng.snapshot(), feng.snapshot()
        assert_snapshots_equal(js, ps)
        assert_snapshots_equal(fs, ps)
        assert pages(peng) == pages(jeng)
        assert_pager_views_equal(peng, jeng)
        st = peng.stats()
        assert st["promotes"] > 0 and st["demotes"] > 0, st
        assert st["resident_pages"] == BUDGET and st["host_pages"] > 0
        assert st["kernel_launches"] == 0  # CPU table: the plain version
    finally:
        jeng.close()
        peng.close()
        feng.close()


def test_wave_over_budget_raises():
    """A wave touching more pages than the budget holds raises
    PageBudgetError naming the knob; served through the engine, the
    whole flush fails and nothing is committed."""
    clock = Clock()
    psvc, peng = port_engine(clock, budget=1)
    try:
        with pytest.raises(PageBudgetError, match="GUBER_TABLE_PAGE_BUDGET"):
            with peng._lock:
                peng._pager.ensure_resident(peng.table, np.arange(2))
        before = peng.snapshot()
        # keys on two different pages in one call: one wave, two pages
        keys, seen = [], set()
        for i in range(64):
            lp = int(peng._pager.touched_pages(
                np.asarray([_group(f"k{i}")]))[0])
            if lp not in seen:
                seen.add(lp)
                keys.append(f"k{i}")
            if len(keys) == 2:
                break
        out = asyncio.run(psvc.get_rate_limits(
            [RateLimitReq(name="pg", unique_key=k, hits=1, limit=5, duration=60_000)
             for k in keys]))
        assert all("page budget" in r.error for r in out), out
        after = peng.snapshot()
        for f in before:
            if f != "key_strings":
                assert np.array_equal(before[f], after[f]), f
    finally:
        peng.close()


def _group(unique_key):
    req = RateLimitReq(name="pg", unique_key=unique_key)
    _, _, grp = key_hash128_batch([req.hash_key()], NUM_GROUPS)
    return int(grp[0])


def test_snapshot_carries_across_packages_and_budgets():
    """A JAX paged snapshot restores into the port (with another budget:
    the overflow goes to the host tier), both keep agreeing, and the
    port's snapshot restores back into a fresh JAX paged engine."""
    clock = Clock()
    calls = make_calls(52, 30)
    jsvc, jeng = jax_engine(clock, budget=6)
    psvc, peng = port_engine(clock)
    jsvc2, jeng2 = jax_engine(clock, budget=4)
    try:
        serve([(jsvc, True)], clock, calls[:10])
        peng.restore(jeng.snapshot())
        assert_snapshots_equal(jeng.snapshot(), peng.snapshot())
        assert pages(peng)["host"] > 0
        serve([(jsvc, True), (psvc, False)], clock, calls[10:20])
        jeng2.restore(peng.snapshot())
        serve([(jsvc2, True), (psvc, False)], clock, calls[20:])
        assert_snapshots_equal(jeng2.snapshot(), peng.snapshot())
    finally:
        jeng.close()
        peng.close()
        jeng2.close()


def test_paging_knobs_are_checked():
    """page_budget is required with page_groups; the background demoter
    runs at the JAX package's defaults (every 2 s, one free frame) and
    any interval is accepted; a flat engine reports no paging stats."""
    with pytest.raises(ValueError, match="page_budget"):
        DeviceEngine(EngineConfig(device="cpu", num_groups=NUM_GROUPS, page_groups=32))
    with pytest.raises(ValueError, match="exceeds num_groups"):
        DeviceEngine(EngineConfig(device="cpu", num_groups=NUM_GROUPS,
                                  page_groups=512, page_budget=1))
    eng = DeviceEngine(EngineConfig(device="cpu", num_groups=NUM_GROUPS, page_groups=32,
                                    page_budget=2, page_demote_interval_s=1.0))
    try:
        assert eng._demote_thread is not None and eng._demote_thread.is_alive()
    finally:
        eng.close()
    assert not eng._demote_thread.is_alive()
    assert EngineConfig().page_demote_interval_s == JConfig().page_demote_interval_s == 2.0
    assert EngineConfig().page_free_target == JConfig().page_free_target == 1
    eng = DeviceEngine(EngineConfig(device="cpu", num_groups=NUM_GROUPS))
    try:
        assert "promotes" not in eng.stats()
    finally:
        eng.close()


def test_key_prune_keeps_demoted_keys():
    """Pruning the key dictionary keeps the strings of every live key,
    resident or demoted to the host tier, and drops the rest."""
    clock = Clock()
    psvc, peng = port_engine(clock)
    try:
        serve([(psvc, False)], clock, make_calls(53, 30))
        assert peng.stats()["host_pages"] > 0
        with peng._keys_lock:
            peng._key_strings.update({(-i, i): f"gone:{i}" for i in range(1, 5000)})
        peng._maybe_prune_key_strings()
        snap = peng.snapshot()
        live = set(zip(snap["key_hi"][snap["used"]].tolist(),
                       snap["key_lo"][snap["used"]].tolist()))
        assert set(snap["key_strings"]) == live
        with peng._lock:
            assert peng._pager.host_live_keys() < live
    finally:
        peng.close()
