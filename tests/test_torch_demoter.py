"""The port's background page demoter against the JAX package's.

The pager's victim policy (`coldness_from_heatmap`, `_pick_victim`,
`demote_victims` with and without census coldness, with the
`min_idle_ticks` spare gate, per shard on a mesh) against the JAX
`Pager` on the same state (as tests/test_paged_engine.py:336-425 pins
the JAX one); the one-copy demote's host rows against the old
per-column path and the JAX package's; one demoter pass of the port's
engine against the JAX engine driven by `table_census` +
`coldness_from_heatmap` + `demote_victims` (as
tests/test_paged_engine.py:309 drives it): the same page map, host tier,
answers and snapshot; and the background thread, which reaches the
free-frame target (per shard on a mesh) within a deadline and stops on
close(). Tolerance: none.
"""

import threading
import time

import numpy as np
import pytest

from gubernator_tpu.api.types import RateLimitReq as JReq
from gubernator_tpu.ops import paged as jpaged
from gubernator_tpu.ops.layout import SlotTable as JSlotTable
from gubernator_tpu.runtime.engine import DeviceEngine as JEngine
from gubernator_tpu.runtime.engine import EngineConfig as JConfig
from gubernator_tpu.runtime.pager import Pager as JPager
from gubernator_tpu.utils import lockorder
from gubernator_tpu_torch.api.types import RateLimitReq
from gubernator_tpu_torch.ops import paged
from gubernator_tpu_torch.ops.layout import SLOT_DTYPES, SlotTable
from gubernator_tpu_torch.runtime.engine import DeviceEngine, EngineConfig
from gubernator_tpu_torch.runtime.ici_engine import IciEngine, IciEngineConfig
from gubernator_tpu_torch.runtime.pager import Pager
from test_torch_engine import Clock, assert_snapshots_equal
from test_torch_paged_engine import assert_pager_views_equal, make_calls

# The JAX Pager's methods declare the engine's table lock; the race
# sanitizer checks locks by name, so the tests hold one of that name.
_TABLE_LOCK = lockorder.make_lock("engine.table")

NOW = 1_753_700_000_000
WAYS = 8


class _FakePK:
    """Page ops over a dict of frames (no table): frame pp holds a fixed
    block of wide rows, a bind or write of frame pp records it. Both
    packages' pagers run on it (`extract_page` for the JAX one,
    `read_page` for the port's)."""

    def __init__(self, logical=16, phys=8, gpp=4, seed=0):
        self.num_logical_pages, self.num_phys_pages = logical, phys
        self.groups_per_page, self.page_slots = gpp, gpp * WAYS
        rng = np.random.default_rng(seed)
        self.rows = {}
        for pp in range(phys):
            used = rng.random(self.page_slots) < (0.0 if pp == 3 else 0.5)
            self.rows[pp] = {
                f: (used if f == "used" else
                    np.where(used, rng.integers(1, 1000, self.page_slots), 0).astype(SLOT_DTYPES[f]))
                for f in SlotTable._fields
            }

    def bind_page(self, table, lp, pp):
        return table

    unbind_page = bind_page

    def write_page(self, table, lp, pp, rows):
        return table

    def extract_page(self, table, pp):
        return JSlotTable(**self.rows[int(pp)])

    def read_page(self, table, pp):
        return {f: a.copy() for f, a in self.rows[int(pp)].items()}


def _pagers(n_shards=1, seed=0, resident=None):
    """The two pagers on the same state: pages bound to frames (every
    frame by default), random touch ticks."""
    rng = np.random.default_rng(seed)
    fk = _FakePK(seed=seed)
    p, j = Pager(fk, n_shards=n_shards), JPager(fk, n_shards=n_shards)
    with _TABLE_LOCK:
        frames = list(range(fk.num_phys_pages)) if resident is None else resident
        for pg in (p, j):
            pg.free = [pp for pp in range(fk.num_phys_pages) if pp not in frames]
            pg._tick = 20
        for pp in frames:
            # the pools are per shard: a frame holds a page of its shard
            shard = pp // (fk.num_phys_pages // n_shards)
            per = fk.num_logical_pages // n_shards
            lp = shard * per + (pp % (fk.num_phys_pages // n_shards)) * 2 + int(rng.integers(0, 2))
            for pg in (p, j):
                pg.page_map[lp] = pp
        touch = rng.integers(5, 21, fk.num_logical_pages)
        for pg in (p, j):
            pg.touch[:] = touch
    return p, j


def _state(pg):
    return (pg.page_map.tolist(), sorted(pg.free), sorted(pg.host_tier), pg.demotes)


# ---- the victim policy against the JAX Pager ------------------------------------


@pytest.mark.parametrize("per_region", [1, 2, 3, 4, 8, 13])
def test_coldness_from_heatmap_matches_jax(per_region):
    p, j = _pagers(seed=per_region, resident=[0, 2, 3, 5, 6, 7])
    rng = np.random.default_rng(per_region)
    hm = rng.integers(0, 9, -(-32 // per_region)).tolist()
    with _TABLE_LOCK:
        got = p.coldness_from_heatmap(hm, per_region)
        assert got == j.coldness_from_heatmap(hm, per_region)
    assert sorted(got) == sorted(np.nonzero(p.page_map >= 0)[0].tolist())


@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_pick_victim_matches_jax(seed, n_shards):
    p, j = _pagers(n_shards, seed)
    rng = np.random.default_rng(seed)
    resident = np.nonzero(p.page_map >= 0)[0].tolist()
    for coldness in (None, {}, {lp: float(rng.integers(0, 3)) for lp in resident}):
        for shard in [None] + list(range(n_shards)):
            with _TABLE_LOCK:
                assert p._pick_victim(coldness, shard) == j._pick_victim(coldness, shard)


@pytest.mark.parametrize("n_shards", [1, 4])
@pytest.mark.parametrize("min_idle", [0, 1, 5])
@pytest.mark.parametrize("with_coldness", [False, True])
def test_demote_victims_matches_jax(with_coldness, min_idle, n_shards):
    """The same victims, free pools, host tier and counts from both
    pagers, pass after pass, the target per shard on a mesh."""
    p, j = _pagers(n_shards, seed=7 + min_idle)
    rng = np.random.default_rng(min_idle)
    resident = np.nonzero(p.page_map >= 0)[0].tolist()
    empty_page = int(np.nonzero(p.page_map == 3)[0][0])  # frame 3's rows are all empty
    coldness = ({lp: float(rng.choice([0, 0, 1, 2.5])) for lp in resident}
                if with_coldness else None)
    for want in (1, 2, 2, 3):
        with _TABLE_LOCK:
            p.demote_victims(object(), want_free=want, min_idle_ticks=min_idle, coldness=coldness)
            j.demote_victims(object(), want_free=want, min_idle_ticks=min_idle, coldness=coldness)
            assert _state(p) == _state(j)
            for lp, rows in p.host_tier.items():
                for f, a in rows.items():
                    assert np.array_equal(a, j.host_tier[lp][f]), (lp, f)
    if min_idle == 0:
        for s in range(n_shards):
            assert p._free_in_shard(s) >= min(3, p.frames_per_shard)
    if p.page_map[empty_page] < 0:
        assert empty_page not in p.host_tier  # an all-empty page is dropped


def test_census_cold_page_goes_before_a_hot_touched_one():
    """JAX tests/test_paged_engine.py:388: a page just touched but
    census-cold goes before a census-busy page with an older touch, and
    census coldness overrides the min_idle_ticks gate."""
    for pg in _pagers(resident=[0, 1]):
        with _TABLE_LOCK:
            lp0, lp1 = sorted(np.nonzero(pg.page_map >= 0)[0].tolist())
            pg._tick = 10
            pg.touch[lp0], pg.touch[lp1] = 10, 2
            coldness = {lp0: 6.0, lp1: 0.0}
            assert pg._pick_victim(coldness) == lp0
            pg.free = []
            pg.demote_victims(object(), want_free=1, min_idle_ticks=100, coldness=coldness)
            assert pg.page_map[lp0] == -1 and pg.page_map[lp1] == 1
            assert pg.free == [0]


def test_pure_lru_fallback_and_min_idle_spare():
    """JAX tests/test_paged_engine.py:408: without coldness the LRU page
    goes; pages touched within min_idle_ticks are spared."""
    for pg in _pagers(resident=[0, 1]):
        with _TABLE_LOCK:
            lp0, lp1 = sorted(np.nonzero(pg.page_map >= 0)[0].tolist())
            pg.free = []
            pg._tick = 10
            pg.touch[lp0], pg.touch[lp1] = 9, 10
            assert pg._pick_victim(None) == lp0
            pg.demote_victims(object(), want_free=2, min_idle_ticks=5)
            assert pg.free == [] and pg.page_map[lp0] == 0
            pg.demote_victims(object(), want_free=1)
            assert pg.page_map[lp0] == -1 and pg.page_map[lp1] == 1


# ---- the one-copy demote -----------------------------------------------------------


def _rows(rng, n):
    used = rng.random(n) < 0.6
    z = np.zeros(n, np.int64)
    return {
        "key_hi": np.where(used, rng.integers(1, 1 << 62, n), z),
        "key_lo": np.where(used, rng.integers(0, 1 << 62, n), z),
        "used": used,
        "algo": rng.integers(0, 2, n).astype(np.int8),
        "status": rng.integers(0, 2, n).astype(np.int8),
        "limit": rng.integers(-5, 1 << 30, n),
        "duration": rng.integers(0, 1 << 40, n),
        "remaining": rng.integers(-(1 << 50), 1 << 50, n),
        "stamp": NOW - rng.integers(-(1 << 30), 1 << 40, n),
        "expire_at": NOW + rng.integers(-(1 << 40), 1 << 40, n),
        "invalid_at": rng.integers(0, 1 << 41, n),
        "burst": rng.integers(0, 1 << 30, n),
        "lru": NOW - rng.integers(0, 1 << 40, n),
    }


@pytest.mark.parametrize("layout", ["fused", "narrow"])
def test_one_copy_demote_rows_equal_the_old_path_and_jax(layout):
    """`read_page` (one copy of the frame's packed rows, unpacked on the
    host) gives bit for bit the rows of the per-column path it replaced
    (`extract_page` on the table's device, then one copy per column) and
    of the JAX package's extract_page, dtypes included; a demote through
    the Pager stores those rows, and a promote writes them back as they
    were."""
    gpp, nlp, npp = 4, 8, 4
    PK = paged.make_paged_kernels(layout, gpp * nlp, WAYS, gpp, npp, "cpu")
    JK = jpaged.make_paged_kernels(layout, gpp * nlp, WAYS, gpp, npp)
    pt, jt = PK.create(), JK.create()
    rng = np.random.default_rng(5)
    for lp, pp in ((1, 2), (6, 0), (3, 3)):
        rows = _rows(rng, PK.page_slots)
        pt = PK.write_page(pt, lp, pp, SlotTable(**rows))
        jt = JK.write_page(jt, np.int32(lp), np.int32(pp), JSlotTable(**rows))
        one = PK.read_page(pt, pp)
        old = {f: getattr(PK.extract_page(pt, pp), f).cpu().numpy() for f in SlotTable._fields}
        ref = JK.extract_page(jt, np.int32(pp))
        for f in SlotTable._fields:
            want = np.asarray(getattr(ref, f))
            assert one[f].dtype == old[f].dtype == want.dtype == SLOT_DTYPES[f], f
            assert np.array_equal(one[f], old[f]) and np.array_equal(one[f], want), f
            assert np.array_equal(one[f], rows[f]), f
    pager = Pager(PK)
    pager.page_map[:] = -1
    pager.page_map[[1, 6, 3]] = [2, 0, 3]
    pager.free = [1]
    before = PK.read_page(pt, 0)
    pt = pager.demote(pt, 6)
    assert pager.page_map[6] == -1 and pager.free == [1, 0]
    assert not PK.read_page(pt, 0)["used"].any()  # the frame is zeroed
    for f in SlotTable._fields:
        assert np.array_equal(pager.host_tier[6][f], before[f])
    pt = pager.ensure_resident(pt, [6])
    back = PK.read_page(pt, int(pager.page_map[6]))
    for f in SlotTable._fields:
        assert np.array_equal(back[f], before[f])
    assert pager.promotes == 1


# ---- the engine's demoter pass against the JAX engine -----------------------------


def _engines(clock, layout, target):
    kw = dict(num_groups=256, batch_size=64, batch_wait_s=0.001, layout=layout,
              page_groups=32, page_budget=3, page_demote_interval_s=0,
              page_free_target=target)
    return (DeviceEngine(EngineConfig(device="cpu", census_ttl_s=0, **kw), now_fn=clock),
            JEngine(JConfig(**kw), now_fn=clock))


def _serve(peng, jeng, clock, calls, advance):
    for items in calls:
        pa = peng.check_batch([RateLimitReq(**kw) for kw in items])
        ja = jeng.check_batch([JReq(**kw) for kw in items])
        got = [(r.status, r.limit, r.remaining, r.reset_time, r.error) for r in pa]
        assert got == [(r.status, r.limit, r.remaining, r.reset_time, r.error) for r in ja]
        clock.ms += advance


def _jax_demoter_pass(jeng):
    """The JAX engine's `_demote_loop` body, driven by hand."""
    census = jeng.table_census(max_age_s=0)
    dev = census["tiers"]["device"]
    if dev["live"] > 0 and dev["cold"][0]["slots"] == 0:
        return
    with jeng._lock:
        pager = jeng._pager
        coldness = pager.coldness_from_heatmap(
            dev["cold_heatmap"], dev["heatmap_groups_per_region"])
        jeng.table = pager.demote_victims(
            jeng.table, want_free=jeng.cfg.page_free_target, min_idle_ticks=1,
            coldness=coldness)


@pytest.mark.parametrize("layout", ["fused", "narrow"])
def test_demoter_pass_matches_jax(layout):
    """Serve, let the clock make some slots census-cold, run one demoter
    pass on each engine: the same page map, host tier and pages; then
    serve again (promoting the demoted pages back) with every answer and
    the final snapshot equal. A fully hot table is not demoted."""
    clock = Clock()
    peng, jeng = _engines(clock, layout, target=2)
    try:
        _serve(peng, jeng, clock, make_calls(61, 20), advance=0)
        peng._demote_once()  # nothing is cold yet: the census gate holds
        assert len(peng._pager.free) == 0 and peng.stats()["demotes"] == jeng._pager.demotes
        clock.ms += 30_000  # the 1 s windows go cold, the 60 s ones do not
        before = peng.stats()["demotes"]
        peng._demote_once()
        _jax_demoter_pass(jeng)
        assert peng.stats()["demotes"] > before and len(peng._pager.free) >= 2
        with peng._lock, jeng._lock:
            assert peng._pager.pages_snapshot() == jeng._pager.pages_snapshot()
            assert peng._pager.touch.tolist() == jeng._pager.touch.tolist()
        assert_pager_views_equal(peng, jeng)
        _serve(peng, jeng, clock, make_calls(62, 20), advance=700)
        assert_snapshots_equal(jeng.snapshot(), peng.snapshot())
    finally:
        peng.close()
        jeng.close()


# ---- the background thread ------------------------------------------------------


@pytest.mark.parametrize("mesh", [False, True])
def test_background_demoter_reaches_the_free_target_and_stops(mesh):
    """With the interval armed and traffic on every page, the thread
    evacuates down to the free-frame target (each shard's on a mesh) once
    the census sees the resident set idle; nothing is lost, and close()
    stops the thread."""
    clock = {"now": NOW}
    kw = dict(num_groups=256, batch_size=64, batch_wait_s=0.001, page_demote_interval_s=0.05,
              page_free_target=2, census_ttl_s=0.01)
    if mesh:
        eng = IciEngine(IciEngineConfig(devices=["cpu"] * 4, page_groups=16, page_budget=12,
                                        **kw), now_fn=lambda: clock["now"])
    else:
        eng = DeviceEngine(EngineConfig(device="cpu", page_groups=32, page_budget=4, **kw),
                           now_fn=lambda: clock["now"])
    thread = eng._demote_thread
    try:
        assert thread is not None and thread.is_alive()
        for i in range(48):
            eng.check_batch([RateLimitReq(name="bg", unique_key=f"k:{i}", duration=60_000,
                                          limit=100, hits=1)])
        clock["now"] += 100 * 60_000  # every window long past: all cold

        def short():
            with eng._lock:
                p = eng._pager
                return [s for s in range(p.n_shards) if p._free_in_shard(s) < 2]

        deadline = time.monotonic() + 10
        while short() and time.monotonic() < deadline:
            threading.Event().wait(0.05)
        assert not short(), "the demoter never reached page_free_target"
        assert eng.stats()["demotes"] > 0
        for i in range(48):
            (r,) = eng.check_batch([RateLimitReq(name="bg", unique_key=f"k:{i}",
                                                 duration=60_000, limit=100, hits=0)])
            assert r.error == "" and r.remaining == 100
    finally:
        eng.close()
    assert not thread.is_alive()


def test_no_demoter_thread_at_interval_zero_or_on_a_flat_table():
    flat = DeviceEngine(EngineConfig(device="cpu", num_groups=64))
    off = DeviceEngine(EngineConfig(device="cpu", num_groups=64, page_groups=8, page_budget=2,
                                    page_demote_interval_s=0))
    try:
        assert flat._demote_thread is None and off._demote_thread is None
    finally:
        flat.close()
        off.close()
