"""The port's table observatories against the JAX package's.

`gubernator_tpu_torch.ops.census` / `ops.admission` (torch ops) against
`gubernator_tpu.ops.census.make_census` / `ops.admission.make_admission`
on the same seeded wide tables, at all four layouts (wide, packed,
fused, narrow), flat and a paged table's physical frames, plus empty,
full, clamped and bucket-edge tables (as tests/test_table_census.py and
tests/test_admission.py pin the JAX programs); the port's numpy oracles against JAX's; each WaveScan
sum of the plain wave and of the kernel's lane code built for the host
against the oracles over the rows the wave wrote (as
tests/test_kernel_fuzz.py `test_pallas_wavescan_matches_scans`); and the
engines' `table_census` / `admission_snapshot` (DeviceEngine and
IciEngine on the CPU, flat and paged) against the JAX engines after the
same calls under the same fake clock. Left out of that comparison: the
churn ledger's `interval_s` and its `*_per_s` rates, which read the
wall clock. Tolerance: none (all integers).
"""

import time

import numpy as np
import pytest
import torch

from gubernator_tpu.ops.admission import admission_oracle as jadmission_oracle
from gubernator_tpu.ops.admission import make_admission as jmake_admission
from gubernator_tpu.ops.census import census_oracle as jcensus_oracle
from gubernator_tpu.ops.census import make_census as jmake_census
from gubernator_tpu.ops.kernels import get_raw_kernels
from gubernator_tpu.runtime.engine import DeviceEngine as JEngine
from gubernator_tpu.runtime.engine import EngineConfig as JConfig
from gubernator_tpu.runtime.ici_engine import IciEngine as JIciEngine
from gubernator_tpu.runtime.ici_engine import IciEngineConfig as JIciConfig
from gubernator_tpu_torch.api.types import RateLimitReq
from gubernator_tpu_torch.ops import cuda_decide, paged
from gubernator_tpu_torch.ops.admission import AdmissionOutput, admission_oracle
from gubernator_tpu_torch.ops.census import CensusOutput, census_oracle
from gubernator_tpu_torch.ops.kernels import get_admission, get_census, get_kernels
from gubernator_tpu_torch.ops.layout import SLOT_DTYPES, SlotTable
from gubernator_tpu_torch.runtime.engine import DeviceEngine, EngineConfig
from gubernator_tpu_torch.runtime.ici_engine import IciEngine, IciEngineConfig
from test_torch_decide import fuzz_wave, to_torch
from test_torch_paged import GPP, SCRAMBLE, paged_waves, port_table

NOW = 1_753_700_000_000
GROUPS = 64
WAYS = 8
LAYOUTS = ("wide", "packed", "fused", "narrow")
# the layouts of the hand kernel, whose WaveScan sums the oracles check
KERNEL_LAYOUTS = ("fused", "narrow")


def random_wide(rng, groups=GROUPS, ways=WAYS, density=0.5, now=NOW):
    """A random wide host table with adversarial times (future stamps,
    ages up to weeks, windows on both sides of now) and the admission
    corner cases: negative remaining (debt), leaky levels above the
    limit, zero and negative limits, OVER_LIMIT status, expired windows.
    Values fit the narrow layout's 32-bit limit and burst."""
    n = groups * ways
    used = rng.random(n) < density
    z = np.zeros(n, dtype=np.int64)
    algo = rng.integers(0, 2, size=n).astype(np.int8)
    limit = rng.choice(np.array([-5, 0, 1, 10, 100, 1000], dtype=np.int64), size=n)
    tok = rng.integers(-50, 1200, size=n)
    lky = rng.integers(-(50 << 20), 1200 << 20, size=n)
    return SlotTable(
        key_hi=np.where(used, rng.integers(1, 1 << 40, size=n), z),
        key_lo=np.where(used, rng.integers(1, 1 << 40, size=n), z),
        used=used,
        algo=algo,
        status=rng.integers(0, 2, size=n).astype(np.int8),
        limit=limit,
        duration=rng.choice(np.array([0, 1_000, 60_000, 3_600_000], dtype=np.int64), size=n),
        remaining=np.where(algo == 1, lky, tok).astype(np.int64),
        stamp=now - rng.integers(-3_600_000, 1_300_000_000, size=n),
        expire_at=now + rng.integers(-7_200_000, 7_200_000, size=n),
        invalid_at=z,
        burst=rng.integers(0, 1000, size=n),
        lru=now - rng.integers(-3_600_000, 1_300_000_000, size=n),
    )


def port_table_of(layout, wide):
    return get_kernels(layout).from_wide(wide, "cpu")


def jax_table_of(layout, wide):
    return get_raw_kernels(layout).from_wide(_jax_wide(wide))


def _jax_wide(wide):
    from gubernator_tpu.ops.layout import SlotTable as JSlotTable

    return JSlotTable(**{f: np.asarray(getattr(wide, f)) for f in SlotTable._fields})


def assert_fields_equal(port, ref, tag):
    """Every field of a port output (NamedTuple of tensors, or an oracle
    dict) equal to a JAX output or oracle dict, value for value."""
    pf = port._asdict() if hasattr(port, "_asdict") else port
    rf = ref._asdict() if hasattr(ref, "_asdict") else ref
    assert set(pf) == set(rf), tag
    for f in pf:
        a = np.asarray(pf[f].numpy() if torch.is_tensor(pf[f]) else pf[f])
        r = np.asarray(rf[f])
        assert a.shape == r.shape and np.array_equal(a, r), f"{tag}: {f}\nport={a}\nref={r}"


# ---- the scans against JAX's, flat ------------------------------------------


@pytest.mark.parametrize("density", [0.1, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_census_matches_jax(layout, density):
    rng = np.random.default_rng(int(density * 100) + len(layout))
    wide = random_wide(rng, density=density)
    for hw, thresholds in ((16, (1, 4, 16)), (64, (2, 3)), (5, (1,))):
        got = get_census(layout, WAYS, heatmap_width=hw, thresholds=thresholds)(
            port_table_of(layout, wide), NOW)
        want = jmake_census(layout, WAYS, heatmap_width=hw, thresholds=thresholds)(
            jax_table_of(layout, wide), NOW)
        assert isinstance(got, CensusOutput)
        assert_fields_equal(got, want, f"{layout}/{density}/{hw}")
        for t in got:
            assert t.dtype == torch.int64
        oracle = census_oracle(wide, NOW, ways=WAYS, heatmap_width=hw, thresholds=thresholds)
        assert_fields_equal(oracle, want, f"oracle/{layout}/{density}/{hw}")


@pytest.mark.parametrize("density", [0.1, 0.5, 1.0])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_admission_matches_jax(layout, density):
    rng = np.random.default_rng(int(density * 100) + 7 * len(layout))
    wide = random_wide(rng, density=density)
    excess = over = 0
    for now in (NOW, NOW + 3_000_000):
        got = get_admission(layout, WAYS)(port_table_of(layout, wide), now)
        want = jmake_admission(layout, WAYS)(jax_table_of(layout, wide), now)
        assert isinstance(got, AdmissionOutput)
        assert_fields_equal(got, want, f"{layout}/{density}/{now}")
        assert_fields_equal(admission_oracle(wide, now), want, f"oracle/{layout}/{density}")
        excess += int(want.excess_keys)
        over += int(want.over_limit_keys)
    assert density < 0.5 or (excess > 0 and over > 0)  # the corner cases ran


@pytest.mark.parametrize("seed", [3, 4])
def test_oracles_match_jax_oracles(seed):
    rng = np.random.default_rng(seed)
    wide = random_wide(rng, groups=96, density=0.6)
    for ways, hw in ((8, 64), (8, 7), (4, 10)):
        assert_fields_equal(
            census_oracle(wide, NOW, ways=ways, heatmap_width=hw),
            jcensus_oracle(_jax_wide(wide), NOW, ways=ways, heatmap_width=hw), f"census/{ways}")
    assert_fields_equal(admission_oracle(wide, NOW), jadmission_oracle(_jax_wide(wide), NOW),
                        "admission")


# ---- the scans over a paged table's physical frames --------------------------


@pytest.mark.parametrize("layout", LAYOUTS)
def test_scans_of_paged_frames_match_jax(layout):
    """The engine scans a paged table's PHYSICAL frames (`PagedTable.
    data`): after paged waves through the scrambled map, the port's
    scans of its frames equal JAX's scans of the same frames."""
    PK, pt = port_table(layout)
    for w, now in paged_waves(71, 4):
        pt, _out = PK.decide(pt, to_torch(w), now)
    wide = get_kernels(layout).to_wide(pt.data)
    frames = SlotTable(*(c.clone().numpy() for c in wide))
    assert frames.used.any()
    got = get_census(layout, WAYS, heatmap_width=4)(pt.data, now)
    want = jmake_census(layout, WAYS, heatmap_width=4)(jax_table_of(layout, frames), now)
    assert_fields_equal(got, want, f"census/{layout}")
    got = get_admission(layout, WAYS)(pt.data, now)
    want = jmake_admission(layout, WAYS)(jax_table_of(layout, frames), now)
    assert_fields_equal(got, want, f"admission/{layout}")


# ---- edge tables --------------------------------------------------------------


def _empty(groups, ways):
    return SlotTable(**{f: np.zeros(groups * ways, SLOT_DTYPES[f]) for f in SlotTable._fields})


@pytest.mark.parametrize("layout", LAYOUTS)
def test_census_empty_and_full_tables(layout):
    census = get_census(layout, WAYS, heatmap_width=16)
    out = census(port_table_of(layout, _empty(GROUPS, WAYS)), NOW)
    assert int(out.live) == int(out.waste) == int(out.max_full_run) == 0
    assert int(out.age_hist.sum()) == 0 and int(out.fill_hist[0]) == GROUPS
    full = random_wide(np.random.default_rng(3), density=1.1)
    out = census(port_table_of(layout, full), NOW)
    assert int(out.live) == GROUPS * WAYS
    assert int(out.full_groups) == int(out.max_full_run) == int(out.fill_hist[WAYS]) == GROUPS
    want = jmake_census(layout, WAYS, heatmap_width=16)(jax_table_of(layout, full), NOW)
    assert_fields_equal(out, want, "full")


def test_census_clamps_and_bucket_edges():
    """Bin 0 is < 1 ms, bin i is [2^(i-1), 2^i) ms, future stamps clamp
    to bin 0; an idle time equal to k x duration is not cold; the last
    bin takes everything past 2^30 ms; a run of full groups is measured
    between groups that are not full."""
    wide = _empty(6, 2)
    used = np.array([1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0], dtype=bool)
    age = np.array([0, 1, 7, -50, 1 << 30, (1 << 30) - 1, 8, 1 << 40, 3, 2, 0, 0], np.int64)
    idle = np.array([1000, 1001, 4000, 4001, 0, -5, 16_000, 16_001, 999, 5, 0, 0], np.int64)
    wide = wide._replace(
        used=used, key_lo=np.where(used, np.arange(1, 13), 0).astype(np.int64),
        stamp=NOW - age, lru=NOW - idle,
        expire_at=NOW + np.array([1, 0, -1, 5, 0, 1, 1, 1, 1, 1, 0, 0], np.int64),
        duration=np.full(12, 1000, np.int64),
    )
    for layout in LAYOUTS:
        got = get_census(layout, 2, heatmap_width=4)(port_table_of(layout, wide), NOW)
        want = jmake_census(layout, 2, heatmap_width=4)(jax_table_of(layout, wide), NOW)
        assert_fields_equal(got, want, layout)
    a = got.age_hist.tolist()
    assert a[0] == 2 and a[1] == 1 and a[2] == 2 and a[3] == 1 and a[4] == 1
    assert a[30] == 1 and a[31] == 2  # 2^30 - 1 in [2^29, 2^30); 2^30 and 2^40 in the last
    assert got.cold.tolist() == [5, 3, 1]  # idle > 1 s / 4 s / 16 s
    assert int(got.waste) == 3 and int(got.full_groups) == 5 and int(got.max_full_run) == 5


# ---- WaveScan sums against the oracles -----------------------------------------


def _rows(layout, data, slot) -> SlotTable:
    """The rows a wave wrote (slot == N reads zeros), on the host."""
    table = type(get_kernels(layout).create(1, 1, "cpu"))(data)
    return SlotTable(*(c.numpy() for c in get_kernels(layout).gather_rows(table, slot)))


def _assert_scan_is_oracle(scan, rows, now, tag):
    adm = admission_oracle(rows, now)
    cen = census_oracle(rows, now, ways=1)
    assert int(scan.adm_keys) == adm["keys"], tag
    assert int(scan.adm_admitted) == adm["admitted_sum"], tag
    assert int(scan.adm_limit) == adm["limit_sum"], tag
    assert int(scan.census_live) == cen["live"], tag
    assert int(scan.census_waste) == cen["waste"], tag


@pytest.mark.parametrize("paged_table", [False, True])
@pytest.mark.parametrize("layout", KERNEL_LAYOUTS)
def test_wavescan_sums_equal_the_oracles(layout, paged_table):
    """Each wave's five WaveScan sums, from the plain wave and from the
    kernel's lane code built for the host, equal the admission and
    census oracles over the rows the wave wrote (`gather_rows(table,
    out.slot)`)."""
    if paged_table:
        PK, pt = port_table(layout)
        _, kt = port_table(layout)
        waves = paged_waves(81, 5)
    else:
        K = get_kernels(layout)
        pt = K.create(GROUPS, WAYS, "cpu")
        kt = K.create(GROUPS, WAYS, "cpu")
        rng = np.random.default_rng(82)
        waves, now = [], NOW
        for _ in range(5):
            now += int(rng.choice([0, 40, 700, 70_000]))
            waves.append((fuzz_wave(rng, now, GROUPS), now))
    for step, (w, now) in enumerate(waves):
        b = to_torch(w)
        if paged_table:
            pt, out, scan = cuda_decide.decide_paged_with_scan(
                pt, b, now, layout=layout, ways=WAYS, gpp=GPP)
            _, ko, ks = cuda_decide.decide_lane_code_on_host(
                kt.data, b, now, ways=WAYS, layout=layout, page_map=kt.page_map, gpp=GPP)
            data, kdata = pt.data.data, kt.data.data
        else:
            pt, out, scan = cuda_decide.decide_flat_with_scan(pt, b, now, layout=layout, ways=WAYS)
            _, ko, ks = cuda_decide.decide_lane_code_on_host(kt, b, now, ways=WAYS, layout=layout)
            data, kdata = pt.data, kt.data
        tag = f"{layout}/paged={paged_table}/step{step}"
        assert int(scan.census_live) > 0, tag
        _assert_scan_is_oracle(scan, _rows(layout, data, out.slot), now, "plain " + tag)
        _assert_scan_is_oracle(ks, _rows(layout, kdata, ko.slot), now, "lane code " + tag)


# ---- the engines against the JAX engines ---------------------------------------

NUM_GROUPS = 256
PAGE_GROUPS = 16  # 16 logical pages
WALL_CLOCK = ("interval_s", "insert_per_s", "evict_per_s", "recycle_per_s")


class Clock:
    def __init__(self):
        self.ms = NOW

    def __call__(self):
        return self.ms


def _calls(seed, n_calls, keys=60, max_items=3):
    rng = np.random.default_rng(seed)
    return [[
        dict(name="cz", unique_key=f"k:{int(k)}", algorithm=int(rng.random() < 0.4),
             behavior=int(rng.choice([0] * 8 + [8, 32])),
             duration=int(rng.choice([1_000, 60_000, 600_000])),
             limit=int(rng.choice([1, 5, 100])), hits=int(rng.choice([0, 1, 2, 7])))
        for k in rng.integers(0, keys, int(rng.integers(1, max_items + 1)))
    ] for _ in range(n_calls)]


def _engines(clock, mesh, layout, paged_table):
    kw = dict(num_groups=NUM_GROUPS, batch_size=32, batch_wait_s=0.001, layout=layout)
    if paged_table:
        # a call's pages fit the budget (per shard on the mesh: 2 frames
        # each, and calls of at most 2 items)
        kw.update(page_groups=PAGE_GROUPS // 2 if mesh else PAGE_GROUPS,
                  page_budget=16 if mesh else 8, page_demote_interval_s=0)
    if mesh:
        return (IciEngine(IciEngineConfig(devices=["cpu"] * 8, **kw), now_fn=clock),
                JIciEngine(JIciConfig(**kw), now_fn=clock))
    return (DeviceEngine(EngineConfig(device="cpu", **kw), now_fn=clock),
            JEngine(JConfig(**kw), now_fn=clock))


def _without_wall_clock(snap):
    snap = dict(snap)
    snap["churn"] = {k: v for k, v in snap["churn"].items() if k not in WALL_CLOCK}
    return snap


@pytest.mark.parametrize("mesh,layout,paged_table", [
    (False, "fused", False), (False, "narrow", True), (True, "narrow", False),
    (True, "fused", True), (False, "wide", True), (False, "packed", False),
])
def test_engine_snapshots_match_jax(mesh, layout, paged_table):
    """table_census and admission_snapshot of the port's engine equal the
    JAX engine's after the same calls under the same fake clock (twice,
    so the churn ledger's deltas are compared too), paged tiers and the
    pages section included."""
    clock = Clock()
    peng, jeng = _engines(clock, mesh, layout, paged_table)
    from gubernator_tpu.api.types import RateLimitReq as JReq
    try:
        for part in range(2):
            for items in _calls(90 + part, 20, max_items=2 if mesh else 3):
                pa = peng.check_batch([RateLimitReq(**kw) for kw in items])
                ja = jeng.check_batch([JReq(**kw) for kw in items])
                got = [(r.status, r.remaining, r.reset_time, r.error) for r in pa]
                assert got == [(r.status, r.remaining, r.reset_time, r.error) for r in ja]
                assert not any(r.error for r in pa)
                clock.ms += 17_000
            pc, jc = peng.table_census(max_age_s=0), jeng.table_census(max_age_s=0)
            pa, ja = peng.admission_snapshot(max_age_s=0), jeng.admission_snapshot(max_age_s=0)
            if mesh:
                # both mesh engines carry the GLOBAL replica tier (empty
                # here: these calls have no GLOBAL item)
                assert pc["tiers"]["replica"] == jc["tiers"]["replica"]
                assert pa["tiers"]["replica"] == ja["tiers"]["replica"]
            assert _without_wall_clock(pc) == _without_wall_clock(jc)
            assert pa == ja
        if paged_table:
            assert pc["tiers"]["host"]["live"] > 0 and pc["pages"]["demotes"] > 0
        assert peng.occupancy_stats() == {
            k: jc[k] for k in ("live", "slots", "occupancy", "full_group_ratio")}
    finally:
        peng.close()
        jeng.close()


def test_census_is_cached_for_its_ttl():
    """One scan per TTL: the cached snapshot comes back until the TTL
    passes or max_age_s=0 asks for a fresh one; cached_census never
    scans. The admission snapshot caches the same way."""
    clock = Clock()
    eng = DeviceEngine(EngineConfig(device="cpu", num_groups=64, batch_size=16,
                                    batch_wait_s=0.001, census_ttl_s=0.2,
                                    admission_ttl_s=0.2), now_fn=clock)
    try:
        assert eng.cached_census() is None
        first = eng.table_census()
        assert eng.cached_census() is first and first["live"] == 0
        eng.check_batch([RateLimitReq(name="t", unique_key="a", duration=60_000, limit=5, hits=1)])
        assert eng.table_census() is first  # within the TTL
        a0 = eng.admission_snapshot()
        assert eng.admission_snapshot() is a0 and a0["keys"] == 1
        fresh = eng.table_census(max_age_s=0)
        assert fresh is not first and fresh["live"] == 1
        assert fresh["churn"]["insertions"] == 1
        time.sleep(0.25)
        assert eng.table_census() is not fresh
        assert eng.admission_snapshot() is not a0
    finally:
        eng.close()
