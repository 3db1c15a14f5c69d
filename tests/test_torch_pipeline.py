"""The port's two-stage engine pipeline and the launch path of a flush.

The port's counterparts of tests/test_pipeline.py (`:74`, `:84`, `:95`,
`:125`, `:189`, `:225`, `:283`): depth 1 (the serial pump) and depth 2
give the same decisions in every layout, futures resolve in dispatch
order, the in-flight ring is bounded, a failed flush or a failed
completion fails only its own futures, the mesh agrees at both depths,
close serves flushes in flight. Then the port at depth 2 against the
JAX engine at depth 2 on the same trace, and the flush's launch path
(`cuda_decide.WaveFlush`): the argument structs a card's launch gets,
run through the kernels' lane code built by g++, against the plain
version. The port runs on the CPU (its plain decide). Tolerance: none.
"""

import dataclasses
import random
import threading
import time

import numpy as np
import pytest
import torch

from gubernator_tpu.api.types import RateLimitReq as JReq
from gubernator_tpu.runtime.engine import DeviceEngine as JEngine
from gubernator_tpu.runtime.engine import EngineConfig as JConfig
from gubernator_tpu_torch.api.types import Behavior, RateLimitReq
from gubernator_tpu_torch.ops import cuda_decide, fused, narrow
from gubernator_tpu_torch.ops.layout import RequestBatch, SlotTable, batch_to_device
from gubernator_tpu_torch.ops.paged import make_paged_kernels
from gubernator_tpu_torch.runtime.engine import DeviceEngine, EngineConfig, TableCommittedError
from gubernator_tpu_torch.runtime.ici_engine import IciEngine, IciEngineConfig

NOW = 1_753_700_000_000
CONFIGS = [("fused", 0), ("narrow", 0), ("fused", 64), ("narrow", 64)]


def mk(key="k", **kw):
    kw.setdefault("name", "pipe")
    kw.setdefault("duration", 60_000)
    kw.setdefault("limit", 100)
    kw.setdefault("hits", 1)
    return RateLimitReq(unique_key=key, **kw)


def trace(n=400, n_keys=23, cls=RateLimitReq):
    """tests/test_pipeline.py's trace: duplicate keys (multi-wave
    flushes), leaky and token buckets, over-limit pressure,
    RESET_REMAINING."""
    rng = random.Random(7)
    reqs = []
    for i in range(n):
        reqs.append(cls(
            name="pipe", unique_key=f"k{rng.randrange(n_keys)}", duration=60_000,
            algorithm=rng.choice((0, 1)), hits=rng.choice((0, 1, 1, 2, 5)), limit=20,
            behavior=int(Behavior.RESET_REMAINING) if i % 37 == 5 else 0,
        ))
    return reqs


def engine(depth, layout="fused", page_groups=0, **kw):
    kw.setdefault("batch_size", 64)
    kw.setdefault("batch_wait_s", 0.001)
    kw.setdefault("batch_limit", 50)  # one bulk of `run` per flush
    pcfg = (dict(page_groups=page_groups, page_budget=4, page_demote_interval_s=0)
            if page_groups else {})
    return DeviceEngine(
        EngineConfig(num_groups=1 << 10, device="cpu", pipeline_depth=depth, layout=layout,
                     **pcfg, **kw),
        now_fn=lambda: NOW,
    )


def run(eng, reqs, chunk=50):
    """Submit the trace as overlapping bulks (the pipeline engages at
    depth >= 2); returns the decision tuples and the snapshot."""
    try:
        futs = [eng.check_bulk(reqs[i:i + chunk]) for i in range(0, len(reqs), chunk)]
        out = [r for f in futs for r in f.result(timeout=60)]
        snap = eng.snapshot()
        st = eng.stats()
    finally:
        eng.close()
    return [(r.status, r.limit, r.remaining, r.reset_time, r.error) for r in out], snap, st


def assert_snapshots_equal(a, b):
    assert set(a) == set(b)
    for f in a:
        if f == "key_strings":
            assert a[f] == b[f]
        else:
            assert np.array_equal(a[f], b[f]), f


def test_depth1_matches_depth2_bitexact():
    reqs = trace()
    a, sa, _ = run(engine(1), [dataclasses.replace(r) for r in reqs])
    b, sb, st = run(engine(2), [dataclasses.replace(r) for r in reqs])
    assert a == b
    assert_snapshots_equal(sa, sb)
    assert st["pipeline_depth"] == 2 and st["flushes"] >= 8


@pytest.mark.parametrize("layout,page_groups", CONFIGS)
def test_pipelined_matches_serial_all_layouts(layout, page_groups):
    """Fused and narrow, flat and paged (4 frames of 64 groups for 16
    pages: the pager demotes and promotes inside the pipeline)."""
    reqs = trace(n=160, n_keys=40)
    a, sa, _ = run(engine(1, layout, page_groups), [dataclasses.replace(r) for r in reqs])
    b, sb, st = run(engine(3, layout, page_groups), [dataclasses.replace(r) for r in reqs])
    assert a == b
    assert_snapshots_equal(sa, sb)
    if page_groups:
        assert st["demotes"] > 0


def test_fifo_future_resolution_order():
    eng = engine(4, batch_size=32, batch_wait_s=0.0005)
    order, lock = [], threading.Lock()
    try:
        futs = []
        for i in range(40):
            f = eng.check_async(mk(key=f"fifo{i}", behavior=Behavior.NO_BATCHING))
            f.add_done_callback(lambda _f, i=i: (lock.acquire(), order.append(i), lock.release()))
            futs.append(f)
        for f in futs:
            assert f.result(timeout=10).error == ""
    finally:
        eng.close()
    assert order == sorted(order)


def test_backpressure_bounds_inflight_ring():
    """With completion gated, at most `pipeline_depth` tickets are ever
    in flight, and the ring does fill to that depth."""
    eng = engine(2, batch_size=32, batch_wait_s=0.0005)
    gate = threading.Event()
    orig = eng._complete
    seen = []

    def gated(t):
        seen.append(eng._inflight)
        gate.wait(10)
        orig(t)

    eng._complete = gated
    try:
        futs = [eng.check_async(mk(key=f"bp{i}", behavior=Behavior.NO_BATCHING))
                for i in range(8)]
        deadline = time.monotonic() + 1.0
        while time.monotonic() < deadline:
            assert eng._inflight <= 2
            time.sleep(0.01)
        gate.set()
        for f in futs:
            assert f.result(timeout=10).error == ""
    finally:
        gate.set()
        eng.close()
    assert seen and max(seen) <= 2
    assert eng.stats()["inflight_max"] == 2


def test_inflight_counts_from_the_end_of_dispatch():
    """A flush counts as in flight once its dispatch returned, as the
    JAX engine counts it (the pipeline histogram): no dispatch sees its
    own flush counted, so two in flight means a flush was launched while
    the one before it had not been answered. Serial: one."""
    eng = engine(2, batch_size=32, batch_wait_s=0.0005)
    gate = threading.Event()
    orig_dispatch, orig_complete = eng._dispatch, eng._complete
    at_dispatch = []

    def dispatch(items):
        at_dispatch.append(eng._inflight)
        return orig_dispatch(items)

    def gated(t):
        gate.wait(10)
        orig_complete(t)

    eng._dispatch, eng._complete = dispatch, gated
    try:
        futs = [eng.check_async(mk(key=f"ic{i}", behavior=Behavior.NO_BATCHING))
                for i in range(3)]
        deadline = time.monotonic() + 5.0
        while len(at_dispatch) < 2 or eng._inflight < 2:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        assert at_dispatch[:2] == [0, 1]
        gate.set()
        for f in futs:
            assert f.result(timeout=10).error == ""
    finally:
        gate.set()
        eng.close()
    assert eng.stats()["inflight_max"] == 2
    serial = engine(1)
    try:
        serial.check_batch([mk(key=f"s{i}") for i in range(5)])
    finally:
        serial.close()
    assert serial.stats()["inflight_max"] == 1


class _FailingKernels:
    """Kernel facade proxy: runs the real wave (the table is updated in
    place) and then raises on the armed call: a failure after the
    flush's wave committed."""

    def __init__(self, real):
        self._real = real
        self.fail_on_call = -1
        self.calls = 0

    def __getattr__(self, name):
        return getattr(self._real, name)

    def run_wave(self, *a, **kw):
        self.calls += 1
        out = self._real.run_wave(*a, **kw)
        if self.calls == self.fail_on_call:
            raise RuntimeError("injected device failure")
        return out


def test_failed_flush_fails_only_its_futures():
    """A flush whose wave fails fails its own futures and nothing else.
    The table is updated in place (no donated buffer to rebuild): a wave
    that ran before the failure keeps its update, and the engine keeps
    serving from that table."""
    eng = engine(3, batch_size=32, batch_wait_s=0.0005)
    try:
        proxy = _FailingKernels(eng.K)
        eng.K = proxy
        for f in [eng.check_async(mk(key=f"a{i}", behavior=Behavior.NO_BATCHING))
                  for i in range(3)]:
            assert f.result(timeout=10).error == ""
        proxy.fail_on_call = proxy.calls + 1
        boom = eng.check_async(mk(key="boom", behavior=Behavior.NO_BATCHING, hits=3))
        assert "injected device failure" in boom.result(timeout=10).error
        ok2 = [eng.check_async(mk(key=f"b{i}", behavior=Behavior.NO_BATCHING)) for i in range(3)]
        for f in ok2:
            assert f.result(timeout=10).error == ""
        # the failed flush's one wave ran: its hit is in the table
        again = eng.check_async(mk(key="boom", hits=0)).result(timeout=10)
        assert again.error == "" and again.remaining == 97
    finally:
        eng.close()


def test_failure_after_a_committed_wave_is_table_committed():
    """A wave failing after an earlier wave of its flush committed raises
    TableCommittedError (no caller may retry the batch)."""
    eng = engine(1, batch_size=32)
    try:
        proxy = _FailingKernels(eng.K)
        eng.K = proxy
        proxy.fail_on_call = 2
        with pytest.raises(TableCommittedError, match="injected"):
            eng._dispatch([(mk(key="dup"), None), (mk(key="dup"), None)])
    finally:
        eng.close()


def test_completion_stage_failure_is_ticket_isolated():
    eng = engine(3, batch_size=32, batch_wait_s=0.0005)
    orig = eng._complete

    def flaky(t):
        if any(req.unique_key == "poison" for req, _ in t.items):
            raise RuntimeError("injected completion failure")
        orig(t)

    eng._complete = flaky
    try:
        a = eng.check_async(mk(key="pre", behavior=Behavior.NO_BATCHING))
        assert a.result(timeout=10).error == ""
        p = eng.check_async(mk(key="poison", behavior=Behavior.NO_BATCHING))
        assert "injected completion failure" in p.result(timeout=10).error
        b = eng.check_async(mk(key="post", behavior=Behavior.NO_BATCHING))
        assert b.result(timeout=10).error == ""
    finally:
        eng._complete = orig
        eng.close()


def test_close_serves_flushes_in_flight():
    """Zero loss at close: everything submitted before close() is
    answered, with tickets in flight when it is called."""
    eng = engine(2, batch_size=16, batch_wait_s=0.0005)
    futs = [eng.check_bulk([mk(key=f"c{i}_{j}") for j in range(20)]) for i in range(10)]
    eng.close()
    out = [r for f in futs for r in f.result(timeout=10)]
    assert len(out) == 200 and all(r.error == "" and r.remaining == 99 for r in out)


def test_mesh_depth1_matches_depth2():
    """The mesh tier (8 shards on the CPU) through the pipeline."""
    def go(depth):
        eng = IciEngine(IciEngineConfig(devices=["cpu"] * 8, num_groups=1 << 8, batch_size=64,
                                        batch_wait_s=0.001, pipeline_depth=depth),
                        now_fn=lambda: NOW)
        return run(eng, [mk(key=f"i{i % 17}", limit=50) for i in range(120)], chunk=40)

    a, sa, _ = go(1)
    b, sb, _ = go(2)
    assert a == b
    assert_snapshots_equal(sa, sb)


def test_depth2_matches_jax_depth2():
    """The same trace through the JAX engine and the port, both at
    depth 2: equal decisions and snapshots."""
    jeng = JEngine(JConfig(num_groups=1 << 10, batch_size=64, batch_wait_s=0.001,
                           pipeline_depth=2), now_fn=lambda: NOW)
    try:
        futs = [jeng.check_bulk(trace(cls=JReq)[i:i + 50]) for i in range(0, 400, 50)]
        want = [(r.status, r.limit, r.remaining, r.reset_time, r.error)
                for f in futs for r in f.result(timeout=60)]
        jsnap = jeng.snapshot()
    finally:
        jeng.close()
    got, psnap, _ = run(engine(2), trace())
    assert got == want
    assert_snapshots_equal(psnap, jsnap)


# ---- the launch path of a flush ---------------------------------------------


def _tables(layout, paged, rng):
    """(layout table or paged frames + map, groups, gpp) with live rows."""
    mod = {"fused": fused, "narrow": narrow}[layout]
    groups, ways = 256, 8
    if not paged:
        t = mod.pack_table(_image(rng, groups * ways))
        return t.data, None, groups, 0
    pk = make_paged_kernels(layout, groups, ways, 32, 6, "cpu")
    pt = pk.create()
    for lp, pp in ((0, 3), (2, 0), (5, 5), (7, 1)):
        pt = pk.write_page(pt, lp, pp, _image(rng, 32 * ways))
    return pt.data.data, pt.page_map, groups, 32


def _image(rng, n):
    cols = {f: np.zeros(n, dtype=np.int64) for f in SlotTable._fields}
    live = rng.random(n) < 0.6
    cols["used"] = live
    cols["key_hi"] = np.where(live, rng.integers(1, 1 << 40, n), 0)
    cols["key_lo"] = np.where(live, rng.integers(1, 1 << 40, n), 0)
    cols["algo"] = (rng.random(n) < 0.3).astype(np.int8)
    cols["status"] = np.zeros(n, np.int8)
    cols["limit"] = rng.integers(1, 50, n)
    cols["duration"] = np.full(n, 60_000)
    cols["remaining"] = rng.integers(0, 50, n)
    cols["stamp"] = np.full(n, NOW - 1000)
    cols["expire_at"] = np.where(rng.random(n) < 0.8, NOW + 30_000, NOW - 1)
    cols["burst"] = cols["limit"]
    cols["lru"] = rng.integers(NOW - 5000, NOW, n)
    return SlotTable(**cols)


def _flush_batch(rng, data_rows, groups, page_map, gpp, widths):
    """Waves of the given widths, each of distinct groups (paged: groups
    of resident and non-resident pages), one after another in one batch;
    some lanes hit live keys of the table."""
    waves = []
    for b in widths:
        wb = RequestBatch.zeros(b)
        g = rng.permutation(groups)[:b]
        wb.group[:] = g
        wb.key_hi[:] = rng.integers(1, 1 << 40, b)
        wb.key_lo[:] = rng.integers(1, 1 << 40, b)
        wb.algo[:] = (rng.random(b) < 0.3).astype(np.int8)
        wb.behavior[:] = rng.choice([0, 0, 8, 32], b)
        wb.hits[:] = rng.choice([0, 1, 2, 40], b)
        wb.limit[:] = rng.integers(1, 50, b)
        wb.duration[:] = 60_000
        wb.rate_num[:] = 60_000
        wb.eff_duration[:] = 60_000
        wb.burst[:] = wb.limit
        wb.created_at[:] = NOW
        wb.active[:] = rng.random(b) < 0.9
        waves.append(wb)
    spans, off = [], 0
    for b in widths:
        spans.append((off, b))
        off += b
    hb = RequestBatch(*(np.concatenate(c) for c in zip(*waves)))
    return batch_to_device(hb, "cpu"), spans


FLUSH_CASES = [(lay, paged, shards) for lay in ("fused", "narrow") for paged in (False, True)
               for shards in (0, 2)]


@pytest.mark.parametrize("layout,paged,shards", FLUSH_CASES)
def test_flush_args_through_lane_code_match_plain(layout, paged, shards):
    """The argument structs a card's launch gets (`WaveFlush.args`: each
    wave's span of the batch columns and outputs, its sums row and the
    next row, the page map, the shard geometry), run through the wave or
    sharded kernel's lane code (g++), leave the same outputs, sums and
    table as the plain version through the same flush layout."""
    rng = np.random.default_rng(5)
    data, pm, groups, gpp = _tables(layout, paged, rng)
    if paged:
        groups = 8 * gpp  # the logical keyspace of the 8 pages
    db, spans = _flush_batch(rng, data, groups, pm, gpp, (40, 7, 0, 64, 1))
    kdata, pdata = data.clone(), data.clone()
    memo_k, memo_p = cuda_decide.TableMemo(), cuda_decide.TableMemo()
    fk = cuda_decide.WaveFlush(db, spans, memo_k)
    fp = cuda_decide.WaveFlush(db, spans, memo_p)
    for w in range(len(spans)):
        now = NOW + 10 * w
        if spans[w][1]:
            cuda_decide.flush_lane_code_on_host(fk, w, kdata, pm, now, layout=layout, ways=8,
                                                gpp=gpp, n_shards=shards)
        fp.launch(w, pdata, pm, now, layout=layout, ways=8, gpp=gpp, n_shards=shards)
    assert torch.equal(kdata, pdata)
    for f in ("status", "limit", "remaining", "reset_time", "slot", "evicted_hi", "evicted_lo",
              "sums"):
        assert torch.equal(getattr(fk, f), getattr(fp, f)), f
    dt = torch.int32 if shards else torch.bool
    assert torch.equal(fk.freed(dt), fp.freed(dt))
    fk.read_back()
    fp.read_back()
    for hk, hp in zip(fk.host(), fp.host()):
        assert all(np.array_equal(a, b) for a, b in zip(hk[:4], hp[:4])) and hk[4:] == hp[4:]
    assert int(fp.sums[len(spans)].abs().sum()) == 0  # the last wave's next row: zero


@pytest.mark.parametrize("layout,paged,shards", FLUSH_CASES)
def test_one_wave_flush_outputs_match_the_wrapper(layout, paged, shards):
    """What the one-wave wrappers return on the card: a flush of one
    wave (`spans=None`) launched with the card's argument struct, run
    through the lane code (g++), its outputs viewed back
    (`WaveFlush.wave_outputs`) as the wrapper's (DecideOutput,
    WaveScan): equal to the plain wrapper's, field by field and in the
    table."""
    rng = np.random.default_rng(6)
    data, pm, groups, gpp = _tables(layout, paged, rng)
    if paged:
        groups = 8 * gpp
    db, _ = _flush_batch(rng, data, groups, pm, gpp, (48,))
    kdata, pdata = data.clone(), data.clone()
    fl = cuda_decide.WaveFlush(db, None, cuda_decide.TableMemo())
    assert fl.spans == [(0, 48)]
    cuda_decide.flush_lane_code_on_host(fl, 0, kdata, pm, NOW, layout=layout, ways=8,
                                        gpp=gpp, n_shards=shards)
    dt = torch.int32 if shards else torch.bool
    kout, kscan = fl.wave_outputs(0, dt)
    if shards:
        pout, pscan = cuda_decide.decide_sharded(pdata, pm, db, NOW, layout=layout, ways=8,
                                                 n_shards=shards, gpp=gpp)
    else:
        pout, pscan = cuda_decide._wave(pdata, pm, db, NOW, layout=layout, ways=8, gpp=gpp)
    assert torch.equal(kdata, pdata)
    for f in pout._fields:
        assert torch.equal(getattr(kout, f), getattr(pout, f).to(getattr(kout, f).dtype)), f
    for a, b in zip(kscan, pscan):
        assert int(a) == int(b)


def test_table_memo_checks_once_and_on_identity_change():
    memo = cuda_decide.TableMemo()
    t = fused.FusedTable.create(64, 8, "cpu").data
    memo.check(t, None, layout="fused", ways=8, gpp=0, n_shards=0)
    key = memo.key
    memo.check(t, None, layout="fused", ways=8, gpp=0, n_shards=0)
    assert memo.key is key
    with pytest.raises(ValueError, match="multiple of ways"):
        memo.check(t, None, layout="fused", ways=7, gpp=0, n_shards=0)
    with pytest.raises(ValueError, match=r"\(N, 9\)"):
        memo.check(t, None, layout="narrow", ways=8, gpp=0, n_shards=0)
    with pytest.raises(ValueError, match="shards"):
        memo.check(t, None, layout="fused", ways=8, gpp=0, n_shards=3)
    memo.check(t, None, layout="fused", ways=8, gpp=0, n_shards=2)
    assert memo.groups_per_shard == 32


def test_wave_flush_refuses_bad_spans_and_devices():
    hb = RequestBatch.zeros(8)
    db = batch_to_device(hb, "cpu")
    with pytest.raises(ValueError, match="outside"):
        cuda_decide.WaveFlush(db, [(4, 8)], cuda_decide.TableMemo())
    fl = cuda_decide.WaveFlush(db, [(0, 8)], cuda_decide.TableMemo())
    with pytest.raises(RuntimeError, match="read_back"):
        fl.host()
