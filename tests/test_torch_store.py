"""The port's Store and Loader seams against the JAX package's.

`gubernator_tpu_torch.store` and the engine's store path (read-through,
write-behind, `inject_snapshots`, `snapshot`) run the JAX suite's own
cases (tests/test_store.py, and the merge fuzz of tests/test_store_fuzz.py)
once through the JAX package and once through the port on the CPU, on
one frozen clock, for the fused and narrow layouts, flat and paged.
Each case's trace (every answer, the store's entries and its get and
change counts where the JAX case looks at them, the final wide table
with its key strings) must be equal. Tolerance: none (int64).

The JAX engines are built once per configuration and emptied before
each case (`restore` of an empty snapshot); the port builds fresh
engines, so a "restart" is a second engine on the port side and the
emptied engine on the JAX side. The store module's own classes are held
against the JAX package's too.
"""

import dataclasses
import random

import numpy as np
import pytest

import gubernator_tpu.store.store as jst
from gubernator_tpu.api.types import RateLimitReq as JReq
from gubernator_tpu.runtime.engine import DeviceEngine as JEngine
from gubernator_tpu.runtime.engine import EngineConfig as JConfig
import gubernator_tpu_torch.store.store as pst
from gubernator_tpu_torch.api.keys import group_of, key_hash128
from gubernator_tpu_torch.api.types import RateLimitReq
from gubernator_tpu_torch.runtime.engine import DeviceEngine, EngineConfig

NOW = 1_753_700_000_000
TOKEN, LEAKY = 0, 1
RESET, DRAIN = 8, 32  # Behavior.RESET_REMAINING, DRAIN_OVER_LIMIT
FIXED_SHIFT = 20

# "wide": the suites' 1,024 groups of 8 ways; "direct": their direct-mapped
# 4 groups of 1 way, where keys of one group evict each other; "edge":
# wide, for calls whose waves spread over every page. Paged: 8 logical
# pages of 128 groups with 4 frames (edge: 8), and 2 pages of 2 groups
# with 1 frame.
GEOMS = {
    "wide": (dict(num_groups=1 << 10, batch_size=32), dict(page_groups=128, page_budget=4)),
    "direct": (dict(num_groups=4, ways=1, batch_size=8), dict(page_groups=2, page_budget=1)),
    "edge": (dict(num_groups=1 << 10, batch_size=32), dict(page_groups=128, page_budget=8)),
}
VARIANTS = [("fused", False), ("narrow", False), ("fused", True), ("narrow", True)]
VARIANT_IDS = ["fused", "narrow", "fused-paged", "narrow-paged"]


class Clock:
    def __init__(self):
        self.ms = NOW

    def __call__(self):
        return self.ms


def engine_kwargs(geom, layout, paged):
    base, paging = GEOMS[geom]
    kw = dict(base, layout=layout, batch_wait_s=0.001)
    if paged:
        kw.update(paging, page_demote_interval_s=0)
    return kw


class JaxEngines:
    """One JAX DeviceEngine per (geometry, layout, paged), built on first
    use on the shared clock and emptied for each case."""

    def __init__(self, clock):
        self.clock = clock
        self._engines = {}

    def get(self, geom, layout, paged):
        key = (geom, layout, paged)
        if key not in self._engines:
            eng = JEngine(JConfig(**engine_kwargs(geom, layout, paged)), now_fn=self.clock)
            self._engines[key] = (eng, eng.snapshot())
        eng, empty = self._engines[key]
        eng.store = None
        eng.restore(empty)
        return eng

    def close(self):
        for eng, _ in self._engines.values():
            eng.close()


@pytest.fixture(scope="module")
def jax_engines():
    clock = Clock()
    je = JaxEngines(clock)
    try:
        yield je
    finally:
        je.close()


class Side:
    """One package's run of a case: its request and store classes and
    fresh (or emptied) engines of one configuration on the shared clock.
    Every step appends to `trace`."""

    def __init__(self, port: bool, geom, layout, paged, jax_engines):
        self.port = port
        self.geom, self.layout, self.paged = geom, layout, paged
        self.st = pst if port else jst
        self.Req = RateLimitReq if port else JReq
        self._jax = jax_engines
        self.clock = jax_engines.clock
        self.clock.ms = NOW
        self._open = []
        self.trace = []

    def engine(self):
        if self.port:
            eng = DeviceEngine(EngineConfig(device="cpu", **engine_kwargs(
                self.geom, self.layout, self.paged)), now_fn=self.clock)
            self._open.append(eng)
            return eng
        return self._jax.get(self.geom, self.layout, self.paged)

    def close(self):
        for eng in self._open:
            eng.close()

    def store(self, cls=None):
        return (cls or self.st.MemoryStore)()

    def snap(self, **kw):
        return self.st.ItemSnapshot(**kw)

    def req(self, key="k", name="t", **kw):
        kw.setdefault("duration", 60_000)
        kw.setdefault("limit", 10)
        kw.setdefault("hits", 1)
        return self.Req(name=name, unique_key=key, **kw)

    def check(self, eng, reqs):
        """Serve `reqs` as one batch; trace and return the answers."""
        out = [(r.status, r.limit, r.remaining, r.reset_time, r.error)
               for r in eng.check_batch([dataclasses.replace(r) for r in reqs])]
        self.trace.append(("answers", out))
        return out

    def note(self, *what):
        self.trace.append(what)

    def note_store(self, store):
        with store.lock:
            data = {k: dataclasses.astuple(v) for k, v in store.data.items()}
            self.trace.append(("store", data, store.get_calls, store.change_calls))

    def note_table(self, eng):
        snap = eng.snapshot()
        self.trace.append(("table", {f: (np.asarray(a).tobytes() if f != "key_strings" else a)
                                     for f, a in snap.items()}))

    def evictions(self, eng) -> int:
        return eng.stats()["unexpired_evictions"] if self.port else eng.metrics.unexpired_evictions


def run_both(case, geom, layout, paged, jax_engines, **kw):
    """The case through the JAX package, then the port; their traces
    must be equal. Returns the port's trace."""
    traces = []
    for port in (False, True):
        side = Side(port, geom, layout, paged, jax_engines)
        try:
            case(side, **kw)
        finally:
            side.close()
        traces.append(side.trace)
    jt, pt = traces
    assert len(pt) == len(jt)
    for i, (a, b) in enumerate(zip(jt, pt)):
        assert a == b, (i, a[0])
    return pt


# ---------------------------------------------------------------------------
# tests/test_store.py (reference store_test.go:76-127)


def case_loader_roundtrip(s):
    eng = s.engine()
    s.check(eng, [s.req("a", hits=3), s.req("b", hits=7, algorithm=LEAKY)])
    loader = s.st.MemoryLoader()
    n = s.st.save_engine(eng, loader)
    s.note("saved", n, loader.called_save, [dataclasses.astuple(i) for i in loader.items])
    s.clock.ms = NOW + 10
    eng2 = s.engine()
    s.note("loaded", s.st.load_engine(eng2, loader), loader.called_load)
    a = s.check(eng2, [s.req("a", hits=0)])
    b = s.check(eng2, [s.req("b", hits=0, algorithm=LEAKY)])
    assert (a[0][2], b[0][2]) == (7, 3)
    s.note_table(eng2)


def case_leaky_fraction(s):
    eng = s.engine()
    s.check(eng, [s.req("frac", algorithm=LEAKY, hits=3)])
    s.clock.ms = NOW + 4500  # leaks 1.5 tokens at 3 s a token
    s.check(eng, [s.req("frac", algorithm=LEAKY, hits=0, duration=30_000)])
    loader = s.st.MemoryLoader()
    s.st.save_engine(eng, loader)
    item = next(i for i in loader.items if i.key == "t_frac")
    assert item.remaining == (8 << FIXED_SHIFT) + (1 << (FIXED_SHIFT - 1))
    s.note("item", dataclasses.astuple(item))
    s.note_table(eng)


def case_write_behind_and_remove(s):
    eng = s.engine()
    store = s.store()
    s.st.attach_store(eng, store)
    s.check(eng, [s.req("w", hits=4)])
    assert store.data["t_w"].remaining == 6
    s.note_store(store)
    s.check(eng, [s.req("w", hits=1)])
    s.note_store(store)
    s.check(eng, [s.req("w", hits=0, behavior=RESET)])  # frees the slot: a remove
    assert "t_w" not in store.data
    s.note_store(store)
    s.note_table(eng)


def case_read_through(s):
    store = s.store()
    store.data["t_r"] = s.snap(key="t_r", algorithm=TOKEN, limit=10, duration=60_000,
                               remaining=2, stamp=NOW - 1000, expire_at=NOW + 59_000)
    eng = s.engine()
    s.st.attach_store(eng, store)
    got = s.check(eng, [s.req("r", hits=1)])
    assert got[0][0] == 0 and got[0][2] == 1  # continues from the stored 2
    s.note_store(store)
    s.note_table(eng)


def case_invalid_at_forces_refetch(s):
    store = s.store()
    store.data["t_i"] = s.snap(key="t_i", algorithm=TOKEN, limit=10, duration=60_000,
                               remaining=5, stamp=NOW, expire_at=NOW + 60_000,
                               invalid_at=NOW + 100)
    eng = s.engine()
    s.st.attach_store(eng, store)
    s.check(eng, [s.req("i", hits=1)])
    store.data["t_i"] = s.snap(key="t_i", algorithm=TOKEN, limit=10, duration=60_000,
                               remaining=2, stamp=NOW, expire_at=NOW + 60_000)
    gets = store.get_calls
    s.clock.ms = NOW + 500
    got = s.check(eng, [s.req("i", hits=1)])
    assert store.get_calls > gets and got[0][2] == 1
    s.note_store(store)
    s.note_table(eng)


def _pair_in_one_group(num_groups, prefix="g", name="t"):
    by_group = {}
    for i in range(100_000):
        k = f"{prefix}{i}"
        g = group_of(key_hash128(f"{name}_{k}")[1], num_groups)
        if g in by_group:
            return by_group[g], k
        by_group[g] = k
    raise AssertionError("no pair")


def case_reset_then_reuse_same_flush(s):
    ka, kb = _pair_in_one_group(1 << 10)
    store = s.store()
    eng = s.engine()
    s.st.attach_store(eng, store)
    s.check(eng, [s.req(ka, hits=2)])
    s.check(eng, [s.req(ka, hits=0, behavior=RESET), s.req(kb, hits=3)])
    assert f"t_{ka}" not in store.data and store.data[f"t_{kb}"].remaining == 7
    s.note_store(store)
    s.note_table(eng)


STORE_CASES = [case_loader_roundtrip, case_leaky_fraction, case_write_behind_and_remove,
               case_read_through, case_invalid_at_forces_refetch,
               case_reset_then_reuse_same_flush]


@pytest.mark.parametrize("layout,paged", VARIANTS, ids=VARIANT_IDS)
@pytest.mark.parametrize("case", STORE_CASES, ids=lambda c: c.__name__[5:])
def test_store_case_matches_jax(case, layout, paged, jax_engines):
    run_both(case, "wide", layout, paged, jax_engines)


# ---------------------------------------------------------------------------
# merge_snapshots_lww order independence (tests/test_store_fuzz.py)


def _keys_on_pages(n, num_groups, max_group, prefix="lww", name=None):
    """n keys whose groups lie below max_group (the paged variant's
    first pages: a merge batch then fits the frames)."""
    out, i = [], 0
    while len(out) < n:
        k = f"{prefix}{i}"
        i += 1
        if group_of(key_hash128(name + k if name else k)[1], num_groups) < max_group:
            out.append(k)
    return out


def case_merge_lww_shuffle(s, seed):
    rng = random.Random(seed)
    keys = _keys_on_pages(10, 1 << 10, 512)
    snaps = []
    for _ in range(60):
        k = rng.choice(keys)
        stamp = NOW + rng.choice([0, 0, 1000, 2000])  # many stamp ties
        snaps.append(s.snap(key=k, algorithm=TOKEN, limit=100, duration=600_000,
                            remaining=rng.randrange(0, 101), stamp=stamp,
                            expire_at=stamp + 600_000))
    want = {}
    for sn in snaps:
        cur = want.get(sn.key)
        if cur is None or (sn.stamp, -sn.remaining) > (cur.stamp, -cur.remaining):
            want[sn.key] = sn
    states = []
    for _trial in range(3):
        order = snaps[:]
        rng.shuffle(order)
        eng = s.engine()
        i = 0
        while i < len(order):
            n = rng.randrange(1, 9)
            s.note("merged", s.st.merge_snapshots_lww(eng, order[i:i + n]))
            i += n
        states.append({sn.key: (sn.stamp, sn.remaining)
                       for sn in s.st.snapshots_from_engine(eng)})
        s.note_table(eng)
    assert states[0] == states[1] == states[2]
    assert states[0] == {k: (sn.stamp, sn.remaining) for k, sn in want.items()}


@pytest.mark.parametrize("layout,paged", VARIANTS, ids=VARIANT_IDS)
@pytest.mark.parametrize("seed", [3, 11, 42])
def test_merge_snapshots_lww_shuffle_matches_jax(seed, layout, paged, jax_engines):
    run_both(case_merge_lww_shuffle, "wide", layout, paged, jax_engines, seed=seed)


# ---------------------------------------------------------------------------
# the store module alone


def test_memory_store_and_loader_match_jax():
    """MemoryStore hands out copies and counts gets and change calls;
    MemoryLoader counts its loads and saves; ItemSnapshot has the JAX
    package's fields and defaults."""
    assert [(f.name, f.default) for f in dataclasses.fields(pst.ItemSnapshot)] == [
        (f.name, f.default) for f in dataclasses.fields(jst.ItemSnapshot)]
    out = []
    for m, Req in ((jst, JReq), (pst, RateLimitReq)):
        st = m.MemoryStore()
        st.on_change([m.ItemSnapshot(key="t_a", remaining=3), m.ItemSnapshot(key="t_b")])
        got = st.get(Req(name="t", unique_key="a"))
        got.remaining = 99  # a copy: the store keeps 3
        miss = st.get(Req(name="t", unique_key="zz"))
        st.remove("t_b")
        st.remove("t_none")
        ld = m.MemoryLoader([m.ItemSnapshot(key="x")])
        items = ld.load()
        ld.save([m.ItemSnapshot(key="y", limit=5)])
        out.append((
            {k: dataclasses.astuple(v) for k, v in st.data.items()}, miss, st.get_calls,
            st.change_calls, [dataclasses.astuple(i) for i in items],
            [dataclasses.astuple(i) for i in ld.items], ld.called_load, ld.called_save,
        ))
    assert out[0] == out[1]
    assert out[1][0]["t_a"][5] == 3


def test_inject_snapshots_keeps_group_order_past_the_batch():
    """More snapshots than one wave holds, several per group and
    duplicate keys (the last one wins): the table equals the JAX
    engine's, whose first-fit assembler places the same per-group
    order in other waves."""
    clock = Clock()
    kw = dict(num_groups=16, batch_size=8, batch_wait_s=0.001)
    rng = np.random.default_rng(5)
    items = [dict(key=f"t_s{int(k)}", algorithm=int(k % 2), limit=int(10 + k),
                  duration=60_000, remaining=int(rng.integers(0, 10)),
                  stamp=NOW - int(k), expire_at=NOW + 60_000, burst=int(k % 2) * 10)
             for k in rng.integers(0, 90, 120)]
    jeng = JEngine(JConfig(**kw), now_fn=clock)
    peng = DeviceEngine(EngineConfig(device="cpu", **kw), now_fn=clock)
    try:
        jeng.inject_snapshots([jst.ItemSnapshot(**d) for d in items])
        peng.inject_snapshots([pst.ItemSnapshot(**d) for d in items])
        js, ps = jeng.snapshot(), peng.snapshot()
        for f in js:
            if f == "key_strings":
                assert ps[f] == js[f]
            else:
                assert np.array_equal(ps[f], js[f]), f
        st = peng.stats()
        assert st["injected_rows"] == 120 and st["inject_waves"] >= 120 // 8
    finally:
        jeng.close()
        peng.close()
