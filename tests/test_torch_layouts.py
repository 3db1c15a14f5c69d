"""The port's wide and packed layouts against the JAX package's, op by op.

`gubernator_tpu_torch.ops.decide` (the wide table's `decide`,
`decide_scan`, `probe_exists`, `gather_rows`), `ops.inject.inject` (the
wide inject) and `ops.packed` (the whole packed module), through the
registry (`ops.kernels.get_kernels`) and the paged facade
(`ops.paged.make_paged_kernels`), against `gubernator_tpu.ops.kernels.
get_kernels` / `ops.paged.make_paged_kernels` of the same layout (XLA
programs in the JAX package under any GUBER_KERNEL). The same seeded
numpy inputs go through both: 64 groups of 8 ways, waves of 64 lanes
from tests/test_torch_decide.py `fuzz_wave` (negative and zero limits
and hits, Gregorian lanes, RESET_REMAINING and DRAIN_OVER_LIMIT,
evictions); the paged table of tests/test_torch_paged.py (16 logical
pages over 8 frames in a scrambled order, so about half of the lanes
of every wave sit on pages that are not resident and take the JAX XLA
branch's sentinel group), with a page moved to another frame between
waves. Compared: every DecideOutput field, the evicted keys, the
probes, the gathered rows and the whole table in wide form, after every
step. Tolerance: none (int64).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gubernator_tpu.ops.inject import InjectBatch as JInjectBatch
from gubernator_tpu.ops.kernels import get_kernels as jget_kernels
from gubernator_tpu.ops.layout import SlotTable as JSlotTable
from gubernator_tpu.ops.paged import make_paged_kernels as jmake_paged
from gubernator_tpu_torch.ops import cuda_decide, paged
from gubernator_tpu_torch.ops.inject import InjectBatch
from gubernator_tpu_torch.ops.kernels import BYTES_PER_SLOT, LAYOUTS, Kernels, get_kernels
from gubernator_tpu_torch.ops.layout import SLOT_DTYPES, SlotTable, stack_batches
from test_torch_census import random_wide
from test_torch_decide import NOW, OUT_FIELDS, WAYS, assert_out_equal, fuzz_wave, to_jax, to_torch
from test_torch_paged import GPP, NPP, NUM_GROUPS as PAGED_GROUPS, SCRAMBLE, paged_waves

GROUPS = 64
TORCH_OP_LAYOUTS = ("wide", "packed")


def jax_table(layout, wide):
    """The JAX layout's table of a host wide image."""
    jw = JSlotTable(**{f: jnp.asarray(getattr(wide, f)) for f in SlotTable._fields})
    return jw if layout == "wide" else jget_kernels(layout).from_wide(jw)


def assert_wide_equal(port_wide, jax_wide, tag):
    for f in SlotTable._fields:
        a, r = getattr(port_wide, f).numpy(), np.asarray(getattr(jax_wide, f))
        assert a.dtype == r.dtype, (tag, f, a.dtype, r.dtype)
        assert np.array_equal(a, r), f"{tag}: column {f} diverged"


def assert_tables_equal(layout, pt, jt, tag):
    assert_wide_equal(get_kernels(layout).to_wide(pt), jget_kernels(layout).to_wide(jt), tag)


def waves(seed, steps, num_groups=GROUPS):
    rng = np.random.default_rng(seed)
    now, out = NOW, []
    for _ in range(steps):
        now += int(rng.choice([0, 1, 40, 700, 5000, 70_000], p=[.2, .2, .2, .2, .15, .05]))
        out.append((fuzz_wave(rng, now, num_groups), now))
    return out


def test_registry_lists_the_four_layouts():
    """LAYOUTS and BYTES_PER_SLOT are the JAX package's; every layout
    fills every field of Kernels."""
    from gubernator_tpu.ops import kernels as jkernels

    assert LAYOUTS == jkernels.LAYOUTS == ("wide", "packed", "fused", "narrow")
    assert BYTES_PER_SLOT == jkernels.BYTES_PER_SLOT
    for layout in LAYOUTS:
        K = get_kernels(layout)
        assert K.layout == layout
        assert all(v is not None for v in K), layout
        assert set(K._fields) == set(Kernels._fields)


@pytest.mark.parametrize("layout", TORCH_OP_LAYOUTS)
def test_create_and_round_trips_match_jax(layout):
    """create gives the JAX layout's zeroed columns (names, dtypes,
    lengths); from_wide / to_wide round-trip a seeded wide image and
    equal JAX's pack and unpack; from_wide copies (a decide never writes
    into the caller's arrays)."""
    K, JK = get_kernels(layout), jget_kernels(layout)
    t, jt = K.create(GROUPS, WAYS, "cpu"), JK.create(GROUPS, WAYS)
    assert type(t)._fields == type(jt)._fields
    for a, r in zip(t, jt):
        assert a.numpy().dtype == np.asarray(r).dtype and a.shape == r.shape
        assert not a.any()
    wide = random_wide(np.random.default_rng(5), groups=GROUPS, density=0.7)
    pt = K.from_wide(wide, "cpu")
    assert_tables_equal(layout, pt, jax_table(layout, wide), "pack")
    assert_wide_equal(K.to_wide(pt), wide._replace(**{f: np.asarray(getattr(wide, f),
                                                                     SLOT_DTYPES[f])
                                                      for f in SlotTable._fields}), "round trip")
    before = {f: np.array(getattr(wide, f)) for f in SlotTable._fields}
    K.decide(pt, to_torch(waves(6, 1)[0][0]), NOW, WAYS)
    assert all(np.array_equal(getattr(wide, f), before[f]) for f in SlotTable._fields)


@pytest.mark.parametrize("layout", TORCH_OP_LAYOUTS)
@pytest.mark.parametrize("seed", [1, 2])
def test_decide_matches_jax(layout, seed):
    """decide, wave after wave from an empty table: every output field
    and the whole table; no hand kernel launched."""
    K, JK = get_kernels(layout), jget_kernels(layout)
    pt, jt = K.create(GROUPS, WAYS, "cpu"), JK.create(GROUPS, WAYS)
    before = sum(cuda_decide.CONFIG_LAUNCHES.values())
    for step, (w, now) in enumerate(waves(seed, 10)):
        pt, po = K.decide(pt, to_torch(w), now, WAYS)
        jt, jo = JK.decide(jt, to_jax(w), jnp.int64(now), WAYS)
        tag = f"{layout}/seed{seed}/step{step}"
        assert_out_equal(po, jo, tag)
        assert_tables_equal(layout, pt, jt, tag)
    assert sum(cuda_decide.CONFIG_LAUNCHES.values()) == before


@pytest.mark.parametrize("layout", TORCH_OP_LAYOUTS)
def test_decide_scan_matches_jax(layout):
    """decide_scan of 6 stacked waves from a seeded image: the (T, B)
    outputs, the (T,) sums and the table; a scan of no step."""
    K, JK = get_kernels(layout), jget_kernels(layout)
    wide = random_wide(np.random.default_rng(3), groups=GROUPS, density=0.5)
    pt, jt = K.from_wide(wide, "cpu"), jax_table(layout, wide)
    ws = waves(4, 6)
    batches = stack_batches([w for w, _ in ws])
    nows = np.array([n for _, n in ws], np.int64)
    pt, po = K.decide_scan(pt, to_torch(batches), torch.from_numpy(nows), WAYS)
    jt, jo = JK.decide_scan(jt, to_jax(batches), jnp.asarray(nows), WAYS)
    assert_out_equal(po, jo, layout)
    assert_tables_equal(layout, pt, jt, layout)
    empty = stack_batches([w for w, _ in ws])
    empty = type(empty)(*(c[:0] for c in empty))
    _, eo = K.decide_scan(pt, to_torch(empty), torch.zeros(0, dtype=torch.int64), WAYS)
    assert eo.status.shape == (0, 64) and eo.hits.shape == (0,)


def _inject_items(rng, wide, n=48):
    """Items of distinct groups: a third rewrite live keys of the image
    (a match), the rest new keys (inserts, some over live rows); some
    lanes inactive."""
    groups = rng.choice(GROUPS, n, replace=False)
    items = InjectBatch.zeros(n)
    used = np.flatnonzero(wide.used)
    for j, g in enumerate(groups.tolist()):
        mine = used[(used >= g * WAYS) & (used < (g + 1) * WAYS)]
        if j % 3 == 0 and len(mine):
            s = int(mine[0])
            items.key_hi[j], items.key_lo[j] = wide.key_hi[s], wide.key_lo[s]
        else:
            items.key_hi[j], items.key_lo[j] = rng.integers(1, 1 << 40, 2)
    items.group[:] = groups
    items.algo[:] = rng.integers(0, 2, n)
    items.status[:] = rng.integers(0, 2, n)
    items.limit[:] = rng.choice([1, 10, 1000], n)
    items.duration[:] = rng.choice([1_000, 60_000], n)
    items.remaining[:] = rng.integers(0, 1000, n)
    items.stamp[:] = NOW - rng.integers(0, 5000, n)
    items.expire_at[:] = NOW + rng.integers(-100, 60_000, n)
    items.invalid_at[:] = np.where(rng.random(n) < 0.2, NOW + 50, 0)
    items.burst[:] = rng.integers(0, 1000, n)
    items.active[:] = rng.random(n) < 0.85
    return items


def _jax_items(items):
    return JInjectBatch(*(jnp.asarray(c) for c in items))


@pytest.mark.parametrize("layout", TORCH_OP_LAYOUTS)
def test_inject_probe_gather_match_jax(layout):
    """inject (match, insert over empty, expired and live rows),
    probe_exists (live, expired, invalidated and absent keys) and
    gather_rows (slot N reads zeros) on a seeded image."""
    rng = np.random.default_rng(7)
    K, JK = get_kernels(layout), jget_kernels(layout)
    wide = random_wide(rng, groups=GROUPS, density=0.8)
    wide = wide._replace(invalid_at=np.where(rng.random(GROUPS * WAYS) < 0.1, NOW - 5, 0))
    pt, jt = K.from_wide(wide, "cpu"), jax_table(layout, wide)
    items = _inject_items(rng, wide)
    pt, ehi, elo = K.inject(pt, items.to_device("cpu"), NOW, WAYS)
    jt, jehi, jelo = JK.inject(jt, _jax_items(items), jnp.int64(NOW), WAYS)
    assert np.array_equal(ehi.numpy(), np.asarray(jehi))
    assert np.array_equal(elo.numpy(), np.asarray(jelo))
    assert (ehi != 0).any()  # live rows were displaced
    assert_tables_equal(layout, pt, jt, "inject")
    # probes: every slot's key at its own group, then keys of no row
    n = GROUPS * WAYS
    cur = K.to_wide(pt)
    grp = (np.arange(n) // WAYS).astype(np.int32)
    for hi, lo in ((cur.key_hi.numpy(), cur.key_lo.numpy()),
                   (rng.integers(1, 1 << 40, n), rng.integers(1, 1 << 40, n))):
        for now in (NOW, NOW + 3_000_000):
            got = K.probe_exists(pt, torch.from_numpy(hi), torch.from_numpy(lo),
                                 torch.from_numpy(grp), now, WAYS)
            want = JK.probe_exists(jt, jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(grp),
                                   jnp.int64(now), WAYS)
            assert np.array_equal(got.numpy(), np.asarray(want)), now
    assert got.dtype == torch.bool
    slots = np.array([0, 5, n - 1, n, 17, n + 3], np.int64)
    assert_wide_equal(K.gather_rows(pt, torch.from_numpy(slots)),
                      JK.gather_rows(jt, jnp.asarray(slots)), "gather")


def _paged_pair(layout):
    PK = paged.make_paged_kernels(layout, PAGED_GROUPS, WAYS, GPP, NPP, "cpu")
    JPK = jmake_paged(layout, PAGED_GROUPS, WAYS, GPP, NPP)
    pt, jpt = PK.create(), JPK.create()
    for lp, pp in SCRAMBLE.items():
        pt = PK.bind_page(pt, lp, pp)
        jpt = JPK.bind_page(jpt, lp, pp)
    return PK, pt, JPK, jpt


def _assert_paged_equal(layout, PK, pt, JPK, jpt, tag):
    assert np.array_equal(pt.page_map.numpy(), np.asarray(jpt.page_map)), f"{tag}: page_map"
    assert_wide_equal(PK.to_wide(pt), JPK.to_wide(jpt), tag)


@pytest.mark.parametrize("layout", TORCH_OP_LAYOUTS)
def test_paged_decide_with_page_move_matches_jax(layout):
    """The paged facade over the scrambled map: waves with lanes on pages
    that are not resident (the JAX XLA branch's sentinel group: gathers
    clamp, writes drop) match every output field; a resident page moves
    to a free frame (read_page, unbind, write_page at the new frame:
    positional, the JAX extract and write) and the waves go on equal."""
    PK, pt, JPK, jpt = _paged_pair(layout)
    steps = paged_waves(31, 6)
    for step, (w, now) in enumerate(steps[:4]):
        pt, po = PK.decide(pt, to_torch(w), now)
        jpt, jo = JPK.decide(jpt, to_jax(w), jnp.int64(now))
        assert_out_equal(po, jo, f"{layout}/step{step}")
        _assert_paged_equal(layout, PK, pt, JPK, jpt, f"{layout}/step{step}")
    # move logical page 2 from frame 1 to a freed frame 4 (page 14's)
    for lp, old, new in ((14, 4, None), (2, 1, 4)):
        rows = PK.read_page(pt, old)
        jrows = JPK.extract_page(jpt, old)
        assert_wide_equal(SlotTable(*(torch.from_numpy(rows[f]) for f in SlotTable._fields)),
                          jrows, f"read_page {lp}")
        pt = PK.unbind_page(pt, lp, old)
        jpt = JPK.unbind_page(jpt, lp, old)
        if new is not None:
            pt = PK.write_page(pt, lp, new, SlotTable(**rows))
            jpt = JPK.write_page(jpt, lp, new, jrows)
    assert np.asarray(PK.to_wide(pt).used)[4 * GPP * WAYS:5 * GPP * WAYS].any()
    _assert_paged_equal(layout, PK, pt, JPK, jpt, "after the move")
    for step, (w, now) in enumerate(steps[4:6]):
        pt, po = PK.decide(pt, to_torch(w), now)
        jpt, jo = JPK.decide(jpt, to_jax(w), jnp.int64(now))
        assert_out_equal(po, jo, f"{layout}/moved step{step}")
    _assert_paged_equal(layout, PK, pt, JPK, jpt, "moved")
    w, _now = steps[-1]
    resident = set(np.flatnonzero(pt.page_map.numpy() >= 0).tolist())
    assert set((w.group[w.active] // GPP).tolist()) - resident  # sentinel lanes ran


def test_torch_op_wave_writes_the_flush():
    """A torch-op layout's run_wave (the engine's launch seam) runs its
    decide on the flush's wave batch and writes the flush's outputs:
    equal to its one-wave decide, the WaveScan sums left zero."""
    from gubernator_tpu_torch.ops.layout import batch_to_device

    ws = waves(9, 2)
    hb = stack_batches([w for w, _ in ws])
    hb = type(hb)(*(c.reshape(-1) for c in hb))
    for layout in TORCH_OP_LAYOUTS:
        K = get_kernels(layout)
        t1, t2 = K.create(GROUPS, WAYS, "cpu"), K.create(GROUPS, WAYS, "cpu")
        flush = cuda_decide.WaveFlush(batch_to_device(hb, "cpu"), [(0, 64), (64, 64)],
                                      cuda_decide.TableMemo())
        for i, (w, now) in enumerate(ws):
            t1 = K.run_wave(t1, flush, i, now, WAYS)
            t2, o2 = K.decide(t2, to_torch(w), now, WAYS)
            o1, scan = flush.wave_outputs(i)
            for f in OUT_FIELDS:
                assert torch.equal(getattr(o1, f), getattr(o2, f)), (layout, i, f)
            assert all(int(v) == 0 for v in scan)
        assert_wide_equal(K.to_wide(t1), K.to_wide(t2), layout)
