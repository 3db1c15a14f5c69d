"""The port's paged decide and page ops against the JAX package's.

A paged table of 16 logical pages (128 groups, 8 groups per page) over 8
physical frames, bound in a scrambled order, so about half of the lanes
of every wave sit on non-resident pages (sentinel lanes). The same
seeded waves go through:

- the port's plain paged wave (`cuda_decide.decide_paged_with_scan` on a
  CPU table, i.e. `ops/fused.py::wave_plain` with a page map);
- the CUDA kernel's per-lane C++ built by g++, paged, fused and narrow
  (`cuda_decide.decide_lane_code_on_host(page_map=...)`);
- `gubernator_tpu.ops.pallas_decide.decide_paged_with_scan` in its
  reference lowering and, for one small case, in interpret mode, on a
  table built as tests/test_kernel_fuzz.py `_paged_pair` builds it
  (`GUBER_KERNEL=pallas`, `make_paged_kernels`).

The port follows the Pallas kernel's sentinel semantics (zeroed group,
slot == N, no evicted key), so every field is compared. Tolerance: none.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gubernator_tpu.ops import pallas_decide as jpallas
from gubernator_tpu.ops.layout import SlotTable as JSlotTable
from gubernator_tpu.ops.paged import make_paged_kernels as jmake_paged
from gubernator_tpu_torch.ops import cuda_decide, fused, narrow, paged
from gubernator_tpu_torch.ops.layout import SlotTable
from test_torch_decide import (
    NOW,
    OUT_FIELDS,
    WAYS,
    assert_out_equal,
    assert_scan_equal,
    fuzz_wave,
    to_jax,
    to_torch,
)

NUM_GROUPS = 128
GPP = 8  # -> 16 logical pages
NPP = 8  # physical frames
N_PHYS = NPP * GPP * WAYS
# logical page -> frame, scrambled; the other 8 pages are not resident
SCRAMBLE = {0: 3, 2: 1, 3: 7, 5: 0, 8: 5, 9: 2, 12: 6, 14: 4}
_PERM = np.random.default_rng(99).permutation(NUM_GROUPS).astype(np.int32)
_UNPACK = {"fused": fused.unpack_table, "narrow": narrow.unpack_table}


def paged_waves(seed, steps):
    """fuzz_wave's waves with their groups spread over all 16 pages by a
    fixed permutation (a key keeps its group; active groups stay
    distinct)."""
    rng = np.random.default_rng(seed)
    now = NOW
    out = []
    for _ in range(steps):
        now += int(rng.choice([0, 1, 40, 700, 5000, 70_000], p=[.2, .2, .2, .2, .15, .05]))
        w = fuzz_wave(rng, now, NUM_GROUPS)
        w.group[:] = _PERM[w.group]
        out.append((w, now))
    return out


def port_table(layout):
    PK = paged.make_paged_kernels(layout, NUM_GROUPS, WAYS, GPP, NPP, "cpu")
    pt = PK.create()
    for lp, pp in SCRAMBLE.items():
        pt = PK.bind_page(pt, lp, pp)
    return PK, pt


def jax_table(layout, monkeypatch):
    monkeypatch.setenv("GUBER_KERNEL", "pallas")
    PK = jmake_paged(layout, NUM_GROUPS, WAYS, GPP, NPP)
    pt = PK.create()
    for lp, pp in SCRAMBLE.items():
        pt = PK.bind_page(pt, lp, pp)
    return PK, pt


def assert_paged_equal(pt, jpt, layout, tag):
    assert np.array_equal(pt.page_map.numpy(), np.asarray(jpt.page_map)), f"{tag}: page_map"
    assert np.array_equal(pt.data.data.numpy(), np.asarray(jpt.data.data)), f"{tag}: rows"


def _jax_decide(jpt, wave, now, layout):
    return jpallas.decide_paged_with_scan(
        jpt, to_jax(wave), jnp.int64(now), layout=layout, ways=WAYS, gpp=GPP
    )


def _check_lane_code(kpt, wave, now, layout, po, ps, tag):
    """The kernel's lane code on its own copy of the table."""
    _, ko, ks = cuda_decide.decide_lane_code_on_host(
        kpt.data, to_torch(wave), now, ways=WAYS, layout=layout,
        page_map=kpt.page_map, gpp=GPP,
    )
    for f in OUT_FIELDS:
        a, r = getattr(ko, f), getattr(po, f)
        assert a.dtype == r.dtype and torch.equal(a, r), f"{tag}: lane code {f}"
    for f in ps._fields:
        assert int(getattr(ks, f)) == int(getattr(ps, f)), (tag, f)


@pytest.mark.parametrize("seed", [41, 42])
@pytest.mark.parametrize("layout", ["fused", "narrow"])
def test_paged_plain_and_lane_code_match_pallas_reference(layout, seed, monkeypatch):
    """Plain paged wave, kernel lane code and Pallas reference lowering:
    outputs (sentinel slot and evicted keys included), WaveScan sums,
    physical rows and page map after every wave."""
    monkeypatch.setenv("GUBER_PALLAS_INTERPRET", "0")
    _, pt = port_table(layout)
    _, kpt = port_table(layout)
    _, jpt = jax_table(layout, monkeypatch)
    sentinel_lanes = 0
    for step, (wave, now) in enumerate(paged_waves(seed, 8)):
        tag = f"{layout}/seed{seed}/step{step}"
        pt, po, ps = cuda_decide.decide_paged_with_scan(
            pt, to_torch(wave), now, layout=layout, ways=WAYS, gpp=GPP
        )
        _check_lane_code(kpt, wave, now, layout, po, ps, tag)
        jpt, jo, js = _jax_decide(jpt, wave, now, layout)
        assert_out_equal(po, jo, tag)
        assert_scan_equal(ps, js, tag)
        assert_paged_equal(pt, jpt, layout, tag)
        assert torch.equal(kpt.data.data, pt.data.data), f"{tag}: lane code rows"
        sentinel_lanes += int((wave.active & (po.slot.numpy() == N_PHYS)).sum())
    assert sentinel_lanes > 50, "the waves must hit non-resident pages"


def test_paged_matches_pallas_interpret(monkeypatch):
    """One small case through the Pallas kernel body itself (paged,
    narrow, interpret mode), sentinel lanes included."""
    monkeypatch.setenv("GUBER_PALLAS_INTERPRET", "1")
    assert jpallas.pallas_mode() == "interpret"
    _, pt = port_table("narrow")
    _, jpt = jax_table("narrow", monkeypatch)
    for step, (wave, now) in enumerate(paged_waves(43, 2)):
        tag = f"interpret/step{step}"
        pt, po, ps = cuda_decide.decide_paged_with_scan(
            pt, to_torch(wave), now, layout="narrow", ways=WAYS, gpp=GPP
        )
        jpt, jo, js = _jax_decide(jpt, wave, now, "narrow")
        assert_out_equal(po, jo, tag)
        assert_scan_equal(ps, js, tag)
        assert_paged_equal(pt, jpt, "narrow", tag)


@pytest.mark.parametrize("layout", ["fused", "narrow"])
def test_sentinel_lanes_load_and_store_nothing(layout, monkeypatch):
    """A wave whose active lanes all sit on non-resident pages: every
    lane reports slot == N and no evicted key, answers as a fresh
    bucket (as the JAX kernel does), adds nothing to the WaveScan sums,
    and the table and page map stay untouched, in the plain version and
    the kernel lane code alike."""
    monkeypatch.setenv("GUBER_PALLAS_INTERPRET", "0")
    _, pt = port_table(layout)
    _, kpt = port_table(layout)
    _, jpt = jax_table(layout, monkeypatch)
    # fill the resident frames first, so "untouched" means something
    for wave, now in paged_waves(44, 4):
        pt, _, _ = cuda_decide.decide_paged_with_scan(
            pt, to_torch(wave), now, layout=layout, ways=WAYS, gpp=GPP
        )
        cuda_decide.decide_lane_code_on_host(
            kpt.data, to_torch(wave), now, ways=WAYS, layout=layout,
            page_map=kpt.page_map, gpp=GPP,
        )
        jpt, _, _ = _jax_decide(jpt, wave, now, layout)
    wave, now = paged_waves(45, 1)[0]
    pages = wave.group // GPP
    nonres = np.isin(pages, list(SCRAMBLE), invert=True)
    wave.active[:] = wave.active & nonres
    assert wave.active.sum() > 10
    rows_before = pt.data.data.clone()
    map_before = pt.page_map.clone()
    pt, po, ps = cuda_decide.decide_paged_with_scan(
        pt, to_torch(wave), now, layout=layout, ways=WAYS, gpp=GPP
    )
    act = torch.from_numpy(wave.active)
    assert (po.slot[act] == N_PHYS).all()
    assert (po.evicted_hi == 0).all() and (po.evicted_lo == 0).all()
    assert int(po.misses) == int(act.sum()) and int(po.hits) == 0
    assert all(int(v) == 0 for v in ps)
    assert torch.equal(pt.data.data, rows_before)
    assert torch.equal(pt.page_map, map_before)
    _check_lane_code(kpt, wave, now, layout, po, ps, "sentinel")
    assert torch.equal(kpt.data.data, rows_before)
    jpt, jo, js = _jax_decide(jpt, wave, now, layout)
    assert_out_equal(po, jo, "sentinel")
    assert_scan_equal(ps, js, "sentinel")


def _wide_rows(rng, n):
    return {
        "key_hi": rng.integers(1, 1 << 62, n),
        "key_lo": rng.integers(0, 1 << 62, n),
        "used": rng.random(n) < 0.6,
        "algo": rng.integers(0, 2, n).astype(np.int8),
        "status": rng.integers(0, 2, n).astype(np.int8),
        "limit": rng.integers(-100, 1000, n),
        "duration": rng.integers(0, 60_000, n),
        "remaining": rng.integers(0, 1 << 30, n),
        "stamp": NOW - rng.integers(0, 60_000, n),
        "expire_at": NOW + rng.integers(-60_000, 60_000, n),
        "invalid_at": np.where(rng.random(n) < 0.1, NOW + 5, 0),
        "burst": rng.integers(0, 1000, n),
        "lru": NOW - rng.integers(0, 60_000, n),
    }


@pytest.mark.parametrize("layout", ["fused", "narrow"])
def test_page_ops_match_jax(layout, monkeypatch):
    """bind_page / write_page / extract_page / unbind_page: the same
    sequence on both packages leaves the same rows and page map, and
    extract_page returns the same wide rows (a copy, which a later
    unbind does not change)."""
    PK, pt = port_table(layout)
    JK, jpt = jax_table(layout, monkeypatch)
    rng = np.random.default_rng(46)
    ps = PK.page_slots
    assert (PK.num_logical_pages, PK.page_slots) == (JK.num_logical_pages, JK.page_slots)
    for lp, pp in ((1, 0), (4, 5), (15, 3)):
        rows = _wide_rows(rng, ps)
        pt = PK.write_page(pt, lp, pp, SlotTable(**rows))
        jpt = JK.write_page(jpt, np.int32(lp), np.int32(pp), JSlotTable(**rows))
        assert_paged_equal(pt, jpt, layout, f"write {lp}->{pp}")
    for pp in (0, 5, 3, 7):
        got, want = PK.extract_page(pt, pp), JK.extract_page(jpt, np.int32(pp))
        for f in SlotTable._fields:
            assert np.array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f))), (pp, f)
    kept = PK.extract_page(pt, 5)
    kept_used = kept.used.clone()
    pt = PK.unbind_page(pt, 4, 5)
    jpt = JK.unbind_page(jpt, np.int32(4), np.int32(5))
    assert_paged_equal(pt, jpt, layout, "unbind")
    assert torch.equal(kept.used, kept_used) and bool(kept_used.any())
    pt = PK.bind_page(pt, 6, 5)
    jpt = JK.bind_page(jpt, np.int32(6), np.int32(5))
    assert_paged_equal(pt, jpt, layout, "rebind")
    wide = PK.to_wide(pt)
    assert wide.num_slots == N_PHYS
    with pytest.raises(NotImplementedError):
        PK.from_wide(wide)


def test_paged_wrapper_refuses_bad_page_map():
    """The page map must be a contiguous int32 vector on the table's
    device, and the table whole pages (checked before any launch)."""
    _, pt = port_table("fused")
    wave = to_torch(paged_waves(47, 1)[0][0])
    for bad in (pt.page_map.to(torch.int64), pt.page_map.reshape(4, 4),
                pt.page_map[::2]):
        with pytest.raises(ValueError, match="page_map"):
            cuda_decide.decide_paged(
                pt._replace(page_map=bad), wave, NOW, layout="fused", ways=WAYS, gpp=GPP
            )
    with pytest.raises(ValueError, match="whole pages"):
        cuda_decide.decide_paged(pt, wave, NOW, layout="fused", ways=WAYS, gpp=3)


def test_paged_kernels_refuse_other_ways():
    """PagedKernels.decide takes the engine's ways like the flat decide
    and refuses a count that is not the table's geometry."""
    PK, pt = port_table("narrow")
    wave = to_torch(paged_waves(48, 1)[0][0])
    with pytest.raises(ValueError, match="ways"):
        PK.decide(pt, wave, NOW, WAYS // 2)
    _, out = PK.decide(pt, wave, NOW, WAYS)
    assert out.slot.shape == wave.active.shape
