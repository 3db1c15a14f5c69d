"""The port's scan of decide waves against the JAX package's.

T seeded waves (`fuzz_wave` of test_torch_decide.py; its hot keys keep
their groups, so groups repeat from step to step and each step reads the
rows the step before it stored) are stacked into (T, B) columns and go
through:

- `gubernator_tpu_torch.ops.kernels.get_kernels(layout).decide_scan` on
  a CPU table (the plain version, `ops/fused.py::scan_plain`);
- `cuda_decide.decide_scan_lane_code_on_host` (the scan kernel's step
  loop and per-lane C++, built by g++);
- `gubernator_tpu.ops.kernels.get_kernels(layout).decide_scan` with
  `GUBER_KERNEL=xla` (the XLA `lax.scan`);
- `gubernator_tpu.ops.pallas_decide.decide_scan_flat` /
  `decide_scan_paged` in the reference lowering and, for one small case,
  in interpret mode (the Pallas kernel body itself).

The paged scan has lanes on non-resident pages (a scrambled map, as in
test_torch_paged.py), so it is held against the Pallas scan only: the
XLA paged scan translates such lanes differently (see
tests/test_kernel_fuzz.py, which holds the two together on all-resident
waves). Tolerance: none. Every (T, B) field, the (T,) sums and the
whole table are compared bit for bit.

The scan kernel runs a team of threads per lane in a persistent grid,
each block's next item of lanes staged before the barrier that starts
its step; its host build emulates that data flow on a grid of a given
number of blocks of 128 or 256 threads. The team scan cases
(`test_team_scan_*`) hold it, on every grid shape (one item per block;
blocks that stride over several items per step; both block sizes),
against the plain version, and a subset against the Pallas scan
(reference lowering), fused and narrow, flat and paged, on the
tie-heavy tables of test_torch_team.py (all ways empty, all expired,
all live with one LRU stamp, a key live at two ways, ...):

- `shared`: 4 steps that share 3/4 of their lanes (group, key, request)
  with the step before, so most rows a step reads the step before wrote;
- `ties`: 3 tie-heavy steps (8 ways);
- `ways4`, `ways33`: the same on 4-way and 33-way tables (a team of 4;
  a team of 32 whose members fold two ways);
- `t1`: a scan of one step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gubernator_tpu.ops import fused as jfused
from gubernator_tpu.ops import narrow as jnarrow
from gubernator_tpu.ops import pallas_decide as jpallas
from gubernator_tpu.ops.kernels import get_kernels as jget_kernels
from gubernator_tpu_torch.ops import cuda_decide, fused, narrow
from gubernator_tpu_torch.ops.kernels import get_kernels
from gubernator_tpu_torch.ops.layout import (
    RequestBatch,
    batch_to_device,
    stack_batches,
)
from test_torch_decide import NOW, NUM_GROUPS, OUT_FIELDS, WAYS, _waves, assert_out_equal
from test_torch_paged import (
    GPP,
    N_PHYS,
    jax_table,
    paged_waves,
    port_table,
)
from test_torch_team import B as TIE_B
from test_torch_team import CODEC, JTABLE, TABLE, tie_wave
from test_torch_team import GPP as TIE_GPP
from test_torch_team import NUM_GROUPS as TIE_GROUPS
from test_torch_team import _waves as tie_waves
from test_torch_team import tables as tie_tables
from gubernator_tpu.ops.paged import PagedTable as JPagedTable

_UNPACK = {"fused": (fused.unpack_table, jfused.unpack_table),
           "narrow": (narrow.unpack_table, jnarrow.unpack_table)}


def stacked(waves):
    """(host (T, B) batch, nows) of a list of (wave, now)."""
    return (stack_batches([w for w, _ in waves]),
            np.array([n for _, n in waves], np.int64))


def to_jax(sb):
    from gubernator_tpu.ops.layout import RequestBatch as JBatch

    return JBatch(*(jnp.asarray(c) for c in sb))


def assert_table_equal(port_table, jax_table, layout, tag):
    """Raw rows and the wide view, column by column."""
    assert np.array_equal(port_table.data.numpy(), np.asarray(jax_table.data)), f"{tag}: rows"
    pw, jw = (u(t) for u, t in zip(_UNPACK[layout], (port_table, jax_table)))
    for f in pw._fields:
        a, r = getattr(pw, f).numpy(), np.asarray(getattr(jw, f))
        assert a.dtype == r.dtype and np.array_equal(a, r), f"{tag}: table column {f}"


def assert_port_equal(a, b, tag):
    for f in OUT_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, (tag, f, x.dtype, y.dtype, x.shape, y.shape)
        assert torch.equal(x, y), f"{tag}: {f} diverged"


def _repeats(waves):
    """Active groups a step shares with the step before it."""
    n = 0
    for (a, _), (b, _) in zip(waves, waves[1:]):
        n += len(set(a.group[a.active].tolist()) & set(b.group[b.active].tolist()))
    return n


@pytest.mark.parametrize("seed", [21, 22])
@pytest.mark.parametrize("layout", ["fused", "narrow"])
def test_scan_matches_xla_pallas_and_lane_code(layout, seed, monkeypatch):
    """Flat scan: the port's registry entry (plain version) and the scan
    kernel's host build against the XLA scan and the Pallas reference
    scan: stacked outputs and the final table."""
    monkeypatch.setenv("GUBER_KERNEL", "xla")
    monkeypatch.setenv("GUBER_PALLAS_INTERPRET", "0")
    waves = _waves(seed, 5)
    assert _repeats(waves) > 20, "consecutive steps must share groups"
    sb, nows = stacked(waves)
    K = get_kernels(layout)
    pt, po = K.decide_scan(K.create(NUM_GROUPS, WAYS, "cpu"), batch_to_device(sb, "cpu"), nows, WAYS)
    kt, ko = cuda_decide.decide_scan_lane_code_on_host(
        K.create(NUM_GROUPS, WAYS, "cpu"), batch_to_device(sb, "cpu"), nows,
        ways=WAYS, layout=layout,
    )
    JK = jget_kernels(layout)
    jx, xo = JK.decide_scan(JK.create(NUM_GROUPS, WAYS), to_jax(sb), jnp.asarray(nows), WAYS)
    jp, pallas_o = jpallas.decide_scan_flat(
        JK.create(NUM_GROUPS, WAYS), to_jax(sb), jnp.asarray(nows), layout=layout, ways=WAYS
    )
    tag = f"{layout}/seed{seed}"
    assert po.status.shape == (5, 64) and po.hits.shape == (5,)
    assert_out_equal(po, xo, tag + "/xla")
    assert_out_equal(po, pallas_o, tag + "/pallas")
    assert_port_equal(ko, po, tag + "/lane code")
    assert_table_equal(pt, jx, layout, tag + "/xla")
    assert_table_equal(pt, jp, layout, tag + "/pallas")
    assert torch.equal(kt.data, pt.data), f"{tag}: lane code table"


def test_scan_matches_pallas_interpret(monkeypatch):
    """One small scan through the Pallas kernel body itself (fused,
    interpret mode)."""
    monkeypatch.setenv("GUBER_PALLAS_INTERPRET", "1")
    assert jpallas.pallas_mode() == "interpret"
    waves = _waves(23, 3)
    sb, nows = stacked(waves)
    K = get_kernels("fused")
    pt, po = K.decide_scan(K.create(NUM_GROUPS, WAYS, "cpu"), batch_to_device(sb, "cpu"), nows, WAYS)
    jt, jo = jpallas.decide_scan_flat(
        jfused.FusedTable.create(NUM_GROUPS, WAYS), to_jax(sb), jnp.asarray(nows),
        layout="fused", ways=WAYS,
    )
    assert_out_equal(po, jo, "interpret")
    assert_table_equal(pt, jt, "fused", "interpret")


@pytest.mark.parametrize("layout", ["fused", "narrow"])
def test_paged_scan_matches_pallas_reference(layout, monkeypatch):
    """Paged scan over a scrambled page map (sentinel lanes in every
    step): the port's paged registry entry and the scan kernel's host
    build against the Pallas reference scan; physical rows and the page
    map after the scan."""
    monkeypatch.setenv("GUBER_PALLAS_INTERPRET", "0")
    waves = paged_waves(43, 4)
    sb, nows = stacked(waves)
    PK, pt = port_table(layout)
    pm0 = pt.page_map.clone()
    pt, po = PK.decide_scan(pt, batch_to_device(sb, "cpu"), nows, WAYS)
    _, kpt = port_table(layout)
    _, ko = cuda_decide.decide_scan_lane_code_on_host(
        kpt.data, batch_to_device(sb, "cpu"), nows, ways=WAYS, layout=layout,
        page_map=kpt.page_map, gpp=GPP,
    )
    _, jpt = jax_table(layout, monkeypatch)
    jpt, jo = jpallas.decide_scan_paged(
        jpt, to_jax(sb), jnp.asarray(nows), layout=layout, ways=WAYS, gpp=GPP
    )
    tag = f"paged/{layout}"
    assert int((sb.active & (po.slot.numpy() == N_PHYS)).sum()) > 30, "sentinel lanes"
    assert_out_equal(po, jo, tag)
    assert_port_equal(ko, po, tag + "/lane code")
    assert np.array_equal(pt.data.data.numpy(), np.asarray(jpt.data.data)), f"{tag}: rows"
    assert torch.equal(pt.page_map, pm0) and np.array_equal(pm0.numpy(), np.asarray(jpt.page_map))
    assert torch.equal(kpt.data.data, pt.data.data), f"{tag}: lane code rows"
    with pytest.raises(ValueError):
        PK.decide_scan(pt, batch_to_device(sb, "cpu"), nows, WAYS + 1)


@pytest.mark.parametrize("layout", ["fused", "narrow"])
def test_scan_equals_successive_waves(layout):
    """A scan equals T calls of the port's single-wave decide, one per
    step, including a step whose lanes are all inactive (it reads and
    writes nothing, its sums are 0)."""
    waves = _waves(24, 4)
    idle = RequestBatch(*(c.copy() for c in waves[2][0]))
    idle.active[:] = False
    waves[2] = (idle, waves[2][1])
    sb, nows = stacked(waves)
    K = get_kernels(layout)
    st, so = K.decide_scan(K.create(NUM_GROUPS, WAYS, "cpu"), batch_to_device(sb, "cpu"), nows, WAYS)
    wt = K.create(NUM_GROUPS, WAYS, "cpu")
    for t, (w, now) in enumerate(waves):
        wt, wo = K.decide(wt, batch_to_device(w, "cpu"), now, WAYS)
        for f in OUT_FIELDS:
            assert torch.equal(getattr(so, f)[t], getattr(wo, f)), (t, f)
    assert torch.equal(st.data, wt.data)
    assert int(so.hits[2]) == int(so.misses[2]) == int(so.over_limit[2]) == 0
    assert bool((so.slot[2] == NUM_GROUPS * WAYS).all())


def test_scan_of_no_steps():
    """T = 0: empty stacks of the output dtypes, the table unchanged,
    nothing launched (plain version and host build)."""
    before = dict(cuda_decide.CONFIG_LAUNCHES)
    sb = stack_batches([RequestBatch.zeros(8)])
    sb = RequestBatch(*(c[:0] for c in sb))
    assert sb.key_hi.shape == (0, 8)
    K = get_kernels("narrow")
    t0 = K.create(NUM_GROUPS, WAYS, "cpu")
    for run in (
        lambda t: K.decide_scan(t, batch_to_device(sb, "cpu"), [], WAYS),
        lambda t: cuda_decide.decide_scan_lane_code_on_host(
            t, batch_to_device(sb, "cpu"), np.zeros(0, np.int64), ways=WAYS, layout="narrow"),
    ):
        t, out = run(K.create(NUM_GROUPS, WAYS, "cpu"))
        assert torch.equal(t.data, t0.data)
        assert out.status.shape == (0, 8) and out.status.dtype == torch.int8
        assert out.freed.dtype == torch.bool and out.slot.dtype == torch.int64
        assert out.hits.shape == (0,) and out.over_limit.dtype == torch.int64
    assert dict(cuda_decide.CONFIG_LAUNCHES) == before


def test_stacked_batch_to_device_and_checks():
    """stack_batches + batch_to_device keep (T, B) columns contiguous with
    step t at row t; the scan wrapper refuses a (B,) batch, nows of the
    wrong length and an int32 nows tensor; the scan configurations are
    counted apart from the wave's."""
    waves = _waves(25, 3)
    sb, nows = stacked(waves)
    db = batch_to_device(sb, "cpu")
    for f in RequestBatch._fields:
        col = getattr(db, f)
        assert col.shape == (3, 64) and col.is_contiguous()
        for t, (w, _) in enumerate(waves):
            assert np.array_equal(col[t].numpy(), getattr(w, f)), f
    K = get_kernels("fused")
    t = K.create(NUM_GROUPS, WAYS, "cpu")
    with pytest.raises(ValueError):
        K.decide_scan(t, batch_to_device(waves[0][0], "cpu"), nows[:1], WAYS)
    with pytest.raises(ValueError):
        K.decide_scan(t, db, nows[:2], WAYS)
    with pytest.raises(ValueError):
        K.decide_scan(t, db, torch.from_numpy(nows).to(torch.int32), WAYS)
    assert {"decide_scan", "decide_scan_narrow", "decide_scan_paged",
            "decide_scan_narrow_paged"} <= set(cuda_decide.CONFIG_LAUNCHES)
    # four wave, four scan and the two sharded-wave configurations, and
    # the sharded kernel's two replica-wave counts (the GLOBAL tier)
    assert len(cuda_decide.CONFIGS) == 12


# ---------------------------------------------------------------------------
# the team scan (the scan kernel's data flow, emulated by its host build)


def _shared_waves(rng, image, wanted, ways, steps=4):
    """`steps` waves on the tie image, each keeping 3/4 of the lanes of
    the step before (group, key, request) and taking the rest from a
    fresh tie wave, on groups the kept lanes do not hold."""
    now = NOW
    w = tie_wave(rng, image, wanted, ways, now)
    out = [(w, now)]
    for _ in range(steps - 1):
        now += 250
        keep = rng.permutation(TIE_B)[: TIE_B * 3 // 4]
        fresh = tie_wave(rng, image, wanted, ways, now)
        free = np.flatnonzero(~np.isin(fresh.group, w.group[keep]))[: TIE_B - keep.size]
        assert free.size == TIE_B - keep.size
        w = RequestBatch(*(np.concatenate([c[keep], f[free]]) for c, f in zip(w, fresh)))
        out.append((w, now))
    return out


# case -> (ways, steps of the tie image's traffic)
TEAM_CASES = {"shared": 8, "ties": 8, "ways4": 4, "ways33": 33, "t1": 8}


def team_scan_case(case, layout, paged):
    """(rows (N, C) on the CPU, page map or None, (T, B) host batch,
    nows, ways) of a team scan case; paged: the frames of a scrambled
    map of the tie image."""
    ways = TEAM_CASES[case]
    image, wanted, rows, pm, rng = tie_tables(60 + len(case) + ways, layout, ways, paged)
    if case == "shared":
        waves = _shared_waves(rng, image, wanted, ways)
        shared = [np.intersect1d(a.group, b.group).size for (a, _), (b, _) in zip(waves, waves[1:])]
        assert min(shared) >= TIE_B * 3 // 4, "consecutive steps must share most groups"
    else:
        waves = list(tie_waves(rng, image, wanted, ways))[: 1 if case == "t1" else None]
    sb, nows = stacked(waves)
    return rows, pm, sb, nows, ways


# (blocks, threads) of the emulated grid: one item per block, blocks
# that stride over several items, both block sizes
GRIDS = {"fit128": (None, 128), "stride128": (1, 128), "fit256": (None, 256),
         "stride256": (3, 256)}


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("layout", ["fused", "narrow"])
@pytest.mark.parametrize("case", list(TEAM_CASES))
def test_team_scan_matches_plain(case, layout, paged, grid):
    """The scan kernel's host build on a grid shape against the plain
    scan: every (T, B) field, the (T,) sums, the rows, the page map."""
    rows, pm, sb, nows, ways = team_scan_case(case, layout, paged)
    blocks, threads = GRIDS[grid]
    gpp = TIE_GPP if paged else 0
    pm0 = pm.clone() if paged else None
    krows, prows = rows.clone(), rows.clone()
    _, ko = cuda_decide.decide_scan_lane_code_on_host(
        TABLE[layout](krows), batch_to_device(sb, "cpu"), nows, ways=ways, layout=layout,
        page_map=pm, gpp=gpp, blocks=blocks, threads=threads)
    po = fused.scan_plain(CODEC[layout], prows, pm, batch_to_device(sb, "cpu"), nows,
                          ways=ways, gpp=gpp)
    tag = f"{case}/{layout}/paged{paged}/{grid}"
    assert po.status.shape == sb.key_hi.shape and po.hits.shape == (len(nows),)
    assert_port_equal(ko, po, tag)
    assert torch.equal(krows, prows), f"{tag}: rows"
    assert pm is None or torch.equal(pm, pm0), f"{tag}: page map"
    assert int(po.hits.sum()) > 0 and int(po.misses.sum()) > 0, tag


def test_team_scan_grids_stride():
    """The grid shapes of the team scan cases stride where they should:
    fewer blocks than items per step (scan_items), and items past the
    batch when the blocks do not divide them."""
    assert cuda_decide.scan_items(TIE_B, 8, 128) == 2  # stride128: 1 block, 2 items a step
    assert cuda_decide.scan_items(TIE_B, 33, 128) == 8
    assert cuda_decide.scan_items(TIE_B, 33, 256) == 4  # stride256: 3 blocks, 2 passes
    assert cuda_decide.scan_items(TIE_B, 4, 256) == 1
    assert cuda_decide.scan_items(4096, 8, 128) == 256
    assert cuda_decide.scan_items(4096, 8, 256) == 128
    with pytest.raises(RuntimeError):
        rows, pm, sb, nows, ways = team_scan_case("t1", "fused", False)
        cuda_decide.decide_scan_lane_code_on_host(
            TABLE["fused"](rows), batch_to_device(sb, "cpu"), nows, ways=ways, threads=192)


def _jax_scan(layout, ways, jrows, jpm, sb, nows):
    if jpm is None:
        jt, jo = jpallas.decide_scan_flat(JTABLE[layout](jrows), to_jax(sb), jnp.asarray(nows),
                                          layout=layout, ways=ways)
        return jt.data, jo
    jt, jo = jpallas.decide_scan_paged(JPagedTable(JTABLE[layout](jrows), jpm), to_jax(sb),
                                       jnp.asarray(nows), layout=layout, ways=ways, gpp=TIE_GPP)
    return jt.data.data, jo


# Against JAX (a program compiles per case, ~3 s on one core): every case
# once, each layout and each table kind at least twice.
@pytest.mark.parametrize("case,layout,paged", [
    ("shared", "fused", False), ("ties", "narrow", True), ("ways4", "fused", True),
    ("ways33", "narrow", False), ("t1", "narrow", False), ("t1", "fused", True),
])
def test_team_scan_matches_pallas(case, layout, paged, monkeypatch):
    """The scan kernel's host build (one item per block, and 256-thread
    blocks that stride) against the JAX package's Pallas scan
    (`decide_scan_flat` / `decide_scan_paged`, reference lowering):
    every (T, B) field, the (T,) sums, the rows."""
    monkeypatch.setenv("GUBER_PALLAS_INTERPRET", "0")
    rows, pm, sb, nows, ways = team_scan_case(case, layout, paged)
    gpp = TIE_GPP if paged else 0
    # copies: jnp.asarray may share the numpy buffer, which the lane code
    # then updates in place while JAX may still read it
    jrows = jnp.array(rows.numpy(), copy=True)
    jpm = jnp.array(pm.numpy(), copy=True) if paged else None
    jrows, jo = _jax_scan(layout, ways, jrows, jpm, sb, nows)
    for blocks, threads in ((None, 128), (1, 256)):
        krows = rows.clone()
        _, ko = cuda_decide.decide_scan_lane_code_on_host(
            TABLE[layout](krows), batch_to_device(sb, "cpu"), nows, ways=ways, layout=layout,
            page_map=pm, gpp=gpp, blocks=blocks, threads=threads)
        tag = f"{case}/{layout}/paged{paged}/{blocks}x{threads}"
        assert_out_equal(ko, jo, tag)
        assert np.array_equal(krows.numpy(), np.asarray(jrows)), f"{tag}: rows"
