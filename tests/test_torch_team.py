"""The wave and sharded kernels' team of threads per lane, on the CPU.

The wave and sharded CUDA kernels run a team of T threads per lane (T
the smallest power of two >= ways, at most 32): member t loads way t's
row, the team picks the way with a butterfly of warp shuffles, the
member that holds the chosen row finishes the lane. The host build of
that lane code (`cuda_decide.decide_lane_code_on_host`,
`decide_sharded_lane_code_on_host`) emulates the team: the members'
candidates and rows, the butterfly's combine calls in the device's
order, the owner's finish. Here it meets groups built to tie:

- all ways empty; all expired; all live with one LRU stamp;
- one live key at two ways (the first must win);
- a key expired at one way beside the same key live at another;
- a mix of the above with store invalidation marks.

Each wave is held bit for bit (every DecideOutput field, the WaveScan
sums, the whole table; tolerance: none, all int64) against the plain
version (`ops/fused.py::wave_plain`, `sharded_plain`) for ways in
{1, 3, 4, 8, 16, 33}, fused and narrow, flat and paged (the sharded
wave on a flat mesh and on a paged one, XLATE), and, at ways 4 and 8
(in both layouts, the wave flat and paged), against the JAX package's
Pallas decide in its reference lowering
(`pallas_decide.decide_flat_with_scan`, `decide_paged_with_scan`; the
sharded wave as the mesh composes it: the Pallas wave per shard on its
masked lanes, then the sum, composed by hand). The selection alone (the
emulated butterfly against the serial fold) is checked on random
candidates with many equal scores.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gubernator_tpu.ops import fused as jfused
from gubernator_tpu.ops import narrow as jnarrow
from gubernator_tpu.ops import pallas_decide as jpallas
from gubernator_tpu.ops.paged import PagedTable as JPagedTable
from gubernator_tpu.ops.layout import RequestBatch as JBatch
from gubernator_tpu_torch.ops import cuda_decide, fused, narrow
from gubernator_tpu_torch.ops.layout import RequestBatch, SlotTable
from test_torch_decide import NOW, assert_out_equal, assert_scan_equal, to_jax, to_torch

WAYS_SWEEP = (1, 3, 4, 8, 16, 33)
NUM_GROUPS = 48
B = 32
GPP = 4  # groups per page: 12 logical pages
FRAMES = 8  # 4 logical pages not resident
SHARDS = 4
LAYOUTS = ("fused", "narrow")
CODEC = {"fused": fused.FUSED_CODEC, "narrow": narrow.NARROW_CODEC}
PACK = {"fused": fused.pack_table, "narrow": narrow.pack_table}
TABLE = {"fused": fused.FusedTable, "narrow": narrow.NarrowTable}
JTABLE = {"fused": jfused.FusedTable, "narrow": jnarrow.NarrowTable}
NO_WAY = (1 << 31) - 1


# ---------------------------------------------------------------------------
# the selection alone


def _reference_select(scores, live):
    order = np.lexsort((np.arange(scores.size), scores))
    first_live = np.flatnonzero(live)
    return (int(scores[order[0]]), int(order[0]),
            int(first_live[0]) if first_live.size else NO_WAY)


@pytest.mark.parametrize("ways", WAYS_SWEEP)
def test_butterfly_equals_serial_fold(ways):
    """The team's selection (member folds of ways t, t + 32, ..., then
    the emulated butterfly; every member must end with the same) equals
    the serial fold and the lexicographic (score, way) minimum and first
    live way, on random candidates drawn from few scores (ties)."""
    rng = np.random.default_rng(ways)
    for k in range(300):
        pool = rng.integers(0, 4 << 44, 1 + k % 4)
        scores = rng.choice(pool, ways)
        live = rng.random(ways) < rng.choice([0.0, 0.1, 0.5])
        serial, team = cuda_decide.select_on_host(scores, live)
        assert serial == team == _reference_select(scores, live), (ways, k)


# ---------------------------------------------------------------------------
# tie-heavy tables and waves


def tie_image(rng, ways, now):
    """Wide image of NUM_GROUPS groups; group g is of kind g % 6 (see
    the module docstring). Returns the image and, per group, the key a
    lane should ask for to hit the group's tie (None: any)."""
    n = NUM_GROUPS * ways
    col = {f: np.zeros(n, np.int64) for f in SlotTable._fields}
    col["used"] = np.zeros(n, bool)
    col["algo"] = np.zeros(n, np.int8)
    col["status"] = np.zeros(n, np.int8)
    wanted = {}
    for g in range(NUM_GROUPS):
        kind = g % 6
        s = np.arange(g * ways, (g + 1) * ways)
        if kind == 0:
            continue  # all empty
        col["used"][s] = True
        col["key_hi"][s] = rng.integers(1, 1 << 62, ways)
        col["key_lo"][s] = rng.integers(0, 1 << 62, ways)
        leaky = rng.random(ways) < 0.4
        col["algo"][s] = leaky
        col["limit"][s] = rng.integers(1, 50, ways)
        col["duration"][s] = rng.choice([1000, 60_000], ways)
        col["burst"][s] = np.where(leaky, col["limit"][s], 0)
        col["remaining"][s] = np.where(leaky, col["limit"][s] << 19, col["limit"][s] // 2)
        col["stamp"][s] = now - rng.integers(0, 5000, ways)
        col["expire_at"][s] = now + rng.integers(1, 60_000, ways)
        col["lru"][s] = now - 1000  # one stamp for every way
        if kind == 1:  # all expired
            col["expire_at"][s] = now - rng.integers(1, 1000, ways)
        elif kind == 3 and ways >= 2:  # one live key at two ways
            a, b = 1 % ways, ways - 1
            col["key_hi"][s[b]], col["key_lo"][s[b]] = col["key_hi"][s[a]], col["key_lo"][s[a]]
            wanted[g] = (col["key_hi"][s[a]], col["key_lo"][s[a]])
        elif kind == 4:  # the key expired at way 0, live at the last way
            col["expire_at"][s[0]] = now - 5
            col["key_hi"][s[-1]], col["key_lo"][s[-1]] = col["key_hi"][s[0]], col["key_lo"][s[0]]
            wanted[g] = (col["key_hi"][s[0]], col["key_lo"][s[0]])
        elif kind == 5:  # a mix: empty, expired, invalidated, LRU ties
            col["used"][s] = rng.random(ways) < 0.7
            col["expire_at"][s] = now + rng.choice([-50, 40_000], ways)
            col["invalid_at"][s] = np.where(rng.random(ways) < 0.2, now + rng.choice([-9, 9], ways), 0)
            col["lru"][s] = now - rng.choice([100, 100, 7000], ways)
        col["key_hi"][s] = np.where(col["used"][s], col["key_hi"][s], 0)
        col["key_lo"][s] = np.where(col["used"][s], col["key_lo"][s], 0)
    col["algo"] = col["algo"].astype(np.int8)
    return SlotTable(**col), wanted


def tie_wave(rng, image, wanted, ways, now):
    """B lanes on distinct groups: the group's tie key where it has one,
    else an existing key of the group or a new one; a few inactive."""
    b = RequestBatch.zeros(B)
    groups = rng.choice(NUM_GROUPS, B, replace=False)
    for i, g in enumerate(groups):
        if int(g) in wanted and rng.random() < 0.9:
            hi, lo = wanted[int(g)]
        elif rng.random() < 0.5:
            s = g * ways + rng.integers(0, ways)
            hi, lo = image.key_hi[s] or 7, image.key_lo[s] or g + 1
        else:
            hi, lo = rng.integers(1, 1 << 62), rng.integers(0, 1 << 62)
        b.key_hi[i], b.key_lo[i] = hi, lo
    b.group[:] = groups.astype(np.int32)
    b.algo[:] = rng.random(B) < 0.4
    b.behavior[:] = rng.choice([0, 0, 0, 8, 32], B)
    b.hits[:] = rng.choice([0, 1, 1, 2, 60], B)
    b.limit[:] = rng.integers(1, 50, B)
    b.duration[:] = rng.choice([1000, 60_000], B)
    b.rate_num[:] = b.duration
    b.eff_duration[:] = b.duration
    b.burst[:] = np.where(b.algo == 1, b.limit, 0)
    b.created_at[:] = now - rng.choice([0, 0, 3], B)
    b.active[:] = rng.random(B) < 0.9
    return b


def paged_frames(image, ways, page_map):
    """The rows of the resident logical pages, each at its frame."""
    ps = GPP * ways
    lp_of_frame = np.empty(FRAMES, np.int64)
    mapped = np.flatnonzero(page_map >= 0)
    lp_of_frame[page_map[mapped]] = mapped
    idx = (lp_of_frame[:, None] * ps + np.arange(ps)[None, :]).ravel()
    return SlotTable(*(c[idx] for c in image))


def tables(seed, layout, ways, paged):
    """(image rows (N, C) on the CPU, page map or None, rng, now): the
    tie-heavy image in `layout`, paged: the frames of a scrambled map."""
    rng = np.random.default_rng(seed)
    image, wanted = tie_image(rng, ways, NOW)
    pm = None
    if paged:
        pm = np.full(NUM_GROUPS // GPP, -1, np.int32)
        pm[rng.choice(pm.size, FRAMES, replace=False)] = rng.permutation(FRAMES)
        rows = PACK[layout](paged_frames(image, ways, pm), device="cpu").data
        pm = torch.from_numpy(pm)
    else:
        rows = PACK[layout](image, device="cpu").data
    return image, wanted, rows, pm, rng


def _waves(rng, image, wanted, ways):
    now = NOW
    for step in range(3):
        yield tie_wave(rng, image, wanted, ways, now), now
        now += (0, 2, 61_000)[step]


def _assert_same(ko, ks, po, ps, tag):
    for f in ko._fields:
        a, r = getattr(ko, f), getattr(po, f)
        assert a.dtype == r.dtype and torch.equal(a, r), f"{tag}: {f}\nteam={a}\nplain={r}"
    assert_scan_equal(ks, ps, tag) if ks is not None else None


# ---------------------------------------------------------------------------
# the wave kernel's team


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("ways", WAYS_SWEEP)
def test_wave_team_matches_plain_on_ties(ways, layout, paged):
    image, wanted, rows, pm, rng = tables(10 + ways, layout, ways, paged)
    kt = TABLE[layout]
    krows, prows = rows.clone(), rows.clone()
    gpp = GPP if paged else 0
    for step, (wave, now) in enumerate(_waves(rng, image, wanted, ways)):
        tag = f"{layout}/ways{ways}/paged{paged}/step{step}"
        po, ps = fused.wave_plain(CODEC[layout], prows, pm, to_torch(wave), now, ways=ways, gpp=gpp)
        _, ko, ks = cuda_decide.decide_lane_code_on_host(
            kt(krows), to_torch(wave), now, ways=ways, layout=layout, page_map=pm, gpp=gpp)
        _assert_same(ko, ks, po, ps, tag)
        assert torch.equal(krows, prows), f"{tag}: table"
    if ways >= 2 and not paged:
        assert int(po.hits) > 0 and int(po.misses) > 0


def _jax_wave(layout, ways, jrows, jpm, wave, now):
    if jpm is None:
        jt, jo, js = jpallas.decide_flat_with_scan(
            JTABLE[layout](jrows), to_jax(wave), jnp.int64(now), layout=layout, ways=ways)
        return jt.data, jo, js
    jt, jo, js = jpallas.decide_paged_with_scan(
        JPagedTable(JTABLE[layout](jrows), jpm), to_jax(wave), jnp.int64(now),
        layout=layout, ways=ways, gpp=GPP)
    return jt.data.data, jo, js


# Against JAX (a program compiles per case, ~3 s on one core): the wave
# at 8 ways fused flat and 4 ways narrow paged, the sharded wave at 8
# ways narrow and 4 ways fused, so each of 4 and 8 ways meets both
# layouts, and each layout both table kinds.
@pytest.mark.parametrize("ways,layout,paged", [(8, "fused", False), (4, "narrow", True)])
def test_wave_team_matches_pallas_on_ties(ways, layout, paged, monkeypatch):
    """The team's lane code against the Pallas decide (reference
    lowering) on the same tie-heavy waves: every field, the sums, the
    rows."""
    monkeypatch.setenv("GUBER_PALLAS_INTERPRET", "0")
    image, wanted, rows, pm, rng = tables(20 + ways, layout, ways, paged)
    kt = TABLE[layout]
    # copies: jnp.asarray may share the numpy buffer, which the lane code
    # then updates in place while JAX may still read it
    jrows = jnp.array(rows.numpy(), copy=True)
    jpm = jnp.array(pm.numpy(), copy=True) if paged else None
    gpp = GPP if paged else 0
    for step, (wave, now) in enumerate(_waves(rng, image, wanted, ways)):
        tag = f"{layout}/ways{ways}/paged{paged}/step{step}"
        jrows, jo, js = _jax_wave(layout, ways, jrows, jpm, wave, now)
        _, ko, ks = cuda_decide.decide_lane_code_on_host(
            kt(rows), to_torch(wave), now, ways=ways, layout=layout, page_map=pm, gpp=gpp)
        assert_out_equal(ko, jo, tag)
        assert_scan_equal(ks, js, tag)
        assert np.array_equal(rows.numpy(), np.asarray(jrows)), f"{tag}: table"


# ---------------------------------------------------------------------------
# the sharded kernel's team


@pytest.mark.parametrize("xlate", [False, True])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("ways", WAYS_SWEEP)
def test_sharded_team_matches_plain_on_ties(ways, layout, xlate):
    """SHARDS shards of the tie-heavy table (flat), or of the frames of
    a scrambled page map (XLATE: lanes on pages that are not resident
    are owned by no shard)."""
    image, wanted, rows, pm, rng = tables(30 + ways, layout, ways, xlate)
    krows, prows = rows.clone(), rows.clone()
    gpp = GPP if xlate else 0
    for step, (wave, now) in enumerate(_waves(rng, image, wanted, ways)):
        tag = f"{layout}/ways{ways}/xlate{xlate}/step{step}"
        po, ps = fused.sharded_plain(CODEC[layout], prows, pm, to_torch(wave), now,
                                     ways=ways, n_shards=SHARDS, gpp=gpp)
        ko, ks = cuda_decide.decide_sharded_lane_code_on_host(
            krows, pm, to_torch(wave), now, layout=layout, ways=ways, n_shards=SHARDS, gpp=gpp)
        _assert_same(ko, ks, po, ps, tag)
        assert torch.equal(krows, prows), f"{tag}: table"


@pytest.mark.parametrize("ways,layout", [(8, "narrow"), (4, "fused")])
def test_sharded_team_matches_pallas_shards_on_ties(ways, layout, monkeypatch):
    """The sharded team against the mesh tier's composition in the JAX
    package, built by hand (JAX's shard_map needs the faked devices and
    a compile per table shape): each shard's Pallas wave (reference
    lowering; `raw_decide_flat` is the same `_wave`, unjitted) on its
    rows with the lanes it does not own masked (the port's
    `mask_to_local`, which tests/test_torch_mesh.py holds against the
    JAX mesh), then the sum of every output."""
    monkeypatch.setenv("GUBER_PALLAS_INTERPRET", "0")
    image, wanted, rows, _, rng = tables(40 + ways, layout, ways, False)
    n_local = rows.shape[0] // SHARDS
    gp = n_local // ways
    jshards = [jnp.array(rows[d * n_local:(d + 1) * n_local].numpy(), copy=True)
               for d in range(SHARDS)]
    for step, (wave, now) in enumerate(_waves(rng, image, wanted, ways)):
        tag = f"{layout}/ways{ways}/step{step}"
        outs = []
        for d in range(SHARDS):
            local = fused.mask_to_local(d, gp, to_torch(wave))
            shard, out, _ = jpallas.decide_flat_with_scan(
                JTABLE[layout](jshards[d]), JBatch(*(jnp.asarray(c.numpy()) for c in local)),
                jnp.int64(now), layout=layout, ways=ways)
            jshards[d] = shard.data
            outs.append(out)
        ko, _ = cuda_decide.decide_sharded_lane_code_on_host(
            rows, None, to_torch(wave), now, layout=layout, ways=ways, n_shards=SHARDS)
        for f in ko._fields:
            want = np.sum([np.asarray(getattr(o, f)).astype(np.int64) for o in outs], axis=0)
            assert np.array_equal(getattr(ko, f).numpy().astype(np.int64), want), f"{tag}: {f}"
        assert np.array_equal(rows.numpy(), np.concatenate([np.asarray(s) for s in jshards])), tag
