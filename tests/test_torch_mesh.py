"""The port's owner-sharded mesh decide against the JAX package's.

The JAX package tests its mesh tier on 8 XLA host devices faked on one
CPU (tests/conftest.py); the port's mesh here is 8 shards on `cpu`, one
table in which shard d holds rows [d * n_local, (d + 1) * n_local). The
same seeded numpy waves go through:

- the port's sharded wave (`parallel/mesh.py::make_sharded_decide` on a
  CPU table, i.e. `ops/fused.py::sharded_plain`: the masked wave on
  every shard's rows, then the sum);
- the sharded kernel's per-lane C++ built by g++
  (`cuda_decide.decide_sharded_lane_code_on_host`: the ownership
  prologue, the lane body on the owner's rows and the psum epilogue);
- `gubernator_tpu.parallel.mesh.make_sharded_decide` on
  `jax.devices()[:8]` under `GUBER_KERNEL=pallas`, whose shards each run
  `pallas_decide.raw_decide_flat` (reference lowering, and interpret
  mode for one case), and the psum.

Every one of the 12 output fields is compared with its dtype (the
psum'd `slot` and `freed` included), and the whole table. The paged
mesh facade, the per-shard pager and the refusals are held against the
JAX package too. Tolerance: none.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gubernator_tpu.api.types import RateLimitReq as JReq
from gubernator_tpu.models.oracle import OracleEngine
from gubernator_tpu.ops import fused as jfused
from gubernator_tpu.ops import pallas_decide as jpallas
from gubernator_tpu.ops.layout import RequestBatch as JBatch
from gubernator_tpu.ops.layout import SlotTable as JSlotTable
from gubernator_tpu.parallel import mesh as jmesh
from gubernator_tpu.runtime.pager import Pager as JPager
from gubernator_tpu.utils import lockorder
from gubernator_tpu_torch.api.keys import key_hash128_batch
from gubernator_tpu_torch.api.types import RateLimitReq
from gubernator_tpu_torch.ops import cuda_decide, fused, narrow
from gubernator_tpu_torch.ops.encode import encode_batch
from gubernator_tpu_torch.ops.layout import RequestBatch, SlotTable, batch_prefix
from gubernator_tpu_torch.parallel import mesh as pmesh
from gubernator_tpu_torch.runtime.pager import Pager
from test_torch_decide import NOW, OUT_FIELDS, fuzz_wave, to_jax, to_torch

NDEV = 8
NUM_GROUPS = 64
WAYS = 4
B = 32
N = NUM_GROUPS * WAYS
N_LOCAL = N // NDEV


@pytest.fixture(scope="module")
def jax_mesh():
    devices = jax.devices()
    assert len(devices) >= NDEV
    return jmesh.make_mesh(devices[:NDEV])


def port_mesh():
    return pmesh.make_mesh(["cpu"] * NDEV)


def assert_all_fields_equal(port, ref, tag):
    """All 12 DecideOutput fields, values and dtypes (numpy's)."""
    for f in OUT_FIELDS:
        a, r = getattr(port, f).numpy(), np.asarray(getattr(ref, f))
        assert a.dtype == r.dtype, (tag, f, a.dtype, r.dtype)
        assert np.array_equal(a, r), f"{tag}: {f} diverged\nport={a}\nref={r}"


def assert_outputs_equal(a, b, tag):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and torch.equal(x, y), (tag, f)


def mesh_waves(seed, steps, num_groups=NUM_GROUPS):
    """fuzz_wave's waves cut to B lanes (distinct active groups)."""
    rng = np.random.default_rng(seed)
    now = NOW
    out = []
    for _ in range(steps):
        now += int(rng.choice([0, 1, 40, 700, 5000, 70_000], p=[.2, .2, .2, .2, .15, .05]))
        out.append((batch_prefix(fuzz_wave(rng, now, num_groups), B), now))
    return out


_JAX_PROGRAMS = {}


def _jax_program(key, build, monkeypatch):
    """One JAX program per key for the module (each build is a new jit
    to compile), built under GUBER_KERNEL=pallas, reference lowering."""
    monkeypatch.setenv("GUBER_KERNEL", "pallas")
    monkeypatch.setenv("GUBER_PALLAS_INTERPRET", "0")
    if key not in _JAX_PROGRAMS:
        _JAX_PROGRAMS[key] = build()
    return _JAX_PROGRAMS[key]


def jax_decide(jax_mesh, layout, monkeypatch):
    """A fresh JAX sharded table and the mesh decide (Pallas raw decide
    per shard, then the psum)."""
    decide = _jax_program(
        ("decide", layout),
        lambda: jmesh.make_sharded_decide(jax_mesh, NUM_GROUPS, WAYS, layout),
        monkeypatch,
    )
    return jmesh.create_sharded_table(jax_mesh, NUM_GROUPS, WAYS, layout), decide


@pytest.mark.parametrize("seed", [51, 52])
@pytest.mark.parametrize("layout", ["fused", "narrow"])
def test_sharded_decide_matches_jax_mesh(layout, seed, jax_mesh, monkeypatch):
    """Plain sharded wave, kernel lane code and the JAX mesh (Pallas raw
    decide per shard, psum): every output field with its dtype, the
    WaveScan sums (plain against lane code) and the whole table, after
    every wave."""
    jt, jdecide = jax_decide(jax_mesh, layout, monkeypatch)
    mesh = port_mesh()
    pt = pmesh.create_sharded_table(mesh, NUM_GROUPS, WAYS, layout)
    kt = pmesh.create_sharded_table(mesh, NUM_GROUPS, WAYS, layout)
    unowned = 0
    for step, (wave, now) in enumerate(mesh_waves(seed, 6)):
        tag = f"{layout}/seed{seed}/step{step}"
        po, ps = fused.sharded_plain(
            fused.FUSED_CODEC if layout == "fused" else narrow.NARROW_CODEC,
            pt.data, None, to_torch(wave), now, ways=WAYS, n_shards=NDEV,
        )
        ko, ks = cuda_decide.decide_sharded_lane_code_on_host(
            kt.data, None, to_torch(wave), now, layout=layout, ways=WAYS, n_shards=NDEV
        )
        jt, jo = jdecide(jt, to_jax(wave), now)
        assert_all_fields_equal(po, jo, tag)
        assert_outputs_equal(ko, po, f"{tag} lane code")
        for f in ps._fields:
            assert int(getattr(ks, f)) == int(getattr(ps, f)), (tag, f)
        assert np.array_equal(pt.data.numpy(), np.asarray(jt.data)), f"{tag}: table"
        assert torch.equal(kt.data, pt.data), f"{tag}: lane code table"
        unowned += int((po.slot == N).sum())
    assert unowned > 0, "padding lanes must report D * n_local"


def test_sharded_decide_matches_pallas_interpret(monkeypatch):
    """One small case through the Pallas kernel body itself (interpret
    mode) on every shard. JAX's shard_map refuses the interpret lowering
    (its check_vma wants output vma on the kernel's ShapeDtypeStruct), so
    the shards are composed here by hand: each shard's slice of the table
    and its masked batch (`mask_to_local`) go through
    `pallas_decide.raw_decide_flat`, and the outputs are summed as the
    psum sums them."""
    monkeypatch.setenv("GUBER_PALLAS_INTERPRET", "1")
    assert jpallas.pallas_mode() == "interpret"
    pt = pmesh.create_sharded_table(port_mesh(), NUM_GROUPS, WAYS, "fused")
    pdecide = pmesh.make_sharded_decide(port_mesh(), NUM_GROUPS, WAYS, "fused")
    jrows = np.zeros((N, fused.NCOLS), np.int64)
    gp = NUM_GROUPS // NDEV
    for step, (wave, now) in enumerate(mesh_waves(53, 1)):
        pt, po = pdecide(pt, to_torch(wave), now)
        outs = []
        for d in range(NDEV):
            local = fused.mask_to_local(d, gp, to_torch(wave))
            shard = jfused.FusedTable(jnp.asarray(jrows[d * N_LOCAL:(d + 1) * N_LOCAL]))
            shard, o = jpallas.raw_decide_flat(
                shard, JBatch(*(jnp.asarray(c.numpy()) for c in local)), jnp.int64(now),
                layout="fused", ways=WAYS,
            )
            jrows[d * N_LOCAL:(d + 1) * N_LOCAL] = np.asarray(shard.data)
            outs.append(o)
        for f in OUT_FIELDS:
            want = sum(np.asarray(getattr(o, f)).astype(np.int64) for o in outs)
            got = getattr(po, f).numpy()
            assert np.array_equal(got, want), f"interpret/step{step}: {f}"
        assert np.array_equal(pt.data.numpy(), jrows), f"interpret/step{step}: table"


def test_psum_slot_is_not_a_global_slot(jax_mesh, monkeypatch):
    """The combined `slot` is the psum of what the shards report, not a
    global slot index: a masked lane reports its shard's n_local (32
    here), so the owner's local slot gains (D - 1) * n_local = 224 and a
    padding lane reads D * n_local = 256. Group 48 (shard 6, local slot
    0) -> 224, not 192; group 7 (shard 0, local slot 28) -> 252. `freed`
    comes out int32, `status` int8. The port reproduces it, in the plain
    version and the kernel lane code alike."""
    b = RequestBatch.zeros(8)
    b.key_hi[:] = np.arange(1, 9)
    b.key_lo[:] = np.arange(1, 9) * 7
    b.group[:] = [48, 7, 0, 63, 5, 1, 2, 3]
    b.active[:] = [1, 1, 1, 1, 1, 1, 0, 0]
    b.hits[:] = 1
    b.limit[:] = 10
    b.duration[:] = b.rate_num[:] = b.eff_duration[:] = 1000
    b.created_at[:] = 1000
    jt, jdecide = jax_decide(jax_mesh, "fused", monkeypatch)
    jt, jo = jdecide(jt, to_jax(b), 1000)
    want = [224, 252, 224, 252, 244, 228, 256, 256]
    assert np.asarray(jo.slot).tolist() == want
    pt = pmesh.create_sharded_table(port_mesh(), NUM_GROUPS, WAYS, "fused")
    kt = pmesh.create_sharded_table(port_mesh(), NUM_GROUPS, WAYS, "fused")
    pt, po = pmesh.make_sharded_decide(port_mesh(), NUM_GROUPS, WAYS, "fused")(pt, to_torch(b), 1000)
    ko, _ = cuda_decide.decide_sharded_lane_code_on_host(
        kt.data, None, to_torch(b), 1000, layout="fused", ways=WAYS, n_shards=NDEV
    )
    assert po.slot.tolist() == ko.slot.tolist() == want
    assert po.freed.dtype == ko.freed.dtype == torch.int32
    assert po.status.dtype == torch.int8
    assert_all_fields_equal(po, jo, "slot quirk")
    # the rows themselves sit where a flat table puts them: group 48 way 0
    assert int(pt.data[48 * WAYS, 0]) == 1 and int(pt.data[7 * WAYS, 0]) == 2


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_sharded_mesh_fuzz_matches_oracle(seed):
    """tests/test_mesh_fuzz.py's sequence (seeds 21-23, 60 steps, 30 keys
    over 64 groups, distinct groups per wave) through the port's sharded
    decide, against the oracle."""
    num_groups = 8 * NDEV
    mesh = port_mesh()
    table = pmesh.create_sharded_table(mesh, num_groups, 4, "fused")
    decide = pmesh.make_sharded_decide(mesh, num_groups, 4, "fused")
    oracle = OracleEngine()
    rng = random.Random(seed)
    keys = [f"mf{i}" for i in range(30)]
    now = NOW
    for step in range(60):
        if rng.random() < 0.15:
            now += rng.choice([5, 500, 70_000])
        reqs, used = [], set()
        for _ in range(rng.randrange(1, 17)):
            key = rng.choice(keys)
            behavior = 0
            if rng.random() < 0.08:
                behavior |= 8
            if rng.random() < 0.12:
                behavior |= 32
            kw = dict(
                name="mf", unique_key=key, algorithm=rng.choice([0, 1]),
                behavior=behavior, duration=rng.choice([100, 30_000, 60_000]),
                limit=rng.choice([3, 10, 100]), hits=rng.choice([-1, 0, 1, 2, 5, 40]),
            )
            g = int(key_hash128_batch([f"mf_{key}"], num_groups)[2][0])
            if g in used:
                continue
            used.add(g)
            reqs.append(kw)
        b = encode_batch([RateLimitReq(**kw) for kw in reqs], now, num_groups, 16)
        table, out = decide(table, to_torch(b), now)
        for i, kw in enumerate(reqs):
            want = oracle.decide(JReq(**kw), now)
            got = (int(out.status[i]), int(out.limit[i]),
                   int(out.remaining[i]), int(out.reset_time[i]))
            assert got == (int(want.status), want.limit, want.remaining,
                           want.reset_time), f"seed {seed} step {step} item {i}: {kw}"


# ---------------------------------------------------------------------------
# the paged mesh facade

P_GROUPS = 128
GPP = 8  # -> 16 logical pages, 2 per shard
BUDGET = 16  # 2 frames per shard
# logical page -> frame, each in its page's shard (page lp belongs to
# shard lp // 2, frame pp to shard pp // 2); the other six pages are not
# resident, so their lanes are unowned everywhere
BOUND = {0: 1, 2: 5, 3: 4, 5: 6, 7: 7, 8: 9, 11: 10, 12: 13, 14: 14, 15: 15}


def _paged_waves(seed, steps):
    """mesh_waves over 128 groups, spread over all 16 pages."""
    perm = np.random.default_rng(98).permutation(P_GROUPS).astype(np.int32)
    out = []
    for wave, now in mesh_waves(seed, steps, P_GROUPS):
        wave.group[:] = perm[wave.group]
        out.append((wave, now))
    return out


def paged_kernels(layout, jax_mesh, monkeypatch, budget=BUDGET):
    JK = _jax_program(
        ("paged", layout, budget),
        lambda: jmesh.make_mesh_kernels(jax_mesh, layout, P_GROUPS, WAYS,
                                        page_groups=GPP, page_budget=budget),
        monkeypatch,
    )
    PK = pmesh.make_mesh_kernels(port_mesh(), layout, P_GROUPS, WAYS, page_groups=GPP,
                                 page_budget=budget)
    return JK, PK


def paged_pair(layout, jax_mesh, monkeypatch):
    """The two facades and a table of each with the BOUND pages bound."""
    JK, PK = paged_kernels(layout, jax_mesh, monkeypatch)
    jt, pt = JK.create(), PK.create()
    for lp, pp in BOUND.items():
        jt = JK.bind_page(jt, np.int32(lp), np.int32(pp))
        pt = PK.bind_page(pt, lp, pp)
    return JK, PK, jt, pt


def assert_paged_equal(pt, jt, tag):
    assert np.array_equal(pt.page_map.numpy(), np.asarray(jt.page_map)), f"{tag}: page map"
    assert np.array_equal(pt.data.data.numpy(), np.asarray(jt.data.data)), f"{tag}: frames"


@pytest.mark.parametrize("layout", ["fused", "narrow"])
def test_paged_mesh_decide_matches_jax(layout, jax_mesh, monkeypatch):
    """The paged mesh facade's decide (translation, then ownership in
    physical group space) against JAX `make_mesh_kernels(page_groups>0)`:
    lanes on pages that are not resident are owned by no shard (all
    zeros, slot = D * n_local, no miss counted). The lane code's paged
    prologue agrees."""
    JK, PK, jt, pt = paged_pair(layout, jax_mesh, monkeypatch)
    kt = PK.create()
    for lp, pp in BOUND.items():
        kt = PK.bind_page(kt, lp, pp)
    n_phys = BUDGET * GPP * WAYS
    unowned = 0
    for step, (wave, now) in enumerate(_paged_waves(61, 5)):
        tag = f"{layout}/step{step}"
        pt, po = PK.decide(pt, to_torch(wave), now, WAYS)
        jt, jo = JK.decide(jt, to_jax(wave), now)
        ko, _ = cuda_decide.decide_sharded_lane_code_on_host(
            kt.data.data, kt.page_map, to_torch(wave), now, layout=layout, ways=WAYS,
            n_shards=NDEV, gpp=GPP,
        )
        assert_all_fields_equal(po, jo, tag)
        assert_outputs_equal(ko, po, f"{tag} lane code")
        assert_paged_equal(pt, jt, tag)
        assert torch.equal(kt.data.data, pt.data.data)
        sentinel = torch.from_numpy(wave.active) & (po.slot == n_phys)
        unowned += int(sentinel.sum())
        assert (po.remaining[sentinel] == 0).all() and (po.limit[sentinel] == 0).all()
        assert int(po.misses) + int(po.hits) == int(wave.active.sum()) - int(sentinel.sum())
    assert unowned > 20, "the waves must hit pages that are not resident"
    with pytest.raises(NotImplementedError):
        PK.decide_scan(pt, None, None, WAYS)


def test_paged_mesh_page_ops_match_jax(jax_mesh, monkeypatch):
    """bind / unbind / extract / write page on the paged mesh facade
    address the frame's own rows (its shard's), as JAX's do."""
    JK, PK, jt, pt = paged_pair("fused", jax_mesh, monkeypatch)
    for wave, now in _paged_waves(62, 3):
        pt, _ = PK.decide(pt, to_torch(wave), now, WAYS)
        jt, _ = JK.decide(jt, to_jax(wave), now)
    for pp in (1, 9, 14):
        pr, jr = PK.extract_page(pt, pp), JK.extract_page(jt, np.int32(pp))
        for f in SlotTable._fields:
            assert np.array_equal(getattr(pr, f).numpy(), np.asarray(getattr(jr, f))), (pp, f)
    rows = {f: getattr(PK.extract_page(pt, 9), f).numpy() for f in SlotTable._fields}
    pt = PK.unbind_page(pt, 8, 9)
    jt = JK.unbind_page(jt, np.int32(8), np.int32(9))
    assert_paged_equal(pt, jt, "unbind")
    pt = PK.write_page(pt, 4, 8, SlotTable(**rows))
    jt = JK.write_page(jt, np.int32(4), np.int32(8), JSlotTable(**{f: jnp.asarray(v) for f, v in rows.items()}))
    assert_paged_equal(pt, jt, "write")
    pt = PK.bind_page(pt, 9, 3)
    jt = JK.bind_page(jt, np.int32(9), np.int32(3))
    assert_paged_equal(pt, jt, "bind")


def test_sharded_pager_matches_jax(jax_mesh, monkeypatch):
    """Pager(n_shards=8) against the JAX Pager on the same paged mesh
    facades, one frame per shard for two pages per shard: frames come
    from the page's own shard pool, victims from that shard's residents;
    page map, free list, host tier, frames and counters agree after every
    ensure_resident."""
    JK, PK = paged_kernels("fused", jax_mesh, monkeypatch, budget=NDEV)
    jt, pt = JK.create(), PK.create()
    jp, pp_ = JPager(JK, n_shards=NDEV), Pager(PK, n_shards=NDEV)
    rng = np.random.default_rng(7)
    table_lock = lockorder.make_lock("engine.table")
    with table_lock:
        for step in range(40):
            # at most one page of each shard per round (one frame each)
            pages = np.unique(rng.integers(0, 16, int(rng.integers(1, 5))))
            pages = pages[np.unique(pages // 2, return_index=True)[1]]
            jt = jp.ensure_resident(jt, pages)
            pt = pp_.ensure_resident(pt, pages)
            if step % 3 == 0:  # give the pages rows, so demotes keep them
                wave, now = _paged_waves(70 + step, 1)[0]
                wave.active[:] &= np.isin(wave.group // GPP, pages)
                jt, _ = JK.decide(jt, to_jax(wave), now)
                pt, _ = PK.decide(pt, to_torch(wave), now, WAYS)
            assert pp_.page_map.tolist() == jp.page_map.tolist(), step
            assert pp_.free == jp.free, step
            assert sorted(pp_.host_tier) == sorted(jp.host_tier), step
            for lp in range(16):
                if pp_.page_map[lp] >= 0:
                    assert pp_.shard_of_frame(pp_.page_map[lp]) == pp_.shard_of_page(lp)
            assert_paged_equal(pt, jt, f"step {step}")
        assert (pp_.demotes, pp_.promotes, pp_.binds) == (jp.demotes, jp.promotes, jp.binds)
        assert pp_.demotes > 0 and pp_.promotes > 0
        assert pp_.pages_snapshot() == jp.pages_snapshot()


# ---------------------------------------------------------------------------
# refusals


def test_mesh_refusals():
    """A mesh spanning two devices, a shard count that does not divide
    the groups, the page budget or the logical pages: each raises."""
    with pytest.raises(NotImplementedError, match="several"):
        pmesh.make_mesh([torch.device("cuda", 0), torch.device("cuda", 1)])
    with pytest.raises(NotImplementedError, match="several"):
        pmesh.make_mesh(["cpu", "cuda:0"])
    assert pmesh.make_mesh(["cuda", "cuda:0"]).size == 2  # the same card
    mesh = port_mesh()
    with pytest.raises(ValueError, match="divide"):
        pmesh.make_sharded_decide(mesh, 60, WAYS)
    with pytest.raises(ValueError, match="divide"):
        pmesh.make_mesh_kernels(mesh, "fused", 60, WAYS)
    with pytest.raises(ValueError, match="multiple of mesh size"):
        pmesh.make_mesh_kernels(mesh, "fused", P_GROUPS, WAYS, page_groups=GPP, page_budget=12)
    PK = pmesh.make_mesh_kernels(mesh, "fused", P_GROUPS, WAYS, page_groups=32, page_budget=8)
    with pytest.raises(ValueError, match="logical page count"):
        Pager(PK, n_shards=NDEV)  # 4 logical pages over 8 shards
    with pytest.raises(ValueError):
        cuda_decide.decide_sharded(torch.zeros((N, 10), dtype=torch.int64), None,
                                   to_torch(RequestBatch.zeros(4)), NOW,
                                   layout="fused", ways=WAYS, n_shards=3)


def test_sharded_wave_launches_nothing_on_cpu():
    """On a CPU table the sharded wave is the plain version: no kernel
    count moves, and the table equals a flat wave's table after the same
    waves (the sharded image is the flat image)."""
    before = dict(cuda_decide.CONFIG_LAUNCHES)
    mesh = port_mesh()
    st = pmesh.create_sharded_table(mesh, NUM_GROUPS, WAYS, "narrow")
    ft = pmesh.create_sharded_table(mesh, NUM_GROUPS, WAYS, "narrow")
    decide = pmesh.make_sharded_decide(mesh, NUM_GROUPS, WAYS, "narrow")
    for wave, now in mesh_waves(54, 4):
        st, so = decide(st, to_torch(wave), now)
        _, fo = cuda_decide.decide_flat(ft, to_torch(wave), now, layout="narrow", ways=WAYS)
        act = torch.from_numpy(wave.active)
        for f in ("status", "limit", "remaining", "reset_time", "evicted_hi", "evicted_lo"):
            assert torch.equal(getattr(so, f), getattr(fo, f)), f
        assert torch.equal(so.slot[act], fo.slot[act] % N_LOCAL + (NDEV - 1) * N_LOCAL)
        assert torch.equal(st.data, ft.data)
    assert cuda_decide.CONFIG_LAUNCHES == before
