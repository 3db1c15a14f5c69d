"""The port's GLOBAL replica tier (`parallel/ici.py`) against the JAX
package's (`gubernator_tpu/parallel/ici.py`).

The JAX tier runs on 8 XLA host devices faked on one CPU
(tests/conftest.py) with its replica decide under GUBER_KERNEL=pallas
(each device's `raw_decide_flat`, reference lowering: the TPU kernel's
route); the port's replicas are 8 shards on `cpu`, one (D, N, C) stack,
decided by the sharded wave's plain version (`fused.sharded_plain`)
over the pair-encoded group column. The same seeded numpy waves go
through both. Compared bit for bit: every DecideOutput field with its
dtype, the stacked tables, `pending`, `tick`, the sync tick's `diag`,
and `group_fps` as uint64 (the JAX closure itself, reached through the
jitted sync step). The host twin of the sharded kernel's lane code is
held against the plain version in the replica geometry. Tolerance:
none (all int64).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gubernator_tpu.ops.inject import InjectBatch as JInject
from gubernator_tpu.parallel import ici as jici
from gubernator_tpu.parallel import mesh as jmesh
from gubernator_tpu_torch.ops import cuda_decide, fused
from gubernator_tpu_torch.ops.inject import InjectBatch
from gubernator_tpu_torch.ops.layout import RequestBatch, stack_batches
from gubernator_tpu_torch.parallel import ici
from gubernator_tpu_torch.parallel import mesh as pmesh
from test_torch_decide import NOW, fuzz_wave, to_jax, to_torch
from test_torch_mesh import assert_all_fields_equal

NDEV = 8
SLOTS = 64  # per replica: 16 groups of 4 ways (2 per owner), or 64 of 1
GLOBAL = 2

_PROGRAMS = {}


@pytest.fixture(scope="module")
def jax_mesh():
    devices = jax.devices()
    assert len(devices) >= NDEV
    return jmesh.make_mesh(devices[:NDEV])


def port_mesh():
    return pmesh.make_mesh(["cpu"] * NDEV)


def jax_program(kind, jm, ways, layout, cap=None, num_slots=SLOTS):
    """One JAX program per configuration for the module (each is a jit
    to compile), its replica decide routed to the Pallas kernel's
    reference lowering (GUBER_KERNEL=pallas, read at build)."""
    key = (kind, num_slots, ways, layout, cap)
    if key not in _PROGRAMS:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("GUBER_KERNEL", "pallas")
            if kind == "sync":
                prog = jici.make_sync_step(jm, num_slots, ways, layout, max_sync_groups=cap)
            else:
                make = {"decide": jici.make_replica_decide,
                        "scan": jici.make_replica_decide_scan,
                        "inject": jici.make_inject_replicas}[kind]
                prog = make(jm, num_slots, ways, layout)
        _PROGRAMS[key] = prog
    return _PROGRAMS[key]


def replica_wave(rng, now, num_rgroups):
    """`fuzz_wave`'s lanes (evictions, RESET_REMAINING frees, both
    algorithms, padding lanes) made mostly GLOBAL, with a home per lane;
    a third of the lanes repeat another lane's key on another home (the
    same key on two replicas in one wave), one active lane has no
    replica (home -1), and (home, group) pairs are distinct, as the
    engine's assembler makes them. Returns (host batch, homes)."""
    b = fuzz_wave(rng, now, num_rgroups)
    n = len(b.active)
    b.behavior[:] |= np.where(rng.random(n) < 0.8, GLOBAL, 0).astype(np.int32)
    home = rng.integers(0, NDEV, n).astype(np.int64)
    act = np.nonzero(b.active)[0]
    for i in range(n):
        if rng.random() < 0.3:
            j = int(rng.choice(act))
            for col in b:
                col[i] = col[j]
            b.hits[i] = int(rng.choice([0, 1, 2, 5]))
    seen = set()
    for i in range(n):
        if b.active[i]:
            if (home[i], b.group[i]) in seen:
                b.active[i] = False
            else:
                seen.add((home[i], b.group[i]))
    home[int(np.nonzero(b.active)[0][-1])] = -1
    return b, home


def _waves(seed, steps, num_rgroups):
    rng = np.random.default_rng(seed)
    now = NOW
    out = []
    for _ in range(steps):
        now += int(rng.choice([0, 1, 40, 700, 5000, 70_000], p=[.2, .2, .2, .2, .15, .05]))
        b, home = replica_wave(rng, now, num_rgroups)
        out.append((b, home, now))
    return out


def assert_state_equal(ps: ici.IciState, js, tag):
    for name, a, r in (("table", ps.table.data, js.table.data), ("pending", ps.pending, js.pending),
                       ("tick", ps.tick, js.tick)):
        a, r = a.numpy(), np.asarray(r)
        assert a.dtype == r.dtype and a.shape == r.shape, (tag, name, a.shape, r.shape)
        if not np.array_equal(a, r):
            bad = np.argwhere(a != r)[:5].tolist()
            raise AssertionError(f"{tag}: {name} diverged at {bad}")


@pytest.mark.parametrize("layout", ["fused", "narrow"])
def test_create_ici_state(jax_mesh, layout):
    ps = ici.create_ici_state(port_mesh(), SLOTS, 4, layout)
    js = jici.create_ici_state(jax_mesh, SLOTS, 4, layout)
    assert_state_equal(ps, js, "create")
    with pytest.raises(ValueError, match="divide"):
        ici.create_ici_state(port_mesh(), 60, 4, layout)  # 15 groups over 8 replicas


@pytest.mark.parametrize("layout,ways,seed", [
    ("fused", 4, 1), ("fused", 1, 2), ("narrow", 4, 3), ("narrow", 1, 4)])
def test_replica_decide_matches_jax(jax_mesh, layout, ways, seed):
    """Replica waves: answers, stacked tables and pending deltas equal
    after every wave (evictions and RESET_REMAINING frees drop pending,
    non-owned GLOBAL hits add to it, padding lanes touch nothing)."""
    num_rgroups = SLOTS // ways
    jdecide = jax_program("decide", jax_mesh, ways, layout)
    pdecide = ici.make_replica_decide(port_mesh(), SLOTS, ways, layout)
    js = jici.create_ici_state(jax_mesh, SLOTS, ways, layout)
    ps = ici.create_ici_state(port_mesh(), SLOTS, ways, layout)
    pending_seen = 0
    for w, (b, home, now) in enumerate(_waves(seed, 10, num_rgroups)):
        js, jo = jdecide(js, to_jax(b), jnp.asarray(home), now)
        ps, po = pdecide(ps, to_torch(b), torch.from_numpy(home), now)
        assert_all_fields_equal(po, jo, f"wave {w}")
        assert_state_equal(ps, js, f"wave {w}")
        pending_seen += int((ps.pending != 0).sum())
        assert int(po.slot[~to_torch(b).active].min()) == NDEV * SLOTS
    assert pending_seen > 0


def test_replica_decide_scan_matches_jax(jax_mesh):
    ways, layout = 4, "fused"
    waves = _waves(11, 6, SLOTS // ways)
    jscan = jax_program("scan", jax_mesh, ways, layout)
    pscan = ici.make_replica_decide_scan(port_mesh(), SLOTS, ways, layout)
    js = jici.create_ici_state(jax_mesh, SLOTS, ways, layout)
    ps = ici.create_ici_state(port_mesh(), SLOTS, ways, layout)
    hb = stack_batches([b for b, _, _ in waves])
    homes = np.stack([h for _, h, _ in waves])
    nows = np.array([t for _, _, t in waves], np.int64)
    js, jo = jscan(js, to_jax(hb), jnp.asarray(homes), jnp.asarray(nows))
    ps, po = pscan(ps, RequestBatch(*(torch.from_numpy(np.ascontiguousarray(c)) for c in hb)),
                   torch.from_numpy(homes), nows)
    assert_all_fields_equal(po, jo, "scan")
    assert_state_equal(ps, js, "scan")


def _inject_items(rng, num_rgroups, keys):
    """Authoritative rows for `keys` (distinct groups per call, as the
    engine's assembler places them)."""
    b = InjectBatch.zeros(len(keys))
    seen = set()
    for i, (hi, lo, g) in enumerate(keys):
        if g in seen:
            continue
        seen.add(g)
        leaky = bool(rng.random() < 0.4)
        b.key_hi[i], b.key_lo[i], b.group[i] = hi, lo, g
        b.algo[i] = int(leaky)
        b.status[i] = int(rng.integers(0, 2))
        b.limit[i] = int(rng.integers(1, 100))
        b.duration[i] = int(rng.choice([1000, 60_000]))
        b.remaining[i] = int(rng.integers(0, 100)) << (20 if leaky else 0)
        b.stamp[i] = NOW
        b.expire_at[i] = NOW + int(rng.integers(1, 120_000))
        b.burst[i] = b.limit[i] if leaky else 0
        b.active[i] = True
    return b


@pytest.mark.parametrize("layout", ["fused", "narrow"])
def test_inject_replicas_matches_jax(jax_mesh, layout):
    """An authoritative push lands on every replica and clears the
    pending of the slot each key now occupies, on replicas that held the
    key, held it at another way, or lacked it (an eviction)."""
    ways = 4
    num_rgroups = SLOTS // ways
    jdecide = jax_program("decide", jax_mesh, ways, layout)
    jinject = jax_program("inject", jax_mesh, ways, layout)
    pdecide = ici.make_replica_decide(port_mesh(), SLOTS, ways, layout)
    pinject = ici.make_inject_replicas(port_mesh(), SLOTS, ways, layout)
    js = jici.create_ici_state(jax_mesh, SLOTS, ways, layout)
    ps = ici.create_ici_state(port_mesh(), SLOTS, ways, layout)
    rng = np.random.default_rng(21)
    waves = _waves(22, 4, num_rgroups)
    for b, home, now in waves:
        js, _ = jdecide(js, to_jax(b), jnp.asarray(home), now)
        ps, _ = pdecide(ps, to_torch(b), torch.from_numpy(home), now)
    assert int((ps.pending != 0).sum()) > 0
    b0 = waves[-1][0]
    keys = [(int(b0.key_hi[i]), int(b0.key_lo[i]), int(b0.group[i]))
            for i in np.nonzero(b0.active)[0]]
    keys += [(1000 + i, 2000 + i, i % num_rgroups) for i in range(3)]  # new keys
    items = _inject_items(rng, num_rgroups, keys)
    now = waves[-1][2] + 5
    js = jinject(js, JInject(*(jnp.asarray(c) for c in items)), now)
    ps = pinject(ps, items.to_device("cpu"), now)
    assert_state_equal(ps, js, "inject")


def _jax_group_fps(jsync):
    """The JAX tick's `group_fps` closure, reached through the jitted
    sync step (sync_fn -> sharded -> local)."""
    def cells(fn):
        return {n: c.cell_contents for n, c in zip(fn.__code__.co_freevars, fn.__closure__)}

    local = inspect.unwrap(cells(inspect.unwrap(jsync))["sharded"])
    return cells(local)["group_fps"]


@pytest.mark.parametrize("layout", ["fused", "narrow"])
def test_group_fps_bit_for_bit(jax_mesh, layout):
    """Both fingerprints of every group of every replica, as uint64,
    after replica traffic made the replicas diverge."""
    ways = 4
    jsync = jax_program("sync", jax_mesh, ways, layout, cap=2)
    jfps = _jax_group_fps(jsync)
    pdecide = ici.make_replica_decide(port_mesh(), SLOTS, ways, layout)
    ps = ici.create_ici_state(port_mesh(), SLOTS, ways, layout)
    for b, home, now in _waves(31, 4, SLOTS // ways):
        ps, _ = pdecide(ps, to_torch(b), torch.from_numpy(home), now)
    p1, p2 = ici.group_fps(ps.table.data, ps.pending, ways)
    table_cls = type(jici.create_ici_state(jax_mesh, SLOTS, ways, layout).table)
    distinct = set()
    for d in range(NDEV):
        j1, j2 = jfps(table_cls(jnp.asarray(ps.table.data[d].numpy())),
                      jnp.asarray(ps.pending[d].numpy()))
        for p, j in ((p1, j1), (p2, j2)):
            got = p[d].numpy().view(np.uint64)
            want = np.asarray(j)
            assert want.dtype == np.uint64
            assert np.array_equal(got, want), (d, got, want)
        distinct.add(p1[d].numpy().tobytes())
    assert len(distinct) > 1, "the replicas should have diverged"


def _sync_rounds(jax_mesh, layout, ways, cap, seed, rounds=4):
    num_rgroups = SLOTS // ways
    jdecide = jax_program("decide", jax_mesh, ways, layout)
    jsync = jax_program("sync", jax_mesh, ways, layout, cap=cap)
    pdecide = ici.make_replica_decide(port_mesh(), SLOTS, ways, layout)
    psync = ici.make_sync_step(port_mesh(), SLOTS, ways, layout, max_sync_groups=cap)
    js = jici.create_ici_state(jax_mesh, SLOTS, ways, layout)
    ps = ici.create_ici_state(port_mesh(), SLOTS, ways, layout)
    waves = _waves(seed, 3 * rounds, num_rgroups)
    diags = []
    for r in range(rounds):
        for b, home, now in waves[3 * r:3 * r + 3]:
            js, _ = jdecide(js, to_jax(b), jnp.asarray(home), now)
            ps, _ = pdecide(ps, to_torch(b), torch.from_numpy(home), now)
        for k in range(2):  # a second tick at the same `now`: the tick counter rotates
            js, jd = jsync(js, now)
            ps, pd = psync(ps, now)
            jd = np.asarray(jd)
            assert pd.numpy().dtype == jd.dtype and np.array_equal(pd.numpy(), jd), (r, k, pd, jd)
            assert_state_equal(ps, js, f"round {r} tick {k}")
            diags.append(jd)
    return np.stack(diags)


@pytest.mark.parametrize("layout,ways,cap,seed", [
    ("fused", 4, None, 41), ("fused", 4, 2, 42), ("narrow", 4, 2, 43), ("fused", 1, None, 44)])
def test_sync_step_matches_jax(jax_mesh, layout, ways, cap, seed):
    """Seeded rounds of replica traffic, each followed by two ticks:
    table, pending, tick and diag equal after every tick, uncapped and
    capped at 2 groups per tick (tests/test_ici_fuzz.py's cap), with
    overflow (kept and dropped survivors) and, capped, a backlog."""
    diags = _sync_rounds(jax_mesh, layout, ways, cap, seed)
    if cap is not None:
        assert diags[:, :, 2].max() > 0, "the cap must leave a backlog"
    assert diags[:, :, 0].max() > 0 or diags[:, :, 1].max() > 0, "no overflow occurred"


@pytest.mark.parametrize("layout", ["fused", "narrow"])
def test_replica_lane_code_on_host(layout):
    """The sharded kernel's lane code (g++ build of csrc/decide_lane.cuh,
    the team emulated) in the replica geometry: D = 8 stacked replicas
    as 8 shards of `num_rgroups` groups, the pair column routing each
    lane to its home. Outputs and stacked tables equal the plain
    version's after every wave."""
    ways = 4
    num_rgroups = SLOTS // ways
    a = ici.create_ici_state(port_mesh(), SLOTS, ways, layout)
    b_ = ici.create_ici_state(port_mesh(), SLOTS, ways, layout)
    codec = cuda_decide.CODECS[layout]
    for w, (hb, home, now) in enumerate(_waves(51, 8, num_rgroups)):
        db = to_torch(hb)
        pb = db._replace(group=ici.pair_groups(torch.from_numpy(home), db.group, db.active,
                                               NDEV, num_rgroups))
        ho, hs = cuda_decide.decide_sharded_lane_code_on_host(
            ici.replica_rows(a), None, pb, now, layout=layout, ways=ways, n_shards=NDEV)
        po, ps = fused.sharded_plain(codec, ici.replica_rows(b_), None, pb, now, ways=ways,
                                     n_shards=NDEV)
        for f in po._fields:
            x, y = getattr(ho, f), getattr(po, f)
            assert x.dtype == y.dtype and torch.equal(x, y), (w, f)
        assert all(int(x) == int(y) for x, y in zip(hs, ps)), w
        assert torch.equal(a.table.data, b_.table.data), w


@pytest.mark.parametrize("cap", [None, 2])
def test_untouched_tick_matches_jax(jax_mesh, cap):
    """The tick of a state no wave or inject has touched (every row
    zero) only advances the counter (`untouched=True`, which IciEngine's
    replica tier passes until its first wave): the same state and diag
    as the JAX tick's full program on the same empty state, twice."""
    ways, layout = 4, "fused"
    jsync = jax_program("sync", jax_mesh, ways, layout, cap=cap)
    psync = ici.make_sync_step(port_mesh(), SLOTS, ways, layout, max_sync_groups=cap)
    js = jici.create_ici_state(jax_mesh, SLOTS, ways, layout)
    ps = ici.create_ici_state(port_mesh(), SLOTS, ways, layout)
    for k in range(2):
        js, jd = jsync(js, NOW + k)
        ps, pd = psync(ps, NOW + k, untouched=True)
        assert np.array_equal(pd.numpy(), np.asarray(jd)), (k, pd, jd)
        assert_state_equal(ps, js, f"tick {k}")
