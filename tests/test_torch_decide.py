"""The port's fused decide wave against the JAX package's.

The same seeded numpy waves go through:

- `gubernator_tpu_torch.ops.fused.decide_fused_plain` (the plain
  PyTorch version, the path a CPU table takes);
- `gubernator_tpu_torch.ops.cuda_decide.decide_lane_code_on_host` (the
  CUDA kernel's per-lane C++, built by g++ and run lane after lane);
- `gubernator_tpu.ops.fused._decide_fused_impl` (the XLA program);
- `gubernator_tpu.ops.pallas_decide.decide_flat_with_scan` in its
  reference lowering and, for one small case, in interpret mode (the
  Pallas kernel body itself).

Tolerance: none. Everything is int64 and must be bit-equal: every
DecideOutput field, the five WaveScan sums, and the whole table (via
`unpack_table`). Request sequences are also held against the oracle
(`gubernator_tpu.models.oracle`).
"""

import dataclasses
import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gubernator_tpu.api.types import (
    Algorithm as JAlgorithm,
    Behavior as JBehavior,
    RateLimitReq as JReq,
)
from gubernator_tpu.models.oracle import OracleEngine
from gubernator_tpu.ops import fused as jfused
from gubernator_tpu.ops import pallas_decide as jpallas
from gubernator_tpu.ops.layout import RequestBatch as JBatch
from gubernator_tpu.utils.gregorian import GREGORIAN_MINUTES
from gubernator_tpu_torch.api.types import RateLimitReq
from gubernator_tpu_torch.ops import cuda_decide, fused
from gubernator_tpu_torch.ops.encode import encode_batch
from gubernator_tpu_torch.ops.kernels import get_kernels
from gubernator_tpu_torch.ops.layout import RequestBatch, batch_to_device

NOW = 1_753_700_000_000
NUM_GROUPS = 64
WAYS = 8
B = 64

OUT_FIELDS = (
    "status", "limit", "remaining", "reset_time", "slot", "evicted_hi",
    "evicted_lo", "freed", "hits", "misses", "unexpired_evictions",
    "over_limit",
)

_xla_decide = jax.jit(
    functools.partial(jfused._decide_fused_impl, ways=WAYS)
)


_LIMITS = [-50, -1, 0, 1, 5, 20, 99, 1000]
_DURATIONS = [0, 100, 700, 30_000, 600_000, 600_000]
_BURSTS = [0, 1, 5, 30, 200]
_krng = np.random.default_rng(1234)
_KEY_ALGO = _krng.choice([0, 1], 1500)
_KEY_LIMIT = _krng.choice(_LIMITS, 1500)
_KEY_DURATION = _krng.choice(_DURATIONS, 1500)
_KEY_BURST = _krng.choice(_BURSTS, 1500)


def fuzz_wave(rng, now, num_groups=NUM_GROUPS):
    """One wave as host numpy columns, modelled on the Pallas fuzz
    (tests/test_kernel_fuzz.py `_pallas_reqs`) and widened: negative and
    zero limits and hits, leaky lanes whose burst took their limit (as
    encode does for burst 0), Gregorian lanes, created_at behind `now`,
    and enough keys per group to force evictions. Active lanes have
    distinct groups (the assembler's invariant)."""
    hot = rng.random(B) < 0.5
    ki = np.where(hot, rng.integers(0, 24, B), rng.integers(24, 1500, B))
    hi = np.array([(int(k) * 2654435761) % (1 << 62) + 1 for k in ki], np.int64)
    lo = np.array(
        [(int(k) * 1140071481932319848) % (1 << 62) for k in ki], np.int64
    )
    b = RequestBatch.zeros(B)
    b.key_hi[:] = hi
    b.key_lo[:] = lo
    # hot keys spread over the groups; cold keys crowd 8 of them so
    # groups fill and live entries get evicted
    b.group[:] = np.where(ki < 24, ki, 24 + ki % 8) % num_groups
    # a key keeps its own parameters (as callers do) 85% of the time,
    # so steady-state paths run; the rest change them mid-life
    own = rng.random(B) < 0.85
    b.algo[:] = np.where(own, _KEY_ALGO[ki], rng.choice([0, 1], B))
    b.behavior[:] = rng.choice(
        [0, 0, 0, 8, 32, 40, 4, 36], B
    ).astype(np.int32)
    b.hits[:] = rng.choice([-3, 0, 1, 1, 2, 4, 9, 150], B)
    b.limit[:] = np.where(own, _KEY_LIMIT[ki], rng.choice(_LIMITS, B))
    b.duration[:] = np.where(own, _KEY_DURATION[ki], rng.choice(_DURATIONS, B))
    greg = (b.behavior & 4) != 0
    b.rate_num[:] = np.where(greg, 60_000, b.duration)
    b.eff_duration[:] = np.where(greg, rng.integers(1, 60_000, B), b.duration)
    b.greg_expire[:] = np.where(greg, now + b.eff_duration, 0)
    burst = np.where(own, _KEY_BURST[ki], rng.choice(_BURSTS, B))
    leaky = b.algo == 1
    b.burst[:] = np.where(leaky & (burst == 0), b.limit, burst)
    b.created_at[:] = now - rng.choice([0, 0, 0, 1, 250, 5000], B)
    act = rng.random(B) < 0.9
    seen = set()
    for i, g in enumerate(b.group.tolist()):
        if act[i]:
            if g in seen:
                act[i] = False
            else:
                seen.add(g)
    b.active[:] = act
    return b


def to_jax(b):
    return JBatch(*(jnp.asarray(c) for c in b))


def to_torch(b):
    return batch_to_device(b, "cpu")


def assert_out_equal(port, ref, tag):
    for f in OUT_FIELDS:
        a = getattr(port, f).numpy()
        r = np.asarray(getattr(ref, f))
        assert a.dtype == r.dtype or f in ("freed",), (tag, f, a.dtype, r.dtype)
        assert np.array_equal(a, r), f"{tag}: {f} diverged\nport={a}\nref={r}"


def assert_scan_equal(port, ref, tag):
    for f in port._fields:
        a, r = int(getattr(port, f)), int(getattr(ref, f))
        assert a == r, f"{tag}: WaveScan.{f} port={a} ref={r}"


def assert_table_equal(port_table, jax_table, tag):
    pw = fused.unpack_table(port_table)
    jw = jfused.unpack_table(jax_table)
    for f in pw._fields:
        a = getattr(pw, f).numpy()
        r = np.asarray(getattr(jw, f))
        assert a.dtype == r.dtype, (tag, f, a.dtype, r.dtype)
        assert np.array_equal(a, r), f"{tag}: table column {f} diverged"


def _waves(seed, steps):
    rng = np.random.default_rng(seed)
    now = NOW
    out = []
    for _ in range(steps):
        now += int(rng.choice([0, 1, 40, 700, 5000, 70_000], p=[.2, .2, .2, .2, .15, .05]))
        out.append((fuzz_wave(rng, now), now))
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_plain_matches_xla_impl(seed):
    """decide_fused_plain vs _decide_fused_impl: outputs and the whole
    table after every wave of a multi-wave fuzz."""
    pt = fused.FusedTable.create(NUM_GROUPS, WAYS, device="cpu")
    jt = jfused.FusedTable.create(NUM_GROUPS, WAYS)
    for step, (wave, now) in enumerate(_waves(seed, 12)):
        pt, po, _ = fused.decide_fused_plain(pt, to_torch(wave), now, ways=WAYS)
        jt, jo = _xla_decide(jt, to_jax(wave), jnp.int64(now))
        assert_out_equal(po, jo, f"seed{seed}/step{step}")
        assert_table_equal(pt, jt, f"seed{seed}/step{step}")


@pytest.mark.parametrize("seed", [4, 5])
def test_plain_matches_pallas_reference(seed, monkeypatch):
    """decide_fused_plain vs pallas decide_flat_with_scan (reference
    lowering): outputs, WaveScan sums and table."""
    monkeypatch.setenv("GUBER_PALLAS_INTERPRET", "0")
    pt = fused.FusedTable.create(NUM_GROUPS, WAYS, device="cpu")
    jt = jfused.FusedTable.create(NUM_GROUPS, WAYS)
    for step, (wave, now) in enumerate(_waves(seed, 10)):
        pt, po, ps = fused.decide_fused_plain(pt, to_torch(wave), now, ways=WAYS)
        jt, jo, js = jpallas.decide_flat_with_scan(
            jt, to_jax(wave), jnp.int64(now), layout="fused", ways=WAYS
        )
        tag = f"seed{seed}/step{step}"
        assert_out_equal(po, jo, tag)
        assert_scan_equal(ps, js, tag)
        assert_table_equal(pt, jt, tag)


def test_plain_matches_pallas_interpret(monkeypatch):
    """One small case through the Pallas kernel body itself
    (pl.pallas_call in interpret mode)."""
    monkeypatch.setenv("GUBER_PALLAS_INTERPRET", "1")
    assert jpallas.pallas_mode() == "interpret"
    pt = fused.FusedTable.create(NUM_GROUPS, WAYS, device="cpu")
    jt = jfused.FusedTable.create(NUM_GROUPS, WAYS)
    for step, (wave, now) in enumerate(_waves(6, 3)):
        pt, po, ps = fused.decide_fused_plain(pt, to_torch(wave), now, ways=WAYS)
        jt, jo, js = jpallas.decide_flat_with_scan(
            jt, to_jax(wave), jnp.int64(now), layout="fused", ways=WAYS
        )
        tag = f"interpret/step{step}"
        assert_out_equal(po, jo, tag)
        assert_scan_equal(ps, js, tag)
        assert_table_equal(pt, jt, tag)


def test_leaky_fraction_kept_at_burst_boundary():
    """A leak that lands the bucket on exactly `burst` whole tokens plus
    a fraction keeps the fraction (the clamp is strictly above burst):
    plain version, kernel lane code and the XLA program store the same
    Q44.20 remaining."""
    def wave(hits, now):
        b = RequestBatch.zeros(1)
        b.key_hi[0], b.key_lo[0], b.group[0] = 77, 5, 5
        b.algo[0], b.hits[0], b.limit[0], b.burst[0] = 1, hits, 5, 5
        b.duration[0] = b.rate_num[0] = b.eff_duration[0] = 700
        b.created_at[0], b.active[0] = now, True
        return b

    pt = fused.FusedTable.create(NUM_GROUPS, WAYS, device="cpu")
    kt = fused.FusedTable.create(NUM_GROUPS, WAYS, device="cpu")
    jt = jfused.FusedTable.create(NUM_GROUPS, WAYS)
    for hits, now in ((1, NOW), (0, NOW + 150), (1, NOW + 200)):
        w = wave(hits, now)
        pt, po, _ = fused.decide_fused_plain(pt, to_torch(w), now, ways=WAYS)
        kt, ko, _ = cuda_decide.decide_lane_code_on_host(kt, to_torch(w), now, ways=WAYS)
        jt, jo = _xla_decide(jt, to_jax(w), jnp.int64(now))
        assert_out_equal(po, jo, f"t={now - NOW}")
        assert torch.equal(kt.data, pt.data)
        assert_table_equal(pt, jt, f"t={now - NOW}")
        if hits == 0:  # 4 + 150 ms x 5/700 = 5.07 tokens
            rem = int(pt.data[int(po.slot[0]), fused.REM])
            assert rem >> 20 == 5 and rem & ((1 << 20) - 1) != 0


@pytest.mark.parametrize("seed", [7, 8])
def test_kernel_lane_code_matches_plain(seed):
    """The CUDA kernel's per-lane C++ (csrc/decide_lane.cuh, built by
    g++ for the host) vs the plain version: outputs, scalars, table."""
    pt = fused.FusedTable.create(NUM_GROUPS, WAYS, device="cpu")
    kt = fused.FusedTable.create(NUM_GROUPS, WAYS, device="cpu")
    for step, (wave, now) in enumerate(_waves(seed, 12)):
        pt, po, ps = fused.decide_fused_plain(pt, to_torch(wave), now, ways=WAYS)
        kt, ko, ks = cuda_decide.decide_lane_code_on_host(
            kt, to_torch(wave), now, ways=WAYS
        )
        tag = f"seed{seed}/step{step}"
        for f in OUT_FIELDS:
            a, r = getattr(ko, f), getattr(po, f)
            assert a.dtype == r.dtype, (tag, f)
            assert torch.equal(a, r), f"{tag}: {f} diverged"
        for f in ps._fields:
            assert int(getattr(ks, f)) == int(getattr(ps, f)), (tag, f)
        assert torch.equal(kt.data, pt.data), f"{tag}: table diverged"


def test_pack_unpack_gather_match_jax():
    """pack_table / unpack_table / gather_rows_fused against the JAX
    layout on a seeded wide image."""
    rng = np.random.default_rng(9)
    n = NUM_GROUPS * WAYS
    wide = {
        "key_hi": rng.integers(-(1 << 62), 1 << 62, n),
        "key_lo": rng.integers(-(1 << 62), 1 << 62, n),
        "used": rng.random(n) < 0.7,
        "algo": rng.integers(0, 2, n).astype(np.int8),
        "status": rng.integers(0, 2, n).astype(np.int8),
        "limit": rng.integers(-100, 1000, n),
        "duration": rng.integers(0, 60_000, n),
        "remaining": rng.integers(0, 1 << 40, n),
        "stamp": NOW - rng.integers(0, 60_000, n),
        "expire_at": NOW + rng.integers(-60_000, 60_000, n),
        "invalid_at": np.where(rng.random(n) < 0.1, NOW + 5, 0),
        "burst": rng.integers(0, 1000, n),
        "lru": NOW - rng.integers(0, 60_000, n),
    }
    from gubernator_tpu.ops.layout import SlotTable as JSlotTable
    from gubernator_tpu_torch.ops.layout import SlotTable

    pt = fused.pack_table(SlotTable(**wide), device="cpu")
    jt = jfused.pack_table(JSlotTable(**{k: jnp.asarray(v) for k, v in wide.items()}))
    assert np.array_equal(pt.data.numpy(), np.asarray(jt.data))
    assert_table_equal(pt, jt, "pack")
    slots = np.array([0, 5, n - 1, n, 17], np.int64)
    pr = fused.gather_rows_fused(pt, torch.from_numpy(slots))
    jr = jfused.gather_rows_fused(jt, jnp.asarray(slots))
    for f in pr._fields:
        assert np.array_equal(getattr(pr, f).numpy(), np.asarray(getattr(jr, f))), f


def _oracle_stream(seed, n):
    """Request sequences on few keys (the oracle fuzz's shape, widened
    with negative limits and leaky burst 0)."""
    rng = random.Random(seed)
    keys = [f"acct:{i}" for i in range(12)]
    now = NOW
    seq = []
    for _ in range(n):
        behavior = 0
        if rng.random() < 0.08:
            behavior |= 8
        if rng.random() < 0.15:
            behavior |= 32
        if rng.random() < 0.08:
            behavior |= 4
        seq.append((
            dict(
                name="rl", unique_key=rng.choice(keys),
                algorithm=rng.choice([0, 1]), behavior=behavior,
                duration=GREGORIAN_MINUTES if behavior & 4
                else rng.choice([0, 5, 100, 1000, 30_000]),
                limit=rng.choice([-20, -1, 0, 1, 2, 10, 100, 2000]),
                hits=rng.choice([-5, 0, 1, 1, 2, 5, 99, 3000]),
                burst=rng.choice([0, 0, 0, 5, 30]),
            ),
            now,
        ))
        now += rng.choice([0, 0, 1, 7, 50, 500, 3000, 61_000])
    return seq


@pytest.mark.parametrize("path", ["plain", "kernel_lane_code"])
@pytest.mark.parametrize("seed", [11, 12])
def test_single_requests_match_oracle(seed, path):
    """One request per wave through the port's encode + decide, against
    the oracle (the JAX package's executable spec)."""
    oracle = OracleEngine()
    decide = (
        fused.decide_fused_plain if path == "plain"
        else cuda_decide.decide_lane_code_on_host
    )
    table = fused.FusedTable.create(NUM_GROUPS, WAYS, device="cpu")
    for i, (kw, now) in enumerate(_oracle_stream(seed, 250)):
        want = oracle.decide(JReq(**kw), now)
        b = encode_batch([RateLimitReq(**kw)], now, NUM_GROUPS, 1)
        table, out, _ = decide(table, to_torch(b), now, ways=WAYS)
        got = (int(out.status[0]), int(out.limit[0]),
               int(out.remaining[0]), int(out.reset_time[0]))
        assert got == (int(want.status), int(want.limit),
                       int(want.remaining), int(want.reset_time)), (i, kw, now)


def test_registry_dispatches_by_device():
    """get_kernels("fused").decide on a CPU table is the plain version
    and launches nothing; a layout name the JAX package does not know is
    refused (the port serves all four of its layouts)."""
    K = get_kernels("fused")
    before = sum(cuda_decide.CONFIG_LAUNCHES.values())
    wave, now = _waves(13, 1)[0]
    t1 = K.create(NUM_GROUPS, WAYS, "cpu")
    t2 = fused.FusedTable.create(NUM_GROUPS, WAYS, device="cpu")
    t1, o1 = K.decide(t1, to_torch(wave), now, WAYS)
    t2, o2, _ = fused.decide_fused_plain(t2, to_torch(wave), now, ways=WAYS)
    assert torch.equal(t1.data, t2.data)
    assert torch.equal(o1.remaining, o2.remaining)
    assert sum(cuda_decide.CONFIG_LAUNCHES.values()) == before
    with pytest.raises(ValueError):
        get_kernels("columnar")


def test_wrapper_refuses_bad_operands():
    """The kernel wrapper's checks run before any launch (here on the
    host lane code, which shares them)."""
    t = fused.FusedTable.create(NUM_GROUPS, WAYS, device="cpu")
    wave = to_torch(_waves(14, 1)[0][0])
    with pytest.raises(ValueError):
        cuda_decide.decide_lane_code_on_host(
            t, wave._replace(group=wave.group.to(torch.int64)), NOW, ways=WAYS
        )
    with pytest.raises(ValueError):
        cuda_decide.decide_lane_code_on_host(
            fused.FusedTable(t.data[:, :9].contiguous()), wave, NOW, ways=WAYS
        )


def test_jax_behavior_constants_match():
    """The port's enum values are the JAX package's (the kernel reads
    behavior bits and algorithm codes directly)."""
    from gubernator_tpu_torch.api.types import Algorithm, Behavior

    for e in Behavior:
        assert int(e) == int(JBehavior[e.name])
    for e in Algorithm:
        assert int(e) == int(JAlgorithm[e.name])
    assert dataclasses.fields(JReq)[0].name == dataclasses.fields(RateLimitReq)[0].name
