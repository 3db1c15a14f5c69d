"""The port's narrow layout against the JAX package's.

The same seeded numpy waves (`fuzz_wave` of test_torch_decide.py) go
through:

- `gubernator_tpu_torch.ops.narrow.decide_narrow_plain` (the plain
  PyTorch version, the path a CPU table takes);
- `cuda_decide.decide_lane_code_on_host(layout="narrow")` (the CUDA
  kernel's per-lane C++, built by g++, narrow and flat);
- `gubernator_tpu.ops.narrow._decide_narrow_impl` (the XLA program);
- `gubernator_tpu.ops.pallas_decide.decide_flat_with_scan(layout=
  "narrow")` in its reference lowering and, for one small case, in
  interpret mode (the Pallas kernel body itself).

Tolerance: none. Everything is int64 and must be bit-equal: every
DecideOutput field, the five WaveScan sums, and the whole table.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gubernator_tpu.ops import narrow as jnarrow
from gubernator_tpu.ops import pallas_decide as jpallas
from gubernator_tpu.ops.layout import SlotTable as JSlotTable
from gubernator_tpu_torch.ops import cuda_decide, fused, narrow
from gubernator_tpu_torch.ops.kernels import BYTES_PER_SLOT, get_kernels
from gubernator_tpu_torch.ops.layout import SlotTable
from test_torch_decide import (
    NOW,
    NUM_GROUPS,
    OUT_FIELDS,
    WAYS,
    _waves,
    assert_out_equal,
    assert_scan_equal,
    to_jax,
    to_torch,
)

MAX_COUNT = (1 << 31) - 1

_xla_decide = jax.jit(functools.partial(jnarrow._decide_narrow_impl, ways=WAYS))


def assert_table_equal(port_table, jax_table, tag):
    """Raw rows and the wide view, column by column."""
    assert np.array_equal(port_table.data.numpy(), np.asarray(jax_table.data)), (
        f"{tag}: narrow rows diverged"
    )
    pw = narrow.unpack_table(port_table)
    jw = jnarrow.unpack_table(jax_table)
    for f in pw._fields:
        a, r = getattr(pw, f).numpy(), np.asarray(getattr(jw, f))
        assert a.dtype == r.dtype, (tag, f, a.dtype, r.dtype)
        assert np.array_equal(a, r), f"{tag}: table column {f} diverged"


def wide_image(rng, n):
    """A wide image whose limit and burst cover the int32 clamp's edges
    (+-(2^31-1), negative values, zero) and whose other columns take
    arbitrary int64 values."""
    edges = np.array([MAX_COUNT, -MAX_COUNT, -1, 0, 1, -50, 1 << 30, -(1 << 30)])
    return {
        "key_hi": rng.integers(-(1 << 62), 1 << 62, n),
        "key_lo": rng.integers(-(1 << 62), 1 << 62, n),
        "used": rng.random(n) < 0.7,
        "algo": rng.integers(0, 2, n).astype(np.int8),
        "status": rng.integers(0, 2, n).astype(np.int8),
        "limit": np.where(rng.random(n) < 0.5, rng.choice(edges, n),
                          rng.integers(-MAX_COUNT, MAX_COUNT, n)),
        "duration": rng.integers(-(1 << 62), 1 << 62, n),
        "remaining": rng.integers(-(1 << 62), 1 << 62, n),
        "stamp": NOW - rng.integers(0, 60_000, n),
        "expire_at": NOW + rng.integers(-60_000, 60_000, n),
        "invalid_at": np.where(rng.random(n) < 0.1, NOW + 5, 0),
        "burst": np.where(rng.random(n) < 0.5, rng.choice(edges, n),
                          rng.integers(-MAX_COUNT, MAX_COUNT, n)),
        "lru": NOW - rng.integers(0, 60_000, n),
    }


def test_pack_unpack_roundtrip_matches_jax():
    """pack_table / unpack_table against the JAX layout, and the round
    trip wide -> narrow -> wide is the identity inside the clamp."""
    n = NUM_GROUPS * WAYS
    wide = wide_image(np.random.default_rng(21), n)
    pt = narrow.pack_table(SlotTable(**wide), device="cpu")
    jt = jnarrow.pack_table(JSlotTable(**{k: jnp.asarray(v) for k, v in wide.items()}))
    assert_table_equal(pt, jt, "pack")
    back = narrow.unpack_table(pt)
    for f in SlotTable._fields:
        assert np.array_equal(getattr(back, f).numpy(), wide[f]), f"round trip {f}"


def test_limbur_split_words_match_jax():
    """_pack_limbur / _unpack_limbur on the clamp's edges, bit for bit."""
    v = np.array([MAX_COUNT, -MAX_COUNT, -1, 0, 1, 7, -(1 << 31) + 1], np.int64)
    lim, bur = np.meshgrid(v, v)
    lim, bur = lim.ravel(), bur.ravel()
    word = narrow._pack_limbur(torch.from_numpy(lim), torch.from_numpy(bur))
    jword = jnarrow._pack_limbur(jnp.asarray(lim), jnp.asarray(bur))
    assert np.array_equal(word.numpy(), np.asarray(jword))
    l2, b2 = narrow._unpack_limbur(word)
    assert np.array_equal(l2.numpy(), lim) and np.array_equal(b2.numpy(), bur)


def test_gather_rows_matches_jax():
    n = NUM_GROUPS * WAYS
    wide = wide_image(np.random.default_rng(22), n)
    pt = narrow.pack_table(SlotTable(**wide), device="cpu")
    jt = jnarrow.pack_table(JSlotTable(**{k: jnp.asarray(v) for k, v in wide.items()}))
    slots = np.array([0, 5, n - 1, n, 17, 300], np.int64)
    pr = narrow.gather_rows_narrow(pt, torch.from_numpy(slots))
    jr = jnarrow.gather_rows_narrow(jt, jnp.asarray(slots))
    for f in pr._fields:
        assert np.array_equal(getattr(pr, f).numpy(), np.asarray(getattr(jr, f))), f


@pytest.mark.parametrize("seed", [31, 32])
def test_plain_matches_xla_impl(seed):
    """decide_narrow_plain vs _decide_narrow_impl: outputs and the whole
    table after every wave of a multi-wave fuzz."""
    pt = narrow.NarrowTable.create(NUM_GROUPS, WAYS, device="cpu")
    jt = jnarrow.NarrowTable.create(NUM_GROUPS, WAYS)
    for step, (wave, now) in enumerate(_waves(seed, 10)):
        pt, po, _ = narrow.decide_narrow_plain(pt, to_torch(wave), now, ways=WAYS)
        jt, jo = _xla_decide(jt, to_jax(wave), jnp.int64(now))
        assert_out_equal(po, jo, f"seed{seed}/step{step}")
        assert_table_equal(pt, jt, f"seed{seed}/step{step}")


@pytest.mark.parametrize("seed", [33, 34])
def test_plain_matches_pallas_reference(seed, monkeypatch):
    """decide_narrow_plain vs pallas decide_flat_with_scan (layout
    narrow, reference lowering): outputs, WaveScan sums and table."""
    monkeypatch.setenv("GUBER_PALLAS_INTERPRET", "0")
    pt = narrow.NarrowTable.create(NUM_GROUPS, WAYS, device="cpu")
    jt = jnarrow.NarrowTable.create(NUM_GROUPS, WAYS)
    for step, (wave, now) in enumerate(_waves(seed, 8)):
        pt, po, ps = narrow.decide_narrow_plain(pt, to_torch(wave), now, ways=WAYS)
        jt, jo, js = jpallas.decide_flat_with_scan(
            jt, to_jax(wave), jnp.int64(now), layout="narrow", ways=WAYS
        )
        tag = f"seed{seed}/step{step}"
        assert_out_equal(po, jo, tag)
        assert_scan_equal(ps, js, tag)
        assert_table_equal(pt, jt, tag)


def test_plain_matches_pallas_interpret(monkeypatch):
    """One small case through the Pallas kernel body itself, layout
    narrow (pl.pallas_call in interpret mode)."""
    monkeypatch.setenv("GUBER_PALLAS_INTERPRET", "1")
    assert jpallas.pallas_mode() == "interpret"
    pt = narrow.NarrowTable.create(NUM_GROUPS, WAYS, device="cpu")
    jt = jnarrow.NarrowTable.create(NUM_GROUPS, WAYS)
    for step, (wave, now) in enumerate(_waves(35, 2)):
        pt, po, ps = narrow.decide_narrow_plain(pt, to_torch(wave), now, ways=WAYS)
        jt, jo, js = jpallas.decide_flat_with_scan(
            jt, to_jax(wave), jnp.int64(now), layout="narrow", ways=WAYS
        )
        tag = f"interpret/step{step}"
        assert_out_equal(po, jo, tag)
        assert_scan_equal(ps, js, tag)
        assert_table_equal(pt, jt, tag)


@pytest.mark.parametrize("seed", [36, 37])
def test_kernel_lane_code_matches_plain(seed):
    """The CUDA kernel's per-lane C++ (narrow, flat), built by g++ for
    the host, vs the plain version: outputs, scalars, table."""
    pt = narrow.NarrowTable.create(NUM_GROUPS, WAYS, device="cpu")
    kt = narrow.NarrowTable.create(NUM_GROUPS, WAYS, device="cpu")
    for step, (wave, now) in enumerate(_waves(seed, 10)):
        pt, po, ps = narrow.decide_narrow_plain(pt, to_torch(wave), now, ways=WAYS)
        kt, ko, ks = cuda_decide.decide_lane_code_on_host(
            kt, to_torch(wave), now, ways=WAYS, layout="narrow"
        )
        tag = f"seed{seed}/step{step}"
        for f in OUT_FIELDS:
            a, r = getattr(ko, f), getattr(po, f)
            assert a.dtype == r.dtype, (tag, f)
            assert torch.equal(a, r), f"{tag}: {f} diverged"
        for f in ps._fields:
            assert int(getattr(ks, f)) == int(getattr(ps, f)), (tag, f)
        assert torch.equal(kt.data, pt.data), f"{tag}: table diverged"


def test_narrow_and_fused_hold_the_same_state():
    """The two layouts are encodings of one table: the same waves give
    the same outputs and the same wide image."""
    ft = fused.FusedTable.create(NUM_GROUPS, WAYS, device="cpu")
    nt = narrow.NarrowTable.create(NUM_GROUPS, WAYS, device="cpu")
    for step, (wave, now) in enumerate(_waves(38, 10)):
        ft, fo, fs = fused.decide_fused_plain(ft, to_torch(wave), now, ways=WAYS)
        nt, no, ns = narrow.decide_narrow_plain(nt, to_torch(wave), now, ways=WAYS)
        for f in OUT_FIELDS:
            assert torch.equal(getattr(fo, f), getattr(no, f)), (step, f)
        for f in fs._fields:
            assert int(getattr(fs, f)) == int(getattr(ns, f)), (step, f)
    fw, nw = fused.unpack_table(ft), narrow.unpack_table(nt)
    for f in SlotTable._fields:
        assert torch.equal(getattr(fw, f), getattr(nw, f)), f


def test_registry_serves_narrow():
    """get_kernels("narrow") on a CPU table is the plain version and
    launches nothing; its wide conversions are the layout's own."""
    K = get_kernels("narrow")
    assert BYTES_PER_SLOT["narrow"] == narrow.BYTES_PER_SLOT == 72
    before = dict(cuda_decide.CONFIG_LAUNCHES)
    wave, now = _waves(39, 1)[0]
    t1 = K.create(NUM_GROUPS, WAYS, "cpu")
    t2 = narrow.NarrowTable.create(NUM_GROUPS, WAYS, device="cpu")
    t1, o1 = K.decide(t1, to_torch(wave), now, WAYS)
    t2, o2, _ = narrow.decide_narrow_plain(t2, to_torch(wave), now, ways=WAYS)
    assert torch.equal(t1.data, t2.data)
    assert torch.equal(o1.remaining, o2.remaining)
    assert dict(cuda_decide.CONFIG_LAUNCHES) == before
    w = K.to_wide(t1)
    assert torch.equal(K.from_wide(w, "cpu").data, t1.data)
    with pytest.raises(ValueError, match="narrow table must be"):
        cuda_decide.decide_flat(
            fused.FusedTable.create(NUM_GROUPS, WAYS, device="cpu"),
            to_torch(wave), now, layout="narrow", ways=WAYS,
        )
