"""Packed slot-table layout: fewer, narrower columns on the probe path.

The port of `gubernator_tpu/ops/packed.py`, as torch ops (an XLA
program in the JAX package, never a Pallas kernel). A struct of ten
columns; the probe reads three per way (`key_lo`, `meta`, `expire_at`,
plus `invalid_at`, the store's mark) and completes the 128-bit key check
at the matched way only, with one per-lane gather of `key_hi`:

- `meta` (int64): lru << 4 | status << 2 | algo << 1 | used, a
  cross-layout contract (the fused and narrow rows pack the same word,
  and the CUDA kernel in `csrc/decide_lane.cuh`);
- `limit` and `burst` are int32 (encode clamps both to MAX_COUNT);
  `remaining`, `duration`, `stamp`, `expire_at` and `invalid_at` stay
  int64.

72 B per slot. The branches are the shared `_token_paths` /
`_leaky_paths` (ops/decide.py). The table is updated IN PLACE, where
JAX donates it; gathers past the end clamp and writes past the end are
dropped, as in `ops/decide.py`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gubernator_tpu_torch.ops.decide import (
    both_paths,
    expired_ways,
    lane_outputs,
    pick,
    run_scan,
    scatter,
    select_ways,
    take,
    way_slots,
)
from gubernator_tpu_torch.ops.layout import DEFAULT_WAYS, SlotTable, wide_on_device

I64 = torch.int64
I32 = torch.int32

META_USED = 1
META_ALGO_SHIFT = 1
META_STATUS_SHIFT = 2
META_LRU_SHIFT = 4


def _pack_meta(used, algo, status, lru):
    i64 = torch.int64
    return (
        (lru.to(i64) << META_LRU_SHIFT)
        | (status.to(i64) & 3) << META_STATUS_SHIFT
        | (algo.to(i64) & 1) << META_ALGO_SHIFT
        | used.to(i64)
    )


class PackedTable(NamedTuple):
    """The packed struct-of-columns table, N = groups x ways rows."""

    key_hi: torch.Tensor  # (N,) int64
    key_lo: torch.Tensor  # (N,) int64
    meta: torch.Tensor  # (N,) int64: lru<<4 | status<<2 | algo<<1 | used
    expire_at: torch.Tensor  # (N,) int64 epoch ms
    limit: torch.Tensor  # (N,) int32
    duration: torch.Tensor  # (N,) int64
    remaining: torch.Tensor  # (N,) int64 (token: tokens; leaky: Q44.20)
    stamp: torch.Tensor  # (N,) int64
    burst: torch.Tensor  # (N,) int32
    invalid_at: torch.Tensor  # (N,) int64, 0 = unset (store mark)

    @property
    def num_slots(self) -> int:
        return self.key_hi.shape[0]

    # Wide-compatible views (key pruning, live counts)
    @property
    def used(self) -> torch.Tensor:
        return (self.meta & META_USED) != 0

    @property
    def algo(self) -> torch.Tensor:
        return ((self.meta >> META_ALGO_SHIFT) & 1).to(torch.int8)

    @property
    def status(self) -> torch.Tensor:
        return ((self.meta >> META_STATUS_SHIFT) & 3).to(torch.int8)

    @property
    def lru(self) -> torch.Tensor:
        return self.meta >> META_LRU_SHIFT

    @staticmethod
    def create(num_groups: int, ways: int = DEFAULT_WAYS, device="cuda") -> "PackedTable":
        n = num_groups * ways
        return PackedTable(*(
            torch.zeros((n,), dtype=I32 if f in ("limit", "burst") else I64, device=device)
            for f in PackedTable._fields))


def pack_table(wide: SlotTable, device=None) -> PackedTable:
    """Wide -> packed (the snapshot interop): counts cast to int32, as
    encode's clamp already bounds them. `wide` holds numpy arrays or
    tensors; the columns are copies, on `device` (default: where `wide`
    is)."""
    w = wide_on_device(wide, device)
    return PackedTable(
        key_hi=w.key_hi,
        key_lo=w.key_lo,
        meta=_pack_meta(w.used, w.algo, w.status, w.lru),
        expire_at=w.expire_at,
        limit=w.limit.to(I32),
        duration=w.duration,
        remaining=w.remaining,
        stamp=w.stamp,
        burst=w.burst.to(I32),
        invalid_at=w.invalid_at,
    )


def unpack_table(packed: PackedTable) -> SlotTable:
    """Packed -> wide on the table's device (the snapshot format)."""
    return SlotTable(
        key_hi=packed.key_hi,
        key_lo=packed.key_lo,
        used=packed.used,
        algo=packed.algo,
        status=packed.status,
        limit=packed.limit.to(I64),
        duration=packed.duration,
        remaining=packed.remaining,
        stamp=packed.stamp,
        expire_at=packed.expire_at,
        invalid_at=packed.invalid_at,
        burst=packed.burst.to(I64),
        lru=packed.lru,
    )


def _choose_slot_packed(table: PackedTable, batch, now: int, ways: int):
    """The packed probe: key_lo, meta, expire_at and invalid_at per way,
    key_hi checked at the matched way only; the way policy of the wide
    layout over the key_lo matches. Returns (slot, exists, evicts_live,
    evicted_hi, evicted_lo, the chosen way's meta and expire_at)."""
    grp_base, way_ix = way_slots(batch.group, ways)
    w_key_lo = take(table.key_lo, way_ix)
    w_meta = take(table.meta, way_ix)
    w_expire = take(table.expire_at, way_ix)
    w_used = (w_meta & META_USED) != 0
    w_expired = expired_ways(w_used, w_expire, take(table.invalid_at, way_ix), now)
    lo_match = w_used & (w_key_lo == batch.key_lo[:, None])
    lo_exists, matched_way, insert_way, cat = select_ways(
        lo_match, w_used, w_expired, w_meta >> META_LRU_SHIFT)
    # the 128-bit identity completed at the matched way only
    hi_at_match = take(table.key_hi, grp_base + matched_way)
    exists = lo_exists & (hi_at_match == batch.key_hi)
    way = torch.where(exists, matched_way, insert_way)
    evicts_live = ~exists & (pick(cat, insert_way) == 3) & batch.active
    # only the insert way's occupant can be displaced: its key_hi is one
    # more per-lane gather
    old_hi = torch.where(exists, hi_at_match, take(table.key_hi, grp_base + insert_way))
    old_lo = pick(w_key_lo, way)
    displaced = (batch.active & ~exists & pick(w_used, way)
                 & ((old_hi != batch.key_hi) | (old_lo != batch.key_lo)))
    evicted_hi = torch.where(displaced, old_hi, 0)
    evicted_lo = torch.where(displaced, old_lo, 0)
    return (grp_base + way, exists, evicts_live, evicted_hi, evicted_lo,
            pick(w_meta, way), pick(w_expire, way))


def _decide_packed_impl(table: PackedTable, batch, now: int, *, ways: int):
    """One decide wave on a packed table, in place (`_decide_packed_impl`)."""
    now = int(now)
    slot, exists, evicts_live, evicted_hi, evicted_lo, meta_sel, expire_sel = (
        _choose_slot_packed(table, batch, now, ways))
    # the state phase: per-lane gathers of the cold columns; algo and
    # status ride in the gathered meta word
    st = dict(
        algo=((meta_sel >> META_ALGO_SHIFT) & 1).to(torch.int8),
        status=((meta_sel >> META_STATUS_SHIFT) & 3).to(torch.int8),
        limit=take(table.limit, slot).to(I64),
        duration=take(table.duration, slot),
        remaining=take(table.remaining, slot),
        stamp=take(table.stamp, slot),
        expire_at=expire_sel,
        burst=take(table.burst, slot).to(I64),
        invalid_at=take(table.invalid_at, slot),
    )
    st = {k: torch.where(exists, v, 0) for k, v in st.items()}
    new_state, resp = both_paths(batch, st, exists)
    idx = torch.where(batch.active, slot, table.num_slots)
    freed = ~new_state["used"]
    meta_new = torch.where(freed, 0, _pack_meta(
        torch.ones_like(freed), batch.algo, new_state["status"],
        torch.full_like(batch.key_hi, now)))
    scatter(dict(
        key_hi=torch.where(freed, 0, batch.key_hi),
        key_lo=torch.where(freed, 0, batch.key_lo),
        meta=meta_new,
        **{k: new_state[k] for k in ("expire_at", "limit", "duration", "remaining", "stamp",
                                     "burst")},
        invalid_at=torch.where(exists & ~freed, st["invalid_at"], 0),
    ), table, idx)
    return lane_outputs(batch, resp, idx, evicted_hi, evicted_lo, freed, exists, evicts_live)


def decide_packed(table: PackedTable, batch, now, ways: int = 8):
    """One decide wave on a packed table, updated in place: (table,
    DecideOutput)."""
    return table, _decide_packed_impl(table, batch, now, ways=ways)


def decide_scan_packed(table: PackedTable, batches, nows, ways: int = 8):
    """T decide waves on a packed table in order (`decide_scan_packed`)."""
    return run_scan(decide_packed, table, batches, nows, ways)


def probe_exists_packed(table: PackedTable, key_hi, key_lo, group, now,
                        ways: int = 8) -> torch.Tensor:
    """The store path's residency probe on a packed table."""
    _grp_base, way_ix = way_slots(group, ways)
    w_used = (take(table.meta, way_ix) & META_USED) != 0
    w_expired = expired_ways(w_used, take(table.expire_at, way_ix),
                             take(table.invalid_at, way_ix), int(now))
    live = (w_used & ~w_expired & (take(table.key_lo, way_ix) == key_lo[:, None])
            & (take(table.key_hi, way_ix) == key_hi[:, None]))
    return live.any(dim=1)


def gather_rows_packed(table: PackedTable, slots: torch.Tensor) -> SlotTable:
    """Rows at `slots` expanded to the wide struct (the store
    write-behind's rows); a slot >= N reads as zeros."""
    valid = slots < table.num_slots
    rows = PackedTable(*(torch.where(valid, take(c, slots),
                                     torch.zeros((), dtype=c.dtype, device=c.device))
                         for c in table))
    return unpack_table(rows)


def _inject_packed_impl(table: PackedTable, items, now: int, ways: int):
    """Authoritative rows into a packed table, in place
    (`_inject_packed_impl`): each item's slot by the packed probe (match
    or insert), lru = now. Returns (evicted_hi, evicted_lo)."""
    now = int(now)
    slot, _exists, _ev, evicted_hi, evicted_lo, _meta, _exp = _choose_slot_packed(
        table, items, now, ways)
    scatter(dict(
        key_hi=items.key_hi,
        key_lo=items.key_lo,
        meta=_pack_meta(torch.ones_like(items.active), items.algo, items.status,
                        torch.full_like(items.key_hi, now)),
        **{k: getattr(items, k) for k in ("expire_at", "limit", "duration", "remaining",
                                          "stamp", "burst", "invalid_at")},
    ), table, torch.where(items.active, slot, table.num_slots))
    return evicted_hi, evicted_lo


def inject_packed(table: PackedTable, items, now, ways: int = 8):
    """(table, evicted_hi, evicted_lo), the table updated in place."""
    return (table, *_inject_packed_impl(table, items, now, ways))
