"""Direct state injection into the slot table (the AddCacheItem analog),
and the residency probe of the store path.

The port of `gubernator_tpu/ops/inject.py` (`InjectBatch` and the
`wide` layout's `_inject_impl` / `inject`), of the raw injects of the
row layouts, `gubernator_tpu/ops/fused.py::_inject_fused_impl` and
`gubernator_tpu/ops/narrow.py::_inject_narrow_impl` (`inject_rows`),
and of their residency probes `probe_exists_fused` /
`probe_exists_narrow` (`probe_rows`), as torch ops (XLA programs in the
JAX package, not Pallas kernels). The packed layout's inject is in
ops/packed.py. The GLOBAL
replica tier lands an authoritative push on every replica with the
inject (parallel/ici.py `make_inject_replicas`); the store path's
read-through probes a wave's keys (`probe_rows`) and injects the
state of the misses; the Loader restore injects a checkpoint.

Each lane probes its key's group with the decide's way policy
(`fused.probe_ways`: a live match, else matched-expired > empty >
expired > least recently used) and overwrites or creates the entry:
stamp and expiry from the item, lru = now. The caller guarantees
distinct groups among the active lanes of one call (the engine's wave
assembler). The table is updated IN PLACE, where JAX returns a new one:
on a row layout one `index_add_` of each active lane's row delta (new
row minus old, an exact int64 round trip), so an inactive lane writes
nothing and needs no host-side mask; on the wide layout one write per
column, a slot past the end dropped (`decide.scatter`).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from gubernator_tpu_torch.ops.decide import _choose_slot, scatter
from gubernator_tpu_torch.ops.fused import RowCodec, probe_ways
from gubernator_tpu_torch.ops.layout import SlotTable
from gubernator_tpu_torch.ops.packed import META_USED, _pack_meta

I64 = torch.int64


class InjectBatch(NamedTuple):
    """Authoritative per-key state to write (padded, distinct groups).
    `zeros` gives numpy columns on the host; `to_device` moves them."""

    key_hi: torch.Tensor  # (B,) int64
    key_lo: torch.Tensor  # (B,) int64
    group: torch.Tensor  # (B,) int32
    algo: torch.Tensor  # (B,) int8
    status: torch.Tensor  # (B,) int8
    limit: torch.Tensor  # (B,) int64
    duration: torch.Tensor  # (B,) int64
    remaining: torch.Tensor  # (B,) int64 (already Q44.20 for leaky)
    stamp: torch.Tensor  # (B,) int64
    expire_at: torch.Tensor  # (B,) int64
    invalid_at: torch.Tensor  # (B,) int64
    burst: torch.Tensor  # (B,) int64
    active: torch.Tensor  # (B,) bool

    @staticmethod
    def zeros(b: int) -> "InjectBatch":
        return InjectBatch(**{f: np.zeros((b,), dtype=dt) for f, dt in INJECT_DTYPES.items()})

    def to_device(self, device) -> "InjectBatch":
        """Host (numpy) columns -> torch tensors on `device`."""
        return InjectBatch(*(torch.as_tensor(np.ascontiguousarray(c)).to(device) for c in self))


INJECT_DTYPES = {
    "key_hi": np.int64, "key_lo": np.int64, "group": np.int32, "algo": np.int8,
    "status": np.int8, "limit": np.int64, "duration": np.int64, "remaining": np.int64,
    "stamp": np.int64, "expire_at": np.int64, "invalid_at": np.int64, "burst": np.int64,
    "active": np.bool_,
}


def inject_rows(
    codec: RowCodec, data: torch.Tensor, items: InjectBatch, now: int, ways: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inject `items` into the (N, C) rows `data` of a layout (`codec`),
    in place: `_inject_fused_impl` / `_inject_narrow_impl`. Returns
    (evicted_hi, evicted_lo): the key a lane's insert displaced from its
    slot, (0, 0) where none."""
    now = int(now)
    act = items.active
    grp_base = torch.where(act, items.group.to(I64), 0) * ways
    way_ix = grp_base[:, None] + torch.arange(ways, dtype=I64, device=data.device)[None, :]
    rows = data[way_ix]  # (B, W, C)
    c_khi, c_klo, c_meta, c_exp, c_inv = codec.probe
    exists, matched_way, insert_way, _cat = probe_ways(
        rows[..., c_khi], rows[..., c_klo], rows[..., c_meta], rows[..., c_exp],
        rows[..., c_inv], items, now,
    )
    way = torch.where(exists, matched_way, insert_way)
    slot = grp_base + way
    st_row = torch.gather(rows, 1, way[:, None, None].expand(-1, 1, codec.ncols))[:, 0]
    old_used = (st_row[:, c_meta] & META_USED) != 0
    displaced = act & ~exists & old_used & (
        (st_row[:, c_khi] != items.key_hi) | (st_row[:, c_klo] != items.key_lo)
    )
    evicted_hi = torch.where(displaced, st_row[:, c_khi], 0)
    evicted_lo = torch.where(displaced, st_row[:, c_klo], 0)
    new_row = codec.pack_rows({
        "key_hi": items.key_hi,
        "key_lo": items.key_lo,
        "meta": _pack_meta(torch.ones_like(act), items.algo, items.status,
                           torch.full_like(items.key_hi, now)),
        "expire_at": items.expire_at,
        "limit": items.limit,
        "duration": items.duration,
        "remaining": items.remaining,
        "stamp": items.stamp,
        "burst": items.burst,
        "invalid_at": items.invalid_at,
    })
    data.index_add_(0, slot, torch.where(act[:, None], new_row - st_row, 0))
    return evicted_hi, evicted_lo


def probe_rows(codec: RowCodec, data: torch.Tensor, key_hi: torch.Tensor,
               key_lo: torch.Tensor, group: torch.Tensor, now: int,
               ways: int) -> torch.Tensor:
    """Residency probe of the (N, C) rows `data` of a layout (`codec`):
    (B,) bool, True where a lane's key is live in its group (used, not
    expired, not invalidated). Reads only the columns up to the last
    probe column (the narrow layout's 40-byte hot prefix). A group
    outside the table (a paged table's sentinel, the physical group
    count) probes as absent."""
    now = int(now)
    n_groups = data.shape[0] // ways
    g = group.to(I64)
    valid = (g >= 0) & (g < n_groups)
    grp_base = torch.where(valid, g, 0) * ways
    way_ix = grp_base[:, None] + torch.arange(ways, dtype=I64, device=data.device)[None, :]
    rows = data[:, :max(codec.probe) + 1][way_ix]  # (B, W, hot columns)
    c_khi, c_klo, c_meta, c_exp, c_inv = codec.probe
    w_used = (rows[..., c_meta] & META_USED) != 0
    w_inv = rows[..., c_inv]
    w_expired = w_used & ((rows[..., c_exp] < now) | ((w_inv != 0) & (w_inv < now)))
    live = (w_used & ~w_expired & (rows[..., c_khi] == key_hi[:, None])
            & (rows[..., c_klo] == key_lo[:, None]))
    return live.any(dim=1) & valid


def _inject_impl(table: SlotTable, items: InjectBatch, now: int, ways: int = 8):
    """Authoritative rows into a wide table, in place (`_inject_impl`):
    each item's slot by the decide's probe (`decide._choose_slot`: match
    or insert), lru = now. Returns (evicted_hi, evicted_lo)."""
    now = int(now)
    slot, _exists, _ev, evicted_hi, evicted_lo = _choose_slot(table, items, now, ways)
    scatter(dict(
        **{f: getattr(items, f) for f in ("key_hi", "key_lo", "algo", "status", "limit",
                                          "duration", "remaining", "stamp", "expire_at",
                                          "invalid_at", "burst")},
        used=torch.ones_like(items.active),
        lru=torch.full_like(items.key_hi, now),
    ), table, torch.where(items.active, slot, table.num_slots))
    return evicted_hi, evicted_lo


def inject(table: SlotTable, items: InjectBatch, now, ways: int = 8):
    """(table, evicted_hi, evicted_lo), the wide table updated in place:
    the displaced occupant's key per lane, (0, 0) where none, as
    DecideOutput's evicted keys."""
    return (table, *_inject_impl(table, items, now, ways))
