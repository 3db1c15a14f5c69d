"""Narrow slot-table layout: ONE (N, 9) int64 tensor whose probe reads a
5-column row prefix.

The port of `gubernator_tpu/ops/narrow.py`. Way selection reads only
KHI KLO META EXP INV, so they come first (40 B per way, against the
fused layout's 80 B rows); the rest of the row is per-lane state read
at the chosen slot only:

  KHI KLO META EXP INV | LIMBUR DUR REM STM

LIMBUR packs the two int32-clamped counters into one word, limit in the
low 32 bits and burst in the high 32 (encode clamps both to
|v| <= MAX_COUNT = 2^31-1, `models/bucket.py`); every other column is a
native int64, so leaky Q44.20 `remaining` and any stamp round-trip
exactly. META packs lru<<4 | status<<2 | algo<<1 | used as in
`ops/packed.py`. 72 B per slot.

`decide_narrow_plain` is the twin of `_decide_narrow_impl` plus the five
WaveScan sums (`gubernator_tpu/ops/pallas_decide.py:361-385`): the
shared plain wave `ops/fused.py::wave_plain` over this layout's rows.
It updates `table.data` IN PLACE where JAX donates the buffer.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from gubernator_tpu_torch.ops.fused import RowCodec, wave_plain, wide_columns
from gubernator_tpu_torch.ops.layout import (
    DEFAULT_WAYS,
    DecideOutput,
    RequestBatch,
    SlotTable,
    WaveScan,
)
from gubernator_tpu_torch.ops.packed import (
    META_ALGO_SHIFT,
    META_LRU_SHIFT,
    META_STATUS_SHIFT,
    META_USED,
)

I64 = torch.int64

# Row columns. The probe reads ONLY the first N_HOT; the rest is
# per-lane state.
KHI, KLO, META, EXP, INV, LIMBUR, DUR, REM, STM = range(9)
N_HOT = 5
NCOLS = 9

BYTES_PER_SLOT = N_HOT * 8 + 4 + 4 + 3 * 8  # 72


def _pack_limbur(limit: torch.Tensor, burst: torch.Tensor) -> torch.Tensor:
    """(limit, burst) -> one word: limit in the low 32 bits, burst in
    the high (the shift wraps). Lossless inside the int32 clamp."""
    return (burst.to(I64) << 32) | (limit.to(I64) & 0xFFFFFFFF)


def _unpack_limbur(word: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """LIMBUR word -> (limit, burst), sign-extending both halves."""
    limit = word.to(torch.int32).to(I64)  # low 32, sign-extended
    burst = word >> 32  # arithmetic shift keeps burst's sign
    return limit, burst


class NarrowTable(NamedTuple):
    """One (N, NCOLS) int64 tensor, N = groups x ways."""

    data: torch.Tensor  # (N, 9): KHI KLO META EXP INV LIMBUR DUR REM STM

    @property
    def num_slots(self) -> int:
        return self.data.shape[-2]

    # Wide-compatible views (key pruning, live counts).
    @property
    def used(self) -> torch.Tensor:
        return (self.data[..., META] & META_USED) != 0

    @property
    def key_hi(self) -> torch.Tensor:
        return self.data[..., KHI]

    @property
    def key_lo(self) -> torch.Tensor:
        return self.data[..., KLO]

    @property
    def expire_at(self) -> torch.Tensor:
        return self.data[..., EXP]

    @property
    def remaining(self) -> torch.Tensor:
        return self.data[..., REM]

    @staticmethod
    def create(num_groups: int, ways: int = DEFAULT_WAYS, device="cuda") -> "NarrowTable":
        return NarrowTable(
            torch.zeros((num_groups * ways, NCOLS), dtype=I64, device=device)
        )


def _pack_rows(col: dict, dim: int = -1, out=None) -> torch.Tensor:
    """Narrow rows from wide columns (+ `meta`): (..., NCOLS) int64, or
    with dim=0 the (NCOLS, ...) transpose (into `out` when given)."""
    cols = [None] * NCOLS
    cols[KHI] = col["key_hi"]
    cols[KLO] = col["key_lo"]
    cols[META] = col["meta"]
    cols[EXP] = col["expire_at"]
    cols[INV] = col["invalid_at"]
    cols[LIMBUR] = _pack_limbur(col["limit"], col["burst"])
    cols[DUR] = col["duration"]
    cols[REM] = col["remaining"]
    cols[STM] = col["stamp"]
    return torch.stack([c.to(I64) for c in cols], dim=dim, out=out)


def _wide_view(rows: torch.Tensor) -> SlotTable:
    meta = rows[:, META]
    limit, burst = _unpack_limbur(rows[:, LIMBUR])
    return SlotTable(
        key_hi=rows[:, KHI],
        key_lo=rows[:, KLO],
        used=(meta & META_USED) != 0,
        algo=((meta >> META_ALGO_SHIFT) & 1).to(torch.int8),
        status=((meta >> META_STATUS_SHIFT) & 3).to(torch.int8),
        limit=limit,
        duration=rows[:, DUR],
        remaining=rows[:, REM],
        stamp=rows[:, STM],
        expire_at=rows[:, EXP],
        invalid_at=rows[:, INV],
        burst=burst,
        lru=meta >> META_LRU_SHIFT,
    )


NARROW_CODEC = RowCodec(NCOLS, (KHI, KLO, META, EXP, INV), _wide_view, _pack_rows)


def pack_table(wide: SlotTable, device=None) -> NarrowTable:
    """Wide -> narrow (the snapshot interop). Lossless within the encode
    clamp (limit and burst fit int32); every other column round-trips
    any int64. The result lives on `device` (default: where `wide` is)."""
    data = _pack_rows(wide_columns(wide))
    if device is not None:
        data = data.to(device)
    return NarrowTable(data.contiguous())


def unpack_table(narrow: NarrowTable) -> SlotTable:
    """Narrow -> wide, on the table's device (the snapshot format)."""
    return _wide_view(narrow.data)


def gather_rows_narrow(table: NarrowTable, slots: torch.Tensor) -> SlotTable:
    """Rows at `slots`, expanded to the wide struct; a slot == N
    (padding lane) reads as zeros."""
    n = table.num_slots
    valid = slots < n
    rows = table.data[torch.clamp(slots, 0, n - 1)]
    return _wide_view(torch.where(valid[:, None], rows, 0))


def decide_narrow_plain(
    table: NarrowTable, batch: RequestBatch, now: int, *, ways: int = DEFAULT_WAYS
) -> Tuple[NarrowTable, DecideOutput, WaveScan]:
    """One decide wave on a flat narrow table in plain torch ops (the twin
    of `_decide_narrow_impl`); updates `table.data` in place."""
    out, scan = wave_plain(NARROW_CODEC, table.data, None, batch, now, ways=ways)
    return table, out, scan
