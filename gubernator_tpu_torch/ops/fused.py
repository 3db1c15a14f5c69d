"""Fused slot-table layout: ONE (N, 10) int64 tensor, and the plain
PyTorch version of the decide wave for every layout, flat or paged.

A group's W x C block is contiguous, so a lane's probe reads W
neighbouring rows and the chosen way's state is one of them; the update
writes one contiguous row per lane. Columns (all int64; META packs
lru<<4 | status<<2 | algo<<1 | used, see ops/packed.py):

  KHI KLO META EXP LIM DUR REM STM BUR INV

`wave_plain` is the twin of `gubernator_tpu/ops/pallas_decide.py`
`_reference_wave` + `_wave_compute`: one wave over any layout's rows
(described by a `RowCodec`), on a flat table or through a page map, with
the five WaveScan sums. On a flat table it equals the layout's XLA
program (`_decide_fused_impl`, `_decide_narrow_impl`). It is the
reference the CUDA kernel (`ops/cuda_decide.py`) is held against and
the path a CPU table takes. `scan_plain` runs T such waves in order: the
plain version of the scan kernel. `sharded_plain` is the owner-sharded
wave of the mesh tier: the masked wave on every shard's rows, then the
sum over the shards (the plain version of the sharded kernel).
`decide_fused_plain` is the wave's fused, flat form. Where JAX donates the table buffer, this version updates the
table IN PLACE.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from gubernator_tpu_torch.api.types import Algorithm
from gubernator_tpu_torch.ops.decide import both_paths, expired_ways, select_ways, stack_outputs
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
    _pack_meta,
)

I64 = torch.int64

KHI, KLO, META, EXP, LIM, DUR, REM, STM, BUR, INV = range(10)
NCOLS = 10

# Leaky `remaining` -> whole tokens for the admission sums
# (gubernator_tpu/ops/admission.py ADMISSION_SHIFT).
ADMISSION_SHIFT = 20

# Column of the fused row that holds each wide field (META aside).
_WIDE_COLS = {
    "key_hi": KHI, "key_lo": KLO, "expire_at": EXP, "limit": LIM,
    "duration": DUR, "remaining": REM, "stamp": STM, "burst": BUR,
    "invalid_at": INV,
}


class FusedTable(NamedTuple):
    """One (N, NCOLS) int64 tensor, N = groups x ways."""

    data: torch.Tensor

    @property
    def num_slots(self) -> int:
        return self.data.shape[0]

    # Wide-compatible views (key pruning, live counts; a PagedTable
    # forwards them), as NarrowTable's.
    @property
    def used(self) -> torch.Tensor:
        return (self.data[..., META] & META_USED) != 0

    @property
    def key_hi(self) -> torch.Tensor:
        return self.data[..., KHI]

    @property
    def key_lo(self) -> torch.Tensor:
        return self.data[..., KLO]

    @staticmethod
    def create(num_groups: int, ways: int = DEFAULT_WAYS, device="cuda") -> "FusedTable":
        return FusedTable(
            torch.zeros((num_groups * ways, NCOLS), dtype=I64, device=device)
        )


def _as_tensor(v) -> torch.Tensor:
    if torch.is_tensor(v):
        return v
    a = np.asarray(v)
    # torch refuses to wrap a read-only array (a JAX snapshot's columns)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def wide_columns(wide: SlotTable) -> dict:
    """A wide image's columns as tensors (numpy arrays are wrapped, not
    copied, where they are writable), plus its packed `meta` word."""
    col = {f: _as_tensor(v) for f, v in zip(SlotTable._fields, wide)}
    col["meta"] = _pack_meta(col["used"], col["algo"], col["status"], col["lru"])
    return col


def _pack_rows(col: dict, dim: int = -1, out=None) -> torch.Tensor:
    """Fused rows from wide columns (+ `meta`): (..., NCOLS) int64, or
    with dim=0 the (NCOLS, ...) transpose (into `out` when given)."""
    cols = [None] * NCOLS
    for f, c in _WIDE_COLS.items():
        cols[c] = col[f].to(I64)
    cols[META] = col["meta"].to(I64)
    return torch.stack(cols, dim=dim, out=out)


def pack_table(wide: SlotTable, device=None) -> FusedTable:
    """Wide -> fused (the snapshot interop). `wide` holds numpy arrays or
    tensors; the result lives on `device` (default: where `wide` is)."""
    data = _pack_rows(wide_columns(wide))
    if device is not None:
        data = data.to(device)
    return FusedTable(data.contiguous())


def _wide_view(rows: torch.Tensor) -> SlotTable:
    meta = rows[:, META]
    return SlotTable(
        key_hi=rows[:, KHI],
        key_lo=rows[:, KLO],
        used=(meta & META_USED) != 0,
        algo=((meta >> META_ALGO_SHIFT) & 1).to(torch.int8),
        status=((meta >> META_STATUS_SHIFT) & 3).to(torch.int8),
        limit=rows[:, LIM],
        duration=rows[:, DUR],
        remaining=rows[:, REM],
        stamp=rows[:, STM],
        expire_at=rows[:, EXP],
        invalid_at=rows[:, INV],
        burst=rows[:, BUR],
        lru=meta >> META_LRU_SHIFT,
    )


def unpack_table(fused: FusedTable) -> SlotTable:
    """Fused -> wide, on the table's device (the snapshot format)."""
    return _wide_view(fused.data)


def gather_rows_fused(table: FusedTable, slots: torch.Tensor) -> SlotTable:
    """Rows at `slots`, expanded to the wide struct; a slot == N
    (padding lane) reads as zeros."""
    n = table.num_slots
    valid = slots < n
    rows = table.data[torch.clamp(slots, 0, n - 1)]
    return _wide_view(torch.where(valid[:, None], rows, 0))


def probe_ways(w_khi, w_klo, w_meta, w_exp, w_inv, batch, now):
    """Way selection over per-way (B, W) columns of a row layout, the
    used bit and lru read from the meta word: (exists, matched_way,
    insert_way, cat) of `decide.select_ways`."""
    w_used = (w_meta & META_USED) != 0
    w_match = (
        w_used
        & (w_khi == batch.key_hi[:, None])
        & (w_klo == batch.key_lo[:, None])
    )
    return select_ways(w_match, w_used, expired_ways(w_used, w_exp, w_inv, now),
                       w_meta >> META_LRU_SHIFT)


class RowCodec(NamedTuple):
    """How a layout stores one slot row."""

    ncols: int
    probe: Tuple[int, int, int, int, int]  # columns of KHI KLO META EXP INV
    wide_view: Callable  # rows (B, C) -> SlotTable of (B,) tensors
    pack_rows: Callable  # wide columns + "meta" -> rows (B, C)


FUSED_CODEC = RowCodec(NCOLS, (KHI, KLO, META, EXP, INV), _wide_view, _pack_rows)

_STATE_FIELDS = ("algo", "status", "limit", "duration", "remaining", "stamp",
                 "expire_at", "burst", "invalid_at")


def wave_plain(
    codec: RowCodec,
    data: torch.Tensor,
    page_map: Optional[torch.Tensor],
    batch: RequestBatch,
    now: int,
    *,
    ways: int,
    gpp: int = 0,
) -> Tuple[DecideOutput, WaveScan]:
    """One decide wave in plain torch ops over the (N, C) rows `data`,
    updated in place.

    Flat (`page_map` None): a lane's group is its physical group. Paged:
    `page_map[group // gpp]` (int32, as the Pallas kernel computes it)
    names the lane's frame, or -1; a lane on a non-resident page is a
    sentinel lane: it sees an all-empty group, answers as a fresh bucket,
    counts in misses and over_limit but not in the WaveScan sums, writes
    nothing and reports slot == N (pallas_decide.py:338-343, :365,
    :529-548). A page index outside the map is treated as non-resident.

    Inactive lanes read nothing and write nothing: their outputs are
    zeros with slot == N, as in the JAX kernel, where every such output
    is masked by `active`."""
    now = int(now)
    n = data.shape[0]
    dev = data.device
    act = batch.active
    group = torch.where(act, batch.group, 0)
    if page_map is None:
        resident = torch.ones_like(act)
        phys = group.to(I64)
    else:
        lp = torch.div(group, gpp, rounding_mode="floor")
        in_map = (lp >= 0) & (lp < page_map.shape[0])
        pp = torch.where(in_map, page_map[torch.clamp(lp, 0, page_map.shape[0] - 1).long()], -1)
        resident = pp >= 0
        phys = torch.where(resident, pp * gpp + group % gpp, 0).to(I64)
    grp_base = phys * ways
    way_ix = grp_base[:, None] + torch.arange(ways, dtype=I64, device=dev)[None, :]

    # the lanes' group blocks, zeroed for sentinel lanes
    rows = torch.where(resident[:, None, None], data[way_ix], 0)  # (B, W, C)
    c_khi, c_klo, c_meta, c_exp, c_inv = codec.probe
    exists, matched_way, insert_way, cat = probe_ways(
        rows[..., c_khi], rows[..., c_klo], rows[..., c_meta],
        rows[..., c_exp], rows[..., c_inv], batch, now,
    )
    way = torch.where(exists, matched_way, insert_way)
    st_row = torch.gather(rows, 1, way[:, None, None].expand(-1, 1, codec.ncols))[:, 0]

    sel = torch.gather(cat, 1, insert_way[:, None])[:, 0]
    evicts_live = ~exists & (sel == 3) & act

    old_used = (st_row[:, c_meta] & META_USED) != 0
    displaced = (
        act
        & ~exists
        & old_used
        & ((st_row[:, c_khi] != batch.key_hi) | (st_row[:, c_klo] != batch.key_lo))
    )
    evicted_hi = torch.where(displaced, st_row[:, c_khi], 0)
    evicted_lo = torch.where(displaced, st_row[:, c_klo], 0)

    sel_wide = codec.wide_view(st_row)
    st = {k: torch.where(exists, getattr(sel_wide, k), 0) for k in _STATE_FIELDS}

    new_state, resp = both_paths(batch, st, exists)
    is_leaky = batch.algo == int(Algorithm.LEAKY_BUCKET)

    freed = ~new_state["used"]
    new_row = codec.pack_rows({
        "key_hi": torch.where(freed, 0, batch.key_hi),
        "key_lo": torch.where(freed, 0, batch.key_lo),
        "meta": torch.where(
            freed,
            0,
            _pack_meta(
                torch.ones_like(freed), batch.algo, new_state["status"],
                torch.full_like(batch.key_hi, now),
            ),
        ),
        "expire_at": new_state["expire_at"],
        "limit": new_state["limit"],
        "duration": new_state["duration"],
        "remaining": new_state["remaining"],
        "stamp": new_state["stamp"],
        "burst": new_state["burst"],
        # The store's invalidation mark survives updates on a live entry;
        # fresh inserts and freed slots clear it.
        "invalid_at": torch.where(exists & ~freed, st["invalid_at"], 0),
    })  # (B, C)

    # The ONE scatter, in place: distinct groups per wave -> distinct
    # slots; sentinel and inactive lanes write nothing.
    written = act & resident
    slot = torch.where(resident, grp_base + way, n)
    data[slot[written]] = new_row[written]

    z8 = torch.zeros((), dtype=torch.int8, device=dev)
    out = DecideOutput(
        status=torch.where(act, resp["status"], z8),
        limit=torch.where(act, batch.limit, 0),
        remaining=torch.where(act, resp["remaining"], 0),
        reset_time=torch.where(act, resp["reset_time"], 0),
        slot=torch.where(act, slot, n),
        evicted_hi=evicted_hi,
        evicted_lo=evicted_lo,
        freed=act & freed,
        hits=(act & exists).sum(),
        misses=(act & ~exists).sum(),
        unexpired_evictions=evicts_live.sum(),
        over_limit=(act & resp["over"]).sum(),
    )

    # Admission/census sums over the rows this wave WROTE, at `now`
    # (gubernator_tpu/ops/pallas_decide.py:361-385).
    row_used = written & ~freed
    lim_new = new_state["limit"]
    exp_new = new_state["expire_at"]
    adm_active = row_used & (lim_new > 0) & (exp_new > now)
    tokens = torch.where(
        is_leaky, new_state["remaining"] >> ADMISSION_SHIFT, new_state["remaining"]
    )
    admitted = torch.where(adm_active, torch.clamp(lim_new - tokens, min=0), 0)
    scan = WaveScan(
        adm_keys=adm_active.sum(),
        adm_admitted=admitted.sum(),
        adm_limit=torch.where(adm_active, lim_new, 0).sum(),
        census_live=row_used.sum(),
        census_waste=(row_used & (exp_new <= now)).sum(),
    )
    return out, scan


def scan_plain(
    codec: RowCodec,
    data: torch.Tensor,
    page_map: Optional[torch.Tensor],
    batches: RequestBatch,
    nows,
    *,
    ways: int,
    gpp: int = 0,
) -> DecideOutput:
    """T decide waves in order over the (N, C) rows `data`, updated in
    place: step t is `wave_plain` of row t of the (T, B) `batches` at
    `nows[t]`. Returns the steps' outputs stacked: (T, B) lanes and (T,)
    sums (the WaveScan sums are dropped, as the JAX scans drop them).
    The twin of gubernator_tpu's `decide_scan_fused` / `decide_scan_narrow`
    and of `pallas_decide.decide_scan_flat` / `decide_scan_paged` (Pallas
    sentinel semantics on a paged table, as `wave_plain`)."""
    steps, b = batches.key_hi.shape
    outs = [
        wave_plain(codec, data, page_map, RequestBatch(*(c[t] for c in batches)),
                   int(nows[t]), ways=ways, gpp=gpp)[0]
        for t in range(steps)
    ]
    return stack_outputs(outs, b, data.device)


def mask_to_local(shard: int, groups_per: int, batch: RequestBatch) -> RequestBatch:
    """Shard `shard`'s view of a replicated batch (`parallel/mesh.py`
    `_mask_to_local`): lanes whose group lies outside its contiguous
    range [shard * groups_per, (shard + 1) * groups_per) go inactive,
    the rest are rebased to shard-local groups (in int64, then cast back
    to the batch's group type); masked lanes get group 0."""
    local = batch.group.to(I64) - shard * groups_per
    mine = (local >= 0) & (local < groups_per) & batch.active
    return batch._replace(
        group=torch.where(mine, local, 0).to(batch.group.dtype), active=mine
    )


def xlate_groups(page_map: torch.Tensor, group: torch.Tensor, gpp: int,
                 sentinel: int) -> torch.Tensor:
    """A paged mesh's logical -> physical group translation (`parallel/
    mesh.py` `_xlate`), in int32: page_map[g // gpp] * gpp + g % gpp, or
    `sentinel` (the physical group count, which no shard owns) where the
    page is not resident. A page index outside the map counts as not
    resident (the JAX gather clamps it; no hashed group lies there)."""
    g = group.to(torch.int32)
    lp = torch.div(g, gpp, rounding_mode="floor")
    in_map = (lp >= 0) & (lp < page_map.shape[0])
    pp = torch.where(in_map, page_map[torch.clamp(lp, 0, page_map.shape[0] - 1).long()], -1)
    phys = torch.where(pp >= 0, pp * gpp + g % gpp, sentinel)
    return phys.to(group.dtype)


# dtype of each DecideOutput field after the psum over the shard axis
# (sums of int8 stay int8; the bool `freed` sums as int32)
_PSUM_DTYPES = {"status": torch.int8, "freed": torch.int32}


def sharded_plain(
    codec: RowCodec,
    data: torch.Tensor,
    page_map: Optional[torch.Tensor],
    batch: RequestBatch,
    now: int,
    *,
    ways: int,
    n_shards: int,
    gpp: int = 0,
) -> Tuple[DecideOutput, WaveScan]:
    """The owner-sharded wave of the mesh tier in plain torch ops, on one
    device: `data` is `n_shards` equal shards of contiguous rows, shard d
    at rows [d * n_local, (d + 1) * n_local), updated in place. Each
    shard runs `wave_plain` (flat) on its own rows with the batch masked
    to the lanes it owns (`mask_to_local`), and every output is summed
    over the shards, as `parallel/mesh.py` psums them: a lane's answer
    is its owner's, its `slot` the owner's local slot plus (D - 1) *
    n_local (a masked lane reports its shard's n_local), D * n_local for
    a lane no shard owns, and `freed` int32. With `page_map` the rows are
    a paged mesh's frames and the groups are translated first
    (`xlate_groups`). The WaveScan sums add up over the shards."""
    n = data.shape[0]
    n_local = n // n_shards
    groups_per = n_local // ways
    if page_map is not None:
        batch = batch._replace(
            group=xlate_groups(page_map, batch.group, gpp, n_shards * groups_per)
        )
    outs, scans = [], []
    for d in range(n_shards):
        out, scan = wave_plain(
            codec, data[d * n_local:(d + 1) * n_local], None,
            mask_to_local(d, groups_per, batch), now, ways=ways,
        )
        outs.append(out)
        scans.append(scan)
    out = DecideOutput(**{
        f: torch.stack([getattr(o, f) for o in outs]).sum(0, dtype=_PSUM_DTYPES.get(f, I64))
        for f in DecideOutput._fields
    })
    return out, WaveScan(*(torch.stack(f).sum(0) for f in zip(*scans)))


def decide_fused_plain(
    table: FusedTable, batch: RequestBatch, now: int, *, ways: int = DEFAULT_WAYS
) -> Tuple[FusedTable, DecideOutput, WaveScan]:
    """One decide wave on a flat fused table in plain torch ops (the twin
    of `_decide_fused_impl`); updates `table.data` in place."""
    out, scan = wave_plain(FUSED_CODEC, table.data, None, batch, now, ways=ways)
    return table, out, scan
