"""Slot-table and batch operand structs, as torch tensors.

Same fields, dtypes and meaning as `gubernator_tpu/ops/layout.py`:

- the table is W-way set-associative: a key's 128-bit hash picks a group
  of W contiguous slots; matching, insertion and LRU eviction happen in
  the decide wave over the W candidates;
- `remaining` holds whole tokens for TOKEN_BUCKET and Q44.20 fixed
  point for LEAKY_BUCKET; `stamp` is the token bucket's CreatedAt or the
  leaky bucket's UpdatedAt; `invalid_at` is the store's re-fetch mark;
- (key_hi, key_lo) == (0, 0) marks an empty slot.

`SlotTable` (one column per field) is the snapshot format every layout
converts to and from, so snapshots move between this package and the
JAX package unchanged. It is also the `wide` layout's table itself
(ops/decide.py, `SlotTable.create`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

DEFAULT_WAYS = 8


class SlotTable(NamedTuple):
    """Struct-of-arrays counter table (the wide snapshot format). Holds
    torch tensors, or numpy arrays for a host-side image."""

    key_hi: torch.Tensor  # (N,) int64
    key_lo: torch.Tensor  # (N,) int64
    used: torch.Tensor  # (N,) bool
    algo: torch.Tensor  # (N,) int8
    status: torch.Tensor  # (N,) int8 (token-bucket sticky status)
    limit: torch.Tensor  # (N,) int64
    duration: torch.Tensor  # (N,) int64
    remaining: torch.Tensor  # (N,) int64 (token: tokens; leaky: Q44.20)
    stamp: torch.Tensor  # (N,) int64 (token: created_at; leaky: updated_at)
    expire_at: torch.Tensor  # (N,) int64 epoch ms
    invalid_at: torch.Tensor  # (N,) int64 epoch ms, 0 = unset
    burst: torch.Tensor  # (N,) int64 (leaky only)
    lru: torch.Tensor  # (N,) int64 last-access epoch ms

    @property
    def num_slots(self) -> int:
        return self.key_hi.shape[0]

    @staticmethod
    def create(num_groups: int, ways: int = DEFAULT_WAYS, device="cuda") -> "SlotTable":
        """The `wide` layout's empty table of num_groups x ways slots."""
        n = num_groups * ways
        return SlotTable(*(torch.zeros((n,), dtype=_TORCH_DTYPES[np.dtype(SLOT_DTYPES[f])],
                                       device=device) for f in SlotTable._fields))


# numpy dtype of every SlotTable column (the snapshot dict's format)
SLOT_DTYPES = {
    f: (np.bool_ if f == "used" else np.int8 if f in ("algo", "status") else np.int64)
    for f in SlotTable._fields
}


def wide_on_device(wide: SlotTable, device=None) -> SlotTable:
    """A wide image (numpy arrays or tensors) as a `wide` table on
    `device` (default: where its columns are): each column a COPY in the
    column's dtype, so that a decide updating the table in place never
    writes into the caller's arrays."""
    cols = []
    for f, c in zip(SlotTable._fields, wide):
        dt = _TORCH_DTYPES[np.dtype(SLOT_DTYPES[f])]
        if torch.is_tensor(c):
            cols.append(c.to(device=device or c.device, dtype=dt, copy=True))
        else:
            cols.append(torch.tensor(np.asarray(c), dtype=dt, device=device))
    return SlotTable(*cols)


class RequestBatch(NamedTuple):
    """Operands of one decide wave, one lane per request.

    Host-resolved fields (the kernel is calendar- and string-free):
    key_hi/key_lo (api/keys.py), group (key_lo mod num_groups), rate_num
    (duration, or the whole Gregorian interval), eff_duration (duration,
    or the time to the interval's end), greg_expire (the interval's end,
    0 when not Gregorian).

    Invariant the assembler maintains: within one batch all active lanes
    have distinct `group` values, so the per-lane row stores never
    collide and per-key request order is kept across waves.

    `zeros` gives numpy columns on the host, which `ops/encode.py` fills;
    `batch_to_device` turns them into torch tensors on a device.
    """

    key_hi: torch.Tensor  # (B,) int64
    key_lo: torch.Tensor  # (B,) int64
    group: torch.Tensor  # (B,) int32
    algo: torch.Tensor  # (B,) int8
    behavior: torch.Tensor  # (B,) int32 bit flags
    hits: torch.Tensor  # (B,) int64
    limit: torch.Tensor  # (B,) int64
    duration: torch.Tensor  # (B,) int64 (raw request field)
    rate_num: torch.Tensor  # (B,) int64
    eff_duration: torch.Tensor  # (B,) int64
    greg_expire: torch.Tensor  # (B,) int64
    burst: torch.Tensor  # (B,) int64 (leaky: 0 already replaced by limit)
    created_at: torch.Tensor  # (B,) int64 epoch ms
    active: torch.Tensor  # (B,) bool padding mask

    @property
    def batch_size(self) -> int:
        return self.key_hi.shape[0]

    @staticmethod
    def zeros(b: int) -> "RequestBatch":
        """Host (numpy) columns for `b` lanes, all inactive."""
        return RequestBatch(
            **{f: np.zeros((b,), dtype=dt) for f, dt in BATCH_DTYPES.items()}
        )


# numpy dtype of every RequestBatch column, in field order
BATCH_DTYPES = {
    "key_hi": np.int64, "key_lo": np.int64, "group": np.int32,
    "algo": np.int8, "behavior": np.int32, "hits": np.int64,
    "limit": np.int64, "duration": np.int64, "rate_num": np.int64,
    "eff_duration": np.int64, "greg_expire": np.int64, "burst": np.int64,
    "created_at": np.int64, "active": np.bool_,
}

# Packing order of batch_to_device: widest first, so every column's
# byte offset is a multiple of its element size.
_PACK_ORDER = sorted(
    RequestBatch._fields, key=lambda f: -np.dtype(BATCH_DTYPES[f]).itemsize
)
_TORCH_DTYPES = {
    np.dtype(np.int64): torch.int64, np.dtype(np.int32): torch.int32,
    np.dtype(np.int8): torch.int8, np.dtype(np.bool_): torch.bool,
}


def batch_prefix(batch: RequestBatch, n: int) -> RequestBatch:
    """The first `n` lanes of a host batch (lanes fill in arrival order,
    so a wave's occupied lanes are a prefix)."""
    return RequestBatch(*(c[:n] for c in batch))


def stack_batches(batches) -> RequestBatch:
    """Host batches of one width -> one host batch of (T, B) columns,
    step t in row t (the scan's operand)."""
    return RequestBatch(*(np.stack(cols) for cols in zip(*batches)))


def batch_to_device(batch: RequestBatch, device) -> RequestBatch:
    """Host numpy batch -> torch tensors on `device` with ONE host-to-
    device copy: the 14 columns are packed into one byte buffer (pinned
    on CUDA, copied without blocking the host) and viewed back out.
    Columns keep their shape, (B,) or (T, B); each is contiguous, so
    step t of a stacked batch sits at offset t * B."""
    device = torch.device(device)
    shape = np.shape(batch.key_hi)
    b = int(np.prod(shape))
    sizes = {f: np.dtype(BATCH_DTYPES[f]).itemsize * b for f in _PACK_ORDER}
    host = torch.empty(
        sum(sizes.values()), dtype=torch.uint8,
        pin_memory=device.type == "cuda",
    )
    h = host.numpy()
    spans = {}
    off = 0
    for f in _PACK_ORDER:
        dt = np.dtype(BATCH_DTYPES[f])
        h[off:off + sizes[f]].view(dt)[:] = np.ravel(getattr(batch, f))
        spans[f] = (off, off + sizes[f], _TORCH_DTYPES[dt])
        off += sizes[f]
    dev = host.to(device, non_blocking=True) if device.type != "cpu" else host
    return RequestBatch(
        **{f: dev[a:e].view(t).view(shape) for f, (a, e, t) in spans.items()}
    )


class DecideOutput(NamedTuple):
    """Per-lane decisions plus batch metrics."""

    status: torch.Tensor  # (B,) int8
    limit: torch.Tensor  # (B,) int64
    remaining: torch.Tensor  # (B,) int64
    reset_time: torch.Tensor  # (B,) int64
    slot: torch.Tensor  # (B,) int64 slot each lane touched (N for padding)
    # Displaced occupant's key when this lane's insert evicted a DIFFERENT
    # live key from the slot ((0,0) = none).
    evicted_hi: torch.Tensor  # (B,) int64
    evicted_lo: torch.Tensor  # (B,) int64
    # Slot freed by token-bucket RESET_REMAINING (reference
    # algorithms.go:78-90).
    freed: torch.Tensor  # (B,) bool
    # metrics (0-d int64): cache hits, misses, unexpired evictions,
    # over-limit answers
    hits: torch.Tensor
    misses: torch.Tensor
    unexpired_evictions: torch.Tensor
    over_limit: torch.Tensor


class WaveScan(NamedTuple):
    """Admission/census sums over the rows ONE wave wrote (post-update
    state at the wave's `now`), as `gubernator_tpu/ops/pallas_decide.py`
    WaveScan defines them."""

    adm_keys: torch.Tensor  # () written rows active for admission
    adm_admitted: torch.Tensor  # () sum clamp(limit - tokens, >= 0)
    adm_limit: torch.Tensor  # () sum limit over admission-active rows
    census_live: torch.Tensor  # () written rows left used
    census_waste: torch.Tensor  # () written used rows already expired
