"""Host-side encoding of validated requests into batch operands.

Resolves everything the kernel must not do itself: string hashing, group
addressing, Gregorian calendar math, leaky burst defaulting, and domain
clamping for the int64-exact leak math. Encoding fills a host numpy
`RequestBatch` (`RequestBatch.zeros`); `ops.layout.batch_to_device`
then moves a whole wave to the device in one copy.

The caller (the assembler) guarantees all active lanes in one batch have
distinct groups; this module just encodes. Semantics are identical to
`gubernator_tpu/ops/encode.py`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from gubernator_tpu_torch.api.keys import group_of, key_hash128
from gubernator_tpu_torch.api.types import Algorithm, Behavior, RateLimitReq
from gubernator_tpu_torch.models.bucket import MAX_COUNT, MAX_DURATION_MS
from gubernator_tpu_torch.ops.layout import RequestBatch
from gubernator_tpu_torch.utils import gregorian as greg


class EncodeError(ValueError):
    """Per-request encoding failure (e.g. invalid Gregorian interval)."""


def encode_one(
    batch: RequestBatch,
    lane: int,
    r: RateLimitReq,
    now_ms: int,
    num_groups: int,
    key: Optional[tuple] = None,
) -> None:
    """Encode one request into `lane` of a host-side RequestBatch.

    `key` optionally carries a precomputed (key_hi, key_lo) pair.
    Raises EncodeError for invalid Gregorian durations; the caller turns
    that into a per-item error response (reference algorithms.go:128-131).
    """
    hi, lo = key if key is not None else key_hash128(r.hash_key())
    is_greg = bool(r.behavior & Behavior.DURATION_IS_GREGORIAN)

    duration = min(max(int(r.duration), 0), MAX_DURATION_MS) if not is_greg else int(r.duration)
    if is_greg:
        # Host resolves the calendar; kernel sees only epoch-ms operands.
        try:
            rate_num = greg.gregorian_duration(now_ms, r.duration)
            greg_expire = greg.gregorian_expiration(now_ms, r.duration)
        except greg.GregorianError as e:
            raise EncodeError(str(e)) from e
        eff_duration = greg_expire - now_ms
    else:
        rate_num = duration
        greg_expire = 0
        eff_duration = duration

    limit = min(max(int(r.limit), -MAX_COUNT), MAX_COUNT)
    hits = min(max(int(r.hits), -MAX_COUNT), MAX_COUNT)
    burst = min(max(int(r.burst), 0), MAX_COUNT)
    if r.algorithm == Algorithm.LEAKY_BUCKET and burst == 0:
        burst = limit  # reference algorithms.go:264-266

    batch.key_hi[lane] = hi
    batch.key_lo[lane] = lo
    batch.group[lane] = group_of(lo, num_groups)
    batch.algo[lane] = int(r.algorithm)
    batch.behavior[lane] = int(r.behavior)
    batch.hits[lane] = hits
    batch.limit[lane] = limit
    batch.duration[lane] = duration
    batch.rate_num[lane] = rate_num
    batch.eff_duration[lane] = eff_duration
    batch.greg_expire[lane] = greg_expire
    batch.burst[lane] = burst
    batch.created_at[lane] = (
        int(r.created_at) if r.created_at is not None else int(now_ms)
    )
    batch.active[lane] = True


def encode_batch(
    reqs: Sequence[RateLimitReq], now_ms: int, num_groups: int, batch_size: int
) -> RequestBatch:
    """Encode up to batch_size requests (caller ensures distinct groups)."""
    if len(reqs) > batch_size:
        raise ValueError(f"{len(reqs)} requests exceed batch_size={batch_size}")
    b = RequestBatch.zeros(batch_size)
    for i, r in enumerate(reqs):
        encode_one(b, i, r, now_ms, num_groups)
    return b


_GREG = int(Behavior.DURATION_IS_GREGORIAN)
_LEAKY = int(Algorithm.LEAKY_BUCKET)


def _clamped(vals, lo_b, hi_b):
    """Vectorized clamp; values beyond int64 are clamped on Python ints
    first (they would make the conversion raise)."""
    try:
        a = np.array(vals, dtype=np.int64)
    except OverflowError:
        a = np.array([min(max(int(v), lo_b), hi_b) for v in vals], dtype=np.int64)
    return np.clip(a, lo_b, hi_b)


def encode_rows(
    wb: RequestBatch,
    lanes,
    rows,  # list of (req, hi, lo, grp)
    now_ms: int,
) -> None:
    """Vectorized twin of encode_one for a whole wave: one attribute pass
    into Python lists, then column-wise numpy assignment. Gregorian items
    raise EncodeError before any column is written (they take
    encode_one)."""
    n = len(rows)
    hits = [0] * n
    limit = [0] * n
    duration = [0] * n
    burst = [0] * n
    algo = [0] * n
    behavior = [0] * n
    created = [0] * n
    key_hi = [0] * n
    key_lo = [0] * n
    group = [0] * n

    for j, (r, hi, lo, grp) in enumerate(rows):
        if r.behavior & _GREG:
            raise EncodeError("encode_rows cannot take Gregorian items")
        hits[j] = r.hits
        limit[j] = r.limit
        duration[j] = r.duration
        burst[j] = r.burst
        algo[j] = int(r.algorithm)
        behavior[j] = int(r.behavior)
        created[j] = int(r.created_at) if r.created_at is not None else now_ms
        key_hi[j] = hi
        key_lo[j] = lo
        group[j] = grp

    hits = _clamped(hits, -MAX_COUNT, MAX_COUNT)
    limit = _clamped(limit, -MAX_COUNT, MAX_COUNT)
    burst = _clamped(burst, 0, MAX_COUNT)
    # leaky items with burst 0 default to their limit (encode_one parity)
    is_leaky = np.array(algo, dtype=np.int8) == _LEAKY
    burst = np.where(is_leaky & (burst == 0), limit, burst)

    lanes = np.asarray(lanes, dtype=np.int64)
    dur = _clamped(duration, 0, MAX_DURATION_MS)
    wb.key_hi[lanes] = key_hi
    wb.key_lo[lanes] = key_lo
    wb.group[lanes] = np.array(group, dtype=np.int32)
    wb.algo[lanes] = np.array(algo, dtype=np.int8)
    wb.behavior[lanes] = np.array(behavior, dtype=np.int32)
    wb.hits[lanes] = hits
    wb.limit[lanes] = limit
    wb.duration[lanes] = dur
    wb.rate_num[lanes] = dur
    wb.eff_duration[lanes] = dur
    wb.greg_expire[lanes] = 0
    wb.burst[lanes] = burst
    wb.created_at[lanes] = created
    wb.active[lanes] = True
