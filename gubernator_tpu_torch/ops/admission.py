"""Admission accounting: admitted-vs-limit scan of the slot table.

The port of `gubernator_tpu/ops/admission.py`: one scan per table layout
over the table's wide view, as torch ops on the table's device, that
reduces each key's admitted-this-window against its configured limit to
O(buckets) tensors:

- admitted this window per key: `limit - tokens`, where whole tokens are
  the raw `remaining` of a token bucket and `remaining >> FIXED_SHIFT`
  (an arithmetic shift, the reference's int64 truncation) of a leaky
  bucket's Q44.20 level; clamped at 0;
- per-key EXCESS: `max(0, admitted - limit)`;
- sums of admitted and limit over active keys, the excess sum, the keys
  with excess, the largest excess, the OVER_LIMIT keys, and a log2
  histogram of the per-key excess (the census's boundary rules,
  ops/census.py).

"Active" means used, limit > 0 and a window that has not fully elapsed
(`expire_at > now`). The engine scans the physical frames of a paged
table on the device and its host tier with `admission_oracle`
(runtime/engine.py), as it does the census. Like the census, a scan
waits for nothing and leaves the table as it is.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from gubernator_tpu_torch.ops.census import bin_counts, log2_bounds
from gubernator_tpu_torch.ops.kernels import get_kernels

I64 = torch.int64

# Leaky buckets store their level in Q44.20 fixed point
# (models/bucket.py FIXED_SHIFT); whole tokens = remaining >> 20.
ADMISSION_SHIFT = 20
ADMISSION_BUCKETS = 32  # log2 hit bins: bin 31 is >= 2^30 excess hits

_OVER_LIMIT = 1  # api.types.Status.OVER_LIMIT


class AdmissionOutput(NamedTuple):
    """O(buckets) tensors from one admission scan, on the table's device."""

    keys: torch.Tensor  # () int64 active keys (used, limit > 0, unexpired)
    admitted_sum: torch.Tensor  # () int64 sum clamp(limit - tokens, >= 0)
    limit_sum: torch.Tensor  # () int64 sum limit over active keys
    excess_sum: torch.Tensor  # () int64 sum max(0, admitted - limit)
    excess_keys: torch.Tensor  # () int64 active keys with excess > 0
    max_excess: torch.Tensor  # () int64 worst single-key excess
    over_limit_keys: torch.Tensor  # () int64 active keys at OVER_LIMIT
    excess_hist: torch.Tensor  # (n_buckets,) int64 log2 bins of excess


def _admission_wide(wide, now: int, *, n_buckets: int) -> AdmissionOutput:
    now = int(now)
    active = wide.used & (wide.limit > 0) & (wide.expire_at > now)
    tokens = torch.where(wide.algo == 1, wide.remaining >> ADMISSION_SHIFT, wide.remaining)
    admitted = torch.where(active, torch.clamp(wide.limit - tokens, min=0), 0)
    excess = torch.clamp(admitted - wide.limit, min=0)
    excess_mask = active & (excess > 0)
    # Histogram over keys WITH excess; bin 0 (< 1 hit) stays empty.
    idx = torch.searchsorted(
        log2_bounds(n_buckets, excess.device), torch.where(excess_mask, excess, 0), right=True
    )
    return AdmissionOutput(
        keys=active.sum(dtype=I64),
        admitted_sum=admitted.sum(dtype=I64),
        limit_sum=torch.where(active, wide.limit, 0).sum(dtype=I64),
        excess_sum=excess.sum(dtype=I64),
        excess_keys=excess_mask.sum(dtype=I64),
        max_excess=excess.max(),
        over_limit_keys=(active & (wide.status == _OVER_LIMIT)).sum(dtype=I64),
        excess_hist=bin_counts(idx, excess_mask, n_buckets),
    )


@functools.lru_cache(maxsize=None)
def make_admission(layout: str, ways: int, n_buckets: int = ADMISSION_BUCKETS,
                   stacked: bool = False):
    """The admission scan of `layout`: (table, now) -> AdmissionOutput,
    on the table's device and the current stream, without changing the
    table or waiting for the device. `ways` keys the cache, as in the
    JAX package's `make_admission`; `stacked=True` scans replica 0 of a
    replica tier's (D, N, C) rows, as `make_census` does."""
    to_wide = get_kernels(layout).to_wide

    def admission(table, now) -> AdmissionOutput:
        if stacked:
            table = type(table)(table.data[0])
        return _admission_wide(to_wide(table), now, n_buckets=n_buckets)

    return admission


# ---------------------------------------------------------------------------
# Plain numpy oracle (the paged host tier's accounting, and the tests' target)


def admission_oracle(wide, now: int, *, n_buckets: int = ADMISSION_BUCKETS) -> dict:
    """Reference admission accounting over a WIDE table of host numpy
    arrays; mirrors `_admission_wide` decision for decision (same clamps,
    same arithmetic shift, same searchsorted boundaries)."""
    used = np.asarray(wide.used, dtype=bool)
    algo = np.asarray(wide.algo, dtype=np.int8)
    status = np.asarray(wide.status, dtype=np.int8)
    limit = np.asarray(wide.limit, dtype=np.int64)
    remaining = np.asarray(wide.remaining, dtype=np.int64)
    expire_at = np.asarray(wide.expire_at, dtype=np.int64)

    active = used & (limit > 0) & (expire_at > np.int64(now))
    tokens = np.where(algo == 1, remaining >> ADMISSION_SHIFT, remaining)
    admitted = np.where(active, np.maximum(limit - tokens, 0), 0).astype(np.int64)
    excess = np.maximum(admitted - limit, 0).astype(np.int64)
    excess_mask = active & (excess > 0)

    bounds = np.int64(2) ** np.arange(n_buckets - 1, dtype=np.int64)
    idx = np.searchsorted(bounds, excess[excess_mask], "right")
    excess_hist = np.bincount(idx, minlength=n_buckets).astype(np.int64)

    return {
        "keys": int(active.sum()),
        "admitted_sum": int(admitted.sum()),
        "limit_sum": int(np.where(active, limit, 0).sum()),
        "excess_sum": int(excess.sum()),
        "excess_keys": int(excess_mask.sum()),
        "max_excess": int(excess.max(initial=0)),
        "over_limit_keys": int((active & (status == _OVER_LIMIT)).sum()),
        "excess_hist": excess_hist,
    }
