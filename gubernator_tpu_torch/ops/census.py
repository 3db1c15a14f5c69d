"""Table census: residency, age and churn scan of the slot table.

The port of `gubernator_tpu/ops/census.py`. One scan per table layout
over the table's wide view (the layout's `to_wide`), as torch ops on
the table's device, returning O(buckets) tensors there (never O(slots)
host transfer):

- log2 histograms of slot AGE (now - stamp) and IDLE time (now - lru)
  over used slots, with their sums;
- a fixed-width per-group-region occupancy heatmap, and the same over
  the slots cold at the first threshold (`cold_heatmap`: the background
  demoter's victim signal, runtime/pager.py `demote_victims`);
- expired-but-resident waste (used and expire_at <= now);
- probe pressure: the per-group used-way fill histogram and the longest
  run of completely full groups;
- cold-set counts: used slots whose idle time exceeds k x their own
  duration, for each k of the thresholds.

Conventions shared with the numpy oracle `census_oracle` (bit-exact with
the JAX package's program and oracle, tests/test_torch_census.py):

- ages and idles clamp negative deltas to 0 (bucket 0);
- bin 0 counts deltas < 1 ms, bin i counts [2^(i-1), 2^i) ms, the last
  bin everything >= 2^(n_buckets-2) ms (searchsorted, right side, over
  one power-of-two boundary vector);
- the heatmap pads the group axis to heatmap_width * ceil(G / R) with
  empty groups, so trailing regions may aggregate fewer groups.

Histograms count each bin with one comparison and one sum over a
one-byte bin index (no atomics, no bincount: bincount sizes its output
from the data's maximum, a device-to-host wait). Nothing in a scan waits
for the device: the engine enqueues it on its stream under the table
lock and reads the O(buckets) result back after releasing it. The
scan does not change the table.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from gubernator_tpu_torch.ops.kernels import get_kernels

I64 = torch.int64

CENSUS_BUCKETS = 32  # log2 ms bins: bin 31 is >= ~12.4 days
DEFAULT_HEATMAP_WIDTH = 64
DEFAULT_THRESHOLDS = (1, 4, 16)  # cold = idle > k x slot duration


class CensusOutput(NamedTuple):
    """O(buckets) tensors from one census scan, on the table's device."""

    live: torch.Tensor  # () int64 used slots
    full_groups: torch.Tensor  # () int64 groups with all ways used
    waste: torch.Tensor  # () int64 used & expire_at <= now
    age_hist: torch.Tensor  # (n_buckets,) int64 log2 ms bins of now - stamp
    age_sum: torch.Tensor  # () int64 clamped age ms over used slots
    idle_hist: torch.Tensor  # (n_buckets,) int64 log2 ms bins of now - lru
    idle_sum: torch.Tensor  # () int64 clamped idle ms over used slots
    heatmap: torch.Tensor  # (heatmap_width,) int64 used slots per region
    fill_hist: torch.Tensor  # (ways + 1,) int64 groups by used-way count
    max_full_run: torch.Tensor  # () int64 longest run of full groups
    cold: torch.Tensor  # (len(thresholds),) int64 used & idle > k * duration
    cold_heatmap: torch.Tensor  # (heatmap_width,) int64 cold slots per region


def bin_counts(idx: torch.Tensor, mask: torch.Tensor, n: int) -> torch.Tensor:
    """(n,) int64: how many masked lanes have idx == b, for each b < n.
    One comparison and one sum per bin over a narrow bin index."""
    dt = torch.uint8 if n < 255 else torch.int32
    key = torch.where(mask, idx, n).to(dt)
    return torch.stack([(key == b).sum(dtype=I64) for b in range(n)])


def log2_bounds(n_buckets: int, device) -> torch.Tensor:
    """The shared boundary vector 2^0 .. 2^(n_buckets-2), made on the
    device (a copy from pageable host memory would wait for the stream)."""
    return 1 << torch.arange(n_buckets - 1, dtype=I64, device=device)


def _log2_bins(values: torch.Tensor, used: torch.Tensor, n_buckets: int):
    """(counts, sum) of `values` over used lanes in log2-ms bins."""
    v = torch.where(used, torch.clamp(values, min=0), 0)
    idx = torch.searchsorted(log2_bounds(n_buckets, v.device), v, right=True)
    return bin_counts(idx, used, n_buckets), v.sum(dtype=I64)


def _per_region(per_group: torch.Tensor, heatmap_width: int) -> torch.Tensor:
    """Sum a per-group count into heatmap_width regions of ceil(G / R)
    groups, the group axis padded with empty groups."""
    groups = per_group.shape[0]
    per = -(-groups // heatmap_width)
    padded = torch.zeros(heatmap_width * per, dtype=I64, device=per_group.device)
    padded[:groups] = per_group
    return padded.view(heatmap_width, per).sum(dim=1, dtype=I64)


def _census_wide(wide, now: int, *, ways: int, heatmap_width: int, thresholds,
                 n_buckets: int) -> CensusOutput:
    used = wide.used
    groups = used.shape[0] // ways
    now = int(now)
    idle = now - wide.lru

    age_hist, age_sum = _log2_bins(now - wide.stamp, used, n_buckets)
    idle_hist, idle_sum = _log2_bins(idle, used, n_buckets)

    g_used = used.view(groups, ways).sum(dim=1, dtype=I64)
    full = g_used == ways
    # Longest run of consecutive full groups: distance to the most
    # recent group that is not full (cummax of its index), 0 outside runs.
    g_idx = torch.arange(groups, dtype=I64, device=used.device)
    last_unfull = torch.cummax(torch.where(full, -1, g_idx), dim=0).values
    max_full_run = torch.where(full, g_idx - last_unfull, 0).max()

    idle_c = torch.clamp(idle, min=0)
    cold = torch.stack([
        (used & (idle_c > int(k) * wide.duration)).sum(dtype=I64) for k in thresholds
    ])
    cold0 = used & (idle_c > int(thresholds[0]) * wide.duration)
    g_cold = cold0.view(groups, ways).sum(dim=1, dtype=I64)

    return CensusOutput(
        live=used.sum(dtype=I64),
        full_groups=full.sum(dtype=I64),
        waste=(used & (wide.expire_at <= now)).sum(dtype=I64),
        age_hist=age_hist,
        age_sum=age_sum,
        idle_hist=idle_hist,
        idle_sum=idle_sum,
        heatmap=_per_region(g_used, heatmap_width),
        fill_hist=bin_counts(g_used, torch.ones_like(full), ways + 1),
        max_full_run=max_full_run,
        cold=cold,
        cold_heatmap=_per_region(g_cold, heatmap_width),
    )


@functools.lru_cache(maxsize=None)
def make_census(
    layout: str,
    ways: int,
    heatmap_width: int = DEFAULT_HEATMAP_WIDTH,
    thresholds: tuple = DEFAULT_THRESHOLDS,
    n_buckets: int = CENSUS_BUCKETS,
    stacked: bool = False,
):
    """The census scan of `layout`: (table, now) -> CensusOutput, on the
    table's device and the current stream, without changing the table or
    waiting for the device. `stacked=True` is the replica tier's variant
    (parallel/ici.py): the table's rows carry a leading replica axis,
    (D, N, C), and the scan reads replica 0 (after a sync tick the
    replicas mirror each other)."""
    to_wide = get_kernels(layout).to_wide
    thresholds = tuple(int(k) for k in thresholds)

    def census(table, now) -> CensusOutput:
        if stacked:
            table = type(table)(table.data[0])
        return _census_wide(
            to_wide(table), now, ways=ways, heatmap_width=heatmap_width,
            thresholds=thresholds, n_buckets=n_buckets,
        )

    return census


# ---------------------------------------------------------------------------
# Plain numpy oracle (the paged host tier's census, and the tests' target)


def census_oracle(
    wide,
    now: int,
    *,
    ways: int,
    heatmap_width: int = DEFAULT_HEATMAP_WIDTH,
    thresholds: tuple = DEFAULT_THRESHOLDS,
    n_buckets: int = CENSUS_BUCKETS,
) -> dict:
    """Reference census over a WIDE table of host numpy arrays; mirrors
    `_census_wide` decision for decision (same clamps, same searchsorted
    boundaries, same heatmap padding). Only used slots count, so the
    per-slot work runs over them alone."""
    used = np.asarray(wide.used, dtype=bool)
    n = used.shape[0]
    groups = n // ways
    live = np.flatnonzero(used)
    stamp = np.asarray(wide.stamp, dtype=np.int64)[live]
    lru = np.asarray(wide.lru, dtype=np.int64)[live]
    expire_at = np.asarray(wide.expire_at, dtype=np.int64)[live]
    duration = np.asarray(wide.duration, dtype=np.int64)[live]
    bounds = np.int64(2) ** np.arange(n_buckets - 1, dtype=np.int64)

    def bins(deltas):
        v = np.maximum(deltas, 0)
        counts = np.bincount(np.searchsorted(bounds, v, side="right"),
                             minlength=n_buckets).astype(np.int64)
        return counts, np.int64(v.sum())

    age_hist, age_sum = bins(np.int64(now) - stamp)
    idle_c = np.maximum(np.int64(now) - lru, 0)
    idle_hist, idle_sum = bins(idle_c)

    g_used = used.reshape(groups, ways).sum(axis=1).astype(np.int64)
    full = g_used == ways
    g_idx = np.arange(groups, dtype=np.int64)
    last_unfull = np.maximum.accumulate(np.where(~full, g_idx, -1))
    max_full_run = int(np.where(full, g_idx - last_unfull, 0).max())

    per_region = -(-groups // heatmap_width)

    def regions(per_group):
        padded = np.zeros(heatmap_width * per_region, dtype=np.int64)
        padded[:groups] = per_group
        return padded.reshape(heatmap_width, per_region).sum(axis=1).astype(np.int64)

    cold = np.array([int((idle_c > np.int64(k) * duration).sum()) for k in thresholds],
                    dtype=np.int64)
    cold0 = idle_c > np.int64(thresholds[0]) * duration
    g_cold = np.bincount(live[cold0] // ways, minlength=groups).astype(np.int64)

    return {
        "live": int(live.size),
        "full_groups": int(full.sum()),
        "waste": int((expire_at <= np.int64(now)).sum()),
        "age_hist": age_hist,
        "age_sum": int(age_sum),
        "idle_hist": idle_hist,
        "idle_sum": int(idle_sum),
        "heatmap": regions(g_used),
        "fill_hist": np.bincount(g_used, minlength=ways + 1).astype(np.int64),
        "max_full_run": max_full_run,
        "cold": cold,
        "cold_heatmap": regions(g_cold),
    }
