"""Device-memory accounting: per-subsystem attribution and headroom.

The port of `gubernator_tpu/utils/devicemem.py`. Each engine names its
resident subsystems (slot table, replica tier, census buffers, pipeline
ring, snapshot staging) and sizes them from its geometry; the snapshot
adds what the device itself reports.

Two sources, ONE schema (the JAX package's keys; only `source`
differs):

- "device": a CUDA device. `bytes_in_use` is the caching allocator's
  `allocated_bytes.all.current` (`torch.cuda.memory_stats`), its peak
  `allocated_bytes.all.peak`, and `bytes_limit` the card's total from
  `torch.cuda.mem_get_info`. The subsystem map stays the geometry
  estimate; the gap is `unattributed_bytes`.
- "estimated": the CPU. `bytes_in_use` is the sum of the subsystem
  estimates and the capacity ESTIMATED_CAPACITY_BYTES, a documented
  assumption, not a measurement, as the JAX package reports off a TPU.
"""

from __future__ import annotations

from typing import Optional

import torch

SCHEMA_VERSION = 1

# Capacity assumption for the estimated fallback, used ONLY when the
# device reports no allocator stats (the JAX package's, one v5e core's
# 16 GiB). The snapshot labels itself source="estimated".
ESTIMATED_CAPACITY_BYTES = 16 << 30


def device_stats(device=None) -> Optional[dict]:
    """{bytes_in_use, peak_bytes_in_use, bytes_limit} of a CUDA
    `device` (a torch.device or its name), or None for any other device
    or when CUDA is unavailable. Reads allocator statistics only: no
    device work."""
    if device is None:
        return None
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    stats = torch.cuda.memory_stats(dev)
    _free, total = torch.cuda.mem_get_info(dev)
    in_use = int(stats.get("allocated_bytes.all.current", 0))
    return {
        "bytes_in_use": in_use,
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", in_use)),
        "bytes_limit": int(total),
    }


def snapshot(
    subsystems: Optional[dict] = None,
    device=None,
    capacity_bytes: Optional[int] = None,
) -> dict:
    """One device-memory accounting snapshot.

    `subsystems` maps subsystem name -> estimated resident bytes (static
    geometry, computed once by the engine at init). The returned dict
    has the SAME keys whether backed by device stats or the estimated
    fallback; only `source` distinguishes them."""
    subs = {k: int(v) for k, v in (subsystems or {}).items()}
    accounted = sum(subs.values())
    stats = device_stats(device)
    if stats is not None:
        source = "device"
        in_use = stats["bytes_in_use"]
        limit = stats["bytes_limit"]
        peak = stats["peak_bytes_in_use"]
    else:
        source = "estimated"
        in_use = accounted
        limit = 0
        peak = in_use
    if limit <= 0:
        limit = int(capacity_bytes or ESTIMATED_CAPACITY_BYTES)
    headroom = max(limit - in_use, 0)
    return {
        "v": SCHEMA_VERSION,
        "source": source,
        "bytes_in_use": in_use,
        "peak_bytes_in_use": peak,
        "bytes_limit": limit,
        "headroom_bytes": headroom,
        "headroom_frac": headroom / limit if limit else 0.0,
        "subsystems": subs,
        "accounted_bytes": accounted,
        "unattributed_bytes": max(in_use - accounted, 0),
    }
