"""The slot meta word: lru<<4 | status<<2 | algo<<1 | used.

A cross-layout contract (snapshots are exchanged in the wide format and
re-packed), identical to `gubernator_tpu/ops/packed.py`. The CUDA kernel
packs the same bits in `csrc/decide_lane.cuh`.
"""

from __future__ import annotations

import torch

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
