"""Persistence seams: Loader (checkpoint/restore) and Store (durability).

The port of `gubernator_tpu/store/store.py`. The reference defines two
plugin interfaces (reference store.go:49-78):

- Loader: bulk Load() at startup, Save() at shutdown: checkpoint and
  resume.
- Store: OnChange after every update (write-behind), Get on a cache miss
  (read-through) and Remove.

Both fire at wave granularity here (runtime/engine.py): before a wave's
decide the engine probes the table for the wave's keys and injects the
freshest state of each miss (`Store.get`); after the decide it gathers
the rows the wave wrote (exact raw state, the leaky fixed-point
fraction included) and hands them to `Store.on_change` before the
flush's futures resolve.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Iterable, List, Optional, Protocol

import numpy as np

from gubernator_tpu_torch.api.keys import key_hash128
from gubernator_tpu_torch.api.types import Algorithm, RateLimitReq

# ItemSnapshot's state fields, in order, and the wide snapshot column
# each comes from.
SNAPSHOT_COLUMNS = (
    ("algorithm", "algo"), ("status", "status"), ("limit", "limit"),
    ("duration", "duration"), ("remaining", "remaining"), ("stamp", "stamp"),
    ("expire_at", "expire_at"), ("invalid_at", "invalid_at"), ("burst", "burst"),
)


@dataclasses.dataclass
class ItemSnapshot:
    """One key's raw counter state: the portable form of a slot row (the
    reference's CacheItem and bucket struct, store.go:29-43)."""

    key: str  # hash_key (name + "_" + unique_key)
    algorithm: int = Algorithm.TOKEN_BUCKET
    status: int = 0
    limit: int = 0
    duration: int = 0
    remaining: int = 0  # raw: whole tokens (token) / Q44.20 (leaky)
    stamp: int = 0  # created_at (token) / updated_at (leaky)
    expire_at: int = 0
    invalid_at: int = 0
    burst: int = 0


class Store(Protocol):
    """Write-behind and read-through durability plugin (reference
    store.go:49-65, wave-granular here)."""

    def on_change(self, items: List[ItemSnapshot]) -> None: ...

    def get(self, req: RateLimitReq) -> Optional[ItemSnapshot]: ...

    def remove(self, key: str) -> None: ...


class Loader(Protocol):
    """Bulk checkpoint/restore plugin (reference store.go:69-78)."""

    def load(self) -> Iterable[ItemSnapshot]: ...

    def save(self, items: Iterable[ItemSnapshot]) -> None: ...


class MemoryStore:
    """Dict-backed Store (the reference's MockStore, store.go:80-112):
    for tests and as a template."""

    def __init__(self):
        self.data: Dict[str, ItemSnapshot] = {}
        self.lock = threading.Lock()
        self.get_calls = 0
        self.change_calls = 0

    def on_change(self, items: List[ItemSnapshot]) -> None:
        # The engine builds the snapshots fresh per flush and never
        # touches them again: the store keeps them without a copy.
        with self.lock:
            self.change_calls += 1
            for it in items:
                self.data[it.key] = it

    def get(self, req: RateLimitReq) -> Optional[ItemSnapshot]:
        with self.lock:
            self.get_calls += 1
            it = self.data.get(req.hash_key())
            return dataclasses.replace(it) if it is not None else None

    def remove(self, key: str) -> None:
        with self.lock:
            self.data.pop(key, None)


class MemoryLoader:
    """List-backed Loader (the reference's MockLoader, store.go:114-150)."""

    def __init__(self, items: Optional[List[ItemSnapshot]] = None):
        self.items: List[ItemSnapshot] = list(items or [])
        self.called_load = 0
        self.called_save = 0

    def load(self) -> Iterable[ItemSnapshot]:
        self.called_load += 1
        return list(self.items)

    def save(self, items: Iterable[ItemSnapshot]) -> None:
        self.called_save += 1
        self.items = list(items)


# ---- engine glue -----------------------------------------------------------


def snapshots_from_engine(engine) -> List[ItemSnapshot]:
    """The engine's live rows as portable snapshots, in slot order (the
    Loader.Save feed; reference workers.go:451-534). A row whose key
    string the engine does not hold is left out."""
    snap = engine.snapshot()
    keys = snap["key_strings"]
    idx = np.nonzero(np.asarray(snap["used"]))[0]
    hi = snap["key_hi"][idx].tolist()
    lo = snap["key_lo"][idx].tolist()
    cols = [np.asarray(snap[c])[idx].tolist() for _, c in SNAPSHOT_COLUMNS]
    out: List[ItemSnapshot] = []
    for k, row in zip(zip(hi, lo), zip(*cols)):
        key = keys.get(k)
        if key is None:
            continue  # anonymous row
        out.append(ItemSnapshot(key, *row))
    return out


def merge_snapshots_lww(engine, items: List[ItemSnapshot]) -> tuple:
    """Last-writer-wins merge of incoming snapshots into an engine table
    (the receiver half of a ring-change handover).

    Unlike `inject_snapshots`' unconditional overwrite (right for the
    Loader restore into an empty table), a handover can race live
    traffic at the receiver. Per key:

    - a strictly newer local `stamp` wins (the receiver re-created the
      bucket after the sender took its snapshot);
    - at equal stamps the MORE-CONSUMED side wins (lower `remaining`):
      both hold copies of one bucket, and within a window hits only
      consume, so the lower remaining carries more of the true count.

    Duplicates inside `items` reduce by the same rule, so the result
    does not depend on arrival order. Returns (accepted, stale)."""
    if not items:
        return 0, 0
    snap = engine.snapshot()
    idx = np.nonzero(np.asarray(snap["used"]))[0]
    existing: Dict[tuple, tuple] = dict(zip(
        zip(snap["key_hi"][idx].tolist(), snap["key_lo"][idx].tolist()),
        zip(snap["stamp"][idx].tolist(), snap["remaining"][idx].tolist()),
    ))

    def _loses(have: tuple, s: ItemSnapshot) -> bool:
        return have[0] > s.stamp or (have[0] == s.stamp and have[1] <= s.remaining)

    keep: Dict[tuple, ItemSnapshot] = {}
    stale = 0
    for s in items:
        kh = key_hash128(s.key)
        have = existing.get(kh)
        if have is not None and _loses(have, s):
            stale += 1
            continue
        prev = keep.get(kh)
        if prev is not None:
            if _loses((prev.stamp, prev.remaining), s):
                stale += 1
                continue
            stale += 1  # prev superseded within the batch
        keep[kh] = s
    engine.inject_snapshots(list(keep.values()))
    return len(keep), stale


def save_engine(engine, loader: Loader) -> int:
    items = snapshots_from_engine(engine)
    loader.save(items)
    return len(items)


def load_engine(engine, loader: Loader) -> int:
    """Stream the loader's items into the engine's table before serving
    (reference gubernator.go:138-148 -> workers.go:329-446)."""
    items = list(loader.load())
    engine.inject_snapshots(items)
    return len(items)


def attach_store(engine, store: Store) -> None:
    """Enable read-through and write-behind on an engine. Read-through is
    driven by the table's residency probe and write-behind keys come from
    the requests; the engine's key-string dictionary lets it prefetch
    never-seen keys outside its table lock. `warm_store_path` builds the
    store path's kernels before traffic."""
    engine.store = store
    warm = getattr(engine, "warm_store_path", None)
    if warm is not None:
        warm()
