"""Host-side page-residency manager for the paged slot table.

The port of `gubernator_tpu/runtime/pager.py`, for one table or a
mesh-sharded one (`n_shards`). The device
half of paging is `ops/paged.py` (the page map and positional page
moves); this module owns the HOST half: which logical page sits in which
physical frame (a numpy mirror of the device map), the free-frame list,
per-page touch recency, and the host-DRAM cold tier (demoted pages as
wide numpy row blocks). The engine calls `ensure_resident` before each
wave's decide, so a wave never runs against a demoted page.

Locking: the Pager has no lock of its own. Every method that changes
state is called with the owning engine's table lock held (the serving
pump, snapshot and restore all take it).

Order matters and follows the JAX package exactly, so pager state can be
compared with it: `acquire_frame` pops the END of `free`, victims are the
least recently touched resident page (lowest tick, ties to the lowest
logical page), and every bind, unbind and write updates the device map
(through the page op) and the host mirror together.

A demote copies the page to the host in one copy (`read_page`: the
frame's packed rows to a pinned buffer on PyTorch's current stream,
which orders it after every decide launched before it, then unpacked on
the host) and then unbinds the frame. Pages demote on demand, when a
wave needs a frame and none is free, and in the background
(`demote_victims`, the engine's demoter): census-cold pages first
(`coldness_from_heatmap`), the LRU touch tick breaking ties, until each
shard's pool has the free-frame target.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from gubernator_tpu_torch.ops.layout import SLOT_DTYPES, SlotTable


def wide_zeros(n: int) -> Dict[str, np.ndarray]:
    """One n-row block of empty wide (SlotTable-shaped) host rows."""
    return {f: np.zeros(n, dtype=SLOT_DTYPES[f]) for f in SlotTable._fields}


class PageBudgetError(RuntimeError):
    """One wave touches more distinct pages than there are physical
    frames: the resident-page budget cannot hold a single wave's working
    set. Raised loudly: silently dropping lanes would serve wrong
    decisions."""


class Pager:
    """Tracks residency for a PagedKernels-backed table.

    State (all guarded by the engine's table lock):
      page_map:  host mirror of the device map (lp -> pp, -1 demoted)
      free:      physical frames not bound to any logical page
      touch:     per-logical-page monotonic touch tick (LRU victims)
      host_tier: lp -> {field: np.ndarray(page_slots,)} wide rows

    n_shards > 1 runs the same bookkeeping over a mesh-sharded physical
    table (`parallel/mesh.py::make_mesh_kernels`): the frames split into
    n_shards contiguous per-shard pools, a logical page only ever binds
    a frame of its own shard's pool, and victims come from that shard's
    residents, so one shard's pressure never evicts another shard's
    pages. The host tier is keyed by logical page either way."""

    def __init__(self, kernels, *, n_shards: int = 1):
        self.PK = kernels
        if n_shards <= 0:
            raise ValueError(f"n_shards must be >= 1: {n_shards}")
        if n_shards > 1:
            if kernels.num_phys_pages % n_shards:
                raise ValueError(
                    f"page budget {kernels.num_phys_pages} must divide by "
                    f"mesh size {n_shards} (equal per-shard frame pools)"
                )
            if kernels.num_logical_pages % n_shards:
                raise ValueError(
                    f"logical page count {kernels.num_logical_pages} must "
                    f"divide by mesh size {n_shards} (pages must not "
                    "straddle shard boundaries)"
                )
        self.n_shards = n_shards
        self.frames_per_shard = kernels.num_phys_pages // n_shards
        self.pages_per_shard = -(-kernels.num_logical_pages // n_shards)
        self.page_map = np.full(kernels.num_logical_pages, -1, dtype=np.int32)
        self.free: List[int] = list(range(kernels.num_phys_pages))
        self.touch = np.zeros(kernels.num_logical_pages, dtype=np.int64)
        self._tick = 0
        self.host_tier: Dict[int, Dict[str, np.ndarray]] = {}
        self.demotes = 0
        self.promotes = 0
        self.binds = 0

    # ---- shard geometry ----------------------------------------------------

    def shard_of_page(self, lp: int) -> int:
        """Owner shard of a logical page (0 on one table)."""
        return int(lp) // self.pages_per_shard

    def shard_of_frame(self, pp: int) -> int:
        """Owner shard of a physical frame (0 on one table)."""
        return int(pp) // self.frames_per_shard

    # ---- residency queries -------------------------------------------------

    def resident_count(self) -> int:
        return self.PK.num_phys_pages - len(self.free)

    def host_count(self) -> int:
        return len(self.host_tier)

    def host_bytes(self) -> int:
        return sum(
            sum(a.nbytes for a in rows.values()) for rows in self.host_tier.values()
        )

    def touched_pages(self, groups, active=None) -> np.ndarray:
        """Distinct logical pages hit by a host batch's group column."""
        g = np.asarray(groups)
        if active is not None:
            g = g[np.asarray(active)]
        if g.size == 0:
            return g.astype(np.int64)
        return np.unique(g.astype(np.int64) // self.PK.groups_per_page)

    def phys_groups(self, groups: np.ndarray) -> np.ndarray:
        """Host-side logical -> physical group translation; groups on
        non-resident pages map to -1."""
        g = np.asarray(groups, dtype=np.int64)
        gpp = self.PK.groups_per_page
        pp = self.page_map[g // gpp].astype(np.int64)
        return np.where(pp >= 0, pp * gpp + g % gpp, np.int64(-1))

    def host_live_keys(self) -> Set[Tuple[int, int]]:
        """(key_hi, key_lo) of every used slot in the host tier: key
        pruning keeps the strings of demoted keys (they are still live;
        a promote brings them back verbatim)."""
        out: Set[Tuple[int, int]] = set()
        for rows in self.host_tier.values():
            used = rows["used"]
            out.update(zip(rows["key_hi"][used].tolist(), rows["key_lo"][used].tolist()))
        return out

    def host_tier_copy(self) -> Dict[int, Dict[str, np.ndarray]]:
        """Shallow copy for readers outside the lock. Stored row blocks
        are never changed in place (demote replaces the dict entry)."""
        return dict(self.host_tier)

    # ---- residency transitions (engine lock held) --------------------------

    def ensure_resident(self, table, pages):
        """Promote every page in `pages` (logical page indices), demoting
        LRU victims if no frame is free. Returns the table."""
        pages = [int(p) for p in np.atleast_1d(pages)]
        self._tick += 1
        for lp in pages:
            self.touch[lp] = self._tick
        protect = set(pages)
        for lp in pages:
            if self.page_map[lp] < 0:
                table = self._promote_one(table, lp, protect)
        return table

    def acquire_frame(self, lp: int) -> Optional[int]:
        """Pop a free frame eligible to hold logical page `lp`: any frame
        on one table, the page's own shard pool on a mesh (the last such
        entry of `free`). None when the (per-shard) pool is dry. Every
        bind site (promote and the engine's paged restore) goes through
        here, so shard placement is never bypassed."""
        if self.n_shards == 1:
            return self.free.pop() if self.free else None
        shard = self.shard_of_page(lp)
        for i in range(len(self.free) - 1, -1, -1):
            if self.shard_of_frame(self.free[i]) == shard:
                return self.free.pop(i)
        return None

    def _promote_one(self, table, lp: int, protect: Set[int]):
        pp = self.acquire_frame(lp)
        if pp is None:
            victim = self._coldest_resident(protect, shard=self.shard_of_page(lp))
            if victim is None:
                budget = self.frames_per_shard if self.n_shards > 1 else self.PK.num_phys_pages
                raise PageBudgetError(
                    f"page budget {budget}"
                    + (f" (per shard, x{self.n_shards})" if self.n_shards > 1 else "")
                    + f" cannot hold {len(protect)} distinct pages touched "
                    "by one wave; raise GUBER_TABLE_PAGE_BUDGET"
                )
            table = self.demote(table, victim)
            pp = self.acquire_frame(lp)
        rows = self.host_tier.pop(lp, None)
        if rows is None:
            table = self.PK.bind_page(table, lp, pp)
            self.binds += 1
        else:
            table = self.PK.write_page(table, lp, pp, SlotTable(**rows))
            self.promotes += 1
        self.page_map[lp] = pp
        return table

    def demote(self, table, lp: int):
        """Evacuate one resident page to the host tier (positional wide
        rows) and unbind its frame. All-empty pages are dropped, not
        stored: a later touch binds a zeroed frame."""
        pp = int(self.page_map[lp])
        if pp < 0:
            return table
        host = self.PK.read_page(table, pp)
        if host["used"].any():
            self.host_tier[lp] = host
        table = self.PK.unbind_page(table, lp, pp)
        self.page_map[lp] = -1
        self.free.append(pp)
        self.demotes += 1
        return table

    def _coldest_resident(self, protect: Set[int], shard: Optional[int] = None) -> Optional[int]:
        """The least recently touched resident page outside `protect`
        (ties to the lowest logical page), of `shard` only when given."""
        resident = np.nonzero(self.page_map >= 0)[0]
        candidates = [
            lp for lp in resident.tolist()
            if lp not in protect and (shard is None or self.shard_of_page(lp) == shard)
        ]
        if not candidates:
            return None
        return min(candidates, key=lambda lp: int(self.touch[lp]))

    def coldness_from_heatmap(self, cold_heatmap, groups_per_region: int) -> Dict[int, float]:
        """Fold the census's per-region cold-slot heatmap (over PHYSICAL
        groups: the census scans the frames) into a coldness score per
        resident LOGICAL page: the cold counts of the regions its frame's
        groups overlap, each weighted by the overlap's share of the
        region."""
        hm = np.asarray(cold_heatmap, dtype=np.float64)
        per = max(1, int(groups_per_region))
        gpp = self.PK.groups_per_page
        out: Dict[int, float] = {}
        for lp in np.nonzero(self.page_map >= 0)[0].tolist():
            pp = int(self.page_map[lp])
            g0, g1 = pp * gpp, (pp + 1) * gpp
            total = 0.0
            for r in range(g0 // per, min((g1 - 1) // per, len(hm) - 1) + 1):
                overlap = min(g1, (r + 1) * per) - max(g0, r * per)
                if overlap > 0:
                    total += float(hm[r]) * (overlap / float(per))
            out[lp] = total
        return out

    def _pick_victim(self, coldness: Optional[Dict[int, float]],
                     shard: Optional[int] = None) -> Optional[int]:
        """The demoter's victim: the census-coldest resident page, the
        LRU touch tick breaking ties (and the whole order without
        coldness), then the lowest logical page; of `shard` only when
        given."""
        resident = [
            lp for lp in np.nonzero(self.page_map >= 0)[0].tolist()
            if shard is None or self.shard_of_page(lp) == shard
        ]
        if not resident:
            return None
        cold = coldness or {}
        return min(resident, key=lambda lp: (-cold.get(lp, 0.0), int(self.touch[lp])))

    def demote_victims(self, table, want_free: int, min_idle_ticks: int = 0, coldness=None):
        """The background demoter's step: demote resident pages until
        `want_free` frames are free, census-coldest first when `coldness`
        (`coldness_from_heatmap`) is given, LRU otherwise. With
        min_idle_ticks > 0 a page touched within that many
        `ensure_resident` rounds is spared unless the census counts it
        cold (and the pass stops there). On a mesh the target holds for
        EACH shard's pool, from that shard's residents. Returns the
        table."""
        for shard in range(self.n_shards):
            while self._free_in_shard(shard) < want_free:
                victim = self._pick_victim(coldness, shard=shard if self.n_shards > 1 else None)
                if victim is None:
                    break
                census_cold = bool(coldness) and coldness.get(victim, 0.0) > 0
                if (not census_cold and min_idle_ticks > 0
                        and self._tick - int(self.touch[victim]) < min_idle_ticks):
                    break  # everything left was touched too recently
                table = self.demote(table, victim)
        return table

    def _free_in_shard(self, shard: int) -> int:
        if self.n_shards == 1:
            return len(self.free)
        return sum(1 for pp in self.free if self.shard_of_frame(pp) == shard)

    def reset(self) -> None:
        """The engine rebuilt an empty paged table: every mirror entry,
        frame and host page is gone."""
        self.page_map.fill(-1)
        self.free = list(range(self.PK.num_phys_pages))
        self.touch.fill(0)
        self.host_tier.clear()

    # ---- observability -----------------------------------------------------

    def pages_snapshot(self) -> dict:
        """Residency summary, in the JAX pager's form (with the per-shard
        breakdown on a mesh)."""
        nlp = self.PK.num_logical_pages
        snap = {
            "enabled": True,
            "groups_per_page": self.PK.groups_per_page,
            "page_slots": self.PK.page_slots,
            "logical_pages": nlp,
            "budget": self.PK.num_phys_pages,
            "resident": self.resident_count(),
            "free": len(self.free),
            "host": len(self.host_tier),
            "host_bytes": self.host_bytes(),
            "demotes": self.demotes,
            "promotes": self.promotes,
            "binds": self.binds,
        }
        if self.n_shards > 1:
            # each shard pages on its own, so a healthy aggregate can hide
            # one starved pool
            per = self.pages_per_shard
            snap["n_shards"] = self.n_shards
            snap["frames_per_shard"] = self.frames_per_shard
            snap["shards"] = [
                {
                    "resident": int((self.page_map[s * per:(s + 1) * per] >= 0).sum()),
                    "free": self._free_in_shard(s),
                    "host": sum(1 for lp in self.host_tier if self.shard_of_page(lp) == s),
                }
                for s in range(self.n_shards)
            ]
        if nlp <= 4096:  # bounded debug payload
            snap["page_map"] = self.page_map.tolist()
        return snap
