"""IciEngine: the engine core served over an owner-sharded mesh.

The port of `gubernator_tpu/runtime/ici_engine.py`. IciEngine IS
MeshEngine (runtime/engine.py) bound to the mesh topology
(runtime/topology.py IciMeshTopology). It replaces the peer mesh inside
one process:

- Non-GLOBAL traffic runs through the owner-sharded decide
  (parallel/mesh.py): the slot table shards over the mesh's shards and
  every wave answers each lane at its owner, one kernel launch per wave
  on a card. Paging works as on one table, with one frame pool per
  shard, which the background demoter keeps at `page_free_target` free
  frames each.
- GLOBAL traffic runs through per-shard replicas (parallel/ici.py): a
  lane's home is the next value of a round-robin cursor (the node the
  request hit), its home's replica answers it, one launch of the same
  sharded kernel per replica wave over the stacked replicas, and its
  non-owned hits wait in the replica's pending deltas. A background
  thread runs the sync tick every `sync_wait_s` (the reference's
  GlobalSyncWait, 100 ms): the globalManager with reductions over the
  replica axis instead of gRPC.

This file adds only what is policy, not topology: the sync cadence (the
thread, the overflow and backlog counters, the full-tick backstop, the
tick's histograms, flight-recorder record and watchdog beat) and
`inject_globals`, which lands an authoritative push on every replica.
A tick runs under the engine's lock and guard on its stream, after every
wave dispatched before it, and reads back one (D, 4) `diag` behind one
event.

The public surface matches DeviceEngine (check_async / check_bulk /
check_batch / check_columns / close / snapshot / restore / stats), so
V1Service and the serving edge take either: a GLOBAL column reaches the
replica tier through `check_columns` as a GLOBAL request does on the
object path. Wave rules differ per tier: sharded lanes split on group
conflicts, replica lanes on (home, slot) conflicts (the same key on one
replica serializes; on different replicas it is multi-node GLOBAL
behavior and may share a wave).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Callable, NamedTuple, Optional

import torch

from gubernator_tpu_torch.api.keys import key_hash128_batch
from gubernator_tpu_torch.models.bucket import FIXED_SHIFT
from gubernator_tpu_torch.ops.inject import InjectBatch
from gubernator_tpu_torch.runtime.engine import MeshEngine, _read_back, _WaveAssembler
from gubernator_tpu_torch.parallel.mesh import check_mesh_layout
from gubernator_tpu_torch.runtime.topology import IciMeshTopology
from gubernator_tpu_torch.utils import clock as _clock

log = logging.getLogger("gubernator_tpu_torch.ici")


class _TickDiag(NamedTuple):
    """A sync tick's (D, 4) diag, read back as the scans' results are."""

    diag: torch.Tensor


@dataclasses.dataclass
class IciEngineConfig:
    """The mesh tier's knobs (defaults mirror the JAX engine's)."""

    # One device per shard, repeats allowed (["cpu"] * 8, ["cuda:0"] * 8);
    # None: one shard per visible card.
    devices: Optional[list] = None
    num_groups: int = 1 << 12  # sharded-table groups (divisible by the shard count)
    ways: int = 8
    # GLOBAL replica tier: slots per replica (num_slots / replica_ways
    # groups, divisible by the shard count) and their associativity.
    num_slots: int = 1 << 14
    replica_ways: int = 4
    batch_size: int = 1024
    batch_limit: int = 1000
    batch_wait_s: float = 500e-6
    max_flush_items: int = 8192
    max_waves: int = 32  # per-flush wave cap; overflow carries over
    sync_wait_s: float = 0.1  # GLOBAL sync cadence (reference 100 ms)
    # Observatories, as in EngineConfig; the census and the admission
    # scan cover the sharded table and replica 0 of the replica tier.
    census_ttl_s: float = 5.0
    census_thresholds: tuple = (1, 4, 16)
    census_heatmap_width: int = 64
    admission_ttl_s: float = 5.0
    layout: str = "fused"  # both tiers: "fused" or "narrow" (parallel/mesh.py MESH_LAYOUTS)
    # Groups a sync tick merges at most: the groups whose content
    # diverges across replicas or that hold pending deltas or expired
    # rows; the rest carries to the next tick (`sync_backlog`). None
    # merges the whole replica table every tick.
    max_sync_groups: "int | None" = 65536
    # Fingerprint-collision backstop: every this many capped ticks, one
    # tick merges the whole table (0: never; ignored when uncapped).
    full_tick_every: int = 64
    # Paged table: page_groups > 0 pages the sharded table, the page map
    # shared by the shards, the frames split into one pool per shard
    # (page_budget must divide by the shard count). The replica tier
    # stays flat.
    page_groups: int = 0
    page_budget: int = 0
    # The background demoter, as in EngineConfig; the free-frame target
    # holds for each shard's pool.
    page_demote_interval_s: float = 2.0
    page_free_target: int = 1
    pipeline_depth: int = 2  # flushes in flight, as in EngineConfig
    # Telemetry, as in EngineConfig: the hot-key sketch's entries and
    # the per-answer stage breakdown.
    hotkeys_k: int = 128
    stage_metadata: bool = False


class IciEngine(MeshEngine):
    # GLOBAL-flagged requests are routed to the replica tier inside the
    # engine; V1Service and the edge must not strip the flag.
    routes_global_internally = True

    def __init__(self, config: Optional[IciEngineConfig] = None,
                 now_fn: Callable[[], int] = _clock.now_ms):
        cfg = config if config is not None else IciEngineConfig()
        check_mesh_layout(cfg.layout)  # wide and packed: one table only
        topo = IciMeshTopology(cfg.devices)
        n_dev = topo.n_dev
        if cfg.num_groups % n_dev:
            raise ValueError(
                f"num_groups {cfg.num_groups} must divide by the shard count {n_dev}"
            )
        if cfg.replica_ways < 1 or cfg.num_slots % (cfg.replica_ways * n_dev):
            raise ValueError(
                f"num_slots {cfg.num_slots} must divide by replica_ways * shard count "
                f"({cfg.replica_ways} * {n_dev})"
            )
        if cfg.num_slots // cfg.replica_ways * n_dev >= 1 << 31:
            raise ValueError(
                "num_slots / replica_ways * shard count must stay below 2^31: a replica "
                "lane's int32 group column carries home * num_rgroups + slot"
            )
        # The sync cadence's counters: keys kept replica-local now
        # (overflow_keys), a running total of overflow entries dropped
        # (overflow_drops), the active groups the last capped tick left
        # (sync_backlog), forced full ticks (full_ticks).
        self._sync_errors = 0
        self.overflow_keys = 0
        self.overflow_drops = 0
        self.sync_backlog = 0
        self.full_ticks = 0
        self._capped_ticks = 0
        super().__init__(cfg, now_fn, topology=topo)
        self._stop_sync = threading.Event()
        self._sync_thread = threading.Thread(
            target=self._sync_loop, daemon=True, name=topo.thread_name + "-sync"
        )
        self._sync_thread.start()

    @property
    def n_dev(self) -> int:
        return self.topo.n_dev

    @property
    def mesh(self):
        return self.topo.mesh

    @property
    def num_rgroups(self) -> int:
        return self._rtier.num_rgroups

    @property
    def ici_state(self):
        return self._rtier.state

    @ici_state.setter
    def ici_state(self, state) -> None:
        self._rtier.state = state

    def stats(self) -> dict:
        """The core's counters plus the shard count and the sync
        cadence's: overflow_keys, overflow_drops, sync_backlog,
        full_ticks."""
        return dict(
            super().stats(), n_dev=self.n_dev, overflow_keys=self.overflow_keys,
            overflow_drops=self.overflow_drops, sync_backlog=self.sync_backlog,
            full_ticks=self.full_ticks,
        )

    def sync_now(self) -> None:
        """Run one GLOBAL sync tick now (the sync thread's tick body):
        enqueued under the engine's lock and guard on its stream, then
        its `diag` read back behind one event, after the lock is
        released. Every `full_tick_every`-th capped tick merges the whole
        table instead (the backstop). Feeds the tick's histograms
        (`ici_tick_duration`, `ici_tick_groups`) and the flight recorder,
        as the JAX engine's tick does."""
        now = self.now_fn()
        t0 = time.perf_counter()
        rt = self._rtier
        with self._lock, self.topo.dispatch_guard(), self._on_stream():
            sync = rt.sync
            if rt.sync_full is not None:
                self._capped_ticks += 1
                if self._capped_ticks >= self.cfg.full_tick_every:
                    self._capped_ticks = 0
                    self.full_ticks += 1
                    sync = rt.sync_full
            pending = _read_back(_TickDiag(rt.run_sync(sync, now)))
        d = pending()["diag"]
        # kept/dropped cover the groups merged THIS tick; the backlog is
        # the same on every replica
        with self._stats_lock:
            self.overflow_keys = int(d[:, 0].sum())
            self.overflow_drops += int(d[:, 1].sum())
            self.sync_backlog = int(d[:, 2].max())
        dur = time.perf_counter() - t0
        groups = int(d[:, 3].max())
        em = self.metrics
        em.ici_tick_duration.observe(dur)
        em.ici_tick_groups.observe(groups)
        em.recorder.record(
            path="ici-sync", layout=self.cfg.layout, groups=groups,
            backlog=self.sync_backlog, overflow_keys=self.overflow_keys,
            dur_us=int(dur * 1e6), trace_id="",
        )

    def inject_globals(self, globals_) -> None:
        """Apply an authoritative UpdatePeerGlobals push (objects with
        `key`, `algorithm`, `duration` and `status` (a RateLimitResp))
        to every replica: the cross-pod leg landing on this engine."""
        if not globals_:
            return
        now = self.now_fn()
        cfg = self.cfg
        rt = self._rtier
        asm = _WaveAssembler(InjectBatch.zeros, cfg.batch_size)
        hi_a, lo_a, slot_a = key_hash128_batch([g.key for g in globals_], rt.num_rgroups)
        for i, g in enumerate(globals_):
            slot = int(slot_a[i])
            ib, w, lane = asm.place(slot)
            leaky = int(g.algorithm) == 1
            ib.key_hi[lane] = int(hi_a[i])
            ib.key_lo[lane] = int(lo_a[i])
            ib.group[lane] = slot
            ib.algo[lane] = int(g.algorithm)
            ib.status[lane] = int(g.status.status)
            ib.limit[lane] = g.status.limit
            ib.duration[lane] = g.duration
            ib.remaining[lane] = (
                g.status.remaining << FIXED_SHIFT if leaky else g.status.remaining
            )
            ib.stamp[lane] = now
            ib.expire_at[lane] = g.status.reset_time
            ib.burst[lane] = g.status.limit if leaky else 0
            ib.active[lane] = True
            asm.commit(w, slot)
        with self._lock, self.topo.dispatch_guard(), self._on_stream():
            for ib in asm.waves:
                rt.inject(ib.to_device(self.device), now)

    def close(self, timeout_s: float = 60.0) -> None:
        """Stop the sync thread, then the core (its drain, pump and
        completion thread)."""
        self._stop_sync.set()
        super().close(timeout_s)
        self._sync_thread.join(timeout=5)

    def _sync_loop(self) -> None:
        """One `sync_now` every `sync_wait_s` until close(). A failed
        tick is logged (the first, the tenth, then every hundredth in a
        row) and the loop goes on: without ticks the replicas stop
        converging."""
        while not self._stop_sync.wait(self.cfg.sync_wait_s):
            wd = self.watchdog
            if wd is not None:
                wd.beat("ici-sync", period_s=self.cfg.sync_wait_s)
            try:
                self.sync_now()
                self._sync_errors = 0
            except Exception:
                self._sync_errors += 1
                if self._sync_errors in (1, 10) or self._sync_errors % 100 == 0:
                    log.exception("GLOBAL sync tick failed (%d in a row)", self._sync_errors)
