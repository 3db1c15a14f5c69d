"""Device engine: micro-batch assembly over the device-resident table.

The port of `gubernator_tpu/runtime/engine.py` (`MeshEngine`, and
`DeviceEngine`, the engine at mesh shape (1,)): the object path, fed by
a pump, and the columnar path (`check_columns`), fed by the serving
edge (service/fastpath.py). Requests accumulate into waves; one decide
call per wave updates the table in place on the device (the CUDA kernel
on a CUDA table of the fused or narrow layout; torch ops for the wide
and packed layouts). The topology (runtime/topology.py) binds the kernels:
one table's, or the owner-sharded mesh's (runtime/ici_engine.py
IciEngine).

Micro-batching (reference peer_client.go:284-337; config.go:126-128):
flush at `batch_limit` items or after `batch_wait_s`, whichever comes
first; NO_BATCHING requests flush at once.

Duplicates (SURVEY.md §7 hard part (a)): the reference serializes a
key's requests through one worker, so in-batch duplicates see each
other's effects in order and an over-limit rejection does not consume.
The assembler places requests into *waves*: a request whose slot group
is taken in a wave goes to the next one, and waves run as sequential
decide calls. Group granularity also makes every wave's row stores
disjoint. A flush holds at most `max_waves` waves; the rest carries to
the next flush in arrival order. The columnar path assigns the same
waves with array operations (`_assemble_column_waves`).

The launch path of a flush (`_execute_waves`): every wave's batch
reaches the device in ONE host-to-device copy, every wave's outputs are
spans of ONE allocation, the table is checked once per engine
(`cuda_decide.TableMemo`), and the decisions come back in one copy to
pinned host memory behind ONE CUDA event (`cuda_decide.WaveFlush`).

Two-stage pipeline (`pipeline_depth`, JAX `engine.py` `_dispatch` /
`_complete`): the pump's `_dispatch` assembles, encodes and launches a
flush and hands its ticket to a completion thread, which waits on the
ticket's event, resolves its futures and sweeps finished bulks, in
dispatch order; the pump meanwhile assembles the next flush. At most
`pipeline_depth` tickets are in flight (a semaphore taken before each
dispatch). Depth 1 is the serial pump (dispatch, then complete inline).
Decisions are the same at every depth: waves run in dispatch order on
one stream.

Streams: on a card every table read and write of an engine runs on ONE
CUDA stream the engine owns (`_on_stream`): the pump, `check_columns`
callers, the pager, snapshots and restores all enter it under the
table lock, so launches from different threads stay ordered, and the
caching allocator only reuses an engine's blocks on that stream.

Paged table (`page_groups > 0`, docs/architecture.md "Paged table"):
the device holds `page_budget` frames of `page_groups` groups behind a
page map (ops/paged.py), and the host tier holds demoted pages
(runtime/pager.py). Before each wave's decide the pager makes every
page the wave touches resident, demoting the least recently touched
pages when no frame is free. A background demoter (`_demote_loop`, every
`page_demote_interval_s`) keeps `page_free_target` frames free (per
shard on a mesh) so that promotes rarely pay a demote: census-cold pages
first, and not at all while the census sees no cold slot on a table
with live rows. A demote's copy to the host waits for every wave queued
on the stream, tickets in flight included: it stays correct and
serializes the pipeline.

GLOBAL replica tier (IciEngine; runtime/topology.py `ReplicaTier`,
parallel/ici.py): a GLOBAL item's key re-hashes into the replica
keyspace, its home is the next value of a round-robin cursor shared by
both paths, and its waves assemble per (home, slot) pair. A flush runs
its table waves first, then its replica waves (one launch of the
sharded kernel each over the stacked replicas, then the pending
bookkeeping), under the same lock, on the same stream; the flush's
counts sum over both tiers.

Observatories (JAX `table_census`, `admission_snapshot`): one census or
admission scan (ops/census.py, ops/admission.py) per TTL, enqueued on
the engine's stream under the table lock and read back after the lock
is released, behind one event. A paged table's physical frames are
scanned on the device and its host tier with the numpy oracles; a
replica tier's replica 0 is the "replica" tier of both snapshots.

Store path (`store`, store/store.py; JAX `engine.py` `_execute_waves`,
reference algorithms.go:45-51, 149-153): with a Store attached, each
wave of the table runs the reference's per-request sequence at wave
granularity, under the table lock, on the engine's stream:
`ensure_resident` (paged) -> `probe_exists` of the wave's keys, read
back -> the freshest state of each miss (a row this flush already
served, the prefetch of never-seen keys made outside the lock, else
`Store.get`) -> `inject` -> decide (the hand kernel on a card) ->
`gather_rows(table, out.slot)` with the wave's evicted keys and freed
flags, read back. So the store path reads back twice per wave where
the store-less path reads back once per flush; the flush's decisions
still come back in one copy behind its last wave. Write-behind (the
last operation per key wins, in request order; a token-bucket RESET
free is a `store.remove`) runs before the flush's futures resolve. A
Store pins the pipeline at depth 1, as the JAX engine does. The waves
keep the widths of the store-less path: the JAX engine pins them at
`batch_size` so that its store-path programs stay compiled at one
shape, which changes no answer and which the port has no need of. The
replica tier's lanes never persist.

Telemetry (JAX `EngineMetrics`, metrics.py): every flush feeds the
engine's counters and histograms on the host, after its read-back: the
flush's duration and device sync, its waves and width, the stages of a
request's life (intake, assemble, dispatch, inflight_wait, device_sync,
resolve), the pipeline's in-flight depth and host/device overlap, the
flight recorder, and the hot-key sketch. `stats()` reads the decide's
counts and the waves from the EngineMetrics. With `stage_metadata` every answer
of the object path carries `stage_breakdown_us`. The pump, the
completion thread and the demoter beat a `Watchdog` once it is set on
`watchdog`. Nothing of this reaches the device.

Intake admission (JAX `engine.overload`, service/overload.py): with an
`IntakeGovernor` set on `overload`, `check_async` and each member of
`check_bulk` pass its `admit` before they are enqueued (a shed or an
expired deadline answers at once, with no device work), and the pump
feeds it each entry's queue wait and refuses members whose deadline
passed while they waited. Left None, the engine admits everything.

Thread model: callers on any thread enqueue; one pump thread assembles
and launches; the completion thread (depth >= 2) reads the decisions
back and resolves futures. The table lock guards the table and the
pager (`snapshot`, `restore` and `check_columns` take it too).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gubernator_tpu_torch import wire
from gubernator_tpu_torch.api.keys import group_of, key_hash128_batch, key_hash128_batch_raw
from gubernator_tpu_torch.api.types import (
    Behavior,
    ERR_ENGINE_DRAINING,
    RateLimitReq,
    RateLimitResp,
    validate_request,
)
from gubernator_tpu_torch.ops import cuda_decide
from gubernator_tpu_torch.models.bucket import MAX_COUNT, MAX_DURATION_MS
from gubernator_tpu_torch.ops.encode import EncodeError, encode_one, encode_rows
from gubernator_tpu_torch.ops.inject import INJECT_DTYPES, InjectBatch
from gubernator_tpu_torch.ops.admission import admission_oracle
from gubernator_tpu_torch.ops.census import census_oracle
from gubernator_tpu_torch.metrics import engine_histograms
from gubernator_tpu_torch.ops.kernels import (
    BYTES_PER_SLOT,
    KERNEL_LAYOUTS,
    LAYOUTS,
    get_admission,
    get_census,
)
from gubernator_tpu_torch.ops.layout import (
    BATCH_DTYPES,
    SLOT_DTYPES,
    RequestBatch,
    SlotTable,
    batch_to_device,
)
from gubernator_tpu_torch.runtime.pager import wide_zeros
from gubernator_tpu_torch.runtime.telemetry import FlightRecorder
from gubernator_tpu_torch.runtime.topology import SingleChipTopology
from gubernator_tpu_torch.store.store import SNAPSHOT_COLUMNS, ItemSnapshot
from gubernator_tpu_torch.utils import clock as _clock
from gubernator_tpu_torch.utils import devicemem


class TableCommittedError(RuntimeError):
    """A device failure occurred AFTER waves of this flush already
    committed hits to the table. Callers must NOT retry the batch
    through another path (that would apply the committed hits twice)."""


@dataclasses.dataclass
class EngineConfig:
    """Sizing and batching knobs (defaults mirror the JAX engine's)."""

    num_groups: int = 1 << 15  # 32k groups x 8 ways = 256k slots
    ways: int = 8
    batch_size: int = 1024  # max lanes per wave
    batch_limit: int = 1000  # max requests accumulated per flush
    batch_wait_s: float = 500e-6  # 500 µs
    max_flush_items: int = 8192  # hard cap pulled off the queue per flush
    # Bound per-flush latency: a flush full of same-key duplicates would
    # otherwise serialize into thousands of waves; overflow items carry
    # over to the next flush in arrival order.
    max_waves: int = 32
    # Where the table lives. "cuda" (the default) requires a GPU and
    # raises without one; pass "cpu" to run the plain version on the CPU.
    device: str = "cuda"
    # "wide", "packed", "fused" or "narrow" (ops/kernels.py LAYOUTS)
    layout: str = "fused"
    # ---- observatories (docs/monitoring.md "Table census", "Admission") ----
    # TTL of the cached census snapshot: at most one census scan per TTL.
    census_ttl_s: float = 5.0
    # A used slot is "cold at k" when its idle time exceeds k x its duration.
    census_thresholds: tuple = (1, 4, 16)
    # Regions of the census heatmaps (contiguous runs of groups).
    census_heatmap_width: int = 64
    # TTL of the cached admission snapshot.
    admission_ttl_s: float = 5.0
    # ---- paged table (GUBER_TABLE_PAGE_*) ----
    # Groups per page: 0 keeps the flat table; > 0 carves the device
    # table into pages behind a page map, with a host cold tier for
    # demoted pages. num_groups stays the logical keyspace.
    page_groups: int = 0
    # Resident frames on the device; required > 0 when page_groups > 0.
    # Device table bytes = page_budget x page_groups x ways x bytes/slot.
    page_budget: int = 0
    # Seconds between background demoter passes; 0: no demoter thread
    # (pages then demote only when a wave needs a frame).
    page_demote_interval_s: float = 2.0
    # Free frames the demoter keeps (per shard on a mesh), so promotes on
    # the serving path rarely pay a demote under the lock.
    page_free_target: int = 1
    # Flushes in flight (GUBER_PIPELINE_DEPTH): 1 is the serial pump
    # (dispatch, read back, resolve, repeat); >= 2 adds a completion
    # thread that reads tickets back in dispatch order while the pump
    # assembles the next flush. Decisions are the same at every depth.
    pipeline_depth: int = 2
    # Top-K hot-key attribution (GUBER_HOTKEYS_K): entries of the
    # space-saving sketch updated at each flush boundary
    # (`hotkeys_snapshot()`, gubernator_hotkey_hits); 0 disables it.
    hotkeys_k: int = 128
    # Per-request stage breakdown in response metadata
    # (GUBER_STAGE_METADATA): each answer of the object path carries
    # `stage_breakdown_us` with its flush's stage times. Off: no
    # per-item bookkeeping.
    stage_metadata: bool = False


_STAGES = ("intake", "assemble", "dispatch", "inflight_wait", "device_sync", "resolve")


class EngineMetrics:
    """Counters and device-tier distributions the observability layer
    exports (JAX `runtime/engine.py` `EngineMetrics`): the scalar
    counters map to the reference's Prometheus catalog
    (docs/prometheus.md); the histogram families (metrics.py
    `engine_histograms`), the flight recorder and the hot-key sketch are
    the device tier's. Wired into a Metrics registry by
    `metrics.wire_engine_telemetry()`. `cold_compiles` stays 0: the port
    compiles nothing while it serves."""

    def __init__(self):
        self.lock = threading.Lock()
        self.cache_hits = 0
        self.cache_misses = 0
        self.unexpired_evictions = 0
        self.over_limit = 0
        self.batches = 0
        self.waves = 0
        self.requests = 0
        self.served = 0
        self.cold_compiles = 0
        hists = engine_histograms()
        for attr, h in hists.items():
            setattr(self, attr, h)
        self._histograms = tuple(hists.values())
        # pre-resolved stage children (labels() is per-flush cost)
        self._stage = {s: self.stage_duration.labels(s) for s in _STAGES}
        self.recorder = FlightRecorder()

    def histograms(self) -> tuple:
        return self._histograms

    def observe_stage(self, stage: str, dur: float) -> None:
        self._stage[stage].observe(dur)

    def observe(self, hits, misses, evic, over, waves, n, served=None):
        """One flush's counts (of both tiers): `n` items taken (encode
        errors included, as the JAX engine counts them), `served` of
        them answered by a wave (all `n` when not given)."""
        with self.lock:
            self.cache_hits += hits
            self.cache_misses += misses
            self.unexpired_evictions += evic
            self.over_limit += over
            self.batches += 1
            self.waves += waves
            self.requests += n
            self.served += n if served is None else served

    def observe_flush(self, path: str, n: int, waves: int, dur: float,
                      dev: float, collective: bool = False) -> None:
        """One flush's distribution samples (per FLUSH, not per
        request). `collective` (mesh topologies) also lands the device
        time in the collective-tick histogram."""
        self.flush_duration.labels(path).observe(dur)
        self.device_sync.labels(path).observe(dev)
        self.batch_width.labels(path).observe(n)
        self.flush_waves.observe(waves)
        if collective:
            self.collective_tick.observe(dev)


class _WaveAssembler:
    """First-fit placement of requests into scatter-disjoint waves: a
    request goes to the first wave where its slot-group is unused and a
    lane is free. Same key => same group => strictly increasing wave
    index, which preserves per-key request order."""

    def __init__(self, make_batch, batch_size: int):
        self._make = make_batch
        self._B = batch_size
        self.waves: List[object] = []
        self._groups: List[set] = []
        self._fill: List[int] = []

    def place(self, grp: int, max_waves: Optional[int] = None):
        """Returns (wave_batch, wave_index, lane), or None if placement
        would exceed max_waves (caller carries the item to the next
        flush)."""
        w = 0
        while True:
            if w == len(self.waves):
                if max_waves is not None and w >= max_waves:
                    return None
                self.waves.append(self._make(self._B))
                self._groups.append(set())
                self._fill.append(0)
            if grp not in self._groups[w] and self._fill[w] < self._B:
                return self.waves[w], w, self._fill[w]
            w += 1

    def commit(self, w: int, grp: int) -> None:
        self._groups[w].add(grp)
        self._fill[w] += 1

    def fill(self, w: int) -> int:
        """Occupied lanes in wave w (a prefix: lanes fill in order)."""
        return self._fill[w]


class _Slot:
    """Result slot of one bulk member (a full Future per item costs lock
    and notify overhead; the bulk's one Future resolves at the end).
    `t_enq` is the enqueue stamp, set only under `stage_metadata`;
    `deadline_ms` the caller's absolute deadline (epoch ms), set only
    with an intake governor, so that the pump drops the member at pickup
    once the caller has given up."""

    __slots__ = ("value", "_done", "t_enq", "deadline_ms")

    def __init__(self):
        self.value = None
        self._done = False
        self.t_enq = None
        self.deadline_ms = None

    def set_result(self, v) -> None:
        self.value = v
        self._done = True

    def done(self) -> bool:
        return self._done


class _Bulk:
    """A bulk queue entry: N (req, _Slot) pairs resolved by one Future,
    and its enqueue stamp (the queue-wait histogram's start)."""

    __slots__ = ("work", "slots", "future", "t_enq")

    def __init__(self, work, slots, future):
        self.work = work
        self.slots = slots
        self.future = future
        self.t_enq = time.perf_counter()

    def resolve(self) -> None:
        if not self.future.done():
            self.future.set_result([
                s.value if s.done() else RateLimitResp(error=ERR_ENGINE_DRAINING)
                for s in self.slots
            ])


class _FlushTicket:
    """One dispatched flush on its way from `_dispatch` to `_complete`
    (consumed once, in dispatch order): the intake, where each item's
    answer lies, and the flush's outputs, whose copy to the host is
    queued behind one event."""

    __slots__ = (
        "items",       # [(req, future-like)]: the flush's intake
        "placements",  # per item: (tier, wave, lane), tier "s" (the table) or
                       # "r" (the replica tier); None if resolved or carried
        "flush",       # cuda_decide.WaveFlush of the table's waves, or None
        "rflush",      # the replica tier's WaveFlush, or None
        "waves",       # wave count (both tiers)
        "launches",    # kernel launches made by the waves
        "store",       # with a Store: (_StoreFlush, write-behind entries
                       # (hash_key, wave, lane, hi, lo) in request order)
        "keys",        # (hi, lo) lists of the items' keys, for the hot-key sketch
        "carry_n",     # items the wave cap carried to the next flush
        "widths",      # each wave's lanes (both tiers)
        "seq",         # the flush's number, the flight recorder's join key
        "t0",          # perf_counter stamps: dispatch start,
        "t_dev",       # the waves' launch start,
        "t_disp_end",  # dispatch end
        "host_mark",   # the pump's dispatch seconds so far, at dispatch end
    )

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw.get(k))


# The gathered row fields the store path reads back per wave, then the
# wave's evicted keys and freed flags: the rows of its host block.
_WB_FIELDS = ("used", "key_hi", "key_lo", "algo", "status", "limit", "duration",
              "remaining", "stamp", "expire_at", "invalid_at", "burst")
_R = {f: i for i, f in enumerate(_WB_FIELDS + ("evicted_hi", "evicted_lo", "freed"))}
_N_ROWS = len(_R)


class _StoreFlush:
    """The store path's state for one flush (`_execute_waves` with a
    Store): per wave {lane: (request, or the item's index when
    `resolver` builds requests lazily, key_hi, key_lo)}, the prefetched
    snapshots of never-seen keys, where each key was last served in
    this flush, each wave's host block ((_N_ROWS, wave width) int64: the
    rows its decide wrote, its evicted keys, its freed flags) with its
    offset among the flush's lanes, and the flush's ('d' displaced | 'i'
    inserted, key) events, in the JAX engine's order."""

    __slots__ = ("lane_reqs", "prefetched", "resolver", "served", "rows", "offsets",
                 "events", "readbacks", "injected")

    def __init__(self, lane_reqs, prefetched, resolver=None):
        self.lane_reqs = lane_reqs
        self.prefetched = prefetched
        self.resolver = resolver
        self.served: Dict[Tuple[int, int], Tuple[int, int]] = {}
        self.rows: List[np.ndarray] = []
        self.offsets: List[int] = []
        self.events: List[Tuple[str, Tuple[int, int]]] = []
        self.readbacks = 0
        self.injected = 0


_FLUSH = object()
_STOP = object()
# On close: how long the pump keeps serving entries that raced the
# shutdown before failing them with ERR_ENGINE_DRAINING (the JAX
# engine's default).
DRAIN_TIMEOUT_S = 5.0


class MeshEngine:
    """Owns the slot table; turns request streams into decisions. One
    engine core, parameterised by mesh shape (runtime/topology.py): the
    topology binds the kernels (one table's at shape (1,), the
    owner-sharded wave at (D,)), decides whether a Pager manages page
    residency behind them, and names the device. Counts its flushes,
    waves and kernel launches (`stats()`): on a CUDA table every wave is
    one kernel launch, whatever the number of shards."""

    # Whether GLOBAL requests belong to a tier inside the engine (the
    # replica tier of IciEngine) rather than to the table every request
    # reaches.
    routes_global_internally = False

    def __init__(
        self,
        config: Optional[EngineConfig] = None,
        now_fn: Callable[[], int] = _clock.now_ms,
        topology=None,
    ):
        cfg = config if config is not None else EngineConfig()
        if cfg.max_waves < 1:
            raise ValueError("max_waves must be >= 1")
        if cfg.batch_size < 1 or cfg.num_groups < 1 or cfg.ways < 1:
            raise ValueError("batch_size, num_groups and ways must be >= 1")
        if cfg.layout not in LAYOUTS:
            raise ValueError(f"layout {cfg.layout!r}: this package serves {LAYOUTS}")
        self.topo = topology if topology is not None else SingleChipTopology(cfg.device)
        self.device = self.topo.device
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "the engine's device is cuda but no CUDA device is "
                    "available; pass device='cpu' to run on the CPU"
                )
        elif self.device.type != "cpu":
            raise ValueError(f"device must be cuda or cpu, not {self.device}")
        if cfg.pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        self.cfg = cfg
        self.now_fn = now_fn
        # optional Store plugin (store/store.py attach_store)
        self.store = None
        # The engine's one stream on a card (see the module docstring).
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        with self._on_stream():
            self.K, self._pager = self.topo.build_kernels(cfg)
            self.K.load(self.device)
            self.table = self.K.create(cfg.num_groups, cfg.ways, self.device)
            # the GLOBAL replica tier (runtime/topology.py ReplicaTier): a
            # mesh topology's, None on one table
            self._rtier = self.topo.build_replica(cfg)
        self._memo = cuda_decide.TableMemo()
        # Round-robin home cursor of GLOBAL lanes (the replica answering a
        # lane: the node the request arrived at), shared by the object
        # path and check_columns.
        self._home_rr = 0
        self._rr_lock = threading.Lock()
        # The observatories' scans (one per TTL) and their caches.
        self._census_thresholds = tuple(int(k) for k in cfg.census_thresholds)
        self._census = get_census(
            cfg.layout, cfg.ways, heatmap_width=int(cfg.census_heatmap_width),
            thresholds=self._census_thresholds,
        )
        self._admission = get_admission(cfg.layout, cfg.ways)
        self._census_lock = threading.Lock()
        self._census_cache: Optional[dict] = None
        self._census_ts = 0.0
        self._census_prev = None  # (t_mono, misses, evictions, live)
        self._admission_lock = threading.Lock()
        self._admission_cache: Optional[dict] = None
        self._admission_ts = 0.0

        self._lock = threading.Lock()  # the table
        self._keys_lock = threading.Lock()  # the host key dictionary
        self._key_strings: Dict[Tuple[int, int], str] = {}
        # Telemetry (metrics.py): the engine's counters, histograms,
        # flight recorder and hot-key sketch, fed on the host per flush.
        self.metrics = EngineMetrics()
        self._stage_md = bool(cfg.stage_metadata)
        self.metrics.hotkeys.configure(int(cfg.hotkeys_k or 0))
        self.metrics.hotkeys.set_resolver(self.key_string)
        # Which decide serves (gubernator_kernel_backend) and the team
        # kernel's lanes per block (gubernator_pallas_block_lanes): the
        # hand kernel on a card for fused and narrow; torch ops for wide
        # and packed on either device, as the JAX engine reads "xla" for
        # them under GUBER_KERNEL=pallas.
        on_card = self.device.type == "cuda" and cfg.layout in KERNEL_LAYOUTS
        self.kernel_backend = "cuda" if on_card else "torch"
        self.pallas_block = cuda_decide.lanes_per_block(cfg.ways) if on_card else 0
        # Liveness (runtime/watchdog.py): set a Watchdog here and the
        # pump, the completion thread and the demoter beat it.
        self.watchdog = None
        # Intake admission (service/overload.py IntakeGovernor, duck-typed
        # like the watchdog): set one here and check_async / check_bulk
        # consult it before enqueueing, and the pump feeds it each entry's
        # queue wait and refuses expired deadlines at pickup. None admits
        # everything: the engine without the governor, answer for answer.
        self.overload = None
        self._ticket_seq = 0  # pump thread only
        # the pump's seconds in _dispatch so far (pump thread writes; the
        # completion stage reads it for the overlap ratio)
        self._host_busy = 0.0
        # Per-shard decided lanes (mesh topologies), host numpy.
        self._shard_lock = threading.Lock()
        self._shard_decisions = (
            np.zeros(self.topo.n_dev, dtype=np.int64) if self.topo.n_dev > 1 else None
        )
        self._mem_subsystems = self._memory_subsystems()
        self._snapshot_staging_bytes = 0
        self._stats_lock = threading.Lock()
        # stats()'s own counters; the decide's counts and the waves are
        # the EngineMetrics'.
        self._stats = dict(
            flushes=0, columnar_flushes=0, replica_waves=0, kernel_launches=0,
            inflight_max=0,
            store_readbacks=0, store_injected=0, inject_waves=0, injected_rows=0,
        )

        self._queue: "queue.SimpleQueue" = queue.SimpleQueue()
        self._running = True
        self._draining = False
        self._bulks: List[_Bulk] = []
        self._bulks_lock = threading.Lock()
        self._pipe_depth = int(cfg.pipeline_depth)
        self._pipe_q: Optional["queue.SimpleQueue"] = None
        self._pipe_thread: Optional[threading.Thread] = None
        self._inflight = 0
        if self._pipe_depth > 1:
            # The semaphore's permits are the in-flight ring's slots (the
            # pump takes one before it launches a flush); the queue
            # carries tickets to the completion thread in dispatch order.
            self._pipe_sem = threading.Semaphore(self._pipe_depth)
            self._pipe_q = queue.SimpleQueue()
            self._pipe_lock = threading.Lock()
            self._pipe_thread = threading.Thread(
                target=self._completion_loop, name=self.topo.thread_name + "-complete",
                daemon=True,
            )
            self._pipe_thread.start()
        self._thread = threading.Thread(
            target=self._pump, name=self.topo.thread_name, daemon=True
        )
        self._thread.start()
        # Background demoter (paged tables): keeps free frames by
        # evacuating census-cold pages to the host tier.
        self._demote_stop = threading.Event()
        self._demote_thread: Optional[threading.Thread] = None
        if self._pager is not None and float(cfg.page_demote_interval_s or 0) > 0:
            self._demote_thread = threading.Thread(
                target=self._demote_loop, name=self.topo.thread_name + "-demoter",
                daemon=True,
            )
            self._demote_thread.start()

    def _on_stream(self):
        """Enter the engine's stream (a card) or nothing (the CPU)."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    # -- public intake -------------------------------------------------------

    def check_async(self, req: RateLimitReq) -> "Future[RateLimitResp]":
        """Enqueue one request; resolves after its wave executes."""
        t_in = time.perf_counter()
        fut: Future = Future()
        if not self._running:
            fut.set_result(RateLimitResp(error=ERR_ENGINE_DRAINING))
            return fut
        err = validate_request(req)
        if err is not None:
            fut.set_result(RateLimitResp(error=err))
            return fut
        ov = self.overload
        if ov is not None:
            shed, dl = ov.admit(req, self._queue.qsize())
            if shed is not None:
                fut.set_result(shed)
                return fut
            if dl is not None:
                fut.deadline_ms = dl
        if req.created_at is None:
            req.created_at = self.now_fn()
        t_enq = time.perf_counter()
        self.metrics.observe_stage("intake", t_enq - t_in)
        if self._stage_md:
            fut.t_enq = t_enq
        self._queue.put((req, fut, t_enq))
        return fut

    def check_bulk(self, reqs: Sequence[RateLimitReq]) -> "Future[List[RateLimitResp]]":
        """Bulk check: ONE queue entry and ONE Future for N requests.
        Resolves in request order."""
        t_in = time.perf_counter()
        out: Future = Future()
        if not self._running:
            out.set_result([RateLimitResp(error=ERR_ENGINE_DRAINING) for _ in reqs])
            return out
        slots: List[_Slot] = []
        work = []
        now = None
        ov = self.overload
        # one depth read per bulk: its members join the queue as one entry
        depth = self._queue.qsize() if ov is not None else 0
        for req in reqs:
            slot = _Slot()
            slots.append(slot)
            err = validate_request(req)
            if err is not None:
                slot.set_result(RateLimitResp(error=err))
                continue
            if ov is not None:
                shed, dl = ov.admit(req, depth)
                if shed is not None:
                    slot.set_result(shed)
                    continue
                if dl is not None:
                    slot.deadline_ms = dl
            if req.created_at is None:
                if now is None:
                    now = self.now_fn()
                req.created_at = now
            work.append((req, slot))
        if work:
            b = _Bulk(work, slots, out)
            self.metrics.observe_stage("intake", b.t_enq - t_in)
            if self._stage_md:
                for s in slots:
                    s.t_enq = b.t_enq
            self._queue.put(b)
        else:
            out.set_result([s.value for s in slots])
        return out

    def check_batch(self, reqs: Sequence[RateLimitReq]) -> List[RateLimitResp]:
        """Synchronous batched check (returns in request order)."""
        return self.check_bulk(reqs).result()

    def close(self, timeout_s: float = 60.0) -> None:
        """Serve everything queued before this call, then stop the pump
        and the completion thread. The pump completes every flush in
        flight first, then serves entries that raced the shutdown for up
        to DRAIN_TIMEOUT_S; what is left fails with the typed retryable
        status (ERR_ENGINE_DRAINING). The page demoter stops first: it
        takes the table lock and enqueues device work."""
        self._demote_stop.set()
        dem = self._demote_thread
        if dem is not None and dem.is_alive():
            dem.join(timeout=timeout_s)
        self._queue.put(_STOP)
        self._thread.join(timeout=timeout_s)
        self._running = False
        comp = self._pipe_thread
        if comp is not None and comp.is_alive():
            # the pump sends _STOP after its drain; this one is a backstop
            # for a wedged pump (the loop exits on the first it sees)
            self._pipe_q.put(_STOP)
            comp.join(timeout=timeout_s)
        while True:
            try:
                entry = self._queue.get_nowait()
            except queue.Empty:
                break
            if type(entry) is _Bulk:
                entry.resolve()
            elif type(entry) is tuple:
                entry[1].set_result(RateLimitResp(error=ERR_ENGINE_DRAINING))
        with self._bulks_lock:
            rest, self._bulks[:] = list(self._bulks), []
        for b in rest:
            b.resolve()

    def stats(self) -> dict:
        """Counters: flushes (object path), columnar_flushes
        (`check_columns`), waves (of both tiers), replica_waves (the
        GLOBAL replica tier's), kernel_launches, requests, the decide
        metrics (cache hits/misses, unexpired evictions, over-limit
        answers), inflight_max (the most flushes in flight at once: from
        the end of a flush's dispatch to the end of its completion),
        pipeline_depth, the store path's device-to-host reads
        (store_readbacks, two per wave) and rows read through into the
        table (store_injected), and the waves and rows of
        `inject_snapshots` (inject_waves, injected_rows); with a paged table also the pager's promotes,
        demotes, binds, resident_pages and host_pages."""
        with self._stats_lock:
            out = dict(self._stats)
        em = self.metrics
        with em.lock:
            out.update(
                waves=em.waves, requests=em.served, cache_hits=em.cache_hits,
                cache_misses=em.cache_misses, unexpired_evictions=em.unexpired_evictions,
                over_limit=em.over_limit,
            )
        out["pipeline_depth"] = self._pipe_depth
        pager = self._pager
        if pager is not None:
            out.update(
                promotes=pager.promotes, demotes=pager.demotes, binds=pager.binds,
                resident_pages=pager.resident_count(), host_pages=pager.host_count(),
            )
        return out

    # -- introspection (JAX engine: debug_snapshot, hotkeys, device memory) ---

    def key_string(self, hi: int, lo: int) -> Optional[str]:
        """The key string of a (key_hi, key_lo) pair this engine served."""
        with self._keys_lock:
            return self._key_strings.get((hi, lo))

    def queue_depth(self) -> int:
        return self._queue.qsize()

    def live_count(self) -> int:
        """Occupied slots (gubernator_cache_size) of the cached census."""
        return self.table_census()["live"]

    def debug_snapshot(self) -> dict:
        """Telemetry and the flight recorder as one JSON-shaped dict (the
        JAX engine's /debug/engine payload): host state plus the cached
        census's occupancy."""
        em = self.metrics
        cfg = self.cfg
        with em.lock:
            counters = {
                "requests": em.requests,
                "batches": em.batches,
                "waves": em.waves,
                "cache_hits": em.cache_hits,
                "cache_misses": em.cache_misses,
                "unexpired_evictions": em.unexpired_evictions,
                "over_limit": em.over_limit,
                "cold_compiles": em.cold_compiles,
            }
        return {
            "engine": type(self).__name__,
            "layout": cfg.layout,
            "batch_size": cfg.batch_size,
            "max_waves": cfg.max_waves,
            "pipeline_depth": self._pipe_depth,
            "kernel_backend": self.kernel_backend,
            "pallas_block": self.pallas_block,
            "inflight": self._inflight,
            "queue_depth": self.queue_depth(),
            "counters": counters,
            "histograms": {h.name: h.summary() for h in em.histograms()},
            "flight_recorder": em.recorder.snapshot(),
            "occupancy": self.occupancy_stats(),
        }

    def hotkeys_snapshot(self) -> dict:
        """The hot-key sketch (`/debug/hotkeys`), on an engine without a
        replica tier joined with the table: each entry gains the key's
        residency, `resident`, `cold` (idle past the census's second
        cold threshold), `expired` (window elapsed, slot still held),
        `evicted`, or `demoted` (its page is in the host tier), from one
        gather of the entries' groups. A replica tier's GLOBAL keys hash
        into another keyspace, so such an engine serves the plain
        sketch, as JAX's does."""
        snap = self.metrics.hotkeys.snapshot()
        entries = snap["entries"]
        if self._rtier is not None or not entries:
            return snap
        cfg = self.cfg
        W = cfg.ways
        n = len(entries)
        hi = np.array([e["key_hash"][0] for e in entries], dtype=np.int64)
        lo = np.array([e["key_hash"][1] for e in entries], dtype=np.int64)
        grp = np.array([group_of(int(v), cfg.num_groups) for v in lo], dtype=np.int64)
        demoted = np.zeros(n, dtype=bool)
        with self._lock, self._on_stream():
            if self._pager is not None:
                pgrp = self._pager.phys_groups(grp)
                demoted = pgrp < 0
                # a demoted key's lanes read the out-of-range sentinel (zeros)
                grp_dev = np.where(demoted, self.table.num_slots // W, pgrp)
            else:
                grp_dev = grp
            slots = (grp_dev[:, None] * W + np.arange(W, dtype=np.int64)[None, :]).reshape(-1)
            rows = self.K.gather_rows(
                self.table, torch.as_tensor(slots, dtype=torch.int64, device=self.device))
            cols = {f: getattr(rows, f).cpu().numpy().reshape(n, W)
                    for f in ("key_hi", "key_lo", "used", "lru", "duration", "expire_at")}
        now = self.now_fn()
        th = self._census_thresholds
        cold_k = th[min(1, len(th) - 1)]
        for i, e in enumerate(entries):
            if demoted[i]:
                e["census"] = "demoted"
                continue
            match = cols["used"][i].astype(bool) & (cols["key_hi"][i] == hi[i]) & (
                cols["key_lo"][i] == lo[i])
            if not match.any():
                e["census"] = "evicted"
                continue
            w = int(np.argmax(match))
            if cols["expire_at"][i, w] <= now:
                e["census"] = "expired"
            elif now - cols["lru"][i, w] > cold_k * cols["duration"][i, w]:
                e["census"] = "cold"
            else:
                e["census"] = "resident"
        snap["cold_multiplier"] = int(cold_k)
        return snap

    def device_memory(self) -> dict:
        """Per-subsystem device-memory attribution and headroom
        (utils/devicemem.py): the geometry sized at init, the last
        snapshot's or restore's staging bytes, and on a card the caching
        allocator's bytes in use and the card's total. No device work."""
        subs = dict(self._mem_subsystems)
        subs["snapshot_staging"] = int(self._snapshot_staging_bytes)
        subs.setdefault("ici_replicas", 0)
        return devicemem.snapshot(subs, device=self.device)

    def _memory_subsystems(self) -> dict:
        """Static device-memory attribution from the engine's geometry
        (JAX `_memory_subsystems`), in bytes: estimates of what each
        subsystem keeps resident."""
        cfg = self.cfg
        bps = BYTES_PER_SLOT[cfg.layout]
        if self._pager is not None:
            # the frames and the int32 page map; demoted pages are host memory
            table_b = self.K.num_phys_pages * self.K.page_slots * bps
        else:
            table_b = cfg.num_groups * cfg.ways * bps
        n_th = len(self._census_thresholds)
        hw = int(cfg.census_heatmap_width)
        census_b = 8 * (2 * 32 + (cfg.ways + 1) + hw + n_th + 16)
        ring_b = max(int(cfg.pipeline_depth), 1) * cfg.max_waves * cfg.batch_size * 8 * 8
        admission_b = 8 * (32 + 8)
        subs = {
            "slot_table": table_b,
            "census": census_b,
            "admission": admission_b,
            "pipeline_ring": ring_b,
        }
        if self._pager is not None:
            subs["page_map"] = 4 * self.K.num_logical_pages
        rt = self._rtier
        if rt is not None:
            subs["ici_replicas"] = self.topo.n_dev * rt.num_slots * (bps + 8) + 8 * self.topo.n_dev
            subs["census"] += 8 * ((rt.replica_ways + 1) + hw + n_th + 16)
            subs["admission"] += admission_b
        return subs

    def _note_shard_decisions(self, hb: RequestBatch) -> None:
        """Fold a flush's table lanes onto the shards that own their
        groups (contiguous, as the sharded kernel splits them): host
        numpy over the host batch."""
        n_dev = self.topo.n_dev
        groups = (self.K.num_phys_pages * self.K.groups_per_page
                  if self._pager is not None else self.cfg.num_groups)
        per = max(groups // n_dev, 1)
        grp = hb.group[hb.active].astype(np.int64)
        counts = np.bincount(np.minimum(grp // per, n_dev - 1), minlength=n_dev)
        with self._shard_lock:
            self._shard_decisions += counts

    def shard_stats(self) -> Optional[dict]:
        """Per-shard skew of a mesh (JAX `shard_stats`): decisions (the
        lanes each shard owned), occupancy (the cached census's heatmap
        folded onto shard boundaries), page frames, and the max/mean
        imbalance of each; None on one table. Reads host counters and
        the ALREADY-CACHED census only."""
        n_dev = self.topo.n_dev
        if self._shard_decisions is None:
            return None
        with self._shard_lock:
            decisions = self._shard_decisions.tolist()

        def imbalance(vals) -> Optional[float]:
            total = sum(vals)
            if total <= 0:
                return None
            return round(max(vals) / (total / float(len(vals))), 4)

        out: dict = {
            "n_shards": n_dev,
            "decisions": decisions,
            "decision_imbalance": imbalance(decisions),
        }
        census = self.cached_census()
        if census is not None:
            tier = census.get("tiers", {}).get(self.topo.primary_tier, census)
            heat = tier.get("heatmap") or []
            gpr = int(tier.get("heatmap_groups_per_region", 1) or 1)
            groups = int(tier.get("groups", 0) or 0)
            if heat and groups:
                per = max(groups // n_dev, 1)
                occ = [0] * n_dev
                for r, live in enumerate(heat):
                    occ[min((r * gpr) // per, n_dev - 1)] += int(live)
                out["occupancy"] = occ
                out["occupancy_imbalance"] = imbalance(occ)
            pages = census.get("pages")
            if pages and pages.get("shards"):
                out["pages"] = pages["shards"]
                out["resident_imbalance"] = imbalance(
                    [int(s.get("resident", 0)) for s in pages["shards"]])
        dims = [v for v in (out.get("decision_imbalance"), out.get("occupancy_imbalance"),
                            out.get("resident_imbalance")) if v is not None]
        out["imbalance_ratio"] = max(dims) if dims else None
        return out

    # -- table census (docs/monitoring.md "Table census") --------------------

    def table_census(self, max_age_s: Optional[float] = None) -> dict:
        """The TTL-cached table census: at most one scan per
        `census_ttl_s` (`max_age_s` overrides it; 0 forces a fresh scan).
        The scan is enqueued under the table lock and read back after it
        is released (`_census_scan`)."""
        ttl = float(self.cfg.census_ttl_s) if max_age_s is None else float(max_age_s)
        with self._census_lock:
            if self._census_cache is not None and time.monotonic() - self._census_ts < ttl:
                return self._census_cache
            snap = self._census_scan()
            snap["churn"] = self._census_churn(snap)
            self._census_cache = snap
            self._census_ts = time.monotonic()
            return snap

    def cached_census(self) -> Optional[dict]:
        """The census snapshot only if one is cached: never scans."""
        with self._census_lock:
            return self._census_cache

    def cached_admission(self) -> Optional[dict]:
        """The admission snapshot only if one is cached: never scans (the
        SLO sampler reads it on its own clock and must do no device
        work)."""
        with self._admission_lock:
            return self._admission_cache

    def occupancy_stats(self) -> dict:
        """live, slots, occupancy and full_group_ratio of the cached
        census."""
        c = self.table_census()
        return {
            "live": c["live"],
            "slots": c["slots"],
            "occupancy": c["occupancy"],
            "full_group_ratio": c["full_group_ratio"],
        }

    def _census_view(self, table):
        """What the scans read: a paged table's PHYSICAL frames (its host
        tier goes through the numpy oracles), else the table."""
        return table.data if self._pager is not None else table

    def _census_scan(self) -> dict:
        """One census (called with _census_lock held): the scan enqueued
        on the engine's stream under the table lock, its O(buckets)
        result read back after the lock is released."""
        cfg = self.cfg
        now = self.now_fn()
        host_pages = pages_snap = None
        rt = self._rtier
        with self._lock, self.topo.dispatch_guard(), self._on_stream():
            pending = _read_back(self._census(self._census_view(self.table), now))
            r_pending = _read_back(rt.census(rt.state.table, now)) if rt is not None else None
            if self._pager is not None:
                # host rows blocks are replaced, never changed in place
                host_pages = self._pager.host_tier_copy()
                pages_snap = self._pager.pages_snapshot()
        dev_groups = (
            self.K.num_phys_pages * self.K.groups_per_page
            if self._pager is not None else cfg.num_groups
        )
        primary = self.topo.primary_tier
        tiers = {primary: self._census_tier(pending(), now, dev_groups)}
        if r_pending is not None:
            # the GLOBAL replica tier: replica 0 (post-sync mirrors)
            tiers["replica"] = _census_tier_snapshot(
                r_pending(), now=now, layout=cfg.layout, groups=rt.num_rgroups,
                ways=rt.replica_ways, bytes_per_slot=BYTES_PER_SLOT[cfg.layout],
                thresholds=self._census_thresholds,
                heatmap_width=int(cfg.census_heatmap_width),
            )
        if self._pager is not None:
            tiers["host"] = self._census_host_tier(host_pages, now)
        snap = _census_combine(tiers, primary=primary)
        if pages_snap is not None:
            snap["pages"] = pages_snap
        return snap

    def _census_tier(self, out: dict, now: int, groups: int) -> dict:
        cfg = self.cfg
        return _census_tier_snapshot(
            out, now=now, layout=cfg.layout, groups=groups, ways=cfg.ways,
            bytes_per_slot=BYTES_PER_SLOT[cfg.layout], thresholds=self._census_thresholds,
            heatmap_width=int(cfg.census_heatmap_width),
        )

    def _host_tier_rows(self, host_pages: dict) -> SlotTable:
        """The host tier's pages in logical order as one wide host image
        (one empty page when there is none: zero counts)."""
        if not host_pages:
            return SlotTable(**wide_zeros(self.K.page_slots))
        lps = sorted(host_pages)
        return SlotTable(**{
            f: np.concatenate([host_pages[lp][f] for lp in lps]) for f in SlotTable._fields
        })

    def _census_host_tier(self, host_pages: dict, now: int) -> dict:
        """The host tier's census with the numpy oracle, in the device
        tier's form (0 slots when the tier is empty)."""
        cfg = self.cfg
        out = census_oracle(
            self._host_tier_rows(host_pages), now, ways=cfg.ways,
            heatmap_width=int(cfg.census_heatmap_width), thresholds=self._census_thresholds,
        )
        groups = len(host_pages or ()) * (self.K.page_slots // cfg.ways)
        return self._census_tier(out, now, groups)

    def _census_churn(self, snap: dict) -> dict:
        """Insertions, unexpired evictions and recycles (inserts that
        reclaimed a dead resident slot: the remainder of the insertions)
        since the last census, and their rates. _census_lock held."""
        em = self.metrics
        with em.lock:
            misses = em.cache_misses
            evics = em.unexpired_evictions
        t = time.monotonic()
        prev = self._census_prev
        self._census_prev = (t, misses, evics, snap["live"])
        if prev is None:
            return {
                "interval_s": 0.0, "insertions": 0, "evictions": 0, "overwrite_recycles": 0,
                "insert_per_s": 0.0, "evict_per_s": 0.0, "recycle_per_s": 0.0,
            }
        dt = max(t - prev[0], 1e-9)
        d_ins = max(misses - prev[1], 0)
        d_ev = max(evics - prev[2], 0)
        d_live = snap["live"] - prev[3]
        d_rec = max(d_ins - d_ev - max(d_live, 0), 0)
        return {
            "interval_s": round(dt, 6),
            "insertions": d_ins,
            "evictions": d_ev,
            "overwrite_recycles": d_rec,
            "insert_per_s": round(d_ins / dt, 3),
            "evict_per_s": round(d_ev / dt, 3),
            "recycle_per_s": round(d_rec / dt, 3),
        }

    # -- admission accounting (docs/monitoring.md "Admission") ---------------

    def admission_snapshot(self, max_age_s: Optional[float] = None) -> dict:
        """The TTL-cached admitted-vs-limit accounting: at most one scan
        per `admission_ttl_s` (`max_age_s` overrides it), dispatched as
        the census is."""
        ttl = float(self.cfg.admission_ttl_s) if max_age_s is None else float(max_age_s)
        with self._admission_lock:
            if (self._admission_cache is not None
                    and time.monotonic() - self._admission_ts < ttl):
                return self._admission_cache
            snap = self._admission_scan()
            self._admission_cache = snap
            self._admission_ts = time.monotonic()
            return snap

    def _admission_scan(self) -> dict:
        """One admission pass (_admission_lock held): the device tier's
        scan, and a paged table's host tier with the numpy oracle (a
        demoted key's window still counts)."""
        now = self.now_fn()
        host_pages = None
        rt = self._rtier
        with self._lock, self.topo.dispatch_guard(), self._on_stream():
            pending = _read_back(self._admission(self._census_view(self.table), now))
            r_pending = _read_back(rt.admission(rt.state.table, now)) if rt is not None else None
            if self._pager is not None:
                host_pages = self._pager.host_tier_copy()
        tiers = {self.topo.primary_tier: _admission_tier_dict(pending())}
        if r_pending is not None:
            tiers["replica"] = _admission_tier_dict(r_pending())
        if self._pager is not None:
            tiers["host"] = self._admission_host_tier(host_pages, now)
        snap = _admission_combine(tiers)
        snap["now_ms"] = now
        return snap

    def _admission_host_tier(self, host_pages: dict, now: int) -> dict:
        return _admission_tier_dict(admission_oracle(self._host_tier_rows(host_pages), now))

    # -- background page demoter ----------------------------------------------

    def _demote_loop(self) -> None:
        """Every `page_demote_interval_s` (at least 50 ms) one
        `_demote_once` pass until close(). A pass that fails is dropped:
        the serving path's demand demotes cover for the demoter."""
        interval = max(float(self.cfg.page_demote_interval_s), 0.05)
        while not self._demote_stop.wait(interval):
            wd = self.watchdog
            if wd is not None:
                # its period widens the stall deadline: a long cadence
                # is not a wedge
                wd.beat("page-demoter", period_s=interval)
            try:
                self._demote_once()
            except Exception:  # pragma: no cover - defensive, as the JAX engine's
                if self._demote_stop.is_set():
                    return

    def _demote_once(self) -> None:
        """One demoter pass: nothing while the pool holds
        `page_free_target` free frames (a check without the lock;
        `demote_victims` re-reads under it) or while the census sees no
        cold slot on a table with live rows (a fully hot resident set is
        not thrashed through the host tier); else the census's cold
        heatmap folded into per-page coldness and `demote_victims` under
        the table lock, on the engine's stream."""
        pager = self._pager
        want = int(self.cfg.page_free_target or 0)
        if want <= 0 or len(pager.free) >= want:
            return
        census = self.table_census()
        dev = census.get("tiers", {}).get(self.topo.primary_tier, census)
        cold = dev.get("cold") or []
        cold_slots = int(cold[0]["slots"]) if cold else 0
        if int(dev.get("live", 0)) > 0 and cold_slots == 0:
            return
        ch = dev.get("cold_heatmap")
        with self._lock, self.topo.dispatch_guard(), self._on_stream():
            # the fold reads page_map, which serving rebinds under the lock
            coldness = None
            if ch:
                coldness = pager.coldness_from_heatmap(
                    ch, int(dev.get("heatmap_groups_per_region", 1))
                )
            self.table = pager.demote_victims(
                self.table, want_free=want, min_idle_ticks=1, coldness=coldness
            )

    # -- pump ----------------------------------------------------------------

    def _pump(self) -> None:
        carry: List[Tuple[RateLimitReq, object]] = []
        qw = self.metrics.queue_wait
        while self._running:
            wd = self.watchdog
            if wd is not None:
                # a pump stuck behind the pipeline semaphore (a wedged
                # completion thread) stops beating here
                wd.beat("engine-pump", serving=True)
            if not carry:
                try:
                    item = self._queue.get(timeout=0.1)
                except queue.Empty:
                    continue
            else:
                # Wave-capped leftovers go first (per-key arrival order);
                # take whatever is queued without waiting.
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    item = _FLUSH
            if item is _STOP:
                self._running = False
                break
            batch = list(carry)
            carry = []
            flush = item is _FLUSH or self._extend(batch, item, qw)
            deadline = time.monotonic() + self.cfg.batch_wait_s
            while not flush and len(batch) < self.cfg.max_flush_items:
                remaining = deadline - time.monotonic()
                if len(batch) >= self.cfg.batch_limit or remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is _STOP:
                    self._running = False
                    break
                if nxt is _FLUSH or self._extend(batch, nxt, qw):
                    break
            if batch:
                carry = self._serve(batch)
        # Shutdown: complete every flush in flight FIRST (dispatch order),
        # then serve what is still queued within the drain budget, then
        # fail the stragglers with the typed retryable status.
        self._pipeline_quiesce()
        carry = self._drain_tail(carry)
        for _, fut in carry:
            if not fut.done():
                fut.set_result(RateLimitResp(error=ERR_ENGINE_DRAINING))
        self._resolve_all_bulks()
        if self._pipe_q is not None:
            self._pipe_q.put(_STOP)

    def _drain_tail(self, carry):
        """Serve queue entries that raced the shutdown (entries enqueued
        before close() were served by the main loop: the queue is FIFO)
        and the wave-capped carry, completing each flush inline, until
        DRAIN_TIMEOUT_S passes or nothing is left. Returns the pairs the
        budget could not serve."""
        deadline = time.monotonic() + DRAIN_TIMEOUT_S
        pending = list(carry)

        def pull(entry) -> None:
            if entry is not _STOP and entry is not _FLUSH:
                self._extend(pending, entry)

        while time.monotonic() <= deadline:
            while True:
                try:
                    pull(self._queue.get_nowait())
                except queue.Empty:
                    break
            if not pending:
                # idle: one short wait for a producer that raced the
                # intake check, then stop
                try:
                    pull(self._queue.get(timeout=0.02))
                except queue.Empty:
                    break
                continue
            batch = pending[: self.cfg.max_flush_items]
            pending = self._serve(batch) + pending[self.cfg.max_flush_items:]
        while True:
            try:
                pull(self._queue.get_nowait())
            except queue.Empty:
                break
        return pending

    def _extend(self, batch: list, entry, wait_hist=None) -> bool:
        """Add a queue entry (single request or bulk); True if it asks for
        an immediate flush (NO_BATCHING). The pump passes the queue-wait
        histogram: an entry's wait from enqueue to pickup lands there and,
        with an intake governor set, feeds its controller, and members
        whose caller deadline has passed are refused here, before any
        device work (the shutdown drain, which passes none, serves what
        it finds, as the JAX engine's does)."""
        nb = int(Behavior.NO_BATCHING)
        ov = self.overload if wait_hist is not None else None
        if type(entry) is _Bulk:
            if wait_hist is not None:
                w = time.perf_counter() - entry.t_enq
                wait_hist.observe(w)
                if ov is not None:
                    ov.observe_wait(w)
                    live = []
                    for req, slot in entry.work:
                        dl = slot.deadline_ms
                        if dl is not None and ov.deadline_expired(dl):
                            slot.set_result(ov.refuse_expired(req))
                        else:
                            live.append((req, slot))
                    entry.work = live
            batch.extend(entry.work)
            with self._bulks_lock:
                self._bulks.append(entry)
            if not entry.work:
                # every member expired at pickup: no flush will sweep the
                # bulk, so it resolves now
                self._sweep_bulks()
                return False
            return any(r.behavior & nb for r, _ in entry.work)
        req, fut, t_enq = entry
        if wait_hist is not None:
            w = time.perf_counter() - t_enq
            wait_hist.observe(w)
            if ov is not None:
                ov.observe_wait(w)
                dl = getattr(fut, "deadline_ms", None)
                if dl is not None and ov.deadline_expired(dl):
                    fut.set_result(ov.refuse_expired(req))
                    return False
        batch.append((req, fut))
        return bool(req.behavior & nb)

    def _serve(self, batch) -> list:
        """One flush; never lets an error kill the pump. Returns carry.
        Serial mode sweeps finished bulks here; pipelined mode leaves
        that to the completion thread (the answers are not in yet)."""
        try:
            carry = self._process(batch)
        except Exception as e:
            for _, fut in batch:
                if not fut.done():
                    fut.set_result(RateLimitResp(error=str(e)))
            self._sweep_bulks()
            return []
        if not self._pipeline_active():
            self._sweep_bulks()
        return carry

    def _sweep_bulks(self) -> None:
        """Resolve bulk futures whose members have all been answered
        (the pump after each flush when serial; the completion thread
        after each ticket when pipelined)."""
        done = []
        with self._bulks_lock:
            still = []
            for b in self._bulks:
                (done if all(s.done() for s in b.slots) else still).append(b)
            self._bulks[:] = still
        for b in done:
            b.resolve()

    def _resolve_all_bulks(self) -> None:
        """Shutdown tail: resolve every remaining bulk (members never
        served answer ERR_ENGINE_DRAINING, see _Bulk.resolve)."""
        with self._bulks_lock:
            rest, self._bulks[:] = list(self._bulks), []
        for b in rest:
            b.resolve()

    # -- the two-stage pipeline ------------------------------------------------

    def _pipeline_active(self) -> bool:
        """Tickets go to the completion thread while serving at depth
        >= 2 and store-less (a Store's read-through reads back inside the
        dispatch anyway, and its write-behind must not race the next
        flush's prefetch); the shutdown drain completes inline."""
        return self._pipe_q is not None and not self._draining and self.store is None

    def _process(self, items: List[Tuple[RateLimitReq, object]]) -> list:
        """One flush through both stages. Serial (depth 1, or draining):
        dispatch, then complete inline. Pipelined: take a ring slot
        (backpressure BEFORE launching more device work), dispatch, hand
        the ticket to the completion thread and return, so the pump can
        assemble the next flush while the device runs this one and the
        completion thread reads the last one back. A flush counts as in
        flight from the end of its dispatch (its waves queued) to the
        end of its completion, as the JAX engine counts it: two in
        flight means a flush was launched while the one before it had
        not been answered. Returns the (req, future) pairs the wave cap
        deferred.

        The pump's seconds in `_dispatch` accumulate in `_host_busy`:
        a flush's overlap ratio is the dispatch work done for other
        flushes while it was in flight (`_observe_overlap`)."""
        pipelined = self._pipeline_active()
        if pipelined:
            self._pipe_sem.acquire()
        t_host0 = time.perf_counter()
        try:
            carry, ticket = self._dispatch(items)
        except BaseException:
            if pipelined:
                self._pipe_sem.release()
            raise
        end = time.perf_counter()
        self._host_busy += end - t_host0
        if ticket is None:
            if pipelined:
                self._pipe_sem.release()
            return carry
        ticket.t_disp_end = end
        ticket.host_mark = self._host_busy
        if not pipelined:
            self._note_inflight(1)
            self.metrics.pipeline_inflight.observe(1)
            self._complete(ticket)
            return carry
        with self._pipe_lock:
            self._inflight += 1
            depth = self._inflight
        self._note_inflight(depth)
        self.metrics.pipeline_inflight.observe(depth)
        self._pipe_q.put(ticket)
        return carry

    def _release_slot(self) -> None:
        with self._pipe_lock:
            self._inflight -= 1
        self._pipe_sem.release()

    def _note_inflight(self, depth: int) -> None:
        with self._stats_lock:
            if depth > self._stats["inflight_max"]:
                self._stats["inflight_max"] = depth

    def _completion_loop(self) -> None:
        """Completion stage: each ticket in dispatch order, its event
        waited on, its futures resolved. A failed ticket fails only its
        own futures; the loop lives as long as the engine. The get is
        bounded so that an idle loop still beats the watchdog: a wedge
        inside `_complete` stops the beats, idleness does not."""
        while True:
            wd = self.watchdog
            if wd is not None:
                wd.beat("engine-complete", serving=True)
            try:
                t = self._pipe_q.get(timeout=0.5)
            except queue.Empty:
                continue
            if t is _STOP:
                return
            try:
                self._complete(t)
            except Exception as e:
                self._ticket_failed(t, e)
            finally:
                self._release_slot()
                self._sweep_bulks()

    def _ticket_failed(self, ticket, exc) -> None:
        """A ticket's results could not be read back: fail its
        unresolved futures. Its waves ran: the table holds their
        updates (it is updated in place, so there is nothing to rebuild,
        unlike the JAX engine's donated buffers), and later tickets go
        on from that table."""
        err = str(exc)
        for _req, fut in ticket.items:
            if not fut.done():
                fut.set_result(RateLimitResp(error=err))

    def _observe_overlap(self, ticket) -> None:
        """Host/device overlap sample for one completed flush: the
        pump's dispatch work for OTHER flushes while this one was in
        flight, as a fraction of its in-flight window (0 at depth 1)."""
        window = time.perf_counter() - ticket.t_disp_end
        overlap = self._host_busy - ticket.host_mark
        ratio = min(overlap / window, 1.0) if window > 0 else 0.0
        self.metrics.pipeline_overlap.observe(ratio)

    def _pipeline_quiesce(self) -> None:
        """Wait until every ticket in flight has completed and switch
        `_process` to inline completion (drain mode). Pump thread only:
        taking every ring slot is ticket-free only when no other producer
        can interleave."""
        self._draining = True
        if self._pipe_q is None:
            return
        for _ in range(self._pipe_depth):
            self._pipe_sem.acquire()
        for _ in range(self._pipe_depth):
            self._pipe_sem.release()

    # -- one flush -----------------------------------------------------------

    def _dispatch(self, items: List[Tuple[RateLimitReq, object]]):
        """Pipeline stage 1: assemble + encode the flush on the host and
        launch its waves, with their read-back queued and nothing waited
        for. Returns (carry, ticket); `_complete` resolves the ticket.
        The ticket is None only when the flush took no item (all
        carried); a flush whose items all failed to encode gets a ticket
        with no wave, so that its completion sweeps their bulks.

        With a replica tier (IciEngine), a GLOBAL item goes to the
        replicas (JAX `engine.py` `_dispatch`): its key re-hashed into
        the replica keyspace (slot = key_lo mod num_rgroups), its home
        the round-robin cursor, its waves assembled per (home, slot)
        pair, whose value home * num_rgroups + slot is the lane's group
        column (`parallel/ici.py`). The cursor advances only for an item
        that was placed, as JAX's does.

        With a Store, the never-seen keys of the flush (every tier's, as
        JAX's) are fetched here, outside the table lock, and the table's
        waves run the store path (`_execute_waves`)."""
        t0 = time.perf_counter()
        now = self.now_fn()
        cfg = self.cfg
        store = self.store
        hi_a, lo_a, grp_a = key_hash128_batch(
            [req.hash_key() for req, _ in items], cfg.num_groups
        )
        hi_l, lo_l, grp_l = hi_a.tolist(), lo_a.tolist(), grp_a.tolist()
        prefetched = None
        if store is not None:
            prefetched = self._store_prefetch(
                [(req, (hi_l[i], lo_l[i])) for i, (req, _) in enumerate(items)])
        self._maybe_prune_key_strings()
        rt = self._rtier
        glob = int(Behavior.GLOBAL) if rt is not None else 0
        if glob:
            n_rg = rt.num_rgroups
            slot_l = (lo_a.astype(np.uint64) % np.uint64(n_rg)).astype(np.int64).tolist()

        asm = _WaveAssembler(RequestBatch.zeros, cfg.batch_size)
        r_asm = _WaveAssembler(RequestBatch.zeros, cfg.batch_size)
        placements: List[Optional[Tuple[str, int, int]]] = []
        # per tier and wave: (req, hi, lo, group) rows for encode_rows
        rows = {"s": ([], []), "r": ([], [])}
        greg = int(Behavior.DURATION_IS_GREGORIAN)
        carry: List[Tuple[RateLimitReq, object]] = []
        new_strings: Dict[Tuple[int, int], str] = {}
        with self._rr_lock if glob else contextlib.nullcontext():
            for i, (req, fut) in enumerate(items):
                hi, lo = hi_l[i], lo_l[i]
                new_strings[(hi, lo)] = req.hash_key()
                if req.behavior & glob:
                    tier, a = "r", r_asm
                    home = self._home_rr % self.topo.n_dev
                    place_key = (home, slot_l[i])
                    grp = home * n_rg + slot_l[i]
                else:
                    tier, a = "s", asm
                    place_key = grp = grp_l[i]
                placed = a.place(place_key, cfg.max_waves)
                if placed is None:
                    carry.append((req, fut))
                    placements.append(None)
                    continue
                if tier == "r":
                    self._home_rr += 1
                wb, w, lane = placed
                if req.behavior & greg:
                    # calendar resolution stays per-item (rare path)
                    try:
                        encode_one(wb, lane, req, now, cfg.num_groups, key=(hi, lo))
                    except EncodeError as e:
                        fut.set_result(RateLimitResp(error=str(e)))
                        placements.append(None)
                        continue
                    wb.group[lane] = grp
                else:
                    wave_rows, wave_lanes = rows[tier]
                    while len(wave_rows) < len(a.waves):
                        wave_rows.append([])
                        wave_lanes.append([])
                    wave_rows[w].append((req, hi, lo, grp))
                    wave_lanes[w].append(lane)
                a.commit(w, place_key)
                placements.append((tier, w, lane))

        with self._keys_lock:
            self._key_strings.update(new_strings)
        hbs = {}
        for tier, a in (("s", asm), ("r", r_asm)):
            for w, wrows in enumerate(rows[tier][0]):
                if wrows:
                    encode_rows(a.waves[w], rows[tier][1][w], wrows, now)
            hbs[tier] = _flush_batch(a)
        (hb, spans), (rhb, rspans) = hbs["s"], hbs["r"]
        if not spans and not rspans and len(carry) == len(items):
            return carry, None
        # A flush whose every item failed to encode has no wave, and still
        # a ticket: its completion resolves the bulks those items belong to.
        sf = seq = None
        if store is not None:
            # the table's lanes: their requests per wave for the
            # read-through, and the write-behind's entries in request order
            sf = _StoreFlush([{} for _ in spans], prefetched)
            seq = []
            for i, ((req, _), place) in enumerate(zip(items, placements)):
                if place is not None and place[0] == "s":
                    _t, w, lane = place
                    sf.lane_reqs[w][lane] = (req, hi_l[i], lo_l[i])
                    seq.append((req.hash_key(), w, lane, hi_l[i], lo_l[i]))
        self._ticket_seq += 1
        t_dev = time.perf_counter()
        flush, rflush, launches = self._execute_waves(hb, spans, now, rhb, rspans, sf)
        return carry, _FlushTicket(
            items=items, placements=placements, flush=flush, rflush=rflush,
            waves=len(spans) + len(rspans), launches=launches,
            store=(sf, seq) if sf is not None else None,
            keys=(hi_l, lo_l), carry_n=len(carry),
            widths=[b for _o, b in spans] + [b for _o, b in rspans],
            seq=self._ticket_seq, t0=t0, t_dev=t_dev,
        )

    def _complete(self, t: _FlushTicket) -> None:
        """Pipeline stage 2: wait for the ticket's read-back (its events
        on a card), count the flush over both tiers and feed its
        telemetry (JAX `_complete`: the flush, its stages and the flight
        recorder), run the Store's write-behind (before any future
        resolves: a caller that saw its answer finds the store holding
        it, as the reference's OnChange runs within the request), resolve
        its futures (with `stage_breakdown_us` under `stage_metadata`),
        and fold the flush's keys into the hot-key sketch."""
        t_c0 = time.perf_counter()
        hosts = {"s": t.flush.host() if t.flush is not None else [],
                 "r": t.rflush.host() if t.rflush is not None else []}
        t_sync = time.perf_counter()
        dev_s = t_sync - t.t_dev
        served = sum(p is not None for p in t.placements)
        dur = time.perf_counter() - t.t0
        # the metrics count every item the flush took (encode errors too),
        # as the JAX engine's do
        self._count_flush("flushes", hosts["s"] + hosts["r"], t.waves, t.launches, served,
                          len(hosts["r"]), taken=len(t.items) - t.carry_n)
        em = self.metrics
        em.observe_flush("object", len(t.items) - t.carry_n, t.waves, dur, dev_s,
                         collective=self.topo.n_dev > 1)
        em.observe_stage("assemble", t.t_dev - t.t0)
        em.observe_stage("dispatch", t.t_disp_end - t.t_dev)
        em.observe_stage("inflight_wait", max(t_c0 - t.t_disp_end, 0.0))
        em.observe_stage("device_sync", t_sync - t_c0)
        em.recorder.record(
            path="object", layout=self.cfg.layout, n=len(t.items) - t.carry_n,
            waves=t.waves, carry=t.carry_n, widths=t.widths,
            dur_us=int(dur * 1e6), dev_us=int(dev_s * 1e6), ticket=t.seq, trace_id="",
        )
        if t.store is not None:
            sf, seq = t.store
            self._drop_displaced_strings(sf.events)
            self._store_write_behind_core(seq, sf)
        # under stage_metadata: the stage times every answer of the flush
        # shares; each answer adds its own queue wait
        stage_base = None
        if self._stage_md:
            stage_base = (
                f"assemble={int((t.t_dev - t.t0) * 1e6)}"
                f",dispatch={int((t.t_disp_end - t.t_dev) * 1e6)}"
                f",inflight_wait={int(max(t_c0 - t.t_disp_end, 0.0) * 1e6)}"
                f",device_sync={int((t_sync - t_c0) * 1e6)}"
            )
        hk = em.hotkeys if em.hotkeys.k > 0 else None
        hk_agg: Dict[Tuple[int, int], list] = {}
        hi_l, lo_l = t.keys
        for i, ((req, fut), place) in enumerate(zip(t.items, t.placements)):
            if place is None:
                continue  # resolved (encode error) or carried
            tier, w, lane = place
            st, rem, rst, lim = hosts[tier][w][:4]
            status = int(st[lane])
            if hk is not None:
                k = (hi_l[i], lo_l[i])
                ent = hk_agg.get(k)
                if ent is None:
                    hk_agg[k] = [max(int(req.hits), 0), int(status == 1), req.hash_key()]
                else:
                    ent[0] += max(int(req.hits), 0)
                    ent[1] += int(status == 1)
            md = None
            if stage_base is not None:
                t_enq = getattr(fut, "t_enq", None)
                md = {"stage_breakdown_us": (
                    f"queue={int((t.t0 - t_enq) * 1e6)},{stage_base}"
                    if t_enq is not None else stage_base
                )}
            fut.set_result(RateLimitResp(
                status=status,
                limit=int(lim[lane]),
                remaining=int(rem[lane]),
                reset_time=int(rst[lane]),
                **({"metadata": md} if md else {}),
            ))
        if hk is not None and hk_agg:
            hk.update([(k, v[0], v[1], v[2]) for k, v in hk_agg.items()])
        em.observe_stage("resolve", time.perf_counter() - t_sync)
        self._observe_overlap(t)

    def _count_flush(self, kind: str, host, waves: int, launches: int, served: int,
                     replica_waves: int = 0, *, taken: int) -> None:
        """Count one flush: the decide's counts and the waves into the
        EngineMetrics (`served` items answered by a wave, stats'
        requests; `taken` items the flush took, the metrics' requests,
        encode errors included, as the JAX engine counts them), the
        flush's kind, replica waves and launches into `stats()`'s own."""
        hits, misses, evictions, over = _wave_totals(host)
        self.metrics.observe(hits, misses, evictions, over, waves, taken, served)
        with self._stats_lock:
            s = self._stats
            s[kind] += 1
            s["replica_waves"] += replica_waves
            s["kernel_launches"] += launches

    def _execute_waves(self, hb: Optional[RequestBatch], spans, now: int,
                       rhb: Optional[RequestBatch] = None, rspans=(),
                       sf: Optional[_StoreFlush] = None):
        """Run decide over a flush's scatter-disjoint waves, in order,
        under the table lock, on the engine's stream: `hb` holds every
        wave's lanes on the host, wave w the span `spans[w] = (offset,
        width)` of each column. The batch goes to the device in one copy;
        each wave writes its span of the flush's outputs
        (`cuda_decide.WaveFlush`), whose read-back is queued behind the
        last wave. The replica tier's waves (`rhb`, `rspans`: group
        column of pairs) run after the table's, in a flush of their own
        over the tier's table memo, as JAX runs them after the sharded
        waves. Returns (flush or None, replica flush or None, kernel
        launches).

        With `sf` (a Store is attached) each table wave runs the store
        path around its decide: the read-through before it
        (`_store_readthrough`: probe, read back, inject the misses'
        state) and the gather after it (`_store_gather`: the rows it
        wrote, read back); the decide is the same launch.

        If a wave fails after earlier waves of the table committed,
        raises TableCommittedError so no caller retries the batch. A
        failure in a replica wave recreates the replica tier empty (its
        pending may no longer match its table; JAX rebuilds its donated
        state): the replica hits are lost, as on the JAX engine, and only
        the table's committed waves make the error TableCommittedError."""
        pager = self._pager
        rt = self._rtier
        launches = 0
        flush = rflush = None
        if self._shard_decisions is not None and spans:
            # the one point both the object and the columnar path pass:
            # the table waves' lanes, by the shard that owns their group
            self._note_shard_decisions(hb)
        with self._lock, self.topo.dispatch_guard(), self._on_stream():
            if spans:
                flush = cuda_decide.WaveFlush(batch_to_device(hb, self.device), spans, self._memo)
            if rspans:
                rflush = cuda_decide.WaveFlush(batch_to_device(rhb, self.device), rspans, rt.memo)
            done = 0
            try:
                for w, (off, width) in enumerate(spans):
                    if pager is not None:
                        # Promote every page this wave touches BEFORE its
                        # decide, from the host batch (a wave over the
                        # budget raises PageBudgetError).
                        sl = slice(off, off + width)
                        self.table = pager.ensure_resident(
                            self.table, pager.touched_pages(hb.group[sl], hb.active[sl])
                        )
                    inj = None
                    if sf is not None:
                        inj = self._store_readthrough(sf, flush, w, now, hb.group[off:off + width])
                    before = cuda_decide.thread_launches()
                    self.table = self.K.run_wave(self.table, flush, w, now, self.cfg.ways)
                    launches += cuda_decide.thread_launches() - before
                    done += 1
                    if sf is not None:
                        self._store_gather(sf, flush, w, inj)
            except Exception as e:
                if done:
                    raise TableCommittedError(str(e)) from e
                raise
            try:
                for w in range(len(rspans)):
                    before = cuda_decide.thread_launches()
                    rt.run_wave(rflush, w, now)
                    launches += cuda_decide.thread_launches() - before
            except Exception as e:
                rt.recreate_state()
                if done:
                    raise TableCommittedError(str(e)) from e
                raise
            for f in (flush, rflush):
                if f is not None:
                    f.read_back()
        if sf is not None:
            with self._stats_lock:
                self._stats["store_readbacks"] += sf.readbacks
                self._stats["store_injected"] += sf.injected
        return flush, rflush, launches

    # -- the store path (Store read-through and write-behind) ------------------

    def _store_prefetch(self, reqs, resolve=None, record=()) -> dict:
        """Store.get, outside the table lock, of the keys this engine has
        never seen (absent from the key dictionary, which holds every key
        of the table): {(hi, lo): snapshot}. `reqs` are (request, key)
        pairs, or (item index, key) with `resolve` building the request;
        `record` ((key, string) pairs) joins the dictionary under the same
        lock. A store outage is a miss."""
        with self._keys_lock:
            need, seen = [], set()
            for req, k in reqs:
                if k not in self._key_strings and k not in seen:
                    seen.add(k)
                    need.append((req, k))
            self._key_strings.update(record)
        out = {}
        for req, k in need:
            try:
                snap = self.store.get(resolve(req) if resolve is not None else req)
            except Exception:
                snap = None  # a store outage is a cache miss, not a crash
            if snap is not None:
                out[k] = snap
        return out

    def _store_probe(self, wb: RequestBatch, now: int) -> np.ndarray:
        """The residency probe of a wave's keys (its lanes on the
        device), read back: the store path's first read-back of the
        wave."""
        exists = self.K.probe_exists(self.table, wb.key_hi, wb.key_lo, wb.group, now,
                                     self.cfg.ways)
        return exists.cpu().numpy()

    def _store_readthrough(self, sf: _StoreFlush, flush, w: int, now: int, group):
        """Before wave w's decide (table lock held; JAX
        `_wave_readthrough`): probe the wave's keys and, for each lane
        whose key is not live, take the freshest state known and inject
        it so that the decide continues the counter (reference
        algorithms.go:45-51). Freshness order:

        1. a row this flush already served (the key was displaced between
           its own waves; a row freed by RESET_REMAINING, or one whose key
           check fails, leaves the key absent: the store's remove lands
           at the flush's end);
        2. the prefetch of never-seen keys;
        3. `Store.get` under the lock (a store outage is a miss).

        `group` is the wave's group column on the host. Returns None, or
        the inject's evicted keys on the device and the injected keys,
        for `_store_gather`'s read-back and events."""
        exists = self._store_probe(flush.wave_batch(w), now)
        sf.readbacks += 1
        rows = []
        for lane, (req, hi, lo) in sf.lane_reqs[w].items():
            if exists[lane]:
                continue
            if sf.resolver is not None:
                req = sf.resolver(req)  # columnar: requests only for misses
            snap = None
            sv = sf.served.get((hi, lo))
            if sv is not None:
                pw, plane = sv
                r = sf.rows[pw]
                if r[_R["used"], plane] and r[_R["key_hi"], plane] == hi \
                        and r[_R["key_lo"], plane] == lo:
                    snap = _snapshot_from_row(r, plane, req.hash_key())
            else:
                snap = sf.prefetched.get((hi, lo))
                if snap is None:
                    try:
                        snap = self.store.get(req)
                    except Exception:
                        snap = None  # a store outage is a cache miss
            if snap is not None:
                rows.append((lane, snap, hi, lo))
        if not rows:
            return None
        ib = InjectBatch.zeros(len(rows))
        for j, (lane, sn, hi, lo) in enumerate(rows):
            ib.key_hi[j] = hi
            ib.key_lo[j] = lo
            ib.group[j] = int(group[lane])
            ib.algo[j] = int(sn.algorithm)
            ib.status[j] = int(sn.status)
            ib.limit[j] = sn.limit
            ib.duration[j] = sn.duration
            ib.remaining[j] = sn.remaining
            ib.stamp[j] = sn.stamp
            ib.expire_at[j] = sn.expire_at
            ib.invalid_at[j] = int(getattr(sn, "invalid_at", 0))
            ib.burst[j] = sn.burst
            ib.active[j] = True
        sf.injected += len(rows)
        ehi, elo = self._store_inject(ib, now)
        return ehi, elo, [(hi, lo) for _lane, _sn, hi, lo in rows]

    def _store_inject(self, ib: InjectBatch, now: int):
        """A read-through's rows (host columns) into the table: one copy
        to the device, then `inject`. Returns its evicted keys, on the
        device."""
        self.table, ehi, elo = self.K.inject(self.table, ib.to_device(self.device), now,
                                             self.cfg.ways)
        return ehi, elo

    def _store_gather(self, sf: _StoreFlush, flush, w: int, inj) -> None:
        """After wave w's decide: `gather_rows(table, out.slot)` (the rows
        it wrote, as the wide struct), its evicted keys and freed flags,
        and the evicted keys of its inject, read back in ONE copy (the
        wave's second read-back); then the wave's events in the JAX
        engine's order (the inject's displaced and inserted keys, the
        decide's displaced keys, the wave's keys) and where each of its
        keys was served."""
        off, b = flush.spans[w]
        s = slice(off, off + b)
        rows = self.K.gather_rows(self.table, flush.slot[s])
        cols = [getattr(rows, f).to(torch.int64) for f in _WB_FIELDS]
        cols += [flush.evicted_hi[s], flush.evicted_lo[s],
                 flush.freed(self.topo.freed_dtype)[s].to(torch.int64)]
        if inj is not None:
            cols += [inj[0], inj[1]]
        flat = torch.cat(cols).cpu().numpy()
        sf.readbacks += 1
        host = flat[:_N_ROWS * b].reshape(_N_ROWS, b)
        ev = sf.events
        if inj is not None:
            ehi, elo = flat[_N_ROWS * b:].reshape(2, -1)
            for j in np.nonzero((ehi != 0) | (elo != 0))[0].tolist():
                ev.append(("d", (int(ehi[j]), int(elo[j]))))
            ev.extend(("i", k) for k in inj[2])
        ehi, elo = host[_R["evicted_hi"]], host[_R["evicted_lo"]]
        for j in np.nonzero((ehi != 0) | (elo != 0))[0].tolist():
            ev.append(("d", (int(ehi[j]), int(elo[j]))))
        for lane, (_req, hi, lo) in sf.lane_reqs[w].items():
            sf.served[(hi, lo)] = (w, lane)
            ev.append(("i", (hi, lo)))
        sf.offsets.append(off)  # the blocks tile the flush's lanes, as its spans
        sf.rows.append(host)

    def _drop_displaced_strings(self, events) -> None:
        """Key-dictionary hygiene (store path): a key whose LAST event of
        the flush was a displacement has left the table; dropping its
        string makes its next request prefetch the store's state outside
        the lock. A key inserted again after its displacement keeps its
        string. Read-through never depends on this: the probe is ground
        truth."""
        if not events:
            return
        last: Dict[Tuple[int, int], str] = {}
        for ev, k in events:
            last[k] = ev
        dead = [k for k, ev in last.items() if ev == "d"]
        if dead:
            with self._keys_lock:
                for k in dead:
                    self._key_strings.pop(k, None)

    def _store_write_behind_core(self, seq, sf: _StoreFlush) -> None:
        """Write-behind (JAX `_store_write_behind_core`): `seq` yields
        (hash_key, wave, lane, hi, lo) in REQUEST order, `sf.rows` are
        the flush's per-wave host blocks, gathered right after each wave,
        so each lane sees the state its own decide produced even where a
        later wave displaced or freed the slot.

        The last operation per key wins: a token-bucket RESET_REMAINING
        free removes the stored entry (reference algorithms.go:78-90), a
        later hit stores the new state; a lane whose gathered row is not
        its key's (unused, or another key's) leaves the store as it was.
        A failed store call is logged, never raised: write-behind runs
        after the table committed, and the reference's OnChange has no
        error return (store.go:49-65)."""
        entries = list(seq)
        if not entries:
            return
        w_arr = np.fromiter((e[1] for e in entries), np.int64, len(entries))
        l_arr = np.fromiter((e[2] for e in entries), np.int64, len(entries))
        col = np.asarray(sf.offsets, np.int64)[w_arr] + l_arr
        v = np.concatenate(sf.rows, axis=1)[:, col].tolist()  # (_N_ROWS, n) lists
        used, k_hi, k_lo, freed = (v[_R[f]] for f in ("used", "key_hi", "key_lo", "freed"))
        state = [v[_R[c]] for _f, c in SNAPSHOT_COLUMNS]
        ops: Dict[str, Optional[ItemSnapshot]] = {}
        for i, (key, _w, _lane, hi, lo) in enumerate(entries):
            if freed[i]:
                ops[key] = None
                continue
            if not used[i] or k_hi[i] != hi or k_lo[i] != lo:
                continue
            ops[key] = ItemSnapshot(key, *(col[i] for col in state))
        changes = [sn for sn in ops.values() if sn is not None]
        try:
            for key, sn in ops.items():
                if sn is None:
                    self.store.remove(key)
            if changes:
                self.store.on_change(changes)
        except Exception:
            logging.getLogger(__name__).exception(
                "store write-behind failed (%d changes dropped)", len(changes))

    def warm_store_path(self) -> None:
        """Load the store path's ops at engine start, where JAX compiles
        them, so that the first flush does not pay for it under the lock:
        one probe, inject and gather of one padding lane (inactive, at
        slot N), which change nothing. The decide's kernels were built
        when the engine was made."""
        z = torch.zeros(1, dtype=torch.int64, device=self.device)
        with self._lock, self.topo.dispatch_guard(), self._on_stream():
            now = self.now_fn()
            self.K.probe_exists(self.table, z, z, z.to(torch.int32), now, self.cfg.ways)
            self._store_inject(InjectBatch.zeros(1), now)
            self.K.gather_rows(self.table, z + self.table.num_slots).used.cpu()

    def inject_snapshots(self, items: Sequence[ItemSnapshot]) -> None:
        """Write raw per-key state rows into the table, unconditionally
        (the Loader restore and the LWW merge; reference
        workers.go:537-580). Waves keep each group's items in arrival
        order, as the JAX engine's first-fit assembler does, so the table
        ends the same: an item's wave is its occurrence rank within its
        group; each rank's items, sorted by group (few pages per wave on
        a paged table), are cut into waves of `batch_size` lanes. The
        columns reach the device in one copy each; then one inject per
        wave, after `ensure_resident` of its pages."""
        if not items:
            return
        now = self.now_fn()
        cfg = self.cfg
        n = len(items)
        hi, lo, grp = key_hash128_batch([it.key for it in items], cfg.num_groups)
        order = np.argsort(grp, kind="stable")
        sg = grp[order]
        rank = np.empty(n, np.int64)
        rank[order] = np.arange(n) - np.searchsorted(sg, sg, side="left")
        seq = np.lexsort((grp, rank))  # by rank, then group
        state = np.array(
            [(it.algorithm, it.status, it.limit, it.duration, it.remaining, it.stamp,
              it.expire_at, getattr(it, "invalid_at", 0), it.burst) for it in items],
            dtype=np.int64,
        ).reshape(n, 9)[seq]
        cols = dict(key_hi=hi[seq], key_lo=lo[seq], group=grp[seq].astype(np.int32))
        for j, (_f, c) in enumerate(SNAPSHOT_COLUMNS):
            cols[c] = state[:, j]
        r_sorted = rank[seq]
        bounds = np.flatnonzero(np.diff(r_sorted)) + 1
        waves = []
        for a, z in zip(np.concatenate([[0], bounds]).tolist(),
                        np.concatenate([bounds, [n]]).tolist()):
            waves.extend((o, min(o + cfg.batch_size, z)) for o in range(a, z, cfg.batch_size))
        cols["active"] = np.ones(n, np.bool_)
        host = InjectBatch(**{f: cols[f].astype(dt) for f, dt in INJECT_DTYPES.items()})
        with self._keys_lock:
            self._key_strings.update(zip(zip(hi.tolist(), lo.tolist()), (it.key for it in items)))
        pager = self._pager
        with self._lock, self.topo.dispatch_guard(), self._on_stream():
            dev = host.to_device(self.device)
            for a, z in waves:
                if pager is not None:
                    self.table = pager.ensure_resident(
                        self.table, pager.touched_pages(host.group[a:z]))
                self.table, _ehi, _elo = self.K.inject(
                    self.table, InjectBatch(*(c[a:z] for c in dev)), now, cfg.ways)
        with self._stats_lock:
            self._stats["inject_waves"] += len(waves)
            self._stats["injected_rows"] += n

    # -- the columnar path (the serving edge, service/fastpath.py) -------------

    def check_columns(self, cols, now: Optional[int] = None, select=None, hashes=None):
        """Decide a batch given as wire columns (`wire.RequestColumns`)
        with no per-item Python objects: one native hash call, waves and
        lanes assigned with array operations (`_assemble_column_waves`),
        the (W, B) stack sent to the device in one copy, every wave a
        contiguous row of it. Returns (status, limit, remaining,
        reset_time) numpy arrays in request order, or None when the batch
        needs the object path (empty, more than `max_waves` waves, or
        more than `batch_size` lanes in one).

        The caller guarantees: no DURATION_IS_GREGORIAN items, no GLOBAL
        bit unless the engine routes GLOBAL internally, no per-item
        metadata, and validation already done (service/fastpath.py).

        With a replica tier (IciEngine) the batch splits as JAX's
        `_check_columns_replica_split` splits it: the non-GLOBAL items
        go to the table's waves, the GLOBAL ones to replica waves, their
        homes the round-robin cursor's next values (taken once the table
        waves fit), their waves assembled per (home, slot) pair.

        `select` serves a SUBSET of the batch (the Gregorian lane split of
        the edge), with `hashes` = (hi, lo, grp) over the FULL batch.
        Results align with `select`'s order.

        The never-seen keys' strings join the key dictionary (the object
        path records every key's), so snapshots carry the same
        `key_strings` whichever path served.

        With a Store the table's waves take the store path (JAX
        `check_columns`): every key's string is decoded once, never-seen
        keys are prefetched outside the lock with requests built from
        the columns, requests are built lazily for the waves' misses
        only (`wire.req_from_columns`), and write-behind runs from the
        per-wave rows before this returns. On an engine with a replica
        tier the JAX package serves columns through
        `_check_columns_replica_split`, whose waves run the probe and
        the gather with no lane to read through or persist: this engine
        does the same (ROADMAP.md §3)."""
        cfg = self.cfg
        store = self.store
        if cols.n == 0:
            return None
        t_start = time.perf_counter()
        if now is None:
            now = self.now_fn()
        if hashes is None:
            hi, lo, grp = key_hash128_batch_raw(
                cols.key_data.tobytes(), cols.key_offsets, cfg.num_groups
            )
        else:
            hi, lo, grp = hashes
        orig_cols, sel_map = cols, None
        if select is not None:
            if len(select) == 0:
                return None
            hi, lo, grp = hi[select], lo[select], grp[select]
            cols = _select_columns(cols, select)
            sel_map = select
        tiers = []  # ("s" or "r", the items' positions (a slice: all), assembly)
        g_mask = None
        if self._rtier is not None:
            g_mask = (cols.behavior & int(Behavior.GLOBAL)) != 0
            if not g_mask.any():
                g_mask = None
        if g_mask is None:
            asm = _assemble_column_waves(cols, hi, lo, grp, now, cfg.batch_size, cfg.max_waves)
            if asm is None:
                return None
            tiers.append(("s", slice(None), asm))
        else:
            ng, g = np.nonzero(~g_mask)[0], np.nonzero(g_mask)[0]
            if len(ng):
                asm = _assemble_column_waves(_select_columns(cols, ng), hi[ng], lo[ng], grp[ng],
                                             now, cfg.batch_size, cfg.max_waves)
                if asm is None:
                    return None
                tiers.append(("s", ng, asm))
            n_rg = self._rtier.num_rgroups
            slot = (lo[g].astype(np.uint64) % np.uint64(n_rg)).astype(np.int64)
            with self._rr_lock:
                rr0 = self._home_rr
                self._home_rr += len(g)
            homes = (rr0 + np.arange(len(g))) % self.topo.n_dev
            asm = _assemble_column_waves(_select_columns(cols, g), hi[g], lo[g],
                                         homes * n_rg + slot, now, cfg.batch_size, cfg.max_waves)
            if asm is None:
                return None
            tiers.append(("r", g, asm))

        hi_l, lo_l = hi.tolist(), lo.tolist()
        keys_l = list(zip(hi_l, lo_l))
        sf = strs = None
        if store is not None and self._rtier is None:
            if sel_map is None:
                strs = cols.key_strings_all()
            else:
                strs = [orig_cols.key_string(int(j)) for j in sel_map]

            def req_of(j: int) -> RateLimitReq:
                return wire.req_from_columns(
                    orig_cols, int(sel_map[j]) if sel_map is not None else j)

            prefetched = self._store_prefetch(
                list(enumerate(keys_l)), resolve=req_of, record=zip(keys_l, strs))
            self._maybe_prune_key_strings()
            _wb, wave, lane, _ix, W, _B = tiers[0][2]
            wave_l, lane_l = wave.tolist(), lane.tolist()
            sf = _StoreFlush([{} for _ in range(W)], prefetched, resolver=req_of)
            for j, (w, ln) in enumerate(zip(wave_l, lane_l)):
                sf.lane_reqs[w][ln] = (j, hi_l[j], lo_l[j])
        else:
            with self._keys_lock:
                miss = [(j, k) for j, k in enumerate(keys_l) if k not in self._key_strings]
            if miss:
                decoded = [
                    (k, orig_cols.key_string(int(sel_map[j]) if sel_map is not None else j))
                    for j, k in miss
                ]
                with self._keys_lock:
                    self._key_strings.update(decoded)
                self._maybe_prune_key_strings()
            if store is not None and tiers[0][0] == "s":
                sf = _StoreFlush([{} for _ in range(tiers[0][2][4])], {})

        batches = {"s": (None, []), "r": (None, [])}
        for tier, _pos, (wb, _wave, _lane, _ix, W, B) in tiers:
            batches[tier] = (RequestBatch(*(c.reshape(-1) for c in wb)),
                             [(w * B, B) for w in range(W)])
        (hb, spans), (rhb, rspans) = batches["s"], batches["r"]
        t_dev = time.perf_counter()
        flush, rflush, launches = self._execute_waves(hb, spans, now, rhb, rspans, sf)
        hosts = {"s": flush.host() if flush is not None else [],
                 "r": rflush.host() if rflush is not None else []}
        dev_s = time.perf_counter() - t_dev
        n_waves = len(spans) + len(rspans)
        if strs is not None:
            self._store_write_behind_core(zip(strs, wave_l, lane_l, hi_l, lo_l), sf)
            self._drop_displaced_strings(sf.events)
        out = None
        for tier, pos, asm in tiers:
            stacked = _stack_wave_outputs(hosts[tier])
            if out is None:
                out = [np.zeros(cols.n, dtype=x.dtype) for x in stacked]
            for o, x in zip(out, stacked):
                o[pos] = x[asm[3]]
        dur = time.perf_counter() - t_start
        self._count_flush("columnar_flushes", hosts["s"] + hosts["r"], n_waves,
                          launches, cols.n, len(rspans), taken=cols.n)
        em = self.metrics
        em.observe_flush("columnar", cols.n, n_waves, dur, dev_s,
                         collective=self.topo.n_dev > 1)
        em.observe_stage("assemble", t_dev - t_start)
        em.observe_stage("device_sync", dev_s)
        em.recorder.record(
            path="columnar", layout=cfg.layout, n=cols.n, waves=n_waves, carry=0,
            widths=[cfg.batch_size] * n_waves, dur_us=int(dur * 1e6),
            dev_us=int(dev_s * 1e6), trace_id="",
        )
        if em.hotkeys.k > 0:
            _note_hotkeys_columnar(em.hotkeys, hi, lo, cols.hits, out[0])
        return tuple(out)

    def _maybe_prune_key_strings(self) -> None:
        """Bound host memory: when the hash->string dictionary exceeds
        twice the slot count, rebuild it from the table's live keys."""
        n = self.cfg.num_groups * self.cfg.ways
        if len(self._key_strings) <= max(2 * n, 4096):
            return
        # on the engine's stream: the read sees every wave queued before it
        with self._lock, self._on_stream():
            wide = self.K.to_wide(self.table)
            used = wide.used.cpu().numpy()
            hi = wide.key_hi.cpu().numpy()[used]
            lo = wide.key_lo.cpu().numpy()[used]
            # Demoted keys are still live: their pages promote back
            # verbatim, so their strings survive the prune.
            host_keys = self._pager.host_live_keys() if self._pager is not None else set()
        live = set(zip(hi.tolist(), lo.tolist())) | host_keys
        with self._keys_lock:
            self._key_strings = {
                k: v for k, v in self._key_strings.items() if k in live
            }

    # -- snapshot / restore (the Loader seam) --------------------------------

    def snapshot(self) -> dict:
        """Device -> host snapshot: the wide columns as numpy arrays plus
        `key_strings` ({(hi, lo): key}), the format
        `gubernator_tpu.runtime.engine.MeshEngine.snapshot()` returns.

        Paged table: the LOGICAL wide image (resident frames and host-tier
        pages placed at their logical offsets), identical to a flat
        table's snapshot of the same keys."""
        with self._lock, self._on_stream():
            wide = self.K.to_wide(self.table)
            host = {
                f: getattr(wide, f).to("cpu", copy=True).numpy()
                for f in SlotTable._fields
            }
            # the bytes this snapshot staged (device_memory's snapshot_staging)
            self._snapshot_staging_bytes = sum(a.nbytes for a in host.values())
            if self._pager is not None:
                host = self._logical_image(host)
        with self._keys_lock:
            host["key_strings"] = dict(self._key_strings)
        return host

    def _logical_image(self, phys: dict) -> dict:
        """The physical frames' wide rows and the host tier, placed by
        logical page and trimmed to the logical slot count (lock held)."""
        ps = self.K.page_slots
        host = wide_zeros(self.K.num_logical_pages * ps)
        pager = self._pager
        for lp in np.nonzero(pager.page_map >= 0)[0].tolist():
            pp = int(pager.page_map[lp])
            for f in SlotTable._fields:
                host[f][lp * ps:(lp + 1) * ps] = phys[f][pp * ps:(pp + 1) * ps]
        for lp, rows in pager.host_tier.items():
            for f in SlotTable._fields:
                host[f][lp * ps:(lp + 1) * ps] = rows[f]
        n_logical = self.cfg.num_groups * self.cfg.ways
        return {f: a[:n_logical] for f, a in host.items()}

    def restore(self, snap: dict) -> None:
        """Host -> device restore from a snapshot dict (this engine's or
        the JAX package's). Replaces the table and the key dictionary.

        Paged table: pages holding live rows fill the frames in logical
        order; the overflow goes to the host tier, so nothing is dropped
        when the image holds more live pages than the budget."""
        n = self.cfg.num_groups * self.cfg.ways
        wide = SlotTable(**{
            f: np.asarray(snap[f], dtype=SLOT_DTYPES[f]) for f in SlotTable._fields
        })
        if wide.num_slots != n:
            raise ValueError(
                f"snapshot holds {wide.num_slots} slots; this engine has {n}"
            )
        self._snapshot_staging_bytes = sum(getattr(wide, f).nbytes for f in SlotTable._fields)
        if self._pager is not None:
            self._restore_paged(wide)
        else:
            with self._lock, self._on_stream():
                self.table = self.K.from_wide(wide, self.device)
        with self._keys_lock:
            self._key_strings = dict(snap.get("key_strings", {}))

    def _restore_paged(self, wide: SlotTable) -> None:
        PK = self.K
        ps = PK.page_slots
        n = wide.num_slots
        with self._lock, self._on_stream():
            self.table = PK.create()
            pager = self._pager
            pager.reset()
            for lp in range(PK.num_logical_pages):
                lo, hi = lp * ps, min((lp + 1) * ps, n)
                if lo >= n or not wide.used[lo:hi].any():
                    continue
                page = wide_zeros(ps)
                for f in SlotTable._fields:
                    page[f][: hi - lo] = getattr(wide, f)[lo:hi]
                pp = pager.acquire_frame(lp)
                if pp is not None:
                    self.table = PK.write_page(self.table, lp, pp, SlotTable(**page))
                    pager.page_map[lp] = pp
                else:
                    pager.host_tier[lp] = page


def _snapshot_from_row(r: np.ndarray, lane: int, key: str) -> ItemSnapshot:
    """ItemSnapshot from one lane of a wave's host block."""
    return ItemSnapshot(key, *(int(r[_R[c], lane]) for _f, c in SNAPSHOT_COLUMNS))


class DeviceEngine(MeshEngine):
    """MeshEngine at mesh shape (1,): the single-device engine that
    V1Service and the tests construct, its table on `EngineConfig.device`
    (the default topology). Every behaviour lives in the core."""


def _read_back(out):
    """Enqueue the copy of a scan's O(buckets) tensors (a NamedTuple) to
    the host: one int64 vector, on a card copied to pinned memory on the
    current stream behind one event. Returns a function that waits for
    it (call it after releasing the table lock) and returns {field:
    numpy array}."""
    shapes = [tuple(t.shape) for t in out]
    flat = torch.cat([t.reshape(-1).to(torch.int64) for t in out])
    done = None
    if flat.device.type == "cuda":
        host = torch.empty(flat.shape, dtype=torch.int64, pin_memory=True)
        host.copy_(flat, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
    else:
        host = flat

    def wait() -> dict:
        if done is not None:
            done.synchronize()
        vals, res, off = host.numpy(), {}, 0
        for f, shape in zip(out._fields, shapes):
            n = int(np.prod(shape, dtype=np.int64))
            res[f] = vals[off:off + n].reshape(shape).copy()
            off += n
        return res

    return wait


def _census_tier_snapshot(out, *, now, layout, groups, ways, bytes_per_slot, thresholds,
                          heatmap_width) -> dict:
    """One tier's census result ({field: value}, O(buckets)) as the
    JSON-safe dict of the JAX engine's snapshot."""
    a = {f: np.asarray(v).tolist() for f, v in out.items()}
    slots = groups * ways
    live = a["live"]
    waste = a["waste"]
    full_groups = a["full_groups"]
    return {
        "layout": layout,
        "groups": groups,
        "ways": ways,
        "slots": slots,
        "bytes_per_slot": bytes_per_slot,
        "now_ms": int(now),
        "live": live,
        "occupancy": live / float(slots) if slots else 0.0,
        "full_groups": full_groups,
        "full_group_ratio": full_groups / float(groups) if groups else 0.0,
        "waste": waste,
        "waste_frac": waste / float(slots) if slots else 0.0,
        "age_ms_hist": a["age_hist"],
        "age_ms_sum": a["age_sum"],
        "idle_ms_hist": a["idle_hist"],
        "idle_ms_sum": a["idle_sum"],
        "heatmap": a["heatmap"],
        "cold_heatmap": a["cold_heatmap"],
        "heatmap_groups_per_region": -(-groups // heatmap_width),
        "fill_hist": a["fill_hist"],
        "max_full_run": a["max_full_run"],
        "cold": [
            {
                "multiplier": int(k),
                "slots": c,
                "frac": c / float(slots) if slots else 0.0,
                "reclaimable_bytes": c * bytes_per_slot,
            }
            for k, c in zip(thresholds, a["cold"])
        ],
    }


def _census_combine(tiers: Dict[str, dict], primary: str) -> dict:
    """The census snapshot: residency, age and cold numbers summed over
    the tiers, the primary tier's structural fields (heatmaps, fill
    histogram, probe pressure), and every tier under "tiers"."""
    p = tiers[primary]
    live = sum(t["live"] for t in tiers.values())
    slots = sum(t["slots"] for t in tiers.values())
    waste = sum(t["waste"] for t in tiers.values())

    def vsum(field):
        return [sum(vals) for vals in zip(*(t[field] for t in tiers.values()))]

    cold = []
    for i, entry in enumerate(p["cold"]):
        c = sum(t["cold"][i]["slots"] for t in tiers.values())
        cold.append({
            "multiplier": entry["multiplier"],
            "slots": c,
            "frac": c / float(slots) if slots else 0.0,
            "reclaimable_bytes": sum(t["cold"][i]["reclaimable_bytes"] for t in tiers.values()),
        })
    return {
        "v": 1,
        "layout": p["layout"],
        "groups": p["groups"],
        "ways": p["ways"],
        "slots": slots,
        "bytes_per_slot": p["bytes_per_slot"],
        "now_ms": p["now_ms"],
        "live": live,
        "occupancy": live / float(slots) if slots else 0.0,
        "full_groups": p["full_groups"],
        "full_group_ratio": p["full_group_ratio"],
        "waste": waste,
        "waste_frac": waste / float(slots) if slots else 0.0,
        "age_ms_hist": vsum("age_ms_hist"),
        "age_ms_sum": sum(t["age_ms_sum"] for t in tiers.values()),
        "idle_ms_hist": vsum("idle_ms_hist"),
        "idle_ms_sum": sum(t["idle_ms_sum"] for t in tiers.values()),
        "heatmap": p["heatmap"],
        "cold_heatmap": p["cold_heatmap"],
        "heatmap_groups_per_region": p["heatmap_groups_per_region"],
        "fill_hist": p["fill_hist"],
        "max_full_run": p["max_full_run"],
        "cold": cold,
        "tiers": tiers,
    }


def _admission_tier_dict(out: dict) -> dict:
    """One tier's admission result ({field: value}) as plain ints."""
    return {
        "keys": int(out["keys"]),
        "admitted_hits": int(out["admitted_sum"]),
        "limit_hits": int(out["limit_sum"]),
        "excess_hits": int(out["excess_sum"]),
        "excess_keys": int(out["excess_keys"]),
        "max_excess": int(out["max_excess"]),
        "over_limit_keys": int(out["over_limit_keys"]),
        "excess_hist": [int(x) for x in out["excess_hist"]],
    }


def _admission_combine(tiers: Dict[str, dict]) -> dict:
    """The admission snapshot: every count summed over the tiers (each
    key lives in one), max_excess their maximum, and the over-admission
    ratio (excess hits per configured limit hit, 0 on an empty table)."""
    excess = sum(t["excess_hits"] for t in tiers.values())
    limit = sum(t["limit_hits"] for t in tiers.values())
    return {
        "v": 1,
        "keys": sum(t["keys"] for t in tiers.values()),
        "admitted_hits": sum(t["admitted_hits"] for t in tiers.values()),
        "limit_hits": limit,
        "excess_hits": excess,
        "excess_keys": sum(t["excess_keys"] for t in tiers.values()),
        "max_excess": max(t["max_excess"] for t in tiers.values()),
        "over_limit_keys": sum(t["over_limit_keys"] for t in tiers.values()),
        "excess_ratio": excess / float(limit) if limit else 0.0,
        "excess_hist": [sum(vals) for vals in zip(*(t["excess_hist"] for t in tiers.values()))],
        "tiers": tiers,
    }


def _assemble_column_waves(cols, hi, lo, grp, now: int, batch_size: int, max_waves: int):
    """Vectorized wave assembly of the columnar path: wave = occurrence
    rank within the group (a stable sort keeps arrival order, so a key's
    requests keep their order); lane = arrival rank within the wave.
    Returns (wb, wave, lane, ix, W, B) with `wb` a (W, B) host
    RequestBatch narrowed to the occupancy (B = the widest wave's lanes),
    or None when the batch exceeds the wave or lane bounds (the caller
    takes the object path). The clamps are encode_rows' (encode_one's);
    created_at == 0 counts as absent, as on the object path."""
    n = cols.n
    order = np.argsort(grp, kind="stable")
    sg = grp[order]
    wave_sorted = np.arange(n) - np.searchsorted(sg, sg, side="left")
    wave = np.empty(n, np.int64)
    wave[order] = wave_sorted
    num_waves = int(wave.max()) + 1
    if num_waves > max_waves:
        return None
    order2 = np.argsort(wave, kind="stable")
    sw = wave[order2]
    lane_sorted = np.arange(n) - np.searchsorted(sw, sw, side="left")
    max_lane = int(lane_sorted.max())
    if max_lane >= batch_size:
        return None
    lane = np.empty(n, np.int64)
    lane[order2] = lane_sorted

    hits = np.clip(cols.hits, -MAX_COUNT, MAX_COUNT)
    limit = np.clip(cols.limit, -MAX_COUNT, MAX_COUNT)
    duration = np.clip(cols.duration, 0, MAX_DURATION_MS)
    burst = np.clip(cols.burst, 0, MAX_COUNT)
    is_leaky = cols.algo.astype(np.int64) == 1
    burst = np.where(is_leaky & (burst == 0), limit, burst)
    created = np.where(
        cols.has_created.astype(bool) & (cols.created_at != 0), cols.created_at, np.int64(now),
    )

    W, B = num_waves, max_lane + 1
    wb = RequestBatch(*(np.zeros((W, B), dtype=dt) for dt in BATCH_DTYPES.values()))
    ix = (wave, lane)
    wb.key_hi[ix] = hi
    wb.key_lo[ix] = lo
    wb.group[ix] = grp
    wb.algo[ix] = cols.algo.astype(np.int8)
    wb.behavior[ix] = cols.behavior.astype(np.int32)
    wb.hits[ix] = hits
    wb.limit[ix] = limit
    wb.duration[ix] = duration
    wb.rate_num[ix] = duration
    wb.eff_duration[ix] = duration
    wb.burst[ix] = burst
    wb.created_at[ix] = created
    wb.active[ix] = True
    return wb, wave, lane, ix, W, B


def _flush_batch(asm: _WaveAssembler):
    """An assembler's waves as one host batch, every wave at its own
    width (its occupied lanes, a prefix) one after another, and their
    (offset, width) spans; (None, []) when no wave holds a lane. A wave
    made for an item that then failed to encode may be left empty; only
    the last wave can be (later items would fill it)."""
    n_waves = len(asm.waves)
    while n_waves and asm.fill(n_waves - 1) == 0:
        n_waves -= 1
    if n_waves == 0:
        return None, []
    fills = [asm.fill(w) for w in range(n_waves)]
    offsets = np.concatenate([[0], np.cumsum(fills)[:-1]]).tolist()
    hb = RequestBatch(*(
        np.concatenate([c[:f] for c, f in zip(cols, fills)])
        for cols in zip(*asm.waves[:n_waves])
    ))
    return hb, list(zip(offsets, fills))


def _stack_wave_outputs(host):
    """(status, limit, remaining, reset_time) stacked (W, B) from the
    per-wave host outputs (`WaveFlush.host()`)."""
    return (
        np.stack([h[0] for h in host]),
        np.stack([h[3] for h in host]),
        np.stack([h[1] for h in host]),
        np.stack([h[2] for h in host]),
    )


def _note_hotkeys_columnar(hk, hi, lo, hits, status) -> None:
    """Fold one columnar flush into the hot-key sketch, keyed by the
    128-bit hash pair (the edge decodes no key strings for this; display
    names resolve through the sketch's resolver). Host arrays only."""
    agg: Dict[Tuple[int, int], list] = {}
    for h, l, w, s in zip(hi.tolist(), lo.tolist(), hits.tolist(), status.tolist()):
        o = 1 if s == 1 else 0  # Status.OVER_LIMIT
        k = (h, l)
        ent = agg.get(k)
        if ent is None:
            agg[k] = [max(int(w), 0), o]
        else:
            ent[0] += max(int(w), 0)
            ent[1] += o
    if agg:
        hk.update([(k, v[0], v[1], None) for k, v in agg.items()])


def _wave_totals(host):
    """(hits, misses, unexpired_evictions, over_limit) summed over the
    waves of a flush."""
    return tuple(sum(h[k] for h in host) for k in (4, 5, 6, 7))


def _select_columns(cols, select: np.ndarray):
    """Subset view of RequestColumns for check_columns(select=...): the
    field arrays are fancy-indexed; the key bytes are NOT re-sliced (the
    hashes come from the full batch, and key strings are read from the
    original columns), so key_offsets is None: any use of the subset's
    keys fails loudly instead of reading misaligned offsets."""
    return dataclasses.replace(
        cols,
        n=int(len(select)),
        hits=cols.hits[select],
        limit=cols.limit[select],
        duration=cols.duration[select],
        algo=cols.algo[select],
        behavior=cols.behavior[select],
        burst=cols.burst[select],
        created_at=cols.created_at[select],
        has_created=cols.has_created[select],
        slow=cols.slow[select],
        name_lens=cols.name_lens[select],
        key_offsets=None,
    )
