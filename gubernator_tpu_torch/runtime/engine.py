"""Device engine: micro-batch assembly over the device-resident table.

The port of `gubernator_tpu/runtime/engine.py` (`MeshEngine`, and
`DeviceEngine`, the engine at mesh shape (1,)) for the object path with
a serial pump. Requests accumulate into waves; one decide call per wave
updates the table in place on the device (a CUDA kernel on a CUDA
table). The topology (runtime/topology.py) binds the kernels: one
table's, or the owner-sharded mesh's (runtime/ici_engine.py IciEngine).

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
the next flush in arrival order.

Paged table (`page_groups > 0`, docs/architecture.md "Paged table"):
the device holds `page_budget` frames of `page_groups` groups behind a
page map (ops/paged.py), and the host tier holds demoted pages
(runtime/pager.py). Before each wave's copy to the device and its
decide, the pager makes every page the wave touches resident, demoting
the least recently touched pages when no frame is free. Pages demote
only on that demand: the JAX engine's background demoter waits for the
table census.

Thread model: callers on any thread enqueue; one pump thread assembles,
runs the waves, reads the decisions back and resolves futures. Only the
pump touches the table during serving (`snapshot`/`restore` take the
same lock, which also guards the pager).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gubernator_tpu_torch.api.keys import key_hash128_batch
from gubernator_tpu_torch.api.types import (
    Behavior,
    ERR_ENGINE_DRAINING,
    RateLimitReq,
    RateLimitResp,
    validate_request,
)
from gubernator_tpu_torch.ops import cuda_decide
from gubernator_tpu_torch.ops.encode import EncodeError, encode_one, encode_rows
from gubernator_tpu_torch.ops.kernels import LAYOUTS
from gubernator_tpu_torch.ops.layout import (
    SLOT_DTYPES,
    RequestBatch,
    SlotTable,
    batch_prefix,
    batch_to_device,
)
from gubernator_tpu_torch.runtime.pager import wide_zeros
from gubernator_tpu_torch.runtime.topology import SingleChipTopology
from gubernator_tpu_torch.utils import clock as _clock


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
    layout: str = "fused"  # "fused" or "narrow"
    # ---- paged table (GUBER_TABLE_PAGE_*) ----
    # Groups per page: 0 keeps the flat table; > 0 carves the device
    # table into pages behind a page map, with a host cold tier for
    # demoted pages. num_groups stays the logical keyspace.
    page_groups: int = 0
    # Resident frames on the device; required > 0 when page_groups > 0.
    # Device table bytes = page_budget x page_groups x ways x bytes/slot.
    page_budget: int = 0
    # Background demoter cadence. The demoter is gated by the table
    # census, which is not ported: only 0 (demand demotes) is served.
    page_demote_interval_s: float = 0.0


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
    and notify overhead; the bulk's one Future resolves at the end)."""

    __slots__ = ("value", "_done")

    def __init__(self):
        self.value = None
        self._done = False

    def set_result(self, v) -> None:
        self.value = v
        self._done = True

    def done(self) -> bool:
        return self._done


class _Bulk:
    """A bulk queue entry: N (req, _Slot) pairs resolved by one Future."""

    __slots__ = ("work", "slots", "future")

    def __init__(self, work, slots, future):
        self.work = work
        self.slots = slots
        self.future = future

    def resolve(self) -> None:
        if not self.future.done():
            self.future.set_result([
                s.value if s.done() else RateLimitResp(error=ERR_ENGINE_DRAINING)
                for s in self.slots
            ])


_FLUSH = object()
_STOP = object()


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
        if cfg.page_groups > 0 and cfg.page_demote_interval_s > 0:
            raise NotImplementedError(
                "page_demote_interval_s > 0: the background demoter comes "
                "with the table-census slice; pass 0 (pages demote on demand)"
            )
        self.cfg = cfg
        self.now_fn = now_fn
        self.K, self._pager = self.topo.build_kernels(cfg)
        self.K.load(self.device)
        self.table = self.K.create(cfg.num_groups, cfg.ways, self.device)
        # the GLOBAL replica tier: None on every topology until it is ported
        self._rtier = self.topo.build_replica(cfg)

        self._lock = threading.Lock()  # the table
        self._keys_lock = threading.Lock()  # the host key dictionary
        self._key_strings: Dict[Tuple[int, int], str] = {}
        self._stats_lock = threading.Lock()
        self._stats = dict(
            flushes=0, waves=0, kernel_launches=0, requests=0,
            cache_hits=0, cache_misses=0, unexpired_evictions=0, over_limit=0,
        )

        self._queue: "queue.SimpleQueue" = queue.SimpleQueue()
        self._running = True
        self._bulks: List[_Bulk] = []
        self._bulks_lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._pump, name=self.topo.thread_name, daemon=True
        )
        self._thread.start()

    # -- public intake -------------------------------------------------------

    def check_async(self, req: RateLimitReq) -> "Future[RateLimitResp]":
        """Enqueue one request; resolves after its wave executes."""
        fut: Future = Future()
        if not self._running:
            fut.set_result(RateLimitResp(error=ERR_ENGINE_DRAINING))
            return fut
        err = validate_request(req)
        if err is not None:
            fut.set_result(RateLimitResp(error=err))
            return fut
        if req.created_at is None:
            req.created_at = self.now_fn()
        self._queue.put((req, fut))
        return fut

    def check_bulk(self, reqs: Sequence[RateLimitReq]) -> "Future[List[RateLimitResp]]":
        """Bulk check: ONE queue entry and ONE Future for N requests.
        Resolves in request order."""
        out: Future = Future()
        if not self._running:
            out.set_result([RateLimitResp(error=ERR_ENGINE_DRAINING) for _ in reqs])
            return out
        slots: List[_Slot] = []
        work = []
        now = None
        for req in reqs:
            slot = _Slot()
            slots.append(slot)
            err = validate_request(req)
            if err is not None:
                slot.set_result(RateLimitResp(error=err))
                continue
            if req.created_at is None:
                if now is None:
                    now = self.now_fn()
                req.created_at = now
            work.append((req, slot))
        if work:
            self._queue.put(_Bulk(work, slots, out))
        else:
            out.set_result([s.value for s in slots])
        return out

    def check_batch(self, reqs: Sequence[RateLimitReq]) -> List[RateLimitResp]:
        """Synchronous batched check (returns in request order)."""
        return self.check_bulk(reqs).result()

    def close(self, timeout_s: float = 60.0) -> None:
        """Serve everything queued before this call, then stop the pump.
        Entries that race the shutdown fail with the typed retryable
        status (ERR_ENGINE_DRAINING)."""
        self._queue.put(_STOP)
        self._thread.join(timeout=timeout_s)
        self._running = False
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
        """Counters: flushes, waves, kernel_launches, requests, and the
        decide metrics (cache hits/misses, unexpired evictions,
        over-limit answers); with a paged table also the pager's
        promotes, demotes, binds, resident_pages and host_pages."""
        with self._stats_lock:
            out = dict(self._stats)
        pager = self._pager
        if pager is not None:
            out.update(
                promotes=pager.promotes, demotes=pager.demotes, binds=pager.binds,
                resident_pages=pager.resident_count(), host_pages=pager.host_count(),
            )
        return out

    # -- pump ----------------------------------------------------------------

    def _pump(self) -> None:
        carry: List[Tuple[RateLimitReq, object]] = []
        while self._running:
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
            flush = item is _FLUSH or self._extend(batch, item)
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
                if nxt is _FLUSH or self._extend(batch, nxt):
                    break
            if batch:
                carry = self._serve(batch)
        # Shutdown: serve the carry and everything still queued (FIFO puts
        # every entry enqueued before close() ahead of _STOP's successors).
        pending = list(carry)
        while True:
            try:
                entry = self._queue.get_nowait()
            except queue.Empty:
                break
            if entry is not _STOP and entry is not _FLUSH:
                self._extend(pending, entry)
        while pending:
            batch = pending[: self.cfg.max_flush_items]
            pending = self._serve(batch) + pending[self.cfg.max_flush_items:]

    def _extend(self, batch: list, entry) -> bool:
        """Add a queue entry (single pair or bulk); True if it asks for an
        immediate flush (NO_BATCHING)."""
        nb = int(Behavior.NO_BATCHING)
        if type(entry) is _Bulk:
            batch.extend(entry.work)
            with self._bulks_lock:
                self._bulks.append(entry)
            return any(r.behavior & nb for r, _ in entry.work)
        req, fut = entry
        batch.append((req, fut))
        return bool(req.behavior & nb)

    def _serve(self, batch) -> list:
        """One flush; never lets an error kill the pump. Returns carry."""
        try:
            carry = self._process(batch)
        except Exception as e:
            for _, fut in batch:
                if not fut.done():
                    fut.set_result(RateLimitResp(error=str(e)))
            carry = []
        self._sweep_bulks()
        return carry

    def _sweep_bulks(self) -> None:
        """Resolve bulk futures whose members have all been answered."""
        done = []
        with self._bulks_lock:
            still = []
            for b in self._bulks:
                (done if all(s.done() for s in b.slots) else still).append(b)
            self._bulks[:] = still
        for b in done:
            b.resolve()

    # -- one flush -----------------------------------------------------------

    def _process(self, items: List[Tuple[RateLimitReq, object]]) -> list:
        """Assemble + encode the flush on the host, run its waves, read
        the decisions back, resolve the futures. Returns the (req,
        future) pairs the wave cap deferred to the next flush."""
        now = self.now_fn()
        cfg = self.cfg
        hi_a, lo_a, grp_a = key_hash128_batch(
            [req.hash_key() for req, _ in items], cfg.num_groups
        )
        hi_l, lo_l, grp_l = hi_a.tolist(), lo_a.tolist(), grp_a.tolist()
        self._maybe_prune_key_strings()

        asm = _WaveAssembler(RequestBatch.zeros, cfg.batch_size)
        placements: List[Optional[Tuple[int, int]]] = []
        wave_rows: List[list] = []  # per-wave (req, hi, lo, grp) for encode_rows
        wave_lanes: List[list] = []
        greg = int(Behavior.DURATION_IS_GREGORIAN)
        carry: List[Tuple[RateLimitReq, object]] = []
        new_strings: Dict[Tuple[int, int], str] = {}
        for i, (req, fut) in enumerate(items):
            hi, lo, grp = hi_l[i], lo_l[i], grp_l[i]
            new_strings[(hi, lo)] = req.hash_key()
            placed = asm.place(grp, cfg.max_waves)
            if placed is None:
                carry.append((req, fut))
                placements.append(None)
                continue
            wb, w, lane = placed
            if req.behavior & greg:
                # calendar resolution stays per-item (rare path)
                try:
                    encode_one(wb, lane, req, now, cfg.num_groups, key=(hi, lo))
                except EncodeError as e:
                    fut.set_result(RateLimitResp(error=str(e)))
                    placements.append(None)
                    continue
            else:
                while len(wave_rows) < len(asm.waves):
                    wave_rows.append([])
                    wave_lanes.append([])
                wave_rows[w].append((req, hi, lo, grp))
                wave_lanes[w].append(lane)
            asm.commit(w, grp)
            placements.append((w, lane))

        with self._keys_lock:
            self._key_strings.update(new_strings)
        for w, rows in enumerate(wave_rows):
            if rows:
                encode_rows(asm.waves[w], wave_lanes[w], rows, now)
        # A wave made for an item that then failed to encode may be left
        # empty; only the last wave can be (later items would fill it).
        n_waves = len(asm.waves)
        while n_waves and asm.fill(n_waves - 1) == 0:
            n_waves -= 1
        waves = [batch_prefix(asm.waves[w], asm.fill(w)) for w in range(n_waves)]

        outs, launches = self._execute_waves(waves, now)
        host = self._read_back(outs)

        served = 0
        for (req, fut), place in zip(items, placements):
            if place is None:
                continue  # resolved (encode error) or carried
            st, rem, rst, lim = host[place[0]][:4]
            lane = place[1]
            fut.set_result(RateLimitResp(
                status=int(st[lane]),
                limit=int(lim[lane]),
                remaining=int(rem[lane]),
                reset_time=int(rst[lane]),
            ))
            served += 1
        with self._stats_lock:
            s = self._stats
            s["flushes"] += 1
            s["waves"] += len(waves)
            s["kernel_launches"] += launches
            s["requests"] += served
            for h in host:
                s["cache_hits"] += h[4]
                s["cache_misses"] += h[5]
                s["unexpired_evictions"] += h[6]
                s["over_limit"] += h[7]
        return carry

    def _execute_waves(self, waves, now: int):
        """Run decide over the scatter-disjoint waves, in order, under the
        table lock. Returns (per-wave DecideOutputs, kernel launches).
        If a wave fails after earlier waves committed, raises
        TableCommittedError so no caller retries the batch."""
        outs = []
        launches = 0
        with self._lock, self.topo.dispatch_guard():
            try:
                for wb in waves:
                    if self._pager is not None:
                        # Promote every page this wave touches BEFORE its
                        # decide, from the host batch (a wave over the
                        # budget raises PageBudgetError).
                        self.table = self._pager.ensure_resident(
                            self.table, self._pager.touched_pages(wb.group, wb.active)
                        )
                    db = batch_to_device(wb, self.device)
                    before = cuda_decide.thread_launches()
                    self.table, out = self.K.decide(self.table, db, now, self.cfg.ways)
                    launches += cuda_decide.thread_launches() - before
                    outs.append(out)
            except Exception as e:
                if outs:
                    raise TableCommittedError(str(e)) from e
                raise
        return outs, launches

    def _read_back(self, outs) -> list:
        """The flush's decisions to the host: every wave's copies queued
        without blocking, then ONE synchronisation."""
        fields = [
            (o.status, o.remaining, o.reset_time, o.limit,
             o.hits, o.misses, o.unexpired_evictions, o.over_limit)
            for o in outs
        ]
        if self.device.type == "cuda":
            fields = [tuple(t.to("cpu", non_blocking=True) for t in f) for f in fields]
            torch.cuda.current_stream(self.device).synchronize()
        return [
            tuple(t.numpy() for t in f[:4]) + tuple(int(t) for t in f[4:])
            for f in fields
        ]

    def _maybe_prune_key_strings(self) -> None:
        """Bound host memory: when the hash->string dictionary exceeds
        twice the slot count, rebuild it from the table's live keys."""
        n = self.cfg.num_groups * self.cfg.ways
        if len(self._key_strings) <= max(2 * n, 4096):
            return
        with self._lock:
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
        with self._lock:
            wide = self.K.to_wide(self.table)
            host = {
                f: getattr(wide, f).to("cpu", copy=True).numpy()
                for f in SlotTable._fields
            }
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
        if self._pager is not None:
            self._restore_paged(wide)
        else:
            table = self.K.from_wide(wide, self.device)
            with self._lock:
                self.table = table
        with self._keys_lock:
            self._key_strings = dict(snap.get("key_strings", {}))

    def _restore_paged(self, wide: SlotTable) -> None:
        PK = self.K
        ps = PK.page_slots
        n = wide.num_slots
        with self._lock:
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


class DeviceEngine(MeshEngine):
    """MeshEngine at mesh shape (1,): the single-device engine that
    V1Service and the tests construct, its table on `EngineConfig.device`
    (the default topology). Every behaviour lives in the core."""
