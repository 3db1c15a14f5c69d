"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Builds the port's native code from the checkout (the CUDA decide-wave
kernel, four configurations, the decide-scan kernel, four
configurations at two block sizes, and the sharded decide-wave kernel,
two configurations, which also serves the GLOBAL replica tier's waves
(row 5r), one nvcc per source, all built for sm_90a and
linked into one library, and the key hasher and the wire path with
g++, every compiler started at once; the build line gives each
kernel's registers, spills and static shared memory), then drives it
at two sizes and prints one JSON line per phase:

- 1M (BASELINE.json config 3, "1M-key Zipfian"): a flat table of 2^18
  groups x 8 ways holding 1,000,000 live keys; kernel configurations
  fused (`decide_wave`, 167.8 MB) and narrow (`decide_wave_narrow`,
  151.0 MB).
- 10M (BASELINE.json config 5, 10M keys Zipfian, paged as in
  docs/config.md "GUBER_TABLE_PAGE_*"): 2^22 logical groups x 8 ways
  (33,554,432 slots) holding 10,000,000 live keys, 4,096 groups per page
  (1,024 logical pages of 32,768 slots), 768 frames on the card (2,013
  MB fused, 1,812 MB narrow); the other pages live in the host tier.
  Kernel configurations fused paged (`decide_wave_paged`) and narrow
  paged (`decide_wave_narrow_paged`).

Phases, for each size:

1. kernel: each configuration against its plain PyTorch version on the
   card, 16 waves of 1024 lanes, bit-exact on every output field, the 9
   scalars, the whole physical table and (paged) the unchanged page map
   (tolerance: none, all int64). The paged tables map 768 random logical
   pages onto the frames in a scrambled order, so about a quarter of the
   lanes are sentinel lanes. Then two more waves of 1024 lanes for the
   team of threads per lane, each on its own table of 4,096 groups
   (paged: 3/4 of 64 pages resident, scrambled): a tie-heavy wave (8
   ways: groups all empty, all expired, all live with one LRU stamp, one
   key live at two ways, a key expired beside its live copy, a mix) and
   a wave of a 4-way table (a team of 4), bit-exact against the plain
   version in the same way (`tie_wave`, `ways4_wave`).
2. times, over fresh waves at B = 1024 (paged: groups on resident pages
   only, as the main path runs them): the kernel's median device time
   per launch (CUDA events, L2 flushed before each, device held busy
   while the host enqueues, the one-wave flush made and its sums zeroed
   before the window), the median of the whole launch path (the
   engine's: one wave of a `WaveFlush` over the 200 waves, whose batch
   went to the card in one copy and whose outputs are one allocation;
   and, beside it, the one-wave wrapper's, a flush of one wave), the
   median of 5 runs of 200 back-to-back launches, the kernel's device
   time from torch.profiler, the plain version's median and the byte
   bound, which counts the live matches each timed launch found; and a
   B sweep, events and profiler time per wave at B = 128, 1024 and 4096.
3. scan_kernel: the scan kernel (`decide_scan.cu`, T = 32 waves in one
   cooperative launch, a team of threads per lane in a persistent grid,
   each step's batch columns and page words staged before its barrier)
   of each configuration of the size against its plain version
   (`scan_plain`) and against 32 successive launches of the wave kernel,
   each on its own copy of the table: 32 steps of 4,096 lanes drawn as
   the bench draws them (the Zipf head's groups recur in consecutive
   steps), bit-exact on every (T, B) field, the (T,) sums, the whole
   physical table and the page map; exactly one launch per scan. The
   steps carry the bench's `kernel10m` (BASELINE config 5) behavior mix,
   RESET_REMAINING and DRAIN_OVER_LIMIT beside plain lanes, so every
   behavior the bench runs is held against the plain version on the
   card. Flat on the 1M image; paged on the 10M frames with the
   scrambled map, so sentinel lanes occur. Then four more scans, each
   on its own table (paged: 3/4 of its pages resident, scrambled) and
   held the same way (`scan_team_checks`): a tie-heavy scan (8 ways), a
   scan of a 4-way table (a team of 4), a 32-way scan at B = 4,096 whose
   items outnumber the co-resident blocks, so the blocks stride
   (checked with the launch's own grid, `scan_grid`), and a scan of one
   step.
4. scan_times: the scan's device ms per scan and per step (CUDA events,
   L2 flushed, device held busy while the host enqueues; and
   torch.profiler's kernel time), a profiler trace that shows one scan
   to be one device operation (the kernel: no memset, no other kernel;
   traced in a fresh process of this script, `--scan-op-counts`, run
   before the sizes: in a long run CUPTI has been seen to lose scan
   records, once as early as the 10M size's second scan),
   the same 32 waves as 32 wave-kernel launches (events, and the
   profiler's summed kernel time), the plain version's ms and the byte
   bound summed over the steps. Paged scans are timed on groups of
   resident pages, as the bench runs them. Then team_vs_scan: the two
   team kernels in this run at B = 4096, the wave kernel's profiler time
   per launch (the B sweep's fresh waves, and on the scan's own steps)
   beside the scan kernel's per step.
5. main_path: `V1Service.get_rate_limits` over a CUDA `DeviceEngine` in
   each configuration, 8 calls of 1,000 Zipf(1.1) items (2 at 10M, whose
   phases all serve those 2), against one CPU
   engine (flat, fused: the plain version) on the same calls and frozen
   clock: every response and the final snapshot equal, kernel launches
   of that configuration equal to waves and > 0, and (paged) pages
   promoted and demoted, with host-clock spans of the pager's
   ensure_resident, demote and promote.
6. mesh_kernel, per layout: the sharded kernel (`decide_sharded.cu`,
   the mesh tier's `raw_decide_flat` per shard plus the psum, one launch
   for 8 shards of the table on the card) against its plain version
   (the masked wave on every shard's rows, then the sum) and the wave
   kernel of the same table, 16 waves of 1024 lanes: bit-exact on every
   output field and the 9 scalars, the three tables equal after every
   wave, and the wave kernel's answers equal on every owned lane with
   the psum's slot. Flat on the 1M image; on the 10M frames with the
   scrambled map, whose non-resident lanes no shard owns. Then phase 1's
   tie-heavy and 4-way waves through the sharded kernel (8 shards).
7. mesh_times: phase 2's times for the sharded kernel (8 shards).
8. mesh_main_path: `V1Service` over an `IciEngine` of 8 shards on the
   card per configuration (1M flat; 10M paged, 96 frames of the 768 per
   shard), on phase 5's calls and clock, against phase 5's CPU engine:
   every response and the snapshot equal, one sharded-kernel launch per
   wave, no other configuration launched.
9. edge_main_path: the same calls as GetRateLimitsReq bytes (a varint
   encoder here; the card's machine has no protobuf) through
   `serve_get_rate_limits_bytes`, the columnar edge. First the
   mechanism check, at max_waves = 1000 so that a call fits one flush
   (the calls' hottest key repeats about 120 times): on a CPU engine,
   whose answers must equal the CPU object path's in the edge's order
   (the Gregorian items after the columnar decide), then on the card on
   a DeviceEngine per configuration and an IciEngine per layout: the
   CPU edge's response bytes and snapshot (key strings included), one
   launch per wave and no other configuration's, every call that is
   not all-Gregorian served by one columnar flush, the Gregorian items
   spliced through the object path; decisions/s and seconds. Then the
   same engines at the default max_waves (32), what a deployment runs:
   the edge declines every such call and the object path serves it
   from the native parse, bytes and snapshot equal to the main path's
   CPU reference, no columnar flush; its decisions/s is the edge's
   served rate for this traffic.
10. pipeline: phase 5's object path at pipeline_depth 1 and 2, in turns
   1, 2, 2, 1 (1 on the paged engines at 10M, whose depth-2 run is the
   main path's), on every engine of phase 9 (same calls, frozen clock):
   responses and snapshot equal to the CPU engine's at both depths,
   launches = waves; per run the most flushes in flight (from the end
   of a flush's dispatch to the end of its completion, as the JAX
   engine counts them), the host spans of the two stages (`_dispatch`,
   `_complete`), decisions/s and, paged, the pager's spans. Then a
   last, held run at depth 2: each flush's device work held about 20
   ms longer on the engine's stream, so the device is the bottleneck;
   answers equal, and on a flat table two flushes in flight (a paged
   table's demote waits on the stream inside dispatch: reported only).
   Every run also prints the engine's stage trace (`stages`: the
   stage_duration histogram's count, p50, p99 and mean per stage:
   intake, assemble, dispatch, inflight_wait, device_sync, resolve) and
   the median of `pipeline_overlap`.
   Phases 5 and 8 run at the engines' default depth, 2.
11. census: after each serving run of phases 5 and 8, on that live
   engine (its background demoter stopped first, so the table holds
   still), `table_census(max_age_s=0)` and `admission_snapshot(
   max_age_s=0)` against the port's numpy oracles over the same table
   copied to the host, field for field (tolerance: none); then each
   scan's device time (CUDA events, L2 flushed, the stream held busy
   while the host enqueues, median of 10), the host time of a whole
   snapshot with its read-back, the device memory one scan adds at its
   peak, and the byte bound (the scanned table read once at 3.35 TB/s);
   the 10M mesh engines' scans are checked but not timed again (the
   DeviceEngines' lines time the same programs over a table of the same
   size).
12. wavescan_oracles, after phase 1 for each wave configuration (rows
   1-3b): 4 waves of the wave kernel, each wave's five WaveScan sums
   against the admission and census oracles over the rows it wrote
   (`gather_rows(table, out.slot)`), as the JAX package's kernel fuzz
   holds its kernel. The sharded kernel is left out (its psum'd slot is
   not a global slot index).
13. page_moves, at 10M for each layout: the insides of 16 demotes and
   promotes of a 32,768-slot page, medians on the host clock and CUDA
   events: the one-copy path the pager runs (`read_page`, `write_page`)
   beside the per-column path it replaced (written in the phase), the
   frame's zeroing and the page-map write; the host rows of both demote
   paths bit-equal.
14. demoter, at 10M (fused) on a DeviceEngine and an IciEngine of 8
   shards: the census-gated background demoter (every 0.05 s, 8 free
   frames, per shard on the mesh) must move no page while every slot is
   hot, must reach its target once the clock makes the slots of shorter
   windows census-cold, taking exactly the census-coldest pages its rule
   picks, and must lose no key: every answer and the final snapshot
   equal a flat engine's on the same calls and clock.
Phase 9's run at the default max_waves is made at the engines' default
demoter setting (every 2 s on a paged table, as the JAX package runs
it).

Then the bench (`gubernator_tpu_torch/bench.py`, the port of the repo's
`bench.py` device modes), each run with the launch counts set to 0 just
before it and read just after: `kernel` (1M keys) and `kernel10m` (10M
keys) for both layouts on flat tables, and `latency` (fused). Each flat
run is replayed on a CPU table through the plain version and must leave
the same table and eviction count. Then a drive of the paged scan
kernels (no deployment runs it): the `kernel10m` traffic on a paged
table of 512 pages of 4,096 groups, every page resident, for both
layouts, which must leave exactly the flat run's table. Each line is
printed as a phase line with the scan launches it made.

Then, after the bench, the GLOBAL replica tier on the 1M size's image
and calls (`parallel/ici.py`; bench.py's replica geometry: 8 replicas
of 2^20 slots at 4 ways, one per shard):

15. replica_kernel, per layout (kernel row 5r): the sharded kernel over
   the 8 replicas stacked on the card, each lane's group the pair home *
   num_rgroups + slot, 32 waves of 4,096 GLOBAL lanes (Zipf(1.1) over
   500,000 keys, homes uniform, RESET_REMAINING, leaky keys, 5% of the
   lanes on keys crowding 64 groups so that inserts evict), against its
   plain version (`sharded_plain` on a second copy, then the same
   pending bookkeeping): bit-exact on every output, the 9 sums, the
   stacked table and `pending` after every wave, exactly one launch per
   wave, evictions and freed slots seen. Then replica_times: the
   kernel's events and profiler time per wave, the engine's path per
   wave (kernel and pending ops), device operations per replica wave,
   the plain version's time and the byte bound as for row 5.
16. sync_tick (fused): at 8 x 2^20 slots the capped tick (65,536 groups)
   and the full tick, each first enqueued under torch's sync debug mode
   "error" and held bit-equal (table, pending, tick, diag) against the
   same tick of the port on a host copy of the state; then per variant
   (and the capped tick at 8 x 2^22) device ms per tick (events, the
   stream held busy, median of 6, each after a fresh traffic step of 32
   waves) against the 100 ms cadence, host enqueue and wall ms, device
   operations per tick, the peak memory a tick adds and its byte bound.
   Then replica_ops at 8 x 2^20: one inject of 4,096 authoritative rows
   into every replica and the stacked census and admission scans of
   replica 0 (device ms, device operations, byte bound).
17. global_main_path: `IciEngine` on 8 shards of the card (the 1M
   sharded table restored from the main path's image, and the replica
   tier) per layout, on the main path's first 2 calls: (a) every item GLOBAL
   (`V1Service(force_global=True)`), (b) half of them, so one flush
   feeds both tiers; each through the object path and over wire bytes
   at the default max_waves, sync_now() after every 2nd call; against
   a CPU `IciEngine` of the same geometry on the same calls, clock and
   ticks: answers, sharded snapshot and replica stack equal, the
   replica kernel launched once per replica wave and the sharded one
   once per table wave, decisions/s and the calls served columnar.
18. global_cadence: the same engine (fused) with its sync thread at 100
   ms on the wall clock, 3 s of (a), two idle cadences, one more
   sync_now() and close(): every replica equal, no pending left,
   overflow_keys 0, the thread stopped, and the census and admission
   snapshots' replica tier equal to the numpy oracles over replica 0;
   ticks run and the host ms of a sync_now.

The Store and Loader seams (store/store.py, the engine's per-wave store
path), after the GLOBAL phases, on each size's main-path calls (their
many small device operations come after every exact profiler count:
CUPTI has been seen to lose scan records after such runs):

19. store_path, per size: a ColumnStore (a Store holding a snapshot of
   every key the calls can name, "smoke_acct:{k}" up to the size's live
   keys, drawn as the image's rows, 10% with invalid_at marks, half in
   the past and half inside the calls' span) and, per configuration, a
   fresh DeviceEngine (rows 1-3b) and an IciEngine of 8 shards (row 5)
   on the card attached to it: the main path's first 2 calls at max_waves
   1,000, the first through V1Service, the other as wire bytes
   through the columnar edge; against the port's CPU engine of the same
   kind and paging (fused) on the same calls, clock and store (a demote
   drops a page left with no live row, so only a table paged alike
   keeps the same dead rows; a mesh's stored keys depend on where its
   frames lie):
   every answer, the wide image with its key strings, the store's
   changes and removals, and per call its gets, change calls and rows
   read through; launches equal to the table waves, two read-backs a
   wave, every body that is not all-Gregorian one columnar flush;
   decisions/s and the host ms of each step of the store path (probe
   and read-back, Store.get, inject, the decide's launch, gather and
   read-back, write-behind). No background demoter in this phase.
20. loader, at 1M per layout: `load_engine` of 1,000,000 snapshots of
   keys that fit the table into a fresh DeviceEngine on the card
   (seconds, inject waves), `save_engine` (equal to what was loaded, key
   for key), then the main path's first call, answered as a CPU engine
   loaded the same way answers it.

Then 21. store_ops: the store path's torch ops
(`probe_exists`, `inject`, `gather_rows`) at B = 1,024 on a table of
each size and layout, alone and as the 8-shard mesh: device ms,
device operations per call (counted in a fresh process of this script,
`--store-op-counts`: late in the run CUPTI loses records) and the byte
bound. The kernels line gives
rows 1-3b and 5 their launches on the store path
(`store_path_launches`).

Then 22. layouts: the JAX package's wide and packed layouts, torch
ops on DeviceEngine (no hand kernel: they are XLA programs in the JAX
package), at each size (1M flat; 10M paged, the pages moving on demand,
no background demoter), on the first 250 items of the main path's
calls and its clock: the first call as objects, the next as wire bytes
through the columnar edge (max_waves 1,000), then a restart: the live
keys' snapshots saved to a MemoryLoader (`save_engine`) and loaded into
a fresh engine (`load_engine`), which answers the first call again.
Each layout's card
engine against a fused DeviceEngine on the card fed the same (every
answer and response byte equal; the fused engine launches its kernel
once a wave) and a CPU engine of the same layout and paging (answers,
the wide table with its key strings, the census snapshot, its device
tier scanned on the CPU by the numpy oracle, and the MemoryLoader's
snapshots equal); no hand kernel launched; 83 and 72 B a slot;
decisions/s of each path. Then each layout's ops at B = 1,024 on that
card table (the decide wave, a scan of 4 waves, the store path's
inject, probe and gather, the census): device ms (events, L2 flushed,
the stream held while the host enqueues, median of 10), device
operations per call (torch.profiler, in store_ops' fresh process:
`--store-op-counts`, or `--layout-op-counts` alone) and the byte
bound. `--only-layouts` runs the build and this phase alone.

Then the observability core (metrics.py, the engine's telemetry, the
watchdog, device memory), with no profiler, after every exact count:

23. metrics, per size: the main path's calls as objects, then as bytes
   at the default max_waves (32), on each engine of the size
   (DeviceEngine and IciEngine of 8 shards, fused and narrow), each
   with a `Metrics` wired (`wire_engine_telemetry`, `V1Service(...,
   metrics=)`) and a started `Watchdog`, then `render()`: every line of
   the exposition parses; the cache, over-limit, command and
   unexpired-eviction counters equal the engine's stats() and a CPU
   DeviceEngine's (fused, paged as the size's engines are) on the same
   calls and clock, whose answers the card's equal; the flush_waves
   count equals the flushes, each stage's count the flushes (or bulks)
   that pass it; the flush durations sum to no more than the calls'
   wall time; `device_memory()` reads the caching allocator
   (`allocated_bytes.all.current`) and its slot_table equals the
   table's tensors' bytes, no more than in use; the pump's, the
   completion thread's, the sync thread's (mesh) and the demoter's
   (paged) beats arrive and no serving loop stalls; one launch per
   wave. Per engine decisions/s (objects, bytes), the resolve stage's
   host ms per flush (mean, p50), the stage trace, the render's
   seconds and the garbage collections during the calls.
24. telemetry_ab, at 1M: the hot-key sketch (the telemetry's per-item
   part) on and off (`hotkeys_k` 128, 0, 0, 128) on a fresh
   DeviceEngine (fused) per turn, the main path's calls as objects:
   answers equal to the CPU engine's; decisions/s, the resolve stage
   and the garbage collections per turn.
25. latency, at 1M: the first p99 GetRateLimits. 1,000 calls of 10
   Zipf(1.1) items (the main path's mix) from 16 concurrent asyncio
   callers, as objects and as bytes, each on a fresh DeviceEngine and
   IciEngine (fused, max_waves 32, the default depth) with a Metrics:
   per call the host clock's p50, p99, max and mean, decisions/s, the
   stage trace (p50 and p99 per stage), pipeline_overlap's median and
   the garbage collections; every item answered without an error, one
   launch per wave.

Then the overload control plane and the SLO observatory
(service/overload.py, service/slo.py), last, with no profiler in this
process:

26. overload, at 1M (fused): (1) the plane armed as the JAX daemon arms
   it (a Watchdog, an SloObservatory sampling every 0.5 s, an
   IntakeGovernor of limit 8,192 and target 20 ms on the engine, the
   brownout ladder every 0.25 s), the main path's calls as objects on a
   DeviceEngine and an IciEngine of 8 shards, the collector held off:
   answers and table equal to the CPU engine's, one launch per wave, no
   shed, the ladder and the sampler beating, the ladder at level 0 (on
   the mesh it may move on the shard-balance SLO alone: the Zipf head
   skews the shards' decisions); (2) on each, expired deadlines through
   check_async and check_bulk, and live ones expired at the pump's
   pickup, answered with the JAX package's refusal and no flush, wave
   or launch; a mixed bulk serves its live members; the shed counts of
   `overload_debug_info()` equal the exposition's; (3) the flood
   (tools/jobs/45_overload_soak.py's shape, in process, on a
   DeviceEngine whose flushes take at most 4 items): 4 closed-loop good
   tenants of 2 items a call, then one open-loop flood tenant of
   per-item check_async at 10x their offered rate for 8 s, its sheds
   re-sent once through a RetryBudget, intake limit 256, target 15 ms,
   the ladder every 0.1 s, the sampler on, fresh keys each in a group of
   the image that holds no row: the queue depth stays within the limit,
   every admitted answer is UNDER_LIMIT, every shed is typed and
   counted, admits and sheds add up to the answers, the shed counts of
   debug_info equal the exposition's, and the table equals a CPU
   engine's fed exactly the admitted items; goodput and p50/p99 of the
   good tenants against their baseline, the levels the ladder reached
   and its level when the flood's last answer is in are printed, not
   gated; (4) the host cost per item of the governor alone and of the
   whole plane armed and idle, against unarmed, in turns on one engine,
   answers equal every turn; (5) the SLO sampler's
   passes (sample_once, evaluate, metrics_sync, render, 100 times over a
   warmed engine) under torch.profiler in a fresh process of this script
   (`--slo-op-counts`): no device operation but the marker fills.

Then a summary line with the wall time, the card's name and power limit
as nvidia-smi prints them, the kernel table line, and the last line
`{"ok": true, "device": {"platform": "gpu", ...}}`. Any failure raises
and the script exits non-zero. It needs one card; without one it exits
with code 2 before printing anything to stdout. The phase lines are also
written to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import gc
import json
import operator
import os
import re
import statistics
import subprocess
import sys
import threading
import time
from typing import NamedTuple, Tuple

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is False; needs one GPU",
          file=sys.stderr)
    sys.exit(2)

from gubernator_tpu_torch import bench  # noqa: E402
from gubernator_tpu_torch.api.keys import key_hash128_batch  # noqa: E402
from gubernator_tpu_torch.api.types import (  # noqa: E402
    ERR_OVERLOADED,
    MAX_BATCH_SIZE,
    RETRY_AFTER_MD_KEY,
    RateLimitReq,
    RateLimitResp,
    is_retryable_error,
)
from gubernator_tpu_torch.ops import _build, cuda_decide, fused, narrow  # noqa: E402
from gubernator_tpu_torch.ops.admission import admission_oracle  # noqa: E402
from gubernator_tpu_torch.ops.census import CensusOutput, census_oracle  # noqa: E402
from gubernator_tpu_torch.ops.inject import INJECT_DTYPES, InjectBatch  # noqa: E402
from gubernator_tpu_torch.ops.kernels import (  # noqa: E402
    BYTES_PER_SLOT,
    get_admission,
    get_census,
    get_kernels,
    get_paged_kernels,
)
from gubernator_tpu_torch.ops.layout import (  # noqa: E402
    BATCH_DTYPES,
    SLOT_DTYPES,
    RequestBatch,
    SlotTable,
    batch_to_device,
    stack_batches,
)
from gubernator_tpu_torch.ops.paged import PagedTable  # noqa: E402
from gubernator_tpu_torch.parallel import ici  # noqa: E402
from gubernator_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from gubernator_tpu_torch.metrics import Metrics, wire_engine_telemetry  # noqa: E402
from gubernator_tpu_torch.runtime.engine import DeviceEngine, EngineConfig  # noqa: E402
from gubernator_tpu_torch.runtime.ici_engine import IciEngine, IciEngineConfig  # noqa: E402
from gubernator_tpu_torch.runtime.watchdog import Watchdog  # noqa: E402
from gubernator_tpu_torch import wire  # noqa: E402
from gubernator_tpu_torch.store import (  # noqa: E402
    ItemSnapshot,
    MemoryLoader,
    attach_store,
    load_engine,
    save_engine,
)
from gubernator_tpu_torch.service.overload import (  # noqa: E402
    DEADLINE_MD_KEY,
    ERR_DEADLINE_EXPIRED,
    SHED_REASONS,
    IntakeGovernor,
    OverloadManager,
    RetryBudget,
)
from gubernator_tpu_torch.service.server import (  # noqa: E402
    V1Service,
    serve_get_rate_limits_bytes,
)
from gubernator_tpu_torch.service.slo import SloObservatory, parse_slo_specs  # noqa: E402
from gubernator_tpu_torch.utils import clock as _clock  # noqa: E402


class Size(NamedTuple):
    name: str
    num_groups: int
    live_keys: int
    page_groups: int  # 0: flat table
    page_budget: int
    configs: Tuple[Tuple[str, bool], ...]  # (layout, paged)
    calls: int = 8  # the main path's calls of ITEMS items


# 10M serves 2 calls (the main path and every phase on its calls): a
# paged engine's run costs seconds a call, and the script has a time
# limit
SIZES = (
    Size("1M", 1 << 18, 1_000_000, 0, 0, (("fused", False), ("narrow", False))),
    Size("10M", 1 << 22, 10_000_000, 4096, 768, (("fused", True), ("narrow", True)), calls=2),
)
WAYS = 8
B = 1024
WAVES = 16
CALLS = 8
ITEMS = 1000
SCAN_T = 32  # steps per scan, as the bench's chunk
SCAN_B = 4096  # lanes per step, as the bench's batch
SCAN_REPS = 20
# Lane counts of the wave and sharded kernels' B sweep (`times`)
SWEEP_B = (128, 1024, 4096)
# Shards of the mesh tier on the one card: the JAX package's mesh size
# (its tests fake 8 devices; the v5e-8 north star)
MESH_SHARDS = 8
NOW = 1_753_700_000_000
# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and the
# non-tensor float32 rate, taken as the scalar-ALU ceiling for the
# wave's integer work.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
# Integer operations one active lane needs: 8-way probe (~20 each), both
# bucket branches' selects (~150), the leaky leak's ten 64-bit divisions
# (~40 each when emulated) and the row pack (~30). An estimate; the byte
# bound is the larger by an order of magnitude either way.
OPS_PER_LANE = 8 * 20 + 150 + 10 * 40 + 30
# Row bytes per active resident lane: the probe columns of each of the W
# ways, the rest of the chosen row (read only on a live match) and the
# new row.
ROW_BYTES = {"fused": (5 * 8, 5 * 8, 80), "narrow": (5 * 8, 4 * 8, 72)}
LAYOUT = {"fused": fused, "narrow": narrow}
CODEC = {"fused": fused.FUSED_CODEC, "narrow": narrow.NARROW_CODEC}
OUT_DIR = "chiprun_out"
DEVICE = torch.device("cuda", 0)
_lines = []


_T0 = time.perf_counter()


def emit(obj) -> None:
    """Print a phase line (with `t_s`, the seconds since the script
    started) and keep it for the JSON file under OUT_DIR."""
    obj = dict(obj, t_s=round(time.perf_counter() - _T0, 3))
    line = json.dumps(obj, sort_keys=True)
    _lines.append(line)
    print(line, flush=True)


def sync() -> None:
    torch.cuda.synchronize()


def free_device() -> None:
    sync()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# seeded data


def live_image(rng, size: Size, ways: int = WAYS) -> SlotTable:
    """Wide numpy image of the logical table of `ways` ways with
    `size.live_keys` keys, each in a free way of its group: mixed
    token/leaky, expiries on both sides of NOW, a few store invalidation
    marks. Limits and bursts stay inside the encode clamp (narrow stores
    them in 32 bits)."""
    ng = size.num_groups
    n = ng * ways
    k = size.live_keys
    cand = k + k // 8
    hi = rng.integers(1, 1 << 62, cand, dtype=np.int64)
    lo = rng.integers(0, 1 << 62, cand, dtype=np.int64)
    grp = lo % ng
    order = np.argsort(grp, kind="stable")
    g_sorted = grp[order]
    first = np.searchsorted(g_sorted, g_sorted, side="left")
    rank = np.empty(cand, np.int64)
    rank[order] = np.arange(cand) - first
    keep = np.nonzero(rank < ways)[0][:k]
    if keep.size != k:
        raise RuntimeError(f"placed only {keep.size} keys")
    slot = grp[keep] * ways + rank[keep]

    col = {f: np.zeros(n, SLOT_DTYPES[f]) for f in SlotTable._fields}
    leaky = rng.random(k) < 0.3
    limit = rng.integers(10, 1001, k)
    duration = rng.integers(1000, 60_001, k)
    burst = np.where(leaky, np.where(rng.random(k) < 0.5, limit, rng.integers(1, 2000, k)), 0)
    tok_rem = rng.integers(0, limit + 1)
    lky_rem = rng.integers(0, (burst << 20) + 1)
    col["key_hi"][slot] = hi[keep]
    col["key_lo"][slot] = lo[keep]
    col["used"][slot] = True
    col["algo"][slot] = leaky.astype(np.int8)
    col["status"][slot] = np.where(leaky, 0, rng.random(k) < 0.1).astype(np.int8)
    col["limit"][slot] = limit
    col["duration"][slot] = duration
    col["remaining"][slot] = np.where(leaky, lky_rem, tok_rem)
    col["stamp"][slot] = NOW - rng.integers(0, 60_000, k)
    col["expire_at"][slot] = NOW + rng.integers(-30_000, 60_000, k)
    col["invalid_at"][slot] = np.where(
        rng.random(k) < 0.02, NOW + rng.integers(-5000, 5000, k), 0
    )
    col["burst"][slot] = burst
    col["lru"][slot] = NOW - rng.integers(0, 120_000, k)
    return SlotTable(**col)


def smoke_wave(rng, image: SlotTable, now: int, num_groups: int, groups=None,
               lanes: int = B, ways: int = WAYS) -> RequestBatch:
    """One full wave: `lanes` (B) distinct groups (random, or `groups`),
    ~60% lanes on a live key of the image (a table of `ways` ways), the
    rest new keys; token/leaky, RESET_REMAINING and DRAIN_OVER_LIMIT,
    negative and zero limits, a few Gregorian lanes and inactive
    (padding) lanes."""
    B = lanes  # noqa: N806
    b = RequestBatch.zeros(B)
    if groups is None:
        groups = rng.choice(num_groups, B, replace=False).astype(np.int64)
    way = rng.integers(0, ways, B)
    slot = groups * ways + way
    reuse = (rng.random(B) < 0.6) & image.used[slot]
    new_lo = groups + num_groups * rng.integers(1, 1 << 40, B)
    b.key_hi[:] = np.where(reuse, image.key_hi[slot], rng.integers(1, 1 << 62, B))
    b.key_lo[:] = np.where(reuse, image.key_lo[slot], new_lo)
    b.group[:] = groups.astype(np.int32)
    b.algo[:] = np.where(reuse, image.algo[slot], rng.random(B) < 0.3)
    flip = rng.random(B) < 0.05  # algorithm switch on a live key
    b.algo[:] = np.where(flip, 1 - b.algo, b.algo)
    b.behavior[:] = rng.choice([0] * 14 + [8, 32, 40, 4], B)
    b.hits[:] = rng.choice([-2, 0, 1, 1, 2, 3, 5, 400], B)
    b.limit[:] = np.where(
        rng.random(B) < 0.08, rng.choice([-100, -1, 0], B),
        np.where(reuse & (rng.random(B) < 0.8), image.limit[slot], rng.integers(10, 1001, B)),
    )
    b.duration[:] = np.where(
        reuse & (rng.random(B) < 0.8), image.duration[slot], rng.integers(1000, 60_001, B)
    )
    greg = (b.behavior & 4) != 0
    b.rate_num[:] = np.where(greg, 3_600_000, b.duration)
    b.eff_duration[:] = np.where(greg, rng.integers(1, 3_600_000, B), b.duration)
    b.greg_expire[:] = np.where(greg, now + b.eff_duration, 0)
    burst = np.where(reuse & (rng.random(B) < 0.7), image.burst[slot], rng.choice([0, 5, 50], B))
    b.burst[:] = np.where((b.algo == 1) & (burst == 0), b.limit, burst)
    b.created_at[:] = now - rng.choice([0, 0, 0, 3, 400], B)
    b.active[:] = rng.random(B) < 0.97
    return b


def scrambled_page_map(rng, size: Size) -> np.ndarray:
    """`page_budget` random logical pages onto the frames in a scrambled
    order; the other pages -1 (not resident)."""
    nlp = -(-size.num_groups // size.page_groups)
    pm = np.full(nlp, -1, np.int32)
    pm[rng.choice(nlp, size.page_budget, replace=False)] = rng.permutation(size.page_budget)
    return pm


def resident_groups(rng, size: Size, page_map: np.ndarray, lanes: int = B) -> np.ndarray:
    """`lanes` distinct logical groups, all on pages the map holds
    resident: the main path's case, where the pager promotes a wave's
    pages before the wave runs, so no lane is a sentinel lane."""
    mapped = np.nonzero(page_map >= 0)[0]
    gpp = size.page_groups
    idx = rng.choice(mapped.size * gpp, lanes, replace=False)
    return mapped[idx // gpp] * gpp + idx % gpp


# The groups of the tie-heavy and 4-way check tables; paged: pages of
# TEAM_GPP groups, 3/4 of them resident
TEAM_GROUPS = 4096
TEAM_GPP = 64


def tie_image(rng, now: int):
    """Wide image of TEAM_GROUPS groups x WAYS built to tie the way
    selection; group g is of kind g % 6: 0 all ways empty; 1 all
    expired; 2 all live with one LRU stamp; 3 one live key at ways 1 and
    W - 1 (the first must win); 4 a key expired at way 0 and live at way
    W - 1; 5 a mix of empty, expired, invalidated and LRU-tied ways.
    Returns the image and each group's tie key (kinds 3 and 4: the
    duplicated key; else the key at a random way)."""
    ng = TEAM_GROUPS
    n = ng * WAYS
    g = np.repeat(np.arange(ng), WAYS)
    w = np.tile(np.arange(WAYS), ng)
    kind = g % 6
    first = g * WAYS
    hi = rng.integers(1, 1 << 62, n, dtype=np.int64)
    lo = rng.integers(0, 1 << 62, n, dtype=np.int64)
    used = kind != 0
    expire = now + rng.integers(1, 60_000, n)
    lru = np.full(n, now - 1000, np.int64)
    inv = np.zeros(n, np.int64)
    expire = np.where(kind == 1, now - rng.integers(1, 1000, n), expire)
    dup = (kind == 3) & (w == WAYS - 1)
    hi[dup], lo[dup] = hi[first[dup] + 1], lo[first[dup] + 1]
    expire = np.where((kind == 4) & (w == 0), now - 5, expire)
    last = (kind == 4) & (w == WAYS - 1)
    hi[last], lo[last] = hi[first[last]], lo[first[last]]
    mix = kind == 5
    used = np.where(mix, rng.random(n) < 0.7, used)
    expire = np.where(mix, now + rng.choice([-50, 40_000], n), expire)
    inv = np.where(mix & (rng.random(n) < 0.2), now + rng.choice([-9, 9], n), 0)
    lru = np.where(mix, now - rng.choice([100, 100, 7000], n), lru)
    leaky = rng.random(n) < 0.4
    limit = rng.integers(1, 50, n)
    col = {f: np.zeros(n, SLOT_DTYPES[f]) for f in SlotTable._fields}
    col.update(
        key_hi=np.where(used, hi, 0), key_lo=np.where(used, lo, 0), used=used,
        algo=leaky.astype(np.int8), limit=np.where(used, limit, 0),
        duration=np.where(used, rng.choice([1000, 60_000], n), 0),
        remaining=np.where(used, np.where(leaky, limit << 19, limit // 2), 0),
        stamp=np.where(used, now - rng.integers(0, 5000, n), 0),
        expire_at=np.where(used, expire, 0), invalid_at=np.where(used, inv, 0),
        burst=np.where(used & leaky, limit, 0), lru=np.where(used, lru, 0),
    )
    col = {f: np.asarray(v, SLOT_DTYPES[f]) for f, v in col.items()}
    gw = np.arange(ng) * WAYS
    way = np.where(np.arange(ng) % 6 == 3, 1, np.where(np.arange(ng) % 6 == 4, 0,
                                                      rng.integers(0, WAYS, ng)))
    return SlotTable(**col), (hi[gw + way], lo[gw + way])


def tie_wave(rng, tie_keys, now: int) -> RequestBatch:
    """B lanes on distinct groups of the tie image: 90% ask their group's
    tie key, the rest a new key; token/leaky, RESET_REMAINING and
    DRAIN_OVER_LIMIT, a few inactive lanes."""
    b = RequestBatch.zeros(B)
    groups = rng.choice(TEAM_GROUPS, B, replace=False)
    ask = rng.random(B) < 0.9
    b.key_hi[:] = np.where(ask, tie_keys[0][groups], rng.integers(1, 1 << 62, B))
    b.key_lo[:] = np.where(ask, tie_keys[1][groups], rng.integers(0, 1 << 62, B))
    b.group[:] = groups.astype(np.int32)
    b.algo[:] = rng.random(B) < 0.4
    b.behavior[:] = rng.choice([0, 0, 0, 8, 32], B)
    b.hits[:] = rng.choice([0, 1, 1, 2, 60], B)
    b.limit[:] = rng.integers(1, 50, B)
    b.duration[:] = rng.choice([1000, 60_000], B)
    b.rate_num[:] = b.duration
    b.eff_duration[:] = b.duration
    b.burst[:] = np.where(b.algo == 1, b.limit, 0)
    b.created_at[:] = now - rng.choice([0, 0, 3], B)
    b.active[:] = rng.random(B) < 0.97
    return b


def team_checks(rng, layout: str, paged: bool, shards: int = 0) -> dict:
    """The team's selection on the card, against the plain version: one
    tie-heavy wave (`tie_image`, 8 ways) and one wave of a 4-way table
    (T = 4), each of B lanes on its own table of TEAM_GROUPS groups
    (paged: a scrambled map of 3/4 of the pages), through the wave
    kernel or with `shards` the sharded one. Bit-exact on every output
    field, the 9 sums and the whole table. Returns each wave's counts."""
    name = cuda_decide.sharded_name(layout) if shards else cuda_decide.config_name(layout, paged)
    res = {}
    for what, ways in (("tie_wave", WAYS), ("ways4_wave", 4)):
        nlp = TEAM_GROUPS // TEAM_GPP
        size = Size(what, TEAM_GROUPS, 2 * TEAM_GROUPS, TEAM_GPP if paged else 0,
                    nlp * 3 // 4 if paged else 0, ())
        if ways == WAYS:
            image, tie_keys = tie_image(rng, NOW)
            hb = tie_wave(rng, tie_keys, NOW)
        else:
            image = live_image(rng, size, ways)
            hb = smoke_wave(rng, image, NOW, TEAM_GROUPS, ways=ways)
        pm = scrambled_page_map(rng, size) if paged else None
        kt, pt = kernel_tables(image, size, layout, pm, ways)
        db = batch_to_device(hb, DEVICE)
        sync()
        before = cuda_decide.CONFIG_LAUNCHES[name]
        ko, ks = run_kernel(kt, db, NOW, layout, size.page_groups, shards, ways)
        po, ps = run_plain(pt, db, NOW, layout, size.page_groups, shards, ways)
        sync()
        err = _max_abs_err(ko, po, ks, ps)
        if not torch.equal(_rows(kt), _rows(pt)):
            rows = int((_rows(kt) != _rows(pt)).any(dim=1).sum())
            raise AssertionError(f"{name} {what}: table differs from the plain version in {rows} rows")
        res[what] = {"ways": ways,
                     "hits": int(po.hits), "misses": int(po.misses),
                     "unexpired_evictions": int(po.unexpired_evictions),
                     "launches": cuda_decide.CONFIG_LAUNCHES[name] - before, "max_abs_err": err}
    return res


def kernel_tables(image: SlotTable, size: Size, layout: str, page_map, ways: int = WAYS):
    """(kernel table, plain table): two equal device copies of the image
    (`ways` ways) in `layout`; paged: the frames hold the mapped logical
    pages."""
    mod = LAYOUT[layout]
    if page_map is None:
        kt = mod.pack_table(image, device=DEVICE)
        return kt, type(kt)(kt.data.clone())
    ps = size.page_groups * ways
    lp_of_frame = np.empty(size.page_budget, np.int64)
    mapped = np.nonzero(page_map >= 0)[0]
    lp_of_frame[page_map[mapped]] = mapped
    idx = (lp_of_frame[:, None] * ps + np.arange(ps)[None, :]).ravel()
    data = mod.pack_table(SlotTable(*(c[idx] for c in image)), device=DEVICE)
    pm = torch.from_numpy(page_map).to(DEVICE)
    kt = PagedTable(data, pm)
    return kt, PagedTable(type(data)(data.data.clone()), pm.clone())


def _rows(table) -> torch.Tensor:
    return table.data.data if isinstance(table, PagedTable) else table.data


def run_kernel(table, db, now: int, layout: str, gpp: int, shards: int = 0, ways: int = WAYS):
    """One wave of the wave kernel, or with `shards` of the sharded
    kernel (MESH_SHARDS shards of the table on the card)."""
    if shards:
        pm = table.page_map if isinstance(table, PagedTable) else None
        return cuda_decide.decide_sharded(_rows(table), pm, db, now, layout=layout, ways=ways,
                                          n_shards=shards, gpp=gpp)
    if isinstance(table, PagedTable):
        _, out, scan = cuda_decide.decide_paged_with_scan(
            table, db, now, layout=layout, ways=ways, gpp=gpp
        )
    else:
        _, out, scan = cuda_decide.decide_flat_with_scan(
            table, db, now, layout=layout, ways=ways
        )
    return out, scan


def run_plain(table, db, now: int, layout: str, gpp: int, shards: int = 0, ways: int = WAYS):
    pm = table.page_map if isinstance(table, PagedTable) else None
    if shards:
        return fused.sharded_plain(CODEC[layout], _rows(table), pm, db, now, ways=ways,
                                   n_shards=shards, gpp=gpp)
    return fused.wave_plain(CODEC[layout], _rows(table), pm, db, now, ways=ways, gpp=gpp)


def resident_lanes(hb: RequestBatch, size: Size, page_map) -> np.ndarray:
    if page_map is None:
        return np.ones(len(hb.active), bool)
    return page_map[hb.group.astype(np.int64) // size.page_groups] >= 0


def wave_bytes(hb: RequestBatch, layout: str, resident: np.ndarray, paged: bool,
               hits: int, freed_bytes: int = 1, ways: int = WAYS) -> int:
    """Bytes one wave must move: each active lane's batch columns read
    once (an inactive lane reads only its `active` flag), every output
    written once, per active resident lane its group's probe columns
    over the W ways and the new row, the rest of the chosen row for each
    of the `hits` lanes with a live match (the only lanes that need it),
    and (paged) one page-map word per active lane. Sentinel lanes touch
    no row. `freed` is one byte (bool), or 4 for the sharded wave
    (int32). `ways` is the table's associativity."""
    lanes = len(hb.active)
    active = hb.active
    n_active = int(np.count_nonzero(active))
    batch_in = (n_active * sum(np.dtype(dt).itemsize for dt in BATCH_DTYPES.values())
                + (lanes - n_active) * np.dtype(BATCH_DTYPES["active"]).itemsize)
    outs = lanes * (1 + 6 * 8 + freed_bytes) + 9 * 8
    probe, rest, store = ROW_BYTES[layout]
    rows = int(np.count_nonzero(active & resident)) * (ways * probe + store) + hits * rest
    pmap = n_active * 4 if paged else 0
    return batch_in + outs + rows + pmap


def bound_ms(hb, layout, resident, paged, hits, freed_bytes=1, ways=WAYS):
    t_bytes = wave_bytes(hb, layout, resident, paged, hits, freed_bytes, ways) / HBM_BYTES_PER_S * 1e3
    t_ops = int(np.count_nonzero(hb.active)) * OPS_PER_LANE / SCALAR_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phases


LIBS = ["decide_cuda", "guberhash", "wirepath"]


def _ptxas_kernels(log: str) -> dict:
    """{"decide_wave_kernel<layout,paged>": {registers, spill_stores,
    spill_loads, static_smem_bytes}} from nvcc's -Xptxas -v report (the
    scan kernel's keys also carry its block size)."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"entry function '.*\d(decide_[a-z]+_kernel)ILi(\d+)ELb(\d)E"
                      r"(?:Li(\d+)E)?", ln)
        if m:
            args = ",".join(g for g in m.groups()[1:] if g is not None)
            cur = out.setdefault(f"{m.group(1)}<{args}>", {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            cur.update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", ln)
        if m:
            cur["static_smem_bytes"] = int(m.group(1))
    return out


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.build(LIBS, force=True)
    log = _build.log_path("decide_cuda").read_text()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "entry function" in ln or "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libs": LIBS, "kernels": _ptxas_kernels(log), "ptxas": ptxas})


def _out_err(ko, po, what="the plain version") -> float:
    """Largest |kernel - reference| over every DecideOutput field (lanes
    and sums, (B,) or stacked (T, B)); raises unless they are bit-equal."""
    err = 0.0
    for f in ko._fields:
        a, r = getattr(ko, f), getattr(po, f)
        if a.dtype != r.dtype or a.shape != r.shape:
            raise AssertionError(f"output {f}: {a.dtype}{tuple(a.shape)} vs {r.dtype}{tuple(r.shape)}")
        d = float((a.double() - r.double()).abs().max()) if a.numel() else 0.0
        if not torch.equal(a, r):
            raise AssertionError(f"output {f} differs from {what} (max abs {d})")
        err = max(err, d)
    return err


def _max_abs_err(ko, po, ks, ps) -> float:
    """`_out_err` plus the WaveScan sums, which must be equal too."""
    err = _out_err(ko, po)
    for f in ks._fields:
        if not torch.equal(getattr(ks, f), getattr(ps, f)):
            raise AssertionError(f"WaveScan.{f}: kernel {int(getattr(ks, f))} plain {int(getattr(ps, f))}")
    return err


def phase_kernel(rng, image, size, layout, page_map):
    name = cuda_decide.config_name(layout, page_map is not None)
    kt, pt = kernel_tables(image, size, layout, page_map)
    pm0 = kt.page_map.clone() if page_map is not None else None
    gpp = size.page_groups
    n = _rows(kt).shape[0]
    sync()
    before = cuda_decide.CONFIG_LAUNCHES[name]
    now = NOW
    err = 0.0
    sentinel = 0
    for w in range(WAVES):
        now += int(rng.choice([0, 1, 250, 2000]))
        hb = smoke_wave(rng, image, now, size.num_groups)
        db = batch_to_device(hb, DEVICE)
        ko, ks = run_kernel(kt, db, now, layout, gpp)
        po, ps = run_plain(pt, db, now, layout, gpp)
        sync()
        err = max(err, _max_abs_err(ko, po, ks, ps))
        if not torch.equal(_rows(kt), _rows(pt)):
            rows = int((_rows(kt) != _rows(pt)).any(dim=1).sum())
            raise AssertionError(f"{name} wave {w}: table differs from the plain version in {rows} rows")
        if pm0 is not None and not (torch.equal(kt.page_map, pm0) and torch.equal(pt.page_map, pm0)):
            raise AssertionError(f"{name} wave {w}: the page map changed")
        sentinel += int((db.active & (ko.slot == n)).sum())
    live = int(((_rows(kt)[:, 2] & 1) != 0).sum())  # META is col 2 in both layouts
    launches = cuda_decide.CONFIG_LAUNCHES[name] - before
    team = team_checks(rng, layout, page_map is not None)
    err = max([err] + [t["max_abs_err"] for t in team.values()])
    res = {"phase": "kernel", "size": size.name, "kernel": name, "ok": True,
           "waves": WAVES, "batch": B, "table_rows": n,
           "table_mb": _rows(kt).numel() * 8 / 1e6, "live_rows_after": live,
           "sentinel_lanes": sentinel, "launches": launches, **team,
           "max_abs_err": err, "tolerance": "bit-exact (int64)"}
    emit(res)
    return kt, pt, err


def phase_mesh_kernel(rng, image, size, layout, page_map):
    """The sharded kernel, MESH_SHARDS shards of the table on the card,
    against its plain version (the masked wave on every shard's rows,
    then the sum) and against the wave kernel of the same table (flat,
    or paged with the same page map), each on its own copy of the table:
    WAVES waves of B lanes. Every output field and the 9 sums bit-exact
    against the plain version; after every wave the three tables equal
    (a paged sentinel lane stores nothing in either kernel); the wave
    kernel's answers equal the sharded ones on every owned lane, with
    the psum's slot (local slot + (D - 1) * n_local) and int32 freed."""
    name = cuda_decide.sharded_name(layout)
    paged = page_map is not None
    gpp = size.page_groups
    kt, pt = kernel_tables(image, size, layout, page_map)
    wt = PagedTable(type(kt.data)(kt.data.data.clone()), kt.page_map.clone()) if paged \
        else type(kt)(kt.data.clone())
    n = _rows(kt).shape[0]
    n_local = n // MESH_SHARDS
    sync()
    before = cuda_decide.CONFIG_LAUNCHES[name]
    now = NOW
    err = 0.0
    unowned = 0
    for w in range(WAVES):
        now += int(rng.choice([0, 1, 250, 2000]))
        hb = smoke_wave(rng, image, now, size.num_groups)
        db = batch_to_device(hb, DEVICE)
        ko, ks = run_kernel(kt, db, now, layout, gpp, MESH_SHARDS)
        po, ps = run_plain(pt, db, now, layout, gpp, MESH_SHARDS)
        wo, _ = run_kernel(wt, db, now, layout, gpp)
        sync()
        err = max(err, _max_abs_err(ko, po, ks, ps))
        for ref, what in ((pt, "the plain version"), (wt, "the wave kernel")):
            if not torch.equal(_rows(kt), _rows(ref)):
                rows = int((_rows(kt) != _rows(ref)).any(dim=1).sum())
                raise AssertionError(f"{name} wave {w}: table differs from {what} in {rows} rows")
        owned = db.active & (wo.slot < n)
        want_slot = torch.where(owned, wo.slot % n_local + (MESH_SHARDS - 1) * n_local,
                                MESH_SHARDS * n_local)
        if not torch.equal(ko.slot, want_slot):
            raise AssertionError(f"{name} wave {w}: slot is not the psum of the shards' slots")
        for f in ("status", "limit", "remaining", "reset_time", "evicted_hi", "evicted_lo", "freed"):
            a, r = getattr(ko, f)[owned], getattr(wo, f)[owned]
            if not torch.equal(a.to(torch.int64), r.to(torch.int64)):
                raise AssertionError(f"{name} wave {w}: {f} differs from the wave kernel's")
        if not (ko.status[~owned] == 0).all() or not (ko.remaining[~owned] == 0).all():
            raise AssertionError(f"{name} wave {w}: an unowned lane has an answer")
        unowned += int((db.active & ~owned).sum())
    launches = cuda_decide.CONFIG_LAUNCHES[name] - before
    team = team_checks(rng, layout, paged, MESH_SHARDS)
    err = max([err] + [t["max_abs_err"] for t in team.values()])
    res = {"phase": "mesh_kernel", "size": size.name, "kernel": name, "ok": True,
           "shards": MESH_SHARDS, "paged": paged, "waves": WAVES, "batch": B,
           "table_rows": n, "rows_per_shard": n_local,
           "active_unowned_lanes": unowned, "launches": launches, **team,
           "max_abs_err": err, "tolerance": "bit-exact (int64)"}
    emit(res)
    return kt, pt, err


def _median_ms(fn, reps, flush, hold_cycles=0, setup=None):
    """Median of `reps` launches timed one by one with CUDA events, L2
    flushed before each. With `hold_cycles` the stream first spins that
    long on the device, so the host has enqueued start event, launch and
    end event before the device reaches them: the window then holds only
    device work. Without it the device idles while the host works, and
    the window also holds the host's launch path. With `setup`, each
    launch is `fn(setup())`, setup's work queued before the window."""
    times = []
    for _ in range(reps):
        arg = setup() if setup is not None else None
        flush.zero_()
        if hold_cycles:
            torch.cuda._sleep(hold_cycles)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn() if setup is None else fn(arg)
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


# Fills of a marker tensor around the operations a trace counts: on the
# card the profiler has been seen to miss up to six of them in a trace
# (NVIDIA H100 80GB HBM3), so the fills before the counted operations
# are the ones it may miss at its start (and the fills after them, any
# missed at its end)
MARKER_FILLS = 16


def _device_ops(fn, reps):
    """Names of the device operations (kernels, memsets, copies), in
    time order, that torch.profiler (CUPTI) records while `fn` runs
    `reps` times, between MARKER_FILLS fills of a marker tensor (then a
    synchronise and 50 ms) before them and MARKER_FILLS after them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    marker = torch.empty(1, device=DEVICE)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for k in range(MARKER_FILLS):
            marker.fill_(k)
        sync()
        time.sleep(0.05)
        for _ in range(reps):
            fn()
        for k in range(MARKER_FILLS):
            marker.fill_(k)
        sync()
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return [e.name for e in sorted(ops, key=lambda e: e.time_range.start)]


def _profiled_device_ms(fn, reps, kernel="decide_wave_kernel"):
    """Device time per launch of `kernel` from torch.profiler (CUPTI),
    or None when the trace holds no device time for it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        sync()
    total_us, count = 0.0, 0
    for e in prof.key_averages():
        if kernel in e.key:
            t = getattr(e, "device_time_total", None)
            total_us += t if t is not None else getattr(e, "cuda_time_total", 0.0)
            count += e.count
    return total_us / count / 1e3 if count and total_us > 0 else None


def lone_wave(table, now, layout, gpp, shards):
    """The one-wave wrapper's launch in two steps, so that a window of
    `_median_ms` holds the kernel alone: `setup(db)` makes the wrapper's
    one-wave `WaveFlush` (its checks, its output allocation and the
    memset of its sums), `launch(flush)` launches the wave into it and
    returns the flush."""
    rows, pm = _rows(table), (table.page_map if isinstance(table, PagedTable) else None)

    def setup(db):
        return cuda_decide.WaveFlush(db, None, cuda_decide.TableMemo())

    def launch(fl):
        fl.launch(0, rows, pm, now, layout=layout, ways=WAYS, gpp=gpp, n_shards=shards)
        return fl

    return setup, launch


def flush_wave(table, hbs, now, layout, gpp, shards):
    """A function that launches the next of the host waves `hbs` (each
    of the same width) through the engine's launch path: one
    `WaveFlush` over all of them (one batch copy, one output
    allocation), wave i launched on call i (mod len(hbs))."""
    lanes = len(hbs[0].active)
    flat = RequestBatch(*(np.concatenate(c) for c in zip(*hbs)))
    fl = cuda_decide.WaveFlush(batch_to_device(flat, DEVICE),
                               [(i * lanes, lanes) for i in range(len(hbs))],
                               cuda_decide.TableMemo())
    rows, pm = _rows(table), (table.page_map if isinstance(table, PagedTable) else None)
    state = {"i": 0}

    def launch():
        i = state["i"] % len(hbs)
        state["i"] += 1
        fl.launch(i, rows, pm, now, layout=layout, ways=WAYS, gpp=gpp, n_shards=shards)

    launch()  # the table's check, once
    sync()
    return launch


def phase_times(rng, image, size, layout, page_map, kt, pt, card, shards=0):
    """Times at the main path's shape (B = 1024), each over fresh waves
    of distinct groups so the group blocks come from HBM, not L2. A
    paged wave draws its groups from resident pages only, as the main
    path gives them (no sentinel lanes). The bound of each launch timed
    in (a) counts the live matches that launch found. `card` is
    nvidia-smi's name and power limit, printed beside them. With
    `shards`, the sharded kernel over that many shards of the table (the
    phase `mesh_times`)."""
    paged = page_map is not None
    name = cuda_decide.sharded_name(layout) if shards else cuda_decide.config_name(layout, paged)
    gpp = size.page_groups
    reps = 200
    now = NOW + 60_000
    hbs = [smoke_wave(rng, image, now, size.num_groups,
                      resident_groups(rng, size, page_map) if paged else None)
           for _ in range(reps)]
    resident = [resident_lanes(hb, size, page_map) for hb in hbs]
    if not all(r.all() for r in resident):
        raise AssertionError(f"{name}: a timed wave holds a sentinel lane")
    dbs = [batch_to_device(hb, DEVICE) for hb in hbs]
    sync()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)  # > 50 MB L2
    state = {"i": 0}
    timed = []  # (wave index, live-match count) of each launch in (a)
    lone_setup, lone_launch = lone_wave(kt, now, layout, gpp, shards)

    def kernel():
        i = state["i"] % reps
        state["i"] += 1
        run_kernel(kt, dbs[i], now, layout, gpp, shards)

    def setup_a():
        i = state["i"] % reps
        state["i"] += 1
        return i, lone_setup(dbs[i])

    def kernel_a(arg):
        i, fl = arg
        timed.append((i, lone_launch(fl).sums[0, 0]))

    def plain():
        db = dbs[state["i"] % reps]
        state["i"] += 1
        run_plain(pt, db, now, layout, gpp, shards)

    for _ in range(10):
        kernel()
    sync()
    # (a) the kernel on the card: median of 200 launches timed one by
    # one, L2 flushed before each, the device held busy (~1 ms) while
    # the host enqueues, so the window holds the kernel only (the
    # wrapper's flush made, and its sums zeroed, before the window)
    k_ms = _median_ms(kernel_a, reps, flush, hold_cycles=2_000_000, setup=setup_a)
    # (a') the same without the hold: the launch path a lone wave pays
    # through the one-wave wrapper (a flush of one wave: its checks,
    # allocation, memset of its sums, ctypes call, kernel)
    wrapper_path_ms = _median_ms(kernel, reps, flush)
    # (a'') the engine's launch path: the same waves as one flush
    # (`WaveFlush`: batch in one copy and checked once, outputs in one
    # allocation, the table checked once), one wave launched per timing
    path_ms = _median_ms(flush_wave(kt, hbs, now, layout, gpp, shards), reps, flush)
    # (b) runs of 200 back-to-back launches, events around each run;
    # the median of 5 runs, per launch (host-paced, so noisy)
    runs = []
    for _ in range(5):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            kernel()
        e.record()
        e.synchronize()
        runs.append(s.elapsed_time(e) / reps)
    # (c) the kernel's own device time, from the profiler's trace
    symbol = "decide_sharded_kernel" if shards else "decide_wave_kernel"
    dev_ms = _profiled_device_ms(kernel, reps, symbol)
    # (d) the B sweep: (a) and (c) at 128, 1024 (the numbers above) and
    # 4096 lanes, fresh waves of each width
    sweep = {B: {"events_ms": k_ms, "profiler_ms": dev_ms}}
    for lanes in SWEEP_B:
        if lanes == B:
            continue
        dbl = [batch_to_device(smoke_wave(
            rng, image, now, size.num_groups,
            resident_groups(rng, size, page_map, lanes) if paged else None, lanes=lanes), DEVICE)
            for _ in range(reps)]
        sync()
        at = {"i": 0}

        def wide():
            i = at["i"] % reps
            at["i"] += 1
            run_kernel(kt, dbl[i], now, layout, gpp, shards)

        def setup_wide():
            i = at["i"] % reps
            at["i"] += 1
            return lone_setup(dbl[i])

        for _ in range(10):
            wide()
        sweep[lanes] = {"events_ms": _median_ms(lone_launch, reps, flush,
                                                hold_cycles=2_000_000, setup=setup_wide),
                        "profiler_ms": _profiled_device_ms(wide, reps, symbol)}
        del dbl
    plain()
    sync()
    p_ms = _median_ms(plain, 20, flush)
    hits = torch.stack([h for _, h in timed]).tolist()
    bounds = [bound_ms(hbs[i], layout, resident[i], paged, h, 4 if shards else 1)
              for (i, _), h in zip(timed, hits)]
    b_ms = statistics.median(b for b, _ in bounds)
    res = {"phase": "mesh_times" if shards else "times", "size": size.name, "kernel": name,
           "kernel_ms_median": k_ms, "launch_path_ms_median": path_ms,
           "launch_path_ms_median_wrapper": wrapper_path_ms,
           "kernel_ms_run": statistics.median(runs), "kernel_ms_runs": runs,
           "kernel_device_ms_profiler": dev_ms, "plain_ms_median": p_ms,
           "bound_ms": b_ms, "bound_by": bounds[0][1], "batch": B,
           "live_matches_per_wave_median": statistics.median(hits),
           "active_lanes_per_wave_median": statistics.median(
               int(np.count_nonzero(hb.active)) for hb in hbs),
           "reps_kernel": reps, "reps_plain": 20,
           "b_sweep": [{"batch": k, **v} for k, v in sorted(sweep.items())], "card": card}
    if shards:
        res.update(shards=shards, paged=paged)
    emit(res)
    del flush
    return res


# ---------------------------------------------------------------------------
# the scan kernel (T waves in one launch)


def scan_steps(rng, size: Size, now: int, page_map=None):
    """SCAN_T host batches of SCAN_B lanes drawn as the bench draws them
    (`bench._make_zipf_batch`: Zipf(1.1) over the size's live-key count,
    deduplicated per step, so the head's groups recur in consecutive
    steps; the `kernel10m` behavior mix, a superset of `kernel`'s plain
    lanes), and their `nows`. With `page_map` the groups are drawn over
    the resident pages only (a bijection onto them), as the paged drive
    holds every page resident."""
    gpp = size.page_groups
    groups = size.num_groups
    if page_map is not None:
        mapped = np.nonzero(page_map >= 0)[0]
        groups = mapped.size * gpp
    hosts = []
    for _ in range(SCAN_T):
        hb = bench._make_zipf_batch(rng, SCAN_B, size.live_keys, groups, now, "kernel10m")
        if page_map is not None:
            g = hb.group.astype(np.int64)
            hb.group[:] = (mapped[g // gpp] * gpp + g % gpp).astype(np.int32)
        hosts.append(hb)
    nows = now + np.cumsum(rng.choice([0, 1, 250, 2000], SCAN_T)).astype(np.int64)
    return hosts, nows


def run_scan(table, db, nows, layout: str, gpp: int, ways: int = WAYS):
    if isinstance(table, PagedTable):
        _, out = cuda_decide.decide_scan_paged(table, db, nows, layout=layout, ways=ways, gpp=gpp)
    else:
        _, out = cuda_decide.decide_scan_flat(table, db, nows, layout=layout, ways=ways)
    return out


def run_scan_plain(table, db, nows, layout: str, gpp: int, ways: int = WAYS):
    pm = table.page_map if isinstance(table, PagedTable) else None
    return fused.scan_plain(CODEC[layout], _rows(table), pm, db, nows, ways=ways, gpp=gpp)


def run_waves(table, db, nows: np.ndarray, layout: str, gpp: int, ways: int = WAYS):
    """The scan's steps as successive launches of the wave kernel; the
    outputs stacked as the scan stacks them."""
    outs = [run_kernel(table, RequestBatch(*(c[t] for c in db)), int(nows[t]), layout, gpp,
                       ways=ways)[0]
            for t in range(len(nows))]
    return type(outs[0])(*(torch.stack(f) for f in zip(*outs)))


def _copy_table(table):
    """A device copy of a kernel table (flat or paged)."""
    if isinstance(table, PagedTable):
        return PagedTable(type(table.data)(table.data.data.clone()), table.page_map.clone())
    return type(table)(table.data.clone())


def _scan_against(name, kt, db, nows, layout, gpp, ways=WAYS):
    """One scan of the kernel on `kt` against the plain version and
    against T wave launches, each on its own copy of `kt` made first:
    every (T, B) field and the (T,) sums bit-exact, the three tables
    equal after, the page map unchanged. Returns (kernel output,
    largest difference, scan launches, wave launches)."""
    paged = isinstance(kt, PagedTable)
    pt, wt = _copy_table(kt), _copy_table(kt)
    pm0 = kt.page_map.clone() if paged else None
    wave_name = cuda_decide.config_name(layout, paged)
    nows_d = torch.from_numpy(np.asarray(nows, np.int64)).to(DEVICE)
    sync()
    s0, w0 = cuda_decide.CONFIG_LAUNCHES[name], cuda_decide.CONFIG_LAUNCHES[wave_name]
    ko = run_scan(kt, db, nows_d, layout, gpp, ways)
    sync()
    scan_launches = cuda_decide.CONFIG_LAUNCHES[name] - s0
    po = run_scan_plain(pt, db, nows_d, layout, gpp, ways)
    wo = run_waves(wt, db, np.asarray(nows), layout, gpp, ways)
    sync()
    wave_launches = cuda_decide.CONFIG_LAUNCHES[wave_name] - w0
    err = max(_out_err(ko, po), _out_err(ko, wo, f"{len(nows)} {wave_name} launches"))
    for ref, what in ((pt, "the plain version"), (wt, f"{len(nows)} wave launches")):
        if not torch.equal(_rows(kt), _rows(ref)):
            rows = int((_rows(kt) != _rows(ref)).any(dim=1).sum())
            raise AssertionError(f"{name}: table differs from {what} in {rows} rows")
        if paged and not torch.equal(ref.page_map, pm0):
            raise AssertionError(f"{name}: the page map changed ({what})")
    if paged and not torch.equal(kt.page_map, pm0):
        raise AssertionError(f"{name}: the page map changed")
    if scan_launches != 1 or wave_launches != len(nows):
        raise AssertionError(f"{name}: {scan_launches} scan launches, {wave_launches} wave launches")
    return ko, err, scan_launches, wave_launches


# Steps and lanes of the scan kernel's team checks; the 32-way scan
# runs SCAN_B lanes on STRIDE_GROUPS groups
TEAM_SCAN_T = 8
STRIDE_WAYS = 32
STRIDE_GROUPS = 8192


def scan_team_checks(rng, layout: str, paged: bool) -> dict:
    """The scan kernel's team and its grid on the card, each scan against
    the plain version and against T wave launches (`_scan_against`), on
    tables of their own (paged: a scrambled map of 3/4 of the pages):
    - tie_scan: TEAM_SCAN_T steps of B lanes on the tie-heavy image
      (`tie_image`, 8 ways; 1,024 of its 4,096 groups per step, so
      consecutive steps share about a quarter of their groups);
    - ways4_scan: TEAM_SCAN_T steps of a 4-way table (a team of 4);
    - ways32_scan: TEAM_SCAN_T steps of SCAN_B lanes on a 32-way table of
      STRIDE_GROUPS groups (a team of 32): its items outnumber the
      co-resident blocks, so each block strides over several items per
      step (checked: the grid is smaller than the step's items);
    - t1_scan: a scan of one step of SCAN_B lanes (8 ways): the zeroing
      and the adds of the sums around the one barrier.
    Returns each scan's counts."""
    name = cuda_decide.config_name(layout, paged, scan=True)
    res = {}
    for what, ways, groups, lanes, steps in (
            ("tie_scan", WAYS, TEAM_GROUPS, B, TEAM_SCAN_T),
            ("ways4_scan", 4, TEAM_GROUPS, B, TEAM_SCAN_T),
            ("ways32_scan", STRIDE_WAYS, STRIDE_GROUPS, SCAN_B, TEAM_SCAN_T),
            ("t1_scan", WAYS, STRIDE_GROUPS, SCAN_B, 1)):
        nlp = groups // TEAM_GPP
        size = Size(what, groups, 2 * groups, TEAM_GPP if paged else 0,
                    nlp * 3 // 4 if paged else 0, ())
        if what == "tie_scan":
            image, tie_keys = tie_image(rng, NOW)
        else:
            image = live_image(rng, size, ways)
        nows = NOW + np.cumsum(rng.choice([0, 1, 250, 2000], steps)).astype(np.int64)
        hosts = [tie_wave(rng, tie_keys, int(now)) if what == "tie_scan" else
                 smoke_wave(rng, image, int(now), groups, lanes=lanes, ways=ways)
                 for now in nows]
        pm = scrambled_page_map(rng, size) if paged else None
        kt, _ = kernel_tables(image, size, layout, pm, ways)
        db = batch_to_device(stack_batches(hosts), DEVICE)
        ko, err, launches, _ = _scan_against(name, kt, db, nows, layout, size.page_groups, ways)
        r = {"ways": ways, "steps": steps, "batch": lanes,
             "hits": int(ko.hits.sum()), "misses": int(ko.misses.sum()),
             "unexpired_evictions": int(ko.unexpired_evictions.sum()),
             "recurring_groups": _recurring_groups(hosts),
             "launches": launches, "max_abs_err": err}
        if what == "ways32_scan":
            r["block_threads"], r["grid_blocks"] = cuda_decide.scan_grid(
                DEVICE, lanes, layout=layout, ways=ways, paged=paged)
            r["items"] = cuda_decide.scan_items(lanes, ways, r["block_threads"])
            if not r["grid_blocks"] < r["items"]:
                raise AssertionError(f"{name} {what}: grid {r['grid_blocks']} does not stride "
                                     f"over {r['items']} items")
        res[what] = r
        del kt, db
    return res


def _recurring_groups(hosts) -> int:
    """Active groups a step shares with the step before it."""
    n = 0
    for a, b in zip(hosts, hosts[1:]):
        n += np.intersect1d(a.group[a.active], b.group[b.active]).size
    return n


def phase_scan_kernel(rng, image, size, layout, page_map):
    """The scan kernel against its plain version and against SCAN_T wave
    launches, each on its own copy of the table. Returns the three
    tables (reused for the times) and the largest difference (0)."""
    paged = page_map is not None
    name = cuda_decide.config_name(layout, paged, scan=True)
    gpp = size.page_groups
    kt, _ = kernel_tables(image, size, layout, page_map)
    n = _rows(kt).shape[0]
    hosts, nows = scan_steps(rng, size, NOW + 1000)
    db = batch_to_device(stack_batches(hosts), DEVICE)
    ko, err, scan_launches, wave_launches = _scan_against(name, kt, db, nows, layout, gpp)
    # the plain and wave-kernel copies equal the kernel's table again
    pt, wt = _copy_table(kt), _copy_table(kt)
    team = scan_team_checks(rng, layout, paged)
    err = max([err] + [t["max_abs_err"] for t in team.values()])
    emit({"phase": "scan_kernel", "size": size.name, "kernel": name, "ok": True,
          "steps": SCAN_T, "batch": SCAN_B, "table_rows": n,
          "active_lanes": int(db.active.sum()),
          "recurring_groups": _recurring_groups(hosts),
          "sentinel_lanes": int((db.active & (ko.slot == n)).sum()),
          "live_matches": int(ko.hits.sum()),
          "launches": scan_launches, "wave_launches_compared": wave_launches, **team,
          "max_abs_err": err, "tolerance": "bit-exact (int64)"})
    return (kt, pt, wt), err


def scan_bound_ms(hosts, layout, residents, paged, hits):
    """Least time of one scan: the larger of its bytes (every step's, as
    `wave_bytes` counts a wave, plus the T `nows`) over HBM bandwidth and
    its integer operations over the scalar rate."""
    nbytes = 8 * len(hosts) + sum(wave_bytes(hb, layout, r, paged, h)
                                  for hb, r, h in zip(hosts, residents, hits))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(int(np.count_nonzero(hb.active)) for hb in hosts) * OPS_PER_LANE / SCALAR_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _check_scan_ops(name, ops):
    """One scan, one device operation: among the marker fills the trace
    of SCAN_REPS scans holds exactly SCAN_REPS operations, each the scan
    kernel. Returns (scan kernels, marker fills)."""
    scans = [o for o in ops if "decide_scan_kernel" in o]
    others = [o for o in ops if "decide_scan_kernel" not in o]
    if (len(scans) != SCAN_REPS or len(others) > 2 * MARKER_FILLS
            or any("FillFunctor" not in o for o in others)):
        raise AssertionError(f"{name}: {SCAN_REPS} scans, the profiler saw {len(scans)} scan "
                             f"kernels and {others}")
    return scans, others


def scan_op_names(seed: int) -> dict:
    """The device operations that torch.profiler records over SCAN_REPS
    scans of every scan configuration, at the timed scans' shape (each
    size's image and page map, `scan_steps` over resident pages), as
    `_device_ops` names them: run by main in a fresh process of this
    script (`--scan-op-counts`) before any other work on the card, since
    in a long run CUPTI has been seen to lose scan records. A first,
    empty session starts CUPTI. {scan kernel name: names}."""
    rng = np.random.default_rng(seed)
    _device_ops(lambda: None, 0)
    out = {}
    for size in SIZES:
        image = live_image(rng, size)
        pm = scrambled_page_map(rng, size) if size.page_groups else None
        for layout, paged in size.configs:
            pmap = pm if paged else None
            kt = kernel_tables(image, size, layout, pmap)[0]
            hosts, nows = scan_steps(rng, size, NOW + 60_000, pmap)
            db = batch_to_device(stack_batches(hosts), DEVICE)
            nows_d = torch.from_numpy(nows).to(DEVICE)

            def scan():
                run_scan(kt, db, nows_d, layout, size.page_groups)

            for _ in range(3):
                scan()
            out[cuda_decide.config_name(layout, paged, scan=True)] = _device_ops(scan, SCAN_REPS)
            del kt, db, nows_d
            free_device()
        del image
    return out


def scan_op_names_child(seed: int) -> dict:
    """`scan_op_names` in a fresh process of this script."""
    return _op_counts_child("--scan-op-counts", "--seed", str(seed))


def phase_scan_times(rng, size, layout, page_map, tables, card, op_names):
    """Times of one scan of SCAN_T x SCAN_B at the bench's shape, over
    the tables of the scan_kernel phase; paged: groups on resident pages
    only. The bound of each timed scan counts the live matches its steps
    found. `op_names`: `scan_op_names`' traces, checked here."""
    paged = page_map is not None
    name = cuda_decide.config_name(layout, paged, scan=True)
    gpp = size.page_groups
    kt, pt, wt = tables
    hosts, nows = scan_steps(rng, size, NOW + 60_000, page_map)
    residents = [resident_lanes(hb, size, page_map) for hb in hosts]
    if not all(r.all() for r in residents):
        raise AssertionError(f"{name}: a timed step holds a sentinel lane")
    db = batch_to_device(stack_batches(hosts), DEVICE)
    nows_d = torch.from_numpy(nows).to(DEVICE)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)  # > the H100's 50 MB L2
    hits = []

    def scan():
        hits.append(run_scan(kt, db, nows_d, layout, gpp).hits)

    def waves():
        run_waves(wt, db, nows, layout, gpp)

    for _ in range(3):
        run_scan(kt, db, nows_d, layout, gpp)
    waves()
    sync()
    # the scan on the card: events around one launch, L2 flushed, the
    # device held busy (2M cycles, ~1 ms at the H100's 1.98 GHz) while
    # the host enqueues: the kernel alone (it zeroes its own sums)
    s_ms = _median_ms(scan, SCAN_REPS, flush, hold_cycles=2_000_000)
    s_dev = _profiled_device_ms(lambda: run_scan(kt, db, nows_d, layout, gpp), SCAN_REPS,
                                "decide_scan_kernel")
    scans, others = _check_scan_ops(name, op_names[name])
    # the yardstick: the same steps as SCAN_T wave launches, events
    # around all of them (host-paced), and the kernels' device time
    w_ms = _median_ms(waves, 5, flush)
    w_dev = _profiled_device_ms(waves, 5)
    run_scan_plain(pt, db, nows_d, layout, gpp)
    sync()
    p_ms = _median_ms(lambda: run_scan_plain(pt, db, nows_d, layout, gpp), 3, flush)
    hits = torch.stack(hits).tolist()
    bounds = [scan_bound_ms(hosts, layout, residents, paged, h) for h in hits]
    b_ms = statistics.median(b for b, _ in bounds)
    res = {"phase": "scan_times", "size": size.name, "kernel": name,
           "steps": SCAN_T, "batch": SCAN_B,
           "scan_ms_median": s_ms, "step_ms_median": s_ms / SCAN_T,
           "scan_device_ms_profiler": s_dev,
           "device_ops_per_scan": len(scans) / SCAN_REPS,
           "marker_fills_seen": len(others),
           "step_device_ms_profiler": s_dev / SCAN_T if s_dev else None,
           "waves_ms_median": w_ms,
           "waves_device_ms_profiler": w_dev * SCAN_T if w_dev else None,
           "wave_device_ms_profiler": w_dev,
           "plain_ms_median": p_ms, "bound_ms": b_ms, "bound_by": bounds[0][1],
           "active_lanes_per_scan": sum(int(np.count_nonzero(hb.active)) for hb in hosts),
           "recurring_groups": _recurring_groups(hosts),
           "live_matches_per_scan_median": statistics.median(sum(h) for h in hits),
           "reps_scan": SCAN_REPS, "reps_waves": 5, "reps_plain": 3, "card": card}
    emit(res)
    del flush
    return res


# (mode, layout, page_groups) of each bench run; the paged kernel10m
# runs, a drive of the paged scan kernels, hold all 512 logical pages
# (2^21 groups / 4,096) resident
BENCH_RUNS = (
    ("kernel", "fused", 0), ("kernel", "narrow", 0),
    ("kernel10m", "fused", 0), ("kernel10m", "narrow", 0),
    ("kernel10m", "fused", 4096), ("kernel10m", "narrow", 4096),
)


def _quiet(*_a, **_k) -> None:
    pass


def phase_bench(card):
    """The port's bench, each run with the launch counts set to 0 just
    before it and read just after. Returns {scan config: launches} of
    the first run that drove each configuration."""
    scan_launches = {}
    flat10m = {}
    for mode, layout, pg in BENCH_RUNS:
        paged = bool(pg)
        name = cuda_decide.config_name(layout, paged, scan=True)
        sync()
        cuda_decide.reset_launches()
        run = bench.run_kernel_bench(mode, layout, device=DEVICE, page_groups=pg, log=_quiet)
        sync()
        launches = dict(cuda_decide.CONFIG_LAUNCHES)
        res = {"phase": "bench", "mode": mode, "layout": layout, "paged": paged,
               "line": run.result, "scan_launches": launches[name],
               "wave_launches": launches[cuda_decide.config_name(layout, paged)],
               "other_launches": sum(launches.values()) - launches[name]
               - launches[cuda_decide.config_name(layout, paged)],
               "decisions": run.decisions, "seconds": run.seconds,
               "evictions": run.evictions, "card": card}
        if not paged:
            # the same run through the plain version on a CPU table
            ref = bench.run_kernel_bench(mode, layout, device="cpu", log=_quiet)
            res["cpu_replay_equal"] = bool(torch.equal(_rows(run.table).cpu(), _rows(ref.table))
                                           and run.evictions == ref.evictions)
            del ref
            if mode == "kernel10m":
                flat10m[layout] = run
        else:
            flat = flat10m.pop(layout)
            res["equals_flat_run"] = bool(torch.equal(_rows(run.table), _rows(flat.table))
                                          and run.evictions == flat.evictions)
            del flat
        emit(res)
        v = run.result["value"]
        if not (np.isfinite(v) and v > 0):
            raise AssertionError(f"bench {mode} {layout}: value {v}")
        if launches[name] != run.scans or res["other_launches"]:
            raise AssertionError(f"bench {mode} {layout}: launches {launches}")
        if res.get("cpu_replay_equal") is False or res.get("equals_flat_run") is False:
            raise AssertionError(f"bench {mode} {layout} paged={paged}: table differs from its reference")
        scan_launches.setdefault(name, launches[name])
        del run
        free_device()
    sync()
    cuda_decide.reset_launches()
    line = bench.bench_latency("fused", device=DEVICE, log=_quiet)
    sync()
    n = cuda_decide.CONFIG_LAUNCHES["decide_scan"]
    emit({"phase": "bench", "mode": "latency", "layout": "fused", "line": line,
          "scan_launches": n, "card": card})
    if not (n > 0 and np.isfinite(line["value"])):
        raise AssertionError(f"bench latency: {n} scan launches, value {line['value']}")
    free_device()
    return scan_launches


class _Zipf:
    """Key ranks in 1..n_keys with P(k) proportional to k^-s (a Zipf law
    bounded to the keyspace; clipping an unbounded draw would pile the
    tail onto one key). The CDF is built once."""

    def __init__(self, n_keys: int, s: float = 1.1):
        cdf = np.cumsum(np.arange(1, n_keys + 1, dtype=np.float64) ** -s)
        self.cdf = cdf / cdf[-1]

    def draw(self, rng, n: int) -> np.ndarray:
        return np.searchsorted(self.cdf, rng.random(n), side="right") + 1


def smoke_calls(rng, n_keys: int, n_calls: int = CALLS):
    """n_calls calls of ITEMS items: Zipf(1.1) keys over n_keys, 70% token /
    30% leaky, hits 1-5, limits 10-1000, durations 1-60 s, 5%
    RESET_REMAINING, 5% DRAIN_OVER_LIMIT, a few DURATION_IS_GREGORIAN
    items; the Zipf head repeats keys inside a call, so flushes take
    several waves."""
    zipf = _Zipf(n_keys)
    return [_smoke_items(rng, zipf.draw(rng, ITEMS)) for _ in range(n_calls)]


def _smoke_items(rng, ks):
    """One call's item dicts for the key ranks `ks` (smoke_calls' mix)."""
    u = rng.random(len(ks))
    items = []
    for i in range(len(ks)):
        behavior = 8 if u[i] < 0.05 else (32 if u[i] < 0.10 else 0)
        duration = int(rng.integers(1000, 60_001))
        if rng.random() < 0.01:
            behavior |= 4
            duration = int(rng.choice([0, 1]))  # minutes, hours
        items.append(dict(
            name="smoke", unique_key=f"acct:{int(ks[i])}",
            algorithm=int(rng.random() < 0.3), behavior=behavior,
            duration=duration, limit=int(rng.integers(10, 1001)),
            hits=int(rng.integers(1, 6)),
        ))
    return items


class _PagerSpans:
    """Host-clock spans around an engine's pager calls, summed:
    `ensure_resident` (all page work before a wave), `demote` (gather,
    blocking device-to-host copy, which also waits for the decides
    already queued, and unbind) and `promote_one` (frame, the demote it
    may make, host packing and one host-to-device copy). The pager's
    methods are wrapped on this one instance; the engine is unchanged."""

    NAMES = ("ensure_resident", "demote", "_promote_one")

    def __init__(self, pager):
        self.s = dict.fromkeys(self.NAMES, 0.0)
        for n in self.NAMES:
            setattr(pager, n, self._timed(n, getattr(pager, n)))

    def _timed(self, n, fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.s[n] += time.perf_counter() - t0
        return run


def _serve(svc, calls, clk, spans=None):
    """Every call through `svc`; returns (response tuples, seconds, and
    each call's pager span seconds when `spans` is given)."""
    t, out, per_call = 0.0, [], []
    for items in calls:
        before = dict(spans.s) if spans is not None else None
        t0 = time.perf_counter()
        resp = asyncio.run(svc.get_rate_limits([RateLimitReq(**kw) for kw in items]))
        t += time.perf_counter() - t0
        if spans is not None:
            per_call.append({n: spans.s[n] - before[n] for n in spans.NAMES})
        out.append([(r.status, r.limit, r.remaining, r.reset_time, r.error) for r in resp])
        clk.advance(700)
    clk.advance(-700 * len(calls))  # the next engine starts at the same time
    return out, t, per_call


def phase_main_path(rng, image: SlotTable, size: Size, card: str):
    """One CPU reference engine (flat, fused) and, on the same calls and
    frozen clock, a CUDA engine per configuration of the size. Returns
    the lines, and (snapshot of the image, calls, CPU responses, CPU
    snapshot) for the mesh main path."""
    snap = {f: getattr(image, f) for f in SlotTable._fields}
    snap["key_strings"] = {}
    calls = smoke_calls(rng, size.live_keys, size.calls)
    base = dict(num_groups=size.num_groups, ways=WAYS, batch_size=B)
    results = {}
    with _clock.freeze(NOW) as clk:
        ceng = DeviceEngine(EngineConfig(device="cpu", **base))
        try:
            ceng.restore(snap)
            want, _, _ = _serve(V1Service(ceng), calls, clk)
            csnap = ceng.snapshot()
        finally:
            ceng.close()
        pages = None
        if size.page_groups:
            # a call's first wave holds each of its distinct keys once
            keys = [[f"smoke_{kw['unique_key']}" for kw in items] for items in calls]
            pages = [len(np.unique(key_hash128_batch(k, size.num_groups)[2] // size.page_groups))
                     for k in keys]
        for layout, paged in size.configs:
            name = cuda_decide.config_name(layout, paged)
            pcfg = dict(page_groups=size.page_groups, page_budget=size.page_budget) if paged else {}
            geng = DeviceEngine(EngineConfig(device=DEVICE.type, layout=layout, **base, **pcfg))
            try:
                geng.restore(snap)
                st0 = geng.stats()
                spans = _PagerSpans(geng._pager) if paged else None
                sync()
                cuda_decide.reset_launches()
                got, secs, per_call = _serve(V1Service(geng), calls, clk, spans)
                launches = dict(cuda_decide.CONFIG_LAUNCHES)
                gst = geng.stats()
                gsnap = geng.snapshot()
                phase_census(geng, size, name, False, card)
            finally:
                geng.close()
            mismatches = sum(a != b for gc, wc in zip(got, want) for a, b in zip(gc, wc))
            errors = sum(bool(r[4]) for gc in got for r in gc)
            snap_diff = [f for f in SlotTable._fields if not np.array_equal(gsnap[f], csnap[f])]
            if gsnap["key_strings"] != csnap["key_strings"]:
                snap_diff.append("key_strings")
            del gsnap
            decisions = sum(len(c) for c in calls)
            res = {"phase": "main_path", "size": size.name, "kernel": name,
                   "calls": len(calls), "items": decisions,
                   "flushes": gst["flushes"], "waves": gst["waves"],
                   "engine_kernel_launches": gst["kernel_launches"],
                   "launches": launches[name],
                   "other_kernel_launches": sum(launches.values()) - launches[name],
                   "response_mismatches": mismatches, "error_responses": errors,
                   "snapshot_columns_differing": snap_diff,
                   "over_limit": gst["over_limit"], "cache_hits": gst["cache_hits"],
                   "cache_misses": gst["cache_misses"],
                   "unexpired_evictions": gst["unexpired_evictions"],
                   "decisions_per_s": decisions / secs, "seconds": secs}
            if paged:
                res.update({k: gst[k] - st0[k] for k in ("promotes", "demotes", "binds")})
                res.update(resident_pages=gst["resident_pages"], host_pages=gst["host_pages"],
                           host_pages_after_restore=st0["host_pages"],
                           pages_touched_first_wave=pages)
                # demotes run inside _promote_one: a promote's own time
                # is the difference
                s = spans.s
                moved_in = res["promotes"] + res["binds"]
                res.update(
                    ensure_resident_s=s["ensure_resident"], demote_s=s["demote"],
                    promote_s=s["_promote_one"] - s["demote"],
                    demote_ms_each=s["demote"] / max(res["demotes"], 1) * 1e3,
                    promote_ms_each=(s["_promote_one"] - s["demote"]) / max(moved_in, 1) * 1e3,
                    ensure_resident_s_per_call=[c["ensure_resident"] for c in per_call],
                )
            emit(res)
            if mismatches or snap_diff or errors:
                raise AssertionError(f"{name}: main path disagrees with the CPU engine")
            if not (launches[name] == gst["kernel_launches"] == gst["waves"] > 0):
                raise AssertionError(f"{name}: kernel launches do not match the waves")
            if res["other_kernel_launches"]:
                raise AssertionError(f"{name}: another configuration was launched")
            if paged and not (res["promotes"] > 0 and res["demotes"] > 0):
                raise AssertionError(f"{name}: no page was promoted and demoted")
            results[name] = res
            free_device()
    return results, (snap, calls, want, csnap)


def phase_mesh_main_path(size: Size, reference, card: str):
    """`V1Service` over an `IciEngine` of MESH_SHARDS shards on the card,
    per layout of the size (flat at 1M, paged at 10M: the page budget
    split into one frame pool per shard), on the calls and frozen clock
    of the main path, against the CPU engine's responses and snapshot
    (`reference`, from `phase_main_path`). One sharded-kernel launch per
    wave; no other configuration launches."""
    snap, calls, want, csnap = reference
    base = dict(num_groups=size.num_groups, ways=WAYS, batch_size=B,
                devices=[DEVICE] * MESH_SHARDS)
    results = {}
    with _clock.freeze(NOW) as clk:
        for layout, paged in size.configs:
            name = cuda_decide.sharded_name(layout)
            pcfg = dict(page_groups=size.page_groups, page_budget=size.page_budget) if paged else {}
            eng = IciEngine(IciEngineConfig(layout=layout, **base, **pcfg))
            try:
                eng.restore(snap)
                st0 = eng.stats()
                spans = _PagerSpans(eng._pager) if paged else None
                sync()
                cuda_decide.reset_launches()
                got, secs, _ = _serve(V1Service(eng), calls, clk, spans)
                launches = dict(cuda_decide.CONFIG_LAUNCHES)
                st = eng.stats()
                msnap = eng.snapshot()
                shard_pages = eng._pager.pages_snapshot()["shards"] if paged else None
                phase_census(eng, size, name, True, card, timed=not paged)
            finally:
                eng.close()
            mismatches = sum(a != b for gc, wc in zip(got, want) for a, b in zip(gc, wc))
            errors = sum(bool(r[4]) for gc in got for r in gc)
            snap_diff = [f for f in SlotTable._fields if not np.array_equal(msnap[f], csnap[f])]
            if msnap["key_strings"] != csnap["key_strings"]:
                snap_diff.append("key_strings")
            del msnap
            decisions = sum(len(c) for c in calls)
            res = {"phase": "mesh_main_path", "size": size.name, "kernel": name,
                   "shards": st["n_dev"], "paged": paged, "calls": len(calls),
                   "items": decisions, "flushes": st["flushes"], "waves": st["waves"],
                   "engine_kernel_launches": st["kernel_launches"],
                   "launches": launches[name],
                   "other_kernel_launches": sum(launches.values()) - launches[name],
                   "response_mismatches": mismatches, "error_responses": errors,
                   "snapshot_columns_differing": snap_diff,
                   "over_limit": st["over_limit"], "cache_hits": st["cache_hits"],
                   "cache_misses": st["cache_misses"],
                   "decisions_per_s": decisions / secs, "seconds": secs}
            if paged:
                res.update({k: st[k] - st0[k] for k in ("promotes", "demotes", "binds")})
                res.update(resident_pages=st["resident_pages"], host_pages=st["host_pages"],
                           host_pages_after_restore=st0["host_pages"],
                           shard_pages=shard_pages, ensure_resident_s=spans.s["ensure_resident"],
                           demote_s=spans.s["demote"],
                           promote_s=spans.s["_promote_one"] - spans.s["demote"])
            emit(res)
            if mismatches or snap_diff or errors:
                raise AssertionError(f"{name}: the mesh main path disagrees with the CPU engine")
            if not (launches[name] == st["kernel_launches"] == st["waves"] > 0):
                raise AssertionError(f"{name}: kernel launches do not match the waves")
            if res["other_kernel_launches"]:
                raise AssertionError(f"{name}: another configuration was launched")
            if paged and not (res["promotes"] > 0 and res["demotes"] > 0):
                raise AssertionError(f"{name}: no page was promoted and demoted")
            results[(name, size.name)] = res
            free_device()
    return results


# ---------------------------------------------------------------------------
# the columnar edge (wire bytes -> check_columns -> wire bytes) and the
# two-stage pipeline

# The edge's mechanism check takes a whole call in one flush: the calls'
# hottest key repeats about 120 times in a call, and check_columns
# declines a batch of more waves than max_waves (the default 32, which
# no deployment setting of either package raises) to the object path.
# The edge's served rate at the default is the object path's, measured
# in the same phase.
EDGE_MAX_WAVES = ITEMS
_REQ_FIELDS = (("name", 1, 2), ("unique_key", 2, 2), ("hits", 3, 0), ("limit", 4, 0),
               ("duration", 5, 0), ("algorithm", 6, 0), ("behavior", 7, 0), ("burst", 8, 0))


def encode_request(items) -> bytes:
    """GetRateLimitsReq bytes of one call's item dicts, as protobuf
    writes them (fields in number order, zero values omitted)."""
    _varint = wire.varint
    out = bytearray()
    for kw in items:
        body = bytearray()
        for name, num, wt in _REQ_FIELDS:
            v = kw.get(name)
            if not v:
                continue
            body.append(num << 3 | wt)
            if wt == 2:
                raw = v.encode("utf-8")
                body += _varint(len(raw)) + raw
            else:
                body += _varint(int(v))
        out.append(0x0A)
        out += _varint(len(body)) + body
    return bytes(out)


def _serve_bytes(svc, bodies, clk):
    """Every call's bytes through `serve_get_rate_limits_bytes`; returns
    (response bytes, seconds, each call's columnar flushes)."""
    t, out, columnar = 0.0, [], []
    for data in bodies:
        c0 = svc.engine.stats()["columnar_flushes"]
        t0 = time.perf_counter()
        out.append(asyncio.run(serve_get_rate_limits_bytes(svc, data)))
        t += time.perf_counter() - t0
        columnar.append(svc.engine.stats()["columnar_flushes"] - c0)
        clk.advance(700)
    clk.advance(-700 * len(bodies))
    return out, t, columnar


def _serve_splice_order(svc, calls, clk):
    """The object path in the edge's order: per call its non-Gregorian
    items, then its Gregorian ones (the edge splices those in after the
    columnar decide, as the JAX package's does); the answers in request
    order, encoded as a GetRateLimitsResp."""
    out = []
    for items in calls:
        resp = [None] * len(items)
        greg = [i for i, kw in enumerate(items) if kw["behavior"] & 4]
        rest = [i for i, kw in enumerate(items) if not kw["behavior"] & 4]
        for idx in (rest, greg):
            if idx:
                got = asyncio.run(svc.get_rate_limits([RateLimitReq(**items[i]) for i in idx]))
                for i, r in zip(idx, got):
                    resp[i] = r
        out.append(wire.encode_responses(resp))
        clk.advance(700)
    clk.advance(-700 * len(calls))
    return out


def _snap_diff(a, b) -> list:
    diff = [f for f in SlotTable._fields if not np.array_equal(a[f], b[f])]
    if a["key_strings"] != b["key_strings"]:
        diff.append("key_strings")
    return diff


def _edge_engine(size, layout, paged, mesh, on=None, **kw):
    """An engine of the size on the card (or on `on`)."""
    on = DEVICE if on is None else on
    pcfg = dict(page_groups=size.page_groups, page_budget=size.page_budget) if paged else {}
    base = dict(num_groups=size.num_groups, ways=WAYS, batch_size=B, layout=layout, **pcfg, **kw)
    if mesh:
        return IciEngine(IciEngineConfig(devices=[on] * MESH_SHARDS, **base))
    return DeviceEngine(EngineConfig(device=torch.device(on).type, **base))


def _edge_configs(size):
    """(kernel name, layout, paged, mesh) of every engine the edge and
    pipeline phases drive at this size."""
    return ([(cuda_decide.config_name(lay, p), lay, p, False) for lay, p in size.configs]
            + [(cuda_decide.sharded_name(lay), lay, p, True) for lay, p in size.configs])


def phase_edge_main_path(size: Size, reference):
    """`serve_get_rate_limits_bytes` (the columnar edge) over the main
    path's calls, as GetRateLimitsReq bytes, on the frozen clock: once on
    a CPU engine (flat, fused: the plain version) and, on the card, on a
    DeviceEngine per configuration of the size and on an IciEngine of 8
    shards per layout. The CPU edge must answer as the CPU object path
    does in the edge's order (`_serve_splice_order`); every card run must
    give the CPU edge's response bytes and snapshot (key strings
    included), one kernel launch per wave and no other configuration's,
    and serve every call that is not all-Gregorian through the columnar
    path (one columnar flush each), the Gregorian items spliced through
    the object path."""
    snap, calls, _want, _csnap = reference
    bodies = [encode_request(items) for items in calls]
    n_greg = [sum(1 for kw in items if kw["behavior"] & 4) for items in calls]
    must_columnar = sum(1 for items, g in zip(calls, n_greg) if g < len(items))
    repeats = [int(np.unique([kw["unique_key"] for kw in items], return_counts=True)[1].max())
               for items in calls]
    base = dict(num_groups=size.num_groups, ways=WAYS, batch_size=B, max_waves=EDGE_MAX_WAVES)
    results = {}
    with _clock.freeze(NOW) as clk:
        ceng = DeviceEngine(EngineConfig(device="cpu", **base))
        try:
            ceng.restore(snap)
            want, _, _ = _serve_bytes(V1Service(ceng), bodies, clk)
            csnap = ceng.snapshot()
        finally:
            ceng.close()
        oeng = DeviceEngine(EngineConfig(device="cpu", **base))
        try:
            oeng.restore(snap)
            obj = _serve_splice_order(V1Service(oeng), calls, clk)
            osnap = oeng.snapshot()
        finally:
            oeng.close()
        obj_mismatch = sum(a != b for a, b in zip(want, obj))
        if obj_mismatch or _snap_diff(osnap, csnap):
            raise AssertionError(f"{size.name}: the CPU edge disagrees with the object path")
        del osnap
        for name, layout, paged, mesh in _edge_configs(size):
            eng = _edge_engine(size, layout, paged, mesh, max_waves=EDGE_MAX_WAVES)
            try:
                eng.restore(snap)
                st0 = eng.stats()
                sync()
                cuda_decide.reset_launches()
                got, secs, columnar = _serve_bytes(V1Service(eng), bodies, clk)
                launches = dict(cuda_decide.CONFIG_LAUNCHES)
                st = eng.stats()
                esnap = eng.snapshot()
            finally:
                eng.close()
            decisions = sum(len(c) for c in calls)
            res = {"phase": "edge_main_path", "size": size.name, "kernel": name,
                   "mesh": mesh, "paged": paged, "calls": len(calls), "items": decisions,
                   "max_waves": EDGE_MAX_WAVES, "default_max_waves": False,
                   "max_key_repeats_per_call": repeats,
                   "response_bytes_mismatches": sum(a != b for a, b in zip(got, want)),
                   "object_path_mismatches": sum(a != b for a, b in zip(got, obj)),
                   "snapshot_columns_differing": _snap_diff(esnap, csnap),
                   "columnar_flushes": st["columnar_flushes"] - st0["columnar_flushes"],
                   "columnar_calls": sum(1 for c in columnar if c == 1),
                   "calls_not_all_gregorian": must_columnar,
                   "spliced_items": sum(n_greg), "object_path_flushes": st["flushes"] - st0["flushes"],
                   "waves": st["waves"] - st0["waves"],
                   "engine_kernel_launches": st["kernel_launches"] - st0["kernel_launches"],
                   "launches": launches[name],
                   "other_kernel_launches": sum(launches.values()) - launches[name],
                   "over_limit": st["over_limit"] - st0["over_limit"],
                   "decisions_per_s": decisions / secs, "seconds": secs}
            if paged:
                res.update({k: st[k] - st0[k] for k in ("promotes", "demotes", "binds")})
            del esnap
            emit(res)
            if res["response_bytes_mismatches"] or res["object_path_mismatches"] \
                    or res["snapshot_columns_differing"]:
                raise AssertionError(f"{name}: the edge disagrees with the CPU engine")
            if not (res["launches"] == res["engine_kernel_launches"] == res["waves"] > 0):
                raise AssertionError(f"{name}: edge kernel launches do not match the waves")
            if res["other_kernel_launches"]:
                raise AssertionError(f"{name}: another configuration was launched")
            if res["columnar_calls"] != must_columnar:
                raise AssertionError(f"{name}: a call that is not all-Gregorian was served "
                                     "without the columnar path")
            results[(name, size.name)] = res
            free_device()
        # The same bytes at the engines' default max_waves, what a
        # deployment runs: every call's hottest key repeats more often
        # than that, so the edge declines each call (nothing committed)
        # and the object path serves it from the native parse. Its bytes
        # and snapshot must be the CPU object path's (the main path's
        # reference), in request order.
        max_waves = EngineConfig.max_waves
        if min(repeats) <= max_waves:
            raise AssertionError(f"{size.name}: a call fits the default max_waves; the "
                                 "default-setting edge run expects none to")
        want_obj = [wire.encode_responses([RateLimitResp(*t) for t in call]) for call in _want]
        # paged: at the JAX default (the background demoter every 2 s)
        for name, layout, paged, mesh in _edge_configs(size):
            eng = _edge_engine(size, layout, paged, mesh)
            interval = eng.cfg.page_demote_interval_s if paged else None
            try:
                eng.restore(snap)
                st0 = eng.stats()
                sync()
                cuda_decide.reset_launches()
                got, secs, columnar = _serve_bytes(V1Service(eng), bodies, clk)
                launches = dict(cuda_decide.CONFIG_LAUNCHES)
                st = eng.stats()
                esnap = eng.snapshot()
            finally:
                eng.close()
            decisions = sum(len(c) for c in calls)
            res = {"phase": "edge_main_path", "size": size.name, "kernel": name,
                   "mesh": mesh, "paged": paged, "calls": len(calls), "items": decisions,
                   "max_waves": max_waves, "default_max_waves": True,
                   "page_demote_interval_s": interval,
                   "max_key_repeats_per_call": repeats,
                   "response_bytes_mismatches": sum(a != b for a, b in zip(got, want_obj)),
                   "snapshot_columns_differing": _snap_diff(esnap, _csnap),
                   "columnar_flushes": st["columnar_flushes"] - st0["columnar_flushes"],
                   "columnar_calls": sum(1 for c in columnar if c == 1),
                   "object_path_flushes": st["flushes"] - st0["flushes"],
                   "waves": st["waves"] - st0["waves"], "launches": launches[name],
                   "decisions_per_s": decisions / secs, "seconds": secs}
            if paged:
                res.update({k: st[k] - st0[k] for k in ("promotes", "demotes", "binds")})
            del esnap
            emit(res)
            if res["response_bytes_mismatches"] or res["snapshot_columns_differing"]:
                raise AssertionError(f"{name}: the default-setting edge disagrees with the "
                                     "CPU object path")
            if res["columnar_flushes"] or res["launches"] != res["waves"]:
                raise AssertionError(f"{name}: the default-setting edge ran columnar, or its "
                                     "launches do not match the waves")
            results[(name, size.name, "default", interval)] = res
            free_device()
    return results


# The pipeline's mechanism check holds each flush's device work this
# many cycles longer (about 20 ms at the H100's 1.98 GHz), longer than
# the pump's dispatch of a flush (4-8 ms at 1M), so that the device and
# not the host is the bottleneck.
PIPE_HOLD_CYCLES = 40_000_000
# Pipeline depths per engine, in turns; the last turn is the held run.
# The paged (10M) engines take depth 1 and the held run at depth 2 (their
# unheld depth-2 run is the main path's): each of their runs costs about
# 6.5 s on the card, and the whole script has a time limit.
PIPE_TURNS = (1, 2, 2, 1, 2)
PIPE_TURNS_PAGED = (1, 2)


class _StageSpans:
    """Host-clock spans of an engine's two pipeline stages, one per
    flush: `_dispatch` (the pump: hash, assemble, encode, launch) and
    `_complete` (the completion thread at depth 2, the pump at depth 1:
    the event, the counts, the futures). With `hold_cycles`, each flush
    first queues a spin of that many cycles on the engine's stream
    (`torch.cuda._sleep`), so the flush's device work outlasts the next
    dispatch; the decisions are unchanged. The methods are wrapped on
    this one instance; the engine is unchanged."""

    def __init__(self, eng, hold_cycles: int = 0):
        self.dispatch, self.complete = [], []
        dispatch, complete, execute = eng._dispatch, eng._complete, eng._execute_waves

        def timed(fn, out):
            def run(*a):
                t0 = time.perf_counter()
                try:
                    return fn(*a)
                finally:
                    out.append(time.perf_counter() - t0)
            return run

        def held(*a):
            with eng._on_stream():
                torch.cuda._sleep(hold_cycles)
            return execute(*a)

        eng._dispatch = timed(dispatch, self.dispatch)
        eng._complete = timed(complete, self.complete)
        if hold_cycles:
            eng._execute_waves = held

    def summary(self) -> dict:
        ms = lambda v: 1e3 * statistics.median(v) if v else None  # noqa: E731
        return {"dispatch_ms_median": ms(self.dispatch), "complete_ms_median": ms(self.complete),
                "dispatch_s": sum(self.dispatch), "complete_s": sum(self.complete)}


def phase_pipeline(size: Size, reference):
    """The object path (`V1Service.get_rate_limits`) at pipeline_depth 1
    and 2, in turns (1, 2, 2, 1 on a flat table: the host's noise between
    runs is as large as the effect; 1, 2 on a paged one) on the same
    calls and frozen clock, for every
    engine of the size (DeviceEngine per configuration, IciEngine per
    layout): every run's responses and snapshot equal to the CPU
    engine's (the main path's reference); per run the most flushes in
    flight (counted from the end of a flush's dispatch to the end of its
    completion, as the JAX engine counts them) and the host spans of
    the two stages; paged, the pager's host-clock spans. Then one
    mechanism check per engine at depth 2 (`held`): each flush's device
    work held PIPE_HOLD_CYCLES longer, answers still equal; on a flat
    table two flushes must then be in flight (a dispatch that waited on
    the stream or the device would keep one). A paged engine's pager
    copies a demoted frame to the host inside dispatch, which waits on
    the stream: its count is reported, not required."""
    snap, calls, want, csnap = reference
    results = {}
    with _clock.freeze(NOW) as clk:
        for name, layout, paged, mesh in _edge_configs(size):
            turns = PIPE_TURNS_PAGED if paged else PIPE_TURNS
            for turn, depth in enumerate(turns):
                held = turn == len(turns) - 1
                eng = _edge_engine(size, layout, paged, mesh, pipeline_depth=depth)
                try:
                    eng.restore(snap)
                    st0 = eng.stats()
                    spans = _PagerSpans(eng._pager) if paged else None
                    stages = _StageSpans(eng, PIPE_HOLD_CYCLES if held else 0)
                    sync()
                    cuda_decide.reset_launches()
                    got, secs, _ = _serve(V1Service(eng), calls, clk, spans)
                    launches = dict(cuda_decide.CONFIG_LAUNCHES)
                    st = eng.stats()
                    psnap = eng.snapshot()
                finally:
                    eng.close()
                decisions = sum(len(c) for c in calls)
                res = {"phase": "pipeline", "size": size.name, "kernel": name, "mesh": mesh,
                       "paged": paged, "pipeline_depth": depth, "turn": turn, "held": held,
                       "hold_cycles": PIPE_HOLD_CYCLES if held else 0,
                       "response_mismatches": sum(a != b for gc, wc in zip(got, want)
                                                  for a, b in zip(gc, wc)),
                       "snapshot_columns_differing": _snap_diff(psnap, csnap),
                       "flushes": st["flushes"] - st0["flushes"],
                       "waves": st["waves"] - st0["waves"], "launches": launches[name],
                       "inflight_max": st["inflight_max"], **stages.summary(),
                       "stages": stage_stats(eng.metrics),
                       "pipeline_overlap_p50": eng.metrics.pipeline_overlap.summary()["p50"],
                       "decisions_per_s": decisions / secs, "seconds": secs}
                if paged:
                    res.update({k: st[k] - st0[k] for k in ("promotes", "demotes", "binds")})
                    res.update(ensure_resident_s=spans.s["ensure_resident"],
                               demote_s=spans.s["demote"],
                               promote_s=spans.s["_promote_one"] - spans.s["demote"])
                del psnap
                emit(res)
                if res["response_mismatches"] or res["snapshot_columns_differing"]:
                    raise AssertionError(f"{name}: depth {depth} disagrees with the CPU engine")
                if res["launches"] != res["waves"]:
                    raise AssertionError(f"{name}: kernel launches do not match the waves")
                if held and not paged and res["inflight_max"] < 2:
                    raise AssertionError(f"{name}: with the device the bottleneck, depth 2 "
                                         "never had two flushes in flight")
                results[(name, size.name, turn)] = res
                free_device()
    return results


# ---------------------------------------------------------------------------
# the observatories (census and admission scans), the page moves and the
# census-gated background demoter

CENSUS_REPS = 10
# Cycles the stream spins before a timed scan (about 10 ms), longer than
# the host takes to enqueue the scan's torch ops, so that the window
# holds device work only
SCAN_HOLD_CYCLES = 20_000_000
_CENSUS_FIELDS = (("live", "live"), ("full_groups", "full_groups"), ("waste", "waste"),
                  ("age_ms_hist", "age_hist"), ("age_ms_sum", "age_sum"),
                  ("idle_ms_hist", "idle_hist"), ("idle_ms_sum", "idle_sum"),
                  ("heatmap", "heatmap"), ("cold_heatmap", "cold_heatmap"),
                  ("fill_hist", "fill_hist"), ("max_full_run", "max_full_run"))
_ADMISSION_FIELDS = (("keys", "keys"), ("admitted_hits", "admitted_sum"),
                     ("limit_hits", "limit_sum"), ("excess_hits", "excess_sum"),
                     ("excess_keys", "excess_keys"), ("max_excess", "max_excess"),
                     ("over_limit_keys", "over_limit_keys"), ("excess_hist", "excess_hist"))


def _ops_per_call(fn, reps=3) -> float:
    """Device operations (kernels, copies, memsets) per call of `fn`, from
    torch.profiler over `reps` calls between `_device_ops`' marker fills
    (float fills, which `fn`'s own int fills are not)."""
    ops = _device_ops(fn, reps)
    return sum(1 for n in ops if "FillFunctor<float>" not in n) / reps


def _stop_demoter(eng) -> None:
    """Stop an engine's background demoter (close() does it too), so that
    its table holds still between a scan and the scan's host copy."""
    eng._demote_stop.set()
    if eng._demote_thread is not None:
        eng._demote_thread.join()


def _scanned_rows(eng, fields=SlotTable._fields) -> SlotTable:
    """The engine's scanned table (a paged table's physical frames) as
    wide host rows: `fields` copied, the other columns zero."""
    with eng._lock, eng._on_stream():
        wide = eng.K.to_wide(eng.table)
        n = wide.num_slots
        return SlotTable(*(getattr(wide, f).cpu().numpy() if f in fields
                           else np.zeros(n, SLOT_DTYPES[f]) for f in SlotTable._fields))


# the columns the census and admission oracles read
_ORACLE_FIELDS = ("used", "algo", "status", "limit", "duration", "remaining", "stamp",
                  "expire_at", "lru")


def phase_census(eng, size: Size, name: str, mesh: bool, card: str, timed: bool = True):
    """`table_census(max_age_s=0)` and `admission_snapshot(max_age_s=0)`
    of a live engine after its serving run, against the port's numpy
    oracles over the same table copied to the host, field for field (the
    table's tier; a paged table's host tier is censused by the engine with
    those oracles already); then the device time of one census and one
    admission scan (CUDA events, L2 flushed, stream held busy while the
    host enqueues, median of CENSUS_REPS), the host time of a whole
    snapshot with its read-back, the device memory one scan adds at its
    peak, and the byte bound (the scanned table read once). Without
    `timed` the check alone: the 10M mesh engines' scans are the
    DeviceEngines' programs over a table of the same size, timed on
    those."""
    _stop_demoter(eng)
    sync()
    cfg = eng.cfg
    now = eng.now_fn()
    census = eng.table_census(max_age_s=0)
    admission = eng.admission_snapshot(max_age_s=0)
    rows = _scanned_rows(eng, _ORACLE_FIELDS)
    want_c = census_oracle(rows, now, ways=cfg.ways, heatmap_width=cfg.census_heatmap_width,
                           thresholds=tuple(cfg.census_thresholds))
    want_a = admission_oracle(rows, now)
    slots = rows.num_slots
    del rows
    tier = census["tiers"][eng.topo.primary_tier]
    bad = [k for k, o in _CENSUS_FIELDS if np.asarray(tier[k]).tolist() != np.asarray(want_c[o]).tolist()]
    if [c["slots"] for c in tier["cold"]] != want_c["cold"].tolist():
        bad.append("cold")
    atier = admission["tiers"][eng.topo.primary_tier]
    bad += [k for k, o in _ADMISSION_FIELDS
            if np.asarray(atier[k]).tolist() != np.asarray(want_a[o]).tolist()]

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)  # > the H100's 50 MB L2
    view = eng._census_view(eng.table)
    times = {"census": None, "admission": None}
    for scan, fn in (("census", eng._census), ("admission", eng._admission)) if timed else ():
        fn(view, now)
        sync()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn(view, now)
        sync()
        peak = torch.cuda.max_memory_allocated() - base
        ms = _median_ms(lambda: fn(view, now), CENSUS_REPS, flush, hold_cycles=SCAN_HOLD_CYCLES)
        t0 = time.perf_counter()
        (eng.table_census if scan == "census" else eng.admission_snapshot)(max_age_s=0)
        times[scan] = {"device_ms_median": ms, "snapshot_host_ms": (time.perf_counter() - t0) * 1e3,
                       "peak_added_gb": peak / 1e9,
                       "device_ops_per_scan": _ops_per_call(lambda: fn(view, now))}
    del flush
    table_bytes = slots * BYTES_PER_SLOT[cfg.layout]
    res = {"phase": "census", "size": size.name, "kernel": name, "mesh": mesh,
           "paged": eng._pager is not None, "slots_scanned": slots, "live": census["live"],
           "tiers": {k: v["live"] for k, v in census["tiers"].items()},
           "cold_slots": [c["slots"] for c in census["cold"]],
           "admission_keys": admission["keys"], "fields_differing": bad,
           "table_bytes": table_bytes, "bound_ms": table_bytes / HBM_BYTES_PER_S * 1e3,
           "bound_by": "bytes", "census": times["census"], "admission": times["admission"],
           "card": card}
    emit(res)
    if bad:
        raise AssertionError(f"{name}: the census or admission snapshot disagrees with the oracles")
    return res


def phase_wavescan_oracles(rng, image, size: Size, layout: str, page_map, kt):
    """ROADMAP queue 1 item 3's check: for kernel rows 1-3b, WAVESCAN_WAVES
    waves of the wave kernel on the card, each wave's five WaveScan sums
    against `admission_oracle(rows, now)` and `census_oracle(rows, now,
    ways=1)` over the rows it wrote (`gather_rows(table, out.slot)`), as
    the JAX package's tests/test_kernel_fuzz.py holds its kernel."""
    name = cuda_decide.config_name(layout, page_map is not None)
    data = kt.data if isinstance(kt, PagedTable) else kt
    gather = get_kernels(layout).gather_rows
    now, bad, live = NOW, [], 0
    for w in range(WAVESCAN_WAVES):
        now += int(rng.choice([0, 700, 5000]))
        hb = smoke_wave(rng, image, now, size.num_groups)
        out, scan = run_kernel(kt, batch_to_device(hb, DEVICE), now, layout, size.page_groups)
        rows = SlotTable(*(c.cpu().numpy() for c in gather(data, out.slot)))
        adm, cen = admission_oracle(rows, now), census_oracle(rows, now, ways=1)
        got = {f: int(getattr(scan, f)) for f in scan._fields}
        want = {"adm_keys": adm["keys"], "adm_admitted": adm["admitted_sum"],
                "adm_limit": adm["limit_sum"], "census_live": cen["live"],
                "census_waste": cen["waste"]}
        live += got["census_live"]
        bad += [(w, f) for f in want if got[f] != want[f]]
    del data
    emit({"phase": "wavescan_oracles", "size": size.name, "kernel": name,
          "waves": WAVESCAN_WAVES, "lanes": B, "census_live_total": live,
          "sums_differing": bad,
          "sharded_kernel": "left out: the sharded wave's psum'd slot is not a global slot "
                            "index (ROADMAP.md section 3), so the rows it wrote cannot be "
                            "gathered by slot"})
    if bad or not live:
        raise AssertionError(f"{name}: WaveScan sums disagree with the oracles")


WAVESCAN_WAVES = 4
PAGE_MOVES = 16


def _ev_ms(fn):
    """(result, device ms between events around `fn`, host ms), the
    stream idle before."""
    sync()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    s.record()
    out = fn()
    e.record()
    e.synchronize()
    return out, s.elapsed_time(e), (time.perf_counter() - t0) * 1e3


def phase_page_moves(rng, image, size: Size, layout: str, card: str):
    """The insides of a demote and a promote at 10M (a 4,096-group page
    of 32,768 slots), PAGE_MOVES pages each, medians: the one-copy path
    the pager runs (`read_page`: the frame's packed rows transposed on
    the card, one copy to a pinned buffer, unpacked on the host;
    `write_page`: packed column by column into a pinned buffer, one copy,
    transposed into the frame on the card), whole and part by part,
    beside, in the same run, the
    per-column path it replaced (written here: a gather into wide
    columns on the card and one blocking copy per column; a promote's
    copy from pageable memory); the frame's zeroing and the page-map
    write of an unbind. The host rows of both demote paths must be
    bit-equal (and equal to the image's page)."""
    from gubernator_tpu_torch.ops.paged import make_paged_kernels

    PK = make_paged_kernels(layout, size.num_groups, WAYS, size.page_groups, size.page_budget,
                            DEVICE)
    pt = PK.create()
    ps, mod = PK.page_slots, LAYOUT[layout]
    pages = rng.choice(PK.num_logical_pages, PAGE_MOVES, replace=False)
    frames = rng.choice(size.page_budget, PAGE_MOVES, replace=False)
    host_pages = {int(lp): {f: np.ascontiguousarray(getattr(image, f)[lp * ps:(lp + 1) * ps])
                            for f in SlotTable._fields} for lp in pages}

    def old_demote_rows(pp):
        """runtime/pager.py's demote before this change: the rows
        gathered into wide columns on the card, then a blocking copy per
        column."""
        rows, gather_ms, _ = _ev_ms(lambda: PK.extract_page(pt, pp))
        t0 = time.perf_counter()
        host = {f: getattr(rows, f).cpu().numpy() for f in SlotTable._fields}
        return host, gather_ms, (time.perf_counter() - t0) * 1e3

    def old_promote(lp, pp, rows):
        t0 = time.perf_counter()
        packed = mod.pack_table(SlotTable(**rows), None).data
        pack_ms = (time.perf_counter() - t0) * 1e3
        frame = pt.data.data[pp * ps:(pp + 1) * ps]
        _, copy_ms, copy_host_ms = _ev_ms(lambda: frame.copy_(packed))  # pageable
        return pack_ms, copy_ms, copy_host_ms

    lines = {k: [] for k in (
        "old_demote_gather_ms", "old_demote_copies_host_ms", "old_demote_total_host_ms",
        "new_demote_total_host_ms", "new_demote_copy_ms", "new_demote_copy_host_ms",
        "new_demote_unpack_host_ms", "unbind_zero_ms", "unbind_map_write_ms",
        "unbind_map_write_host_ms", "old_promote_pack_host_ms", "old_promote_copy_ms",
        "old_promote_copy_host_ms", "new_promote_total_host_ms", "new_promote_pack_host_ms",
        "new_promote_copy_ms", "new_promote_transpose_ms")}
    mismatched = []
    # read_page's and write_page's parts, one by one, on their own buffers
    buf = torch.empty((pt.data.data.shape[1], ps), dtype=torch.int64, pin_memory=True)
    wbuf = torch.empty_like(buf, pin_memory=True)
    for lp, pp in zip(pages.tolist(), frames.tolist()):
        # promote, old then new (the new one is what the frame keeps)
        pack_ms, copy_ms, copy_host_ms = old_promote(lp, pp, host_pages[lp])
        lines["old_promote_pack_host_ms"].append(pack_ms)
        lines["old_promote_copy_ms"].append(copy_ms)
        lines["old_promote_copy_host_ms"].append(copy_host_ms)
        sync()
        t0 = time.perf_counter()
        PK.write_page(pt, lp, pp, SlotTable(**host_pages[lp]))
        lines["new_promote_total_host_ms"].append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        CODEC[layout].pack_rows(fused.wide_columns(SlotTable(**host_pages[lp])), dim=0, out=wbuf)
        lines["new_promote_pack_host_ms"].append((time.perf_counter() - t0) * 1e3)
        frame = pt.data.data[pp * ps:(pp + 1) * ps]
        cols, copy_ms, _ = _ev_ms(lambda: wbuf.to(DEVICE, non_blocking=True))
        lines["new_promote_copy_ms"].append(copy_ms)
        lines["new_promote_transpose_ms"].append(_ev_ms(lambda: frame.copy_(cols.t()))[1])
        # demote: old path, then the one-copy path, then its parts
        sync()
        t0 = time.perf_counter()
        old, gather_ms, copies_ms = old_demote_rows(pp)
        lines["old_demote_total_host_ms"].append((time.perf_counter() - t0) * 1e3)
        lines["old_demote_gather_ms"].append(gather_ms)
        lines["old_demote_copies_host_ms"].append(copies_ms)
        sync()
        t0 = time.perf_counter()
        new = PK.read_page(pt, pp)
        lines["new_demote_total_host_ms"].append((time.perf_counter() - t0) * 1e3)
        _, copy_ms, copy_host_ms = _ev_ms(
            lambda: buf.copy_(frame.t().contiguous(), non_blocking=True))
        lines["new_demote_copy_ms"].append(copy_ms)
        lines["new_demote_copy_host_ms"].append(copy_host_ms)
        t0 = time.perf_counter()
        wide = mod.unpack_table(type(pt.data)(buf.t()))
        {f: np.array(getattr(wide, f).numpy()) for f in SlotTable._fields}
        lines["new_demote_unpack_host_ms"].append((time.perf_counter() - t0) * 1e3)
        for f in SlotTable._fields:
            if not (np.array_equal(old[f], new[f]) and old[f].dtype == new[f].dtype
                    and np.array_equal(new[f], host_pages[lp][f])):
                mismatched.append((lp, f))
        # the unbind's two device operations
        lines["unbind_zero_ms"].append(_ev_ms(lambda: frame.zero_())[1])

        def map_write():
            pt.page_map[lp] = -1
        _, w_ms, w_host = _ev_ms(map_write)
        lines["unbind_map_write_ms"].append(w_ms)
        lines["unbind_map_write_host_ms"].append(w_host)
    lp, pp = int(pages[0]), int(frames[0])
    ops = {"demote_device_ops": _ops_per_call(lambda: PK.read_page(pt, pp))
           + _ops_per_call(lambda: PK.unbind_page(pt, lp, pp)),
           "promote_device_ops": _ops_per_call(
               lambda: PK.write_page(pt, lp, pp, SlotTable(**host_pages[lp])))}
    del pt, buf, wbuf, cols
    res = {"phase": "page_moves", **ops, "size": size.name, "layout": layout, "pages": PAGE_MOVES,
           "page_slots": ps, "page_bytes": ps * BYTES_PER_SLOT[layout],
           "page_bound_ms": ps * BYTES_PER_SLOT[layout] / PCIE_BYTES_PER_S * 1e3,
           "rows_differing": mismatched, "card": card}
    res.update({k: statistics.median(v) for k, v in lines.items()})
    emit(res)
    if mismatched:
        raise AssertionError(f"{layout}: the one-copy demote's rows differ from the old path's")
    return res


# PCIe 5.0 x16, one direction (the H100 SXM's host link), for a page
# move's bound
PCIE_BYTES_PER_S = 64e9
DEMOTER_TARGET = 8
DEMOTER_ADVANCE_MS = 30_000


def _expected_victims(rows, pager_state, now, cfg, want):
    """The pages the demoter must take, worked out here from its rule
    (JAX runtime/pager.py `demote_victims`): per shard, while the pool
    holds fewer than `want` free frames, the resident page with the most
    census-cold slots (the cold heatmap at `now`, folded onto frames by
    overlap), then the oldest touch, then the lowest logical page."""
    page_map, touch, free, n_shards, fps, pps, gpp = pager_state
    cen = census_oracle(rows, now, ways=cfg.ways, heatmap_width=cfg.census_heatmap_width,
                        thresholds=tuple(cfg.census_thresholds))
    hm = cen["cold_heatmap"].astype(np.float64)
    per = -(-(rows.num_slots // cfg.ways) // cfg.census_heatmap_width)
    want_out = {}
    for s in range(n_shards):
        res = [lp for lp in np.nonzero(page_map >= 0)[0].tolist()
               if n_shards == 1 or lp // pps == s]
        cold = {}
        for lp in res:
            g0, g1 = int(page_map[lp]) * gpp, (int(page_map[lp]) + 1) * gpp
            cold[lp] = sum(float(hm[r]) * (min(g1, (r + 1) * per) - max(g0, r * per)) / per
                           for r in range(g0 // per, min((g1 - 1) // per, len(hm) - 1) + 1))
        n_free = sum(1 for pp in free if n_shards == 1 or pp // fps == s)
        order = sorted(res, key=lambda lp: (-cold[lp], int(touch[lp]), lp))
        take = order[:max(want - n_free, 0)]
        if any(cold[lp] <= 0 for lp in take):
            raise AssertionError("a page the demoter would take is not census-cold")
        want_out[s] = set(take)
    return want_out


def phase_demoter(size: Size, reference, card: str):
    """The census-gated background demoter at 10M (fused), on a
    DeviceEngine and an IciEngine of 8 shards, interval 0.05 s, target
    DEMOTER_TARGET free frames (per shard on the mesh), census TTL 0.05 s:
    the image restored with every slot just used, the first half of the
    main path's calls served at a frozen clock (nothing census-cold: the
    demoter must not move a page), the clock then advanced
    DEMOTER_ADVANCE_MS so that the slots of shorter windows go cold, and
    the free target awaited with a deadline. The pages it demoted must be
    the census-coldest ones its rule picks (worked out here from the
    table's host copy); then the rest of the calls are served, and every
    answer and the final snapshot must equal a flat engine's on the same
    calls and clock, so no key is lost through demote and promote."""
    snap, calls, _want, _csnap = reference
    hot = dict(snap)
    hot["lru"] = np.where(snap["used"], NOW, 0).astype(np.int64)
    first, rest = calls[:len(calls) // 2], calls[len(calls) // 2:]

    def _answers(eng, items):
        resp = asyncio.run(V1Service(eng).get_rate_limits([RateLimitReq(**kw) for kw in items]))
        return [(r.status, r.limit, r.remaining, r.reset_time, r.error) for r in resp]

    base = dict(num_groups=size.num_groups, ways=WAYS, batch_size=B, layout="fused")
    results = {}
    with _clock.freeze(NOW) as clk:
        flat = DeviceEngine(EngineConfig(device=DEVICE.type, **base))
        try:
            flat.restore(hot)
            want_first = [_answers(flat, items) for items in first]
            clk.advance(DEMOTER_ADVANCE_MS)
            want_rest = []
            for items in rest:
                want_rest.append(_answers(flat, items))
                clk.advance(700)
            fsnap = flat.snapshot()
        finally:
            flat.close()
            clk.advance(-DEMOTER_ADVANCE_MS - 700 * len(rest))
        free_device()
        pcfg = dict(page_groups=size.page_groups, page_budget=size.page_budget,
                    page_demote_interval_s=0.05, page_free_target=DEMOTER_TARGET,
                    census_ttl_s=0.05)
        for mesh in (False, True):
            name = cuda_decide.sharded_name("fused") if mesh else cuda_decide.config_name(
                "fused", True)
            if mesh:
                eng = IciEngine(IciEngineConfig(devices=[DEVICE] * MESH_SHARDS, **base, **pcfg))
            else:
                eng = DeviceEngine(EngineConfig(device=DEVICE.type, **base, **pcfg))
            moves = [0]  # pages the demoter's passes moved (not the demand demotes)
            pager = eng._pager
            victims = pager.demote_victims

            def counted(*a, **k):
                before = pager.demotes
                try:
                    return victims(*a, **k)
                finally:
                    moves[0] += pager.demotes - before

            pager.demote_victims = counted
            try:
                eng.restore(hot)
                got_first = [_answers(eng, items) for items in first]
                time.sleep(0.3)  # several demoter passes: none may move a page
                with eng._lock, eng._on_stream():
                    p = eng._pager
                    state = (p.page_map.copy(), p.touch.copy(), list(p.free), p.n_shards,
                             p.frames_per_shard, p.pages_per_shard, p.PK.groups_per_page)
                    moves_while_hot = moves[0]
                rows = _scanned_rows(eng, ("used", "lru", "duration", "stamp", "expire_at"))
                t0 = time.perf_counter()
                clk.advance(DEMOTER_ADVANCE_MS)
                expect = _expected_victims(rows, state, eng.now_fn(), eng.cfg, DEMOTER_TARGET)
                del rows
                deadline = time.monotonic() + 60
                while True:
                    with eng._lock:
                        p = eng._pager
                        short = [s for s in range(p.n_shards) if p._free_in_shard(s) < DEMOTER_TARGET]
                        if not short:
                            demoted = {s: {lp for lp in np.nonzero((state[0] >= 0)
                                                                   & (p.page_map < 0))[0].tolist()
                                           if p.n_shards == 1 or lp // p.pages_per_shard == s}
                                       for s in range(p.n_shards)}
                            demoter_demotes = moves[0] - moves_while_hot
                            break
                    if time.monotonic() > deadline:
                        raise AssertionError(f"{name}: the demoter never reached its target")
                    time.sleep(0.02)
                reach_s = time.perf_counter() - t0
                got_rest = []
                for items in rest:
                    got_rest.append(_answers(eng, items))
                    clk.advance(700)
                st = eng.stats()
                esnap = eng.snapshot()
            finally:
                eng.close()
                clk.advance(-DEMOTER_ADVANCE_MS - 700 * len(rest))
            mismatches = sum(a != b for gc, wc in zip(got_first + got_rest, want_first + want_rest)
                             for a, b in zip(gc, wc))
            res = {"phase": "demoter", "size": size.name, "kernel": name, "mesh": mesh,
                   "interval_s": 0.05, "free_target": DEMOTER_TARGET,
                   "advance_ms": DEMOTER_ADVANCE_MS, "shards": state[3],
                   "demoter_moves_while_hot": moves_while_hot,
                   "demoter_demotes": demoter_demotes, "seconds_to_target": reach_s,
                   "victims_as_expected": demoted == expect,
                   "unexpected_victims": sorted(set().union(*demoted.values())
                                                - set().union(*expect.values())),
                   "response_mismatches": mismatches,
                   "snapshot_columns_differing": _snap_diff(esnap, fsnap),
                   "promotes": st["promotes"], "demotes": st["demotes"], "card": card}
            del esnap
            emit(res)
            if mismatches or res["snapshot_columns_differing"]:
                raise AssertionError(f"{name}: the demoter lost or changed a key")
            if moves_while_hot or demoter_demotes <= 0 or demoted != expect:
                raise AssertionError(f"{name}: the demoter did not take the census-coldest pages")
            results[name] = res
            free_device()
    return results


# ---------------------------------------------------------------------------
# the GLOBAL replica tier (parallel/ici.py): the sharded kernel over
# stacked replicas (kernel row 5r), the sync tick, the engine's GLOBAL
# serving and its cadence

REPLICAS = MESH_SHARDS  # one replica per shard
# bench.py's replica geometry (:790-804): 2^20 slots per replica at 4
# ways, waves of 4,096 lanes, Zipf(1.1) over 500,000 keys
REPLICA_SLOTS = 1 << 20
REPLICA_BIG = 1 << 22  # the capped tick's second size (bench.py:835-840)
REPLICA_WAYS = 4
REPLICA_B = 4096
REPLICA_WAVES = 32
REPLICA_KEYS = 500_000
REPLICA_REPS = 100  # timed replica waves
SYNC_CAP = 65_536  # IciEngineConfig.max_sync_groups
TICK_REPS = 6
# Cycles the stream spins before a timed tick (about 60 ms), longer than
# the host takes to enqueue the tick's torch ops
TICK_HOLD_CYCLES = 100_000_000
GLOBAL_BIT = 2
SYNC_EVERY = 2  # global_main_path: sync_now() after every 2nd call
# global_main_path serves the main path's first calls: its CPU reference
# (8 replicas of 2^20 slots, their ticks) takes seconds a call
GLOBAL_CALLS = 2
CADENCE_S = 3.0


# Keys that crowd CROWD_GROUPS replica groups (more keys than ways per
# group), drawn by CROWD_SHARE of the lanes, so that inserts evict
CROWD_KEYS = 4096
CROWD_GROUPS = 64
CROWD_SHARE = 0.05


class _ReplicaKeys:
    """REPLICA_KEYS keys (hashed key strings) and CROWD_KEYS keys built
    to share CROWD_GROUPS groups, with per-key parameters (a client
    keeps a key's algorithm, limit and duration)."""

    def __init__(self, rng, num_rgroups: int):
        self.zipf = _Zipf(REPLICA_KEYS)
        hi, lo, _ = key_hash128_batch([f"gl:{i}" for i in range(REPLICA_KEYS + 1)], 1)
        crowd = np.arange(CROWD_KEYS, dtype=np.int64)
        self.hi = np.concatenate([hi, rng.integers(1, 1 << 62, CROWD_KEYS)])
        self.lo = np.concatenate([lo, crowd % CROWD_GROUPS * 7919 % num_rgroups
                                  + num_rgroups * (crowd + 1)])
        n = len(self.hi)
        self.slot = (self.lo.astype(np.uint64) % np.uint64(num_rgroups)).astype(np.int64)
        self.algo = (rng.random(n) < 0.3).astype(np.int8)
        self.limit = rng.integers(10, 1001, n)
        self.duration = rng.integers(1000, 60_001, n)
        self.num_rgroups = num_rgroups


def replica_traffic(rng, keys: _ReplicaKeys, now: int, lanes: int = 0) -> RequestBatch:
    """One replica wave as the engine builds it: Zipf keys, homes drawn
    uniformly, the group column the pair home * num_rgroups + slot, a
    lane whose pair an earlier lane took left inactive (padding), so
    the active pairs are distinct; 30% leaky keys, 5% RESET_REMAINING
    (frees), 5% DRAIN_OVER_LIMIT, CROWD_SHARE of the lanes on the
    crowded groups (evictions), every lane GLOBAL. `lanes`: REPLICA_B
    when 0."""
    lanes = lanes or REPLICA_B
    k = np.where(rng.random(lanes) < CROWD_SHARE,
                 REPLICA_KEYS + 1 + rng.integers(0, CROWD_KEYS, lanes), keys.zipf.draw(rng, lanes))
    home = rng.integers(0, REPLICAS, lanes)
    pair = home * keys.num_rgroups + keys.slot[k]
    _, first = np.unique(pair, return_index=True)
    active = np.zeros(lanes, bool)
    active[first] = True
    u = rng.random(lanes)
    b = RequestBatch.zeros(lanes)
    b.key_hi[:] = keys.hi[k]
    b.key_lo[:] = keys.lo[k]
    b.group[:] = pair.astype(np.int32)
    b.algo[:] = keys.algo[k]
    b.behavior[:] = GLOBAL_BIT | np.where(u < 0.05, 8, np.where(u < 0.10, 32, 0))
    b.hits[:] = rng.integers(1, 6, lanes)
    b.limit[:] = keys.limit[k]
    b.duration[:] = keys.duration[k]
    b.rate_num[:] = b.duration
    b.eff_duration[:] = b.duration
    b.burst[:] = np.where(b.algo == 1, b.limit, 0)
    b.created_at[:] = now
    b.active[:] = active
    return b


def replica_flush(hbs, memo):
    """One WaveFlush over host waves `hbs` (the engine's launch path:
    one batch copy, one output allocation)."""
    lanes = [len(hb.active) for hb in hbs]
    offs = np.concatenate([[0], np.cumsum(lanes)[:-1]]).tolist()
    flat = RequestBatch(*(np.concatenate(c) for c in zip(*hbs)))
    return cuda_decide.WaveFlush(batch_to_device(flat, DEVICE), list(zip(offs, lanes)), memo)


def replica_step(state, keys, rng, now, layout, memo):
    """`waves` replica waves of fresh traffic on `state` through the
    engine's path (one flush, one launch and the pending ops per wave):
    the traffic step bench.py runs before each timed tick."""
    fl = replica_flush([replica_traffic(rng, keys, now) for _ in range(REPLICA_WAVES)], memo)
    rows = ici.replica_rows(state)
    for w in range(REPLICA_WAVES):
        ici.run_replica_wave(state, rows, fl, w, now, layout=layout, ways=REPLICA_WAYS,
                             num_rgroups=keys.num_rgroups)
    return fl


def _state_diff(a, b) -> list:
    """Fields of two IciStates that differ, compared on `a`'s device."""
    pairs = (("table", a.table.data, b.table.data), ("pending", a.pending, b.pending),
             ("tick", a.tick, b.tick))
    return [n for n, x, y in pairs if not torch.equal(x, y.to(x.device))]


def phase_replica_kernel(rng, layout: str, card: str):
    """The sharded kernel in the replica geometry (kernel row 5r): D = 8
    replicas of 2^20 slots at 4 ways stacked on the card as 8 shards,
    each lane's group the pair home * num_rgroups + slot, against its
    plain version (`fused.sharded_plain` on a second copy, then the same
    pending bookkeeping), REPLICA_WAVES waves of REPLICA_B lanes:
    bit-exact on every output field, the 9 sums, the stacked table and
    `pending` after every wave, exactly one kernel launch per wave.
    Then its times (`replica_times`)."""
    name = cuda_decide.replica_name(layout)
    mesh = pmesh.make_mesh([DEVICE] * REPLICAS)
    R = REPLICA_SLOTS // REPLICA_WAYS
    keys = _ReplicaKeys(rng, R)
    kst = ici.create_ici_state(mesh, REPLICA_SLOTS, REPLICA_WAYS, layout)
    pst = ici.create_ici_state(mesh, REPLICA_SLOTS, REPLICA_WAYS, layout)
    krows, prows = ici.replica_rows(kst), ici.replica_rows(pst)
    memo = cuda_decide.TableMemo()
    sync()
    before = cuda_decide.CONFIG_LAUNCHES[name]
    err, now = 0.0, NOW
    counts = dict(evicted=0, freed=0, padding=0)
    for w in range(REPLICA_WAVES):
        now += int(rng.choice([0, 1, 250, 2000]))
        hb = replica_traffic(rng, keys, now)
        fl = replica_flush([hb], memo)
        l0 = cuda_decide.CONFIG_LAUNCHES[name]
        ici.run_replica_wave(kst, krows, fl, 0, now, layout=layout, ways=REPLICA_WAYS,
                             num_rgroups=R)
        if cuda_decide.CONFIG_LAUNCHES[name] - l0 != 1:
            raise AssertionError(f"{name} wave {w}: not exactly one launch")
        ko, ks = fl.wave_outputs(0, torch.int32)
        db = fl.wave_batch(0)
        po, ps = fused.sharded_plain(CODEC[layout], prows, None, db, now, ways=REPLICA_WAYS,
                                     n_shards=REPLICAS)
        ici.replica_pending(pst.pending, db, po.slot, po.evicted_hi, po.evicted_lo, po.freed,
                            num_rgroups=R)
        sync()
        err = max(err, _max_abs_err(ko, po, ks, ps))
        diff = _state_diff(kst, pst)
        if diff:
            raise AssertionError(f"{name} wave {w}: {diff} differ from the plain version")
        counts["evicted"] += int(((ko.evicted_hi != 0) | (ko.evicted_lo != 0)).sum())
        counts["freed"] += int((ko.freed != 0).sum())
        counts["padding"] += int((~db.active).sum())
    launches = cuda_decide.CONFIG_LAUNCHES[name] - before
    if launches != REPLICA_WAVES:
        raise AssertionError(f"{name}: {launches} launches for {REPLICA_WAVES} waves")
    if not (counts["evicted"] and counts["freed"]):
        raise AssertionError(f"{name}: the traffic made no eviction or no freed slot")
    res = {"phase": "replica_kernel", "kernel": name, "ok": True, "replicas": REPLICAS,
           "slots_per_replica": REPLICA_SLOTS, "ways": REPLICA_WAYS, "waves": REPLICA_WAVES,
           "batch": REPLICA_B, "keys": REPLICA_KEYS,
           "table_mb": kst.table.data.numel() * 8 / 1e6,
           "pending_mb": kst.pending.numel() * 8 / 1e6,
           "live_rows_after": int(((kst.table.data[..., 2] & 1) != 0).sum()),  # META: col 2
           "pending_nonzero_after": int((kst.pending != 0).sum()), **counts,
           "launches": launches, "max_abs_err": err, "tolerance": "bit-exact (int64)"}
    emit(res)
    del pst, prows
    free_device()
    times = replica_times(rng, kst, keys, layout, card)
    return err, times


def replica_times(rng, state, keys, layout: str, card: str) -> dict:
    """Row 5r's times at REPLICA_B lanes on fresh waves: the kernel's
    median device time per wave (CUDA events, L2 flushed, the device
    held busy while the host enqueues, the wave's flush made before the
    window), its profiler time, the path per wave (the engine's: one
    wave of a multi-wave WaveFlush, the kernel and the pending ops,
    events without a hold), the device operations per replica wave
    (kernel plus pending ops), the plain version's median, and the byte
    bound as for row 5 (each wave's live matches counted)."""
    name = cuda_decide.replica_name(layout)
    R = keys.num_rgroups
    rows = ici.replica_rows(state)
    now = NOW + 60_000
    hbs = [replica_traffic(rng, keys, now) for _ in range(REPLICA_REPS)]
    dbs = [batch_to_device(hb, DEVICE) for hb in hbs]
    memo = cuda_decide.TableMemo()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)  # > the H100's 50 MB L2
    st = {"i": 0}
    timed = []

    def setup():
        i = st["i"] % REPLICA_REPS
        st["i"] += 1
        return i, cuda_decide.WaveFlush(dbs[i], None, memo)

    def kernel_a(arg):
        i, fl = arg
        fl.launch(0, rows, None, now, layout=layout, ways=REPLICA_WAYS, n_shards=REPLICAS,
                  replica=True)
        timed.append((i, fl.sums[0, 0]))

    def kernel():
        kernel_a(setup())

    path_fl = replica_flush(hbs, memo)

    def path():
        i = st["i"] % REPLICA_REPS
        st["i"] += 1
        ici.run_replica_wave(state, rows, path_fl, i, now, layout=layout, ways=REPLICA_WAYS,
                             num_rgroups=R)

    pt = ici.create_ici_state(pmesh.make_mesh([DEVICE] * REPLICAS), REPLICA_SLOTS,
                              REPLICA_WAYS, layout)
    prows = ici.replica_rows(pt)

    def plain():
        i = st["i"] % REPLICA_REPS
        st["i"] += 1
        po, _ = fused.sharded_plain(CODEC[layout], prows, None, dbs[i], now, ways=REPLICA_WAYS,
                                    n_shards=REPLICAS)
        ici.replica_pending(pt.pending, dbs[i], po.slot, po.evicted_hi, po.evicted_lo, po.freed,
                            num_rgroups=R)

    for _ in range(10):
        kernel()
    sync()
    timed.clear()
    k_ms = _median_ms(kernel_a, REPLICA_REPS, flush, hold_cycles=2_000_000, setup=setup)
    path_ms = _median_ms(path, REPLICA_REPS, flush)
    dev_ms = _profiled_device_ms(kernel, REPLICA_REPS, "decide_sharded_kernel")
    ops = _ops_per_call(path, reps=4)
    plain()
    sync()
    p_ms = _median_ms(plain, 10, flush)
    hits = torch.stack([h for _, h in timed]).tolist()
    ones = np.ones(REPLICA_B, bool)
    bounds = [bound_ms(hbs[i], layout, ones, False, h, 4, ways=REPLICA_WAYS)
              for (i, _), h in zip(timed, hits)]
    res = {"phase": "replica_times", "kernel": name, "batch": REPLICA_B,
           "kernel_ms_median": k_ms, "kernel_device_ms_profiler": dev_ms,
           "path_ms_median": path_ms, "device_ops_per_replica_wave": ops,
           "plain_ms_median": p_ms, "bound_ms": statistics.median(b for b, _ in bounds),
           "bound_by": bounds[0][1], "live_matches_per_wave_median": statistics.median(hits),
           "active_lanes_per_wave_median": statistics.median(
               int(np.count_nonzero(hb.active)) for hb in hbs),
           "reps": REPLICA_REPS, "card": card}
    emit(res)
    del flush, pt, prows, dbs
    return res


def _tick_no_sync(sync_fn, state, now):
    """One tick enqueued with torch's sync debug mode at "error": an
    operation that waits for the device raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return sync_fn(state, now)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _tick_times(sync_fn, state, keys, rng, layout, memo, now):
    """(device ms median, host enqueue ms median, wall ms median, device
    ops per tick, peak device memory the tick adds in GB) over TICK_REPS
    ticks, each after a fresh traffic step (so the capped tick finds
    dirty groups), timed with CUDA events around the tick while the
    stream spins TICK_HOLD_CYCLES first (the window holds device work
    only)."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    dev, host, wall = [], [], []
    for r in range(TICK_REPS):
        replica_step(state, keys, rng, now + r, layout, memo)
        sync()
        flush.zero_()
        torch.cuda._sleep(TICK_HOLD_CYCLES)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        s.record()
        sync_fn(state, now + r)
        e.record()
        host.append((time.perf_counter() - t0) * 1e3)
        e.synchronize()
        dev.append(s.elapsed_time(e))
        replica_step(state, keys, rng, now + r, layout, memo)
        sync()
        t0 = time.perf_counter()
        sync_fn(state, now + r)
        sync()
        wall.append((time.perf_counter() - t0) * 1e3)
    replica_step(state, keys, rng, now, layout, memo)
    sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sync_fn(state, now)
    sync()
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    replica_step(state, keys, rng, now, layout, memo)
    sync()
    ops = _ops_per_call(lambda: sync_fn(state, now), reps=1)
    del flush
    return statistics.median(dev), statistics.median(host), statistics.median(wall), ops, peak


def _inject_items(rng, keys: _ReplicaKeys, n: int) -> InjectBatch:
    """`n` authoritative rows on distinct replica groups (an inject wave
    as `IciEngine.inject_globals` assembles it), host columns."""
    k = rng.choice(REPLICA_KEYS, n * 2, replace=False) + 1
    _, first = np.unique(keys.slot[k], return_index=True)
    k = k[np.sort(first)][:n]
    b = InjectBatch.zeros(len(k))
    leaky = keys.algo[k] == 1
    b.key_hi[:], b.key_lo[:] = keys.hi[k], keys.lo[k]
    b.group[:] = keys.slot[k].astype(np.int32)
    b.algo[:] = keys.algo[k]
    b.limit[:] = keys.limit[k]
    b.duration[:] = keys.duration[k]
    b.remaining[:] = np.where(leaky, (keys.limit[k] // 2) << 20, keys.limit[k] // 2)
    b.stamp[:] = NOW
    b.expire_at[:] = NOW + keys.duration[k]
    b.burst[:] = np.where(leaky, keys.limit[k], 0)
    b.active[:] = True
    return b


def replica_ops_times(rng, state, keys, layout: str, card: str):
    """The replica tier's other torch-op programs on a live 8 x 2^20
    state: one inject wave of REPLICA_B authoritative rows into every
    replica (`make_inject_replicas`), and the stacked census and
    admission scans of replica 0; device ms (events, L2 flushed, the
    stream held busy while the host enqueues, median of CENSUS_REPS),
    device operations per call and the byte bound (inject: the rows'
    columns, per replica and row the W ways' probe columns, the written
    row and the pending slot; scans: replica 0's table read once)."""
    mesh = pmesh.make_mesh([DEVICE] * REPLICAS)
    slots = state.pending.shape[1]
    inject = ici.make_inject_replicas(mesh, slots, REPLICA_WAYS, layout)
    items = [_inject_items(rng, keys, REPLICA_B).to_device(DEVICE) for _ in range(CENSUS_REPS)]
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    st = {"i": 0}

    def one_inject():
        inject(state, items[st["i"] % len(items)], NOW)
        st["i"] += 1

    one_inject()
    sync()
    inj_ms = _median_ms(one_inject, CENSUS_REPS, flush, hold_cycles=SCAN_HOLD_CYCLES)
    inj_ops = _ops_per_call(one_inject)
    probe, _rest, store = ROW_BYTES[layout]
    item_bytes = sum(np.dtype(dt).itemsize for dt in INJECT_DTYPES.values())
    inj_bytes = REPLICA_B * item_bytes + REPLICAS * REPLICA_B * (REPLICA_WAYS * probe + store + 8)
    lines = {"inject": {"device_ms_median": inj_ms, "device_ops_per_call": inj_ops,
                        "bytes_bound": inj_bytes,
                        "bound_ms": inj_bytes / HBM_BYTES_PER_S * 1e3, "items": REPLICA_B}}
    census = get_census(layout, REPLICA_WAYS, stacked=True)
    admission = get_admission(layout, REPLICA_WAYS, stacked=True)
    scan_bytes = slots * BYTES_PER_SLOT[layout]
    for name, fn in (("census_stacked", census), ("admission_stacked", admission)):
        fn(state.table, NOW)
        sync()
        lines[name] = {
            "device_ms_median": _median_ms(lambda: fn(state.table, NOW), CENSUS_REPS, flush,
                                           hold_cycles=SCAN_HOLD_CYCLES),
            "device_ops_per_call": _ops_per_call(lambda: fn(state.table, NOW)),
            "bytes_bound": scan_bytes, "bound_ms": scan_bytes / HBM_BYTES_PER_S * 1e3}
    res = {"phase": "replica_ops", "layout": layout, "replicas": REPLICAS,
           "slots_per_replica": slots, **lines, "bound_by": "bytes", "card": card}
    emit(res)
    del flush
    return res


def phase_sync_tick(rng, card: str, layout: str = "fused"):
    """The sync tick on the card. At 2^20 slots x 8 replicas: after a
    traffic step, the state is copied to the host and one capped tick
    (SYNC_CAP groups) runs on the card, its enqueue under torch's sync
    debug mode "error" (no operation may wait for the device), and the
    same tick on the host copy through the port's CPU path: stacked
    table, pending, tick and diag bit-equal; the same for the full tick.
    Then, per variant (capped and full at 2^20, capped at 2^22), the
    device ms per tick (median of TICK_REPS, each after a fresh traffic
    step) against the 100 ms cadence, the host's enqueue ms, the wall
    ms, the torch device operations per tick, the peak device memory
    the tick adds, and the byte bound (capped: the stack and pending
    read once for the fingerprints; full: read and written once)."""
    cpu_mesh = pmesh.make_mesh(["cpu"] * REPLICAS)
    mesh = pmesh.make_mesh([DEVICE] * REPLICAS)
    out = []
    for slots in (REPLICA_SLOTS, REPLICA_BIG):
        R = slots // REPLICA_WAYS
        keys = _ReplicaKeys(rng, R)
        state = ici.create_ici_state(mesh, slots, REPLICA_WAYS, layout)
        memo = cuda_decide.TableMemo()
        now = NOW
        variants = [("capped", SYNC_CAP)] + ([("full", None)] if slots == REPLICA_SLOTS else [])
        for vname, cap in variants:
            tick = ici.make_sync_step(mesh, slots, REPLICA_WAYS, layout, max_sync_groups=cap)
            check = None
            if slots == REPLICA_SLOTS:
                replica_step(state, keys, rng, now, layout, memo)
                sync()
                host_state = ici.IciState(*(
                    type(state.table)(state.table.data.to("cpu", copy=True)),
                    state.pending.to("cpu", copy=True), state.tick.to("cpu", copy=True)))
                _st, diag = _tick_no_sync(tick, state, now)
                d_card = diag.cpu()
                t0 = time.perf_counter()
                _hs, d_host = ici.make_sync_step(cpu_mesh, slots, REPLICA_WAYS, layout,
                                                 max_sync_groups=cap)(host_state, now)
                host_s = time.perf_counter() - t0
                diff = _state_diff(state, host_state)
                if not torch.equal(d_card, d_host):
                    diff.append("diag")
                check = {"fields_differing_from_cpu": diff, "diag": d_card.tolist(),
                         "cpu_tick_s": host_s, "no_host_sync": True}
                del host_state
                if diff:
                    raise AssertionError(f"sync tick {vname}: {diff} differ from the CPU tick")
            dev_ms, host_ms, wall_ms, ops, peak = _tick_times(tick, state, keys, rng, layout,
                                                              memo, now + 1000)
            bpsl = BYTES_PER_SLOT[layout] + 8  # a row and its pending
            moved = REPLICAS * slots * bpsl * (1 if cap is not None else 2)
            res = {"phase": "sync_tick", "variant": vname, "layout": layout,
                   "replicas": REPLICAS, "slots_per_replica": slots, "ways": REPLICA_WAYS,
                   "max_sync_groups": cap, "groups": R,
                   "device_ms_median": dev_ms, "enqueue_host_ms_median": host_ms,
                   "wall_ms_median": wall_ms, "cadence_ms": 100.0,
                   "within_cadence": dev_ms < 100.0, "device_ops_per_tick": ops,
                   "peak_added_gb": peak, "bytes_bound": moved,
                   "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                   "reps": TICK_REPS, "card": card}
            if check is not None:
                res.update(check)
            emit(res)
            out.append(res)
        if slots == REPLICA_SLOTS:
            replica_ops_times(rng, state, keys, layout, card)
        del state
        free_device()
    return out


def _global_items(calls, rng):
    """The main path's calls with half of every call's items GLOBAL."""
    out = []
    for items in calls:
        flags = rng.random(len(items)) < 0.5
        out.append([dict(kw, behavior=kw["behavior"] | (GLOBAL_BIT if f else 0))
                    for kw, f in zip(items, flags)])
    return out


def _global_engine(size, layout, device, **kw):
    cfg = dict(num_groups=size.num_groups, ways=WAYS, batch_size=B, num_slots=REPLICA_SLOTS,
               replica_ways=REPLICA_WAYS, sync_wait_s=3600.0, layout=layout)
    cfg.update(kw)
    return IciEngine(IciEngineConfig(devices=[device] * REPLICAS, **cfg))


def _serve_global(eng, calls, clk, path: str, force: bool):
    """Every call through the object path or over wire bytes, sync_now()
    after every SYNC_EVERY-th call; returns (answers, seconds, columnar
    flushes per call)."""
    svc = V1Service(eng, force_global=force)
    t, out, columnar = 0.0, [], []
    for c, items in enumerate(calls):
        c0 = eng.stats()["columnar_flushes"]
        t0 = time.perf_counter()
        if path == "bytes":
            out.append(asyncio.run(serve_get_rate_limits_bytes(svc, encode_request(items))))
        else:
            resp = asyncio.run(svc.get_rate_limits([RateLimitReq(**kw) for kw in items]))
            out.append([(r.status, r.limit, r.remaining, r.reset_time, r.error) for r in resp])
        t += time.perf_counter() - t0
        columnar.append(eng.stats()["columnar_flushes"] - c0)
        if (c + 1) % SYNC_EVERY == 0:
            eng.sync_now()
        clk.advance(700)
    clk.advance(-700 * len(calls))
    return out, t, columnar


def _replica_wide(eng) -> dict:
    """The engine's replica stack and pending as host numpy columns (the
    wide image, so layouts compare), and its tick."""
    with eng._lock, eng._on_stream():
        st = eng.ici_state
        wide = get_kernels(eng.cfg.layout).to_wide(type(st.table)(ici.replica_rows(st)))
        out = {f: getattr(wide, f).cpu().numpy() for f in SlotTable._fields}
        out["pending"] = st.pending.cpu().numpy().ravel()
        out["tick"] = st.tick.cpu().numpy()
    return out


def phase_global_main_path(size: Size, reference, card: str):
    """GLOBAL serving through the entry points: an IciEngine on 8 shards
    of the card with the 1M sharded table (restored from the main path's
    image) and a replica tier of 8 x 2^20 slots at 4 ways, per layout,
    on the main path's first GLOBAL_CALLS (2) calls of 1,000 Zipf(1.1)
    items: (a) through
    V1Service(force_global=True), every item GLOBAL, and (b) half the
    items GLOBAL, so one flush feeds both tiers; each over the object
    path and over wire bytes (`serve_get_rate_limits_bytes`, default
    max_waves), with sync_now() after every 2nd call. The reference is a
    CPU IciEngine of the same geometry on the same calls, clock and
    ticks: answers, the sharded snapshot (key strings included) and the
    replica stack (wide), pending and tick equal. Launches counted from
    0 for each run: the replica kernel once per replica wave, the
    sharded kernel once per table wave, nothing else."""
    snap, calls, _want, _csnap = reference
    calls = calls[:GLOBAL_CALLS]
    traffic = {"a_force_global": (calls, True),
               "b_half_global": (_global_items(calls, np.random.default_rng(9)), False)}
    launches_by_layout = {"fused": 0, "narrow": 0}
    with _clock.freeze(NOW) as clk:
        for tname, (tcalls, force) in traffic.items():
            for path in ("object", "bytes"):
                ceng = _global_engine(size, "fused", "cpu")
                try:
                    ceng.restore(snap)
                    want, csecs, ccol = _serve_global(ceng, tcalls, clk, path, force)
                    csnap = ceng.snapshot()
                    crep = _replica_wide(ceng)
                    cst = ceng.stats()
                finally:
                    ceng.close()
                for layout in ("fused", "narrow"):
                    sname = cuda_decide.sharded_name(layout)
                    rname = cuda_decide.replica_name(layout)
                    geng = _global_engine(size, layout, DEVICE)
                    try:
                        geng.restore(snap)
                        sync()
                        cuda_decide.reset_launches()
                        got, secs, col = _serve_global(geng, tcalls, clk, path, force)
                        launches = dict(cuda_decide.CONFIG_LAUNCHES)
                        st = geng.stats()
                        gsnap = geng.snapshot()
                        grep = _replica_wide(geng)
                    finally:
                        geng.close()
                    if path == "object":
                        mismatches = sum(a != b for gc, wc in zip(got, want)
                                         for a, b in zip(gc, wc))
                        errors = sum(bool(r[4]) for gc in got for r in gc)
                    else:
                        mismatches = sum(g != w for g, w in zip(got, want))
                        errors = None
                    ticks = int(grep["tick"][0])
                    snap_diff = _snap_diff(gsnap, csnap)
                    rep_diff = [f for f in crep if not np.array_equal(grep[f], crep[f])]
                    del gsnap, grep
                    decisions = sum(len(c) for c in tcalls)
                    res = {"phase": "global_main_path", "traffic": tname, "path": path,
                           "layout": layout, "calls": len(tcalls), "items": decisions,
                           "global_items": sum(1 for c in tcalls for kw in c
                                               if force or kw["behavior"] & GLOBAL_BIT),
                           "flushes": st["flushes"], "columnar_flushes_per_call": col,
                           "cpu_columnar_flushes_per_call": ccol,
                           "waves": st["waves"], "replica_waves": st["replica_waves"],
                           "engine_kernel_launches": st["kernel_launches"],
                           "replica_launches": launches[rname],
                           "sharded_launches": launches[sname],
                           "other_kernel_launches": sum(launches.values()) - launches[rname]
                           - launches[sname],
                           "ticks": ticks, "error_responses": errors,
                           "response_mismatches": mismatches,
                           "snapshot_columns_differing": snap_diff,
                           "replica_columns_differing": rep_diff,
                           "overflow_keys": st["overflow_keys"],
                           "sync_backlog": st["sync_backlog"],
                           "decisions_per_s": decisions / secs, "seconds": secs,
                           "cpu_decisions_per_s": decisions / csecs,
                           "cpu_overflow_keys": cst["overflow_keys"], "card": card}
                    emit(res)
                    if mismatches or snap_diff or rep_diff or errors:
                        raise AssertionError(f"{rname} {tname} {path}: the card disagrees "
                                             "with the CPU engine")
                    if not (launches[rname] == st["replica_waves"] > 0):
                        raise AssertionError(f"{rname}: replica launches do not match the "
                                             "replica waves")
                    if launches[rname] + launches[sname] != st["waves"] or \
                            res["other_kernel_launches"]:
                        raise AssertionError(f"{rname}: launches do not match the waves")
                    if not force and launches[sname] == 0:
                        raise AssertionError(f"{sname}: the mixed traffic fed no table wave")
                    launches_by_layout[layout] += launches[rname]
                    free_device()
    return launches_by_layout


def phase_global_cadence(size: Size, reference, card: str):
    """The same engine (fused) with its sync thread at the default 100
    ms, on the wall clock, serving CADENCE_S seconds of the main path's
    calls with every item GLOBAL; then no traffic for two cadences, one
    more sync_now() and close(). Checks: every replica holds the same
    rows (each key hit converged), no pending left, overflow_keys 0, the
    thread stopped by close(); and the census and admission snapshots'
    "replica" tier against the numpy oracles over replica 0 copied to
    the host."""
    _snap, calls, _want, _csnap = reference
    eng = _global_engine(size, "fused", DEVICE, sync_wait_s=0.1)
    host_ms = []
    real_sync = eng.sync_now

    def timed_sync():
        t0 = time.perf_counter()
        real_sync()
        host_ms.append((time.perf_counter() - t0) * 1e3)

    eng.sync_now = timed_sync
    svc = V1Service(eng, force_global=True)
    served = errors = 0
    try:
        t0 = time.perf_counter()
        c = 0
        while time.perf_counter() - t0 < CADENCE_S:
            items = calls[c % len(calls)]
            resp = asyncio.run(svc.get_rate_limits([RateLimitReq(**kw) for kw in items]))
            errors += sum(bool(r.error) for r in resp)
            served += len(items)
            c += 1
        secs = time.perf_counter() - t0
        time.sleep(2 * eng.cfg.sync_wait_s + 0.05)
        eng.sync_now()
        with eng._lock, eng._on_stream():
            st = eng.ici_state
            data = st.table.data
            same = all(bool(torch.equal(data[d], data[0])) for d in range(REPLICAS))
            pending_left = int((st.pending != 0).sum())
            ticks = int(st.tick[0])
    finally:
        eng.close()
    stopped = not eng._sync_thread.is_alive()
    stats = eng.stats()
    census = eng.table_census(max_age_s=0)
    admission = eng.admission_snapshot(max_age_s=0)
    rep = _replica_wide(eng)
    cfg = eng.cfg
    rows0 = SlotTable(*(rep[f][:REPLICA_SLOTS] for f in SlotTable._fields))
    tier = census["tiers"]["replica"]
    want_c = census_oracle(rows0, tier["now_ms"], ways=REPLICA_WAYS,
                           heatmap_width=cfg.census_heatmap_width,
                           thresholds=tuple(cfg.census_thresholds))
    want_a = admission_oracle(rows0, admission["now_ms"])
    bad = [k for k, o in _CENSUS_FIELDS if np.asarray(tier[k]).tolist() != np.asarray(want_c[o]).tolist()]
    atier = admission["tiers"]["replica"]
    bad += [k for k, o in _ADMISSION_FIELDS
            if np.asarray(atier[k]).tolist() != np.asarray(want_a[o]).tolist()]
    res = {"phase": "global_cadence", "layout": "fused", "seconds": secs, "items": served,
           "decisions_per_s": served / secs, "sync_wait_s": cfg.sync_wait_s,
           "ticks": ticks, "sync_now_calls": len(host_ms),
           "sync_now_host_ms_median": statistics.median(host_ms) if host_ms else None,
           "sync_now_host_ms_max": max(host_ms) if host_ms else None,
           "sync_backlog": stats["sync_backlog"], "overflow_keys": stats["overflow_keys"],
           "overflow_drops": stats["overflow_drops"], "full_ticks": stats["full_ticks"],
           "error_responses": errors, "replicas_equal": same, "pending_left": pending_left,
           "thread_stopped": stopped,
           "replica_live": tier["live"], "replica_admission_keys": atier["keys"],
           "replica_fields_differing": bad, "card": card}
    emit(res)
    if errors or not (same and pending_left == 0 and stopped and stats["overflow_keys"] == 0):
        raise AssertionError("global_cadence: the replicas did not converge, or the thread ran on")
    if ticks < int(CADENCE_S / cfg.sync_wait_s) // 2:
        raise AssertionError(f"global_cadence: only {ticks} ticks in {CADENCE_S} s")
    if bad:
        raise AssertionError("global_cadence: the replica tier's snapshots disagree with the oracles")
    return res


# ---------------------------------------------------------------------------
# the Store and Loader seams (store/store.py; the engine's store path)

# The calls' hash keys are "smoke_acct:{k}" (name "smoke", unique key
# "acct:{k}"), k = 1 .. the size's live keys.
STORE_PREFIX = "smoke_acct:"
# store_path serves the main path's first calls, the first half through
# the object path and the rest as bytes: its CPU mesh reference takes
# seconds a call
STORE_CALLS = 2
_SNAP_FIELDS = ("algorithm", "status", "limit", "duration", "remaining", "stamp", "expire_at",
                "invalid_at", "burst")


def store_columns(rng, n: int) -> dict:
    """The state of n stored keys (row k - 1: key k), drawn as
    live_image draws its rows: token and leaky, expiries on both sides of
    NOW, and invalidation marks on 10% of them, half in the past (the
    row is dead when injected) and half in the next 6 s, which the calls
    (700 ms apart) cross, so the kernel's invalid_at branch runs while
    serving."""
    leaky = rng.random(n) < 0.3
    limit = rng.integers(10, 1001, n)
    burst = np.where(leaky, np.where(rng.random(n) < 0.5, limit, rng.integers(1, 2000, n)), 0)
    u = rng.random(n)
    return {
        "algorithm": leaky.astype(np.int64),
        "status": np.where(leaky, 0, rng.random(n) < 0.1).astype(np.int64),
        "limit": limit,
        "duration": rng.integers(1000, 60_001, n),
        "remaining": np.where(leaky, rng.integers(0, (burst << 20) + 1),
                              rng.integers(0, limit + 1)),
        "stamp": NOW - rng.integers(0, 60_000, n),
        "expire_at": NOW + rng.integers(-30_000, 60_000, n),
        "invalid_at": np.where(u < 0.05, NOW - rng.integers(1, 5000, n),
                               np.where(u < 0.10, NOW + rng.integers(0, 6000, n), 0)),
        "burst": burst,
    }


class ColumnStore:
    """A Store (store/store.py) holding a snapshot of every key of a
    numbered keyspace, "smoke_acct:{k}" for k = 1 .. n, in numpy columns
    (10M Python objects would not fit the phase's time); what the engine
    writes goes to `data` and what it removes to `removed`, which shadow
    the columns: a MemoryStore filled with every snapshot, whose changes
    are `state()`. `get_s` sums the host time of its gets."""

    def __init__(self, cols: dict):
        self.cols = cols
        self.n = len(cols["limit"])
        self.data = {}
        self.removed = set()
        self.lock = threading.Lock()
        self.get_calls = 0
        self.change_calls = 0
        self.get_s = 0.0

    def _row(self, key: str):
        if not key.startswith(STORE_PREFIX):
            return None
        tail = key[len(STORE_PREFIX):]
        if not tail.isdigit() or str(int(tail)) != tail:
            return None
        k = int(tail)
        return k - 1 if 1 <= k <= self.n else None

    def get(self, req):
        t0 = time.perf_counter()
        key = req.hash_key()
        with self.lock:
            self.get_calls += 1
            it = self.data.get(key)
            if it is not None:
                out = dataclasses.replace(it)
            elif key in self.removed or (row := self._row(key)) is None:
                out = None
            else:
                out = ItemSnapshot(key=key, **{f: int(self.cols[f][row]) for f in _SNAP_FIELDS})
        self.get_s += time.perf_counter() - t0
        return out

    def on_change(self, items) -> None:
        with self.lock:
            self.change_calls += 1
            for it in items:
                self.data[it.key] = it
                self.removed.discard(it.key)

    def remove(self, key: str) -> None:
        with self.lock:
            self.data.pop(key, None)
            self.removed.add(key)

    def state(self):
        with self.lock:
            return ({k: dataclasses.astuple(v) for k, v in self.data.items()},
                    sorted(self.removed), self.get_calls, self.change_calls)


class _StoreSpans:
    """Host-clock spans of an engine's store path, summed over a run:
    the probe with its read-back (`_store_probe`), the inject with its
    batch's copy (`_store_inject`), the decide's launch (`run_wave`,
    enqueued only: the gather's read-back waits for it), the gather with
    the wave's second read-back (`_store_gather`) and the write-behind
    (`_store_write_behind_core`). The engine's methods are wrapped on
    this one instance."""

    METHODS = ("_store_probe", "_store_inject", "_store_gather", "_store_write_behind_core")

    def __init__(self, eng):
        self.s = dict.fromkeys(self.METHODS + ("run_wave",), 0.0)
        for n in self.METHODS:
            setattr(eng, n, self._timed(n, getattr(eng, n)))
        eng.K = eng.K._replace(run_wave=self._timed("run_wave", eng.K.run_wave))

    def _timed(self, n, fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.s[n] += time.perf_counter() - t0
        return run


def _store_engine(size: Size, layout: str, paged: bool, mesh: bool, device):
    """An engine of the store phases: max_waves EDGE_MAX_WAVES (a call is
    one flush), and on a paged table no background demoter (the mesh's
    stored keys depend on where the pager puts frames: see
    phase_store_path)."""
    pcfg = dict(page_groups=size.page_groups, page_budget=size.page_budget,
                page_demote_interval_s=0.0) if paged else {}
    base = dict(num_groups=size.num_groups, ways=WAYS, batch_size=B, layout=layout,
                max_waves=EDGE_MAX_WAVES, **pcfg)
    if mesh:
        return IciEngine(IciEngineConfig(devices=[device] * MESH_SHARDS, **base))
    return DeviceEngine(EngineConfig(device=torch.device(device).type, **base))


def _store_serve(eng, store, calls, clk):
    """The first half of the calls through `V1Service.
    get_rate_limits` (the object path), the rest as GetRateLimitsReq
    bytes through `serve_get_rate_limits_bytes` (the columnar edge), 700
    ms apart. Returns (answers: tuples, then response bytes; per call
    (store gets, store change calls, rows read through); the serving
    seconds; per body the columnar flushes)."""
    svc = V1Service(eng)
    out, per_call, columnar, secs = [], [], [], 0.0
    half = len(calls) // 2
    bodies = [encode_request(items) for items in calls[half:]]

    def counts():
        return store.get_calls, store.change_calls, eng.stats()["store_injected"]

    for kind, work in (("object", calls[:half]), ("bytes", bodies)):
        for w in work:
            c0, f0 = counts(), eng.stats()["columnar_flushes"]
            t0 = time.perf_counter()
            if kind == "object":
                resp = asyncio.run(svc.get_rate_limits([RateLimitReq(**kw) for kw in w]))
                secs += time.perf_counter() - t0
                out.append([(r.status, r.limit, r.remaining, r.reset_time, r.error)
                            for r in resp])
            else:
                out.append(asyncio.run(serve_get_rate_limits_bytes(svc, w)))
                secs += time.perf_counter() - t0
                columnar.append(eng.stats()["columnar_flushes"] - f0)
            per_call.append(tuple(b - a for a, b in zip(c0, counts())))
            clk.advance(700)
    clk.advance(-700 * len(out))
    return out, per_call, secs, columnar


def phase_store_path(rng, size: Size, calls, card: str):
    """The restart case through the store path: a ColumnStore holding a
    snapshot of every key the calls can name (the size's live keys), a
    fresh engine attached to it, the main path's first STORE_CALLS (2)
    calls at max_waves 1,000 (a call is one flush), the first half
    through V1Service, the rest as wire bytes through the columnar edge
    (a body's Gregorian items spliced through the object path).
    Every miss reads through: the prefetch of never-seen keys outside
    the lock, else the per-wave probe and Store.get, then the inject
    before the wave's decide; every flush writes behind.

    On the card per configuration of the size: a DeviceEngine (kernel
    rows 1-3b) and an IciEngine of 8 shards (row 5), each against the
    port's CPU engine of the same kind and paging (fused) on the same
    calls, clock and store: a demote drops a page left with no live row
    (a later touch binds a zeroed frame), so only a table that pages
    alike keeps the same dead rows of freed keys; and a mesh's store
    receives only the last shard's lanes, at rows the psum'd slot
    names, so its contents depend on where frames lie. Every
    answer, the wide image with its key strings, the store's changes
    and removals, and per call its gets, change calls and rows read
    through must be equal; kernel launches equal to the table waves,
    two read-backs per wave, every body that is not all-Gregorian one
    columnar flush. Returns {kernel name: launches}."""
    calls = calls[:STORE_CALLS]
    half = len(calls) // 2
    must_columnar = sum(1 for items in calls[half:]
                        if any(not kw["behavior"] & 4 for kw in items))
    t0 = time.perf_counter()
    cols = store_columns(rng, size.live_keys)
    cols_s = time.perf_counter() - t0
    launched = {}
    with _clock.freeze(NOW) as clk:
        refs = {}
        paged = bool(size.page_groups)
        for mesh in (False, True):
            ceng = _store_engine(size, "fused", paged, mesh, "cpu")
            cstore = ColumnStore(cols)
            attach_store(ceng, cstore)
            try:
                got, per_call, secs, _c = _store_serve(ceng, cstore, calls, clk)
                refs[mesh] = (got, per_call, cstore.state(), ceng.snapshot())
            finally:
                ceng.close()
            emit({"phase": "store_path_reference", "size": size.name, "mesh": mesh,
                  "paged": paged, "device": "cpu", "calls": len(got), "seconds": secs,
                  "stored_keys": size.live_keys, "store_columns_s": cols_s,
                  "changed_keys": len(refs[mesh][2][0]), "removed_keys": len(refs[mesh][2][1]),
                  "gets": refs[mesh][2][2], "change_calls": refs[mesh][2][3]})
        for name, layout, paged, mesh in _edge_configs(size):
            eng = _store_engine(size, layout, paged, mesh, DEVICE)
            store = ColumnStore(cols)
            attach_store(eng, store)
            spans = _StoreSpans(eng)
            try:
                st0 = eng.stats()
                sync()
                cuda_decide.reset_launches()
                got, per_call, secs, columnar = _store_serve(eng, store, calls, clk)
                launches = dict(cuda_decide.CONFIG_LAUNCHES)
                st = eng.stats()
                ssnap = eng.snapshot()
            finally:
                eng.close()
            want, want_calls, want_store, want_snap = refs[mesh]
            d = {k: st[k] - st0[k] for k in ("flushes", "columnar_flushes", "waves",
                                               "kernel_launches", "store_readbacks",
                                               "store_injected", "replica_waves")}
            decisions = sum(len(c) for c in calls)
            waves = max(d["waves"], 1)
            s = spans.s
            host_ms = {
                "probe_readback": s["_store_probe"], "store_get": store.get_s,
                "inject": s["_store_inject"], "decide_launch": s["run_wave"],
                "gather_readback": s["_store_gather"],
                "write_behind": s["_store_write_behind_core"],
            }
            res = {"phase": "store_path", "size": size.name, "kernel": name, "mesh": mesh,
                   "paged": paged, "object_calls": half,
                   "wire_calls": len(calls) - half,
                   "items": decisions, "max_waves": EDGE_MAX_WAVES,
                   "answer_mismatches": sum(a != b for a, b in zip(got, want)),
                   "snapshot_columns_differing": _snap_diff(ssnap, want_snap),
                   "store_state_equal": store.state() == want_store,
                   "per_call_store_counts_equal": per_call == want_calls,
                   "store_gets_per_call": [c[0] for c in per_call],
                   "store_change_calls_per_call": [c[1] for c in per_call],
                   "injected_rows_per_call": [c[2] for c in per_call],
                   "changed_keys": len(store.data), "removed_keys": len(store.removed),
                   "flushes": d["flushes"], "columnar_flushes": d["columnar_flushes"],
                   "columnar_calls": sum(1 for c in columnar if c == 1),
                   "bodies_not_all_gregorian": must_columnar,
                   "waves": d["waves"], "replica_waves": d["replica_waves"],
                   "engine_kernel_launches": d["kernel_launches"],
                   "launches": launches[name],
                   "other_kernel_launches": sum(launches.values()) - launches[name],
                   "store_readbacks": d["store_readbacks"],
                   "readbacks_per_wave": d["store_readbacks"] / waves,
                   "decisions_per_s": decisions / secs, "seconds": secs,
                   "host_ms": {k: v * 1e3 for k, v in host_ms.items()},
                   "host_ms_per_wave": {k: v * 1e3 / waves for k, v in host_ms.items()},
                   "card": card}
            del ssnap
            emit(res)
            if res["answer_mismatches"] or res["snapshot_columns_differing"] \
                    or not res["store_state_equal"] or not res["per_call_store_counts_equal"]:
                raise AssertionError(f"{name}: the store path disagrees with the CPU engine")
            if not (res["launches"] == d["kernel_launches"] == d["waves"] > 0):
                raise AssertionError(f"{name}: store-path kernel launches do not match the waves")
            if res["other_kernel_launches"] or d["replica_waves"]:
                raise AssertionError(f"{name}: another configuration was launched")
            if d["store_readbacks"] != 2 * d["waves"]:
                raise AssertionError(f"{name}: not two read-backs per store-path wave")
            if res["columnar_calls"] != must_columnar:
                raise AssertionError(f"{name}: a body was served without the columnar path")
            if not (d["store_injected"] > 0 and store.get_calls > 0 and store.change_calls > 0):
                raise AssertionError(f"{name}: nothing was read through or written behind")
            launched[name] = launched.get(name, 0) + launches[name]
            free_device()
    return launched


_snap_row = operator.attrgetter(*_SNAP_FIELDS)


def loader_items(rng, size: Size):
    """size.live_keys snapshots of keys "smoke_acct:{k}" that fit the
    table (each in a free way of its group, as live_image places its
    rows), state from store_columns: what a Loader saved from a full 1M
    table."""
    n = size.live_keys
    keys = [f"{STORE_PREFIX}{k}" for k in range(1, n + n // 8 + 1)]
    grp = key_hash128_batch(keys, size.num_groups)[2]
    order = np.argsort(grp, kind="stable")
    sg = grp[order]
    rank = np.empty(len(keys), np.int64)
    rank[order] = np.arange(len(keys)) - np.searchsorted(sg, sg, side="left")
    keep = np.nonzero(rank < WAYS)[0][:n]
    if keep.size != n:
        raise RuntimeError(f"placed only {keep.size} keys")
    cols = store_columns(rng, n)
    rows = zip(*(cols[f].tolist() for f in _SNAP_FIELDS))
    return [ItemSnapshot(keys[i], *row) for i, row in zip(keep.tolist(), rows)]


def phase_loader(rng, size: Size, calls, card: str) -> dict:
    """The Loader round trip at the flat size, per layout on a CUDA
    DeviceEngine: `load_engine` of the size's live keys' snapshots into a
    fresh engine (timed; its inject waves counted), `save_engine`, whose
    snapshots must equal the loaded ones key for key, then the main
    path's first call, whose answers must equal a CPU engine's loaded
    the same way (flat fused), with one launch per wave. The CPU engine
    is loaded with the snapshots of the groups that call touches only:
    every snapshot of such a group, in the same order, so those groups
    hold what a full load leaves there, and the call reads no other.
    Returns {kernel name: launches}."""
    t0 = time.perf_counter()
    items = loader_items(rng, size)
    build_s = time.perf_counter() - t0
    loaded = {it.key: _snap_row(it) for it in items}
    base = dict(num_groups=size.num_groups, ways=WAYS, batch_size=B)
    touched = set(key_hash128_batch([f"{kw['name']}_{kw['unique_key']}" for kw in calls[0]],
                                    size.num_groups)[2].tolist())
    item_groups = key_hash128_batch([it.key for it in items], size.num_groups)[2]
    near = [it for it, g in zip(items, item_groups.tolist()) if g in touched]
    launched = {}
    with _clock.freeze(NOW):
        ceng = DeviceEngine(EngineConfig(device="cpu", **base))
        try:
            load_engine(ceng, MemoryLoader(near))
            want = [(r.status, r.limit, r.remaining, r.reset_time, r.error) for r in
                    asyncio.run(V1Service(ceng).get_rate_limits(
                        [RateLimitReq(**kw) for kw in calls[0]]))]
        finally:
            ceng.close()
        for layout, _paged in size.configs:
            name = cuda_decide.config_name(layout, False)
            eng = DeviceEngine(EngineConfig(device=DEVICE.type, layout=layout, **base))
            try:
                st0 = eng.stats()
                sync()
                t0 = time.perf_counter()
                n = load_engine(eng, MemoryLoader(items))
                sync()
                load_s = time.perf_counter() - t0
                st1 = eng.stats()
                out = MemoryLoader()
                t0 = time.perf_counter()
                saved_n = save_engine(eng, out)
                save_s = time.perf_counter() - t0
                saved = {it.key: _snap_row(it) for it in out.items}
                cuda_decide.reset_launches()
                got = [(r.status, r.limit, r.remaining, r.reset_time, r.error) for r in
                       asyncio.run(V1Service(eng).get_rate_limits(
                           [RateLimitReq(**kw) for kw in calls[0]]))]
                launches = dict(cuda_decide.CONFIG_LAUNCHES)
                st = eng.stats()
            finally:
                eng.close()
            res = {"phase": "loader", "size": size.name, "kernel": name, "layout": layout,
                   "loaded": n, "load_s": load_s, "snapshots_build_s": build_s,
                   "inject_waves": st1["inject_waves"] - st0["inject_waves"],
                   "injected_rows": st1["injected_rows"] - st0["injected_rows"],
                   "rows_per_s": n / load_s, "saved": saved_n, "save_s": save_s,
                   "saved_equal_loaded": saved == loaded,
                   "call_items": len(calls[0]),
                   "call_mismatches": sum(a != b for a, b in zip(got, want)),
                   "call_waves": st["waves"] - st1["waves"], "launches": launches[name],
                   "other_kernel_launches": sum(launches.values()) - launches[name],
                   "card": card}
            del saved
            emit(res)
            if not res["saved_equal_loaded"] or saved_n != n:
                raise AssertionError(f"{name}: save_engine does not give back what was loaded")
            if res["call_mismatches"]:
                raise AssertionError(f"{name}: the loaded engine answers unlike the CPU engine")
            if not (res["launches"] == res["call_waves"] > 0) or res["other_kernel_launches"]:
                raise AssertionError(f"{name}: launches do not match the call's waves")
            launched[name] = launches[name]
            free_device()
    return launched


STORE_OPS_REPS = 10
# bytes of one wide row (SlotTable) as gather_rows writes it
WIDE_ROW_BYTES = sum(np.dtype(dt).itemsize for dt in SLOT_DTYPES.values())


def _store_op_configs(rng):
    """(size, layout, paged, mesh, page map) of every table store_ops
    measures: each size and layout, alone and as the 8-shard mesh."""
    for size in SIZES:
        pm = scrambled_page_map(rng, size) if size.page_groups else None
        for layout, paged in size.configs:
            for mesh in (False, True):
                yield size, layout, paged, mesh, pm


def _store_op_fns(rng, size: Size, layout: str, paged: bool, mesh: bool, pm):
    """A table of the configuration on the card, its rows random (the
    ops' work does not depend on them; paged: 768 frames behind the
    scrambled map `pm`), and {op: (one call on B lanes, its byte
    bound)}: per lane its inputs, the W ways' five probe columns (probe,
    inject), the row written or read, the outputs (probe: one bool;
    inject: the evicted key; gather: the slot and the wide row), a paged
    lane's map entry."""
    pkw = dict(page_groups=size.page_groups, page_budget=size.page_budget)
    if mesh:
        K = pmesh.make_mesh_kernels(pmesh.make_mesh([DEVICE] * MESH_SHARDS), layout,
                                    size.num_groups, WAYS, **(pkw if paged else {}))
    elif paged:
        K = get_paged_kernels(layout, size.num_groups, WAYS, size.page_groups,
                              size.page_budget, DEVICE)
    else:
        K = get_kernels(layout)
    table = K.create(size.num_groups, WAYS, DEVICE)
    rows = table.data.data if paged else table.data
    rows.random_(0, 1 << 62)
    if paged:
        table.page_map.copy_(torch.as_tensor(pm))
        groups = resident_groups(rng, size, pm)
    else:
        groups = rng.choice(size.num_groups, B, replace=False)
    grp = torch.as_tensor(groups.astype(np.int32), device=DEVICE)
    hi = torch.as_tensor(rng.integers(1, 1 << 62, B), device=DEVICE)
    lo = torch.as_tensor(rng.integers(1, 1 << 62, B), device=DEVICE)
    slots = torch.as_tensor(rng.integers(0, rows.shape[0], B), device=DEVICE)
    items = InjectBatch.zeros(B)._replace(
        key_hi=hi.cpu().numpy(), key_lo=lo.cpu().numpy(), group=groups.astype(np.int32),
        limit=np.full(B, 100), duration=np.full(B, 60_000), remaining=np.full(B, 7),
        stamp=np.full(B, NOW), expire_at=np.full(B, NOW + 60_000), active=np.ones(B, np.bool_),
    ).to_device(DEVICE)
    probe_b, _rest, row_b = ROW_BYTES[layout]
    map_b = 4 if paged else 0
    item_bytes = sum(np.dtype(dt).itemsize for dt in INJECT_DTYPES.values())
    return table, {
        "probe_exists": (lambda: K.probe_exists(table, hi, lo, grp, NOW, WAYS),
                         B * (8 + 8 + 4 + WAYS * probe_b + 1 + map_b)),
        "inject": (lambda: K.inject(table, items, NOW, WAYS),
                   B * (item_bytes + WAYS * probe_b + row_b + 16 + map_b)),
        "gather_rows": (lambda: K.gather_rows(table, slots),
                        B * (8 + row_b + WIDE_ROW_BYTES)),
    }


def store_op_counts() -> dict:
    """The device operations per call of every store op of store_ops,
    and of the torch-op layouts' ops (`layout_op_counts`), from
    torch.profiler: run by store_ops in a fresh process of this script
    (`--store-op-counts`), since late in a long run CUPTI has been seen
    to lose records. {"size/layout/mesh": {op: ops per call}, and
    "layouts/size/layout": {op: ops per call}}."""
    rng = np.random.default_rng(0)
    out = {}
    for size, layout, paged, mesh, pm in _store_op_configs(rng):
        table, ops = _store_op_fns(rng, size, layout, paged, mesh, pm)
        for fn, _nbytes in ops.values():
            fn()
        sync()
        out[f"{size.name}/{layout}/{int(mesh)}"] = {
            name: _ops_per_call(fn) for name, (fn, _nbytes) in ops.items()}
        del table, ops
        free_device()
    return layout_op_counts(out)


def phase_store_ops(rng, card: str) -> dict:
    """The store path's torch ops (XLA programs in the JAX package), one
    wave of B lanes on a table of each size and layout, alone and as the
    mesh of 8 shards: `probe_exists` (the residency probe), `inject`
    (the ownership-masked one on the mesh) and `gather_rows` (the rows
    at a wave's slots, expanded to the wide struct); the lanes of a
    paged table on resident pages. Device ms (events, L2 flushed, the
    stream held busy while the host enqueues, median of STORE_OPS_REPS),
    device operations per call (torch.profiler, in a fresh process:
    `store_op_counts`) and the byte bound (`_store_op_fns`). Returns the
    fresh process's op counts (the layouts phase reads its own)."""
    counts = _op_counts_child("--store-op-counts")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    for size, layout, paged, mesh, pm in _store_op_configs(rng):
        table, ops = _store_op_fns(rng, size, layout, paged, mesh, pm)
        line = {"phase": "store_ops", "size": size.name, "layout": layout,
                "paged": paged, "mesh": mesh, "lanes": B, "card": card}
        for name, (fn, nbytes) in ops.items():
            fn()
            sync()
            line[name] = {
                "device_ms_median": _median_ms(fn, STORE_OPS_REPS, flush,
                                               hold_cycles=SCAN_HOLD_CYCLES),
                "device_ops_per_call": counts[f"{size.name}/{layout}/{int(mesh)}"][name],
                "bytes_bound": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes"}
        emit(line)
        del table, ops
        free_device()
    del flush
    return counts


def _op_counts_child(*args: str) -> dict:
    """The JSON line that a fresh process of this script prints when run
    with `args` (an op count mode)."""
    child = subprocess.run(
        [sys.executable, os.path.abspath(__file__), *args],
        capture_output=True, text=True, timeout=600,
    )
    if child.returncode:
        raise AssertionError(f"{args[0]} exited {child.returncode}: {child.stderr[-4000:]}")
    return json.loads(child.stdout.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# the wide and packed layouts: torch ops on DeviceEngine, flat and paged

# The layouts served by torch ops (XLA programs in the JAX package)
TORCH_LAYOUTS = ("wide", "packed")
# The main path's calls the phase serves: the first ones as objects, the
# next ones as wire bytes; the engine restarted through a MemoryLoader
# serves the first call again
LAYOUT_OBJECT_CALLS = 1
LAYOUT_BYTE_CALLS = 1
# items of each call the phase serves (a prefix of the main path's call:
# a wide or packed wave is hundreds of small torch ops)
LAYOUT_ITEMS = 250
LAYOUT_REPS = 10
LAYOUT_SCAN_T = 4  # steps of the timed scan
# Bytes a lane of the decide needs of the table, by layout: a way's probe
# columns (wide: key_hi, key_lo, used, expire_at, invalid_at, lru;
# packed: key_lo, meta, expire_at, invalid_at), the rest of the chosen
# row (packed: with key_hi at the matched and the insert way) and the
# row written
TORCH_ROW_BYTES = {"wide": (41, 42, 83), "packed": (32, 48, 72)}
BATCH_BYTES = sum(np.dtype(dt).itemsize for dt in BATCH_DTYPES.values())
# status, limit, remaining, reset_time, slot, evicted_hi, evicted_lo, freed
OUT_BYTES = 1 + 6 * 8 + 1


class _Taken:
    """An engine's snapshot, taken once, as `save_engine` reads it."""

    def __init__(self, snap):
        self._snap = snap

    def snapshot(self):
        return self._snap


def _layout_engine(size: Size, layout: str, device):
    """A DeviceEngine of the size at `layout` (paged: the size's frames,
    no background demoter, so the pages move on demand alike on the card
    and the CPU), at max_waves 1,000 so that a call's bytes fit one
    columnar flush."""
    pcfg = (dict(page_groups=size.page_groups, page_budget=size.page_budget,
                 page_demote_interval_s=0.0) if size.page_groups else {})
    return DeviceEngine(EngineConfig(device=torch.device(device).type, num_groups=size.num_groups,
                                     ways=WAYS, batch_size=B, layout=layout,
                                     max_waves=EDGE_MAX_WAVES, **pcfg))


def _census_by_oracle(eng) -> None:
    """A CPU engine's census scans its table with the numpy oracle (the
    torch census takes about a minute at 10M on the CPU;
    tests/test_torch_census.py holds the two equal)."""
    cfg = eng.cfg
    to_wide = get_kernels(cfg.layout).to_wide

    def scan(view, now):
        out = census_oracle(SlotTable(*(c.numpy() for c in to_wide(view))), now, ways=cfg.ways,
                            heatmap_width=cfg.census_heatmap_width,
                            thresholds=tuple(cfg.census_thresholds))
        return CensusOutput(**{k: torch.as_tensor(np.asarray(v)) for k, v in out.items()})

    eng._census = scan


def _layout_run(size: Size, layout: str, device, snap, obj_calls, bodies, restart_call, clk,
                saved=None):
    """One engine's run of the phase on the frozen clock: the image
    restored, the object calls, the bytes calls, then (without `saved`)
    the snapshot, the census and the live keys' snapshots saved to a
    MemoryLoader, and (with `restart_call`) a fresh engine loaded from
    the MemoryLoader (or from the snapshots `saved`) answering it.
    Returns what is compared, the stats, the seconds of each path and
    the engine's resident table bytes; the engine is kept for the op
    times on the card (the caller closes it)."""
    eng = _layout_engine(size, layout, device)
    if eng.device.type == "cpu":
        _census_by_oracle(eng)
    eng.restore(snap)
    st0 = eng.stats()
    sync()
    cuda_decide.reset_launches()
    svc = V1Service(eng)
    obj, obj_s, _ = _serve(svc, obj_calls, clk)
    clk.advance(700 * len(obj_calls))
    wire_out, wire_s, columnar = _serve_bytes(svc, bodies, clk)
    clk.advance(700 * len(bodies))
    st = eng.stats()
    run = {"eng": eng, "objects": obj, "bytes": wire_out}
    if saved is None:
        run["snapshot"] = eng.snapshot()
        census = eng.table_census(max_age_s=0)
        run["census"] = {k: v for k, v in census.items() if k != "churn"}
        loader = MemoryLoader()
        save_engine(_Taken(run["snapshot"]), loader)
        saved = loader.items
    fst = {"waves": 0, "kernel_launches": 0}
    if restart_call is not None:
        fresh = _layout_engine(size, layout, device)
        try:
            load_engine(fresh, MemoryLoader(saved))
            run["restart"], restart_s, _ = _serve(V1Service(fresh), [restart_call], clk)
            run["seconds_restart"] = restart_s
            fst = fresh.stats()
        finally:
            fresh.close()
    sync()
    clk.advance(-700 * (len(obj_calls) + len(bodies)))
    run.update(
        saved=saved, launches=dict(cuda_decide.CONFIG_LAUNCHES),
        stats={k: st[k] - st0[k] for k in ("flushes", "columnar_flushes", "waves",
                                           "kernel_launches", "promotes", "demotes",
                                           "binds") if k in st},
        restart_waves=fst["waves"], restart_launches=fst["kernel_launches"],
        columnar_calls=sum(1 for c in columnar if c == 1),
        seconds={"objects": obj_s, "bytes": wire_s,
                 **({"restart": run.pop("seconds_restart")} if "restart" in run else {})},
        table_bytes=sum(t.nbytes for t in (eng.table.data if size.page_groups else eng.table)),
    )
    return run


def _torch_op_fns(rng, K, table, size: Size, layout: str, pm, image) -> dict:
    """{op: (one call, its byte bound)} of the layout's torch ops at B
    lanes on `table` (`K`'s; paged: lanes on the pages `pm` holds
    resident, as the pager runs them): the decide wave, a scan of
    LAYOUT_SCAN_T waves, the store path's inject, probe and gather, and
    the census. Bytes: each input read once, each output written once;
    per active lane the W ways' probe columns, the rest of the chosen
    row, the row written (a paged lane's map entry too); the census
    reads the table once."""
    paged = pm is not None

    def groups():
        if paged:
            return resident_groups(rng, size, pm)
        return rng.choice(size.num_groups, B, replace=False)

    now = NOW + 60_000
    hb = smoke_wave(rng, image, now, size.num_groups, groups())
    db = batch_to_device(hb, DEVICE)
    hbs = [smoke_wave(rng, image, now + t, size.num_groups, groups())
           for t in range(LAYOUT_SCAN_T)]
    sdb = batch_to_device(stack_batches(hbs), DEVICE)
    nows = torch.arange(now, now + LAYOUT_SCAN_T, dtype=torch.int64, device=DEVICE)
    items = InjectBatch.zeros(B)._replace(
        key_hi=hb.key_hi, key_lo=hb.key_lo, group=hb.group, algo=hb.algo,
        limit=np.full(B, 100), duration=np.full(B, 60_000), remaining=np.full(B, 7),
        stamp=np.full(B, NOW), expire_at=np.full(B, NOW + 60_000), active=hb.active,
    ).to_device(DEVICE)
    rows = table.num_slots
    slots = torch.as_tensor(rng.integers(0, rows, B), device=DEVICE)
    census = get_census(layout, WAYS)
    view = table.data if paged else table
    probe_b, rest_b, row_b = TORCH_ROW_BYTES[layout]
    map_b = 4 if paged else 0
    act = int(hb.active.sum())
    wave_b = B * BATCH_BYTES + act * (WAYS * probe_b + rest_b + row_b + map_b) + B * OUT_BYTES
    scan_act = sum(int(h.active.sum()) for h in hbs)
    scan_b = (LAYOUT_SCAN_T * B * (BATCH_BYTES + OUT_BYTES)
              + scan_act * (WAYS * probe_b + rest_b + row_b + map_b))
    item_b = sum(np.dtype(dt).itemsize for dt in INJECT_DTYPES.values())
    return {
        "decide": (lambda: K.decide(table, db, now, WAYS), wave_b),
        "decide_scan": (lambda: K.decide_scan(table, sdb, nows, WAYS), scan_b),
        "inject": (lambda: K.inject(table, items, now, WAYS),
                   B * (item_b + 16) + act * (WAYS * probe_b + row_b + map_b)),
        "probe_exists": (lambda: K.probe_exists(table, db.key_hi, db.key_lo, db.group, now, WAYS),
                         B * (8 + 8 + 4 + 1 + map_b + WAYS * probe_b)),
        "gather_rows": (lambda: K.gather_rows(table, slots), B * (8 + row_b + WIDE_ROW_BYTES)),
        "census": (lambda: census(view, now), rows * BYTES_PER_SLOT[layout]),
    }


def _layout_op_tables(size: Size, layout: str, pm):
    """(K, table) of the layout at the size on the card, empty (paged:
    the frames behind `pm`), for the op counts."""
    if pm is None:
        K = get_kernels(layout)
        return K, K.create(size.num_groups, WAYS, DEVICE)
    K = get_paged_kernels(layout, size.num_groups, WAYS, size.page_groups, size.page_budget,
                          DEVICE)
    table = K.create()
    table.page_map.copy_(torch.as_tensor(pm))
    return K, table


def layout_op_counts(out: dict) -> dict:
    """The device operations per call of every op `_torch_op_fns` times,
    on empty tables of each size and torch-op layout, into `out` under
    "layouts/{size}/{layout}" (the op counts of store_ops' fresh
    process)."""
    rng = np.random.default_rng(1)
    for size in SIZES:
        pm = scrambled_page_map(rng, size) if size.page_groups else None
        image = SlotTable(**{f: np.zeros(size.num_groups * WAYS, SLOT_DTYPES[f])
                             for f in SlotTable._fields})
        for layout in TORCH_LAYOUTS:
            K, table = _layout_op_tables(size, layout, pm)
            ops = _torch_op_fns(rng, K, table, size, layout, pm, image)
            for fn, _nbytes in ops.values():
                fn()
            sync()
            # one call each: hundreds of operations a call, the same every call
            out[f"layouts/{size.name}/{layout}"] = {
                name: _ops_per_call(fn, reps=1) for name, (fn, _nbytes) in ops.items()}
            del K, table, ops
            free_device()
        del image
    return out


def _layout_checks(name, got, want, cpu) -> dict:
    """What one torch-op engine's run must equal: the fused card engine's
    answers (objects, bytes, the restart) and the CPU engine's of the
    same layout and paging (answers but the restart's, wide table with
    key strings, census, the MemoryLoader's snapshots)."""
    diff = {
        "answers_vs_fused": sum(a != b for p in ("objects", "bytes", "restart")
                                for a, b in zip(got[p], want[p])),
        "answers_vs_cpu": sum(a != b for p in ("objects", "bytes")
                              for a, b in zip(got[p], cpu[p])),
        "table_columns_vs_cpu": _snap_diff(got["snapshot"], cpu["snapshot"]),
        "census_vs_cpu": sorted(k for k in got["census"]
                                if got["census"][k] != cpu["census"].get(k)),
        "loader_items_vs_cpu": got["saved"] != cpu["saved"],
    }
    if any(diff.values()):
        raise AssertionError(f"{name}: the layout disagrees: {diff}")
    return diff


def phase_layouts(rng, size_refs, card: str, counts: dict) -> dict:
    """The wide and packed layouts (torch ops) on DeviceEngine, at each
    size (1M flat, 10M paged with page moves), on the main path's calls
    and frozen clock: LAYOUT_OBJECT_CALLS calls as objects, the next
    LAYOUT_BYTE_CALLS as wire bytes through the columnar edge, then a
    restart: the live keys' snapshots saved to a MemoryLoader and loaded
    into a fresh engine, which answers one more call. Each layout's card
    engine against a fused DeviceEngine on the card (answers, launching
    its kernel once a wave) and a CPU engine of the same layout and
    paging (answers, wide table, census, the Loader's snapshots);
    decisions/s of each path, no hand kernel launched by a torch-op
    engine, its resident table bytes (83 or 72 B a slot). Then the
    layout's ops on the card engine's table at B lanes (`_torch_op_fns`):
    device ms (events, L2 flushed, the stream held while the host
    enqueues, median of LAYOUT_REPS), device operations per call
    (`counts`, from the op counts' fresh process) and the byte bound.
    Returns {(size, layout): line}."""
    out = {}
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    for size, reference in size_refs:
        snap = reference[0]
        calls = [items[:LAYOUT_ITEMS] for items in reference[1]]
        n_obj, n_bytes = LAYOUT_OBJECT_CALLS, LAYOUT_BYTE_CALLS
        obj_calls, byte_calls = calls[:n_obj], calls[n_obj:n_obj + n_bytes]
        restart_call = calls[0]  # its keys again, on the restarted engine
        bodies = [encode_request(items) for items in byte_calls]
        image = SlotTable(**{f: snap[f] for f in SlotTable._fields})
        items = {"objects": sum(map(len, obj_calls)), "bytes": sum(map(len, byte_calls)),
                 "restart": len(restart_call)}
        with _clock.freeze(NOW) as clk:
            t0 = time.perf_counter()
            fused = None
            fused_name = cuda_decide.config_name("fused", bool(size.page_groups))
            for layout in TORCH_LAYOUTS:
                t1 = time.perf_counter()
                cpu = _layout_run(size, layout, "cpu", snap, obj_calls, bodies, None, clk)
                cpu["eng"].close()
                cpu_s = time.perf_counter() - t1
                if fused is None:
                    # the cross-check: the fused kernel's engine on the card,
                    # restarted from the same snapshots (the Loader's rows are
                    # the same at every layout)
                    fused = _layout_run(size, "fused", DEVICE, snap, obj_calls, bodies,
                                        restart_call, clk, saved=cpu["saved"])
                    fused["eng"].close()
                    if not (fused["launches"][fused_name] == fused["stats"]["waves"]
                            + fused["restart_waves"] > 0):
                        raise AssertionError(f"{size.name}: the fused engine's launches "
                                             f"{fused['launches']} do not match its waves")
                    free_device()
                got = _layout_run(size, layout, DEVICE, snap, obj_calls, bodies, restart_call,
                                  clk)
                eng = got["eng"]
                name = f"{layout}_{'paged' if size.page_groups else 'flat'}"
                try:
                    diff = _layout_checks(name, got, fused, cpu)
                    st = got["stats"]
                    slots = (size.page_budget * size.page_groups if size.page_groups
                             else size.num_groups) * WAYS
                    line = {
                        "phase": "layouts", "size": size.name, "layout": layout,
                        "paged": bool(size.page_groups), "items": items, **diff,
                        "decisions_per_s": {p: items[p] / got["seconds"][p] for p in items},
                        "fused_decisions_per_s": {p: items[p] / fused["seconds"][p]
                                                  for p in items},
                        "seconds": got["seconds"], "stats": st,
                        "columnar_calls": got["columnar_calls"],
                        "loader_items": len(got["saved"]),
                        "hand_kernel_launches": sum(got["launches"].values()),
                        "fused_launches": fused["launches"][fused_name],
                        "table_bytes": got["table_bytes"], "slots": slots,
                        "bytes_per_slot": got["table_bytes"] / slots,
                        "census_live": got["census"]["live"], "cpu_run_s": cpu_s,
                        "card": card,
                    }
                    if line["hand_kernel_launches"] or st["kernel_launches"] \
                            or got["restart_launches"]:
                        raise AssertionError(f"{name}: a hand kernel was launched")
                    if line["columnar_calls"] != n_bytes or st["columnar_flushes"] != n_bytes:
                        raise AssertionError(f"{name}: the bytes did not go columnar")
                    if line["bytes_per_slot"] != BYTES_PER_SLOT[layout]:
                        raise AssertionError(f"{name}: {line['bytes_per_slot']} B a slot")
                    if size.page_groups and not (st["promotes"] > 0 and st["demotes"] > 0):
                        raise AssertionError(f"{name}: no page moved")
                    del got, cpu
                    pm = eng._pager.page_map if size.page_groups else None
                    ops = _torch_op_fns(rng, eng.K, eng.table, size, layout, pm, image)
                    key = f"layouts/{size.name}/{layout}"
                    for op, (fn, nbytes) in ops.items():
                        fn()
                        sync()
                        line[op] = {
                            "device_ms_median": _median_ms(fn, LAYOUT_REPS, flush,
                                                          hold_cycles=SCAN_HOLD_CYCLES),
                            "device_ops_per_call": counts[key][op], "bytes_bound": nbytes,
                            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
                    del ops
                finally:
                    eng.close()
                line["phase_s"] = time.perf_counter() - t1
                emit(line)
                out[(size.name, layout)] = line
                free_device()
            emit({"phase": "layouts_size", "size": size.name,
                  "seconds": time.perf_counter() - t0, "card": card})
    del flush
    return out


# ---------------------------------------------------------------------------
# the observability core (metrics registry, engine telemetry, watchdog,
# device memory) over the serving paths, and the p99 GetRateLimits latency

# `name{labels} value`: one sample line of the Prometheus text format
_SAMPLE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(?:[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*",?)*\})? (\S+)$')
WATCHDOG_STALL_MS = 5000.0
_STAGES = ("intake", "assemble", "dispatch", "inflight_wait", "device_sync", "resolve")


def parse_exposition(text: str) -> dict:
    """{sample name with its labels: value} of a Prometheus text body;
    raises on a line that is neither a HELP or TYPE comment nor a sample
    whose value parses as a float."""
    out = {}
    for line in text.splitlines():
        if line.startswith(("# HELP ", "# TYPE ")):
            continue
        m = _SAMPLE.match(line)
        if m is None:
            raise AssertionError(f"an exposition line does not parse: {line!r}")
        out[m.group(1) + (m.group(2) or "")] = float(m.group(3))
    return out


def stage_stats(em) -> dict:
    """Per stage of the engine's stage_duration histogram: observations,
    the p50 and p99 in ms (interpolated in its power-of-two buckets) and
    the exact mean in ms."""
    out = {}
    for (stage,), s in sorted(em.stage_duration.label_summaries().items()):
        n = s["count"]
        out[stage] = {"count": n, "p50_ms": s["p50"] * 1e3, "p99_ms": s["p99"] * 1e3,
                      "mean_ms": s["sum"] / n * 1e3 if n else None}
    return out


def _table_bytes(t) -> int:
    """Bytes of the slot rows an engine's table holds (its tensors, the
    page map left out)."""
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    if hasattr(t, "_fields"):
        return sum(_table_bytes(getattr(t, f)) for f in t._fields if f != "page_map")
    return 0


def _allocator_in_use(eng) -> tuple:
    """(device_memory(), allocated_bytes.all.current) read together: the
    two agree on one of three tries unless another thread keeps
    allocating between the reads."""
    for _ in range(3):
        before = torch.cuda.memory_stats(DEVICE)["allocated_bytes.all.current"]
        d = eng.device_memory()
        after = torch.cuda.memory_stats(DEVICE)["allocated_bytes.all.current"]
        if before == after == d["bytes_in_use"]:
            break
    return d, after


def _count_bulks(eng) -> list:
    """Wrap this engine's check_bulk: the returned list's length is the
    number of bulks enqueued (the intake stage's observations)."""
    seen, bulk = [], eng.check_bulk

    def counted(reqs):
        seen.append(len(reqs))
        return bulk(reqs)

    eng.check_bulk = counted
    return seen


class _GcPauses:
    """The interpreter's garbage collections while it is entered:
    count and host ms per generation (gc.callbacks), the pauses a call
    that happens to allocate then waits out."""

    def __init__(self):
        self.ms = {0: [], 1: [], 2: []}
        self._t0 = None

    def _cb(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.ms[info["generation"]].append((time.perf_counter() - self._t0) * 1e3)
            self._t0 = None

    def __enter__(self):
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)

    def summary(self) -> dict:
        return {f"gen{g}": {"count": len(v), "total_ms": sum(v), "max_ms": max(v, default=0.0)}
                for g, v in self.ms.items()}


def _wait_beats(wd, want, timeout_s) -> set:
    deadline = time.monotonic() + timeout_s
    while not want <= set(wd.beats()) and time.monotonic() < deadline:
        time.sleep(0.02)
    return set(wd.beats())


def phase_metrics(size: Size, reference, card: str):
    """The main path's calls, as objects and then as bytes at the
    default max_waves (32), on each engine of the size (DeviceEngine and
    IciEngine of 8 shards, fused and narrow), each with a Metrics wired
    (`wire_engine_telemetry`, a V1Service on it) and a started Watchdog;
    then `render()`. Checks: every line of the exposition parses; the
    cache, over-limit, command and unexpired-eviction counters equal the
    engine's stats() and a CPU engine's of the same kind and paging on
    the same calls and clock (whose answers the card's equal); the
    flush_waves count equals the flushes; each stage's count equals the
    flushes (or bulks) that pass it; the flush durations sum to no more
    than the calls' wall time; device_memory() reads the caching
    allocator, its slot_table equals the table's bytes and fits in what
    is in use; the pump's, the completion thread's, the sync thread's
    (mesh) and the demoter's (paged) beats arrive and no serving loop
    stalls; one launch per wave. Prints decisions/s, the host ms the
    telemetry adds per flush (the resolve stage), the stage trace and
    the garbage collections during the calls. The CPU engine is a
    DeviceEngine (fused) paged as the size's engines are: the counters
    are decisions' sums, which the shard count does not change."""
    snap, calls, _want, _csnap = reference
    bodies = [encode_request(items) for items in calls]
    decisions = sum(len(c) for c in calls)
    paged = size.configs[0][1]
    results = {}
    with _clock.freeze(NOW) as clk:
        ceng = _edge_engine(size, "fused", paged, False, on="cpu", page_demote_interval_s=0.0)
        try:
            ceng.restore(snap)
            csvc = V1Service(ceng)
            obj, _, _ = _serve(csvc, calls, clk)
            byt, _, _ = _serve_bytes(csvc, bodies, clk)
            em = ceng.metrics
            cpu = (obj, byt, dict(hit=em.cache_hits, miss=em.cache_misses,
                                  over_limit=em.over_limit, commands=em.requests,
                                  unexpired=em.unexpired_evictions))
        finally:
            ceng.close()
        for name, layout, p, mesh in _edge_configs(size):
            eng = _edge_engine(size, layout, p, mesh)
            m = Metrics()
            wd = Watchdog(stall_ms=WATCHDOG_STALL_MS)
            try:
                eng.restore(snap)
                wire_engine_telemetry(m, eng)
                svc = V1Service(eng, metrics=m)
                bulks = _count_bulks(eng)
                wd.start()
                eng.watchdog = wd
                sync()
                cuda_decide.reset_launches()
                with _GcPauses() as gcp:
                    got, secs_obj, _ = _serve(svc, calls, clk)
                    gotb, secs_bytes, columnar = _serve_bytes(svc, bodies, clk)
                launches = dict(cuda_decide.CONFIG_LAUNCHES)
                st = eng.stats()
                want_beats = {"engine-pump", "engine-complete"}
                if mesh:
                    want_beats.add("ici-sync")
                if p:
                    want_beats.add("page-demoter")
                beats = _wait_beats(wd, want_beats, eng.cfg.page_demote_interval_s + 2.0)
                wd.check()
                stalled = wd.serving_stalled()
                stalled_loops = wd.stalled_loops()
                t_r = time.perf_counter()
                text = m.render().decode()
                render_s = time.perf_counter() - t_r
                mem, allocated = _allocator_in_use(eng)
                table_bytes = _table_bytes(eng.table)
                em = eng.metrics
                stages = stage_stats(em)
                overlap_p50 = em.pipeline_overlap.summary()["p50"]
            finally:
                wd.stop()
                eng.close()
            s = parse_exposition(text)
            n_lines = len(text.splitlines())
            del text
            obj, byt, ref = cpu
            flushes = st["flushes"] + st["columnar_flushes"]
            flush_s = sum(v for k, v in s.items()
                          if k.startswith("gubernator_engine_flush_duration_sum"))
            counters = dict(
                hit=s['gubernator_cache_access_count{type="hit"}'],
                miss=s['gubernator_cache_access_count{type="miss"}'],
                over_limit=s["gubernator_over_limit_counter"],
                commands=s["gubernator_command_counter"],
                unexpired=s["gubernator_unexpired_evictions_count"])
            stats_view = dict(hit=st["cache_hits"], miss=st["cache_misses"],
                              over_limit=st["over_limit"], commands=st["requests"],
                              unexpired=st["unexpired_evictions"])
            stage_counts = {k: int(s.get(f'gubernator_engine_stage_duration_count{{stage="{k}"}}', 0))
                            for k in _STAGES}
            want_counts = dict(intake=len(bulks), assemble=flushes, dispatch=st["flushes"],
                               inflight_wait=st["flushes"], device_sync=flushes,
                               resolve=st["flushes"])
            res = {"phase": "metrics", "size": size.name, "kernel": name, "mesh": mesh,
                   "paged": p, "calls": len(calls), "items": decisions,
                   "exposition_lines": n_lines, "samples": len(s), "render_s": render_s,
                   "counters": counters, "stats": stats_view, "cpu_engine": ref,
                   "answers_mismatching_cpu": sum(a != b for gc, wc in zip(got, obj)
                                                  for a, b in zip(gc, wc))
                   + sum(a != b for a, b in zip(gotb, byt)),
                   "flushes": st["flushes"], "columnar_flushes": st["columnar_flushes"],
                   "bulks": len(bulks),
                   "flush_waves_count": s["gubernator_engine_flush_waves_count"],
                   "stage_counts": stage_counts, "stages": stages,
                   "resolve_ms_mean": stages["resolve"]["mean_ms"],
                   "resolve_ms_p50": stages["resolve"]["p50_ms"],
                   "pipeline_overlap_p50": overlap_p50, "gc": gcp.summary(),
                   "flush_duration_sum_s": flush_s, "calls_wall_s": secs_obj + secs_bytes,
                   "device_memory": {k: mem[k] for k in ("source", "bytes_in_use", "bytes_limit",
                                                         "headroom_bytes", "unattributed_bytes")},
                   "allocator_bytes_in_use": allocated,
                   "slot_table_bytes": mem["subsystems"]["slot_table"],
                   "table_tensor_bytes": table_bytes,
                   "watchdog_beats": sorted(beats), "serving_stalled": stalled,
                   "stalled_loops": stalled_loops,
                   "waves": st["waves"], "launches": launches[name],
                   "other_kernel_launches": sum(launches.values()) - launches[name],
                   "decisions_per_s_objects": decisions / secs_obj,
                   "decisions_per_s_bytes": decisions / secs_bytes,
                   "card": card}
            emit(res)
            if res["answers_mismatching_cpu"]:
                raise AssertionError(f"{name}: metrics run answers differ from the CPU engine")
            if not counters == stats_view == ref:
                raise AssertionError(f"{name}: rendered counters {counters}, stats {stats_view}, "
                                     f"CPU engine {ref}")
            if res["flush_waves_count"] != flushes or stage_counts != want_counts:
                raise AssertionError(f"{name}: stage counts {stage_counts}, want {want_counts}; "
                                     f"flush_waves {res['flush_waves_count']}, flushes {flushes}")
            if flush_s > res["calls_wall_s"]:
                raise AssertionError(f"{name}: flush durations sum to {flush_s} s, more than "
                                     f"the calls' {res['calls_wall_s']} s")
            if not (mem["source"] == "device" and mem["bytes_in_use"] == allocated
                    and table_bytes == res["slot_table_bytes"] <= mem["bytes_in_use"]):
                raise AssertionError(f"{name}: device_memory {res['device_memory']}, allocator "
                                     f"{allocated}, table {table_bytes}")
            if not want_beats <= beats or stalled:
                raise AssertionError(f"{name}: watchdog beats {sorted(beats)} (want "
                                     f"{sorted(want_beats)}), stalled {stalled_loops}")
            if not (launches[name] == st["waves"] > 0) or res["other_kernel_launches"]:
                raise AssertionError(f"{name}: kernel launches do not match the waves")
            results[(name, size.name)] = res
            free_device()
    return results


TELEMETRY_TURNS = (128, 0, 0, 128)  # hotkeys_k per turn


def phase_telemetry_ab(size: Size, reference, card: str):
    """The hot-key sketch, the telemetry's one per-item part, on and off
    (`hotkeys_k` 128 and 0, the JAX knob GUBER_HOTKEYS_K) in turns on a
    fresh DeviceEngine (fused) per turn: the main path's calls as
    objects, answers equal to the CPU engine's. Per turn decisions/s,
    the resolve stage (mean and p50 ms per flush) and the garbage
    collections; the rest of the telemetry is a few histogram
    observes per flush."""
    snap, calls, want, _csnap = reference
    decisions = sum(len(c) for c in calls)
    name = cuda_decide.config_name("fused", False)
    out = []
    with _clock.freeze(NOW) as clk:
        for turn, k in enumerate(TELEMETRY_TURNS):
            eng = _edge_engine(size, "fused", False, False, hotkeys_k=k)
            try:
                eng.restore(snap)
                sync()
                cuda_decide.reset_launches()
                with _GcPauses() as gcp:
                    got, secs, _ = _serve(V1Service(eng), calls, clk)
                launches = dict(cuda_decide.CONFIG_LAUNCHES)
                st = eng.stats()
                stages = stage_stats(eng.metrics)
                tracked = eng.metrics.hotkeys.summary()["count"]
            finally:
                eng.close()
            res = {"phase": "telemetry_ab", "size": size.name, "kernel": name, "turn": turn,
                   "hotkeys_k": k, "keys_tracked": tracked,
                   "response_mismatches": sum(a != b for gc_, wc in zip(got, want)
                                              for a, b in zip(gc_, wc)),
                   "flushes": st["flushes"], "waves": st["waves"], "launches": launches[name],
                   "resolve_ms_mean": stages["resolve"]["mean_ms"],
                   "resolve_ms_p50": stages["resolve"]["p50_ms"], "stages": stages,
                   "gc": gcp.summary(), "decisions_per_s": decisions / secs, "seconds": secs,
                   "card": card}
            emit(res)
            if res["response_mismatches"] or launches[name] != st["waves"]:
                raise AssertionError(f"{name}: the telemetry A/B run disagrees with the CPU engine")
            if (tracked > 0) != (k > 0):
                raise AssertionError(f"{name}: hotkeys_k {k} tracked {tracked} keys")
            out.append(res)
            free_device()
    return out


LAT_CALLS = 1000
LAT_ITEMS = 10
LAT_CALLERS = 16


def _decode_responses(data: bytes) -> list:
    """(status, limit, remaining, reset_time, error) of each RateLimitResp
    in GetRateLimitsResp bytes (fields 1-5; metadata skipped)."""

    def varint(buf, i):
        v = shift = 0
        while True:
            b = buf[i]
            i += 1
            v |= (b & 0x7F) << shift
            shift += 7
            if b < 0x80:
                return v, i

    out, i = [], 0
    while i < len(data):
        tag, i = varint(data, i)
        n, i = varint(data, i)
        body, i, j = data[i:i + n], i + n, 0
        r = [0, 0, 0, 0, ""]
        while j < len(body):
            ftag, j = varint(body, j)
            field, wt = ftag >> 3, ftag & 7
            if wt == 0:
                v, j = varint(body, j)
                r[field - 1] = v - (1 << 64) if v >= 1 << 63 else v
            else:
                ln, j = varint(body, j)
                if field == 5:
                    r[4] = body[j:j + ln].decode("utf-8")
                j += ln
        if tag != 0x0A:
            raise AssertionError(f"unexpected field tag {tag} in a GetRateLimitsResp")
        out.append(tuple(r))
    return out


async def _drive_callers(svc, work, objects: bool):
    """LAT_CALLERS asyncio callers draining `work` (item lists, or their
    bytes) through the service; returns (per-call seconds, wall seconds,
    each call's answers in `work`'s order)."""
    lat, answers = [], [None] * len(work)
    it = iter(enumerate(work))

    async def caller():
        for c, item in it:
            if objects:
                reqs = [RateLimitReq(**kw) for kw in item]
                t0 = time.perf_counter()
                resp = await svc.get_rate_limits(reqs)
                lat.append(time.perf_counter() - t0)
                answers[c] = [(r.status, r.limit, r.remaining, r.reset_time, r.error)
                              for r in resp]
            else:
                t0 = time.perf_counter()
                data = await serve_get_rate_limits_bytes(svc, item)
                lat.append(time.perf_counter() - t0)
                answers[c] = _decode_responses(data)

    t0 = time.perf_counter()
    await asyncio.gather(*(caller() for _ in range(LAT_CALLERS)))
    return lat, time.perf_counter() - t0, answers


def _latency_reference(size: Size, snap, work):
    """The latency phase's work on a CPU engine (flat, fused), in call
    order, 1,000 items a bulk: each item's answer and the indices of the
    items whose key no other item of the work names. Such an item's
    answer depends on no other item (its key is not in the image, and
    it is the key's only request), so it is the same in any order the
    concurrent callers reach the card in; the other keys' answers are
    not."""
    flat = [kw for items in work for kw in items]
    keys, counts = np.unique([kw["unique_key"] for kw in flat], return_counts=True)
    once = set(keys[counts == 1].tolist())
    singles = [i for i, kw in enumerate(flat) if kw["unique_key"] in once]
    want = []
    with _clock.freeze(NOW):
        eng = _edge_engine(size, "fused", False, False, on="cpu")
        try:
            eng.restore(snap)
            svc = V1Service(eng)
            for i in range(0, len(flat), MAX_BATCH_SIZE):
                resp = asyncio.run(svc.get_rate_limits(
                    [RateLimitReq(**kw) for kw in flat[i:i + MAX_BATCH_SIZE]]))
                want += [(r.status, r.limit, r.remaining, r.reset_time, r.error) for r in resp]
        finally:
            eng.close()
    return want, singles


def phase_latency(rng, size: Size, reference, card: str):
    """The first p99 GetRateLimits: LAT_CALLS calls of LAT_ITEMS Zipf(1.1)
    items (the main path's mix) from LAT_CALLERS concurrent asyncio
    callers, as objects and over bytes, each on a fresh DeviceEngine
    (fused) and IciEngine (fused, 8 shards) at 1M, max_waves 32, the
    default pipeline depth, with a Metrics wired. Per run: the host
    clock's p50, p99 and max per call, decisions/s, the stage_duration
    p50 and p99 per stage, pipeline_overlap's median; every item
    answered without an error, one launch per wave. The answers are
    held against a CPU engine fed the same work in call order
    (`_latency_reference`): equal for every item whose key the work
    names once, and for every item its limit; the OVER_LIMIT answers'
    count equals the rendered admission decisions of status over_limit
    and the rendered over_limit_counter{path} children's sum; the
    engine's over_limit (the waves' over-limit lanes, as the reference's
    counter counts them: not every OVER_LIMIT answer) equals the bare
    over_limit_counter sample; the engine's requests, hits plus misses, the
    rendered getratelimit_counter{calltype="local"} and the rendered
    admission decisions all equal the items."""
    snap = reference[0]
    zipf = _Zipf(size.live_keys)
    work = [_smoke_items(rng, zipf.draw(rng, LAT_ITEMS)) for _ in range(LAT_CALLS)]
    bodies = [encode_request(items) for items in work]
    want, singles = _latency_reference(size, snap, work)
    results = {}
    with _clock.freeze(NOW):
        for mesh in (False, True):
            name = cuda_decide.sharded_name("fused") if mesh else cuda_decide.config_name("fused", False)
            for objects in (True, False):
                eng = _edge_engine(size, "fused", False, mesh)
                try:
                    eng.restore(snap)
                    svc = V1Service(eng, metrics=Metrics())
                    wire_engine_telemetry(svc.metrics, eng)
                    sync()
                    cuda_decide.reset_launches()
                    with _GcPauses() as gcp:
                        lat, wall, per_call = asyncio.run(
                            _drive_callers(svc, work if objects else bodies, objects))
                    launches = dict(cuda_decide.CONFIG_LAUNCHES)
                    st = eng.stats()
                    rendered = parse_exposition(svc.metrics.render().decode())
                    em = eng.metrics
                    stages = stage_stats(em)
                    overlap = em.pipeline_overlap.summary()["p50"]
                    waves_hist = em.flush_waves.summary()
                    width = em.batch_width.summary()
                finally:
                    eng.close()
                ms = np.sort(np.asarray(lat)) * 1e3
                items = LAT_CALLS * LAT_ITEMS
                answers = [a for call in per_call for a in (call or ())]
                errors = sum(bool(a[4]) for a in answers)
                over = sum(a[0] == 1 for a in answers)
                counts = {
                    "over_limit_answers": over, "stats_over_limit": st["over_limit"],
                    "rendered_over_limit": rendered["gubernator_over_limit_counter"],
                    "stats_requests": st["requests"],
                    "stats_hits_plus_misses": st["cache_hits"] + st["cache_misses"],
                    "rendered_local_calls":
                        rendered['gubernator_getratelimit_counter{calltype="local"}'],
                    "rendered_admission_decisions": sum(
                        v for k, v in rendered.items()
                        if k.startswith("gubernator_admission_decisions{")),
                    "rendered_over_limit_by_path": sum(
                        v for k, v in rendered.items()
                        if k.startswith("gubernator_over_limit_counter{")),
                    "rendered_admission_over_limit": sum(
                        v for k, v in rendered.items()
                        if k.startswith("gubernator_admission_decisions{")
                        and 'status="over_limit"' in k),
                }
                checked = {
                    "single_key_items": len(singles),
                    "single_key_mismatches": sum(answers[i] != want[i] for i in singles)
                    if len(answers) == items else None,
                    "limit_mismatches": sum(a[1] != w[1] for a, w in zip(answers, want)),
                }
                res = {"phase": "latency", "size": size.name, "kernel": name, "mesh": mesh,
                       "path": "objects" if objects else "bytes", "calls": LAT_CALLS,
                       "items_per_call": LAT_ITEMS, "callers": LAT_CALLERS,
                       "max_waves": eng.cfg.max_waves, "pipeline_depth": eng.cfg.pipeline_depth,
                       "p50_ms": float(np.percentile(ms, 50)),
                       "p99_ms": float(np.percentile(ms, 99)),
                       "max_ms": float(ms[-1]), "mean_ms": float(ms.mean()),
                       "decisions_per_s": items / wall, "wall_s": wall,
                       "answers": len(answers), "error_answers": errors,
                       "counts": counts, "against_cpu": checked,
                       "flushes": st["flushes"], "columnar_flushes": st["columnar_flushes"],
                       "waves": st["waves"], "launches": launches[name],
                       "inflight_max": st["inflight_max"],
                       "batch_width_p50": width["p50"], "flush_waves_p50": waves_hist["p50"],
                       "stages": stages, "pipeline_overlap_p50": overlap, "gc": gcp.summary(),
                       "card": card}
                emit(res)
                if len(answers) != items or errors:
                    raise AssertionError(f"{name}: {len(answers)} answers of {items}, "
                                         f"{errors} errors")
                if checked["single_key_mismatches"] or checked["limit_mismatches"]:
                    raise AssertionError(f"{name}: answers differ from the CPU engine: {checked}")
                if not (over == counts["rendered_admission_over_limit"]
                        == counts["rendered_over_limit_by_path"]
                        and counts["stats_over_limit"] == counts["rendered_over_limit"]
                        and items == counts["stats_requests"] == counts["stats_hits_plus_misses"]
                        == counts["rendered_local_calls"]
                        == counts["rendered_admission_decisions"]):
                    raise AssertionError(f"{name}: counters disagree with the answers: {counts}")
                if not (launches[name] == st["waves"] > 0):
                    raise AssertionError(f"{name}: kernel launches do not match the waves")
                results[(name, res["path"])] = res
                free_device()
    return results


# ---------------------------------------------------------------------------
# the overload control plane and the SLO observatory

OVL_LIMIT = 8192  # the JAX package's intake limit (GUBER_INTAKE_LIMIT)
OVL_TARGET_MS = 20.0  # its CoDel target (GUBER_INTAKE_TARGET_MS)
OVL_LADDER_S = 0.25  # the ladder's interval
OVL_SLO_S = 0.5  # the SLO sampler's interval: 5 s by default, shortened here
OVL_DEADLINE_ITEMS = 16
# The flood (tools/jobs/45_overload_soak.py's shape, in process): the
# engine's appetite per flush cut to 4 items so that a Python flood can
# stand a queue, the soak's intake limit and target, closed-loop good
# tenants and one open-loop flood tenant at 10x their offered rate.
FLOOD_ENGINE = dict(batch_wait_s=0.004, batch_limit=4)
FLOOD_LIMIT = 256
FLOOD_TARGET_MS = 15.0
FLOOD_LADDER_S = 0.1
FLOOD_HYSTERESIS = 10
FLOOD_WORKERS = 4
FLOOD_BATCH = 2
FLOOD_X = 10.0
FLOOD_OUTSTANDING = 4000
FLOOD_WARM_S = 1.0
FLOOD_BASE_S = 3.0
FLOOD_S = 8.0
FLOOD_GOOD_KEYS = 256
FLOOD_KEYS = 2048
FLOOD_HIT_LIMIT = 1_000_000_000
FLOOD_DURATION_MS = 600_000
COST_TURNS = ("off", "gov", "on", "on", "gov", "off") * 2
SLO_OP_PASSES = 100


class _Plane:
    """The overload plane armed on one engine and its service as the JAX
    daemon arms it (its daemon.py: a Watchdog on the engine, handed to
    the sampler and the ladder, an SloObservatory on the service, an
    IntakeGovernor on the engine, the OverloadManager ladder on the
    service), threads started. `stop()` stops them and leaves engine and
    service unarmed."""

    def __init__(self, eng, svc, *, limit=OVL_LIMIT, target_ms=OVL_TARGET_MS,
                 ladder_s=OVL_LADDER_S, slo_s=OVL_SLO_S, hysteresis=8):
        self.eng, self.svc = eng, svc
        self.wd = Watchdog(stall_ms=WATCHDOG_STALL_MS)
        eng.watchdog = self.wd
        self.slo = SloObservatory(svc, interval_s=slo_s, specs=parse_slo_specs(""),
                                  watchdog=self.wd)
        svc.slo = self.slo
        self.gov = IntakeGovernor(limit=limit, target_ms=target_ms, metrics=svc.metrics,
                                  recorder=svc.recorder)
        self.mgr = OverloadManager(svc, self.gov, slo=self.slo, watchdog=self.wd,
                                   interval_s=ladder_s, hysteresis=hysteresis)
        svc.overload = self.mgr
        eng.overload = self.gov
        self.wd.start()
        self.slo.start()
        self.mgr.start()

    def stop(self) -> None:
        self.mgr.stop()
        self.slo.stop()
        self.wd.stop()
        self.eng.overload = self.eng.watchdog = None
        self.svc.overload = self.svc.slo = None


def _armed_service(eng, **kw):
    """A V1Service with a Metrics wired to the engine, and the plane
    armed on both."""
    m = Metrics()
    wire_engine_telemetry(m, eng)
    svc = V1Service(eng, metrics=m)
    return svc, _Plane(eng, svc, **kw)


def _serve_idle(svc, calls, clk):
    """`_serve` with the collector held off: a gen-2 collection (0.15-0.35
    s on this path, PERF.md section 5) while a bulk waits would be a
    standing queue to the CoDel controller, which an idle run must not
    have."""
    gc.collect()
    gc.disable()
    try:
        return _serve(svc, calls, clk)
    finally:
        gc.enable()


def _shed_counts(rendered) -> dict:
    return {r: rendered.get(f'gubernator_intake_shed_counter{{reason="{r}"}}', 0.0)
            for r in SHED_REASONS}


def _deadline_checks(eng, gov) -> dict:
    """Expired deadlines through check_async and check_bulk, refused at
    admit; live deadlines refused at the pump's pickup (the verdict
    forced, as the JAX package's test forces it); then a bulk of one
    expired, one deadline-free and one live member. Returns the counts
    and the checks' results."""
    now = _clock.now_ms()
    dead = {DEADLINE_MD_KEY: str(now - 5)}
    live = {DEADLINE_MD_KEY: str(now + 60_000)}

    def mk(k, md):
        return RateLimitReq(name="overload", unique_key=f"dl:{k}", hits=1, limit=10,
                            duration=60_000, metadata=dict(md))

    st0, l0 = eng.stats(), sum(cuda_decide.CONFIG_LAUNCHES.values())
    shed0 = gov.snapshot()["shed"]["deadline_expired"]
    n = OVL_DEADLINE_ITEMS
    refused = [eng.check_async(mk(i, dead)).result(timeout=60) for i in range(n)]
    refused += eng.check_bulk([mk(i, dead) for i in range(n)]).result(timeout=60)
    gov.deadline_expired = lambda _dl: True
    try:
        refused += [eng.check_async(mk(f"p{i}", live)).result(timeout=60) for i in range(4)]
        refused += eng.check_bulk([mk(f"p{i}", live) for i in range(4)]).result(timeout=60)
    finally:
        del gov.deadline_expired
    st1, l1 = eng.stats(), sum(cuda_decide.CONFIG_LAUNCHES.values())
    mixed = eng.check_bulk([mk("m0", dead), mk("m1", {}), mk("m2", live)]).result(timeout=60)
    st2, l2 = eng.stats(), sum(cuda_decide.CONFIG_LAUNCHES.values())
    return {
        "refused": len(refused),
        "refused_as_jax": sum(r.error == ERR_DEADLINE_EXPIRED
                              and r.metadata == {"decision_path": "shed"} for r in refused),
        "flushes_waves_launches_during_refusals": [
            st1["flushes"] - st0["flushes"], st1["waves"] - st0["waves"], l1 - l0],
        "mixed_bulk": [r.error or f"remaining={r.remaining}" for r in mixed],
        "mixed_ok": (mixed[0].error == ERR_DEADLINE_EXPIRED
                     and mixed[1].error == mixed[2].error == ""
                     and mixed[1].remaining == mixed[2].remaining == 9),
        "mixed_flushes": st2["flushes"] - st1["flushes"],
        "mixed_waves_launches": [st2["waves"] - st1["waves"], l2 - l1],
        "deadline_sheds": gov.snapshot()["shed"]["deadline_expired"] - shed0,
    }


def _overload_idle(size: Size, reference, clk, mesh: bool, card: str) -> dict:
    """Steps 1-2 of phase_overload on one engine."""
    snap, calls, want, csnap = reference
    name = cuda_decide.sharded_name("fused") if mesh else cuda_decide.config_name("fused", False)
    eng = _edge_engine(size, "fused", False, mesh)
    plane = None
    try:
        eng.restore(snap)
        svc, plane = _armed_service(eng)
        sync()
        cuda_decide.reset_launches()
        got, secs, _ = _serve_idle(svc, calls, clk)
        launches = dict(cuda_decide.CONFIG_LAUNCHES)
        st = eng.stats()
        esnap = eng.snapshot()
        idle = svc.overload_debug_info()
        beats = _wait_beats(plane.wd, {"engine-pump", "engine-complete", "overload-ladder",
                                       "slo-sampler"}, 3.0)
        deadlines = _deadline_checks(eng, plane.gov)
        rendered = parse_exposition(svc.metrics.render().decode())
        info = svc.overload_debug_info()
        slo = svc.slo_debug_info()
    finally:
        if plane is not None:
            plane.stop()
        eng.close()
    decisions = sum(len(c) for c in calls)
    res = {"phase": "overload", "step": "armed_idle_and_deadlines", "size": size.name,
           "kernel": name, "mesh": mesh, "intake_limit": OVL_LIMIT,
           "target_ms": OVL_TARGET_MS, "calls": len(calls), "items": decisions,
           "response_mismatches": sum(a != b for gc_, wc in zip(got, want)
                                      for a, b in zip(gc_, wc)),
           "snapshot_columns_differing": _snap_diff(esnap, csnap),
           "flushes": st["flushes"], "waves": st["waves"], "launches": launches[name],
           "other_kernel_launches": sum(launches.values()) - launches[name],
           "idle_level": idle["level"], "idle_signals": idle["signals"],
           "idle_shed": idle["intake"]["shed"],
           "idle_hot_tenants": idle["intake"]["hot_tenants"],
           "watchdog_beats": sorted(beats), "deadlines": deadlines,
           "shed_debug": info["intake"]["shed"], "shed_rendered": _shed_counts(rendered),
           "slo_ticks": slo["ticks"], "slo_slis": sorted(slo["slis"]),
           "slo_alerting": slo["budget"]["alerting"],
           "decisions_per_s": decisions / secs, "card": card}
    del esnap
    emit(res)
    want_dl = 2 * OVL_DEADLINE_ITEMS + 8
    if res["response_mismatches"] or res["snapshot_columns_differing"]:
        raise AssertionError(f"{name}: armed and idle, the answers or the table differ from "
                             "the CPU engine's")
    if not (launches[name] == st["waves"] > 0) or res["other_kernel_launches"]:
        raise AssertionError(f"{name}: armed and idle, kernel launches do not match the waves")
    # The intake never stands a queue here; the ladder may still move on
    # the mesh, where the Zipf head skews the shards' decisions past the
    # shard-balance SLO's 1.5x and its burn is a ladder signal, as in the
    # JAX package. A shed, or any other signal, fails.
    sig = idle["signals"]
    slo_only = set(sig.get("slo_fast_burn") or []) <= ({"shard-balance"} if mesh else set())
    if (any(idle["intake"]["shed"].values()) or sig.get("intake_overloaded")
            or sig.get("serving_stalled") or not slo_only
            or (idle["level"] and not (mesh and sig.get("slo_fast_burn")))):
        raise AssertionError(f"{name}: armed and idle, level {idle['level']}, signals {sig}, "
                             f"sheds {idle['intake']['shed']}")
    if not (deadlines["refused"] == deadlines["refused_as_jax"] == want_dl
            and deadlines["flushes_waves_launches_during_refusals"] == [0, 0, 0]):
        raise AssertionError(f"{name}: expired deadlines: {deadlines}")
    w, lch = deadlines["mixed_waves_launches"]
    if not (deadlines["mixed_ok"] and deadlines["mixed_flushes"] == 1 and w == lch > 0
            and deadlines["deadline_sheds"] == want_dl + 1):
        raise AssertionError(f"{name}: the mixed bulk: {deadlines}")
    if res["shed_debug"] != res["shed_rendered"]:
        raise AssertionError(f"{name}: shed counts {res['shed_debug']} in debug_info, "
                             f"{res['shed_rendered']} rendered")
    if "overload-ladder" not in beats or "slo-sampler" not in beats:
        raise AssertionError(f"{name}: the ladder and the sampler did not beat: {sorted(beats)}")
    return res


def _free_group_keys(free, num_groups: int, name: str, n: int, taken: set) -> list:
    """n keys of namespace `name`, each hashing to a group that holds no
    row of the image (`free`) and no other chosen key (`taken`): such a
    key's row depends on its own hits only, whatever the order."""
    keys, start = [], 0
    while len(keys) < n:
        cand = [f"f{j}" for j in range(start, start + 50_000)]
        grp = key_hash128_batch([f"{name}_{c}" for c in cand], num_groups)[2].tolist()
        for c, g in zip(cand, grp):
            if free[g] and g not in taken:
                taken.add(g)
                keys.append(c)
                if len(keys) == n:
                    break
        start += 50_000
    return keys


def _p(lat, q) -> float:
    return float(np.percentile(np.asarray(lat) * 1e3, q)) if lat else None


async def _flood_drive(eng, svc, plane, good_keys, flood_keys) -> dict:
    """The flood, on one asyncio loop (one producer thread, so the depth
    each admit reads is the depth it leaves): FLOOD_WORKERS closed-loop
    good tenants of FLOOD_BATCH items a call through the service; after
    FLOOD_WARM_S and a FLOOD_BASE_S baseline, one open-loop flood tenant
    sends per-item check_async at FLOOD_X times the good tenants'
    offered rate for FLOOD_S, its typed sheds re-sent once through a
    RetryBudget; the good tenants stop once the flood's outstanding
    answers are in. Returns what it saw."""
    st = {"acked": 0, "offered": 0, "lat": [], "good_shed": 0}
    answers = []  # (name, key, resp) of every answer
    stop_good = asyncio.Event()

    def req(name, key):
        return RateLimitReq(name=name, unique_key=key, hits=1, limit=FLOOD_HIT_LIMIT,
                            duration=FLOOD_DURATION_MS)

    async def good_worker(w):
        j = w * 7
        while not stop_good.is_set():
            j += FLOOD_BATCH
            ks = [good_keys[(j + i) % len(good_keys)] for i in range(FLOOD_BATCH)]
            st["offered"] += FLOOD_BATCH
            t0 = time.perf_counter()
            out = await svc.get_rate_limits([req("good", k) for k in ks])
            dt = time.perf_counter() - t0
            ok = 0
            for k, r in zip(ks, out):
                answers.append(("good", k, r))
                if r.error:
                    st["good_shed"] += 1
                else:
                    ok += 1
            if ok:
                st["acked"] += ok
                st["lat"].append(dt)

    def window():
        snap = dict(st, lat=list(st["lat"]))
        st.update(acked=0, offered=0, lat=[], good_shed=0)
        return snap

    seen = {"max_depth": 0, "levels": [0]}
    stop_sample = asyncio.Event()

    def look():
        seen["max_depth"] = max(seen["max_depth"], eng.queue_depth())
        lv = plane.mgr.level
        if lv != seen["levels"][-1]:
            seen["levels"].append(lv)

    async def sampler():
        while not stop_sample.is_set():
            look()
            await asyncio.sleep(0.01)

    workers = [asyncio.ensure_future(good_worker(w)) for w in range(FLOOD_WORKERS)]
    sample_task = asyncio.ensure_future(sampler())
    await asyncio.sleep(FLOOD_WARM_S)
    window()
    t0 = time.perf_counter()
    await asyncio.sleep(FLOOD_BASE_S)
    base = window()
    base_s = time.perf_counter() - t0

    rate = FLOOD_X * base["offered"] / base_s
    budget = RetryBudget(ratio=0.1)
    outstanding = []  # (future, key, retried)
    fl = {"sent": 0, "retries": 0, "dropped": 0}

    def send(k, retried):
        outstanding.append((eng.check_async(req("flood", flood_keys[k % len(flood_keys)])),
                            k, retried))

    def reap(resend: bool):
        live = []
        for f, k, retried in outstanding:
            if not f.done():
                live.append((f, k, retried))
                continue
            r = f.result()
            answers.append(("flood", flood_keys[k % len(flood_keys)], r))
            if (resend and r.error and not retried and is_retryable_error(r.error)
                    and budget.try_spend()):
                fl["retries"] += 1
                live.append((eng.check_async(req("flood", flood_keys[k % len(flood_keys)])),
                             k, True))
        outstanding[:] = live

    t0 = time.perf_counter()
    t_end, due, last = t0 + FLOOD_S, 0.0, t0
    while True:
        now = time.perf_counter()
        if now >= t_end:
            break
        due += rate * (now - last)
        last = now
        k = int(due)
        due -= k
        for _ in range(k):
            if len(outstanding) >= FLOOD_OUTSTANDING:
                fl["dropped"] += 1
                continue
            budget.record(1)
            send(fl["sent"], False)
            fl["sent"] += 1
        look()
        reap(True)
        await asyncio.sleep(0.02)
    flood_s = time.perf_counter() - t0
    under = window()
    while outstanding:
        reap(False)
        await asyncio.sleep(0.01)
    stop_good.set()
    stop_sample.set()
    await asyncio.gather(sample_task, *workers)
    return {"base": base, "base_s": base_s, "under": under, "flood_s": flood_s,
            "flood": fl, "flood_rate": rate, "budget": budget.snapshot(), "seen": seen,
            "final_level": plane.mgr.level, "answers": answers}


def _overload_flood(size: Size, snap, card: str) -> dict:
    """Step 3 of phase_overload (DeviceEngine, fused)."""
    name = cuda_decide.config_name("fused", False)
    free = ~np.asarray(snap["used"]).reshape(size.num_groups, WAYS).any(axis=1)
    taken = set()
    good_keys = _free_group_keys(free, size.num_groups, "good", FLOOD_GOOD_KEYS, taken)
    flood_keys = _free_group_keys(free, size.num_groups, "flood", FLOOD_KEYS, taken)
    eng = _edge_engine(size, "fused", False, False, **FLOOD_ENGINE)
    plane = None
    try:
        eng.restore(snap)
        svc, plane = _armed_service(eng, limit=FLOOD_LIMIT, target_ms=FLOOD_TARGET_MS,
                                    ladder_s=FLOOD_LADDER_S, hysteresis=FLOOD_HYSTERESIS)
        sync()
        cuda_decide.reset_launches()
        with _GcPauses() as gcp:
            run = asyncio.run(_flood_drive(eng, svc, plane, good_keys, flood_keys))
        launches = dict(cuda_decide.CONFIG_LAUNCHES)
        st = eng.stats()
        gsnap = eng.snapshot()
        info = svc.overload_debug_info()
        slo = svc.slo_debug_info()
        rendered = parse_exposition(svc.metrics.render().decode())
    finally:
        if plane is not None:
            plane.stop()
        eng.close()
    answers = run.pop("answers")
    admitted = [(n, k) for n, k, r in answers if not r.error]
    shed = [r for _n, _k, r in answers if r.error]
    bad_admitted = sum(not (r.status == 0 and r.limit == FLOOD_HIT_LIMIT)
                       for _n, _k, r in answers if not r.error)
    bad_shed = sum(not (r.error == ERR_OVERLOADED and RETRY_AFTER_MD_KEY in r.metadata)
                   for r in shed)
    # a CPU engine fed exactly the admitted items, in bulks
    ceng = DeviceEngine(EngineConfig(device="cpu", num_groups=size.num_groups, ways=WAYS,
                                     batch_size=B))
    try:
        ceng.restore(snap)
        for i in range(0, len(admitted), MAX_BATCH_SIZE):
            ceng.check_bulk([RateLimitReq(name=n, unique_key=k, hits=1, limit=FLOOD_HIT_LIMIT,
                                          duration=FLOOD_DURATION_MS)
                             for n, k in admitted[i:i + MAX_BATCH_SIZE]]).result(timeout=600)
        csnap = ceng.snapshot()
    finally:
        ceng.close()
    diff = _snap_diff(gsnap, csnap)
    del gsnap, csnap
    base, under = run["base"], run["under"]
    goodput_base = base["acked"] / run["base_s"]
    goodput_flood = under["acked"] / run["flood_s"]
    shed_debug = info["intake"]["shed"]
    res = {"phase": "overload", "step": "flood", "size": size.name, "kernel": name,
           "intake_limit": FLOOD_LIMIT, "target_ms": FLOOD_TARGET_MS, **FLOOD_ENGINE,
           "good_workers": FLOOD_WORKERS, "good_batch": FLOOD_BATCH,
           "good_keys": FLOOD_GOOD_KEYS, "flood_keys": FLOOD_KEYS,
           "goodput_baseline_per_s": goodput_base, "goodput_flood_per_s": goodput_flood,
           "goodput_ratio": goodput_flood / goodput_base if goodput_base else None,
           "p50_baseline_ms": _p(base["lat"], 50), "p99_baseline_ms": _p(base["lat"], 99),
           "p50_flood_ms": _p(under["lat"], 50), "p99_flood_ms": _p(under["lat"], 99),
           "good_offered_baseline_per_s": base["offered"] / run["base_s"],
           "good_shed_under_flood": under["good_shed"],
           "flood_rate_per_s": run["flood_rate"], "flood_sent": run["flood"]["sent"],
           "flood_offered_per_s": run["flood"]["sent"] / run["flood_s"],
           "flood_retries": run["flood"]["retries"],
           "flood_client_dropped": run["flood"]["dropped"], "retry_budget": run["budget"],
           "max_queue_depth": run["seen"]["max_depth"], "levels_reached": run["seen"]["levels"],
           "max_level": max(run["seen"]["levels"]), "final_level": run["final_level"],
           "shed_debug": shed_debug, "shed_rendered": _shed_counts(rendered),
           "answers": len(answers), "admitted": len(admitted), "shed_answers": len(shed),
           "admitted_not_under_limit": bad_admitted, "shed_not_typed": bad_shed,
           "engine_requests": st["requests"], "flushes": st["flushes"], "waves": st["waves"],
           "launches": launches[name],
           "other_kernel_launches": sum(launches.values()) - launches[name],
           "snapshot_columns_differing_from_cpu_fed_admitted": diff,
           "slo_states": {e["id"]: e["state"] for e in slo["slos"]},
           "slo_ticks": slo["ticks"], "signals": info["signals"], "gc": gcp.summary(),
           "card": card}
    emit(res)
    if res["max_queue_depth"] > FLOOD_LIMIT:
        raise AssertionError(f"flood: queue depth {res['max_queue_depth']} over the limit")
    if diff or bad_admitted or bad_shed:
        raise AssertionError(f"flood: table differs from a CPU engine fed the admitted items "
                             f"({diff}), {bad_admitted} admitted answers not UNDER_LIMIT, "
                             f"{bad_shed} sheds untyped")
    if not (len(admitted) == st["requests"] and len(shed) == sum(shed_debug.values())):
        raise AssertionError(f"flood: {len(admitted)} admitted, {st['requests']} served; "
                             f"{len(shed)} shed answers, {shed_debug} counted")
    if shed_debug != res["shed_rendered"]:
        raise AssertionError(f"flood: shed counts {shed_debug} in debug_info, "
                             f"{res['shed_rendered']} rendered")
    if not (launches[name] == st["waves"] > 0) or res["other_kernel_launches"]:
        raise AssertionError("flood: kernel launches do not match the waves")
    return res


def _overload_cost(size: Size, reference, clk, card: str) -> dict:
    """Step 4 of phase_overload: the main path's calls as objects on one
    DeviceEngine (fused, telemetry wired), its table restored each turn,
    unarmed ("off"), with only the IntakeGovernor on `engine.overload`
    ("gov") and with the whole plane armed and idle, its threads running
    ("on"), in COST_TURNS, the collector held off in all: decisions/s
    per turn, answers equal to the CPU engine's in every turn, and the
    host us per item of the governor alone and of the plane (each
    median's difference from "off")."""
    snap, calls, want, _csnap = reference
    decisions = sum(len(c) for c in calls)
    eng = _edge_engine(size, "fused", False, False)
    m = Metrics()
    wire_engine_telemetry(m, eng)
    svc = V1Service(eng, metrics=m)
    rates = {"off": [], "gov": [], "on": []}
    mism, sheds = 0, 0
    try:
        for variant in COST_TURNS:
            eng.restore(snap)
            plane = _Plane(eng, svc) if variant == "on" else None
            if variant == "gov":
                eng.overload = IntakeGovernor(limit=OVL_LIMIT, target_ms=OVL_TARGET_MS,
                                              metrics=m, recorder=svc.recorder)
            gov = eng.overload
            try:
                sync()
                got, secs, _ = _serve_idle(svc, calls, clk)
                if gov is not None:
                    sheds += sum(gov.snapshot()["shed"].values())
            finally:
                eng.overload = None
                if plane is not None:
                    plane.stop()
            mism += sum(a != b for gc_, wc in zip(got, want) for a, b in zip(gc_, wc))
            rates[variant].append(decisions / secs)
    finally:
        eng.close()
    med = {k: statistics.median(v) for k, v in rates.items()}
    res = {"phase": "overload", "step": "cost", "size": size.name,
           "kernel": cuda_decide.config_name("fused", False), "turns": list(COST_TURNS),
           "decisions_per_s": rates, "median_decisions_per_s": med,
           "gov_over_off": med["gov"] / med["off"], "on_over_off": med["on"] / med["off"],
           "governor_host_us_per_item": 1e6 / med["gov"] - 1e6 / med["off"],
           "plane_host_us_per_item": 1e6 / med["on"] - 1e6 / med["off"],
           "response_mismatches": mism, "sheds": sheds, "card": card}
    emit(res)
    if mism or sheds:
        raise AssertionError(f"overload cost: {mism} answers differ from the CPU engine's, "
                             f"{sheds} sheds")
    return res


def slo_op_names(seed: int) -> dict:
    """The device operations that torch.profiler records over
    SLO_OP_PASSES passes of the SLO sampler's `sample_once`, `evaluate`,
    `metrics_sync` and a `render()`, over a warmed DeviceEngine (fused,
    1M keys) with the plane armed: run by phase_overload in a fresh
    process of this script (`--slo-op-counts`), since in a long run CUPTI
    has been seen to lose records. The engine's census and admission
    caches are filled first, with TTLs longer than the passes."""
    rng = np.random.default_rng(seed)
    size = SIZES[0]
    image = live_image(rng, size)
    snap = {f: getattr(image, f) for f in SlotTable._fields}
    snap["key_strings"] = {}
    del image
    calls = smoke_calls(rng, size.live_keys)[:2]
    _device_ops(lambda: None, 0)
    with _clock.freeze(NOW) as clk:
        eng = _edge_engine(size, "fused", False, False, census_ttl_s=3600.0,
                           admission_ttl_s=3600.0)
        plane = None
        try:
            eng.restore(snap)
            svc, plane = _armed_service(eng)
            _serve(svc, calls, clk)
            eng.table_census(max_age_s=0)
            eng.admission_snapshot(max_age_s=0)
            plane.slo.sample_once()
            svc.metrics.render()
            sync()

            def passes():
                for _ in range(SLO_OP_PASSES):
                    plane.slo.sample_once()
                    plane.slo.evaluate()
                    plane.slo.metrics_sync(svc.metrics)
                    svc.metrics.render()

            t0 = time.perf_counter()
            ops = _device_ops(passes, 1)
            secs = time.perf_counter() - t0
            rings = plane.slo.rings.names()
        finally:
            if plane is not None:
                plane.stop()
            eng.close()
    return {"ops": ops, "passes": SLO_OP_PASSES, "seconds": secs, "rings": rings}


def slo_op_names_child(seed: int) -> dict:
    """`slo_op_names` in a fresh process of this script."""
    child = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--slo-op-counts", "--seed", str(seed)],
        capture_output=True, text=True, timeout=600,
    )
    if child.returncode:
        raise AssertionError(f"--slo-op-counts exited {child.returncode}: {child.stderr[-4000:]}")
    return json.loads(child.stdout.strip().splitlines()[-1])


def phase_overload(size: Size, reference, card: str, seed: int) -> dict:
    """The overload control plane and the SLO observatory on the 1M flat
    size (fused). 1: armed as the JAX daemon arms it (limit 8,192,
    target 20 ms, ladder every 0.25 s, SLO sampler every 0.5 s) and idle,
    the main path's calls as objects on a DeviceEngine and an IciEngine
    of 8 shards: answers and table equal to the CPU engine's, no shed,
    level 0, one launch per wave, the ladder and the sampler beating.
    2: on each, expired deadlines through check_async and check_bulk
    refused with the JAX package's answer and no flush, wave or launch;
    the pickup-time expiry likewise; a mixed bulk serves its live
    members; shed counts equal in debug_info and the exposition. 3: the
    flood (`_flood_drive`, printed, not gated on its rates): queue depth
    within the intake limit, every admitted answer UNDER_LIMIT, every
    shed typed, sheds and admits adding up, shed counts equal in
    debug_info and the exposition, and the table equal to a CPU engine's
    fed exactly the admitted items (fresh keys, each in a group that
    holds no other row, so that order does not matter). 4: the
    governor's host cost per item. 5: the sampler's device operations,
    in a fresh process: none but the marker fills."""
    out = {}
    with _clock.freeze(NOW) as clk:
        for mesh in (False, True):
            out[mesh] = _overload_idle(size, reference, clk, mesh, card)
            free_device()
        out["flood"] = _overload_flood(size, reference[0], card)
        free_device()
        out["cost"] = _overload_cost(size, reference, clk, card)
        free_device()
    child = slo_op_names_child(seed)
    ops = child.pop("ops")
    others = [o for o in ops if "FillFunctor" not in o]
    res = {"phase": "overload", "step": "slo_ops", "size": size.name,
           "fills_seen": len(ops) - len(others), "other_device_ops": others, **child,
           "card": card}
    emit(res)
    if others or not ops:
        raise AssertionError(f"the SLO sampler's passes recorded device operations: {others} "
                             f"(fills seen: {res['fills_seen']})")
    out["slo_ops"] = res
    return out


def run_global(rng, size: Size, reference, card: str):
    """The GLOBAL replica tier's phases. Returns {replica kernel name:
    (max err, times line)} and {layout: launches on the main path}."""
    kernels = {}
    for layout in ("fused", "narrow"):
        kernels[cuda_decide.replica_name(layout)] = phase_replica_kernel(rng, layout, card)
        free_device()
    phase_sync_tick(rng, card)
    launches = phase_global_main_path(size, reference, card)
    phase_global_cadence(size, reference, card)
    return kernels, launches


def replica_entry(name, layout, err, times, launches):
    return {
        "name": name,
        "route": "cuda",
        "source": "gubernator_tpu_torch/csrc/decide_sharded.cu",
        "replaces": "gubernator_tpu/ops/pallas_decide.py:927 (raw_decide_flat as "
                    f"gubernator_tpu/parallel/ici.py:146 make_replica_decide composes it, "
                    f"layout={layout})",
        "launches": launches,
        "max_abs_err": err,
        "ms": times["kernel_ms_median"],
        "plain_ms": times["plain_ms_median"],
        "bound_ms": times["bound_ms"],
        "bound_by": times["bound_by"],
        "library_ms": None,
    }


def run_size(rng, size: Size, card: str, scan_ops: dict):
    """Kernel checks and times for each wave, scan and sharded
    configuration of the size, then its main path and its mesh main
    path. Returns ({wave kernel name: (kernel, times, main) lines},
    {scan kernel name: (max err, times line)}, {sharded kernel name:
    (max err, times line)}, {(sharded kernel name, size): mesh main path
    line}, and its main path's reference (the image, calls, CPU answers
    and snapshot: for the GLOBAL phases on the flat size, the store
    phases, and the metrics and latency phases at the end)."""
    image = live_image(rng, size)
    pm = scrambled_page_map(rng, size) if size.page_groups else None
    checked, scans, meshes = {}, {}, {}
    for layout, paged in size.configs:
        pmap = pm if paged else None
        kt, pt, err = phase_kernel(rng, image, size, layout, pmap)
        times = phase_times(rng, image, size, layout, pmap, kt, pt, card)
        phase_wavescan_oracles(rng, image, size, layout, pmap, kt)
        checked[cuda_decide.config_name(layout, paged)] = (err, times)
        del kt, pt
        free_device()
        tables, serr = phase_scan_kernel(rng, image, size, layout, pmap)
        stimes = phase_scan_times(rng, size, layout, pmap, tables, card, scan_ops)
        scans[cuda_decide.config_name(layout, paged, scan=True)] = (serr, stimes)
        team_vs_scan(size, layout, paged, times, stimes, card)
        del tables
        free_device()
        kt, pt, merr = phase_mesh_kernel(rng, image, size, layout, pmap)
        mtimes = phase_times(rng, image, size, layout, pmap, kt, pt, card, MESH_SHARDS)
        meshes[cuda_decide.sharded_name(layout)] = (merr, mtimes)
        del kt, pt
        free_device()
    main, reference = phase_main_path(rng, image, size, card)
    if size.page_groups:
        for layout, _paged in size.configs:
            phase_page_moves(rng, image, size, layout, card)
    del image
    mesh_main = phase_mesh_main_path(size, reference, card)
    phase_edge_main_path(size, reference)
    phase_pipeline(size, reference)
    if size.page_groups:
        phase_demoter(size, reference, card)
    return ({k: (err, times, main[k]) for k, (err, times) in checked.items()}, scans,
            meshes, mesh_main, reference)


def team_vs_scan(size, layout, paged, times, stimes, card) -> None:
    """The two team kernels of the same run at B = 4096 on the card: the
    wave kernel's profiler time per launch (the B sweep's fresh waves,
    and the scan's own 32 steps as 32 wave launches) beside the scan
    kernel's profiler time per step (the same team body in the
    persistent grid, its inputs staged before each step's barrier, no
    launch per step)."""
    wave = next(r for r in times["b_sweep"] if r["batch"] == SCAN_B)["profiler_ms"]
    step = stimes["step_device_ms_profiler"]
    on_steps = stimes["wave_device_ms_profiler"]
    emit({"phase": "team_vs_scan", "size": size.name, "batch": SCAN_B,
          "wave_kernel": cuda_decide.config_name(layout, paged),
          "scan_kernel": cuda_decide.config_name(layout, paged, scan=True),
          "wave_device_ms_profiler": wave, "wave_on_scan_steps_device_ms_profiler": on_steps,
          "scan_step_device_ms_profiler": step,
          "wave_over_scan_step": wave / step if wave and step else None,
          "wave_on_steps_over_scan_step": on_steps / step if on_steps and step else None,
          "card": card})


def kernel_entry(name, layout, paged, err, times, main):
    return {
        "name": name,
        "route": "cuda",
        "source": "gubernator_tpu_torch/csrc/decide_wave.cu",
        "replaces": "gubernator_tpu/ops/pallas_decide.py:483 "
                    f"(_make_kernel, layout={layout}, paged={paged})",
        "launches": main["launches"],
        "max_abs_err": err,
        "ms": times["kernel_ms_median"],
        "plain_ms": times["plain_ms_median"],
        "bound_ms": times["bound_ms"],
        "bound_by": times["bound_by"],
        "library_ms": None,
    }


def scan_entry(name, layout, paged, err, times, launches):
    where = "915 (decide_scan_paged" if paged else "878 (decide_scan_flat"
    return {
        "name": name,
        "route": "cuda",
        "source": "gubernator_tpu_torch/csrc/decide_scan.cu",
        "replaces": f"gubernator_tpu/ops/pallas_decide.py:{where}, layout={layout})",
        "launches": launches,
        "max_abs_err": err,
        "ms": times["scan_ms_median"],
        "plain_ms": times["plain_ms_median"],
        "bound_ms": times["bound_ms"],
        "bound_by": times["bound_by"],
        "library_ms": None,
    }


def mesh_entry(name, layout, errs, times, launches):
    """The sharded kernel's line: the largest difference over its checks
    at both sizes, the 1M flat times, and its launches on the mesh main
    paths (1M flat and 10M paged, each counted from 0)."""
    return {
        "name": name,
        "route": "cuda",
        "source": "gubernator_tpu_torch/csrc/decide_sharded.cu",
        "replaces": f"gubernator_tpu/ops/pallas_decide.py:927 (raw_decide_flat, layout={layout})",
        "launches": launches,
        "max_abs_err": max(errs),
        "ms": times["kernel_ms_median"],
        "plain_ms": times["plain_ms_median"],
        "bound_ms": times["bound_ms"],
        "bound_by": times["bound_by"],
        "library_ms": None,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--store-op-counts", action="store_true",
                    help="print the store ops' device operations per call (store_ops "
                         "runs this in a fresh process) and exit")
    ap.add_argument("--slo-op-counts", action="store_true",
                    help="print the device operations of the SLO sampler's passes over a "
                         "warmed 1M engine (the overload phase runs this in a fresh "
                         "process) and exit")
    ap.add_argument("--scan-op-counts", action="store_true",
                    help="print the device operations of every scan configuration's "
                         "scans (scan_times checks them; main runs this in a fresh "
                         "process) and exit")
    ap.add_argument("--layout-op-counts", action="store_true",
                    help="print the device operations per call of the wide and packed "
                         "layouts' ops (as --store-op-counts does with the store ops) "
                         "and exit")
    ap.add_argument("--only-layouts", action="store_true",
                    help="build, then run the layouts phase alone on a fresh image and "
                         "calls of each size (a short check; prints no kernels line)")
    args = ap.parse_args()
    if args.store_op_counts:
        print(json.dumps(store_op_counts()))
        return 0
    if args.layout_op_counts:
        print(json.dumps(layout_op_counts({})))
        return 0
    if args.scan_op_counts:
        print(json.dumps(scan_op_names(args.seed)))
        return 0
    if args.slo_op_counts:
        print(json.dumps(slo_op_names(args.seed)))
        return 0
    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "count": torch.cuda.device_count()})

    phase_build()
    if args.only_layouts:
        refs = []
        for size in SIZES:
            image = live_image(rng, size)
            snap = {f: getattr(image, f) for f in SlotTable._fields}
            snap["key_strings"] = {}
            refs.append((size, (snap, smoke_calls(rng, size.live_keys, size.calls))))
        phase_layouts(rng, refs, smi, _op_counts_child("--layout-op-counts"))
        emit({"phase": "summary", "wall_s": time.perf_counter() - t0, "nvidia_smi": smi})
        return 0
    scan_ops = scan_op_names_child(args.seed)
    entries, scans = [], []
    mesh_errs, mesh_times, mesh_launches, size_refs = {}, {}, {}, []
    for size in SIZES:
        done, scanned, meshed, mesh_main, reference = run_size(rng, size, smi, scan_ops)
        size_refs.append((size, reference))
        if not size.page_groups:
            flat, flat_reference = size, reference
        for layout, paged in size.configs:
            k = cuda_decide.config_name(layout, paged)
            entries.append(kernel_entry(k, layout, paged, *done[k]))
            k = cuda_decide.config_name(layout, paged, scan=True)
            scans.append(scan_entry(k, layout, paged, *scanned[k], None))
            k = cuda_decide.sharded_name(layout)
            mesh_errs.setdefault(k, []).append(meshed[k][0])
            mesh_times.setdefault(k, meshed[k][1])  # the first size's: 1M flat
            mesh_launches[k] = mesh_launches.get(k, 0) + mesh_main[(k, size.name)]["launches"]
    # the bench is the scans' main path: their launches are its counts
    launches = phase_bench(smi)
    for e in scans:
        e["launches"] = launches[e["name"]]
    # the GLOBAL replica tier last, on the flat size's calls: its
    # profiler sessions come after every exact count of the phases above
    replicas, replica_launches = run_global(rng, flat, flat_reference, smi)
    # the store path's thousands of small operations come after every
    # exact profiler count too (CUPTI lost scan records after them)
    store_launches = {}
    for size, reference in size_refs:
        for k, v in phase_store_path(rng, size, reference[1], smi).items():
            store_launches[k] = store_launches.get(k, 0) + v
        if not size.page_groups:
            phase_loader(rng, size, reference[1], smi)
    op_counts = phase_store_ops(rng, smi)
    # the wide and packed layouts: hundreds of small torch ops, so after
    # every exact profiler count too (their op counts come from the store
    # ops' fresh process)
    phase_layouts(rng, size_refs, smi, op_counts)
    # the observability core over the serving paths, and the p99 latency:
    # no profiler, after every exact count
    for size, reference in size_refs:
        phase_metrics(size, reference, smi)
    phase_telemetry_ab(flat, flat_reference, smi)
    phase_latency(rng, flat, flat_reference, smi)
    # the overload plane and the SLO observatory, last: no profiler in
    # this process (its sampler trace runs in a fresh one)
    phase_overload(flat, flat_reference, smi, args.seed)
    del size_refs, flat_reference
    entries += scans
    entries += [mesh_entry(cuda_decide.sharded_name(lay), lay, mesh_errs[cuda_decide.sharded_name(lay)],
                           mesh_times[cuda_decide.sharded_name(lay)],
                           mesh_launches[cuda_decide.sharded_name(lay)])
                for lay in ("fused", "narrow")]
    entries += [replica_entry(cuda_decide.replica_name(lay), lay,
                              *replicas[cuda_decide.replica_name(lay)], replica_launches[lay])
                for lay in ("fused", "narrow")]
    # the store path's launches (phase 19) beside rows 1-3b and 5, each
    # counted from 0 around its own runs
    for e in entries:
        if e["name"] in store_launches:
            e["store_path_launches"] = store_launches[e["name"]]
    emit({"phase": "summary", "wall_s": time.perf_counter() - t0,
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
          "nvidia_smi": smi})

    kernels = {"kernels": entries}
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        f.write("\n".join(_lines + [json.dumps(kernels)]) + "\n")
    print(smi)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
