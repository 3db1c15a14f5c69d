"""Device-throughput benchmark of the port: rate-limit decisions/s on one
card at 1M and 10M keys, and the device's decide step time.

    python -m gubernator_tpu_torch.bench --mode kernel|kernel10m|latency \\
        [--layout fused|narrow] [--device cuda]

The port of the repo's `bench.py` device modes, at its constants:

- `kernel`: `BASELINE.json` config 3, Zipf(1.1) over 1M keys on a table
  of 2^18 groups x 8 ways (2,097,152 slots). Pre-encoded batches of
  B = 4096 lanes, group-deduplicated per batch as the assembler
  guarantees, 25% leaky; a chunk of 32 batches runs as ONE
  `decide_scan` (one launch of the scan kernel), 2 warm chunks, then 8
  timed chunks on the host clock ending in a synchronise. Then 50
  single-wave round trips (H2D of the batch, decide, synchronise) for
  the dispatch RTT.
- `kernel10m`: config 5, 10M keys on 2^21 groups x 8 ways (16,777,216
  slots), RESET_REMAINING on 1 key in 16 and DRAIN_OVER_LIMIT on 1 in 8,
  4 timed chunks.
- `latency`: the device step time by the scan-delta method: at widths
  128, 1024 and 4096 a scan of S1 = 16 and of S2 = 80 steps, min of 5
  each, (t(S2) - t(S1)) / (S2 - S1), so the per-call host cost cancels.

`run_kernel_bench(..., page_groups=G)` (a keyword only, no flag) runs
the same traffic on a paged table (`ops/paged.py`) of G groups per page
through the paged registry's `decide_scan`, every logical page bound to
the frame of its own index: a drive of the paged scan kernel at full
size, whose decisions and table are those of the flat run. It is not a
deployment (no page is ever out of the device).

Prints ONE JSON line, `{"metric", "value", "unit", "vs_baseline"}`, as
the repo's `bench.py` does; the metric names the card
(`torch.cuda.get_device_name`). vs_baseline is value / 4000 for the
throughput modes (the reference's ~2,000 req/s x 2 checks per node)
and 2000 us / step time for `latency`. The device defaults to `cuda`;
without a card the run fails. `--device cpu` runs the plain PyTorch
versions (tests, small sizes only).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from gubernator_tpu_torch.api.types import Behavior
from gubernator_tpu_torch.ops.kernels import get_kernels, get_paged_kernels
from gubernator_tpu_torch.ops.layout import RequestBatch, batch_to_device, stack_batches

MODES = ("kernel", "kernel10m", "latency")
NOW = 1_753_700_000_000
WAYS = 8
_U64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def _mix(x, c):
    x = (x * np.uint64(c)) & _U64
    x ^= x >> np.uint64(29)
    x = (x * np.uint64(0xBF58476D1CE4E5B9)) & _U64
    x ^= x >> np.uint64(32)
    return x


def _make_zipf_batch(rng, B: int, n_keys: int, num_groups: int, now: int,
                     mode: str = "kernel") -> RequestBatch:
    """One pre-encoded host batch: Zipf(1.1) keys, 128-bit identities by
    splitmix-style mixing, group-deduplicated (one request per group per
    batch, the assembler's invariant), so fewer than B lanes are active.
    Draws exactly what the repo's `bench.py::_make_zipf_batch` draws."""
    b = RequestBatch.zeros(B)
    keys = rng.zipf(1.1, size=B * 2) % n_keys  # oversample for dedup
    h_lo = _mix(keys.astype(np.uint64), 0x9E3779B97F4A7C15)
    grp = (h_lo % np.uint64(num_groups)).astype(np.int64)
    _, first = np.unique(grp, return_index=True)
    first = np.sort(first)[:B]
    keys = keys[first]
    h_lo = h_lo[first]
    grp = grp[first]
    n = len(keys)
    b.key_lo[:n] = h_lo.astype(np.int64, casting="unsafe") | 1
    b.key_hi[:n] = _mix(keys.astype(np.uint64), 0xD6E8FEB86659FD93).astype(
        np.int64, casting="unsafe"
    )
    b.group[:n] = grp[:n].astype(np.int32)
    b.algo[:n] = (keys[:n] % 4 == 0).astype(np.int8)  # 25% leaky
    if mode == "kernel10m":
        # config (5) behavior mix: RESET_REMAINING + DRAIN_OVER_LIMIT
        b.behavior[:n] = np.where(
            keys[:n] % 16 == 1, np.int32(int(Behavior.RESET_REMAINING)), 0
        ) | np.where(
            keys[:n] % 8 == 2, np.int32(int(Behavior.DRAIN_OVER_LIMIT)), 0
        )
    b.hits[:n] = 1
    b.limit[:n] = 10_000
    b.duration[:n] = 60_000
    b.rate_num[:n] = 60_000
    b.eff_duration[:n] = 60_000
    b.burst[:n] = 10_000
    b.created_at[:n] = now
    b.active[:n] = True
    return b


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench: no CUDA device (pass --device cpu for the plain version)")
    return dev


def _platform(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _table(layout, num_groups, dev, page_groups):
    """(kernels, table): flat, or paged with G = `page_groups` groups
    per page and logical page p bound to frame p, every page resident."""
    if not page_groups:
        K = get_kernels(layout)
        return K, K.create(num_groups, WAYS, dev)
    pages = -(-num_groups // page_groups)
    PK = get_paged_kernels(layout, num_groups, WAYS, page_groups, pages, dev)
    pt = PK.create()
    for p in range(pages):
        pt = PK.bind_page(pt, p, p)
    return PK, pt


class KernelRun(NamedTuple):
    """A `kernel`/`kernel10m` run: the JSON line, the table it leaves,
    and what the line is computed from."""

    result: dict
    table: object
    evictions: int  # unexpired evictions in the timed chunks
    decisions: int  # active lanes of the timed chunks
    seconds: float  # the timed chunks, host clock
    scans: int  # decide_scan calls, warm and timed


def run_kernel_bench(
    mode: str = "kernel", layout: str = "fused", *, device="cuda",
    num_groups: Optional[int] = None, n_keys: Optional[int] = None,
    batch: int = 4096, steps: int = 32, warm_chunks: int = 2,
    chunks: Optional[int] = None, rtt_calls: int = 50,
    page_groups: int = 0, seed: int = 7, log=print,
) -> KernelRun:
    """Device decide throughput (`kernel`, `kernel10m`); sizes default to
    the repo bench's constants. `page_groups` > 0: on a paged table with
    every page resident (see the module's note)."""
    if mode not in ("kernel", "kernel10m"):
        raise ValueError(f"run_kernel_bench runs kernel or kernel10m, not {mode!r}")
    dev = _device(device)
    big = mode == "kernel10m"
    num_groups = num_groups or (1 << 21 if big else 1 << 18)
    n_keys = n_keys or (10_000_000 if big else 1_000_000)
    chunks = chunks or (4 if big else 8)
    rng = np.random.default_rng(seed)
    K, table = _table(layout, num_groups, dev, page_groups)
    K.load(dev)

    host = [_make_zipf_batch(rng, batch, n_keys, num_groups, NOW, mode) for _ in range(steps)]
    stacked = batch_to_device(stack_batches(host), dev)
    active_per_chunk = int(sum(int(b.active.sum()) for b in host))
    nows = torch.arange(NOW, NOW + steps, dtype=torch.int64).to(dev)
    single = batch_to_device(host[0], dev)

    t0 = time.perf_counter()
    table, _ = K.decide(table, single, NOW - 10, WAYS)
    for _ in range(warm_chunks):
        table, out = K.decide_scan(table, stacked, nows, WAYS)
    _sync(dev)
    log(f"[bench] decide + {warm_chunks} warm scans in {time.perf_counter() - t0:.3f}s ({layout})")

    # Throughput: chunks of scanned decide steps, the eviction counters
    # left on the device until the timed loop ends.
    t0 = time.perf_counter()
    evic = []
    for _ in range(chunks):
        table, out = K.decide_scan(table, stacked, nows, WAYS)
        evic.append(out.unexpired_evictions)
    _sync(dev)
    dt = time.perf_counter() - t0
    decisions = chunks * active_per_chunk
    throughput = decisions / dt
    evictions = int(sum(int(e.sum()) for e in evic))
    evict_rate = evictions / max(decisions, 1)
    log(f"[bench] THROUGHPUT {throughput:.0f} decisions/s (evict_rate={evict_rate:.2e})")

    # Dispatch round trip of one wave: H2D of the batch, decide, sync.
    lat = []
    for i in range(rtt_calls):
        t1 = time.perf_counter()
        table, _ = K.decide(table, batch_to_device(host[0], dev), NOW + 1000 + i, WAYS)
        _sync(dev)
        lat.append(time.perf_counter() - t1)
    lat_ms = np.array(lat) * 1000
    p50 = float(np.percentile(lat_ms, 50)) if rtt_calls else float("nan")
    p99 = float(np.percentile(lat_ms, 99)) if rtt_calls else float("nan")
    log(f"[bench] DISPATCH RTT p50={p50:.3f}ms p99={p99:.3f}ms")

    paged = (f", paged: {-(-num_groups // page_groups)} pages of {page_groups} groups, "
             "all resident" if page_groups else "")
    result = {
        "metric": (
            f"rate-limit decisions/sec/chip @{n_keys / 1e6:g}M keys zipf "
            f"({mode}, {_platform(dev)}, {layout} layout{paged}); "
            f"batch={batch}, scan={steps} steps/launch, "
            f"dispatch_rtt_p50={p50:.3f}ms dispatch_rtt_p99={p99:.3f}ms "
            f"(one wave: H2D, decide, synchronise), "
            f"unexpired_evictions/decision={evict_rate:.2e}"
        ),
        "value": round(throughput, 0),
        "unit": "decisions/s",
        "vs_baseline": round(throughput / 4000.0, 1),
    }
    return KernelRun(result, table, evictions, decisions, dt, warm_chunks + chunks)


def bench_kernel(mode: str = "kernel", layout: str = "fused", **kw) -> dict:
    """The JSON line of `run_kernel_bench`."""
    return run_kernel_bench(mode, layout, **kw).result


def bench_latency(
    layout: str = "fused", *, device="cuda", num_groups: int = 1 << 18,
    n_keys: int = 1_000_000, widths=(128, 1024, 4096), s1: int = 16,
    s2: int = 80, reps: int = 5, seed: int = 11, log=print,
) -> dict:
    """Device decide step time by the scan-delta method: for each width
    B a scan of s1 and one of s2 steps (8 batches cycled), min of `reps`
    host-clock runs each ending in a synchronise; the per-call cost
    cancels in (t(s2) - t(s1)) / (s2 - s1)."""
    dev = _device(device)
    K = get_kernels(layout)
    K.load(dev)
    rng = np.random.default_rng(seed)
    table = K.create(num_groups, WAYS, dev)
    step_us = {}
    for B in widths:
        batches = [_make_zipf_batch(rng, B, n_keys, num_groups, NOW) for _ in range(8)]

        def stack(n):
            return batch_to_device(stack_batches([batches[i % 8] for i in range(n)]), dev)

        st1, st2 = stack(s1), stack(s2)
        nows1 = torch.arange(NOW, NOW + s1, dtype=torch.int64).to(dev)
        nows2 = torch.arange(NOW, NOW + s2, dtype=torch.int64).to(dev)
        table, _ = K.decide_scan(table, st1, nows1, WAYS)
        table, _ = K.decide_scan(table, st2, nows2, WAYS)
        _sync(dev)
        t_1, t_2 = [], []
        for _ in range(reps):
            for st, nw, acc in ((st1, nows1, t_1), (st2, nows2, t_2)):
                t0 = time.perf_counter()
                table, _ = K.decide_scan(table, st, nw, WAYS)
                _sync(dev)
                acc.append(time.perf_counter() - t0)
        us = (min(t_2) - min(t_1)) / (s2 - s1) * 1e6
        step_us[B] = us
        log(f"[bench] device decide step B={B}: {us:.2f}us ({us / B * 1000:.2f}ns/decision)")

    detail = ", ".join(f"B={b}: {u:.2f}us" for b, u in step_us.items())
    v = step_us[widths[-1]]
    return {
        "metric": (
            f"device decide step time ({_platform(dev)}, {layout} layout, "
            f"scan-delta method, per-call cost cancelled): {detail}; vs <2ms "
            f"p99 budget at B={widths[-1]}"
        ),
        "value": round(v, 2),
        "unit": "us/step",
        "vs_baseline": round(2000.0 / max(v, 1e-9), 1),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", default="kernel", choices=MODES)
    ap.add_argument("--layout", default="fused", choices=("fused", "narrow"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.mode == "latency":
        result = bench_latency(args.layout, device=args.device)
    else:
        result = bench_kernel(args.mode, args.layout, device=args.device)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
