"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Builds the port's native code from the checkout (the CUDA decide-wave
kernel with nvcc for sm_90a and the key hasher with g++, both compilers
started at once), then runs four phases and prints one JSON line each:

1. build: what was compiled, with ptxas' register/spill report;
2. kernel: the CUDA kernel against its plain PyTorch version, on the
   card, over a 2^18-group x 8-way table (168 MB) holding 1,000,000 live
   keys: 16 waves of 1024 lanes, bit-exact on every output field, the 9
   scalars and the whole table (tolerance: none, all int64);
3. main_path: `V1Service.get_rate_limits` over a CUDA `DeviceEngine`
   holding that table, 8 calls of 1,000 items, against the same calls
   on a CPU engine (the plain version): every response and the final
   snapshot equal, and kernel launches equal to waves and > 0;
4. times, over fresh waves at B = 1024: the kernel's median device time
   per launch (CUDA events, L2 flushed before each), the median of the
   whole launch path, the median of 5 runs of 200 back-to-back
   launches, the kernel's device time from torch.profiler, the plain
   version's median, the byte bound, and end-to-end decisions/s through
   V1Service.

Then the card's name and power limit as nvidia-smi prints them, the
kernel table line, and the last line
`{"ok": true, "device": {"platform": "gpu", ...}}`. Any failure raises
and the script exits non-zero. It needs one card; without one it exits
with code 2 before printing anything to stdout. The phase lines are also
written to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is False; needs one GPU",
          file=sys.stderr)
    sys.exit(2)

from gubernator_tpu_torch.api.types import RateLimitReq  # noqa: E402
from gubernator_tpu_torch.ops import _build, cuda_decide, fused  # noqa: E402
from gubernator_tpu_torch.ops.layout import (  # noqa: E402
    BATCH_DTYPES,
    RequestBatch,
    SlotTable,
    batch_to_device,
)
from gubernator_tpu_torch.runtime.engine import DeviceEngine, EngineConfig  # noqa: E402
from gubernator_tpu_torch.service.server import V1Service  # noqa: E402
from gubernator_tpu_torch.utils import clock as _clock  # noqa: E402

NUM_GROUPS = 1 << 18
WAYS = 8
LIVE_KEYS = 1_000_000
B = 1024
WAVES = 16
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
OUT_DIR = "chiprun_out"
DEVICE = torch.device("cuda", 0)
_lines = []


def emit(obj) -> None:
    line = json.dumps(obj, sort_keys=True)
    _lines.append(line)
    print(line, flush=True)


def sync() -> None:
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# seeded data


def live_image(rng) -> SlotTable:
    """Wide numpy image of the table with LIVE_KEYS keys, each in a free
    way of its group: mixed token/leaky, expiries on both sides of NOW,
    a few store invalidation marks."""
    n = NUM_GROUPS * WAYS
    cand = LIVE_KEYS + LIVE_KEYS // 8
    hi = rng.integers(1, 1 << 62, cand, dtype=np.int64)
    lo = rng.integers(0, 1 << 62, cand, dtype=np.int64)
    grp = lo % NUM_GROUPS
    order = np.argsort(grp, kind="stable")
    g_sorted = grp[order]
    first = np.searchsorted(g_sorted, g_sorted, side="left")
    rank = np.empty(cand, np.int64)
    rank[order] = np.arange(cand) - first
    keep = np.nonzero(rank < WAYS)[0][:LIVE_KEYS]
    if keep.size != LIVE_KEYS:
        raise RuntimeError(f"placed only {keep.size} keys")
    slot = grp[keep] * WAYS + rank[keep]
    k = LIVE_KEYS

    col = {f: np.zeros(n, dt) for f, dt in (
        ("key_hi", np.int64), ("key_lo", np.int64), ("used", np.bool_),
        ("algo", np.int8), ("status", np.int8), ("limit", np.int64),
        ("duration", np.int64), ("remaining", np.int64), ("stamp", np.int64),
        ("expire_at", np.int64), ("invalid_at", np.int64), ("burst", np.int64),
        ("lru", np.int64),
    )}
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


def smoke_wave(rng, image: SlotTable, now: int) -> RequestBatch:
    """One full wave: 1024 distinct groups, ~60% lanes on a live key of
    the image, the rest new keys; token/leaky, RESET_REMAINING and
    DRAIN_OVER_LIMIT, negative and zero limits, a few Gregorian lanes
    and inactive (padding) lanes."""
    b = RequestBatch.zeros(B)
    groups = rng.choice(NUM_GROUPS, B, replace=False).astype(np.int64)
    way = rng.integers(0, WAYS, B)
    slot = groups * WAYS + way
    reuse = (rng.random(B) < 0.6) & image.used[slot]
    new_lo = groups + NUM_GROUPS * rng.integers(1, 1 << 40, B)
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


def wave_bytes(b: RequestBatch) -> int:
    """Bytes one wave must move: every batch column read once, every
    output written once, and per active lane its group's 5 probe columns
    over the W ways, the chosen row's other 5 columns, and the new row."""
    lanes = len(b.active)
    active = int(np.count_nonzero(b.active))
    batch_in = lanes * sum(np.dtype(dt).itemsize for dt in BATCH_DTYPES.values())
    outs = lanes * (1 + 6 * 8 + 1) + 9 * 8
    table = active * (WAYS * 5 * 8 + 5 * 8 + fused.NCOLS * 8)
    return batch_in + outs + table


def bound_ms(b: RequestBatch):
    t_bytes = wave_bytes(b) / HBM_BYTES_PER_S * 1e3
    t_ops = int(np.count_nonzero(b.active)) * OPS_PER_LANE / SCALAR_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phases


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.build(["decide_wave", "guberhash"], force=True)
    ptxas = [
        ln.strip() for ln in _build.log_path("decide_wave").read_text().splitlines()
        if "registers" in ln or "spill" in ln
    ]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libs": ["decide_wave", "guberhash"], "ptxas": ptxas})


def _max_abs_err(ko, po, ks, ps) -> float:
    """Largest |kernel - plain| over every output field and scalar;
    raises unless they are bit-equal."""
    err = 0.0
    for f in ko._fields:
        a, r = getattr(ko, f), getattr(po, f)
        if a.dtype != r.dtype or a.shape != r.shape:
            raise AssertionError(f"output {f}: {a.dtype}{tuple(a.shape)} vs {r.dtype}{tuple(r.shape)}")
        d = float((a.double() - r.double()).abs().max()) if a.numel() else 0.0
        if not torch.equal(a, r):
            raise AssertionError(f"output {f} differs from the plain version (max abs {d})")
        err = max(err, d)
    for f in ks._fields:
        if not torch.equal(getattr(ks, f), getattr(ps, f)):
            raise AssertionError(f"WaveScan.{f}: kernel {int(getattr(ks, f))} plain {int(getattr(ps, f))}")
    return err


def phase_kernel(rng, image: SlotTable):
    dev = DEVICE
    kt = fused.pack_table(image, device=dev)
    pt = fused.FusedTable(kt.data.clone())
    sync()
    before = cuda_decide.LAUNCHES
    now = NOW
    err = 0.0
    for w in range(WAVES):
        now += int(rng.choice([0, 1, 250, 2000]))
        hb = smoke_wave(rng, image, now)
        db = batch_to_device(hb, dev)
        kt, ko, ks = cuda_decide.decide_flat_with_scan(kt, db, now, ways=WAYS)
        pt, po, ps = fused.decide_fused_plain(pt, db, now, ways=WAYS)
        sync()
        err = max(err, _max_abs_err(ko, po, ks, ps))
        if not torch.equal(kt.data, pt.data):
            rows = int((kt.data != pt.data).any(dim=1).sum())
            raise AssertionError(f"wave {w}: table differs from the plain version in {rows} rows")
    live = int(((kt.data[:, fused.META] & 1) != 0).sum())
    emit({"phase": "kernel", "ok": True, "waves": WAVES, "batch": B,
          "table_rows": kt.num_slots, "table_mb": kt.data.numel() * 8 / 1e6,
          "live_keys_before": LIVE_KEYS, "live_keys_after": live,
          "launches": cuda_decide.LAUNCHES - before, "max_abs_err": err,
          "tolerance": "bit-exact (int64)"})
    return kt, pt, err


def zipf_keys(rng, n: int, n_keys: int, s: float = 1.1) -> np.ndarray:
    """n key ranks in 1..n_keys with P(k) proportional to k^-s (a Zipf
    law bounded to the keyspace; clipping an unbounded draw would pile
    the tail onto one key)."""
    w = np.arange(1, n_keys + 1, dtype=np.float64) ** -s
    return rng.choice(n_keys, n, p=w / w.sum()) + 1


def smoke_calls(rng, n_calls=8, n_items=1000):
    """8 calls of 1,000 items: Zipf(1.1) keys over 1M, 70% token / 30%
    leaky, hits 1-5, limits 10-1000, durations 1-60 s, 5% RESET_REMAINING,
    5% DRAIN_OVER_LIMIT, a few DURATION_IS_GREGORIAN items; the Zipf head
    repeats keys inside a call, so flushes take several waves."""
    calls = []
    for _ in range(n_calls):
        ks = zipf_keys(rng, n_items, LIVE_KEYS)
        u = rng.random(n_items)
        items = []
        for i in range(n_items):
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
        calls.append(items)
    return calls


def phase_main_path(rng, image: SlotTable):
    with _clock.freeze(NOW) as clk:
        return _main_path(rng, image, clk)


def _main_path(rng, image: SlotTable, clk):
    """Both engines read the frozen clock (their default now_fn)."""
    snap = {f: getattr(image, f) for f in SlotTable._fields}
    snap["key_strings"] = {}
    cfg = dict(num_groups=NUM_GROUPS, ways=WAYS, batch_size=B)
    geng = DeviceEngine(EngineConfig(device=DEVICE.type, **cfg))
    ceng = DeviceEngine(EngineConfig(device="cpu", **cfg))
    try:
        geng.restore(snap)
        ceng.restore(snap)
        gsvc, csvc = V1Service(geng), V1Service(ceng)
        calls = smoke_calls(rng)
        sync()
        cuda_decide.LAUNCHES = 0
        t_gpu = 0.0
        gpu_resps = []
        for items in calls:
            t0 = time.perf_counter()
            gpu_resps.append(asyncio.run(gsvc.get_rate_limits(
                [RateLimitReq(**kw) for kw in items])))
            t_gpu += time.perf_counter() - t0
            clk.advance(700)
        launches = cuda_decide.LAUNCHES
        gst = geng.stats()
        clk.advance(-700 * len(calls))
        mismatches = 0
        errors = 0
        for c, items in enumerate(calls):
            cr = asyncio.run(csvc.get_rate_limits([RateLimitReq(**kw) for kw in items]))
            clk.advance(700)
            for a, b in zip(gpu_resps[c], cr):
                ta = (a.status, a.limit, a.remaining, a.reset_time, a.error)
                tb = (b.status, b.limit, b.remaining, b.reset_time, b.error)
                mismatches += ta != tb
                errors += bool(a.error)
        gs, cs = geng.snapshot(), ceng.snapshot()
        snap_diff = [f for f in SlotTable._fields if not np.array_equal(gs[f], cs[f])]
        if gs["key_strings"] != cs["key_strings"]:
            snap_diff.append("key_strings")
        decisions = sum(len(c) for c in calls)
        res = {"phase": "main_path", "calls": len(calls), "items": decisions,
               "flushes": gst["flushes"], "waves": gst["waves"],
               "engine_kernel_launches": gst["kernel_launches"],
               "launches": launches, "response_mismatches": mismatches,
               "error_responses": errors, "snapshot_columns_differing": snap_diff,
               "over_limit": gst["over_limit"], "cache_hits": gst["cache_hits"],
               "cache_misses": gst["cache_misses"],
               "unexpired_evictions": gst["unexpired_evictions"],
               "decisions_per_s": decisions / t_gpu, "seconds": t_gpu}
        emit(res)
        if mismatches or snap_diff or errors:
            raise AssertionError("main path disagrees with the CPU engine")
        if not (launches == gst["kernel_launches"] == gst["waves"] > 0):
            raise AssertionError("kernel launches do not match the waves")
        return res
    finally:
        geng.close()
        ceng.close()


def _median_ms(fn, reps, flush, hold_cycles=0):
    """Median of `reps` launches timed one by one with CUDA events, L2
    flushed before each. With `hold_cycles` the stream first spins that
    long on the device, so the host has enqueued start event, launch and
    end event before the device reaches them: the window then holds only
    device work. Without it the device idles while the host works, and
    the window also holds the host's launch path."""
    times = []
    for _ in range(reps):
        flush.zero_()
        if hold_cycles:
            torch.cuda._sleep(hold_cycles)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def _profiled_device_ms(fn, reps):
    """Device time per launch of the decide kernel from torch.profiler
    (CUPTI), or None when the trace holds no device time for it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        sync()
    total_us, count = 0.0, 0
    for e in prof.key_averages():
        if "decide_wave_kernel" in e.key:
            t = getattr(e, "device_time_total", None)
            total_us += t if t is not None else getattr(e, "cuda_time_total", 0.0)
            count += e.count
    return total_us / count / 1e3 if count and total_us > 0 else None


def phase_times(rng, image, kt, pt, main):
    """Times at the main path's shape (B = 1024), each over fresh waves
    of distinct groups so the group blocks come from HBM, not L2."""
    dev = DEVICE
    reps = 200
    now = NOW + 60_000
    dbs = [(batch_to_device(smoke_wave(rng, image, now), dev), now) for _ in range(reps)]
    sync()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)  # > 50 MB L2
    state = {"i": 0}

    def kernel():
        db, t = dbs[state["i"] % reps]
        state["i"] += 1
        cuda_decide.decide_flat_with_scan(kt, db, t, ways=WAYS)

    def plain():
        db, t = dbs[state["i"] % reps]
        state["i"] += 1
        fused.decide_fused_plain(pt, db, t, ways=WAYS)

    for _ in range(10):
        kernel()
    sync()
    # (a) the kernel on the card: median of 200 launches timed one by
    # one, L2 flushed before each, the device held busy (~1 ms) while
    # the host enqueues, so the window holds the scalar memset and the
    # kernel only
    k_ms = _median_ms(kernel, reps, flush, hold_cycles=2_000_000)
    # (a') the same without the hold: the launch path a lone wave pays
    # (wrapper checks and allocations, ctypes call, memset, kernel)
    path_ms = _median_ms(kernel, reps, flush)
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
    run_ms = statistics.median(runs)
    # (c) the kernel's own device time, from the profiler's trace
    dev_ms = _profiled_device_ms(kernel, reps)
    plain()
    sync()
    p_ms = _median_ms(plain, 20, flush)
    b_ms, b_by = bound_ms(smoke_wave(rng, image, now))
    res = {"phase": "times", "kernel_ms_median": k_ms,
           "launch_path_ms_median": path_ms, "kernel_ms_run": run_ms,
           "kernel_ms_runs": runs,
           "kernel_device_ms_profiler": dev_ms, "plain_ms_median": p_ms,
           "bound_ms": b_ms, "bound_by": b_by, "batch": B,
           "reps_kernel": reps, "reps_plain": 20,
           "decisions_per_s_v1service": main["decisions_per_s"]}
    emit(res)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
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
    image = live_image(rng)
    kt, pt, err = phase_kernel(rng, image)
    main_res = phase_main_path(rng, image)
    times = phase_times(rng, image, kt, pt, main_res)

    kernels = {"kernels": [{
        "name": "decide_wave",
        "route": "cuda",
        "source": "gubernator_tpu_torch/csrc/decide_wave.cu",
        "replaces": "gubernator_tpu/ops/pallas_decide.py:483",
        "launches": main_res["launches"],
        "max_abs_err": err,
        "ms": times["kernel_ms_median"],
        "plain_ms": times["plain_ms_median"],
        "bound_ms": times["bound_ms"],
        "bound_by": times["bound_by"],
        "library_ms": None,
    }]}
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
