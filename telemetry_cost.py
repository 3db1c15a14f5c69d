"""What the serving path's telemetry costs: this tree, with parts of it
switched off, beside a parent tree, on the main path's calls.

    python3 telemetry_cost.py --parent _checkout/parent [--rounds 2] [--calls 16]
        [--no-gc] [--switch-interval S] [--out chiprun_out/telemetry_cost.jsonl]

Unpack the parent commit into a directory that .gitignore lists first
(`git archive <commit> | tar -x -C _checkout/parent`). Each turn is a
fresh process on one tree; with --rounds 2 the order is parent, this
tree, this tree, parent, and this tree's variants run forward in its
first turn and backward in its second. Each variant serves the same
seeded calls (BASELINE.json config 3: 1,000 Zipf(1.1) items a call over
1M live keys, 70% token / 30% leaky, 5% RESET_REMAINING, 5%
DRAIN_OVER_LIMIT, 1% Gregorian; the table of 2^18 groups x 8 ways
restored from a seeded image of 1M keys; a frozen clock) on a fresh
DeviceEngine (fused, flat, pipeline depth 2) through V1Service, on two
paths:

- `objects`: `get_rate_limits` per call, `max_waves` 32 (the chip
  smoke's `main_path`);
- `columnar`: `serve_get_rate_limits_bytes` per call, `max_waves` 1,000
  (its `edge_main_path`).

This tree's variants (the parent runs as built):

- `full`: as built.
- `no_sketch`: `hotkeys_k` 0 (the hot-key sketch off).
- `no_recorder`: the service's DecisionRecorder replaced by one that
  records nothing (the per-item `record_decision`, its key hash and
  ring entry; the columnar `record_columnar`).
- `no_flush`: the per-flush telemetry off: the stage, flush, queue-wait,
  in-flight and overlap observes, the flight recorder's record and the
  service's call counters (the engine's EngineMetrics counters stay:
  `stats()` reads them).
- `all_off`: the three above together.

Two process settings test what else moves the host-bound path, on
every turn alike: --no-gc disables the garbage collector for the timed
calls (after a collection), --switch-interval sets the interpreter's
thread switch interval (sys.setswitchinterval; Python's default is 5
ms), which bounds how long a thread that wakes (the completion thread
on its event, the pump on its semaphore) waits for the interpreter
lock while another runs Python.

Every variant and the parent must give the same answers (the script
fails otherwise). Prints one JSON line per run (decisions/s, seconds,
garbage collections), the host cost of `key_hash128(req.hash_key())`
per item, and a summary: per path each variant's median decisions/s,
its ratio to the parent's, and each part's host microseconds per item
(1e6 / its variant's rate less 1e6 / the full rate). The last line is
the card's name and power limit as nvidia-smi prints them. The same
lines go to --out. Needs a card (or
--device cpu with small --groups / --keys / --calls to rehearse).
"""

from __future__ import annotations

import argparse
import asyncio
import gc
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

NOW = 1_753_700_000_000
WAYS = 8
B = 1024
ITEMS = 1000
VARIANTS = {
    "full": (),
    "no_sketch": ("sketch",),
    "no_recorder": ("recorder",),
    "no_flush": ("flush",),
    "all_off": ("sketch", "recorder", "flush"),
}
PATHS = {"objects": 32, "columnar": ITEMS}  # path: max_waves
_REQ_FIELDS = (("name", 1, 2), ("unique_key", 2, 2), ("hits", 3, 0), ("limit", 4, 0),
               ("duration", 5, 0), ("algorithm", 6, 0), ("behavior", 7, 0), ("burst", 8, 0))


# ---------------------------------------------------------------------------
# seeded data (numpy only: the same on every tree)

def live_image(rng, num_groups: int, keys: int, dtypes: dict) -> dict:
    """Snapshot dict of a table of `num_groups` x WAYS slots holding
    `keys` live rows, each in a free way of its group (mixed token and
    leaky, expiries on both sides of NOW)."""
    n = num_groups * WAYS
    cand = keys + keys // 8
    hi = rng.integers(1, 1 << 62, cand, dtype=np.int64)
    lo = rng.integers(0, 1 << 62, cand, dtype=np.int64)
    grp = lo % num_groups
    order = np.argsort(grp, kind="stable")
    g_sorted = grp[order]
    rank = np.empty(cand, np.int64)
    rank[order] = np.arange(cand) - np.searchsorted(g_sorted, g_sorted, side="left")
    keep = np.nonzero(rank < WAYS)[0][:keys]
    k = keep.size
    slot = grp[keep] * WAYS + rank[keep]
    col = {f: np.zeros(n, dt) for f, dt in dtypes.items()}
    leaky = rng.random(k) < 0.3
    limit = rng.integers(10, 1001, k)
    burst = np.where(leaky, limit, 0)
    col["key_hi"][slot] = hi[keep]
    col["key_lo"][slot] = lo[keep]
    col["used"][slot] = True
    col["algo"][slot] = leaky.astype(np.int8)
    col["limit"][slot] = limit
    col["duration"][slot] = rng.integers(1000, 60_001, k)
    col["remaining"][slot] = np.where(leaky, burst << 20, limit)
    col["stamp"][slot] = NOW - rng.integers(0, 60_000, k)
    col["expire_at"][slot] = NOW + rng.integers(-30_000, 60_000, k)
    col["burst"][slot] = burst
    col["lru"][slot] = NOW - rng.integers(0, 120_000, k)
    col["key_strings"] = {}
    return col


def smoke_calls(rng, keys: int, calls: int) -> list:
    """`calls` calls of ITEMS item dicts: Zipf(1.1) ranks over `keys`."""
    cdf = np.cumsum(np.arange(1, keys + 1, dtype=np.float64) ** -1.1)
    cdf /= cdf[-1]
    out = []
    for _ in range(calls):
        ks = np.searchsorted(cdf, rng.random(ITEMS), side="right") + 1
        u = rng.random(ITEMS)
        items = []
        for i in range(ITEMS):
            behavior = 8 if u[i] < 0.05 else (32 if u[i] < 0.10 else 0)
            duration = int(rng.integers(1000, 60_001))
            if rng.random() < 0.01:
                behavior |= 4
                duration = int(rng.choice([0, 1]))
            items.append(dict(
                name="smoke", unique_key=f"acct:{int(ks[i])}",
                algorithm=int(rng.random() < 0.3), behavior=behavior,
                duration=duration, limit=int(rng.integers(10, 1001)),
                hits=int(rng.integers(1, 6)),
            ))
        out.append(items)
    return out


def encode_request(items, varint) -> bytes:
    """GetRateLimitsReq bytes of one call's item dicts."""
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
                body += varint(len(raw)) + raw
            else:
                body += varint(int(v))
        out.append(0x0A)
        out += varint(len(body)) + body
    return bytes(out)


# ---------------------------------------------------------------------------
# switching parts off (instance attributes of one engine and service)

def _noop(*_a, **_k) -> None:
    return None


class _NullChild:
    inc = dec = observe = staticmethod(_noop)


class _NullFamily(_NullChild):
    def labels(self, *_a):
        return _NullChild()


class _NullRecorder:
    record_decision = record_columnar = staticmethod(_noop)


def switch_off(parts, eng, svc) -> None:
    if "recorder" in parts:
        svc.recorder = _NullRecorder()
    if "flush" in parts:
        em = eng.metrics
        em.observe_stage = em.observe_flush = em.recorder.record = _noop
        em.queue_wait.observe = em.pipeline_inflight.observe = _noop
        eng._observe_overlap = _noop
        svc._m_local = _NullChild()
        svc.metrics.concurrent_checks = svc.metrics.func_duration = _NullFamily()


# ---------------------------------------------------------------------------
# one process on one tree

class _Gc:
    def __init__(self):
        self.n, self.ms, self._t = 0, 0.0, None

    def cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None and info["generation"] == 2:
            self.n += 1
            self.ms += (time.perf_counter() - self._t) * 1e3


def worker(opts: dict) -> None:
    sys.path.insert(0, os.path.abspath(opts["tree"]))
    if opts["switch_interval"]:
        sys.setswitchinterval(opts["switch_interval"])
    import torch

    from gubernator_tpu_torch import wire
    from gubernator_tpu_torch.api.keys import key_hash128
    from gubernator_tpu_torch.api.types import RateLimitReq
    from gubernator_tpu_torch.ops.layout import SLOT_DTYPES
    from gubernator_tpu_torch.runtime.engine import DeviceEngine, EngineConfig
    from gubernator_tpu_torch.service.server import V1Service, serve_get_rate_limits_bytes
    from gubernator_tpu_torch.utils import clock

    import gubernator_tpu_torch
    pkg = os.path.dirname(os.path.abspath(gubernator_tpu_torch.__file__))
    if pkg != os.path.join(opts["tree"], "gubernator_tpu_torch"):
        raise SystemExit(f"the {opts['tree_name']} turn imported {pkg}, not its tree's package")
    rng = np.random.default_rng(opts["seed"])
    snap = live_image(rng, opts["groups"], opts["keys"], SLOT_DTYPES)
    calls = smoke_calls(rng, opts["keys"], opts["calls"])
    bodies = [encode_request(items, wire.varint) for items in calls]
    decisions = opts["calls"] * ITEMS
    device = opts["device"]

    def run(variant: str, path: str) -> dict:
        parts = VARIANTS.get(variant, ())
        kw = dict(num_groups=opts["groups"], ways=WAYS, batch_size=B, device=device,
                  max_waves=PATHS[path])
        if opts["tree_name"] == "change":
            kw["hotkeys_k"] = 0 if "sketch" in parts else 128
        eng = DeviceEngine(EngineConfig(**kw))
        digest = hashlib.sha256()
        g = _Gc()
        try:
            eng.restore(snap)
            svc = V1Service(eng)
            switch_off(parts, eng, svc)
            if device == "cuda":
                torch.cuda.synchronize()
            gc.collect()
            gc.callbacks.append(g.cb)
            if opts["no_gc"]:
                gc.disable()
            secs = 0.0
            with clock.freeze(NOW) as clk:
                for items, data in zip(calls, bodies):
                    t0 = time.perf_counter()
                    if path == "objects":
                        resp = asyncio.run(svc.get_rate_limits(
                            [RateLimitReq(**kw) for kw in items]))
                        secs += time.perf_counter() - t0
                        for r in resp:
                            digest.update(repr((r.status, r.limit, r.remaining,
                                                r.reset_time, r.error)).encode())
                    else:
                        out = asyncio.run(serve_get_rate_limits_bytes(svc, data))
                        secs += time.perf_counter() - t0
                        digest.update(out)
                    clk.advance(700)
            st = eng.stats()
        finally:
            gc.enable()
            if g.cb in gc.callbacks:
                gc.callbacks.remove(g.cb)
            eng.close()
        return {"tree": opts["tree_name"], "variant": variant, "path": path,
                "round": opts["round"], "decisions_per_s": decisions / secs, "seconds": secs,
                "flushes": st["flushes"], "columnar_flushes": st["columnar_flushes"],
                "waves": st["waves"], "gc2": g.n, "gc2_ms": g.ms,
                "answers": digest.hexdigest()[:16], "no_gc": opts["no_gc"],
                "switch_interval": sys.getswitchinterval()}

    # warm the process (kernels loaded, allocator, interpreter) on a
    # throwaway engine before any timed run
    for path in PATHS:
        run("full" if opts["tree_name"] == "change" else "parent", path)
    if opts["tree_name"] == "change":
        reqs = [RateLimitReq(**kw) for kw in calls[0]]
        t0 = time.perf_counter()
        for r in reqs:
            key_hash128(r.hash_key())
        print(json.dumps({"key_hash_us_per_item": (time.perf_counter() - t0) * 1e6 / len(reqs),
                          "round": opts["round"]}), flush=True)
    for variant in opts["variants"]:
        for path in PATHS:
            print(json.dumps(run(variant, path)), flush=True)


# ---------------------------------------------------------------------------
# the turns

def summarize(lines: list) -> dict:
    rates = {}
    for ln in lines:
        if "decisions_per_s" in ln:
            key = ln["variant"] if ln["tree"] == "change" else "parent"
            rates.setdefault(ln["path"], {}).setdefault(key, []).append(ln["decisions_per_s"])
    out = {}
    for path, by in rates.items():
        med = {k: statistics.median(v) for k, v in by.items()}
        ent = {"median_decisions_per_s": med}
        if "parent" in med:
            ent["ratio_to_parent"] = {k: v / med["parent"] for k, v in med.items()}
        if "full" in med:
            full_us = 1e6 / med["full"]
            ent["us_per_item"] = {k: full_us - 1e6 / v for k, v in med.items()
                                  if k not in ("full", "parent")}
            if "parent" in med and "all_off" in med:
                ent["us_per_item"]["all_off_vs_parent"] = 1e6 / med["all_off"] - 1e6 / med["parent"]
        out[path] = ent
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="root of the parent tree (unpacked)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--calls", type=int, default=16)
    ap.add_argument("--groups", type=int, default=1 << 18)
    ap.add_argument("--keys", type=int, default=1_000_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--no-gc", action="store_true")
    ap.add_argument("--switch-interval", type=float, default=0.0)
    ap.add_argument("--out", default=os.path.join("chiprun_out", "telemetry_cost.jsonl"))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(json.loads(args.worker))
        return 0
    here = os.path.dirname(os.path.abspath(__file__))
    trees = [("change", here)] + ([("parent", os.path.abspath(args.parent))]
                                  if args.parent else [])
    variants = args.variants.split(",")
    lines = []
    out = os.path.abspath(args.out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        for r in range(args.rounds):
            for name, tree in (trees[::-1] if r % 2 == 0 else trees):
                opts = dict(tree=tree, tree_name=name, round=r, seed=args.seed,
                            calls=args.calls, groups=args.groups, keys=args.keys,
                            device=args.device, no_gc=args.no_gc,
                            switch_interval=args.switch_interval,
                            variants=(variants if r % 2 == 0 else variants[::-1])
                            if name == "change" else ["parent"])
                proc = subprocess.run(
                    [sys.executable, os.path.abspath(__file__), "--worker", json.dumps(opts)],
                    cwd=tree, capture_output=True, text=True, timeout=1200,
                )
                if proc.returncode != 0:
                    sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-8000:])
                    raise SystemExit(f"telemetry_cost: the {name} turn of round {r} failed")
                for raw in proc.stdout.splitlines():
                    if raw.startswith("{"):
                        ln = json.loads(raw)
                        lines.append(ln)
                        f.write(raw + "\n")
                        print(raw, flush=True)
        answers = {}
        for ln in lines:
            if "answers" in ln:
                answers.setdefault(ln["path"], set()).add(ln["answers"])
        summary = {"summary": summarize(lines), "calls": args.calls, "items_per_call": ITEMS,
                   "answers_equal": all(len(v) == 1 for v in answers.values())}
        f.write(json.dumps(summary) + "\n")
        print(json.dumps(summary), flush=True)
        smi = "cpu"
        if args.device == "cuda":
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, check=True, timeout=60,
            ).stdout.strip().splitlines()[0]
        f.write(json.dumps({"nvidia_smi": smi}) + "\n")
    print(smi)
    if not summary["answers_equal"]:
        print("telemetry_cost: the runs' answers differ", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
