"""Where the decide kernels' device time goes: the kernels with parts taken out.

    python -m gubernator_tpu_torch.ablate [--kernels wave,scan] [--widths 1024,4096]
        [--scan-widths 4096] [--turns 4]

Builds copies of the kernels' library (csrc/, patched as listed in
WAVE_VARIANTS and SCAN_VARIANTS, into
gubernator_tpu_torch/_build/ablate/<variant>/, one nvcc per source, all
started at once), then times each variant on one card, flat tables of
both layouts (`BASELINE.json` config 3: 2^18 groups x 8 ways, the
bench's `kernel` traffic, Zipf(1.1) over 1M keys, 25% leaky, warmed by
64 waves). Variants other than the `as_built` ones compute wrong
answers on purpose: they only say what a part costs. The variants of a
kernel run in turns, forward then backward (--turns of them, 4 by
default).

The wave kernel (`decide_wave_kernel`), at each width: the profiler's
device time per launch (CUPTI, 200 launches) and the CUDA-events time
of one launch (median of 200, L2 flushed before each, the device held
busy while the host enqueues).

- `as_built`: the kernel as the checkout builds it.
- `empty`: returns at once: the launch floor.
- `no_sums`: no reduction of the 9 sums (`wave_sums` skipped).
- `select_only`: the lane's loads and the team's selection, then the
  owner stores nothing (`lane_finish` skipped; its inputs kept live).
- `token_only`: every lane runs the token-bucket branch (no int64
  divisions of the leaky branch).

The scan kernel (`decide_scan_kernel`), at the bench's shape (T = 32
steps of B = 4,096 lanes, 8 different scans cycled; other widths with
--scan-widths): the profiler's device time per scan and per step (40
scans) and the CUDA-events time of one scan (median of 40, as above).

- `scan_as_built`: the kernel as the checkout builds it.
- `scan_empty`: the barriers and the sums only, no lane work (the
  per-step floor that takes the place of the wave kernel's launch).
- `scan_barrier_only`: the barriers alone (no lane work, no sums).
- `scan_grid_sync`: every barrier a cooperative grid.sync() (as built,
  barriers 1 .. T - 2 are the kernel's own flip_barrier).
- `scan_blocks128`, `scan_blocks256`: blocks of 128 or of 256 threads
  at every width (as built: 128 while a step's items fit one block per
  SM, else 256).
- `scan_first_row_in_loop`: the member's first row loaded in its loop
  over the ways, the hook after it (as built, the scan loads it ahead of
  the loop; the wave kernel, without a hook, in the loop).
- `scan_stage_before_rows`: the next item's stage started before the
  member's row load instead of after it.
- `scan_no_stage`: no staging: each item reads its batch columns from
  device memory after the barrier, as the wave kernel does.

Prints a JSON line of each variant's registers (ptxas), one JSON line
per (kernel, layout, width, variant) and a last line with the card's
name and power limit as nvidia-smi prints them; the same lines go to
chiprun_out/ablate.jsonl. Needs a card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from gubernator_tpu_torch import bench
from gubernator_tpu_torch.ops import _build, cuda_decide
from gubernator_tpu_torch.ops.kernels import get_kernels
from gubernator_tpu_torch.ops.layout import batch_to_device, stack_batches

SOURCES = ("decide_wave.cu", "decide_scan.cu", "decide_sharded.cu")
_FINISH = "  out = lane_finish<LAYOUT>(a, x, c, row, scal);\n  return true;"
# variant -> [(file, text, replacement)]
WAVE_VARIANTS = {
    "as_built": [],
    "empty": [("decide_wave.cu", "  // active and group are read together",
               "  if (a.batch > 0) return;\n  // active and group are read together")],
    "no_sums": [("decide_wave.cu", "  guber::wave_sums<kThreads>(s, a);",
                 "  if (s[0] == -1) a.scalars[0] = 0;")],
    "select_only": [("decide_lane.cuh", _FINISH,
                     "  out = padding_out(a);\n  scal[0] += row.c[0] ^ c.score ^ x.r.hits;\n"
                     "  return true;")],
    "token_only": [("decide_lane.cuh",
                    "  const LaneResult o = is_leaky ? leaky_lane(r, st, exists) : "
                    "token_lane(r, st, exists);",
                    "  const LaneResult o = token_lane(r, st, exists);")],
}
_NO_LANES = ("decide_scan.cu", "    for (int k = 0; k < p.iters; ++k, ++n) {",
             "    for (int k = 0; k < 0; ++k, ++n) {")
SCAN_VARIANTS = {
    "scan_as_built": [],
    "scan_empty": [_NO_LANES],
    "scan_barrier_only": [
        _NO_LANES,
        ("decide_scan.cu", "    guber::warp_partials(s, part[t & 1]);\n", ""),
        ("decide_scan.cu", "    guber::add_partials<THREADS>(part[t & 1], w.scalars);\n", ""),
    ],
    "scan_grid_sync": [("decide_scan.cu", "      flip_barrier(a.barrier);",
                        "      grid.sync();")],
    "scan_blocks128": [("decide_scan.cu", "  return items <= sms ?", "  return true ?")],
    "scan_blocks256": [("decide_scan.cu", "  return items <= sms ?", "  return false ?")],
    "scan_first_row_in_loop": [
        ("decide_lane.cuh", "  constexpr bool HOOKED = !std::is_same<Hook, NoHook>::value;",
         "  constexpr bool HOOKED = false;"),
        ("decide_lane.cuh",
         "    const Cand e = way_eval(probe_of(r), x.key_hi, x.key_lo, a.now, w);\n",
         "    if (w == t) after_load();\n"
         "    const Cand e = way_eval(probe_of(r), x.key_hi, x.key_lo, a.now, w);\n"),
    ],
    "scan_stage_before_rows": [
        ("decide_scan.cu",
         "            if (more) held = guber::stage_start<THREADS>(wn, ln, p, next);\n", ""),
        ("decide_scan.cu", "      guber::StageBytes held{{0, 0}};\n",
         "      guber::StageBytes held{{0, 0}};\n"
         "      if (more) held = guber::stage_start<THREADS>(wn, ln, p, next);\n"),
    ],
    "scan_no_stage": [
        ("decide_scan.cu", "      const bool more = !last || t + 1 < a.steps;",
         "      const bool more = false;"),
        ("decide_scan.cu",
         "      const bool active = in_batch && sv.active[i] != 0;\n"
         "      const guber::LaneCtx x =\n"
         "          guber::lane_ctx<PAGED>(sv, i, in_batch, active, active ? sv.group[i] : 0, pp);",
         "      const bool active = in_batch && w.active[j] != 0;\n"
         "      const guber::LaneCtx x =\n"
         "          guber::lane_ctx<PAGED>(w, (int)j, in_batch, active, active ? w.group[j] : 0);"),
    ],
}
KERNELS = {"wave": WAVE_VARIANTS, "scan": SCAN_VARIANTS}
NUM_GROUPS = 1 << 18
N_KEYS = 1_000_000
REPS = 200
SCAN_T = 32
SCAN_B = 4096
SCAN_REPS = 40
SCANS = 8  # different scans, cycled


def build(root: Path, variants: dict) -> dict:
    """Every variant's library, root/<variant>/libdecide_cuda.so; returns
    {variant: {kernel: registers}} from ptxas."""
    shutil.rmtree(root, ignore_errors=True)
    procs = []
    for name, patches in variants.items():
        d = root / name
        d.mkdir(parents=True)
        for f in _build.CSRC.iterdir():
            if f.is_file():
                text = f.read_text()
                for file, old, new in patches:
                    if file == f.name:
                        if old not in text:
                            raise RuntimeError(f"{name}: {file} no longer holds {old!r}")
                        text = text.replace(old, new)
                (d / f.name).write_text(text)
        for src in SOURCES:
            cmd = [_build._nvcc(), *_build.CUDA_ARCH, "-std=c++17", "-O3", "-c",
                   "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(d), "-o",
                   str(d / f"{src}.o"), str(d / src)]
            procs.append((name, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
    regs = {n: {} for n in variants}
    for name, p in procs:
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc failed:\n{out}")
        kernel = None
        for ln in out.splitlines():
            m = re.search(r"entry function '.*\d(decide_[a-z]+_kernel)ILi(\d+)ELb(\d)E"
                          r"(?:Li(\d+)E)?", ln)
            if m:
                kernel = f"{m.group(1)}<{','.join(g for g in m.groups()[1:] if g)}>"
            m = re.search(r"Used (\d+) registers", ln)
            if m and kernel:
                regs[name][kernel] = int(m.group(1))
    for name in variants:
        d = root / name
        subprocess.run([_build._nvcc(), *_build.CUDA_ARCH, "-shared", "-o",
                        str(d / "libdecide_cuda.so"), *(str(d / f"{s}.o") for s in SOURCES)],
                       check=True)
    return regs


OUT_DIR = "chiprun_out"
_lines = []


def _emit(obj) -> None:
    """One JSON line on stdout, kept for chiprun_out/ablate.jsonl."""
    line = json.dumps(obj)
    _lines.append(line)
    print(line, flush=True)


def _events_ms(fn, flush, reps=REPS) -> float:
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def _profiler_ms(fn, kernel="decide_wave_kernel", reps=REPS) -> float:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for e in prof.key_averages():
        if kernel in e.key:
            total += getattr(e, "device_time_total", 0.0)
            count += e.count
    if not count:
        raise RuntimeError(f"the profiler saw no {kernel}")
    return total / count / 1e3


def _turns(variants, libs, run, timed, turns=4):
    """Each variant's library swapped in, in `turns` turns (forward,
    backward, ...): {variant: [timed() of each turn]}, 10 warm calls of
    `run` before each turn."""
    res = {n: [] for n in variants}
    for rnd in range(turns):
        order = list(variants) if rnd % 2 == 0 else list(variants)[::-1]
        for name in order:
            _build._loaded["decide_cuda"] = libs[name]
            for _ in range(10):
                run()
            torch.cuda.synchronize()
            res[name].append(timed())
    return res


def _line(kernel, layout, width, name, runs, smi, per=1):
    return {"kernel": kernel, "layout": layout, "batch": width, "variant": name,
            "profiler_ms_median": statistics.median(p for p, _ in runs) / per,
            "events_ms_median": statistics.median(e for _, e in runs) / per,
            "profiler_ms_runs": [p / per for p, _ in runs],
            "events_ms_runs": [e / per for _, e in runs], "card": smi}


def ablate_wave(K, table, layout, widths, libs, rng, flush, smi):
    for width in widths:
        dbs = [batch_to_device(bench._make_zipf_batch(rng, width, N_KEYS, NUM_GROUPS,
                                                      bench.NOW), table.data.device)
               for _ in range(REPS)]
        at = {"i": 0}

        def wave():
            i = at["i"] % REPS
            at["i"] += 1
            cuda_decide.decide_flat(table, dbs[i], bench.NOW, layout=layout, ways=bench.WAYS)

        _build._loaded["decide_cuda"] = libs["as_built"]
        for _ in range(64):
            wave()
        res = _turns(WAVE_VARIANTS, libs, wave,
                     lambda: (_profiler_ms(wave), _events_ms(wave, flush)))
        for name, runs in res.items():
            _emit(_line("wave", layout, width, name, runs, smi))


def ablate_scan(K, table, layout, width, libs, rng, flush, smi, turns=4):
    """The scan variants at the bench's shape: times per scan, and per
    step (divided by the SCAN_T steps)."""
    dev = table.data.device
    scans = []
    for _ in range(SCANS):
        hosts = [bench._make_zipf_batch(rng, width, N_KEYS, NUM_GROUPS, bench.NOW)
                 for _ in range(SCAN_T)]
        nows = torch.full((SCAN_T,), bench.NOW, dtype=torch.int64, device=dev)
        scans.append((batch_to_device(stack_batches(hosts), dev), nows))
    at = {"i": 0}

    def scan():
        db, nows = scans[at["i"] % SCANS]
        at["i"] += 1
        cuda_decide.decide_scan_flat(table, db, nows, layout=layout, ways=bench.WAYS)

    _build._loaded["decide_cuda"] = libs["scan_as_built"]
    for _ in range(4):
        scan()
    res = _turns(SCAN_VARIANTS, libs, scan,
                 lambda: (_profiler_ms(scan, "decide_scan_kernel", SCAN_REPS),
                          _events_ms(scan, flush, SCAN_REPS)), turns)
    for name, runs in res.items():
        line = _line("scan", layout, width, name, runs, smi)
        step = _line("scan", layout, width, name, runs, smi, per=SCAN_T)
        line.update(steps=SCAN_T, profiler_ms_per_step=step["profiler_ms_median"],
                    events_ms_per_step=step["events_ms_median"])
        _emit(line)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", default="wave,scan")
    ap.add_argument("--widths", default="1024,4096")
    ap.add_argument("--scan-widths", default=str(SCAN_B))
    ap.add_argument("--turns", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ablate: needs a CUDA device", file=sys.stderr)
        return 2
    kernels = args.kernels.split(",")
    if not set(kernels) <= set(KERNELS):
        print(f"ablate: --kernels takes {','.join(KERNELS)}", file=sys.stderr)
        return 2
    variants = {n: p for k in kernels for n, p in KERNELS[k].items()}
    dev = torch.device("cuda", 0)
    root = _build.BUILD_DIR / "ablate"
    regs = build(root, variants)
    _emit({"registers": regs})
    libs = {n: ctypes.CDLL(str(root / n / "libdecide_cuda.so")) for n in variants}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rng = np.random.default_rng(5)
    for layout in ("fused", "narrow"):
        K = get_kernels(layout)
        table = K.create(NUM_GROUPS, bench.WAYS, dev)
        if "wave" in kernels:
            ablate_wave(K, table, layout, [int(w) for w in args.widths.split(",")], libs, rng,
                        flush, smi)
        if "scan" in kernels:
            for width in (int(w) for w in args.scan_widths.split(",")):
                ablate_scan(K, table, layout, width, libs, rng, flush, smi, args.turns)
        del table
        torch.cuda.empty_cache()
    print(smi)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "ablate.jsonl"), "w") as f:
        f.write("\n".join(_lines + [smi]) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
