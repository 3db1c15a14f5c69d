"""Where the wave kernel's device time goes: the kernel with parts taken out.

    python -m gubernator_tpu_torch.ablate [--widths 1024,4096]

Builds copies of the wave kernel's library (csrc/, patched as listed in
VARIANTS, into gubernator_tpu_torch/_build/ablate/<variant>/, one nvcc
per source, all started at once), then times each variant of
`decide_wave_kernel` on one card, flat tables of both layouts
(`BASELINE.json` config 3: 2^18 groups x 8 ways, the bench's `kernel`
traffic, Zipf(1.1) over 1M keys, 25% leaky, warmed by 64 waves), at each
width: the profiler's device time per launch (CUPTI, 200 launches) and
the CUDA-events time of one launch (median of 200, L2 flushed before
each, the device held busy while the host enqueues). The variants run
in turns, forward then backward, twice. Variants other than `as_built`
compute wrong answers on purpose: they only say what a part costs.

- `as_built`: the kernel as the checkout builds it.
- `empty`: returns at once: the launch floor.
- `no_sums`: no reduction of the 9 sums (`wave_sums` skipped).
- `select_only`: the lane's loads and the team's selection, then the
  owner stores nothing (`lane_finish` skipped; its inputs kept live).
- `token_only`: every lane runs the token-bucket branch (no int64
  divisions of the leaky branch).

Prints one JSON line per (layout, width, variant) and a last line with
the card's name and power limit as nvidia-smi prints them. Needs a
card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
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
from gubernator_tpu_torch.ops.layout import batch_to_device

SOURCES = ("decide_wave.cu", "decide_scan.cu", "decide_sharded.cu")
_FINISH = "  out = lane_finish<LAYOUT>(a, x, c, row, scal);\n  return true;"
# variant -> [(file, text, replacement)]
VARIANTS = {
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
NUM_GROUPS = 1 << 18
N_KEYS = 1_000_000
REPS = 200


def build(root: Path) -> None:
    """Every variant's library, root/<variant>/libdecide_cuda.so."""
    shutil.rmtree(root, ignore_errors=True)
    procs = []
    for name, patches in VARIANTS.items():
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
                   "-Xcompiler", "-fPIC", "-I", str(d), "-o", str(d / f"{src}.o"), str(d / src)]
            procs.append((name, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
    for name, p in procs:
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc failed:\n{out}")
    for name in VARIANTS:
        d = root / name
        subprocess.run([_build._nvcc(), *_build.CUDA_ARCH, "-shared", "-o",
                        str(d / "libdecide_cuda.so"), *(str(d / f"{s}.o") for s in SOURCES)],
                       check=True)


def _events_ms(fn, flush) -> float:
    times = []
    for _ in range(REPS):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def _profiler_ms(fn) -> float:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for e in prof.key_averages():
        if "decide_wave_kernel" in e.key:
            total += getattr(e, "device_time_total", 0.0)
            count += e.count
    if not count:
        raise RuntimeError("the profiler saw no decide_wave_kernel")
    return total / count / 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--widths", default="1024,4096")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ablate: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    root = _build.BUILD_DIR / "ablate"
    build(root)
    libs = {n: ctypes.CDLL(str(root / n / "libdecide_cuda.so")) for n in VARIANTS}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rng = np.random.default_rng(5)
    for layout in ("fused", "narrow"):
        K = get_kernels(layout)
        table = K.create(NUM_GROUPS, bench.WAYS, dev)
        for width in (int(w) for w in args.widths.split(",")):
            dbs = [batch_to_device(bench._make_zipf_batch(rng, width, N_KEYS, NUM_GROUPS,
                                                          bench.NOW), dev)
                   for _ in range(REPS)]
            at = {"i": 0}

            def wave():
                i = at["i"] % REPS
                at["i"] += 1
                cuda_decide.decide_flat(table, dbs[i], bench.NOW, layout=layout, ways=bench.WAYS)

            _build._loaded["decide_cuda"] = libs["as_built"]
            for _ in range(64):
                wave()
            res = {n: [] for n in VARIANTS}
            for rnd in range(4):
                order = list(VARIANTS) if rnd % 2 == 0 else list(VARIANTS)[::-1]
                for name in order:
                    _build._loaded["decide_cuda"] = libs[name]
                    for _ in range(10):
                        wave()
                    torch.cuda.synchronize()
                    res[name].append((_profiler_ms(wave), _events_ms(wave, flush)))
            _build._loaded["decide_cuda"] = libs["as_built"]
            for name, runs in res.items():
                line = {"layout": layout, "batch": width, "variant": name,
                        "profiler_ms_median": statistics.median(p for p, _ in runs),
                        "events_ms_median": statistics.median(e for _, e in runs),
                        "profiler_ms_runs": [p for p, _ in runs],
                        "events_ms_runs": [e for _, e in runs], "card": smi}
                print(json.dumps(line), flush=True)
        del table
        torch.cuda.empty_cache()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
