"""Build the port's native code at first use and load it with ctypes.

Each library has a plain C interface: CUDA sources are compiled by
`nvcc` for `sm_90a` (Hopper), one object per source, and linked into one
library; host C++ is built by `g++`; all into
`gubernator_tpu_torch/_build/` (listed in `.gitignore`). A library is
rebuilt when it is missing or older than any of its sources, so a fresh
checkout builds everything on its first run. `build()` starts every
stale compile at once (every CUDA source its own `nvcc`), waits for all
of them, then links.

A failed build raises with the compiler's output; nothing here falls
back to another implementation.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

CUDA_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")

# library name -> (compiler, sources, headers they include)
TARGETS = {
    # the decide kernels: one wave (replaces ops/pallas_decide.py::
    # _make_kernel), T waves in one cooperative launch (replaces
    # decide_scan_flat / decide_scan_paged) and the owner-sharded wave
    # (replaces raw_decide_flat inside the mesh tier's shard_map)
    "decide_cuda": (
        "nvcc", ("decide_wave.cu", "decide_scan.cu", "decide_sharded.cu"),
        ("decide_lane.cuh",),
    ),
    # the same per-lane code compiled for the CPU; tests only
    "decide_lane_host": ("g++", ("decide_lane_host.cc",), ("decide_lane.cuh",)),
    # MurmurHash3 x64-128 key hasher (host)
    "guberhash": ("g++", ("guberhash.cc",), ()),
    # GetRateLimitsReq parse / GetRateLimitsResp build for the columnar
    # edge (host; wire.py)
    "wirepath": ("g++", ("wirepath.cc",), ()),
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def log_path(name: str) -> Path:
    """Compiler output of the last build (nvcc's `-Xptxas -v` report)."""
    return BUILD_DIR / f"lib{name}.log"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels are built "
        "from source at first use"
    )


def _jobs(name: str, out: str) -> Tuple[List[Tuple[str, List[str]]], Optional[List[str]]]:
    """The compile commands of library `name` (each with the file it
    writes) and the command that links their objects into `out`, or None
    when the one compile writes `out` itself (g++)."""
    compiler, srcs, _ = TARGETS[name]
    if compiler == "nvcc":
        compiles = []
        for src in srcs:
            obj = f"{out}.{Path(src).stem}.o"
            compiles.append((obj, [
                _nvcc(), *CUDA_ARCH, "-std=c++17", "-O3", "-c",
                "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                "-I", str(CSRC), "-o", obj, str(CSRC / src),
            ]))
        link = [_nvcc(), *CUDA_ARCH, "-shared", "-o", out, *(o for o, _ in compiles)]
        return compiles, link
    return [(out, [
        "g++", "-std=c++17", "-O3", "-shared", "-fPIC",
        "-I", str(CSRC), "-o", out, *(str(CSRC / s) for s in srcs),
    ])], None


def _stale(name: str) -> bool:
    so = lib_path(name)
    if not so.exists():
        return True
    _, srcs, headers = TARGETS[name]
    newest = max((CSRC / f).stat().st_mtime for f in (*srcs, *headers))
    return so.stat().st_mtime < newest


def _run(cmd: List[str]) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build(names: Iterable[str], force: bool = False) -> None:
    """Compile the named libraries that are stale (all of them with
    `force`), every compiler started at once, then link. Each writes
    private temporary files, the library renamed into place, so
    concurrent processes building the same library never load a
    half-written file."""
    names = [n for n in names if force or _stale(n)]
    if not names:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = []
    for n in names:
        tmp = str(lib_path(n)) + f".{os.getpid()}.{threading.get_ident()}.tmp"
        compiles, link = _jobs(n, tmp)
        started.append((n, tmp, [(f, _run(cmd)) for f, cmd in compiles], link))
    failed = []
    for n, tmp, procs, link in started:
        logs, ok = [], True
        for _, p in procs:
            out, _ = p.communicate()
            logs.append(out)
            ok = ok and p.returncode == 0
        if ok and link is not None:
            p = _run(link)
            out, _ = p.communicate()
            logs.append(out)
            ok = p.returncode == 0
        log_path(n).write_text("".join(logs))
        for f, _ in procs:
            if f != tmp and os.path.exists(f):
                os.unlink(f)
        if not ok:
            failed.append(f"{n}:\n{''.join(logs)}")
            if os.path.exists(tmp):
                os.unlink(tmp)
            continue
        os.replace(tmp, lib_path(n))
    if failed:
        raise RuntimeError("native build failed: " + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The named library, built first if it is missing or stale."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(lib_path(name)))
            _loaded[name] = lib
        return lib
