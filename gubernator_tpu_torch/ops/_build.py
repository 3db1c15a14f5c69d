"""Build the port's native code at first use and load it with ctypes.

Each library has a plain C interface: CUDA sources are compiled by
`nvcc` for `sm_90a` (Hopper), host C++ by `g++`, into
`gubernator_tpu_torch/_build/` (listed in `.gitignore`). A library is
rebuilt when it is missing or older than any of its sources, so a fresh
checkout builds everything on its first run. `build()` starts every
stale compile at once and waits for all of them.

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
from typing import Dict, Iterable, List

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

CUDA_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")

# library name -> (compiler, sources, headers they include)
TARGETS = {
    # the decide kernels: one wave (replaces ops/pallas_decide.py::
    # _make_kernel) and T waves in one cooperative launch (replaces
    # decide_scan_flat / decide_scan_paged)
    "decide_cuda": ("nvcc", ("decide_wave.cu", "decide_scan.cu"), ("decide_lane.cuh",)),
    # the same per-lane code compiled for the CPU; tests only
    "decide_lane_host": ("g++", ("decide_lane_host.cc",), ("decide_lane.cuh",)),
    # MurmurHash3 x64-128 key hasher (host)
    "guberhash": ("g++", ("guberhash.cc",), ()),
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


def _command(name: str, out: str) -> List[str]:
    compiler, srcs, _ = TARGETS[name]
    src_paths = [str(CSRC / s) for s in srcs]
    if compiler == "nvcc":
        return [
            _nvcc(), *CUDA_ARCH, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-I", str(CSRC), "-o", out, *src_paths,
        ]
    return [
        "g++", "-std=c++17", "-O3", "-shared", "-fPIC",
        "-I", str(CSRC), "-o", out, *src_paths,
    ]


def _stale(name: str) -> bool:
    so = lib_path(name)
    if not so.exists():
        return True
    _, srcs, headers = TARGETS[name]
    newest = max((CSRC / f).stat().st_mtime for f in (*srcs, *headers))
    return so.stat().st_mtime < newest


def build(names: Iterable[str], force: bool = False) -> None:
    """Compile the named libraries that are stale (all of them with
    `force`), every compiler started at once. Each writes a private
    temporary file that is renamed into place, so concurrent processes
    building the same library never load a half-written file."""
    names = [n for n in names if force or _stale(n)]
    if not names:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for n in names:
        tmp = str(lib_path(n)) + f".{os.getpid()}.{threading.get_ident()}.tmp"
        p = subprocess.Popen(
            _command(n, tmp),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        procs.append((n, tmp, p))
    failed = []
    for n, tmp, p in procs:
        out, _ = p.communicate()
        log_path(n).write_text(out)
        if p.returncode != 0:
            failed.append(f"{n} (exit {p.returncode}):\n{out}")
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
