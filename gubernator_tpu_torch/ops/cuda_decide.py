"""The decide wave on Hopper: wrapper of the CUDA kernel in
`csrc/decide_wave.cu`.

Counterpart of `gubernator_tpu/ops/pallas_decide.py` (`decide_flat`,
`decide_flat_with_scan`) for the fused layout on a flat table. The
kernel replaces that module's `_make_kernel`; see the source for its
design and bound.

Dispatch is by the table's device and nothing else:

- a CPU table runs the plain PyTorch version
  (`ops/fused.py::decide_fused_plain`);
- a CUDA table launches the kernel or raises. A failed build or launch
  is never caught here, and the plain version never runs on the card.

The table is updated IN PLACE (JAX donates the buffer instead).
`LAUNCHES` counts kernel launches and is bumped only right after one
succeeded, so a caller can show that a run went through the kernel;
`thread_launches()` is the same count for the calling thread alone.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch

from gubernator_tpu_torch.ops import _build
from gubernator_tpu_torch.ops.fused import NCOLS, FusedTable, decide_fused_plain
from gubernator_tpu_torch.ops.layout import (
    DEFAULT_WAYS,
    DecideOutput,
    RequestBatch,
    WaveScan,
)

# Kernel launches made by this module since import (or the last reset).
LAUNCHES = 0
_tls = threading.local()


def thread_launches() -> int:
    """Kernel launches made by the calling thread since import (an
    engine diffs it around its waves; other threads' launches never
    enter that count)."""
    return getattr(_tls, "launches", 0)

N_SCAL = 9
# scalar slots of the kernel's (9,) side output (decide_lane.cuh S_*)
_S_HITS, _S_MISSES, _S_EVICTS, _S_OVER = 0, 1, 2, 3

_P = ctypes.c_void_p


class _WaveArgs(ctypes.Structure):
    """Mirror of `GuberWaveArgs` in csrc/decide_lane.cuh."""

    _fields_ = [
        ("table", _P), ("key_hi", _P), ("key_lo", _P), ("group", _P),
        ("algo", _P), ("behavior", _P), ("hits", _P), ("limit", _P),
        ("duration", _P), ("rate_num", _P), ("eff_duration", _P),
        ("greg_expire", _P), ("burst", _P), ("created_at", _P),
        ("active", _P), ("out_status", _P), ("out_limit", _P),
        ("out_remaining", _P), ("out_reset_time", _P), ("out_slot", _P),
        ("out_evicted_hi", _P), ("out_evicted_lo", _P), ("out_freed", _P),
        ("scalars", _P), ("n_slots", ctypes.c_int64), ("now", ctypes.c_int64),
        ("ways", ctypes.c_int32), ("batch", ctypes.c_int32),
    ]


_BATCH_DTYPES = {
    "key_hi": torch.int64, "key_lo": torch.int64, "group": torch.int32,
    "algo": torch.int8, "behavior": torch.int32, "hits": torch.int64,
    "limit": torch.int64, "duration": torch.int64, "rate_num": torch.int64,
    "eff_duration": torch.int64, "greg_expire": torch.int64,
    "burst": torch.int64, "created_at": torch.int64, "active": torch.bool,
}


def _check(table: FusedTable, batch: RequestBatch, ways: int) -> int:
    """Validate what the kernel takes; returns the lane count."""
    data = table.data
    if data.dtype != torch.int64 or data.dim() != 2 or data.shape[1] != NCOLS:
        raise ValueError(f"table must be (N, {NCOLS}) int64, got {tuple(data.shape)} {data.dtype}")
    if not data.is_contiguous():
        raise ValueError("table must be contiguous")
    if ways < 1 or data.shape[0] % ways:
        raise ValueError(f"table rows {data.shape[0]} not a multiple of ways={ways}")
    b = batch.key_hi.shape[0]
    if b >= 1 << 31:
        raise ValueError("batch too large")
    for f, dt in _BATCH_DTYPES.items():
        t = getattr(batch, f)
        if not torch.is_tensor(t) or t.device != data.device:
            raise ValueError(f"batch.{f} must be a tensor on {data.device}")
        if t.dtype != dt or t.shape != (b,) or not t.is_contiguous():
            raise ValueError(f"batch.{f} must be contiguous ({b},) {dt}, got {tuple(t.shape)} {t.dtype}")
    return b


def _outputs(b: int, dev) -> Tuple[DecideOutput, WaveScan, list]:
    i64 = dict(dtype=torch.int64, device=dev)
    limit, remaining, reset_time, slot, ehi, elo = (torch.empty(b, **i64) for _ in range(6))
    status = torch.empty(b, dtype=torch.int8, device=dev)
    freed = torch.empty(b, dtype=torch.bool, device=dev)
    scal = torch.empty(N_SCAL, **i64)
    out = DecideOutput(
        status=status, limit=limit, remaining=remaining, reset_time=reset_time,
        slot=slot, evicted_hi=ehi, evicted_lo=elo, freed=freed,
        hits=scal[_S_HITS], misses=scal[_S_MISSES],
        unexpired_evictions=scal[_S_EVICTS], over_limit=scal[_S_OVER],
    )
    scan = WaveScan(*(scal[k] for k in range(4, N_SCAL)))
    ptrs = [status, limit, remaining, reset_time, slot, ehi, elo, freed, scal]
    return out, scan, ptrs


def _wave_args(table, batch, now, ways, b, ptrs) -> _WaveArgs:
    cols = [getattr(batch, f).data_ptr() for f in _BATCH_DTYPES]
    return _WaveArgs(
        table.data.data_ptr(), *cols, *(t.data_ptr() for t in ptrs),
        table.data.shape[0], int(now), ways, b,
    )


def _decide_lib() -> ctypes.CDLL:
    lib = _build.load("decide_wave")
    if lib.guber_decide_wave.argtypes is None:
        lib.guber_decide_wave.argtypes = [ctypes.POINTER(_WaveArgs), ctypes.c_void_p]
        lib.guber_decide_wave.restype = ctypes.c_int
        lib.guber_cuda_error_string.argtypes = [ctypes.c_int]
        lib.guber_cuda_error_string.restype = ctypes.c_char_p
    return lib


def load(device) -> None:
    """Build/load what a decide on `device` needs (nothing for the CPU),
    so a build failure surfaces at engine construction."""
    if torch.device(device).type == "cuda":
        _decide_lib()


def decide_flat_with_scan(
    table: FusedTable, batch: RequestBatch, now: int, *, ways: int = DEFAULT_WAYS
) -> Tuple[FusedTable, DecideOutput, WaveScan]:
    """One decide wave: (table, batch, now) -> (table, out, scan), the
    table updated in place. CPU table: the plain version. CUDA table:
    the kernel, on PyTorch's current stream, without synchronising."""
    global LAUNCHES
    dev = table.data.device
    if dev.type == "cpu":
        return decide_fused_plain(table, batch, now, ways=ways)
    if dev.type != "cuda":
        raise ValueError(f"decide runs on cuda or cpu, not {dev}")
    b = _check(table, batch, ways)
    lib = _decide_lib()
    out, scan, ptrs = _outputs(b, dev)
    if b == 0:
        ptrs[-1].zero_()
        return table, out, scan
    args = _wave_args(table, batch, now, ways, b, ptrs)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.guber_decide_wave(ctypes.byref(args), stream)
    if rc != 0:
        msg = lib.guber_cuda_error_string(rc).decode()
        raise RuntimeError(f"decide_wave launch failed: CUDA error {rc} ({msg})")
    LAUNCHES += 1
    _tls.launches = thread_launches() + 1
    return table, out, scan


def decide_flat(
    table: FusedTable, batch: RequestBatch, now: int, *, ways: int = DEFAULT_WAYS
) -> Tuple[FusedTable, DecideOutput]:
    """`decide_flat_with_scan` without the WaveScan sums."""
    table, out, _scan = decide_flat_with_scan(table, batch, now, ways=ways)
    return table, out


def decide_lane_code_on_host(
    table: FusedTable, batch: RequestBatch, now: int, *, ways: int = DEFAULT_WAYS
) -> Tuple[FusedTable, DecideOutput, WaveScan]:
    """Tests only: the kernel's per-lane C++ (csrc/decide_lane.cuh)
    built by g++ and run lane after lane on CPU tensors, so the CPU test
    suite checks the kernel's own arithmetic against the plain version.
    No serving path calls this."""
    if table.data.device.type != "cpu":
        raise ValueError("decide_lane_code_on_host takes CPU tensors")
    b = _check(table, batch, ways)
    lib = _build.load("decide_lane_host")
    fn = lib.guber_decide_wave_host
    fn.argtypes = [ctypes.POINTER(_WaveArgs)]
    fn.restype = ctypes.c_int
    out, scan, ptrs = _outputs(b, table.data.device)
    args = _wave_args(table, batch, now, ways, b, ptrs)
    if fn(ctypes.byref(args)) != 0:
        raise RuntimeError("decide_lane_host failed")
    return table, out, scan
