"""The decide wave on Hopper: wrapper of the CUDA kernel in
`csrc/decide_wave.cu`.

Counterpart of `gubernator_tpu/ops/pallas_decide.py` (`decide_flat`,
`decide_flat_with_scan`, `decide_paged`, `decide_paged_with_scan`) for
the fused and narrow layouts, on a flat table or a paged one. The kernel
replaces that module's `_make_kernel` in these four static
configurations; see the source for its design and bound.

Dispatch is by the table's device and nothing else:

- a CPU table runs the plain PyTorch version of the same configuration
  (`ops/fused.py::wave_plain`);
- a CUDA table launches the kernel or raises. A failed build or launch
  is never caught here, and the plain version never runs on the card.

The table is updated IN PLACE (JAX donates the buffer instead); a paged
decide never changes the page map. `CONFIG_LAUNCHES` counts each
configuration's kernel launches, bumped only right after a launch
succeeded, so a caller can show that a run went through the kernel;
`thread_launches()` is the total over every configuration for the
calling thread alone.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from gubernator_tpu_torch.ops import _build, fused, narrow
from gubernator_tpu_torch.ops.layout import (
    DEFAULT_WAYS,
    DecideOutput,
    RequestBatch,
    WaveScan,
)

# Layouts the kernel takes, with their code in csrc/decide_lane.cuh
# (LAYOUT_FUSED, LAYOUT_NARROW) and their row codec for the plain version.
_LAYOUT_CODE = {"fused": 0, "narrow": 1}
_CODECS = {"fused": fused.FUSED_CODEC, "narrow": narrow.NARROW_CODEC}


def config_name(layout: str, paged: bool) -> str:
    """Name of one kernel configuration: "decide_wave" (fused, flat),
    "decide_wave_narrow", "decide_wave_paged", "decide_wave_narrow_paged"."""
    return "decide_wave" + ("_narrow" if layout == "narrow" else "") + (
        "_paged" if paged else ""
    )


CONFIGS = tuple(config_name(lay, p) for p in (False, True) for lay in _LAYOUT_CODE)

# Kernel launches made by this module since import (or the last reset),
# by configuration.
CONFIG_LAUNCHES = {c: 0 for c in CONFIGS}
_tls = threading.local()


def thread_launches() -> int:
    """Kernel launches made by the calling thread since import (an
    engine diffs it around its waves; other threads' launches never
    enter that count)."""
    return getattr(_tls, "launches", 0)


def reset_launches() -> None:
    """Set every `CONFIG_LAUNCHES` count to 0."""
    for c in CONFIGS:
        CONFIG_LAUNCHES[c] = 0

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
        ("scalars", _P), ("page_map", _P), ("n_slots", ctypes.c_int64),
        ("now", ctypes.c_int64), ("ways", ctypes.c_int32),
        ("batch", ctypes.c_int32), ("gpp", ctypes.c_int32),
        ("n_log_pages", ctypes.c_int32),
    ]


_BATCH_DTYPES = {
    "key_hi": torch.int64, "key_lo": torch.int64, "group": torch.int32,
    "algo": torch.int8, "behavior": torch.int32, "hits": torch.int64,
    "limit": torch.int64, "duration": torch.int64, "rate_num": torch.int64,
    "eff_duration": torch.int64, "greg_expire": torch.int64,
    "burst": torch.int64, "created_at": torch.int64, "active": torch.bool,
}


def _check(data, batch: RequestBatch, ways: int, layout: str,
           page_map: Optional[torch.Tensor], gpp: int) -> int:
    """Validate what the kernel takes; returns the lane count."""
    if layout not in _LAYOUT_CODE:
        raise ValueError(f"the decide kernel takes layouts {tuple(_LAYOUT_CODE)}, not {layout!r}")
    ncols = _CODECS[layout].ncols
    if data.dtype != torch.int64 or data.dim() != 2 or data.shape[1] != ncols:
        raise ValueError(
            f"{layout} table must be (N, {ncols}) int64, got {tuple(data.shape)} {data.dtype}"
        )
    if not data.is_contiguous():
        raise ValueError("table must be contiguous")
    if ways < 1 or data.shape[0] % ways:
        raise ValueError(f"table rows {data.shape[0]} not a multiple of ways={ways}")
    if page_map is not None:
        if not torch.is_tensor(page_map) or page_map.device != data.device:
            raise ValueError(f"page_map must be a tensor on {data.device}")
        if page_map.dtype != torch.int32 or page_map.dim() != 1 or not page_map.is_contiguous():
            raise ValueError(
                f"page_map must be contiguous (P,) int32, got {tuple(page_map.shape)} {page_map.dtype}"
            )
        if not 1 <= gpp < 1 << 31 or page_map.shape[0] >= 1 << 31:
            raise ValueError(f"bad page geometry: gpp={gpp}, {page_map.shape[0]} pages")
        if data.shape[0] % (gpp * ways):
            raise ValueError(f"table rows {data.shape[0]} not whole pages of {gpp * ways} slots")
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


def _wave_args(data, batch, now, ways, b, ptrs, page_map, gpp) -> _WaveArgs:
    cols = [getattr(batch, f).data_ptr() for f in _BATCH_DTYPES]
    paged = page_map is not None
    return _WaveArgs(
        data.data_ptr(), *cols, *(t.data_ptr() for t in ptrs),
        page_map.data_ptr() if paged else None,
        data.shape[0], int(now), ways, b,
        gpp if paged else 0, page_map.shape[0] if paged else 0,
    )


def _decide_lib() -> ctypes.CDLL:
    lib = _build.load("decide_wave")
    if lib.guber_decide_wave.argtypes is None:
        lib.guber_decide_wave.argtypes = [
            ctypes.POINTER(_WaveArgs), ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.guber_decide_wave.restype = ctypes.c_int
        lib.guber_cuda_error_string.argtypes = [ctypes.c_int]
        lib.guber_cuda_error_string.restype = ctypes.c_char_p
    return lib


def load(device) -> None:
    """Build/load what a decide on `device` needs (nothing for the CPU),
    so a build failure surfaces at engine construction."""
    if torch.device(device).type == "cuda":
        _decide_lib()


def _wave(data, page_map, batch, now, *, layout, ways, gpp):
    """One wave of configuration (layout, paged = page_map given) over
    the rows `data`, in place: (out, scan)."""
    dev = data.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"decide runs on cuda or cpu, not {dev}")
    b = _check(data, batch, ways, layout, page_map, gpp)
    if dev.type == "cpu":
        return fused.wave_plain(
            _CODECS[layout], data, page_map, batch, now, ways=ways, gpp=gpp
        )
    lib = _decide_lib()
    out, scan, ptrs = _outputs(b, dev)
    if b == 0:
        ptrs[-1].zero_()
        return out, scan
    args = _wave_args(data, batch, now, ways, b, ptrs, page_map, gpp)
    paged = page_map is not None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.guber_decide_wave(
            ctypes.byref(args), _LAYOUT_CODE[layout], int(paged), stream
        )
    if rc != 0:
        msg = lib.guber_cuda_error_string(rc).decode()
        raise RuntimeError(
            f"{config_name(layout, paged)} launch failed: CUDA error {rc} ({msg})"
        )
    CONFIG_LAUNCHES[config_name(layout, paged)] += 1
    _tls.launches = thread_launches() + 1
    return out, scan


def decide_flat_with_scan(
    table, batch: RequestBatch, now: int, *, layout: str = "fused",
    ways: int = DEFAULT_WAYS,
) -> Tuple[object, DecideOutput, WaveScan]:
    """One decide wave on a flat table of `layout`: (table, batch, now)
    -> (table, out, scan), the table updated in place. CPU table: the
    plain version. CUDA table: the kernel, on PyTorch's current stream,
    without synchronising."""
    out, scan = _wave(table.data, None, batch, now, layout=layout, ways=ways, gpp=0)
    return table, out, scan


def decide_flat(
    table, batch: RequestBatch, now: int, *, layout: str = "fused",
    ways: int = DEFAULT_WAYS,
) -> Tuple[object, DecideOutput]:
    """`decide_flat_with_scan` without the WaveScan sums."""
    table, out, _scan = decide_flat_with_scan(table, batch, now, layout=layout, ways=ways)
    return table, out


def decide_paged_with_scan(
    pt, batch: RequestBatch, now: int, *, layout: str, ways: int, gpp: int
) -> Tuple[object, DecideOutput, WaveScan]:
    """One decide wave on a paged table (`ops/paged.py` PagedTable: the
    layout table of the physical frames and the int32 page map), the
    page-map lookup inside the kernel. Lanes on non-resident pages are
    sentinel lanes (slot == N, no load, no store). Same dispatch as
    `decide_flat_with_scan`; the page map is left as it is."""
    out, scan = _wave(
        pt.data.data, pt.page_map, batch, now, layout=layout, ways=ways, gpp=gpp
    )
    return pt, out, scan


def decide_paged(
    pt, batch: RequestBatch, now: int, *, layout: str, ways: int, gpp: int
) -> Tuple[object, DecideOutput]:
    """`decide_paged_with_scan` without the WaveScan sums."""
    pt, out, _scan = decide_paged_with_scan(pt, batch, now, layout=layout, ways=ways, gpp=gpp)
    return pt, out


def decide_lane_code_on_host(
    table, batch: RequestBatch, now: int, *, ways: int = DEFAULT_WAYS,
    layout: str = "fused", page_map: Optional[torch.Tensor] = None, gpp: int = 0,
) -> Tuple[object, DecideOutput, WaveScan]:
    """Tests only: the kernel's per-lane C++ (csrc/decide_lane.cuh)
    built by g++ and run lane after lane on CPU tensors, in the
    configuration (layout, paged = `page_map` given), so the CPU test
    suite checks the kernel's own arithmetic against the plain version.
    `table` is the layout table (for a paged table, its frames). No
    serving path calls this."""
    data = table.data
    if data.device.type != "cpu":
        raise ValueError("decide_lane_code_on_host takes CPU tensors")
    b = _check(data, batch, ways, layout, page_map, gpp)
    lib = _build.load("decide_lane_host")
    fn = lib.guber_decide_wave_host
    fn.argtypes = [ctypes.POINTER(_WaveArgs), ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    out, scan, ptrs = _outputs(b, data.device)
    args = _wave_args(data, batch, now, ways, b, ptrs, page_map, gpp)
    if fn(ctypes.byref(args), _LAYOUT_CODE[layout], int(page_map is not None)) != 0:
        raise RuntimeError("decide_lane_host failed")
    return table, out, scan
