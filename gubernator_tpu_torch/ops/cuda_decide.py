"""The decide wave on Hopper: wrappers of the CUDA kernels in
`csrc/decide_wave.cu` (one wave), `csrc/decide_scan.cu` (T waves in
one cooperative launch) and `csrc/decide_sharded.cu` (one wave over an
owner-sharded table), built into one library.

Counterpart of `gubernator_tpu/ops/pallas_decide.py` (`decide_flat`,
`decide_flat_with_scan`, `decide_paged`, `decide_paged_with_scan`, the
scans `decide_scan_flat`, `decide_scan_paged`, and `raw_decide_flat` as
`parallel/mesh.py` composes it inside `shard_map`) for the fused and
narrow layouts. The wave and scan kernels replace that module's
`_make_kernel` (one wave, or a `lax.scan` of waves) on a flat table or
a paged one; the sharded kernel replaces the mesh tier's per-shard
`raw_decide_flat` and the psum over the shards, on a flat mesh table or
a paged mesh's frames. See the sources for their design and bound:
every kernel runs a team of threads per lane (the ways rounded up to a
power of two, at most 32). The wave and sharded kernels add their 9
sums into a buffer that the launch before on the same stream zeroed
(one device operation per wave; the wrapper keeps each stream's chain
of buffers, `_launch_summed`); the scan is one cooperative launch that
zeroes its own (T, 9) sums (one device operation per scan) and stages
each step's batch columns and page words before the barrier that
starts the step.

Dispatch is by the table's device and nothing else:

- a CPU table runs the plain PyTorch version of the same configuration
  (`ops/fused.py::wave_plain`, `scan_plain`, `sharded_plain`);
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

import numpy as np
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


def config_name(layout: str, paged: bool, scan: bool = False) -> str:
    """Name of one kernel configuration: "decide_wave" (fused, flat),
    "decide_wave_narrow", "decide_wave_paged", "decide_wave_narrow_paged";
    with `scan`, the same four of "decide_scan"."""
    return ("decide_scan" if scan else "decide_wave") + (
        "_narrow" if layout == "narrow" else ""
    ) + ("_paged" if paged else "")


def sharded_name(layout: str) -> str:
    """Name of the sharded wave kernel of `layout`: "decide_wave_sharded"
    (fused) or "decide_wave_sharded_narrow", flat or paged mesh alike."""
    return "decide_wave_sharded" + ("_narrow" if layout == "narrow" else "")


CONFIGS = tuple(
    config_name(lay, p, sc) for sc in (False, True) for p in (False, True)
    for lay in _LAYOUT_CODE
) + tuple(sharded_name(lay) for lay in _LAYOUT_CODE)

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
        ("scalars", _P), ("page_map", _P), ("next_scalars", _P),
        ("n_slots", ctypes.c_int64),
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


class _ScanArgs(ctypes.Structure):
    """Mirror of `GuberScanArgs` in csrc/decide_lane.cuh."""

    _fields_ = [("wave", _WaveArgs), ("nows", _P), ("barrier", _P), ("steps", ctypes.c_int32)]


class _ShardArgs(ctypes.Structure):
    """Mirror of `GuberShardArgs` in csrc/decide_lane.cuh."""

    _fields_ = [
        ("wave", _WaveArgs), ("out_freed", _P), ("n_local", ctypes.c_int64),
        ("n_shards", ctypes.c_int32), ("groups_per", ctypes.c_int32),
    ]


def _check_table(data, ways: int, layout: str, page_map: Optional[torch.Tensor],
                 gpp: int) -> None:
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


def _check_batch(batch: RequestBatch, dev, ndim: int) -> Tuple[int, ...]:
    """Every column a contiguous tensor on `dev` of its dtype and of one
    shape, (B,) or (T, B) by `ndim`; returns that shape."""
    shape = tuple(batch.key_hi.shape)
    if len(shape) != ndim or shape[-1] >= 1 << 31:
        raise ValueError(f"batch columns must be {'(B,)' if ndim == 1 else '(T, B)'}, B < 2^31, got {shape}")
    for f, dt in _BATCH_DTYPES.items():
        t = getattr(batch, f)
        if not torch.is_tensor(t) or t.device != dev:
            raise ValueError(f"batch.{f} must be a tensor on {dev}")
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"batch.{f} must be contiguous {shape} {dt}, got {tuple(t.shape)} {t.dtype}")
    return shape


def _check(data, batch: RequestBatch, ways: int, layout: str,
           page_map: Optional[torch.Tensor], gpp: int) -> int:
    """Validate what the wave kernel takes; returns the lane count."""
    _check_table(data, ways, layout, page_map, gpp)
    return _check_batch(batch, data.device, 1)[0]


def _check_scan(data, batches: RequestBatch, nows, ways: int, layout: str,
                page_map: Optional[torch.Tensor], gpp: int):
    """Validate what the scan kernel takes: (T, B) batch columns and T
    `nows` (a tensor of int64, or anything numpy reads as integers),
    returned as a contiguous (T,) int64 tensor on the table's device.
    Returns (T, B, nows)."""
    _check_table(data, ways, layout, page_map, gpp)
    steps, b = _check_batch(batches, data.device, 2)
    if not torch.is_tensor(nows):
        nows = torch.from_numpy(np.asarray(nows, dtype=np.int64).reshape(-1))
    if nows.dtype != torch.int64 or tuple(nows.shape) != (steps,):
        raise ValueError(f"nows must be ({steps},) int64, got {tuple(nows.shape)} {nows.dtype}")
    return steps, b, nows.to(data.device).contiguous()


def _outputs(shape, dev, freed_dtype=torch.bool, scal=None):
    """Kernel outputs for lanes of `shape`, (B,) or (T, B): the lane
    fields, and the 9 sums as (9,) or (T, 9) (`scal` if given, else
    new) with the DecideOutput and WaveScan sums viewed out of it; plus
    the pointers in kernel order. `freed` is bool, or int32 for a
    sharded wave (the psum's type)."""
    i64 = dict(dtype=torch.int64, device=dev)
    limit, remaining, reset_time, slot, ehi, elo = (torch.empty(shape, **i64) for _ in range(6))
    status = torch.empty(shape, dtype=torch.int8, device=dev)
    freed = torch.empty(shape, dtype=freed_dtype, device=dev)
    if scal is None:
        scal = torch.empty(tuple(shape[:-1]) + (N_SCAL,), **i64)
    out = DecideOutput(
        status=status, limit=limit, remaining=remaining, reset_time=reset_time,
        slot=slot, evicted_hi=ehi, evicted_lo=elo, freed=freed,
        hits=scal[..., _S_HITS], misses=scal[..., _S_MISSES],
        unexpired_evictions=scal[..., _S_EVICTS], over_limit=scal[..., _S_OVER],
    )
    scan = WaveScan(*(scal[..., k] for k in range(4, N_SCAL)))
    ptrs = [status, limit, remaining, reset_time, slot, ehi, elo, freed, scal]
    return out, scan, ptrs


def _wave_args(data, batch, now, ways, b, ptrs, page_map, gpp, next_scal=None) -> _WaveArgs:
    """The wave's arguments: `ptrs` as `_outputs` gives them, and the
    (9,) sums the launch zeroes for the stream's next one (the wave and
    sharded kernels only)."""
    cols = [getattr(batch, f).data_ptr() for f in _BATCH_DTYPES]
    paged = page_map is not None
    return _WaveArgs(
        data.data_ptr(), *cols, *(t.data_ptr() if t is not None else None for t in ptrs),
        page_map.data_ptr() if paged else None,
        next_scal.data_ptr() if next_scal is not None else None,
        data.shape[0], int(now), ways, b,
        gpp if paged else 0, page_map.shape[0] if paged else 0,
    )


def _decide_lib() -> ctypes.CDLL:
    """The library of the kernels (csrc/decide_wave.cu, decide_scan.cu
    and decide_sharded.cu), built first if needed."""
    lib = _build.load("decide_cuda")
    if lib.guber_decide_wave.argtypes is None:
        lib.guber_decide_wave.argtypes = [
            ctypes.POINTER(_WaveArgs), ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.guber_decide_wave.restype = ctypes.c_int
        lib.guber_decide_scan.argtypes = [
            ctypes.POINTER(_ScanArgs), ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.guber_decide_scan.restype = ctypes.c_int
        lib.guber_decide_scan_grid.argtypes = [
            ctypes.POINTER(_ScanArgs), ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.guber_decide_scan_grid.restype = ctypes.c_int
        lib.guber_decide_sharded.argtypes = [
            ctypes.POINTER(_ShardArgs), ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.guber_decide_sharded.restype = ctypes.c_int
        lib.guber_cuda_error_string.argtypes = [ctypes.c_int]
        lib.guber_cuda_error_string.restype = ctypes.c_char_p
    return lib


def load(device) -> None:
    """Build/load what a decide or a scan on `device` needs (nothing for
    the CPU), so a build failure surfaces at engine construction."""
    if torch.device(device).type == "cuda":
        _decide_lib()


def _count(name: str) -> None:
    CONFIG_LAUNCHES[name] += 1
    _tls.launches = thread_launches() + 1


# (device index, stream handle) -> the zeroed (9,) sums of the next wave
# or sharded launch on that stream
_SUMS = {}
_sums_lock = threading.Lock()


def _launch_summed(dev, shape, freed_dtype, launch):
    """One wave or sharded launch on the current stream of `dev` with
    its sums chained: the launch adds its 9 sums into the stream's zeroed
    buffer (made zero here for the stream's first launch) and zeroes a
    new one, which becomes the stream's buffer for its next launch (the
    kernel does both: no memset, one device operation per wave). One
    lock holds the chain from the buffer's taking to the launch, so two
    host threads on one stream never add into one buffer, and each
    stream has its own chain. `launch(stream, ptrs, next_scal)` returns
    the C call's code; returns (out, scan, code)."""
    with torch.cuda.device(dev), _sums_lock:
        stream = torch.cuda.current_stream(dev).cuda_stream
        key = (dev.index, stream)
        scal = _SUMS.get(key)
        if scal is None:
            scal = torch.zeros(N_SCAL, dtype=torch.int64, device=dev)
        nxt = torch.empty(N_SCAL, dtype=torch.int64, device=dev)
        out, scan, ptrs = _outputs(shape, dev, freed_dtype, scal)
        rc = launch(stream, ptrs, nxt)
        # a refused launch ran nothing: the stream keeps its zeroed buffer
        _SUMS[key] = nxt if rc == 0 else scal
    return out, scan, rc


def _check_vector_rows(data, layout: str) -> None:
    """The wave and sharded kernels read and write a fused row as five
    16-byte vectors: the table must start on a 16-byte boundary (every
    torch allocation does; an offset view may not)."""
    if layout == "fused" and data.data_ptr() % 16:
        raise ValueError("a fused table on the card must start at a 16-byte boundary")


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
    _check_vector_rows(data, layout)
    if b == 0:
        out, scan, ptrs = _outputs((b,), dev)
        ptrs[8].zero_()
        return out, scan
    paged = page_map is not None

    def launch(stream, ptrs, nxt):
        args = _wave_args(data, batch, now, ways, b, ptrs, page_map, gpp, nxt)
        return lib.guber_decide_wave(
            ctypes.byref(args), _LAYOUT_CODE[layout], int(paged), stream
        )

    out, scan, rc = _launch_summed(dev, (b,), torch.bool, launch)
    if rc != 0:
        msg = lib.guber_cuda_error_string(rc).decode()
        raise RuntimeError(
            f"{config_name(layout, paged)} launch failed: CUDA error {rc} ({msg})"
        )
    _count(config_name(layout, paged))
    return out, scan


def _scan(data, page_map, batches, nows, *, layout, ways, gpp) -> DecideOutput:
    """A scan of T waves of configuration (layout, paged = page_map
    given) over the rows `data`, in place, as ONE kernel launch and no
    other device operation (the kernel zeroes its own sums): the stacked
    outputs, (T, B) lanes and (T,) sums. T = 0 launches nothing."""
    dev = data.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"decide runs on cuda or cpu, not {dev}")
    steps, b, nows = _check_scan(data, batches, nows, ways, layout, page_map, gpp)
    if dev.type == "cpu":
        return fused.scan_plain(
            _CODECS[layout], data, page_map, batches, nows, ways=ways, gpp=gpp
        )
    lib = _decide_lib()
    _check_vector_rows(data, layout)
    if steps == 0:
        return _outputs((steps, b), dev)[0]
    # the (T, 9) sums and, after them, the word of the kernel's grid
    # barrier: one allocation, nothing to initialise
    buf = torch.empty(steps * N_SCAL + 1, dtype=torch.int64, device=dev)
    out, _scan_sums, ptrs = _outputs((steps, b), dev, scal=buf[:-1].view(steps, N_SCAL))
    args = _ScanArgs(
        _wave_args(data, batches, 0, ways, b, ptrs, page_map, gpp),
        nows.data_ptr(), buf[-1:].data_ptr(), steps,
    )
    paged = page_map is not None
    name = config_name(layout, paged, scan=True)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.guber_decide_scan(
            ctypes.byref(args), _LAYOUT_CODE[layout], int(paged), stream
        )
    if rc != 0:
        msg = lib.guber_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")
    _count(name)
    return out


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
    """Tests only: the wave kernel's lane code (csrc/decide_lane.cuh)
    built by g++ and run lane after lane on CPU tensors, in the
    configuration (layout, paged = `page_map` given), each lane's team
    of threads emulated (its members' candidates and rows,
    the butterfly's combine calls in the device's order, the owner's
    finish), so the CPU test suite checks the kernel's own selection and
    arithmetic against the plain version. `table` is the layout table
    (for a paged table, its frames). No serving path calls this."""
    data = table.data
    if data.device.type != "cpu":
        raise ValueError("decide_lane_code_on_host takes CPU tensors")
    b = _check(data, batch, ways, layout, page_map, gpp)
    lib = _build.load("decide_lane_host")
    fn = lib.guber_decide_wave_host
    fn.argtypes = [ctypes.POINTER(_WaveArgs), ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    out, scan, ptrs = _outputs((b,), data.device)
    args = _wave_args(data, batch, now, ways, b, ptrs, page_map, gpp)
    rc = fn(ctypes.byref(args), _LAYOUT_CODE[layout], int(page_map is not None))
    if rc != 0:
        raise RuntimeError(f"decide_lane_host failed ({rc}: 2 is a lane whose team has no single owner)")
    return table, out, scan


def decide_scan_flat(
    table, batches: RequestBatch, nows, *, layout: str = "fused",
    ways: int = DEFAULT_WAYS,
) -> Tuple[object, DecideOutput]:
    """T decide waves on a flat table of `layout`, in order, the table
    carried from step to step: (table, (T, B) batches, (T,) nows) ->
    (table, outputs stacked (T, B) and (T,)), the table updated in place.
    The counterpart of `pallas_decide.decide_scan_flat`. CPU table: the
    plain version (`scan_plain`). CUDA table: the scan kernel, ONE
    launch on PyTorch's current stream, without synchronising."""
    out = _scan(table.data, None, batches, nows, layout=layout, ways=ways, gpp=0)
    return table, out


def decide_scan_paged(
    pt, batches: RequestBatch, nows, *, layout: str, ways: int, gpp: int
) -> Tuple[object, DecideOutput]:
    """`decide_scan_flat` on a paged table, the page-map lookup inside
    the kernel (Pallas sentinel semantics for lanes on non-resident
    pages); the page map is left as it is. The counterpart of
    `pallas_decide.decide_scan_paged`."""
    out = _scan(
        pt.data.data, pt.page_map, batches, nows, layout=layout, ways=ways, gpp=gpp
    )
    return pt, out


def scan_grid(device, batch: int, *, layout: str, ways: int, paged: bool) -> Tuple[int, int]:
    """(threads per block, blocks) of the scan kernel of configuration
    (layout, paged) on CUDA `device` for steps of `batch` lanes: 128
    threads while `scan_items(batch, ways, 128)` fit one block per SM,
    else 256; then min(items, co-resident blocks). Fewer blocks than
    `scan_items(batch, ways, threads)` means the blocks stride over a
    step's lanes."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("scan_grid asks the card: device must be CUDA")
    lib = _decide_lib()
    args = _ScanArgs(_WaveArgs(ways=ways, batch=batch), None, None, 1)
    threads, blocks = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = lib.guber_decide_scan_grid(ctypes.byref(args), _LAYOUT_CODE[layout], int(paged),
                                        ctypes.byref(threads), ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"scan grid query failed: CUDA error {rc}")
    return threads.value, blocks.value


def scan_items(batch: int, ways: int, threads: int = 128) -> int:
    """Items of a scan step (decide_lane.cuh scan_plan): blocks' worth of
    `threads` threads, a team of T per lane (T the smallest power of two
    >= ways, at most 32)."""
    t = 1
    while t < ways and t < 32:
        t <<= 1
    return -(-batch // (threads // t))


def decide_scan_lane_code_on_host(
    table, batches: RequestBatch, nows, *, ways: int = DEFAULT_WAYS,
    layout: str = "fused", page_map: Optional[torch.Tensor] = None, gpp: int = 0,
    blocks: Optional[int] = None, threads: int = 128,
) -> Tuple[object, DecideOutput]:
    """Tests only: the scan kernel's data flow (csrc/decide_scan.cu:
    `scan_plan`, the stage, `step_args`, each lane's team emulated as
    `decide_lane_code_on_host` runs it, the per-step sums) built by g++
    from csrc/decide_lane.cuh and run on CPU tensors as a grid of
    `blocks` blocks of `threads` threads (128 or 256) would run it
    (default `scan_items(B, ways, threads)`, one item per block and step;
    fewer make the blocks stride). Same
    arguments as `decide_scan_flat` (plus `page_map`/`gpp` for a paged
    table's frames). Raises if a lane's team has no single owner. No
    serving path calls this."""
    data = table.data
    if data.device.type != "cpu":
        raise ValueError("decide_scan_lane_code_on_host takes CPU tensors")
    steps, b, nows = _check_scan(data, batches, nows, ways, layout, page_map, gpp)
    lib = _build.load("decide_lane_host")
    fn = lib.guber_decide_scan_host
    fn.argtypes = [ctypes.POINTER(_ScanArgs), ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int]
    fn.restype = ctypes.c_int
    out, _sums, ptrs = _outputs((steps, b), data.device)
    if steps == 0:
        return table, out
    grid = max(1, scan_items(b, ways, threads)) if blocks is None else blocks
    args = _ScanArgs(
        _wave_args(data, batches, 0, ways, b, ptrs, page_map, gpp),
        nows.data_ptr(), None, steps,
    )
    rc = fn(ctypes.byref(args), _LAYOUT_CODE[layout], int(page_map is not None), grid, threads)
    if rc != 0:
        raise RuntimeError(f"decide_lane_host scan failed ({rc}: 2 is a lane whose team has no single owner)")
    return table, out


def _check_shards(data, n_shards: int, ways: int) -> int:
    """Validate the shard geometry of a sharded wave's table; returns the
    groups per shard."""
    if n_shards < 1 or data.shape[0] % (n_shards * ways):
        raise ValueError(
            f"table rows {data.shape[0]} do not split into {n_shards} shards of whole groups"
        )
    gp = data.shape[0] // ways // n_shards
    if gp * n_shards >= 1 << 31:
        raise ValueError(f"{gp * n_shards} groups: the group column is int32")
    return gp


def _shard_args(data, batch, now, ways, b, ptrs, page_map, gpp, n_shards, gp,
                next_scal=None) -> _ShardArgs:
    """The sharded wave's arguments: the wave's, whose bool `freed`
    pointer is left null, and the int32 `freed` and the shard geometry."""
    wave = _wave_args(data, batch, now, ways, b, ptrs[:7] + [None, ptrs[8]], page_map, gpp,
                      next_scal)
    return _ShardArgs(wave, ptrs[7].data_ptr(), gp * ways, n_shards, gp)


def decide_sharded(
    data, page_map, batch: RequestBatch, now: int, *, layout: str, ways: int,
    n_shards: int, gpp: int = 0,
) -> Tuple[DecideOutput, WaveScan]:
    """One owner-sharded wave over the (N, C) rows `data`, split into
    `n_shards` equal shards of contiguous groups, updated in place: what
    `parallel/mesh.py` computes with `shard_map` over `raw_decide_flat`
    and a psum (the owner's answer; `slot` and `freed` as the psum
    gives them, `freed` int32). With `page_map` the rows are a paged
    mesh's frames and each lane's group goes through the map first
    (`_xlate`); a lane on a page that is not resident is owned by no
    shard. CPU rows: the plain version (`fused.sharded_plain`). CUDA
    rows: the sharded kernel, ONE launch for all the shards, on PyTorch's
    current stream, without synchronising."""
    dev = data.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"decide runs on cuda or cpu, not {dev}")
    b = _check(data, batch, ways, layout, page_map, gpp)
    gp = _check_shards(data, n_shards, ways)
    if dev.type == "cpu":
        return fused.sharded_plain(
            _CODECS[layout], data, page_map, batch, now, ways=ways,
            n_shards=n_shards, gpp=gpp,
        )
    lib = _decide_lib()
    _check_vector_rows(data, layout)
    if b == 0:
        out, scan, ptrs = _outputs((b,), dev, torch.int32)
        ptrs[8].zero_()
        return out, scan
    name = sharded_name(layout)

    def launch(stream, ptrs, nxt):
        args = _shard_args(data, batch, now, ways, b, ptrs, page_map, gpp, n_shards, gp, nxt)
        return lib.guber_decide_sharded(
            ctypes.byref(args), _LAYOUT_CODE[layout], int(page_map is not None), stream
        )

    out, scan, rc = _launch_summed(dev, (b,), torch.int32, launch)
    if rc != 0:
        msg = lib.guber_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")
    _count(name)
    return out, scan


def decide_sharded_lane_code_on_host(
    data, page_map, batch: RequestBatch, now: int, *, layout: str, ways: int,
    n_shards: int, gpp: int = 0,
) -> Tuple[DecideOutput, WaveScan]:
    """Tests only: the sharded kernel's ownership prologue, lane code
    (the team emulated, as `decide_lane_code_on_host` runs it) and psum
    epilogue (`shard_lane`, `shard_view`, `store_lane_sharded`,
    csrc/decide_lane.cuh) built by g++ and run lane after lane on CPU
    tensors. Same arguments as `decide_sharded`. No serving path calls
    this."""
    if data.device.type != "cpu":
        raise ValueError("decide_sharded_lane_code_on_host takes CPU tensors")
    b = _check(data, batch, ways, layout, page_map, gpp)
    gp = _check_shards(data, n_shards, ways)
    lib = _build.load("decide_lane_host")
    fn = lib.guber_decide_sharded_host
    fn.argtypes = [ctypes.POINTER(_ShardArgs), ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    out, scan, ptrs = _outputs((b,), data.device, torch.int32)
    args = _shard_args(data, batch, now, ways, b, ptrs, page_map, gpp, n_shards, gp)
    rc = fn(ctypes.byref(args), _LAYOUT_CODE[layout], int(page_map is not None))
    if rc != 0:
        raise RuntimeError(f"decide_lane_host sharded wave failed ({rc}: 2 is a lane whose team has no single owner)")
    return out, scan


def select_on_host(scores, live) -> Tuple[Tuple[int, int, int], Tuple[int, int, int]]:
    """Tests only: the way selection over `len(scores)` candidates
    (int64 insertion scores, bool live matches) as a serial fold and as
    the kernels' team (member folds, then the emulated
    butterfly) compute it, each as (score, insert way, first live way
    or 2^31 - 1), from the g++ build of csrc/decide_lane.cuh."""
    scores = np.ascontiguousarray(scores, dtype=np.int64)
    live = np.ascontiguousarray(live, dtype=np.uint8)
    if scores.shape != live.shape or scores.ndim != 1 or not 1 <= scores.size < 1 << 31:
        raise ValueError("scores and live must be (W,), W >= 1")
    fn = _build.load("decide_lane_host").guber_select_host
    fn.argtypes = [_P, _P, ctypes.c_int, _P]
    fn.restype = ctypes.c_int
    out = np.zeros(6, np.int64)
    if fn(scores.ctypes.data, live.ctypes.data, scores.size, out.ctypes.data) != 0:
        raise RuntimeError("the team's members disagree on the selection")
    return tuple(int(v) for v in out[:3]), tuple(int(v) for v in out[3:])

