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
sums into a row that the launch before zeroed and zero the next row;
the scan is one cooperative launch that zeroes its own (T, 9) sums (one
device operation per scan) and stages each step's batch columns and
page words before the barrier that starts the step.

Every wave and sharded launch goes through `WaveFlush`, the one launch
path: one flush's batch checked once and its outputs in one
allocation, whose sums block one memset zeroes, the table checked once
per engine (`TableMemo`), the decisions read back behind one CUDA
event. Per wave that leaves pointer arithmetic, one argument struct
and the C call. The one-wave wrappers (`decide_flat`, `decide_paged`,
`decide_sharded` and their `_with_scan` forms) are a flush of one wave
whose outputs are viewed back as a `DecideOutput`.

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
calling thread alone. The GLOBAL replica tier's waves (parallel/ici.py)
are sharded launches over the stacked replicas, counted apart under
`replica_name`.
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
CODECS = {"fused": fused.FUSED_CODEC, "narrow": narrow.NARROW_CODEC}


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


def replica_name(layout: str) -> str:
    """Name under which the sharded kernel counts its launches in the
    replica geometry of the GLOBAL tier (parallel/ici.py): D stacked
    replicas as D shards, each lane's group column the pair home *
    num_rgroups + slot. "decide_wave_replica" (fused) or
    "decide_wave_replica_narrow"."""
    return "decide_wave_replica" + ("_narrow" if layout == "narrow" else "")


CONFIGS = tuple(
    config_name(lay, p, sc) for sc in (False, True) for p in (False, True)
    for lay in _LAYOUT_CODE
) + tuple(sharded_name(lay) for lay in _LAYOUT_CODE) + tuple(
    replica_name(lay) for lay in _LAYOUT_CODE)

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
    ncols = CODECS[layout].ncols
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


def _wave_args(data, batch, now, ways, b, ptrs, page_map, gpp) -> _WaveArgs:
    """The arguments of a scan, or of a wave run by the lane code on the
    host: `ptrs` as `_outputs` gives them, no next sums row."""
    cols = [getattr(batch, f).data_ptr() for f in _BATCH_DTYPES]
    paged = page_map is not None
    return _WaveArgs(
        data.data_ptr(), *cols, *(t.data_ptr() if t is not None else None for t in ptrs),
        page_map.data_ptr() if paged else None, None,
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
    if dev.type == "cpu":
        _check(data, batch, ways, layout, page_map, gpp)
        return fused.wave_plain(
            CODECS[layout], data, page_map, batch, now, ways=ways, gpp=gpp
        )
    return _one_wave(data, page_map, batch, now, layout=layout, ways=ways, gpp=gpp)


def _one_wave(data, page_map, batch, now, *, layout, ways, gpp, n_shards=0):
    """A one-wave wrapper on the card: a `WaveFlush` of one span (its
    batch and the table checked, its sums row zeroed by the flush's
    memset), launched, its outputs viewed back as (out, scan)."""
    flush = WaveFlush(batch, None, TableMemo())
    flush.launch(0, data, page_map, now, layout=layout, ways=ways, gpp=gpp, n_shards=n_shards)
    return flush.wave_outputs(0, torch.int32 if n_shards else torch.bool)


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
            CODECS[layout], data, page_map, batches, nows, ways=ways, gpp=gpp
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


class TableMemo:
    """The table an engine's waves last ran on, validated: `check` runs
    the table checks of `_wave` (and of `decide_sharded` with
    `n_shards`) again only when the table's identity changes (its
    tensor, storage, shape or page map, the layout, ways, page geometry
    or shard count). One per engine."""

    __slots__ = ("key", "groups_per_shard")

    def __init__(self):
        self.key = None
        self.groups_per_shard = 0

    def check(self, data, page_map, *, layout, ways, gpp, n_shards) -> None:
        key = (id(data), data.data_ptr(), data.shape, id(page_map), layout, ways,
               gpp, n_shards)
        if key == self.key:
            return
        _check_table(data, ways, layout, page_map, gpp)
        if data.device.type == "cuda":
            _check_vector_rows(data, layout)
        self.groups_per_shard = _check_shards(data, n_shards, ways) if n_shards else 0
        self.key = key


# Sums of a wave in a flush's outputs: (hits, misses, unexpired
# evictions, over-limit) at _S_HITS.._S_OVER, then the WaveScan sums.
class WaveFlush:
    """The waves of one flush, run one after another over one table:
    the launch path of the engine (`runtime/engine.py`) and of the
    one-wave wrappers (a flush of one wave).

    `batch` holds every wave's lanes on the table's device (one
    host-to-device copy, `batch_to_device`), wave w the contiguous span
    `spans[w] = (offset, width)` of every column (None: one wave of all
    of them); its columns are checked once, here. The outputs of all
    the waves are ONE allocation,
    wave w a span of each output column and row w of a (W + 1, 9) sums
    block, zeroed once here (wave w adds into row w and zeroes row w + 1,
    already zero: the kernels' chain of sums stays inside the flush).
    The table is checked by the engine's `TableMemo`, again only when it
    changed. So a wave's launch on the card is pointer arithmetic, one
    argument struct and the C call, on the stream current when the
    flush was made.

    `read_back` queues, after the last wave, one copy of what the host
    reads (status, limit, remaining, reset_time and the sums) into
    pinned host memory and records one CUDA event; `host()` waits on
    that event only, never on the stream or the device. The flush keeps
    its device outputs referenced until then. On a CPU table each wave
    runs the plain version into the same spans, and `host()` reads the
    outputs in place."""

    _INT64_READ = 3  # limit, remaining, reset_time: read back
    _INT64_REST = 3  # slot, evicted_hi, evicted_lo: device only

    def __init__(self, batch: RequestBatch, spans, memo: TableMemo):
        dev = batch.key_hi.device
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"decide runs on cuda or cpu, not {dev}")
        (lanes,) = _check_batch(batch, dev, 1)
        if spans is None:
            spans = [(0, lanes)]
        for off, b in spans:
            if off < 0 or b < 0 or off + b > lanes:
                raise ValueError(f"wave span ({off}, {b}) outside the batch's {lanes} lanes")
        self.batch, self.spans, self.memo = batch, list(spans), memo
        self.device = dev
        n_w = len(self.spans)
        self._lanes = lanes
        # [limit, remaining, reset_time | sums | status | pad | slot, ehi, elo | freed]
        n_read_i64 = self._INT64_READ * lanes + (n_w + 1) * N_SCAL
        self._read_bytes = 8 * n_read_i64 + lanes
        rest_at = -(-self._read_bytes // 8) * 8
        self._freed_at = rest_at + 8 * self._INT64_REST * lanes
        buf = torch.empty(self._freed_at + 4 * lanes, dtype=torch.uint8, device=dev)
        self._buf = buf
        read = buf[:8 * n_read_i64].view(torch.int64)
        self.limit, self.remaining, self.reset_time = (
            read[k * lanes:(k + 1) * lanes] for k in range(self._INT64_READ))
        self.sums = read[self._INT64_READ * lanes:].view(n_w + 1, N_SCAL)
        self.status = buf[8 * n_read_i64:self._read_bytes].view(torch.int8)
        rest = buf[rest_at:self._freed_at].view(torch.int64)
        self.slot, self.evicted_hi, self.evicted_lo = (
            rest[k * lanes:(k + 1) * lanes] for k in range(self._INT64_REST))
        self.sums.zero_()
        self._host = None
        self._event = None
        self._stream = torch.cuda.current_stream(dev).cuda_stream if dev.type == "cuda" else None
        # the lane columns' and outputs' base addresses, in kernel order
        self._cols = [(getattr(batch, f).data_ptr(), getattr(batch, f).element_size())
                      for f in _BATCH_DTYPES]
        self._outs = [(t.data_ptr(), t.element_size()) for t in (
            self.status, self.limit, self.remaining, self.reset_time, self.slot,
            self.evicted_hi, self.evicted_lo)]
        self._sums_ptr = self.sums.data_ptr()
        self._freed_ptr = buf.data_ptr() + self._freed_at

    def freed(self, dtype=torch.bool) -> torch.Tensor:
        """The `freed` column: bool from the wave kernel, int32 from the
        sharded one (the psum's type)."""
        n = self._lanes * (4 if dtype == torch.int32 else 1)
        return self._buf[self._freed_at:self._freed_at + n].view(dtype)

    def wave_batch(self, w: int) -> RequestBatch:
        off, b = self.spans[w]
        return RequestBatch(*(c[off:off + b] for c in self.batch))

    def wave_outputs(self, w: int, freed_dtype=torch.bool) -> Tuple[DecideOutput, WaveScan]:
        """Wave w's outputs, views of the flush's, as the one-wave
        wrappers return them: (DecideOutput, WaveScan)."""
        off, b = self.spans[w]
        s = slice(off, off + b)
        row = self.sums[w]
        out = DecideOutput(
            status=self.status[s], limit=self.limit[s], remaining=self.remaining[s],
            reset_time=self.reset_time[s], slot=self.slot[s], evicted_hi=self.evicted_hi[s],
            evicted_lo=self.evicted_lo[s], freed=self.freed(freed_dtype)[s],
            hits=row[_S_HITS], misses=row[_S_MISSES], unexpired_evictions=row[_S_EVICTS],
            over_limit=row[_S_OVER],
        )
        return out, WaveScan(*(row[k] for k in range(4, N_SCAL)))

    def launch(self, w: int, data, page_map, now: int, *, layout: str, ways: int,
               gpp: int = 0, n_shards: int = 0, replica: bool = False) -> None:
        """Wave w over the rows `data` (the layout's table; a paged
        table's frames with its `page_map`), in place, into the flush's
        outputs: the wave kernel, or with `n_shards` the sharded kernel
        over that many shards. With `replica` the sharded launch counts
        as a replica wave of the GLOBAL tier (`replica_name`): the same
        kernel over stacked replicas. CPU rows: the plain version."""
        if data.device != self.device:
            raise ValueError(f"the table is on {data.device}, the flush on {self.device}")
        off, b = self.spans[w]
        if self.device.type == "cpu":
            wb = self.wave_batch(w)
            if n_shards:
                out, scan = decide_sharded(data, page_map, wb, now, layout=layout, ways=ways,
                                           n_shards=n_shards, gpp=gpp)
            else:
                out, scan = _wave(data, page_map, wb, now, layout=layout, ways=ways, gpp=gpp)
            self._store(w, off, b, out, scan)
            return
        self.memo.check(data, page_map, layout=layout, ways=ways, gpp=gpp, n_shards=n_shards)
        if b == 0:
            return  # nothing to launch; its sums row stays zero
        lib = _decide_lib()
        paged = int(page_map is not None)
        args = self.args(w, data, page_map, now, ways=ways, gpp=gpp, n_shards=n_shards)
        if n_shards:
            name = replica_name(layout) if replica else sharded_name(layout)
            rc = lib.guber_decide_sharded(ctypes.byref(args), _LAYOUT_CODE[layout], paged,
                                          self._stream)
        else:
            name = config_name(layout, bool(paged))
            rc = lib.guber_decide_wave(ctypes.byref(args), _LAYOUT_CODE[layout], paged,
                                       self._stream)
        if rc != 0:
            msg = lib.guber_cuda_error_string(rc).decode()
            raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")
        _count(name)

    def args(self, w: int, data, page_map, now: int, *, ways: int, gpp: int = 0,
             n_shards: int = 0):
        """Wave w's kernel arguments over checked rows `data`: a
        `_WaveArgs`, or with `n_shards` a `_ShardArgs` (the groups per
        shard from the memo's check). Pointer arithmetic only."""
        off, b = self.spans[w]
        paged = page_map is not None
        wave = _WaveArgs(
            data.data_ptr(), *(p + off * s for p, s in self._cols),
            *(p + off * s for p, s in self._outs),
            None if n_shards else self._freed_ptr + off,
            self._sums_ptr + w * N_SCAL * 8,
            page_map.data_ptr() if paged else None,
            self._sums_ptr + (w + 1) * N_SCAL * 8,
            data.shape[0], int(now), ways, b,
            gpp if paged else 0, page_map.shape[0] if paged else 0,
        )
        if not n_shards:
            return wave
        gp = self.memo.groups_per_shard
        return _ShardArgs(wave, self._freed_ptr + 4 * off, gp * ways, n_shards, gp)

    def _store(self, w, off, b, out: DecideOutput, scan: WaveScan) -> None:
        s = slice(off, off + b)
        for dst, src in ((self.status, out.status), (self.limit, out.limit),
                         (self.remaining, out.remaining), (self.reset_time, out.reset_time),
                         (self.slot, out.slot), (self.evicted_hi, out.evicted_hi),
                         (self.evicted_lo, out.evicted_lo)):
            dst[s] = src
        self.freed(out.freed.dtype)[s] = out.freed
        self.sums[w] = torch.stack([
            out.hits, out.misses, out.unexpired_evictions, out.over_limit, *scan,
        ]).to(torch.int64)

    def read_back(self) -> None:
        """Queue the copy of what the host reads behind the waves (CUDA:
        into pinned memory, then one event)."""
        if self.device.type == "cpu":
            self._host = self._buf[:self._read_bytes].numpy()
            return
        host = torch.empty(self._read_bytes, dtype=torch.uint8, pin_memory=True)
        host.copy_(self._buf[:self._read_bytes], non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record()
        self._host = host.numpy()

    def host(self) -> list:
        """Per wave (status, remaining, reset_time, limit as numpy
        arrays; hits, misses, unexpired evictions, over-limit as ints),
        after the flush's event (CUDA)."""
        if self._host is None:
            raise RuntimeError("read_back() first")
        if self._event is not None:
            self._event.synchronize()
        lanes, n_w = self._lanes, len(self.spans)
        i64 = self._host[:self._read_bytes - lanes].view(np.int64)
        limit, remaining, reset_time = (i64[k * lanes:(k + 1) * lanes] for k in range(3))
        sums = i64[3 * lanes:].reshape(n_w + 1, N_SCAL)[:, :4].tolist()
        status = self._host[self._read_bytes - lanes:].view(np.int8)
        out = []
        for w, (off, b) in enumerate(self.spans):
            s = slice(off, off + b)
            out.append((status[s], remaining[s], reset_time[s], limit[s], *sums[w]))
        return out


def flush_lane_code_on_host(flush: WaveFlush, w: int, data, page_map, now: int, *,
                            layout: str, ways: int, gpp: int = 0, n_shards: int = 0) -> None:
    """Tests only: wave w of `flush` (CPU tensors) through the kernels'
    lane code built by g++ (as `decide_lane_code_on_host` and
    `decide_sharded_lane_code_on_host` run it), with the argument struct
    the card's launch gets (`WaveFlush.args`): the flush's spans, sums
    rows and output pointers are held against the plain version on the
    CPU. No serving path calls this."""
    if data.device.type != "cpu":
        raise ValueError("flush_lane_code_on_host takes CPU tensors")
    flush.memo.check(data, page_map, layout=layout, ways=ways, gpp=gpp, n_shards=n_shards)
    lib = _build.load("decide_lane_host")
    fn = lib.guber_decide_sharded_host if n_shards else lib.guber_decide_wave_host
    fn.argtypes = [ctypes.POINTER(_ShardArgs if n_shards else _WaveArgs), ctypes.c_int,
                   ctypes.c_int]
    fn.restype = ctypes.c_int
    args = flush.args(w, data, page_map, now, ways=ways, gpp=gpp, n_shards=n_shards)
    rc = fn(ctypes.byref(args), _LAYOUT_CODE[layout], int(page_map is not None))
    if rc != 0:
        raise RuntimeError(f"decide_lane_host failed ({rc})")


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


def team_size(ways: int) -> int:
    """T, the threads of a lane's team (decide_lane.cuh team_size): the
    smallest power of two >= ways, at most 32."""
    t = 1
    while t < ways and t < 32:
        t <<= 1
    return t


def lanes_per_block(ways: int) -> int:
    """Lanes a block of the wave and sharded kernels holds: 128 threads
    (decide_lane.cuh TEAM_THREADS) over the team's width."""
    return 128 // team_size(ways)


def scan_items(batch: int, ways: int, threads: int = 128) -> int:
    """Items of a scan step (decide_lane.cuh scan_plan): blocks' worth of
    `threads` threads, a team of T per lane."""
    return -(-batch // (threads // team_size(ways)))


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


def _shard_args(data, batch, now, ways, b, ptrs, page_map, gpp, n_shards, gp) -> _ShardArgs:
    """The sharded wave's arguments for the lane code on the host: the
    wave's, whose bool `freed` pointer is left null, and the int32
    `freed` and the shard geometry."""
    wave = _wave_args(data, batch, now, ways, b, ptrs[:7] + [None, ptrs[8]], page_map, gpp)
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
    if dev.type == "cpu":
        _check(data, batch, ways, layout, page_map, gpp)
        _check_shards(data, n_shards, ways)
        return fused.sharded_plain(
            CODECS[layout], data, page_map, batch, now, ways=ways,
            n_shards=n_shards, gpp=gpp,
        )
    return _one_wave(data, page_map, batch, now, layout=layout, ways=ways, gpp=gpp,
                     n_shards=n_shards)


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

