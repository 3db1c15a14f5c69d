"""Paged slot table: the physical table behind a device page map.

The port of `gubernator_tpu/ops/paged.py`. The physical table holds
`num_phys_pages` frames of `groups_per_page` contiguous groups; a
device-resident int32 page map routes every logical group:

    logical group g
      -> logical page   lp = g // groups_per_page
      -> physical frame pp = page_map[lp]         (-1: not resident)
      -> physical group pp * groups_per_page + g % groups_per_page

The decide wave does that lookup inside the CUDA kernel
(`cuda_decide.decide_paged`, the counterpart of `pallas_decide.
decide_paged`, and the scan `cuda_decide.decide_scan_paged`); a lane whose page is not resident is a sentinel lane
that loads and stores nothing and reports slot == N. A CPU table runs
the plain version with the same (Pallas) semantics. The runtime pager
(`runtime/pager.py`) promotes a wave's pages before the wave runs, so
sentinel lanes carry no live traffic.

The wide and packed layouts are structs of columns served by torch ops
(ops/decide.py, ops/packed.py), XLA programs in the JAX package: their
decide follows the JAX package's XLA branch (`_xlate`, then the flat
layout's op), translating the batch's groups through the map first
(`fused.xlate_groups`; a lane on a page that is not resident gets the
sentinel group, one past the frames, whose gathers clamp and whose
writes drop, as in JAX); their scan translates every step's groups at
once (the map does not change inside a scan). Their page moves copy
column by column through the layout's `to_wide` / `from_wide`.

Page moves are positional, so demote -> promote is an identity on
table state. A row layout's demote reads a frame with `read_page`: its packed rows
(one contiguous span of the layout's table), transposed on the card so
that each column is contiguous, go to a reused pinned host buffer in
ONE device-to-host copy, and are unpacked to wide host rows on the host
by the layout's own `to_wide` over CPU tensors. A promote (`write_page`)
packs wide host rows into a reused pinned buffer, column by column, and
sends them in ONE host-to-device copy, transposed into the frame on the
card, without waiting for the device. (Unpacking or packing row-major
rows on the host costs several times the copy: PERF.md, PR 8.)
`extract_page` (the JAX package's op) gathers a frame's rows as a wide
SlotTable on the table's device.

The store path's ops translate logical groups through the map first
(`fused.xlate_groups`, the JAX package's `_xlate`), then run the flat
layout's op over the frames: `inject` writes rows (a lane on a page
that is not resident writes nothing and reports no eviction),
`probe_exists` asks which keys are live (such a lane is absent), and
`gather_rows` reads physical slots (the decide's `slot`). The page ops update the table and the
device map IN PLACE on PyTorch's current stream (JAX donates and
returns new buffers); the caller keeps the pager's host mirror of the
map in step.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from gubernator_tpu_torch.ops import cuda_decide, fused
from gubernator_tpu_torch.ops.inject import inject_rows
from gubernator_tpu_torch.ops.kernels import (
    BYTES_PER_SLOT,
    KERNEL_LAYOUTS,
    get_kernels,
    torch_op_wave,
)
from gubernator_tpu_torch.ops.layout import SlotTable


class PagedTable(NamedTuple):
    """The table the engine holds in place of a flat one.

    data:     the layout's table over the PHYSICAL frames
              (num_phys_pages * groups_per_page groups).
    page_map: (num_logical_pages,) int32 on the table's device: the
              frame of each logical page, -1 when it is not resident.
    """

    data: object
    page_map: torch.Tensor

    # Wide-compatible views over the PHYSICAL table, as the layout
    # tables' own.
    @property
    def used(self) -> torch.Tensor:
        return self.data.used

    @property
    def key_hi(self) -> torch.Tensor:
        return self.data.key_hi

    @property
    def key_lo(self) -> torch.Tensor:
        return self.data.key_lo

    @property
    def num_slots(self) -> int:
        return self.data.num_slots


class PagedKernels(NamedTuple):
    """The `ops.kernels.Kernels` fields the engine calls (same names and
    signatures), plus the page ops and geometry the pager needs.
    `from_wide` raises: a paged table is restored page by page
    (`write_page`), not from one flat wide image."""

    layout: str
    create: object  # (*ignored) -> PagedTable: zeroed frames, empty map
    decide: object  # (pt, batch, now, ways) -> (pt, DecideOutput), in place
    decide_scan: object  # (pt, (T, B) batches, (T,) nows, ways) -> (pt, stacked outputs)
    run_wave: object  # (pt, WaveFlush, w, now, ways) -> pt: wave w of a flush, in place
    load: object  # (device) -> None: build what decide needs there
    to_wide: object  # pt -> SlotTable view of the PHYSICAL table
    from_wide: object  # raises NotImplementedError
    bytes_per_slot: int
    # --- the store path (ops/inject.py), logical groups ---
    inject: object  # (pt, InjectBatch on the device, now, ways) -> (pt, evicted_hi, evicted_lo)
    probe_exists: object  # (pt, key_hi, key_lo, group, now, ways) -> (B,) bool
    gather_rows: object  # (pt, physical slots) -> SlotTable rows (slot == N reads zeros)
    # --- page ops (in place; each returns the PagedTable) ---
    bind_page: object  # (pt, lp, pp) -> pt: zero frame pp, map lp -> pp
    unbind_page: object  # (pt, lp, pp) -> pt: zero frame pp, map lp -> -1
    extract_page: object  # (pt, pp) -> SlotTable rows (page_slots,), a copy
    read_page: object  # (pt, pp) -> {field: numpy (page_slots,)}: one copy to the host
    write_page: object  # (pt, lp, pp, wide rows) -> pt, map lp -> pp
    # --- geometry ---
    ways: int
    groups_per_page: int
    page_slots: int  # groups_per_page * ways
    num_phys_pages: int
    num_logical_pages: int
    num_logical_groups: int


def logical_page_of(group: int, groups_per_page: int) -> int:
    """Host-side logical-page index of one group (pager bookkeeping)."""
    return group // groups_per_page


def make_paged_kernels(
    layout: str,
    num_groups: int,
    ways: int,
    groups_per_page: int,
    num_phys_pages: int,
    device="cuda",
) -> PagedKernels:
    """The paged kernel set for `layout` with a fixed geometry.

    num_groups:      LOGICAL group count (the keyspace the engine hashes
                     into, as for a flat table).
    groups_per_page: page granularity; the last logical page may be
                     partly used when num_groups is not a multiple.
    num_phys_pages:  resident-page budget: the device holds
                     num_phys_pages * groups_per_page * ways slots.
    device:          where `create` puts the frames and the page map.
    """
    if groups_per_page <= 0:
        raise ValueError(f"groups_per_page must be > 0: {groups_per_page}")
    if num_phys_pages <= 0:
        raise ValueError(f"num_phys_pages must be > 0: {num_phys_pages}")
    base = get_kernels(layout)
    gpp = groups_per_page
    page_slots = gpp * ways
    num_logical_pages = -(-num_groups // gpp)  # ceil
    num_phys_groups = num_phys_pages * gpp

    def _check_ways(w):
        if w != ways:
            raise ValueError(f"this paged table has {ways} ways, not {w}")

    def _phys(pt, group):
        return fused.xlate_groups(pt.page_map, group, gpp, num_phys_groups)

    def _probe_exists(pt, key_hi, key_lo, group, now, w=ways):
        _check_ways(w)
        return base.probe_exists(pt.data, key_hi, key_lo, _phys(pt, group), now, ways)

    def _extract_page(pt, pp):
        dev = pt.page_map.device
        slots = int(pp) * page_slots + torch.arange(page_slots, dtype=torch.int64, device=dev)
        return base.gather_rows(pt.data, slots)

    build = _row_ops if layout in KERNEL_LAYOUTS else _column_ops
    ops = build(layout, base, ways, gpp, page_slots, num_phys_groups, _check_ways, _phys)

    def _create(*_a, **_k) -> PagedTable:
        return PagedTable(
            data=base.create(num_phys_groups, ways, device),
            page_map=torch.full((num_logical_pages,), -1, dtype=torch.int32, device=device),
        )

    def _from_wide(*_a, **_k):
        raise NotImplementedError(
            "paged tables restore page by page (write_page), not from one "
            "flat wide image: see DeviceEngine.restore's paged path"
        )

    return PagedKernels(
        layout=layout,
        create=_create,
        decide=ops["decide"],
        decide_scan=ops["decide_scan"],
        run_wave=ops["run_wave"],
        load=base.load,
        to_wide=lambda pt: base.to_wide(pt.data),
        from_wide=_from_wide,
        bytes_per_slot=BYTES_PER_SLOT[layout],
        inject=ops["inject"],
        probe_exists=_probe_exists,
        gather_rows=lambda pt, slots: base.gather_rows(pt.data, slots),
        bind_page=ops["bind_page"],
        unbind_page=ops["unbind_page"],
        extract_page=_extract_page,
        read_page=ops["read_page"],
        write_page=ops["write_page"],
        ways=ways,
        groups_per_page=gpp,
        page_slots=page_slots,
        num_phys_pages=num_phys_pages,
        num_logical_pages=num_logical_pages,
        num_logical_groups=num_groups,
    )


def _row_ops(layout, base, ways, gpp, page_slots, num_phys_groups, check_ways, phys) -> dict:
    """The paged ops of a row layout (fused, narrow): the decide in the
    hand kernel with the map lookup inside it, one-copy page moves."""

    def _frame(pt, pp) -> torch.Tensor:
        start = int(pp) * page_slots
        return pt.data.data[start:start + page_slots]

    def _decide(pt, batch, now, w=ways):
        check_ways(w)
        return cuda_decide.decide_paged(pt, batch, now, layout=layout, ways=ways, gpp=gpp)

    def _decide_scan(pt, batches, nows, w=ways):
        check_ways(w)
        return cuda_decide.decide_scan_paged(
            pt, batches, nows, layout=layout, ways=ways, gpp=gpp
        )

    def _run_wave(pt, flush, w, now, w_=ways):
        check_ways(w_)
        flush.launch(w, pt.data.data, pt.page_map, now, layout=layout, ways=ways, gpp=gpp)
        return pt

    def _inject(pt, items, now, w=ways):
        check_ways(w)
        g = phys(pt, items.group)
        items = items._replace(group=g, active=items.active & (g < num_phys_groups))
        return (pt, *inject_rows(cuda_decide.CODECS[layout], pt.data.data, items, now, ways))

    def _bind_page(pt, lp, pp):
        _frame(pt, pp).zero_()
        pt.page_map[int(lp)] = int(pp)
        return pt

    def _unbind_page(pt, lp, pp):
        # Zero the evacuated frame too: key pruning scans the PHYSICAL
        # table and must not see ghost rows.
        _frame(pt, pp).zero_()
        pt.page_map[int(lp)] = -1
        return pt

    # Pinned host staging of page moves, (columns, page_slots), made at
    # the first move and reused: page ops run under the owning engine's
    # table lock. A read waits for its copy and copies out of the buffer
    # before it returns; a write waits, before it refills its buffer,
    # for the copy that last emptied it (`stage["written"]`).
    stage = {}

    def _stage(frame):
        if not stage:
            shape = (frame.shape[1], frame.shape[0])
            pin = frame.device.type == "cuda"
            stage.update(read=torch.empty(shape, dtype=frame.dtype, pin_memory=pin),
                         write=torch.empty(shape, dtype=frame.dtype, pin_memory=pin),
                         written=None)
        return stage

    def _read_page(pt, pp) -> Dict[str, np.ndarray]:
        frame = _frame(pt, pp)
        buf = _stage(frame)["read"]
        if frame.device.type == "cuda":
            buf.copy_(frame.t().contiguous(), non_blocking=True)  # one device-to-host copy
            done = torch.cuda.Event()
            done.record()
            done.synchronize()  # the copy, behind every wave queued before it
        else:
            buf.copy_(frame.t())
        wide = base.to_wide(type(pt.data)(buf.t()))  # rows whose columns are contiguous
        return {f: np.array(getattr(wide, f).numpy()) for f in SlotTable._fields}

    def _write_page(pt, lp, pp, rows_wide):
        frame = _frame(pt, pp)
        st = _stage(frame)
        if st["written"] is not None:
            st["written"].synchronize()
        buf = st["write"]
        cuda_decide.CODECS[layout].pack_rows(
            fused.wide_columns(SlotTable(*rows_wide)), dim=0, out=buf)
        if frame.device.type == "cuda":
            cols = buf.to(frame.device, non_blocking=True)  # one host-to-device copy
            st["written"] = torch.cuda.Event()
            st["written"].record()
            frame.copy_(cols.t())
        else:
            frame.copy_(buf.t())
        pt.page_map[int(lp)] = int(pp)
        return pt

    return dict(decide=_decide, decide_scan=_decide_scan, run_wave=_run_wave, inject=_inject,
                bind_page=_bind_page, unbind_page=_unbind_page, read_page=_read_page,
                write_page=_write_page)


def _column_ops(layout, base, ways, gpp, page_slots, num_phys_groups, check_ways,
                phys) -> dict:
    """The paged ops of a struct-of-columns layout (wide, packed), torch
    ops as the JAX package's XLA branch runs them: the groups translated
    through the map, then the flat layout's op; page moves column by
    column through the layout's to_wide / from_wide."""

    def _frames(pt, pp):
        start = int(pp) * page_slots
        return type(pt.data)(*(c[start:start + page_slots] for c in pt.data))

    def _decide(pt, batch, now, w=ways):
        check_ways(w)
        _t, out = base.decide(pt.data, batch._replace(group=phys(pt, batch.group)), now, ways)
        return pt, out

    def _decide_scan(pt, batches, nows, w=ways):
        check_ways(w)
        _t, outs = base.decide_scan(
            pt.data, batches._replace(group=phys(pt, batches.group)), nows, ways)
        return pt, outs

    def _inject(pt, items, now, w=ways):
        check_ways(w)
        _t, ehi, elo = base.inject(pt.data, items._replace(group=phys(pt, items.group)),
                                   now, ways)
        return pt, ehi, elo

    def _rebind(pt, lp, pp, to):
        # zero the frame: key pruning scans the PHYSICAL table
        for c in _frames(pt, pp):
            c.zero_()
        pt.page_map[int(lp)] = to
        return pt

    def _read_page(pt, pp) -> Dict[str, np.ndarray]:
        wide = base.to_wide(_frames(pt, pp))
        return {f: getattr(wide, f).to("cpu", copy=True).numpy() for f in SlotTable._fields}

    def _write_page(pt, lp, pp, rows_wide):
        rows = base.from_wide(SlotTable(*rows_wide), pt.page_map.device)
        for dst, src in zip(_frames(pt, pp), rows):
            dst.copy_(src)
        pt.page_map[int(lp)] = int(pp)
        return pt

    return dict(decide=_decide, decide_scan=_decide_scan, run_wave=torch_op_wave(_decide),
                inject=_inject, bind_page=lambda pt, lp, pp: _rebind(pt, lp, pp, int(pp)),
                unbind_page=lambda pt, lp, pp: _rebind(pt, lp, pp, -1),
                read_page=_read_page, write_page=_write_page)
