"""Layout registry: the table operations the engine calls, by layout.

All four layouts of the JAX package (`gubernator_tpu/ops/kernels.py`):

- `wide`: one column per field, the `SlotTable` itself (ops/decide.py);
- `packed`: ten narrower columns with a 3-gather probe (ops/packed.py);
- `fused`: one (N, 10) int64 tensor (ops/fused.py);
- `narrow`: one (N, 9) int64 tensor with a 5-column probe prefix
  (ops/narrow.py).

Fused and narrow are the layouts the JAX package's Pallas kernel lowers,
so here their `decide` is the hand-written CUDA kernel
(ops/cuda_decide.py) on a CUDA table and the plain PyTorch version on a
CPU table; `decide_scan` runs T waves in order, as one launch of the
scan kernel on a CUDA table. Wide and packed are XLA programs in the
JAX package, whatever GUBER_KERNEL says (its diagnostic layouts), so
here they are torch ops on either device: their `run_wave` runs the
layout's decide on the flush's wave batch and writes the flush's
outputs, and `load` builds nothing. Snapshots are exchanged in the wide
format (to_wide/from_wide), the same format the JAX package uses.
`get_paged_kernels` puts any layout behind a page map (ops/paged.py);
`get_census` and `get_admission` give the layout's table scans
(ops/census.py, ops/admission.py). The store path's ops are torch ops
(ops/inject.py, ops/packed.py): `inject` writes authoritative rows,
`probe_exists` asks which of a wave's keys are live, and `gather_rows`
reads the rows a wave wrote, expanded to the wide struct.
"""

from __future__ import annotations

from typing import NamedTuple

from gubernator_tpu_torch.ops import cuda_decide, decide as wide, fused, narrow, packed
from gubernator_tpu_torch.ops import inject as wide_inject
from gubernator_tpu_torch.ops.inject import inject_rows, probe_rows
from gubernator_tpu_torch.ops.layout import SlotTable, wide_on_device

# The layouts this package serves; EngineConfig.layout validates against it.
LAYOUTS = ("wide", "packed", "fused", "narrow")

# Resident bytes per table slot, by layout (the JAX package's accounting).
BYTES_PER_SLOT = {"wide": 83, "packed": 72, "fused": 80, "narrow": 72}

# The layouts whose decide is the hand-written kernel (on a card).
KERNEL_LAYOUTS = tuple(cuda_decide.CODECS)


class Kernels(NamedTuple):
    layout: str
    create: object  # (num_groups, ways, device) -> table
    decide: object  # (table, batch, now, ways) -> (table, DecideOutput), in place
    decide_scan: object  # (table, (T, B) batches, (T,) nows, ways) -> (table, stacked outputs)
    # (table, cuda_decide.WaveFlush, w, now, ways) -> table: wave w of a
    # flush into the flush's outputs, in place (the engine's launch path)
    run_wave: object
    load: object  # (device) -> None: build what decide needs there
    to_wide: object  # table -> SlotTable on the table's device
    from_wide: object  # (SlotTable, device) -> table
    gather_rows: object  # (table, slots) -> SlotTable rows (slot == N reads zeros)
    # (table, InjectBatch on the table's device, now, ways) -> (table,
    # evicted_hi, evicted_lo): authoritative rows written in place
    # (ops/inject.py)
    inject: object
    # (table, key_hi, key_lo, group, now, ways) -> (B,) bool on the
    # table's device: the residency probe (ops/inject.py probe_rows)
    probe_exists: object


def _make(layout: str, module, table_cls, gather_rows) -> Kernels:
    def decide(table, batch, now, ways):
        return cuda_decide.decide_flat(table, batch, now, layout=layout, ways=ways)

    def decide_scan(table, batches, nows, ways):
        return cuda_decide.decide_scan_flat(table, batches, nows, layout=layout, ways=ways)

    def run_wave(table, flush, w, now, ways):
        flush.launch(w, table.data, None, now, layout=layout, ways=ways)
        return table

    def inject(table, items, now, ways):
        return (table, *inject_rows(cuda_decide.CODECS[layout], table.data, items, now, ways))

    def probe_exists(table, key_hi, key_lo, group, now, ways):
        return probe_rows(cuda_decide.CODECS[layout], table.data, key_hi, key_lo, group, now, ways)

    return Kernels(
        layout=layout,
        create=table_cls.create,
        decide=decide,
        decide_scan=decide_scan,
        run_wave=run_wave,
        load=cuda_decide.load,
        to_wide=module.unpack_table,
        from_wide=module.pack_table,
        gather_rows=gather_rows,
        inject=inject,
        probe_exists=probe_exists,
    )


def torch_op_wave(decide_fn):
    """`run_wave` of a layout served by torch ops: the layout's decide on
    the flush's wave batch, in place, its DecideOutput copied into wave
    w's span of the flush's outputs (the WaveScan sums stay zero: the
    JAX package's XLA decide has none)."""
    def run_wave(table, flush, w, now, ways):
        table, out = decide_fn(table, flush.wave_batch(w), now, ways)
        dst, _scan = flush.wave_outputs(w)
        for d, v in zip(dst, out):
            d.copy_(v)
        return table

    return run_wave


def _make_torch_op(layout, create, decide, decide_scan, inject, probe_exists, gather_rows,
                   to_wide, from_wide) -> Kernels:
    return Kernels(
        layout=layout,
        create=create,
        decide=decide,
        decide_scan=decide_scan,
        run_wave=torch_op_wave(decide),
        load=lambda _device: None,
        to_wide=to_wide,
        from_wide=from_wide,
        gather_rows=gather_rows,
        inject=inject,
        probe_exists=probe_exists,
    )


_KERNELS = {
    "wide": _make_torch_op(
        "wide", SlotTable.create, wide.decide, wide.decide_scan, wide_inject.inject,
        wide.probe_exists, wide.gather_rows, lambda t: t, wide_on_device),
    "packed": _make_torch_op(
        "packed", packed.PackedTable.create, packed.decide_packed, packed.decide_scan_packed,
        packed.inject_packed, packed.probe_exists_packed, packed.gather_rows_packed,
        packed.unpack_table, packed.pack_table),
    "fused": _make("fused", fused, fused.FusedTable, fused.gather_rows_fused),
    "narrow": _make("narrow", narrow, narrow.NarrowTable, narrow.gather_rows_narrow),
}


def get_kernels(layout: str) -> Kernels:
    try:
        return _KERNELS[layout]
    except KeyError:
        raise ValueError(
            f"unknown table layout {layout!r}: this package serves {LAYOUTS}"
        ) from None


def get_census(layout: str, ways: int, **kwargs):
    """The census scan of `layout` (ops/census.py): (table, now) ->
    CensusOutput, one per (layout, geometry, knobs). On a paged table the
    engine scans the physical frames (`PagedTable.data`)."""
    get_kernels(layout)  # validates the layout
    from gubernator_tpu_torch.ops.census import make_census

    return make_census(layout, ways, **kwargs)


def get_admission(layout: str, ways: int, **kwargs):
    """The admission-accounting scan of `layout` (ops/admission.py):
    (table, now) -> AdmissionOutput, scanned as the census is."""
    get_kernels(layout)  # validates the layout
    from gubernator_tpu_torch.ops.admission import make_admission

    return make_admission(layout, ways, **kwargs)


def get_paged_kernels(
    layout: str,
    num_groups: int,
    ways: int,
    groups_per_page: int,
    num_phys_pages: int,
    device,
):
    """Paged addressing over `layout` (ops/paged.py): the physical table
    holds `num_phys_pages` frames of `groups_per_page` groups, and the
    decide kernel reads the page map to translate logical groups."""
    get_kernels(layout)  # validates the layout
    from gubernator_tpu_torch.ops.paged import make_paged_kernels

    return make_paged_kernels(
        layout, num_groups, ways, groups_per_page, num_phys_pages, device
    )
