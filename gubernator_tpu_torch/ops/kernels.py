"""Layout registry: the table operations the engine calls, by layout.

Two layouts are ported: `fused` (one (N, 10) int64 tensor, ops/fused.py)
and `narrow` (one (N, 9) int64 tensor with a 5-column probe prefix,
ops/narrow.py). Their `decide` dispatches by the table's device: the
CUDA kernel (ops/cuda_decide.py) on a CUDA table, the plain PyTorch
version on a CPU table; `decide_scan` runs T waves in order, as one
launch of the scan kernel on a CUDA table. Snapshots are exchanged in the wide format
(to_wide/from_wide), the same format the JAX package uses.
`get_paged_kernels` puts either layout behind a page map (ops/paged.py);
`get_census` and `get_admission` give the layout's table scans
(ops/census.py, ops/admission.py). The store path's ops are torch ops
(ops/inject.py): `inject` writes authoritative rows, `probe_exists`
asks which of a wave's keys are live, and `gather_rows` reads the rows
a wave wrote, expanded to the wide struct.
"""

from __future__ import annotations

from typing import NamedTuple

from gubernator_tpu_torch.ops import cuda_decide, fused, narrow
from gubernator_tpu_torch.ops.inject import inject_rows, probe_rows

# The layouts this package serves; EngineConfig.layout validates against it.
LAYOUTS = ("fused", "narrow")

# Resident bytes per table slot, by layout.
BYTES_PER_SLOT = {"fused": 80, "narrow": 72}


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


_KERNELS = {
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
