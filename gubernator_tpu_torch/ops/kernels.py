"""Layout registry: the table operations the engine calls, by layout.

Only the `fused` layout is ported so far (one (N, 10) int64 tensor, see
ops/fused.py). Its `decide` dispatches by the table's device: the CUDA
kernel (ops/cuda_decide.py) on a CUDA table, the plain PyTorch version
on a CPU table. Snapshots are exchanged in the wide format
(to_wide/from_wide), the same format the JAX package uses.
"""

from __future__ import annotations

from typing import NamedTuple

from gubernator_tpu_torch.ops import cuda_decide, fused

# The layouts this package serves; EngineConfig.layout validates against it.
LAYOUTS = ("fused",)

# Resident bytes per table slot, by layout.
BYTES_PER_SLOT = {"fused": 80}


class Kernels(NamedTuple):
    layout: str
    create: object  # (num_groups, ways, device) -> table
    decide: object  # (table, batch, now, ways) -> (table, DecideOutput), in place
    load: object  # (device) -> None: build what decide needs there
    to_wide: object  # table -> SlotTable on the table's device
    from_wide: object  # (SlotTable, device) -> table


def _fused_decide(table, batch, now, ways):
    return cuda_decide.decide_flat(table, batch, now, ways=ways)


_FUSED = Kernels(
    layout="fused",
    create=fused.FusedTable.create,
    decide=_fused_decide,
    load=cuda_decide.load,
    to_wide=fused.unpack_table,
    from_wide=fused.pack_table,
)


def get_kernels(layout: str) -> Kernels:
    if layout == "fused":
        return _FUSED
    raise ValueError(f"unknown table layout {layout!r}: this package serves {LAYOUTS}")
