"""Owner-sharded decide over a mesh of shards.

The port of `gubernator_tpu/parallel/mesh.py`, the multi-device tier
that replaces peer forwarding inside one process: the slot table is
split into D shards of contiguous slot groups, the batch is replicated
to every shard, each shard masks the lanes whose group it does not own
(`_mask_to_local`; the port's is `ops/fused.py::mask_to_local`, beside
the plain wave it feeds) and runs the raw decide on its own rows, and a psum
over the shards combines the answers (each lane is answered by exactly
one owner; the other shards see it masked).

A mesh here is a list of one device per shard, and entries may repeat:
8 shards on `cpu` (the tests, as the JAX package fakes 8 devices on one
CPU) or 8 shards on `cuda:0`. All the shards of a mesh live on ONE
device, as one (N, C) table in which shard d holds rows
[d * n_local, (d + 1) * n_local): exactly what the JAX package's
`NamedSharding(P(AXIS))` array holds, so the global image of a sharded
table is the flat table's image. On that device one launch of the
sharded kernel (`ops/cuda_decide.py::decide_sharded`) runs every shard's
masked wave and the psum for a whole wave; a CPU table runs its plain
version (`ops/fused.py::sharded_plain`). A mesh that spans several
devices is refused: it needs per-card launches and a combine across
cards, which nothing here has run (ROADMAP.md, "a mesh across several
cards").

The combined `slot` is the psum's, not a global slot index: a masked
lane reports its shard's n_local, so an owned lane's slot is its local
slot + (D - 1) * n_local and an unowned lane's is D * n_local; `freed`
is int32 (ROADMAP.md §C).

The store path's ops over a sharded table (JAX `make_mesh_kernels`):
`inject` is the ownership-masked inject (`make_sharded_inject`);
`probe_exists` and `gather_rows` are the layout's own over the whole
table, as GSPMD partitions the JAX package's. So the store path's
`gather_rows(table, out.slot)` reads the psum's slot as a global one,
as the JAX package's does: an owned lane of shard d < D - 1 reads a
row of shard D - 1, whose key fails the write-behind's key check, and
only shard D - 1's lanes persist (ROADMAP.md §3).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Tuple

import torch

from gubernator_tpu_torch.ops import cuda_decide
from gubernator_tpu_torch.ops.inject import inject_rows
from gubernator_tpu_torch.ops.kernels import get_kernels

# The multi-device tier defaults to the fused layout, as the single-chip
# engine does.
DEFAULT_LAYOUT = "fused"
# The layouts the mesh tier serves in this package: those of the sharded
# hand kernel. Wide and packed are served on one table (DeviceEngine)
# only; ROADMAP.md queues them here.
MESH_LAYOUTS = tuple(cuda_decide.CODECS)


def check_mesh_layout(layout: str) -> None:
    """Refuse a layout the mesh tier does not serve, naming it."""
    get_kernels(layout)  # an unknown layout: the registry's error
    if layout not in MESH_LAYOUTS:
        raise ValueError(
            f"layout {layout!r}: the mesh tier serves {MESH_LAYOUTS} in this "
            f"package (a single table, DeviceEngine, serves {layout!r})"
        )


class Mesh(NamedTuple):
    """One device per shard (repeats allowed; all one device here)."""

    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The device every shard lives on."""
        return self.devices[0]


def _same_device(a: torch.device, b: torch.device) -> bool:
    # "cuda" without an index is the current card, cuda:0 unless set
    return a.type == b.type and (a.index or 0) == (b.index or 0)


def make_mesh(devices=None) -> Mesh:
    """A mesh of `devices`, one per shard (repeats allowed, e.g.
    `["cuda:0"] * 8`). The default is one shard per visible card. Raises
    NotImplementedError for a list that spans several devices."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError(
                "no CUDA device is visible; pass the shards' devices, "
                "e.g. ['cpu'] * 8"
            )
        devices = [torch.device("cuda", i) for i in range(n)]
    devs = tuple(torch.device(d) for d in devices)
    if not devs:
        raise ValueError("a mesh needs at least one shard")
    for d in devs:
        if d.type not in ("cpu", "cuda"):
            raise ValueError(f"mesh shards run on cuda or cpu, not {d}")
        if not _same_device(d, devs[0]):
            raise NotImplementedError(
                f"the shards span {devs[0]} and {d}: a mesh across several "
                "cards (per-card launches and a combine across them) is "
                "not ported yet; see ROADMAP.md, 'a mesh across several cards'"
            )
    return Mesh(devs)


def collective_guard():
    """The JAX package's process-wide dispatch lock keeps two engines'
    multi-device programs from interleaving their per-device enqueues
    (a cross-program rendezvous deadlock). The shards of a mesh here are
    one device and the combine is inside one launch, so there is no
    collective to interleave: no lock."""
    return contextlib.nullcontext()


def create_sharded_table(mesh: Mesh, num_groups: int, ways: int = 8,
                         layout: str = DEFAULT_LAYOUT):
    """The layout's table of `num_groups` groups on the mesh's device,
    contiguous groups per shard (num_groups must divide by the mesh
    size): one (N, C) tensor, shard d at rows [d * n_local, (d+1) *
    n_local)."""
    check_mesh_layout(layout)
    if num_groups % mesh.size:
        raise ValueError(f"num_groups {num_groups} must divide by mesh size {mesh.size}")
    return get_kernels(layout).create(num_groups, ways, mesh.device)


def make_sharded_decide(mesh: Mesh, num_groups: int, ways: int = 8,
                        layout: str = DEFAULT_LAYOUT):
    """decide(table, batch, now) -> (table, DecideOutput), the table
    sharded over `mesh` and updated in place, the batch replicated: one
    sharded wave (one kernel launch on a card)."""
    check_mesh_layout(layout)
    if num_groups % mesh.size:
        raise ValueError(f"num_groups {num_groups} must divide by mesh size {mesh.size}")
    n = num_groups * ways

    def decide_fn(table, batch, now):
        if table.data.shape[0] != n:
            raise ValueError(f"table holds {table.data.shape[0]} rows, this mesh decide {n}")
        out, _scan = cuda_decide.decide_sharded(
            table.data, None, batch, now, layout=layout, ways=ways, n_shards=mesh.size
        )
        return table, out

    return decide_fn


def make_sharded_inject(mesh: Mesh, num_groups: int, ways: int = 8,
                        layout: str = DEFAULT_LAYOUT):
    """inject(table, items, now) -> (table, evicted_hi, evicted_lo) over
    a sharded table, in place: the decide's ownership mask applied to
    the inject batch, each shard injecting its own lanes, the evicted
    keys summed over the shards (JAX `make_sharded_inject`). The shards
    are rows [d * n_local, (d + 1) * n_local) of one table and every
    lane has one owner, so shard d's inject at local group g - d *
    groups_per is the inject at global group g, and the sum of the
    evicted keys is the owner's: one inject over the whole table with
    the lanes no shard owns made inactive."""
    check_mesh_layout(layout)
    if num_groups % mesh.size:
        raise ValueError(f"num_groups {num_groups} must divide by mesh size {mesh.size}")
    codec = cuda_decide.CODECS[layout]

    def inject_fn(table, items, now):
        g = items.group.to(torch.int64)
        owned = items.active & (g >= 0) & (g < num_groups)
        return (table, *inject_rows(codec, table.data, items._replace(active=owned), now, ways))

    return inject_fn


def _run_sharded(table, flush, w, data, page_map, now, layout, ways, n_shards, gpp):
    """Wave w of an engine flush (`cuda_decide.WaveFlush`) as one
    sharded wave over `n_shards` shards of `data` (the rows of `table`),
    in place; returns `table`."""
    flush.launch(w, data, page_map, now, layout=layout, ways=ways, gpp=gpp, n_shards=n_shards)
    return table


def _no_scan(*_a, **_k):
    raise NotImplementedError(
        "the mesh tier serves wave-at-a-time sharded programs; there is no "
        "decide_scan path (bench the single-chip engine for scan shapes)"
    )


def make_mesh_kernels(mesh: Mesh, layout: str, num_groups: int, ways: int = 8, *,
                      page_groups: int = 0, page_budget: int = 0):
    """The registry's facade over a sharded table, so the engine core
    binds one kernel set and never learns the topology.

    Flat (page_groups == 0): an `ops.kernels.Kernels` whose decide is the
    sharded wave, whose inject is the ownership-masked one, and whose
    read-side ops (to_wide, gather_rows, probe_exists) are the layout's
    own: the sharded table's image is the flat table's.

    Paged (page_groups > 0): an `ops.paged.PagedKernels` whose PHYSICAL
    frames are split into D shards of page_budget / D frames and whose
    page map is shared by all shards. The decide translates logical
    groups through the map first (`_xlate`, inside the kernel), then
    applies ownership in PHYSICAL group space (groups_per =
    num_phys_groups / D); a lane on a page that is not resident maps
    outside every shard's range and is inactive everywhere. The page
    ops are the single-table ones: frame pp lies in shard pp // (page_
    budget / D), which the pager's per-shard frame pools respect. So are
    the store path's: a lane's owner in PHYSICAL group space is the
    shard of its frame, and a lane on a page that is not resident (no
    owner) injects nothing, so the paged table's translated inject is
    the ownership-masked one."""
    check_mesh_layout(layout)
    n_dev = mesh.size
    if num_groups % n_dev:
        raise ValueError(f"num_groups {num_groups} must divide by mesh size {n_dev}")
    if page_groups <= 0:
        base = get_kernels(layout)
        decide_fn = make_sharded_decide(mesh, num_groups, ways, layout)
        inject_fn = make_sharded_inject(mesh, num_groups, ways, layout)
        return base._replace(
            create=lambda *_a, **_k: create_sharded_table(mesh, num_groups, ways, layout),
            decide=lambda t, b, now, ways_=ways: decide_fn(t, b, now),
            inject=lambda t, i, now, ways_=ways: inject_fn(t, i, now),
            decide_scan=_no_scan,
            run_wave=lambda t, fl, w, now, ways_=ways: _run_sharded(
                t, fl, w, t.data, None, now, layout, ways, n_dev, 0),
            from_wide=lambda wide, _device=None: base.from_wide(wide, mesh.device),
        )
    return _make_mesh_paged_kernels(mesh, layout, num_groups, ways, page_groups, page_budget)


def _make_mesh_paged_kernels(mesh: Mesh, layout: str, num_groups: int, ways: int,
                             groups_per_page: int, num_phys_pages: int):
    from gubernator_tpu_torch.ops.paged import make_paged_kernels

    n_dev = mesh.size
    if num_phys_pages <= 0 or num_phys_pages % n_dev:
        raise ValueError(
            f"page budget {num_phys_pages} must be a positive multiple of "
            f"mesh size {n_dev} (each shard owns an equal frame pool)"
        )
    PK = make_paged_kernels(
        layout, num_groups, ways, groups_per_page, num_phys_pages, mesh.device
    )
    gpp = groups_per_page

    def _decide(pt, batch, now, w=ways):
        if w != ways:
            raise ValueError(f"this paged table has {ways} ways, not {w}")
        out, _scan = cuda_decide.decide_sharded(
            pt.data.data, pt.page_map, batch, now, layout=layout, ways=ways,
            n_shards=n_dev, gpp=gpp,
        )
        return pt, out

    def _run_wave(pt, flush, w, now, w_=ways):
        if w_ != ways:
            raise ValueError(f"this paged table has {ways} ways, not {w_}")
        return _run_sharded(pt, flush, w, pt.data.data, pt.page_map, now, layout, ways, n_dev, gpp)

    return PK._replace(decide=_decide, decide_scan=_no_scan, run_wave=_run_wave)

