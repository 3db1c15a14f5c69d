"""Topology strategies for the engine core (runtime/engine.py MeshEngine).

The port of `gubernator_tpu/runtime/topology.py`. MeshEngine owns
everything topology-independent once: the pump, wave assembly,
snapshots and restore. What differs by topology lives here, in a small
strategy object:

- **kernel binding** (`build_kernels`): which Kernels facade the engine
  dispatches through, and whether a Pager manages page residency behind
  it. One table binds the layout's kernels (ops/kernels.py); the mesh
  binds the owner-sharded wave (parallel/mesh.py), whose psum over the
  shards replaces peer forwarding. Paging rides the same seam on both,
  with one frame pool per shard on the mesh.
- **geometry**: the shard count `n_dev` and the `device` the table
  lives on; one shard is the single-table engine. `primary_tier` names
  the table's tier in the census and admission snapshots ("device" or
  "sharded").
- **collective step** (`dispatch_guard`, `build_replica`): the guard
  around every dispatch (no lock on one device: parallel/mesh.py
  `collective_guard`), and the GLOBAL replica tier (`ReplicaTier`,
  parallel/ici.py), built only where a mesh exists to replicate over.

This module imports ops/, parallel/ and runtime/pager, never
runtime/engine (the engine imports it).
"""

from __future__ import annotations

import contextlib

import torch

from gubernator_tpu_torch.ops import cuda_decide
from gubernator_tpu_torch.ops.kernels import (
    get_admission,
    get_census,
    get_kernels,
    get_paged_kernels,
)
from gubernator_tpu_torch.parallel import ici
from gubernator_tpu_torch.parallel import mesh as pmesh
from gubernator_tpu_torch.runtime.pager import Pager


class ReplicaTier:
    """The GLOBAL replica tier, bundled for the engine core: per-shard
    replica tables with pending deltas (parallel/ici.py), the decide,
    sync and inject over them, and the stacked census and admission
    scans. The core treats it as state plus callables; the sync cadence
    (thread and tick bookkeeping) stays in IciEngine.

    `run_wave(flush, w, now)` runs wave w of a `cuda_decide.WaveFlush`
    made with `memo` (the tier's own table memo: the engine's waves
    alternate between two tables) as one replica wave: one launch of the
    sharded kernel over the stacked replicas on a card, then the pending
    bookkeeping. `run_sync(sync, now)` ticks the state with `sync` (the
    regular tick or the backstop's) and returns the diag; while no wave
    or inject has touched the state since it was created (every row
    zero), the tick only advances its counter, which is all the merge
    would change."""

    def __init__(self, mesh, cfg, census_thresholds):
        self.mesh = mesh
        self._layout = cfg.layout
        self.num_slots = int(cfg.num_slots)
        self.replica_ways = int(cfg.replica_ways)
        self.num_rgroups = self.num_slots // self.replica_ways
        self.memo = cuda_decide.TableMemo()
        self.recreate_state()
        self.decide = ici.make_replica_decide(
            mesh, self.num_slots, self.replica_ways, layout=cfg.layout)
        self.sync = ici.make_sync_step(
            mesh, self.num_slots, self.replica_ways, layout=cfg.layout,
            max_sync_groups=cfg.max_sync_groups,
        )
        # Collision backstop: an unbounded tick every `full_tick_every`
        # capped ticks, built only when the regular tick is capped.
        self.sync_full = None
        if (cfg.max_sync_groups is not None and cfg.max_sync_groups < self.num_rgroups
                and cfg.full_tick_every > 0):
            self.sync_full = ici.make_sync_step(
                mesh, self.num_slots, self.replica_ways, layout=cfg.layout,
                max_sync_groups=None,
            )
        self._inject = ici.make_inject_replicas(
            mesh, self.num_slots, self.replica_ways, layout=cfg.layout)
        # replica 0 of the stack (after a sync the replicas mirror it)
        self.census = get_census(
            cfg.layout, self.replica_ways, heatmap_width=int(cfg.census_heatmap_width),
            thresholds=census_thresholds, stacked=True,
        )
        self.admission = get_admission(cfg.layout, self.replica_ways, stacked=True)

    def recreate_state(self) -> ici.IciState:
        """Fresh empty replicas (after a failed replica wave: counter
        loss on failure, as the JAX engine rebuilds its donated state)."""
        self._state = ici.create_ici_state(
            self.mesh, self.num_slots, self.replica_ways, layout=self._layout)
        self._rows = ici.replica_rows(self._state)
        self._untouched = True
        return self._state

    @property
    def state(self) -> ici.IciState:
        return self._state

    @state.setter
    def state(self, state: ici.IciState) -> None:
        self._state = state
        self._rows = ici.replica_rows(state)
        self._untouched = False

    def inject(self, items, now: int) -> None:
        """Authoritative rows (an InjectBatch on the state's device) into
        every replica."""
        self._untouched = False
        self._inject(self._state, items, now)

    def run_sync(self, sync, now: int):
        self._state, diag = sync(self._state, now, untouched=self._untouched)
        return diag

    def run_wave(self, flush, w: int, now: int) -> None:
        self._untouched = False
        ici.run_replica_wave(
            self._state, self._rows, flush, w, now, layout=self._layout,
            ways=self.replica_ways, num_rgroups=self.num_rgroups,
        )


def _check_paging(cfg) -> int:
    """page_groups, after the checks every topology makes."""
    pg = int(cfg.page_groups or 0)
    if pg > 0:
        if int(cfg.page_budget or 0) <= 0:
            raise ValueError("page_budget must be > 0 when page_groups > 0")
        if pg > cfg.num_groups:
            raise ValueError(f"page_groups ({pg}) exceeds num_groups ({cfg.num_groups})")
    return pg


class SingleChipTopology:
    """Mesh shape ``(1,)``: one table on one device, the layout's
    kernels, no replica tier, no guard."""

    n_dev = 1
    # the census's name for the tier the table is (engine.table_census)
    primary_tier = "device"
    thread_name = "gubernator-torch-pump"
    # the dtype of the decide's `freed` column (the wave kernel's)
    freed_dtype = torch.bool

    def __init__(self, device):
        self.device = torch.device(device)

    def build_kernels(self, cfg):
        """(Kernels, Pager or None): the paged facade and a Pager when
        page_groups is set, the flat layout kernels otherwise."""
        pg = _check_paging(cfg)
        if pg > 0:
            K = get_paged_kernels(
                cfg.layout, cfg.num_groups, cfg.ways, pg, cfg.page_budget, self.device
            )
            return K, Pager(K)
        return get_kernels(cfg.layout), None

    def build_replica(self, cfg):
        return None  # no mesh to replicate over

    def dispatch_guard(self):
        """A single table's decide cannot rendezvous: no guard."""
        return contextlib.nullcontext()


class IciMeshTopology:
    """Mesh shape ``(D,)``: the slot table shards over D shards
    (owner-sharded decide, parallel/mesh.py), all on one device, and
    GLOBAL traffic runs on per-shard replicas (parallel/ici.py). Paging
    composes: the paged mesh facade keeps the physical frames sharded and
    the page map shared, and the Pager runs one frame pool per shard
    (n_shards = D)."""

    primary_tier = "sharded"
    thread_name = "gubernator-torch-ici"
    # the sharded kernel's `freed` is the psum's type
    freed_dtype = torch.int32

    def __init__(self, devices=None):
        self.mesh = pmesh.make_mesh(devices)
        self.n_dev = self.mesh.size
        self.device = self.mesh.device

    def build_kernels(self, cfg):
        """(Kernels, Pager or None) over the mesh: the sharded wave, with
        the paged mesh facade and a per-shard Pager when page_groups is
        set."""
        pg = _check_paging(cfg)
        K = pmesh.make_mesh_kernels(
            self.mesh, cfg.layout, cfg.num_groups, cfg.ways,
            page_groups=pg, page_budget=int(cfg.page_budget or 0),
        )
        return K, (Pager(K, n_shards=self.n_dev) if pg > 0 else None)

    def build_replica(self, cfg):
        return ReplicaTier(self.mesh, cfg, tuple(int(k) for k in cfg.census_thresholds))

    def dispatch_guard(self):
        return pmesh.collective_guard()
