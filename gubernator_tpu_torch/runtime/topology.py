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
  `collective_guard`), and the GLOBAL replica tier, which is not ported
  yet: `build_replica` returns None on both topologies, and IciEngine
  refuses GLOBAL requests while it does.

This module imports ops/, parallel/ and runtime/pager, never
runtime/engine (the engine imports it).
"""

from __future__ import annotations

import contextlib

import torch

from gubernator_tpu_torch.ops.kernels import get_kernels, get_paged_kernels
from gubernator_tpu_torch.parallel import mesh as pmesh
from gubernator_tpu_torch.runtime.pager import Pager


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
    (owner-sharded decide, parallel/mesh.py), all on one device. Paging
    composes: the paged mesh facade keeps the physical frames sharded and
    the page map shared, and the Pager runs one frame pool per shard
    (n_shards = D)."""

    primary_tier = "sharded"
    thread_name = "gubernator-torch-ici"

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
        """The GLOBAL replica tier (parallel/ici.py) is the next slice."""
        return None

    def dispatch_guard(self):
        return pmesh.collective_guard()
