"""IciEngine: the engine core served over an owner-sharded mesh.

The port of `gubernator_tpu/runtime/ici_engine.py`. IciEngine IS
MeshEngine (runtime/engine.py) bound to the mesh topology
(runtime/topology.py IciMeshTopology): the slot table shards over the
mesh's shards and every wave runs the owner-sharded decide
(parallel/mesh.py), one kernel launch per wave on a card, which answers
every lane at its owner. It replaces peer forwarding inside one process.
Paging works as on one table, with one frame pool per shard, which the
background demoter keeps at `page_free_target` free frames each.

The JAX engine also runs a GLOBAL replica tier beside the sharded table
(per-device replicas and a sync thread, parallel/ici.py). That tier is
the port's next slice; until then a GLOBAL-flagged request raises
NotImplementedError at submission (answering it from the sharded table
would be a different result), and no sync thread starts.

The public surface matches DeviceEngine (check_async / check_bulk /
check_batch / check_columns / close / snapshot / restore / stats), so
V1Service and the serving edge take either: the pipeline and the
columnar path are the core's, over the one sharded launch per wave. A
GLOBAL column raises in `check_columns` as a GLOBAL request does on the
object path, so the edge (service/fastpath.py) leaves such a batch to
the object path, which refuses it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np

from gubernator_tpu_torch.api.types import Behavior, RateLimitReq
from gubernator_tpu_torch.runtime.engine import MeshEngine
from gubernator_tpu_torch.runtime.topology import IciMeshTopology
from gubernator_tpu_torch.utils import clock as _clock


@dataclasses.dataclass
class IciEngineConfig:
    """The sharded tier's knobs (defaults mirror the JAX engine's; the
    GLOBAL replica tier's come with its slice)."""

    # One device per shard, repeats allowed (["cpu"] * 8, ["cuda:0"] * 8);
    # None: one shard per visible card.
    devices: Optional[list] = None
    num_groups: int = 1 << 12  # sharded-table groups (divisible by the shard count)
    ways: int = 8
    batch_size: int = 1024
    batch_limit: int = 1000
    batch_wait_s: float = 500e-6
    max_flush_items: int = 8192
    max_waves: int = 32  # per-flush wave cap; overflow carries over
    # Observatories, as in EngineConfig (the census and the admission
    # scan cover the sharded table; the replica tier comes with GLOBAL).
    census_ttl_s: float = 5.0
    census_thresholds: tuple = (1, 4, 16)
    census_heatmap_width: int = 64
    admission_ttl_s: float = 5.0
    layout: str = "fused"
    # Paged table: page_groups > 0 pages the sharded table, the page map
    # shared by the shards, the frames split into one pool per shard
    # (page_budget must divide by the shard count).
    page_groups: int = 0
    page_budget: int = 0
    # The background demoter, as in EngineConfig; the free-frame target
    # holds for each shard's pool.
    page_demote_interval_s: float = 2.0
    page_free_target: int = 1
    pipeline_depth: int = 2  # flushes in flight, as in EngineConfig


class IciEngine(MeshEngine):
    # GLOBAL-flagged requests belong to the replica tier inside the
    # engine (refused until it is ported).
    routes_global_internally = True

    def __init__(self, config: Optional[IciEngineConfig] = None,
                 now_fn: Callable[[], int] = _clock.now_ms):
        cfg = config if config is not None else IciEngineConfig()
        topo = IciMeshTopology(cfg.devices)
        if cfg.num_groups % topo.n_dev:
            raise ValueError(
                f"num_groups {cfg.num_groups} must divide by the shard count {topo.n_dev}"
            )
        super().__init__(cfg, now_fn, topology=topo)

    @property
    def n_dev(self) -> int:
        return self.topo.n_dev

    @property
    def mesh(self):
        return self.topo.mesh

    _GLOBAL_REFUSED = (
        "GLOBAL requests on the mesh tier are answered by the GLOBAL "
        "replica tier (parallel/ici.py), which is not ported yet"
    )

    def _refuse_global(self, reqs: Sequence[RateLimitReq]) -> None:
        if self._rtier is None and any(r.behavior & int(Behavior.GLOBAL) for r in reqs):
            raise NotImplementedError(self._GLOBAL_REFUSED)

    def check_async(self, req: RateLimitReq):
        self._refuse_global([req])
        return super().check_async(req)

    def check_bulk(self, reqs: Sequence[RateLimitReq]):
        self._refuse_global(reqs)
        return super().check_bulk(reqs)

    def check_columns(self, cols, now=None, select=None, hashes=None):
        behavior = cols.behavior if select is None else cols.behavior[select]
        if self._rtier is None and np.any(behavior & int(Behavior.GLOBAL)):
            raise NotImplementedError(self._GLOBAL_REFUSED)
        return super().check_columns(cols, now=now, select=select, hashes=hashes)

    def stats(self) -> dict:
        """The core's counters plus the shard count."""
        return dict(super().stats(), n_dev=self.n_dev)
