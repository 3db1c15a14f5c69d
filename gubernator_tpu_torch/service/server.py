"""The rate-limit service: validation and local execution.

The port of `gubernator_tpu/service/server.py` (`V1Service`, the
reference's V1Instance, gubernator.go:45-773) for a standalone node:
every key is owned locally, so a call's valid items go to the engine as
ONE bulk submission. The engine is either a `DeviceEngine` (one table)
or an `IciEngine` (the owner-sharded mesh, runtime/ici_engine.py), which
refuses GLOBAL requests until the replica tier is ported. Peers, GLOBAL
replication, leases and the decision recorder come in later slices; the
network listeners too, so callers use this class in process.
"""

from __future__ import annotations

import asyncio
from typing import List, Optional, Sequence

from gubernator_tpu_torch.api.types import (
    HealthCheckResp,
    MAX_BATCH_SIZE,
    RateLimitReq,
    RateLimitResp,
    validate_request,
)
from gubernator_tpu_torch.runtime.engine import MeshEngine
from gubernator_tpu_torch.utils import clock as _clock


class ApiError(Exception):
    """Whole-call failure, mapped to gRPC OUT_OF_RANGE / HTTP 400 etc."""

    def __init__(self, message: str, grpc_code: str = "INVALID_ARGUMENT", http_code: int = 400):
        super().__init__(message)
        self.grpc_code = grpc_code
        self.http_code = http_code


class V1Service:
    def __init__(self, engine: MeshEngine, now_fn=_clock.now_ms):
        self.engine = engine
        self.now_fn = now_fn

    # ---- V1.GetRateLimits (reference gubernator.go:183-309) ----------------

    async def get_rate_limits(self, reqs: Sequence[RateLimitReq]) -> List[RateLimitResp]:
        if len(reqs) > MAX_BATCH_SIZE:
            raise ApiError(
                f"Requests.RateLimits list too large; max size is '{MAX_BATCH_SIZE}'",
                grpc_code="OUT_OF_RANGE",
            )
        now = self.now_fn()
        responses: List[Optional[RateLimitResp]] = [None] * len(reqs)
        local_items: List[tuple] = []  # (idx, req) -> one bulk engine submit
        for i, req in enumerate(reqs):
            err = validate_request(req)
            if err is not None:
                responses[i] = RateLimitResp(error=err)
                continue
            if req.created_at is None or req.created_at == 0:
                req.created_at = now
            local_items.append((i, req))

        if local_items:
            fut = self.engine.check_bulk([r for _, r in local_items])
            try:
                results = await asyncio.wrap_future(fut)
                for (i, _), resp in zip(local_items, results):
                    responses[i] = resp
            except Exception as e:
                for i, _ in local_items:
                    responses[i] = RateLimitResp(error=str(e))
        return [
            r if r is not None else RateLimitResp(error="internal: no response")
            for r in responses
        ]

    # ---- V1.HealthCheck ----------------------------------------------------

    async def health_check(self) -> HealthCheckResp:
        """A standalone node has no peers and no drain state yet."""
        return HealthCheckResp(status="healthy", peer_count=0)
