"""The rate-limit service: validation and local execution.

The port of `gubernator_tpu/service/server.py` (`V1Service`, the
reference's V1Instance, gubernator.go:45-773) for a standalone node:
every key is owned locally, so a call's valid items go to the engine as
ONE bulk submission. The engine is either a `DeviceEngine` (one table)
or an `IciEngine` (the owner-sharded mesh, runtime/ici_engine.py), whose
replica tier answers GLOBAL requests (the flag reaches it unstripped).
Peers, the cross-node GLOBAL legs and leases come in later slices; the
network listeners too, so callers use this class in process.

Observability (JAX `service/server.py`): the service counts its calls
into a `Metrics` (`getratelimit_counter`, `check_error_counter`,
`concurrent_checks`, `func_duration`) and records every answer's
provenance (service/admission.py `DecisionRecorder`: path `owner` on
the object path, `fastpath` on the columnar edge); with the engine's
`stage_metadata` each answer carries `decision_path`. The composition
root wires the engine's telemetry into the same Metrics
(`metrics.wire_engine_telemetry`), as the JAX daemon does; `render()`
is the `/metrics` body.

Overload and SLOs (JAX `daemon.py` arms them; the port has no daemon
yet, so the caller does): a `Watchdog` on `engine.watchdog` (handed to
the observatory and the ladder too), an `SloObservatory`
(service/slo.py) on `slo`, and an
`OverloadManager` (service/overload.py) on `overload`, whose
`IntakeGovernor` is `engine.overload`. Their scrape bridges publish
the burn rates, stall flags, the ladder's level, and
`slo_debug_info()` / `overload_debug_info()` are the JAX package's
/debug/slo and /debug/overload payloads. A shed answer comes back from
the engine with its error and decision path `shed`.

`serve_get_rate_limits_bytes` is the grpc-free serving core of
V1/GetRateLimits over wire bytes (the JAX package's
`service/grpc_service.py`): the columnar edge first
(service/fastpath.py), else the object path over requests built from
the native parse, answered in bytes equal to protobuf's.
"""

from __future__ import annotations

import asyncio
import time
from typing import List, Optional, Sequence

from gubernator_tpu_torch import wire
from gubernator_tpu_torch.api.types import (
    Behavior,
    HealthCheckResp,
    MAX_BATCH_SIZE,
    RateLimitReq,
    RateLimitResp,
    validate_request,
)
from gubernator_tpu_torch.metrics import Metrics
from gubernator_tpu_torch.runtime.engine import MeshEngine
from gubernator_tpu_torch.service import fastpath
from gubernator_tpu_torch.service.admission import DecisionRecorder, PATH_OWNER, stamp_decision
from gubernator_tpu_torch.utils import clock as _clock


class ApiError(Exception):
    """Whole-call failure, mapped to gRPC OUT_OF_RANGE / HTTP 400 etc."""

    def __init__(self, message: str, grpc_code: str = "INVALID_ARGUMENT", http_code: int = 400):
        super().__init__(message)
        self.grpc_code = grpc_code
        self.http_code = http_code


class V1Service:
    def __init__(self, engine: MeshEngine, now_fn=_clock.now_ms, *,
                 force_global: bool = False, fast_edge: bool = True,
                 metrics: Optional[Metrics] = None, admission_ring: int = 256):
        self.engine = engine
        self.metrics = metrics or Metrics()
        # GUBER_FORCE_GLOBAL: every item is GLOBAL
        self.force_global = force_global
        self.now_fn = now_fn
        # The columnar edge serves wire-byte calls (the JAX daemon's
        # default for a node without a Loader, daemon.py:135).
        self.fast_edge = fast_edge
        # the pre-resolved child (labels() lookups are hot-loop cost): a
        # standalone node owns every key, GLOBAL ones too, so every call
        # is calltype "local"
        m = self.metrics
        self._m_local = m.getratelimit_counter.labels("local")
        # Admission observatory: every answer is counted by serving path
        # and kept in the bounded ring; the scrape bridge publishes the
        # engine's measured over-admission ratio.
        self.recorder = DecisionRecorder(m, ring_size=admission_ring)
        m.add_sync(self._admission_sync)
        # The SLO observatory (service/slo.py), set by the composition
        # root; its scrape bridge is registered now and does nothing
        # until it is.
        self.slo = None  # SloObservatory
        m.add_sync(self._slo_sync)
        # The overload control plane (service/overload.py OverloadManager,
        # whose governor the composition root sets on engine.overload).
        # None leaves intake as it is; its bridge does nothing until set.
        self.overload = None  # OverloadManager
        m.add_sync(self._overload_sync)

    # ---- V1.GetRateLimits (reference gubernator.go:183-309) ----------------

    async def get_rate_limits(self, reqs: Sequence[RateLimitReq]) -> List[RateLimitResp]:
        m = self.metrics
        if len(reqs) > MAX_BATCH_SIZE:
            m.check_error_counter.labels("Request too large").inc()
            raise ApiError(
                f"Requests.RateLimits list too large; max size is '{MAX_BATCH_SIZE}'",
                grpc_code="OUT_OF_RANGE",
            )
        m.concurrent_checks.inc()
        t0 = time.perf_counter()
        try:
            return await self._get_rate_limits(reqs)
        finally:
            m.concurrent_checks.dec()
            m.func_duration.labels("V1Instance.GetRateLimits").observe(
                time.perf_counter() - t0
            )

    async def _get_rate_limits(self, reqs: Sequence[RateLimitReq]) -> List[RateLimitResp]:
        m = self.metrics
        now = self.now_fn()
        glob = int(Behavior.GLOBAL)
        responses: List[Optional[RateLimitResp]] = [None] * len(reqs)
        local_items: List[tuple] = []  # (idx, req) -> one bulk engine submit
        for i, req in enumerate(reqs):
            err = validate_request(req)
            if err is not None:
                m.check_error_counter.labels("Invalid request").inc()
                responses[i] = RateLimitResp(error=err)
                continue
            if req.created_at is None or req.created_at == 0:
                req.created_at = now
            if self.force_global:
                req.behavior |= glob
            self._m_local.inc()
            local_items.append((i, req))

        if local_items:
            stage_md = bool(getattr(self.engine.cfg, "stage_metadata", False))
            fut = self.engine.check_bulk([r for _, r in local_items])
            try:
                results = await asyncio.wrap_future(fut)
                for (i, req), resp in zip(local_items, results):
                    responses[i] = resp
                    # Owner answers are authoritative: staleness bound 0.
                    if stage_md and not resp.error:
                        stamp_decision(resp, PATH_OWNER, 0)
                    self.recorder.record_decision(PATH_OWNER, resp, key=req.hash_key())
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

    # ---- observatories -----------------------------------------------------

    def admission_debug_info(self, include_ring: bool = True) -> dict:
        """The /debug/admission payload: the engine's TTL-cached window
        accounting, the decision counters by path, the over-admission
        bound this node adds (no leases or cross-node GLOBAL legs yet:
        0), and, locally only, the decision ring. Host-side copies and a
        TTL-cached scan."""
        blob: dict = {"v": 1}
        if hasattr(self.engine, "admission_snapshot"):
            blob["window"] = self.engine.admission_snapshot()
        rec = self.recorder.snapshot()
        blob["decisions"] = rec["decisions"]
        blob["ring_size"] = rec["ring_size"]
        if include_ring:
            blob["ring"] = rec["ring"]
        # lease slices and queued GLOBAL hits are the bound's legs; a
        # standalone node without them adds none
        blob["bound"] = {"total_hits": 0}
        return blob

    def device_debug_info(self) -> dict:
        """The /debug/device payload: per-subsystem device memory and
        headroom, and the compile counters (0: the port compiles nothing
        while it serves). Host-side reads only."""
        info: dict = {"v": 1}
        if hasattr(self.engine, "device_memory"):
            info["memory"] = self.engine.device_memory()
        info["compile"] = {"compiles": 0, "compile_seconds": 0.0, "cache_hits": 0}
        return info

    def slo_debug_info(self) -> dict:
        """The /debug/slo payload: each SLO's burn rates over its
        windows, alert state and remaining budget, the sampled SLIs'
        ring summaries and the watchdog's table. Ring arithmetic over
        values already sampled: no device work."""
        if self.slo is None:
            return {"enabled": False}
        return {"enabled": True, **self.slo.debug_info()}

    def overload_debug_info(self) -> dict:
        """The /debug/overload payload: the brownout ladder's level and
        signals and the intake governor's state (sheds by reason, tenant
        weights, heavy hitters). Host-side copies only."""
        if self.overload is None:
            return {"enabled": False}
        return self.overload.debug_info()

    def _overload_sync(self, _metrics=None) -> None:
        """Scrape-time bridge of gubernator_overload_level; nothing until
        the overload manager is set."""
        if self.overload is None:
            return
        try:
            self.overload.metrics_sync(self.metrics)
        except Exception:  # a failed ladder read must not poison /metrics
            return

    def _slo_sync(self, _metrics=None) -> None:
        """Scrape-time bridge of the SLO families (burn rate, budget
        remaining, alert state) and gubernator_thread_stalled; nothing
        until the observatory is set."""
        if self.slo is None:
            return
        try:
            self.slo.metrics_sync(self.metrics)
        except Exception:  # a failed evaluation must not poison /metrics
            return

    def _admission_sync(self, _metrics=None) -> None:
        """Scrape-time bridge: this node's measured over-admission ratio
        (excess hits over configured limits in active windows, from the
        engine's TTL-cached admission scan), the single writer of
        gubernator_admission_excess_ratio. `Metrics.sync()` passes the
        Metrics to every callback."""
        if not hasattr(self.engine, "admission_snapshot"):
            return
        try:
            snap = self.engine.admission_snapshot()
        except Exception:  # a failed scan must not poison /metrics
            return
        self.metrics.admission_excess_ratio.set(float(snap.get("excess_ratio", 0.0)))


async def serve_get_rate_limits_bytes(svc: V1Service, data: bytes) -> bytes:
    """V1/GetRateLimits over wire bytes: a GetRateLimitsReq in, a
    GetRateLimitsResp out. The columnar edge serves first, in an executor
    (the native parse and the kernels release the interpreter lock);
    a mixed batch's Gregorian items go through the object path and are
    spliced back in request order. Otherwise the object path serves
    requests built from the native parse. Raises ApiError for whole-call
    failures: bytes the parse rejects, a name or key that is not UTF-8,
    and an item metadata map protobuf would refuse (`wire.metadata_ok`,
    walked only when the parse flagged an item `slow`) are
    INVALID_ARGUMENT ("malformed request"), as protobuf's decode error is
    for the JAX package."""
    if fastpath.enabled(svc):
        res = await asyncio.get_running_loop().run_in_executor(
            None, fastpath.try_serve, svc, data
        )
        if isinstance(res, bytes):
            return res
        if res is not None:
            _, n, local_pos, local_out, other_reqs = res
            # The columnar hits are committed: a failure of the rest
            # degrades those items to per-item errors, never the call (a
            # client retry would charge every columnar key twice).
            try:
                other = await svc.get_rate_limits(other_reqs)
            except Exception as e:
                other = [RateLimitResp(error=str(e)) for _ in other_reqs]
            return fastpath.merge_mixed(n, local_pos, local_out, other)
    cols = wire.parse_requests(data)
    if cols is None or (cols.slow.any() and not wire.metadata_ok(data)):
        raise ApiError("malformed request", grpc_code="INVALID_ARGUMENT")
    reqs = []
    for i in range(cols.n):
        if cols.slow[i]:
            try:
                cols.name_key_parts(i, errors="strict")
            except UnicodeDecodeError:
                raise ApiError("malformed request", grpc_code="INVALID_ARGUMENT") from None
        reqs.append(wire.req_from_columns(cols, i))
    return wire.encode_responses(await svc.get_rate_limits(reqs))
