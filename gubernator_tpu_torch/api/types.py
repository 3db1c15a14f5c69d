"""Core request/response types and enums.

Semantics match the reference proto contract (reference
gubernator.proto:56-213). These are plain dataclasses used on the host;
field names, enum values and error strings are identical to
`gubernator_tpu.api.types`, so responses from the two packages compare
field by field.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, Optional

# Hard cap on items per GetRateLimits call (reference gubernator.go:40).
MAX_BATCH_SIZE = 1000


class Algorithm(enum.IntEnum):
    """Rate limit algorithm (reference gubernator.proto:56-61)."""

    TOKEN_BUCKET = 0
    LEAKY_BUCKET = 1


class Behavior(enum.IntFlag):
    """Per-request behavior bit flags (reference gubernator.proto:64-135)."""

    BATCHING = 0  # default; present for parity, has no effect when used
    NO_BATCHING = 1
    GLOBAL = 2
    DURATION_IS_GREGORIAN = 4
    RESET_REMAINING = 8
    MULTI_REGION = 16
    DRAIN_OVER_LIMIT = 32


class Status(enum.IntEnum):
    """Rate limit decision status (reference gubernator.proto:185-188)."""

    UNDER_LIMIT = 0
    OVER_LIMIT = 1


@dataclass
class RateLimitReq:
    """A single rate limit check (reference gubernator.proto:137-183)."""

    name: str = ""
    unique_key: str = ""
    hits: int = 0
    limit: int = 0
    duration: int = 0  # milliseconds (or Gregorian interval enum)
    algorithm: int = Algorithm.TOKEN_BUCKET
    behavior: int = 0
    burst: int = 0
    metadata: Dict[str, str] = field(default_factory=dict)
    # Epoch ms when the request was created; filled by the server if unset
    # (reference gubernator.proto:172-182).
    created_at: Optional[int] = None

    def hash_key(self) -> str:
        """The canonical cache/ownership key (reference client.go:39-41)."""
        return self.name + "_" + self.unique_key


@dataclass
class RateLimitResp:
    """A single rate limit decision (reference gubernator.proto:190-203)."""

    status: int = Status.UNDER_LIMIT
    limit: int = 0
    remaining: int = 0
    reset_time: int = 0  # epoch ms when the limit window resets
    error: str = ""
    metadata: Dict[str, str] = field(default_factory=dict)


@dataclass
class UpdatePeerGlobal:
    """Owner-to-replica state push for one GLOBAL key (reference
    peers.proto:52-72): what `IciEngine.inject_globals` lands on every
    replica."""

    key: str = ""
    status: RateLimitResp = field(default_factory=RateLimitResp)
    algorithm: int = Algorithm.TOKEN_BUCKET
    duration: int = 0
    created_at: int = 0


@dataclass
class HealthCheckResp:
    """Service health (reference gubernator.proto:206-213)."""

    status: str = "healthy"
    message: str = ""
    peer_count: int = 0


# RateLimitResp.error is a free-form string on the wire; "UNAVAILABLE:"
# marks a retryable condition: the request was NOT applied and may be
# re-dispatched.
RETRYABLE_PREFIX = "UNAVAILABLE:"

# The engine pump is shutting down and could not serve this request.
ERR_ENGINE_DRAINING = RETRYABLE_PREFIX + " engine draining; retry"

# The engine intake governor shed this request before it was enqueued
# (intake budget exceeded, CoDel standing-queue shed, or brownout): the
# request was NOT applied; the answer carries the server's suggested
# backoff under RETRY_AFTER_MD_KEY (service/overload.py).
ERR_OVERLOADED = RETRYABLE_PREFIX + " intake overloaded; retry"

# Answer metadata key of a server-suggested backoff in milliseconds (the
# JAX package keeps it in parallel/leases.py; the port's leases, when
# ported, import it from here).
RETRY_AFTER_MD_KEY = "retry_after_ms"


def is_retryable_error(error: str) -> bool:
    """True when a RateLimitResp.error marks a request that was NOT
    applied and can be safely re-dispatched (drain/overload shedding)."""
    return bool(error) and error.startswith(RETRYABLE_PREFIX)


def validate_request(req: RateLimitReq) -> Optional[str]:
    """Per-item validation; returns an error string or None.

    Error strings and check order match the reference exactly
    (reference gubernator.go:208-216).
    """
    if not req.unique_key:
        return "field 'unique_key' cannot be empty"
    if not req.name:
        return "field 'namespace' cannot be empty"
    return None
