"""Columnar serving edge: bytes -> columns -> kernel -> bytes.

The port of `gubernator_tpu/service/fastpath.py` for a standalone node
(every key owned locally: no peer picker, no GLOBAL or region manager;
those come with the peer slice). A served call is counted as the object
path counts it (`getratelimit_counter{calltype="local"}`) and its
decisions recorded with path `fastpath` (`count_metrics`,
`record_provenance`). It serves a
whole GetRateLimits call with no per-item Python: the native wire
parse (`wire.py`), `check_columns` on the engine (one hash call, waves
assigned with array operations, one launch per wave), the native
response build. It is an optimization, not a semantic fork: every batch
it cannot serve byte for byte as the object path would falls back to it
(service/server.py `serve_get_rate_limits_bytes`).

Fallback triggers (try_serve returns None):
- malformed, empty or oversized batch;
- any item carrying metadata, or a name or key that is not UTF-8
  (`slow`), or failing validation (those need the object path's
  per-item error strings or its refusal);
- an all-Gregorian batch (DURATION_IS_GREGORIAN needs host-side
  calendar math); a mixed batch keeps the columnar lanes and returns
  the Gregorian items for the object path (`"mixed"`, spliced back by
  `merge_mixed`);
- the engine declines (wave or lane bounds), or raises before any wave
  committed.

GLOBAL items on IciEngine keep their bit and go to its replica tier
through `check_columns`, as on the object path.

The engine's `stage_metadata` turns the edge off: its per-answer
diagnostics are the object path's.

TableCommittedError is re-raised, never turned into a fallback: a
silent fallback would apply the committed hits twice.
"""

from __future__ import annotations

import os

import numpy as np

from gubernator_tpu_torch import wire
from gubernator_tpu_torch.api.keys import key_hash128_batch_raw
from gubernator_tpu_torch.api.types import MAX_BATCH_SIZE, Behavior
from gubernator_tpu_torch.runtime.engine import TableCommittedError

__all__ = ["MAX_BATCH_SIZE", "enabled", "try_serve", "merge_mixed", "count_metrics",
           "record_provenance"]

_SLOW_BEHAVIOR = int(Behavior.DURATION_IS_GREGORIAN)
_GLOBAL = int(Behavior.GLOBAL)


def _disabled() -> bool:
    # Read per call, not at import: a daemon's config may set it later.
    return os.environ.get("GUBER_DISABLE_FAST_EDGE", "") in ("1", "true")


def enabled(svc) -> bool:
    """Whether this service instance serves through the edge."""
    return (
        not _disabled()
        and getattr(svc, "fast_edge", False)
        and wire.available()
        and hasattr(svc.engine, "check_columns")
        # stage_metadata promises per-answer diagnostics that only the
        # object path attaches: a diagnostics mode trades the edge away
        and not getattr(getattr(svc.engine, "cfg", None), "stage_metadata", False)
    )


def count_metrics(svc, n: int) -> None:
    """Count `n` columnar-served items as the object path counts them:
    a standalone node owns every key, GLOBAL ones too, so every item is
    calltype "local"."""
    m = getattr(svc, "_m_local", None)
    if m is not None:
        m.inc(n)


def record_provenance(svc, cols, out, positions) -> None:
    """Record the columnar decisions (path `fastpath`, staleness 0) in
    the service's DecisionRecorder: sums over the status column, one
    sampled ring row per call, its key built only for that lane."""
    rec = getattr(svc, "recorder", None)
    if rec is None:
        return
    status, _limit, remaining, _reset = out

    def sample_key(j):
        return wire.req_from_columns(cols, int(positions[j])).hash_key()

    rec.record_columnar("fastpath", status, remaining, sample_key=sample_key)


def try_serve(svc, data: bytes):
    """Serve one V1 call's raw request bytes columnar.

    Returns:
    - bytes: the whole response (every item served columnar);
    - ("mixed", n, local_pos, local_out, other_reqs): the non-Gregorian
      items (positions `local_pos`) already decided columnar, `local_out`
      their (status, limit, remaining, reset_time); the caller decides
      `other_reqs` (the Gregorian items, as request objects) through the
      object path and splices with `merge_mixed`;
    - None: the object path serves the whole call.

    GLOBAL items: a standalone node owns every key, so they are decided
    on the local table; the bit is stripped for an engine that does not
    route GLOBAL internally (as the object path leaves it to the engine)
    and kept for IciEngine, whose replica tier answers them.
    """
    cols = wire.parse_requests(data)
    if cols is None or cols.n == 0 or cols.n > MAX_BATCH_SIZE:
        return None
    if cols.slow.any():
        return None
    greg = (cols.behavior & _SLOW_BEHAVIOR) != 0
    has_greg = bool(greg.any())
    if has_greg and bool(greg.all()):
        return None
    if getattr(svc, "force_global", False):
        # every V1 item becomes GLOBAL (the object path ORs it per item)
        cols.behavior = cols.behavior | np.int64(_GLOBAL)
    has_global = bool(((cols.behavior & _GLOBAL) != 0).any())
    # Validation needs per-item error strings: object path.
    key_lens = np.diff(cols.key_offsets)
    if np.any(cols.name_lens == 0) or np.any(key_lens - cols.name_lens - 1 == 0):
        return None
    now = svc.engine.now_fn() if has_global else None
    if has_global and not getattr(svc.engine, "routes_global_internally", False):
        # Gregorian lanes keep the bit: their object-path request carries it.
        stripped = cols.behavior & ~np.int64(_GLOBAL)
        cols.behavior = np.where(greg, cols.behavior, stripped) if has_greg else stripped

    if not has_greg:
        try:
            out = svc.engine.check_columns(cols, now=now)
        except TableCommittedError:
            raise
        except Exception:
            # the object path serves the whole call; no wave committed
            # (TableCommittedError above otherwise)
            return None
        if out is None:
            return None
        count_metrics(svc, cols.n)
        record_provenance(svc, cols, out, np.arange(cols.n))
        return wire.build_responses(*out)
    # Gregorian lanes leave the columnar set and come back spliced
    # through merge_mixed, decided by the object path. Their request
    # objects are built BEFORE the decide, so a failure building them
    # cannot strand committed hits.
    local_pos = np.nonzero(~greg)[0]
    other_reqs = [wire.req_from_columns(cols, int(i)) for i in np.nonzero(greg)[0]]
    hashes = key_hash128_batch_raw(
        cols.key_data.tobytes(), cols.key_offsets, svc.engine.cfg.num_groups
    )
    try:
        out = svc.engine.check_columns(cols, now=now, select=local_pos, hashes=hashes)
    except TableCommittedError:
        raise
    except Exception:
        return None
    if out is None:
        return None
    count_metrics(svc, len(local_pos))
    record_provenance(svc, cols, out, local_pos)
    return ("mixed", cols.n, local_pos, out, other_reqs)


def merge_mixed(n: int, local_pos, local_out, other_resps) -> bytes:
    """Splice the columnar-decided items with the object path's answers
    for the rest (`other_resps`, in request order), preserving request
    order. Repeated message items frame independently, so native-built
    runs and encoded items concatenate into one GetRateLimitsResp."""
    status, limit, remaining, reset_time = local_out
    local = np.zeros(n, dtype=bool)
    local[np.asarray(local_pos, dtype=np.int64)] = True
    chunks = []
    li = 0  # next local answer
    oi = 0  # next object-path answer
    run = 0
    for i in range(n):
        if local[i]:
            run += 1
            continue
        if run:
            s = slice(li, li + run)
            chunks.append(wire.build_responses(status[s], limit[s], remaining[s], reset_time[s]))
            li += run
            run = 0
        chunks.append(wire.framed_response(other_resps[oi]))
        oi += 1
    if run:
        s = slice(li, li + run)
        chunks.append(wire.build_responses(status[s], limit[s], remaining[s], reset_time[s]))
    return b"".join(chunks)
