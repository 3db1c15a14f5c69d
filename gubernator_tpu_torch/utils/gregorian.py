"""Gregorian calendar-aligned durations and expirations.

Behavior flag DURATION_IS_GREGORIAN reinterprets a request's `duration`
field as a calendar interval enum; expiry then lands at the end of the
current calendar interval (reference interval.go:74-148).

All calendar math stays on the host: the device kernel only ever sees
already-resolved epoch-millisecond timestamps (the kernel is calendar-free
by design — see SURVEY.md §7 hard part (e)).

Deviation from the reference: interval.go:99 computes the Gregorian-month
duration as `end.UnixNano() - begin.UnixNano()/1000000`, a precedence bug
yielding nanosecond-scale garbage. We return the intended value
(end - begin in ms). Weeks are unsupported in the reference
(interval.go:92-93) and unsupported here, with the same error text.

Deviation (intentional): interval boundaries are computed in UTC, while
the reference uses the server's local timezone (interval.go now.Location()).
A distributed cluster whose nodes disagree on /etc/localtime would compute
different day/month/year reset times per node; pinning to UTC makes
Gregorian windows identical across every peer and replica. Operators who
need local-midnight semantics should run with TZ=UTC parity at the client
instead. Listed in docs/architecture.md "Known deviations".
"""

from __future__ import annotations

import datetime as _dt

GREGORIAN_MINUTES = 0
GREGORIAN_HOURS = 1
GREGORIAN_DAYS = 2
GREGORIAN_WEEKS = 3
GREGORIAN_MONTHS = 4
GREGORIAN_YEARS = 5

_ERR_WEEKS = "`Duration = GregorianWeeks` not yet supported; consider making a PR!`"
_ERR_INVALID = (
    "behavior DURATION_IS_GREGORIAN is set; but `Duration` is not a valid "
    "gregorian interval"
)


class GregorianError(ValueError):
    pass


def _from_ms(now_ms: int) -> _dt.datetime:
    return _dt.datetime.fromtimestamp(now_ms / 1000.0, tz=_dt.timezone.utc)


def _to_ms(t: _dt.datetime) -> int:
    return int(t.timestamp() * 1000)


def gregorian_duration(now_ms: int, d: int) -> int:
    """Entire duration of the Gregorian interval containing `now_ms`, in ms
    (reference interval.go:83-109)."""
    if d == GREGORIAN_MINUTES:
        return 60_000
    if d == GREGORIAN_HOURS:
        return 3_600_000
    if d == GREGORIAN_DAYS:
        return 86_400_000
    if d == GREGORIAN_WEEKS:
        raise GregorianError(_ERR_WEEKS)
    if d == GREGORIAN_MONTHS:
        now = _from_ms(now_ms)
        begin = now.replace(day=1, hour=0, minute=0, second=0, microsecond=0)
        if begin.month == 12:
            end = begin.replace(year=begin.year + 1, month=1)
        else:
            end = begin.replace(month=begin.month + 1)
        return _to_ms(end) - _to_ms(begin)
    if d == GREGORIAN_YEARS:
        now = _from_ms(now_ms)
        begin = now.replace(month=1, day=1, hour=0, minute=0, second=0, microsecond=0)
        end = begin.replace(year=begin.year + 1)
        return _to_ms(end) - _to_ms(begin)
    raise GregorianError(_ERR_INVALID)


def gregorian_expiration(now_ms: int, d: int) -> int:
    """End of the current Gregorian interval, epoch ms
    (reference interval.go:117-148).

    The reference returns `end-of-interval - 1ns` truncated to ms, which is
    the last whole millisecond of the interval; we compute `end_ms - 1`.
    """
    if d == GREGORIAN_WEEKS:
        raise GregorianError(_ERR_WEEKS)
    now = _from_ms(now_ms)
    if d == GREGORIAN_MINUTES:
        begin = now.replace(second=0, microsecond=0)
        end = begin + _dt.timedelta(minutes=1)
    elif d == GREGORIAN_HOURS:
        begin = now.replace(minute=0, second=0, microsecond=0)
        end = begin + _dt.timedelta(hours=1)
    elif d == GREGORIAN_DAYS:
        begin = now.replace(hour=0, minute=0, second=0, microsecond=0)
        end = begin + _dt.timedelta(days=1)
    elif d == GREGORIAN_MONTHS:
        begin = now.replace(day=1, hour=0, minute=0, second=0, microsecond=0)
        if begin.month == 12:
            end = begin.replace(year=begin.year + 1, month=1)
        else:
            end = begin.replace(month=begin.month + 1)
    elif d == GREGORIAN_YEARS:
        begin = now.replace(month=1, day=1, hour=0, minute=0, second=0, microsecond=0)
        end = begin.replace(year=begin.year + 1)
    else:
        raise GregorianError(_ERR_INVALID)
    return _to_ms(end) - 1
