"""Token- and leaky-bucket branches of the decide wave as torch ops.

Twins of `_leak_fixed`, `_token_paths` and `_leaky_paths` in
`gubernator_tpu/ops/decide.py`: every branch (reference
algorithms.go:37-493) is a masked int64 vector op, in the same order and
with the same wrapping arithmetic, so results are bit-exact with the JAX
package and the oracle. torch int64 `//` and `%` floor like JAX's, `<<`
and `+`/`*` wrap, and `>>` is arithmetic.

`st` is the chosen slot's state as a dict of (B,) tensors, zeroed on
lanes whose key does not exist. Each function returns
(state_update, response) dicts of full-lane values; the caller selects
per lane by algorithm.
"""

from __future__ import annotations

import torch

from gubernator_tpu_torch.api.types import Algorithm, Status
from gubernator_tpu_torch.models.bucket import FIXED_SHIFT, MAX_ELAPSED_MS

I8 = torch.int8
OVER = int(Status.OVER_LIMIT)
UNDER = int(Status.UNDER_LIMIT)


def _leak_fixed(elapsed, limit, rate_num, burst):
    """min(floor(elapsed*limit*2^20 / rate_num), (burst+1) << 20) for
    elapsed > 0, without 128-bit intermediates (a 16-bit split of
    `limit`); 0 for elapsed <= 0."""
    limit_g = torch.clamp(limit, min=1)
    rn = torch.clamp(rate_num, min=1)
    cap_t = burst + 1
    e_c = torch.clamp(elapsed, 0, MAX_ELAPSED_MS)
    a = e_c // rn
    e = e_c % rn
    a_lim = cap_t // limit_g + 1
    a_c = torch.minimum(a, a_lim)
    whole = a_c * limit
    saturated = (a > a_lim) | (whole >= cap_t)
    hi = limit >> 16
    lo = limit & 0xFFFF
    p1 = e * hi
    q1 = p1 // rn
    r1 = p1 % rn
    q2 = (r1 << 16) // rn
    r2 = (r1 << 16) % rn
    p2 = e * lo
    q3 = (r2 + p2) // rn
    r3 = (r2 + p2) % rn
    tok = (q1 << 16) + q2 + q3
    frac_s = (r3 << FIXED_SHIFT) // rn
    cap_s = cap_t << FIXED_SHIFT
    leak = torch.minimum(((whole + tok) << FIXED_SHIFT) + frac_s, cap_s)
    leak = torch.where(saturated, cap_s, leak)
    return torch.where(elapsed <= 0, torch.zeros_like(leak), leak)


def _token_paths(batch, st, b_greg, b_reset, b_drain, exists_any):
    """All token-bucket branches (reference algorithms.go:37-257)."""
    r_hits, r_limit = batch.hits, batch.limit
    created = batch.created_at
    w = torch.where

    # --- existing-item path ---
    # limit hot-change (algorithms.go:105-113)
    limit_changed = st["limit"] != r_limit
    rem0 = w(
        limit_changed,
        torch.clamp(st["remaining"] + (r_limit - st["limit"]), min=0),
        st["remaining"],
    )
    # duration hot-change, possibly renewing (algorithms.go:122-147)
    dur_changed = st["duration"] != batch.duration
    expire1 = w(b_greg, batch.greg_expire, st["stamp"] + batch.duration)
    renew = dur_changed & (expire1 <= created)
    expire2 = w(renew, created + batch.duration, expire1)
    stamp1 = w(renew, created, st["stamp"])
    rem1 = w(renew, r_limit, rem0)
    new_expire = w(dur_changed, expire2, st["expire_at"])
    rl_reset = new_expire

    # branch masks in reference order (hits==0 -> at-limit -> exact -> over)
    m_hits0 = r_hits == 0
    m_atlim = ~m_hits0 & (rem0 == 0) & (r_hits > 0)  # STALE pre-renewal rem
    m_exact = ~m_hits0 & ~m_atlim & (rem1 == r_hits)
    m_over = ~m_hits0 & ~m_atlim & ~m_exact & (r_hits > rem1)
    m_cons = ~m_hits0 & ~m_atlim & ~m_exact & ~m_over

    rem_state = w(
        m_exact, 0,
        w(m_over, w(b_drain, 0, rem1), w(m_cons, rem1 - r_hits, rem1)),
    )
    sticky = st["status"].to(I8)
    status_state = w(m_atlim, OVER, sticky)
    resp_status = w(m_atlim | m_over, OVER, sticky)
    resp_rem = w(
        m_exact, 0,
        w(m_over, w(b_drain, 0, rem0), w(m_cons, rem1 - r_hits, rem0)),
    )

    # --- new-item path (algorithms.go:206-257) ---
    expire_new = w(b_greg, batch.greg_expire, created + batch.duration)
    over_new = r_hits > r_limit
    rem_new = w(over_new, r_limit, r_limit - r_hits)
    resp_status_new = over_new.to(I8)

    # --- RESET_REMAINING on an existing item (algorithms.go:78-90): free
    # the slot, fixed response, whatever the stored algorithm is.
    m_reset = exists_any & b_reset

    fresh = ~exists_any | (st["algo"] != int(Algorithm.TOKEN_BUCKET))
    use_new = ~m_reset & fresh

    state = dict(
        used=~m_reset,
        limit=r_limit,
        duration=batch.duration,
        remaining=w(use_new, rem_new, rem_state),
        stamp=w(use_new, created, stamp1),
        expire_at=w(use_new, expire_new, new_expire),
        status=w(use_new, UNDER, status_state),
        burst=torch.zeros_like(r_limit),
    )
    resp = dict(
        status=w(m_reset, UNDER, w(use_new, resp_status_new, resp_status)),
        remaining=w(m_reset, r_limit, w(use_new, rem_new, resp_rem)),
        reset_time=w(m_reset, 0, w(use_new, expire_new, rl_reset)),
        over=~m_reset & w(use_new, over_new, m_atlim | m_over),
    )
    return state, resp


def _leaky_paths(batch, st, b_greg, b_reset, b_drain, exists_any):
    """All leaky-bucket branches (reference algorithms.go:260-493)."""
    r_hits, r_limit, r_burst = batch.hits, batch.limit, batch.burst
    created = batch.created_at
    S = FIXED_SHIFT
    w = torch.where

    # --- existing-item path ---
    rem_s0 = w(b_reset, r_burst << S, st["remaining"])
    burst_changed = st["burst"] != r_burst
    rem_s1 = w(burst_changed & (r_burst > (rem_s0 >> S)), r_burst << S, rem_s0)
    # expiry refresh when hits != 0 (algorithms.go:356-358)
    expire_upd = w(r_hits != 0, created + batch.eff_duration, st["expire_at"])
    # leak accrual (algorithms.go:360-367); burst already updated to r_burst
    elapsed = created - st["stamp"]
    leak_s = _leak_fixed(elapsed, r_limit, batch.rate_num, r_burst)
    leaked = (leak_s >> S) > 0
    rem_s2 = w(leaked, rem_s1 + leak_s, rem_s1)
    stamp1 = w(leaked, created, st["stamp"])
    # unconditional burst clamp (algorithms.go:369-371)
    rem_s3 = w((rem_s2 >> S) > r_burst, r_burst << S, rem_s2)

    ri = batch.rate_num // torch.clamp(r_limit, min=1)
    rem_int = rem_s3 >> S

    # branch masks in reference order (at-limit -> exact -> over -> hits==0)
    m_atlim = (rem_int == 0) & (r_hits > 0)
    m_exact = ~m_atlim & (rem_int == r_hits)
    m_over = ~m_atlim & ~m_exact & (r_hits > rem_int)
    m_hits0 = ~m_atlim & ~m_exact & ~m_over & (r_hits == 0)
    m_cons = ~m_atlim & ~m_exact & ~m_over & ~m_hits0

    rem_s_final = w(
        m_exact, 0,
        w(m_over, w(b_drain, 0, rem_s3), w(m_cons, rem_s3 - (r_hits << S), rem_s3)),
    )
    resp_rem = w(
        m_exact, 0,
        w(m_over, w(b_drain, 0, rem_int), w(m_cons, rem_s_final >> S, rem_int)),
    )
    resp_status = (m_atlim | m_over).to(I8)
    base_reset = created + (r_limit - rem_int) * ri
    resp_reset = w(
        m_exact,
        created + r_limit * ri,
        w(m_cons, created + (r_limit - (rem_s_final >> S)) * ri, base_reset),
    )

    # --- new-item path (algorithms.go:437-493); rate from the RAW duration
    # field (pre-Gregorian-override quirk) ---
    ri_new = batch.duration // torch.clamp(r_limit, min=1)
    over_new = r_hits > r_burst
    rem_new = r_burst - r_hits
    rem_s_new = w(over_new, 0, rem_new << S)
    resp_rem_new = w(over_new, 0, rem_new)
    resp_reset_new = created + (r_limit - resp_rem_new) * ri_new
    expire_new = created + batch.eff_duration

    use_new = ~exists_any | (st["algo"] != int(Algorithm.LEAKY_BUCKET))

    state = dict(
        used=torch.ones_like(use_new),
        limit=r_limit,
        # Found path stores the RAW duration (algorithms.go:333); new items
        # store the effective duration (algorithms.go:455-456).
        duration=w(use_new, batch.eff_duration, batch.duration),
        remaining=w(use_new, rem_s_new, rem_s_final),
        stamp=w(use_new, created, stamp1),
        expire_at=w(use_new, expire_new, expire_upd),
        status=torch.zeros_like(st["status"]),  # leaky has no stored status
        burst=r_burst,
    )
    resp = dict(
        status=w(use_new, over_new.to(I8), resp_status),
        remaining=w(use_new, resp_rem_new, resp_rem),
        reset_time=w(use_new, resp_reset_new, resp_reset),
        over=w(use_new, over_new, m_atlim | m_over),
    )
    return state, resp
