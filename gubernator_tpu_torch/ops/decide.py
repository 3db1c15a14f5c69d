"""The decide wave's shared branches, and the `wide` layout's table ops,
as torch ops.

Twins of `_leak_fixed`, `_token_paths` and `_leaky_paths` in
`gubernator_tpu/ops/decide.py`: every branch (reference
algorithms.go:37-493) is a masked int64 vector op, in the same order and
with the same wrapping arithmetic, so results are bit-exact with the JAX
package and the oracle. torch int64 `//` and `%` floor like JAX's, `<<`
and `+`/`*` wrap, and `>>` is arithmetic. `st` is the chosen slot's
state as a dict of (B,) tensors, zeroed on lanes whose key does not
exist; each path returns (state_update, response) dicts of full-lane
values, and the caller selects per lane by algorithm.

The `wide` layout (a `SlotTable`, one column per field) is an XLA
program in the JAX package, never a Pallas kernel (`pallas_decide.py`
lowers fused and narrow only), so here it is torch ops on either
device: `_choose_slot`, `_decide_impl`, `decide`, `decide_scan`,
`probe_exists` and `gather_rows`. `select_ways` is the way policy every
layout shares. The table is updated IN PLACE, where JAX donates it. A
gather reads a past-the-end index as the last row (`take`: JAX clamps
it), and a write to a slot past the end is dropped (JAX's mode="drop"),
so a paged table's lanes on a page that is not resident, whose groups
are translated past the frames, behave as in the JAX package.
"""

from __future__ import annotations

from typing import List

import torch

from gubernator_tpu_torch.api.types import Algorithm, Behavior, Status
from gubernator_tpu_torch.models.bucket import FIXED_SHIFT, MAX_ELAPSED_MS
from gubernator_tpu_torch.ops.layout import DecideOutput, SlotTable

I8 = torch.int8
I64 = torch.int64
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


# ---- the way policy and the wide layout ---------------------------------------


def take(col: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """col[idx], an index past the end read as the last row (JAX's gather
    clamps it)."""
    return col[torch.clamp(idx, 0, col.shape[0] - 1)]


def select_ways(w_match, w_used, w_expired, w_lru):
    """The way policy over (B, W) columns: (exists, matched_way,
    insert_way, cat). A live match first (the lowest such way);
    otherwise insert by matched-expired > empty > expired > least
    recently used, ties to the lowest way (argmax/argmin return the
    first index)."""
    live_match = w_match & ~w_expired
    exists = live_match.any(dim=1)
    matched_way = torch.argmax(live_match.to(torch.uint8), dim=1)
    cat = torch.where(
        w_match & w_expired,
        0,
        torch.where(~w_used, 1, torch.where(w_expired, 2, 3)),
    ).to(I64)
    way_off = torch.arange(w_used.shape[1], dtype=I64, device=w_used.device)
    tie = torch.where(cat == 3, torch.clamp(w_lru, 0, (1 << 44) - 1), way_off[None, :])
    insert_way = torch.argmin((cat << 44) + tie, dim=1)
    return exists, matched_way, insert_way, cat


def pick(cols: torch.Tensor, way: torch.Tensor) -> torch.Tensor:
    """Row-wise way selection: cols[b, way[b]] of (B, W) columns."""
    return torch.gather(cols, 1, way[:, None])[:, 0]


def way_slots(group: torch.Tensor, ways: int):
    """(grp_base, way_ix): each lane's first slot and its (B, W) slots."""
    grp_base = group.to(I64) * ways
    return grp_base, grp_base[:, None] + torch.arange(ways, dtype=I64, device=group.device)[None, :]


def expired_ways(w_used, w_expire, w_invalid, now: int):
    """Lazy expiry on read (reference cache.go:43-57, lrucache.go:115-118):
    a used way whose window ended or whose store mark passed."""
    return w_used & ((w_expire < now) | ((w_invalid != 0) & (w_invalid < now)))


def _choose_slot(table: SlotTable, batch, now: int, ways: int):
    """Each lane's W-way group probed (`select_ways`): (slot, exists,
    evicts_live, evicted_hi, evicted_lo), the evicted key the chosen
    way's occupant when the lane inserts over another live key. Reads
    only key_hi, key_lo, group and active of `batch`."""
    grp_base, way_ix = way_slots(batch.group, ways)
    w_key_hi = take(table.key_hi, way_ix)
    w_key_lo = take(table.key_lo, way_ix)
    w_used = take(table.used, way_ix)
    w_expired = expired_ways(w_used, take(table.expire_at, way_ix),
                             take(table.invalid_at, way_ix), now)
    w_match = w_used & (w_key_hi == batch.key_hi[:, None]) & (w_key_lo == batch.key_lo[:, None])
    exists, matched_way, insert_way, cat = select_ways(
        w_match, w_used, w_expired, take(table.lru, way_ix))
    way = torch.where(exists, matched_way, insert_way)
    evicts_live = ~exists & (pick(cat, insert_way) == 3) & batch.active
    old_hi, old_lo = pick(w_key_hi, way), pick(w_key_lo, way)
    displaced = (batch.active & ~exists & pick(w_used, way)
                 & ((old_hi != batch.key_hi) | (old_lo != batch.key_lo)))
    evicted_hi = torch.where(displaced, old_hi, 0)
    evicted_lo = torch.where(displaced, old_lo, 0)
    return grp_base + way, exists, evicts_live, evicted_hi, evicted_lo


def both_paths(batch, st, exists):
    """Both buckets' branches, selected per lane by the request's
    algorithm: (new_state, response) dicts."""
    b_greg, b_reset, b_drain = ((batch.behavior & int(b)) != 0 for b in (
        Behavior.DURATION_IS_GREGORIAN, Behavior.RESET_REMAINING, Behavior.DRAIN_OVER_LIMIT))
    tok_state, tok_resp = _token_paths(batch, st, b_greg, b_reset, b_drain, exists)
    lky_state, lky_resp = _leaky_paths(batch, st, b_greg, b_reset, b_drain, exists)
    is_leaky = batch.algo == int(Algorithm.LEAKY_BUCKET)
    return ({k: torch.where(is_leaky, lky_state[k], tok_state[k]) for k in tok_state},
            {k: torch.where(is_leaky, lky_resp[k], tok_resp[k]) for k in tok_resp})


def scatter(cols: dict, table, idx: torch.Tensor) -> None:
    """Write each lane's values into the table's columns at `idx`, in
    place; an index past the end writes nothing (JAX's mode="drop").
    Without a wait for the device: a dropped lane repeats the first kept
    lane's write (or, with none kept, writes row 0 back as it is), so
    every slot written twice gets equal values and no lane needs to be
    compacted out on the host. Kept lanes have distinct slots (distinct
    groups per wave)."""
    if idx.numel() == 0:
        return
    keep = idx < table.num_slots
    k = torch.argmax(keep.to(torch.uint8))
    any_keep = keep[k]
    dst = torch.where(keep, idx, torch.where(any_keep, idx[k], 0))
    for f, val in cols.items():
        col = getattr(table, f)
        val = val.to(col.dtype)
        col[dst] = torch.where(keep, val, torch.where(any_keep, val[k], col[0]))


def lane_outputs(batch, resp, idx, evicted_hi, evicted_lo, freed, exists,
                 evicts_live) -> DecideOutput:
    """A wave's DecideOutput: answers of active lanes, zeros elsewhere."""
    act = batch.active
    z8 = torch.zeros((), dtype=I8, device=act.device)
    return DecideOutput(
        status=torch.where(act, resp["status"], z8),
        limit=torch.where(act, batch.limit, 0),
        remaining=torch.where(act, resp["remaining"], 0),
        reset_time=torch.where(act, resp["reset_time"], 0),
        slot=idx,
        evicted_hi=evicted_hi,
        evicted_lo=evicted_lo,
        freed=act & freed,
        hits=(act & exists).sum(),
        misses=(act & ~exists).sum(),
        unexpired_evictions=evicts_live.sum(),
        over_limit=(act & resp["over"]).sum(),
    )


_STATE = ("algo", "status", "limit", "duration", "remaining", "stamp", "expire_at",
          "burst", "invalid_at")


def _decide_impl(table: SlotTable, batch, now: int, *, ways: int) -> DecideOutput:
    """One decide wave on a wide table, in place (`_decide_impl`)."""
    now = int(now)
    slot, exists, evicts_live, evicted_hi, evicted_lo = _choose_slot(table, batch, now, ways)
    # the chosen slot's state, zeroed for fresh lanes
    st = {k: torch.where(exists, take(getattr(table, k), slot), 0) for k in _STATE}
    new_state, resp = both_paths(batch, st, exists)
    idx = torch.where(batch.active, slot, table.num_slots)
    freed = ~new_state["used"]  # token RESET_REMAINING frees the slot
    scatter(dict(
        key_hi=torch.where(freed, 0, batch.key_hi),
        key_lo=torch.where(freed, 0, batch.key_lo),
        used=new_state["used"],
        algo=batch.algo,
        **{k: new_state[k] for k in ("status", "limit", "duration", "remaining", "stamp",
                                     "expire_at", "burst")},
        # the store's mark survives updates on a live entry; fresh
        # inserts and freed slots clear it
        invalid_at=torch.where(exists & ~freed, st["invalid_at"], 0),
        lru=torch.full_like(batch.key_hi, now),
    ), table, idx)
    return lane_outputs(batch, resp, idx, evicted_hi, evicted_lo, freed, exists, evicts_live)


def decide(table: SlotTable, batch, now, ways: int = 8):
    """One decide wave on a wide table, updated in place: (table,
    DecideOutput)."""
    return table, _decide_impl(table, batch, now, ways=ways)


def stack_outputs(outs: List[DecideOutput], lanes: int, device) -> DecideOutput:
    """Per-step outputs stacked: (T, B) lanes and (T,) sums; with no step,
    (0, B) and (0,) of the output dtypes."""
    if outs:
        return DecideOutput(*(torch.stack(f) for f in zip(*outs)))
    dtypes = {"status": I8, "freed": torch.bool}
    return DecideOutput(**{
        f: torch.empty((0, lanes) if i < 8 else (0,), dtype=dtypes.get(f, I64), device=device)
        for i, f in enumerate(DecideOutput._fields)
    })


def run_scan(decide_fn, table, batches, nows, ways: int):
    """T decide waves in order, step t row t of the (T, B) `batches` at
    `nows[t]`, the table carried from step to step (JAX's `lax.scan`):
    (table, stacked outputs)."""
    steps, lanes = batches.key_hi.shape
    outs = []
    for t in range(steps):
        table, out = decide_fn(table, type(batches)(*(c[t] for c in batches)), int(nows[t]), ways)
        outs.append(out)
    return table, stack_outputs(outs, lanes, batches.key_hi.device)


def decide_scan(table: SlotTable, batches, nows, ways: int = 8):
    """T decide waves on a wide table in order (`decide_scan`)."""
    return run_scan(decide, table, batches, nows, ways)


def probe_exists(table: SlotTable, key_hi, key_lo, group, now, ways: int = 8) -> torch.Tensor:
    """(B,) bool: the lane's key is live in its group (used, not expired,
    not invalidated): the store path's residency probe."""
    _grp_base, way_ix = way_slots(group, ways)
    w_used = take(table.used, way_ix)
    w_expired = expired_ways(w_used, take(table.expire_at, way_ix),
                             take(table.invalid_at, way_ix), int(now))
    live = (w_used & ~w_expired & (take(table.key_hi, way_ix) == key_hi[:, None])
            & (take(table.key_lo, way_ix) == key_lo[:, None]))
    return live.any(dim=1)


def gather_rows(table: SlotTable, slots: torch.Tensor) -> SlotTable:
    """Rows at `slots` as the wide struct; a slot >= N reads as zeros."""
    valid = slots < table.num_slots
    return SlotTable(*(torch.where(valid, take(c, slots), torch.zeros((), dtype=c.dtype,
                                                                        device=c.device))
                       for c in table))
