"""GLOBAL behavior over per-shard replicas and a collective sync tick.

The port of `gubernator_tpu/parallel/ici.py`, the in-process stand-in
for the reference globalManager's two gRPC legs (reference
global.go:91-283):

- Every shard of the mesh holds a full REPLICA of the GLOBAL counter
  table and answers the lanes whose home it is, accumulating each
  non-owned hit into its `pending` delta table (`_replica_step` in the
  JAX package).
- A sync tick (`make_sync_step`, every `sync_wait_s` in IciEngine)
  sends the deltas to the owners, applies them with drain semantics and
  rebroadcasts the owners' rows to every replica. Replica tables are
  W-way set-associative, so the merge key-matches across the ways of a
  group; it adopts keys the owner lacks, relocates local survivors into
  free ways, and (`max_sync_groups`) merges only the groups whose
  fingerprints diverge, hold pending deltas or hold expired rows.

Layout on the card. The mesh's shards are one device (parallel/mesh.py),
so the replicas are ONE (D, N, C) tensor of the layout's rows, replica d
at [d], `pending` is (D, N) int64 and `tick` is (D,) int64: exactly the
stacked leaves of the JAX state. Viewed as (D * N, C) rows, the stack is
the sharded table's layout with D shards of `num_rgroups` groups, so a
replica wave is ONE launch of the sharded kernel (csrc/decide_sharded.cu,
`cuda_decide.WaveFlush.launch(..., replica=True)`) whose group column
holds the pair home * num_rgroups + slot: the lane goes to shard `home`
at local group `slot`, and the outputs come out as the JAX psum over
replicas gives them (`slot` + (D - 1) * N for an answered lane, D * N
for padding; `freed` int32). On a CPU table the plain version
(`fused.sharded_plain`) runs instead. Everything else here (the pending
bookkeeping, the inject, the tick) is torch ops on the current stream.

A collective becomes a reduction over the replica axis: `psum` a sum
over dim 0, kept as a (1, ...) tensor that broadcasts to every replica,
`pmin` a min over dim 0. JAX's uint64 arithmetic (`_mix64`, the
fingerprints, the rotated start) runs in int64: products and sums wrap
to the same bits, and a right shift is made logical with a mask. No
operation here waits for the device: data-dependent shapes are replaced
by fixed-size compactions and masked `index_add_`s, so the tick's only
read-back is its `diag`, which the caller reads.

The state is updated IN PLACE where JAX donates it: the decide, the
inject and the tick write into the same tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gubernator_tpu_torch.api.types import Behavior
from gubernator_tpu_torch.models.bucket import FIXED_SHIFT
from gubernator_tpu_torch.ops import cuda_decide, fused, narrow
from gubernator_tpu_torch.ops.inject import InjectBatch, inject_rows
from gubernator_tpu_torch.ops.kernels import get_kernels
from gubernator_tpu_torch.parallel.mesh import check_mesh_layout
from gubernator_tpu_torch.ops.layout import DecideOutput, SlotTable
from gubernator_tpu_torch.ops.packed import META_USED

I64 = torch.int64

# The replica decide runs layout-native, as the JAX package's does; only
# the tick's merge goes through the wide view.
DEFAULT_LAYOUT = "fused"

_TABLES = {"fused": fused.FusedTable, "narrow": narrow.NarrowTable}


def _i64(u: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    return u - (1 << 64) if u >= 1 << 63 else u


_GOLDEN = _i64(0x9E3779B97F4A7C15)
_MIX1 = _i64(0xBF58476D1CE4E5B9)
_MIX2 = _i64(0x94D049BB133111EB)
_WAY_SALT = _i64(0xD6E8FEB86659FD93)


class IciState(NamedTuple):
    """Per-replica tables and pending hit deltas.

    `table` is the layout's table whose rows are stacked (D, N, C);
    `pending` is (D, N) int64 hit deltas awaiting the next sync,
    recorded at the slot where the key resides on THAT replica; `tick`
    is a (D,) sync-tick counter (identical on every replica), which the
    capped sync mixes into its scan rotation."""

    table: object
    pending: torch.Tensor
    tick: torch.Tensor


def _geometry(mesh, num_slots: int, ways: int):
    """(D, num_rgroups, groups per owner), checked as the JAX package
    checks them, plus the group column's int32 range for the pairs."""
    n_dev = mesh.size
    if ways < 1 or num_slots % ways:
        raise ValueError(f"num_slots {num_slots} must divide by ways {ways}")
    num_groups = num_slots // ways
    if num_groups % n_dev:
        raise ValueError(
            f"num_slots/ways ({num_groups} groups) must divide by mesh size {n_dev}"
        )
    if n_dev * num_groups >= 1 << 31:
        raise ValueError(
            f"{n_dev} replicas x {num_groups} groups: the pair home * groups + slot "
            "must fit the int32 group column"
        )
    return n_dev, num_groups, num_groups // n_dev


def create_ici_state(mesh, num_slots: int, ways: int = 1,
                     layout: str = DEFAULT_LAYOUT) -> IciState:
    """Empty replicas of `num_slots` slots at `ways` ways on every shard
    of `mesh`, on the mesh's device."""
    n_dev, _g, _gp = _geometry(mesh, num_slots, ways)
    check_mesh_layout(layout)
    dev = mesh.device
    ncols = cuda_decide.CODECS[layout].ncols
    return IciState(
        table=_TABLES[layout](torch.zeros((n_dev, num_slots, ncols), dtype=I64, device=dev)),
        pending=torch.zeros((n_dev, num_slots), dtype=I64, device=dev),
        tick=torch.zeros((n_dev,), dtype=I64, device=dev),
    )


def replica_rows(state: IciState) -> torch.Tensor:
    """The stacked replicas as (D * N, C) rows: the sharded kernel's
    table, replica d the rows of shard d."""
    data = state.table.data
    return data.view(data.shape[0] * data.shape[1], data.shape[2])


def pair_groups(home: torch.Tensor, group: torch.Tensor, active: torch.Tensor,
                n_dev: int, num_rgroups: int) -> torch.Tensor:
    """The replica wave's int32 group column: home * num_rgroups +
    group for an active lane with a home in [0, D), else -1 (no replica
    answers it, as no JAX device's `home == dev` holds)."""
    home = home.to(I64)
    ok = active & (home >= 0) & (home < n_dev)
    return torch.where(ok, home * num_rgroups + group.to(I64), -1).to(torch.int32)


def replica_pending(pending: torch.Tensor, batch, out_slot, evicted_hi, evicted_lo,
                    freed, *, num_rgroups: int) -> None:
    """The pending bookkeeping of one replica wave (`_replica_step`),
    in place, from the wave's pair-encoded batch and its psum'd outputs:
    first the drop (a lane that evicted a different key or freed its
    slot zeroes that slot's pending on its home replica), then the add
    (a GLOBAL lane with hits, not owned by its home, adds them there).
    The local slot is the psum'd slot minus (D - 1) * N; a lane no
    replica answered (slot D * N) touches nothing. Ownership reads the
    replica group, as JAX's `owned` test does:
    group // (num_rgroups / D) == home."""
    n_dev, n = pending.shape
    pair = batch.group.to(I64)
    home = torch.div(pair, num_rgroups, rounding_mode="floor")
    group = pair - home * num_rgroups
    mine = out_slot < n_dev * n
    idx = torch.where(mine, home * n + out_slot - (n_dev - 1) * n, 0)
    drop = mine & ((evicted_hi != 0) | (evicted_lo != 0) | (freed != 0))
    owned = torch.div(group, num_rgroups // n_dev, rounding_mode="floor") == home
    is_global = (batch.behavior & int(Behavior.GLOBAL)) != 0
    add = mine & ~owned & is_global & (batch.hits != 0)
    flat = pending.view(-1)
    # the lanes' slots are distinct (one lane per (home, group) pair), so
    # the delta of each is exact; other lanes add 0 at slot 0
    flat.index_add_(0, idx, torch.where(drop, -flat[idx], 0) + torch.where(add, batch.hits, 0))


def run_replica_wave(state: IciState, rows: torch.Tensor, flush, w: int, now: int, *,
                     layout: str, ways: int, num_rgroups: int) -> None:
    """Wave w of `flush` (a `cuda_decide.WaveFlush` whose batch's group
    column holds pairs, see `pair_groups`) as one replica wave over
    `rows` (`replica_rows(state)`): one launch of the sharded kernel on
    a card, then the pending bookkeeping, on the current stream."""
    n_dev = state.pending.shape[0]
    flush.launch(w, rows, None, now, layout=layout, ways=ways, n_shards=n_dev, replica=True)
    off, b = flush.spans[w]
    s = slice(off, off + b)
    replica_pending(
        state.pending, flush.wave_batch(w), flush.slot[s], flush.evicted_hi[s],
        flush.evicted_lo[s], flush.freed(torch.int32)[s], num_rgroups=num_rgroups,
    )


def make_replica_decide(mesh, num_slots: int, ways: int = 1, layout: str = DEFAULT_LAYOUT):
    """decide(state, batch, home, now) -> (state, DecideOutput): lane i
    (its group the replica group) is answered by replica home[i], the
    node the request arrived at; non-owned GLOBAL hits accumulate in
    that replica's pending at the slot the decide placed the key in.
    The state is updated in place; the outputs are the psum over
    replicas."""
    check_mesh_layout(layout)
    n_dev, num_rgroups, _gp = _geometry(mesh, num_slots, ways)

    def decide_fn(state: IciState, batch, home, now):
        home = torch.as_tensor(home, dtype=I64, device=batch.group.device)
        pb = batch._replace(group=pair_groups(home, batch.group, batch.active, n_dev,
                                              num_rgroups))
        flush = cuda_decide.WaveFlush(pb, None, cuda_decide.TableMemo())
        run_replica_wave(state, replica_rows(state), flush, 0, now, layout=layout,
                         ways=ways, num_rgroups=num_rgroups)
        return state, flush.wave_outputs(0, torch.int32)[0]

    return decide_fn


def make_replica_decide_scan(mesh, num_slots: int, ways: int = 1,
                             layout: str = DEFAULT_LAYOUT):
    """Scan variant: decide(state, batches, homes, nows) with every
    input stacked (S, ...): S replica waves in order, their outputs
    stacked (S, B) lanes and (S,) sums, as the JAX scan's psum'd stack.
    The mesh has no scan kernel (parallel/mesh.py refuses decide_scan):
    this is a loop of S replica waves, one launch each on a card."""
    decide = make_replica_decide(mesh, num_slots, ways, layout)

    def scan_fn(state: IciState, batches, homes, nows):
        homes = torch.as_tensor(homes, dtype=I64, device=batches.group.device)
        outs = []
        for t in range(batches.key_hi.shape[0]):
            state, out = decide(state, type(batches)(*(c[t] for c in batches)), homes[t],
                                int(nows[t]))
            outs.append(out)
        return state, DecideOutput(*(torch.stack(f) for f in zip(*outs)))

    return scan_fn


def make_inject_replicas(mesh, num_slots: int, ways: int = 1, layout: str = DEFAULT_LAYOUT):
    """inject(state, items, now) -> state: authoritative rows written
    into EVERY replica, the landing side of a cross-pod UpdatePeerGlobals
    push. The push supersedes each replica's un-synced deltas for those
    keys, so the pending of the slot the key now occupies is cleared
    (which also drops a displaced occupant's orphaned delta). `items` is
    an InjectBatch on the state's device, its groups replica groups. One
    inject over the stack: lane i of replica d at group d *
    num_rgroups + group, all distinct."""
    check_mesh_layout(layout)
    n_dev, num_rgroups, _gp = _geometry(mesh, num_slots, ways)
    codec = cuda_decide.CODECS[layout]
    c_khi, c_klo = codec.probe[0], codec.probe[1]

    def inject_fn(state: IciState, items: InjectBatch, now):
        rows = replica_rows(state)
        dev = rows.device
        rep = torch.arange(n_dev, dtype=I64, device=dev)[:, None]
        group = (items.group.to(I64)[None, :] + rep * num_rgroups).reshape(-1)
        stacked = InjectBatch(*(c.repeat(n_dev) for c in items))._replace(
            group=group.to(torch.int32))
        inject_rows(codec, rows, stacked, now, ways)
        way_ix = group[:, None] * ways + torch.arange(ways, dtype=I64, device=dev)[None, :]
        landed = (
            stacked.active[:, None]
            & (rows[way_ix, c_khi] == stacked.key_hi[:, None])
            & (rows[way_ix, c_klo] == stacked.key_lo[:, None])
        ).reshape(-1)
        idx = torch.where(landed, way_ix.reshape(-1), 0)
        flat = state.pending.view(-1)
        flat.index_add_(0, idx, torch.where(landed, -flat[idx], 0))
        return state

    return inject_fn


def _srl(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bits (uint64 >> k)."""
    t = x >> k
    t &= (1 << (64 - k)) - 1
    return t


def _mix64_(x: torch.Tensor) -> torch.Tensor:
    """splitmix64's finalizer on uint64 bits held in int64, in place."""
    x ^= _srl(x, 30)
    x *= _MIX1
    x ^= _srl(x, 27)
    x *= _MIX2
    x ^= _srl(x, 31)
    return x


def _mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64's finalizer (`parallel/ici.py::_mix64`): the
    deterministic avalanche of the tick's content fingerprints."""
    return _mix64_(x.clone())


def group_fps(native: torch.Tensor, pending: torch.Tensor, ways: int):
    """TWO independently salted per-group content fingerprints of each
    replica, (D, G) int64 holding JAX's uint64 bits, over the native
    (D, N, C) rows and the (D, N) pending, in one walk of the rows. The
    row's columns are salted by column index from 1 (the table's single
    leaf: fused 10 columns, narrow 9), the pending after them, the way
    position last, so the same keys at different ways on different
    replicas still diverge."""
    n_dev, n, ncols = native.shape
    dev = native.device
    col_salt = torch.arange(ncols, dtype=I64, device=dev)
    accs = []
    for s in range(2):
        salts = (col_salt + (s + 1)) * _GOLDEN
        accs.append(_mix64_(native + salts).sum(dim=-1))
    wsalt = torch.arange(ways, dtype=I64, device=dev) * _WAY_SALT
    out = []
    for s in range(2):
        acc = accs[s] + _mix64_(pending + (ncols + s + 1))
        out.append(_mix64_(acc.view(n_dev, n // ways, ways) + wsalt).sum(dim=-1))
    return tuple(out)


def _psum(x: torch.Tensor) -> torch.Tensor:
    """The sum over replicas, replicated: (1, ...)."""
    return x.sum(dim=0, keepdim=True)


def _merge_block(dev, t: SlotTable, pending, gids, valid, now: int, *, n_dev: int,
                 ways: int, groups_per: int):
    """The sync merge (`merge_block`) over a block of groups on every
    replica at once. `t` is a wide SlotTable whose fields are (D, c * W),
    `pending` (D, c * W), `gids` (L, c) the blocks' group ids (sentinel
    G where `valid` is False) and `valid` (L, c), L = 1 (every replica
    the same block) or D; `dev` is the (D, 1) replica index. Returns
    (new wide table, new pending, kept per replica, dropped per
    replica); padding groups give empty rows."""
    W = ways
    c = gids.shape[-1]
    n = c * W
    lead = (n_dev, c, W)

    def resh(x):
        return x.reshape(x.shape[0], c, W)

    own = (torch.div(gids, groups_per, rounding_mode="floor") == dev)[..., None].expand(lead)
    own = own.reshape(n_dev, n)
    vmask = valid[..., None].expand(valid.shape[0], c, W).reshape(valid.shape[0], n)
    live = t.used & (t.expire_at >= now) & vmask

    # Phase A: the owner's layout, replicated.
    own_live = own & live
    owner_live = _psum(own_live.to(I64)) > 0
    owner_key_hi = _psum(torch.where(own_live, t.key_hi, 0))
    owner_key_lo = _psum(torch.where(own_live, t.key_lo, 0))

    lv, pnd = resh(live), resh(pending)
    lk_hi, lk_lo = resh(t.key_hi), resh(t.key_lo)

    def crossway_inc(dst_hi, dst_lo, dst_ok):
        """Per destination slot (g, w): the sum over replicas of the
        pending at whichever way of group g holds dst's key there."""
        eq = (
            lv[..., :, None] & dst_ok[..., None, :]
            & (lk_hi[..., :, None] == dst_hi[..., None, :])
            & (lk_lo[..., :, None] == dst_lo[..., None, :])
        )
        inc = torch.where(eq, pnd[..., :, None], 0).sum(dim=2)
        return _psum(inc.reshape(n_dev, n))

    ow_hi, ow_lo, ow_lv = resh(owner_key_hi), resh(owner_key_lo), resh(owner_live)
    inc_match = crossway_inc(ow_hi, ow_lo, ow_lv)

    # Adoption: a live replica entry whose key the owner's layout lacks,
    # one candidate per slot position (lowest replica wins), deduplicated,
    # packed into the owner group's empty ways in rank order.
    in_own_src = (
        ow_lv[..., None, :]
        & (lk_hi[..., :, None] == ow_hi[..., None, :])
        & (lk_lo[..., :, None] == ow_lo[..., None, :])
    ).any(dim=3)
    cand = live & ~in_own_src.reshape(n_dev, n)
    sel = torch.where(cand, dev, n_dev).amin(dim=0, keepdim=True)
    is_sel = cand & (dev == sel)
    adopted_key_hi = _psum(torch.where(is_sel, t.key_hi, 0))
    adopted_key_lo = _psum(torch.where(is_sel, t.key_lo, 0))
    adopt_ok = sel < n_dev
    ad_hi, ad_lo, ad_ok = resh(adopted_key_hi), resh(adopted_key_lo), resh(adopt_ok)
    inc_adopt = crossway_inc(ad_hi, ad_lo, ad_ok)
    pending_sel = _psum(torch.where(is_sel, pending, 0))

    def adopt(field):
        return _psum(torch.where(is_sel, field.to(I64), 0))

    same = (ad_hi[..., :, None] == ad_hi[..., None, :]) & (ad_lo[..., :, None] == ad_lo[..., None, :])
    earlier = torch.ones((W, W), dtype=torch.bool, device=dev.device).tril(-1)  # [w, w'] w' < w
    dup_prev = (same & ad_ok[..., None, :] & earlier).any(dim=3)
    ua_src = ad_ok & ~dup_prev

    empty = ~ow_lv
    c_rank = ua_src.to(I64).cumsum(dim=-1) - 1
    e_rank = empty.to(I64).cumsum(dim=-1) - 1
    src_onehot = (  # [g, w_dst, w_src]
        empty[..., :, None] & ua_src[..., None, :]
        & (e_rank[..., :, None] == c_rank[..., None, :])
    )
    use_adopt = src_onehot.any(dim=3).reshape(1, n)
    # a destination way has at most one source (the ranks are distinct),
    # so JAX's one-hot sum is a gather of that source
    src_way = src_onehot.to(torch.uint8).argmax(dim=3)

    def permute(per_slot):
        """Move a per-slot quantity from candidate source ways to their
        destination (adopted) ways; 0 where no candidate lands."""
        q = resh(per_slot.to(I64)).gather(2, src_way)
        return torch.where(use_adopt, q.reshape(1, n), 0)

    use_mine = owner_live

    def merged(field_mine, adopted_i64):
        return torch.where(use_mine, field_mine, permute(adopted_i64).to(field_mine.dtype))

    inc = torch.where(use_mine, inc_match, permute(inc_adopt) - permute(pending_sel))
    base = {f: merged(getattr(t, f), adopt(getattr(t, f))) for f in SlotTable._fields}
    base_used = torch.where(use_mine, live, use_adopt)

    # Deltas applied with drain semantics (reference gubernator.go:510-512).
    is_leaky = base["algo"] == 1
    rem = base["remaining"]
    rem_tok = torch.clamp(rem - inc, min=0)
    rem_lky = torch.clamp(rem - (inc << FIXED_SHIFT), min=0)
    new_rem = torch.where(base_used & (inc != 0), torch.where(is_leaky, rem_lky, rem_tok), rem)

    # Rebroadcast: each replica contributes its owned region.
    own_used = own & base_used

    def bcast(val):
        return _psum(torch.where(own_used, val.to(I64), 0)).to(val.dtype)

    merged_used = _psum(own_used.to(I64)) > 0
    mk_hi = bcast(base["key_hi"])
    mk_lo = bcast(base["key_lo"])

    # Replica-local retention: a live local entry whose key did not make
    # the merged layout is relocated into one of the group's merged-free
    # ways (rank packing per replica), with its pending.
    mfree = ~resh(merged_used)
    in_merged = (
        (lk_hi[..., :, None] == resh(mk_hi)[..., None, :])
        & (lk_lo[..., :, None] == resh(mk_lo)[..., None, :])
        & ~mfree[..., None, :]
    ).any(dim=3)
    surv = lv & ~in_merged
    s_rank = surv.to(I64).cumsum(dim=-1) - 1
    f_rank = mfree.to(I64).cumsum(dim=-1) - 1
    move_onehot = (  # [g, w_dst, w_src]
        mfree[..., :, None] & surv[..., None, :]
        & (f_rank[..., :, None] == s_rank[..., None, :])
    )
    kept = move_onehot.any(dim=3).reshape(n_dev, n)
    move_way = move_onehot.to(torch.uint8).argmax(dim=3)  # at most one source, as above

    def relocate(per_slot):
        q = resh(per_slot.to(I64)).gather(2, move_way)
        return torch.where(kept, q.reshape(n_dev, n), 0)

    def take(merged_val, local_val):
        moved = relocate(local_val).to(local_val.dtype)
        return torch.where(merged_used, merged_val,
                           torch.where(kept, moved, torch.zeros_like(local_val)))

    new_table = SlotTable(
        key_hi=take(mk_hi, t.key_hi),
        key_lo=take(mk_lo, t.key_lo),
        used=merged_used | kept,
        algo=take(bcast(base["algo"]), t.algo),
        status=take(bcast(base["status"]), t.status),
        limit=take(bcast(base["limit"]), t.limit),
        duration=take(bcast(base["duration"]), t.duration),
        remaining=take(bcast(torch.where(base_used, new_rem, 0)), t.remaining),
        stamp=take(bcast(base["stamp"]), t.stamp),
        expire_at=take(bcast(base["expire_at"]), t.expire_at),
        invalid_at=take(bcast(base["invalid_at"]), t.invalid_at),
        burst=take(bcast(base["burst"]), t.burst),
        lru=take(bcast(base["lru"]), t.lru),
    )
    new_pending = torch.where(kept, relocate(pending), 0)
    kept_total = kept.to(I64).sum(dim=1)
    surv_total = surv.to(I64).sum(dim=(1, 2))
    return new_table, new_pending, kept_total, surv_total - kept_total


def make_sync_step(mesh, num_slots: int, ways: int = 1, layout: str = DEFAULT_LAYOUT,
                   max_sync_groups=None):
    """sync(state, now) -> (state, diag): one sync tick, in place.
    Deltas go to the owners, are applied with drain semantics, and the
    owners' rows are rebroadcast to every replica (JAX `make_sync_step`,
    the same merge bit for bit).

    `max_sync_groups` = C bounds a tick's merge: the tick fingerprints
    every group of every replica (`group_fps`), selects the groups whose
    content diverges across replicas, that hold pending deltas anywhere,
    or that hold an expired row (the full merge would erase it), takes
    up to C of them from a start rotated by `now` and the tick counter,
    and merges them on a compact gather. Overflow stays for a later
    tick (diag[2], the backlog). None merges every group every tick.

    diag is (D, 4) int64: per replica [overflow entries kept
    replica-local among the merged groups, overflow survivors dropped,
    active groups left for a later tick, groups merged].

    `untouched=True` says that every row and pending delta of the state
    is zero (no wave or inject since it was created): the merge then
    changes nothing, so only the tick counter advances and the diag is
    the constant the merge would give (no group active when capped,
    every group merged when not), made on the host: nothing to read
    back."""
    check_mesh_layout(layout)
    n_dev, G, groups_per = _geometry(mesh, num_slots, ways)
    W = ways
    C = G if max_sync_groups is None else max(1, min(int(max_sync_groups), G))
    capped = C < G
    K = get_kernels(layout)
    table_cls = _TABLES[layout]
    codec = cuda_decide.CODECS[layout]
    c_meta, c_exp = codec.probe[2], codec.probe[3]

    def to_wide(rows3):
        d, n, ncols = rows3.shape
        wide = K.to_wide(table_cls(rows3.reshape(d * n, ncols)))
        return SlotTable(*(f.reshape(d, n) for f in wide))

    def from_wide(wide):
        d, n = wide.key_hi.shape
        rows = K.from_wide(SlotTable(*(f.reshape(-1) for f in wide))).data
        return rows.view(d, n, rows.shape[-1])

    def sync_fn(state: IciState, now, untouched: bool = False):
        if untouched:
            state.tick.add_(1)
            diag = torch.zeros((n_dev, 4), dtype=I64)
            if not capped:
                diag[:, 3] = G
            return state, diag
        now = int(now)
        native = state.table.data
        pending = state.pending
        dev_t = native.device
        dev = torch.arange(n_dev, dtype=I64, device=dev_t)[:, None]
        merge = dict(n_dev=n_dev, ways=W, groups_per=groups_per)

        if not capped:
            gids = torch.arange(G, dtype=I64, device=dev_t)[None, :]
            valid = torch.ones((1, G), dtype=torch.bool, device=dev_t)
            new_t, new_p, kept, dropped = _merge_block(
                dev, to_wide(native), pending, gids, valid, now, **merge)
            native.copy_(from_wide(new_t))
            pending.copy_(new_p)
            state.tick.add_(1)
            zero = torch.zeros_like(kept)
            return state, torch.stack([kept, dropped, zero, zero + G], dim=1)

        f1, f2 = group_fps(native, pending, W)
        diverged = (_psum(f1) != f1 * n_dev) | (_psum(f2) != f2 * n_dev)
        has_pend = _psum((pending != 0).view(n_dev, G, W).any(dim=2).to(I64)) > 0
        expired_any = (
            ((native[..., c_meta] & META_USED) != 0) & (native[..., c_exp] < now)
        ).view(n_dev, G, W).any(dim=2)
        g_act = diverged | has_pend | expired_any  # (D, G)

        # The scan start rotates with `now` and the tick counter, so a
        # standing backlog cannot starve a group.
        start = _mix64_((state.tick[:1] * _GOLDEN) ^ now) % G  # (1,)
        j = torch.arange(G, dtype=I64, device=dev_t)
        act_rot = g_act[:, (j + start) % G]
        cum = act_rot.to(I64).cumsum(dim=1)
        in_cap = act_rot & (cum <= C)
        # the in-cap positions in order, padded with -1 (JAX's nonzero of
        # size C): each goes to column cum - 1, the rest to a spare column
        comp = torch.full((n_dev, C + 1), -1, dtype=I64, device=dev_t)
        comp.scatter_(1, torch.where(in_cap, cum - 1, C), j.expand(n_dev, G))
        idx_rot = comp[:, :C]
        valid = idx_rot >= 0
        gids = torch.where(valid, (idx_rot + start) % G, G)
        slots = (gids[..., None] * W + torch.arange(W, dtype=I64, device=dev_t)).reshape(n_dev, C * W)
        clipped = slots.clamp(0, num_slots - 1)
        native_c = native.gather(1, clipped[..., None].expand(-1, -1, native.shape[-1]))
        pending_c = pending.gather(1, clipped)
        new_tc, new_pc, kept_c, dropped_c = _merge_block(
            dev, to_wide(native_c), pending_c, gids, valid, now, **merge)
        # sentinel groups' slots lie past the table: their delta is 0
        in_table = slots < num_slots
        flat_ix = (dev * num_slots + clipped).reshape(-1)
        rows = native.view(n_dev * num_slots, -1)
        rows.index_add_(0, flat_ix, torch.where(
            in_table[..., None], from_wide(new_tc) - native_c, 0).reshape(-1, rows.shape[-1]))
        pending.view(-1).index_add_(0, flat_ix, torch.where(
            in_table, new_pc - pending_c, 0).reshape(-1))
        state.tick.add_(1)
        merged = valid.to(I64).sum(dim=1)
        backlog = g_act.to(I64).sum(dim=1) - merged
        return state, torch.stack([kept_c, dropped_c, backlog, merged], dim=1)

    return sync_fn
