// One lane of the decide wave: probe the lane's W-way group, pick the
// way, run the token- or leaky-bucket branch, store the new row.
//
// The lane code of the Hopper kernels in decide_wave.cu, decide_sharded.cu
// and decide_scan.cu (the port of gubernator_tpu/ops/pallas_decide.py::
// _make_kernel: one wave, one wave over an owner-sharded table, a scan of
// waves), in four static configurations: layout fused or narrow, flat or
// paged table (template parameters; no run-time branch on them;
// `dispatch` picks one). It computes exactly what _wave_compute computes
// (pallas_decide.py:201-386) for one lane, and what the plain PyTorch
// version ops/fused.py::wave_plain computes; the three are bit-exact.
// The header also compiles as plain C++ (decide_lane_host.cc) so the CPU
// tests run this very code against the plain version.
//
// Every kernel runs a lane as a TEAM of T threads (team_decide, or
// team_finish on a lane context the caller read): T is the smallest
// power of two >= ways, at most 32. Member t loads way t's whole row
// (ways t, t + 32, ... when ways > 32) in one round of independent
// loads, evaluates it (way_eval), and the team reduces the candidates
// with a butterfly of __shfl_xor_sync over log2 T steps (combine). The
// member that holds the chosen way's row runs the bucket branch
// (lane_finish) from its registers: no second read of the row. The
// chain of a lane is then page map -> rows -> store, three dependent
// steps, where one thread walking the ways paid up to W + 2; the scan
// kernel also takes the page map and the batch columns off it, staged
// before the barrier that starts a step (scan_plan, stage_start).
// The host twin (decide_lane_host.cc) emulates the team: T candidates
// from member_eval, the butterfly's combine calls in the device's order
// (team_reduce_emulated), the owner's lane_finish.
//
// int64 semantics follow JAX, not C++:
//   - `//` and `%` floor (floor_div / floor_mod); C++ truncates. `limit`
//     may be negative (encode clamps it to +-MAX_COUNT, a leaky item with
//     burst 0 takes burst = limit), so _leak_fixed sees negative operands.
//   - `<<`, `+`, `-` and `*` wrap: done in uint64_t, where C++ would have
//     undefined behaviour on signed overflow or a negative left shift.
//   - `>>` of a signed value is arithmetic (nvcc and g++ both do so).
//   - argmax over the live-match mask takes the FIRST true way; argmin
//     over the insertion score takes the FIRST minimum (strict `<`):
//     combine takes the lowest live-match way and the lexicographic
//     minimum of (score, way), which is both in any order of folding.
// Unlike the JAX body, which computes both branches and selects, a lane
// runs only its algorithm's branch: same result, and the ten int64
// divisions of _leak_fixed stay off token lanes.
#pragma once

#include <stdint.h>

#include <type_traits>

#if defined(__CUDACC__)
#define GUBER_HD __host__ __device__ __forceinline__
#else
#define GUBER_HD static inline
#endif
#if defined(__CUDA_ARCH__)
#define GUBER_UNROLL _Pragma("unroll")
#else
#define GUBER_UNROLL
#endif

// Arguments of one wave; the layout is mirrored by a ctypes.Structure in
// ops/cuda_decide.py (pointers first, then int64, then int32).
struct GuberWaveArgs {
  int64_t* table;  // (n_slots, 10 or 9) row-major, updated in place
  const int64_t* key_hi;
  const int64_t* key_lo;
  const int32_t* group;
  const int8_t* algo;
  const int32_t* behavior;
  const int64_t* hits;
  const int64_t* limit;
  const int64_t* duration;
  const int64_t* rate_num;
  const int64_t* eff_duration;
  const int64_t* greg_expire;
  const int64_t* burst;
  const int64_t* created_at;
  const uint8_t* active;
  int8_t* out_status;
  int64_t* out_limit;
  int64_t* out_remaining;
  int64_t* out_reset_time;
  int64_t* out_slot;
  int64_t* out_evicted_hi;
  int64_t* out_evicted_lo;
  uint8_t* out_freed;
  int64_t* scalars;  // (9,) the wave's sums, zero at launch: see S_* below
  const int32_t* page_map;  // (n_log_pages,) paged only: frame or -1
  // Wave and sharded kernels only (null for the scan): the (9,) sums of
  // the next launch on the same stream, which this launch zeroes.
  int64_t* next_scalars;
  int64_t n_slots;  // physical rows of the table
  int64_t now;
  int32_t ways;
  int32_t batch;
  int32_t gpp;  // paged only: groups per page
  int32_t n_log_pages;  // paged only
};

// Arguments of a scan of `steps` waves over one table (decide_scan.cu):
// step 0's wave, whose batch columns and outputs are (steps, batch)
// row-major and whose `scalars` is (steps, 9); `now` is unused, each
// step reads its own from `nows`. Mirrored in ops/cuda_decide.py.
struct GuberScanArgs {
  GuberWaveArgs wave;
  const int64_t* nows;  // (steps,)
  // The counter of the kernel's grid barrier: one word of any value (the
  // kernel zeroes it before it is used); unused by the host twin.
  uint32_t* barrier;
  int32_t steps;
};

// Arguments of a sharded wave (decide_sharded.cu): the table is
// n_shards equal shards of n_local rows in one allocation, shard d at
// rows [d * n_local, (d + 1) * n_local) (`wave.table` is shard 0's first
// row, `wave.n_slots` the whole table). On a paged mesh (`wave.page_map`
// given) the frames are the shards' rows. The combined `freed` is int32,
// as the psum gives it, so it has its own pointer (`wave.out_freed` is
// unused). Mirrored in ops/cuda_decide.py.
struct GuberShardArgs {
  GuberWaveArgs wave;
  int32_t* out_freed;  // (batch,)
  int64_t n_local;  // rows per shard
  int32_t n_shards;
  int32_t groups_per;  // groups per shard: n_local / ways
};

namespace guber {

constexpr int FIXED_SHIFT = 20;
constexpr int ADMISSION_SHIFT = 20;
constexpr int64_t MAX_ELAPSED_MS = int64_t(1) << 42;
constexpr int64_t LRU_CLIP = (int64_t(1) << 44) - 1;
constexpr int32_t B_GREG = 4, B_RESET = 8, B_DRAIN = 32;
constexpr int8_t LEAKY = 1, OVER = 1, UNDER = 0;

// Scalar slots (pallas_decide.py _S_*).
constexpr int S_HITS = 0, S_MISSES = 1, S_EVICTS = 2, S_OVER = 3,
              S_ADM_KEYS = 4, S_ADM_ADMITTED = 5, S_ADM_LIMIT = 6,
              S_CENSUS_LIVE = 7, S_CENSUS_WASTE = 8, N_SCAL = 9;

GUBER_HD int64_t wadd(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a + (uint64_t)b);
}
GUBER_HD int64_t wsub(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a - (uint64_t)b);
}
GUBER_HD int64_t wmul(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a * (uint64_t)b);
}
GUBER_HD int64_t shl(int64_t a, int s) { return (int64_t)((uint64_t)a << s); }
GUBER_HD int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }
GUBER_HD int64_t imax(int64_t a, int64_t b) { return a > b ? a : b; }

// Floor division and modulo, b > 0 at every call site (divisors are
// clamped to >= 1 first, as in the JAX code).
GUBER_HD int64_t floor_div(int64_t a, int64_t b) {
  int64_t q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}
GUBER_HD int64_t floor_mod(int64_t a, int64_t b) {
  int64_t r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

// Twin of ops/decide.py::_leak_fixed.
GUBER_HD int64_t leak_fixed(int64_t elapsed, int64_t limit, int64_t rate_num,
                            int64_t burst) {
  if (elapsed <= 0) return 0;
  const int64_t limit_g = imax(limit, 1);
  const int64_t rn = imax(rate_num, 1);
  const int64_t cap_t = wadd(burst, 1);
  const int64_t e_c = imin(imax(elapsed, 0), MAX_ELAPSED_MS);
  const int64_t a = floor_div(e_c, rn);
  const int64_t e = floor_mod(e_c, rn);
  const int64_t a_lim = wadd(floor_div(cap_t, limit_g), 1);
  const int64_t a_c = imin(a, a_lim);
  const int64_t whole = wmul(a_c, limit);
  const bool saturated = (a > a_lim) || (whole >= cap_t);
  const int64_t hi = limit >> 16;
  const int64_t lo = limit & 0xFFFF;
  const int64_t p1 = wmul(e, hi);
  const int64_t q1 = floor_div(p1, rn);
  const int64_t r1 = floor_mod(p1, rn);
  const int64_t q2 = floor_div(shl(r1, 16), rn);
  const int64_t r2 = floor_mod(shl(r1, 16), rn);
  const int64_t p2 = wmul(e, lo);
  const int64_t q3 = floor_div(wadd(r2, p2), rn);
  const int64_t r3 = floor_mod(wadd(r2, p2), rn);
  const int64_t tok = wadd(wadd(shl(q1, 16), q2), q3);
  const int64_t frac_s = floor_div(shl(r3, FIXED_SHIFT), rn);
  const int64_t cap_s = shl(cap_t, FIXED_SHIFT);
  if (saturated) return cap_s;
  return imin(wadd(shl(wadd(whole, tok), FIXED_SHIFT), frac_s), cap_s);
}

// State of the chosen slot, zeroed when the key does not exist.
struct SlotState {
  int8_t algo, status;
  int64_t limit, duration, remaining, stamp, expire_at, burst, invalid_at;
};

// Request operands of one lane.
struct LaneReq {
  int64_t hits, limit, duration, rate_num, eff_duration, greg_expire, burst,
      created;
  bool greg, reset, drain;
};

// New state and response of one lane.
struct LaneResult {
  bool used;
  int8_t status_state;
  int64_t limit, duration, remaining, stamp, expire_at, burst;
  int8_t resp_status;
  int64_t resp_remaining, resp_reset;
  bool over;
};

// Twin of ops/decide.py::_token_paths for one lane.
GUBER_HD LaneResult token_lane(const LaneReq& r, const SlotState& st,
                               bool exists) {
  LaneResult o;
  const int64_t created = r.created;
  // existing-item path
  const bool limit_changed = st.limit != r.limit;
  const int64_t rem0 =
      limit_changed ? imax(wadd(st.remaining, wsub(r.limit, st.limit)), 0)
                    : st.remaining;
  const bool dur_changed = st.duration != r.duration;
  const int64_t expire1 = r.greg ? r.greg_expire : wadd(st.stamp, r.duration);
  const bool renew = dur_changed && (expire1 <= created);
  const int64_t expire2 = renew ? wadd(created, r.duration) : expire1;
  const int64_t stamp1 = renew ? created : st.stamp;
  const int64_t rem1 = renew ? r.limit : rem0;
  const int64_t new_expire = dur_changed ? expire2 : st.expire_at;

  const bool m_hits0 = r.hits == 0;
  const bool m_atlim = !m_hits0 && rem0 == 0 && r.hits > 0;
  const bool m_exact = !m_hits0 && !m_atlim && rem1 == r.hits;
  const bool m_over = !m_hits0 && !m_atlim && !m_exact && r.hits > rem1;
  const bool m_cons = !m_hits0 && !m_atlim && !m_exact && !m_over;

  const int64_t rem_state =
      m_exact ? 0
              : (m_over ? (r.drain ? 0 : rem1)
                        : (m_cons ? wsub(rem1, r.hits) : rem1));
  const int8_t sticky = st.status;
  const int8_t status_state = m_atlim ? OVER : sticky;
  const int8_t resp_status = (m_atlim || m_over) ? OVER : sticky;
  const int64_t resp_rem =
      m_exact ? 0
              : (m_over ? (r.drain ? 0 : rem0)
                        : (m_cons ? wsub(rem1, r.hits) : rem0));

  // new-item path
  const int64_t expire_new =
      r.greg ? r.greg_expire : wadd(created, r.duration);
  const bool over_new = r.hits > r.limit;
  const int64_t rem_new = over_new ? r.limit : wsub(r.limit, r.hits);

  // RESET_REMAINING on an existing item frees the slot
  const bool m_reset = exists && r.reset;
  const bool fresh = !exists || st.algo != 0;
  const bool use_new = !m_reset && fresh;

  o.used = !m_reset;
  o.limit = r.limit;
  o.duration = r.duration;
  o.remaining = use_new ? rem_new : rem_state;
  o.stamp = use_new ? created : stamp1;
  o.expire_at = use_new ? expire_new : new_expire;
  o.status_state = use_new ? UNDER : status_state;
  o.burst = 0;
  o.resp_status =
      m_reset ? UNDER : (use_new ? (over_new ? OVER : UNDER) : resp_status);
  o.resp_remaining = m_reset ? r.limit : (use_new ? rem_new : resp_rem);
  o.resp_reset = m_reset ? 0 : (use_new ? expire_new : new_expire);
  o.over = !m_reset && (use_new ? over_new : (m_atlim || m_over));
  return o;
}

// Twin of ops/decide.py::_leaky_paths for one lane.
GUBER_HD LaneResult leaky_lane(const LaneReq& r, const SlotState& st,
                               bool exists) {
  LaneResult o;
  const int S = FIXED_SHIFT;
  const int64_t created = r.created;
  const bool use_new = !exists || st.algo != LEAKY;
  o.used = true;
  o.limit = r.limit;
  o.status_state = 0;  // leaky has no stored status
  o.burst = r.burst;
  if (use_new) {
    // new-item path; rate from the RAW duration field
    const int64_t ri_new = floor_div(r.duration, imax(r.limit, 1));
    const bool over_new = r.hits > r.burst;
    const int64_t rem_new = wsub(r.burst, r.hits);
    const int64_t resp_rem_new = over_new ? 0 : rem_new;
    o.duration = r.eff_duration;
    o.remaining = over_new ? 0 : shl(rem_new, S);
    o.stamp = created;
    o.expire_at = wadd(created, r.eff_duration);
    o.resp_status = over_new ? OVER : UNDER;
    o.resp_remaining = resp_rem_new;
    o.resp_reset = wadd(created, wmul(wsub(r.limit, resp_rem_new), ri_new));
    o.over = over_new;
    return o;
  }
  // existing-item path
  const int64_t rem_s0 = r.reset ? shl(r.burst, S) : st.remaining;
  const bool burst_changed = st.burst != r.burst;
  const int64_t rem_s1 =
      (burst_changed && r.burst > (rem_s0 >> S)) ? shl(r.burst, S) : rem_s0;
  const int64_t expire_upd =
      r.hits != 0 ? wadd(created, r.eff_duration) : st.expire_at;
  const int64_t elapsed = wsub(created, st.stamp);
  const int64_t leak_s = leak_fixed(elapsed, r.limit, r.rate_num, r.burst);
  const bool leaked = (leak_s >> S) > 0;
  const int64_t rem_s2 = leaked ? wadd(rem_s1, leak_s) : rem_s1;
  const int64_t stamp1 = leaked ? created : st.stamp;
  const int64_t rem_s3 = ((rem_s2 >> S) > r.burst) ? shl(r.burst, S) : rem_s2;

  const int64_t ri = floor_div(r.rate_num, imax(r.limit, 1));
  const int64_t rem_int = rem_s3 >> S;

  const bool m_atlim = rem_int == 0 && r.hits > 0;
  const bool m_exact = !m_atlim && rem_int == r.hits;
  const bool m_over = !m_atlim && !m_exact && r.hits > rem_int;
  const bool m_hits0 = !m_atlim && !m_exact && !m_over && r.hits == 0;
  const bool m_cons = !m_atlim && !m_exact && !m_over && !m_hits0;

  const int64_t rem_s_final =
      m_exact ? 0
              : (m_over ? (r.drain ? 0 : rem_s3)
                        : (m_cons ? wsub(rem_s3, shl(r.hits, S)) : rem_s3));
  const int64_t resp_rem =
      m_exact ? 0
              : (m_over ? (r.drain ? 0 : rem_int)
                        : (m_cons ? (rem_s_final >> S) : rem_int));
  int64_t resp_reset;
  if (m_exact) {
    resp_reset = wadd(created, wmul(r.limit, ri));
  } else if (m_cons) {
    resp_reset = wadd(created, wmul(wsub(r.limit, rem_s_final >> S), ri));
  } else {
    resp_reset = wadd(created, wmul(wsub(r.limit, rem_int), ri));
  }
  o.duration = r.duration;  // found path stores the RAW duration
  o.remaining = rem_s_final;
  o.stamp = stamp1;
  o.expire_at = expire_upd;
  o.resp_status = (m_atlim || m_over) ? OVER : UNDER;
  o.resp_remaining = resp_rem;
  o.resp_reset = resp_reset;
  o.over = m_atlim || m_over;
  return o;
}


// Column indices of the two table layouts: fused (ops/fused.py, (N, 10))
// and narrow (ops/narrow.py, (N, 9)). Both put the way-selection columns
// KHI KLO META EXP first; fused keeps INV at col 9, narrow at col 4 so
// the probe reads the contiguous 5-column prefix (40 B per way).
enum : int { LAYOUT_FUSED = 0, LAYOUT_NARROW = 1 };

template <int LAYOUT>
struct Cols;
template <>
struct Cols<LAYOUT_FUSED> {
  static constexpr int NCOLS = 10;
  static constexpr int KHI = 0, KLO = 1, META = 2, EXP = 3, LIM = 4, DUR = 5,
                       REM = 6, STM = 7, BUR = 8, INV = 9;
};
template <>
struct Cols<LAYOUT_NARROW> {
  static constexpr int NCOLS = 9;
  static constexpr int KHI = 0, KLO = 1, META = 2, EXP = 3, INV = 4,
                       LIMBUR = 5, DUR = 6, REM = 7, STM = 8;
};

// Narrow's LIMBUR word: limit in the low 32 bits, burst in the high 32
// (ops/narrow.py _pack_limbur / _unpack_limbur). Lossless inside the
// encode clamp |limit|, |burst| <= 2^31-1; the shift wraps like JAX's.
GUBER_HD int64_t pack_limbur(int64_t limit, int64_t burst) {
  return (int64_t)(((uint64_t)burst << 32) | ((uint64_t)limit & 0xFFFFFFFFull));
}
GUBER_HD int64_t limbur_limit(int64_t word) {
  return (int64_t)(int32_t)(uint32_t)((uint64_t)word & 0xFFFFFFFFull);
}
GUBER_HD int64_t limbur_burst(int64_t word) { return word >> 32; }

// The way-selection columns of one way.
struct Probe {
  int64_t khi, klo, meta, exp, inv;
};

// One lane's outputs: the DecideOutput fields of lane j.
struct LaneOut {
  int8_t status;
  int64_t limit, remaining, reset_time, slot, evicted_hi, evicted_lo;
  bool freed;
};

// A padding lane reads nothing, writes no row (scatter-drop by
// omission) and reports slot == n_slots.
GUBER_HD LaneOut padding_out(const GuberWaveArgs& a) {
  return LaneOut{0, 0, 0, 0, a.n_slots, 0, 0, false};
}

// ---------------------------------------------------------------------------
// The way selection (probe_ways, ops/fused.py), as one rule that the
// team's butterfly, the host twin and the serial fold all use.

// A candidate of the selection over some of the group's ways: the
// lexicographic minimum (score, way) of the insertion score, and the
// lowest way that holds a live match of the lane's key (NO_WAY if none).
struct Cand {
  int64_t score;
  int32_t way, match;
};
constexpr int32_t NO_WAY = 0x7fffffff;
constexpr int64_t NO_SCORE = 0x7fffffffffffffffLL;

// The identity of combine: a team member with no way to evaluate.
GUBER_HD Cand no_cand() { return Cand{NO_SCORE, NO_WAY, NO_WAY}; }

// Way w's candidate (probe_ways for one way): used, expired, match,
// the category (0 expired copy of the key, 1 empty, 2 expired, 3 live),
// the tie (the clipped LRU stamp for a live way, else w) and the score
// cat << 44 | tie, below NO_SCORE for every input.
GUBER_HD Cand way_eval(const Probe& p, int64_t key_hi, int64_t key_lo,
                       int64_t now, int32_t w) {
  const bool used = (p.meta & 1) != 0;
  const bool expired = used && (p.exp < now || (p.inv != 0 && p.inv < now));
  const bool match = used && p.khi == key_hi && p.klo == key_lo;
  const int64_t cat =
      (match && expired) ? 0 : (!used ? 1 : (expired ? 2 : 3));
  const int64_t lru = p.meta >> 4;
  const int64_t tie = cat == 3 ? imin(imax(lru, 0), LRU_CLIP) : (int64_t)w;
  return Cand{wadd(shl(cat, 44), tie), w, (match && !expired) ? w : NO_WAY};
}

// Two candidates into one: associative and commutative, so any order of
// folding gives the serial loop's answer (first live match; first
// minimum of the score under strict `<`, i.e. the lower way on a tie).
GUBER_HD Cand combine(const Cand& a, const Cand& b) {
  const bool take_b = b.score < a.score || (b.score == a.score && b.way < a.way);
  return Cand{take_b ? b.score : a.score, take_b ? b.way : a.way,
              b.match < a.match ? b.match : a.match};
}

// The way the lane writes: its first live match, else the insert way.
GUBER_HD int32_t chosen_way(const Cand& c) {
  return c.match != NO_WAY ? c.match : c.way;
}

// ---------------------------------------------------------------------------
// The team: T threads per lane, member t evaluating ways t, t + 32, ...

constexpr int TEAM_MAX = 32;  // a warp
constexpr int TEAM_THREADS = 128;  // threads per block of the team kernels

// T: the smallest power of two >= ways, at most a warp.
GUBER_HD int team_size(int ways) {
  int t = 1;
  while (t < ways && t < TEAM_MAX) t <<= 1;
  return t;
}

// Blocks of a team kernel for `batch` lanes: TEAM_THREADS / T lanes each.
GUBER_HD int team_blocks(int batch, int ways) {
  const int lanes = TEAM_THREADS / team_size(ways);
  return (batch + lanes - 1) / lanes;
}

// The member that holds the chosen way's row (way w is member w mod T).
GUBER_HD int team_owner(const Cand& c, int T) { return chosen_way(c) & (T - 1); }

// The host's emulation of the device butterfly (team_reduce): step by
// step, member t takes combine(its own, member t ^ off's), off = T/2 ..
// 1, every member from the values of the step before. All T end equal.
GUBER_HD void team_reduce_emulated(Cand c[TEAM_MAX], int T) {
  for (int off = T >> 1; off > 0; off >>= 1) {
    Cand next[TEAM_MAX];
    for (int t = 0; t < T; ++t) next[t] = combine(c[t], c[t ^ off]);
    for (int t = 0; t < T; ++t) c[t] = next[t];
  }
}

// ---------------------------------------------------------------------------
// Rows.

template <int LAYOUT>
struct Row {
  int64_t c[Cols<LAYOUT>::NCOLS];
};

template <int LAYOUT>
GUBER_HD Probe probe_of(const Row<LAYOUT>& r) {
  using C = Cols<LAYOUT>;
  return Probe{r.c[C::KHI], r.c[C::KLO], r.c[C::META], r.c[C::EXP], r.c[C::INV]};
}

// A whole row in one round of independent loads. On the card a fused
// row (80 B at a multiple of 80 B from a 16-byte aligned table) is five
// 16-byte loads; a narrow row (72 B) is 16-byte aligned only at even
// slots, so it is nine 8-byte loads: the same sectors, and no load
// waits on another.
template <int LAYOUT>
GUBER_HD Row<LAYOUT> load_row(const int64_t* p) {
  Row<LAYOUT> r;
#if defined(__CUDA_ARCH__)
  if constexpr (LAYOUT == LAYOUT_FUSED) {
    const longlong2* v = reinterpret_cast<const longlong2*>(p);
    GUBER_UNROLL
    for (int k = 0; k < 5; ++k) {
      const longlong2 x = v[k];
      r.c[2 * k] = x.x;
      r.c[2 * k + 1] = x.y;
    }
  } else
#endif
  {
    GUBER_UNROLL
    for (int k = 0; k < Cols<LAYOUT>::NCOLS; ++k) r.c[k] = p[k];
  }
  return r;
}

template <int LAYOUT>
GUBER_HD void store_row(int64_t* p, const Row<LAYOUT>& r) {
#if defined(__CUDA_ARCH__)
  if constexpr (LAYOUT == LAYOUT_FUSED) {
    longlong2* v = reinterpret_cast<longlong2*>(p);
    GUBER_UNROLL
    for (int k = 0; k < 5; ++k) v[k] = make_longlong2(r.c[2 * k], r.c[2 * k + 1]);
  } else
#endif
  {
    GUBER_UNROLL
    for (int k = 0; k < Cols<LAYOUT>::NCOLS; ++k) p[k] = r.c[k];
  }
}

// ---------------------------------------------------------------------------
// The lane.

// What a lane reads besides its group's rows: the request columns and,
// paged, its page-map entry. The request columns are read for every
// lane of the batch (`in_batch`), active or not, so their loads do not
// wait for the `active` flag's; an inactive lane's are never used.
struct LaneCtx {
  bool active, resident;
  int64_t base;  // first slot of the lane's physical group
  int64_t key_hi, key_lo;
  int8_t algo;
  LaneReq r;
};

// Paged: the page-map word of logical group `group`, pp = page_map[g /
// gpp] in int32: its page's frame, or -1 for a page that is not
// resident or lies outside the map (a group beyond the logical table),
// which is then not read out of bounds.
GUBER_HD int32_t page_word(const GuberWaveArgs& a, int64_t group) {
  const int64_t lp = floor_div(group, a.gpp);
  return (lp >= 0 && lp < a.n_log_pages) ? a.page_map[lp] : int32_t(-1);
}

// Lane j that is `active` with logical group `group` (the caller reads
// both: from the batch, or from a shard's ownership mask); `active`
// implies `in_batch` (j < batch). Paged, `pp` is the group's page_word.
//
// Paged (pallas_decide.py:418-422, :529-548): a lane whose page is not
// resident (pp < 0) is a SENTINEL lane. It is still an active lane: it
// sees an all-empty group (no load: every way evaluates a zero row), so
// it does not exist, inserts at way 0 of category "empty" and answers as
// a fresh bucket; it counts in misses and over_limit, never in the
// WaveScan sums (only written rows count), stores nothing, and reports
// slot == n_slots with no evicted key.
template <bool PAGED>
GUBER_HD LaneCtx lane_ctx(const GuberWaveArgs& a, int j, bool in_batch,
                          bool active, int64_t group, int32_t pp) {
  LaneCtx x{};
  x.active = active;
  if (!in_batch) return x;
  x.key_hi = a.key_hi[j];
  x.key_lo = a.key_lo[j];
  x.algo = a.algo[j];
  const int32_t bhv = a.behavior[j];
  x.r.hits = a.hits[j];
  x.r.limit = a.limit[j];
  x.r.duration = a.duration[j];
  x.r.rate_num = a.rate_num[j];
  x.r.eff_duration = a.eff_duration[j];
  x.r.greg_expire = a.greg_expire[j];
  x.r.burst = a.burst[j];
  x.r.created = a.created_at[j];
  x.r.greg = (bhv & B_GREG) != 0;
  x.r.reset = (bhv & B_RESET) != 0;
  x.r.drain = (bhv & B_DRAIN) != 0;
  if (!active) return x;
  bool resident = true;
  int64_t pgroup = group;
  if constexpr (PAGED) {
    resident = pp >= 0;
    // int32 arithmetic as in the Pallas kernel (wrapping, not UB)
    const uint32_t phys = (uint32_t)pp * (uint32_t)a.gpp +
                          (uint32_t)(int32_t)floor_mod(group, a.gpp);
    pgroup = resident ? (int64_t)(int32_t)phys : 0;
  }
  x.resident = resident;
  x.base = pgroup * a.ways;
  return x;
}

// The same, reading the page map itself (the wave kernel: the word's
// load goes out beside the request columns').
template <bool PAGED>
GUBER_HD LaneCtx lane_ctx(const GuberWaveArgs& a, int j, bool in_batch,
                          bool active, int64_t group) {
  return lane_ctx<PAGED>(a, j, in_batch, active, group,
                         PAGED && active ? page_word(a, group) : int32_t(-1));
}

// Member t of the lane's team: its ways t, t + TEAM_MAX, ... (one way,
// or none, when ways <= 32), each row loaded whole (zero rows for a lane
// that is inactive or not resident) and evaluated, folded in ascending
// order. `keep` gets the row the team may ask this member for: its first
// live match, else its best insert way. (If the member holds a live
// match, the team's chosen way is a live match, this member's first one
// if it is the team's lowest; if it holds none, the team asks it only
// for an insert way.) A hook `after_load()` runs once, after the
// member's first row load is sent and before any row is used: work
// placed there overlaps the load (the scan kernel starts its next stage
// there). With a hook the first row is loaded ahead of the loop (the
// scan is faster so: PERF.md); without one, the loop is as it was.
struct NoHook {
#if defined(__CUDACC__)
  __host__ __device__
#endif
  void operator()() const {}
};

template <int LAYOUT, typename Hook = NoHook>
GUBER_HD Cand member_eval(const GuberWaveArgs& a, const LaneCtx& x, int t,
                          Row<LAYOUT>& keep, const Hook& after_load = Hook()) {
  using C = Cols<LAYOUT>;
  constexpr bool HOOKED = !std::is_same<Hook, NoHook>::value;
  const int64_t* grp = a.table + x.base * C::NCOLS;
  Row<LAYOUT> first{};
  if constexpr (HOOKED) {
    if (t < a.ways && x.resident) first = load_row<LAYOUT>(grp + (int64_t)t * C::NCOLS);
    after_load();
  }
  Cand c = no_cand();
  keep = Row<LAYOUT>{};
  for (int w = t; w < a.ways; w += TEAM_MAX) {
    const Row<LAYOUT> r =
        HOOKED && w == t
            ? first
            : (x.resident ? load_row<LAYOUT>(grp + (int64_t)w * C::NCOLS) : Row<LAYOUT>{});
    const Cand e = way_eval(probe_of(r), x.key_hi, x.key_lo, a.now, w);
    const Cand n = combine(c, e);
    if (c.match == NO_WAY && (e.match != NO_WAY || n.way == w)) keep = r;
    c = n;
  }
  return c;
}

// The rest of the lane once the way is chosen: `sel` is the team's (or
// the serial fold's) selection and `row` the chosen way's row as it was
// read. Runs only the algorithm's branch, stores the new row in place if
// the lane is active and resident, ADDS the lane's scalar contributions
// to `scal` and returns its outputs.
template <int LAYOUT>
GUBER_HD LaneOut lane_finish(const GuberWaveArgs& a, const LaneCtx& x,
                             const Cand& sel, const Row<LAYOUT>& row,
                             int64_t scal[N_SCAL]) {
  using C = Cols<LAYOUT>;
  if (!x.active) return padding_out(a);
  const int64_t now = a.now;
  const bool exists = sel.match != NO_WAY;
  const int32_t way = chosen_way(sel);
  const Probe sp = probe_of(row);
  const bool evicts_live = !exists && (sel.score >> 44) == 3;
  const bool old_used = (sp.meta & 1) != 0;
  const bool displaced =
      !exists && old_used && (sp.khi != x.key_hi || sp.klo != x.key_lo);

  // State of the chosen row, zeroed when the key does not exist.
  SlotState st{};
  if (exists) {
    st.algo = (int8_t)((sp.meta >> 1) & 1);
    st.status = (int8_t)((sp.meta >> 2) & 3);
    st.expire_at = sp.exp;
    st.invalid_at = sp.inv;
    if constexpr (LAYOUT == LAYOUT_NARROW) {
      st.limit = limbur_limit(row.c[C::LIMBUR]);
      st.burst = limbur_burst(row.c[C::LIMBUR]);
    } else {
      st.limit = row.c[C::LIM];
      st.burst = row.c[C::BUR];
    }
    st.duration = row.c[C::DUR];
    st.remaining = row.c[C::REM];
    st.stamp = row.c[C::STM];
  }

  const LaneReq& r = x.r;
  const bool is_leaky = x.algo == LEAKY;
  const LaneResult o = is_leaky ? leaky_lane(r, st, exists) : token_lane(r, st, exists);

  // The new row, stored in place by a resident lane (one row per lane).
  const bool freed = !o.used;
  if (x.resident) {
    Row<LAYOUT> n;
    n.c[C::KHI] = freed ? 0 : x.key_hi;
    n.c[C::KLO] = freed ? 0 : x.key_lo;
    n.c[C::META] = freed ? 0
                         : (shl(now, 4) | ((int64_t)(o.status_state & 3) << 2) |
                            ((int64_t)(x.algo & 1) << 1) | 1);
    n.c[C::EXP] = o.expire_at;
    n.c[C::INV] = (exists && !freed) ? st.invalid_at : 0;
    if constexpr (LAYOUT == LAYOUT_NARROW) {
      n.c[C::LIMBUR] = pack_limbur(o.limit, o.burst);
    } else {
      n.c[C::LIM] = o.limit;
      n.c[C::BUR] = o.burst;
    }
    n.c[C::DUR] = o.duration;
    n.c[C::REM] = o.remaining;
    n.c[C::STM] = o.stamp;
    store_row<LAYOUT>(a.table + (x.base + way) * C::NCOLS, n);
  }

  const LaneOut out{o.resp_status, r.limit, o.resp_remaining, o.resp_reset,
                    x.resident ? x.base + way : a.n_slots,
                    displaced ? sp.khi : 0, displaced ? sp.klo : 0, freed};

  // Scalars: the wave's metrics over active lanes, and the WaveScan sums
  // over the rows this wave wrote (active and resident lanes).
  scal[S_HITS] += exists ? 1 : 0;
  scal[S_MISSES] += exists ? 0 : 1;
  scal[S_EVICTS] += evicts_live ? 1 : 0;
  scal[S_OVER] += o.over ? 1 : 0;
  if (!x.resident) return out;
  const bool adm_active = !freed && o.limit > 0 && o.expire_at > now;
  const int64_t tokens = is_leaky ? (o.remaining >> ADMISSION_SHIFT) : o.remaining;
  scal[S_ADM_KEYS] += adm_active ? 1 : 0;
  scal[S_ADM_ADMITTED] =
      wadd(scal[S_ADM_ADMITTED], adm_active ? imax(wsub(o.limit, tokens), 0) : 0);
  scal[S_ADM_LIMIT] = wadd(scal[S_ADM_LIMIT], adm_active ? o.limit : 0);
  scal[S_CENSUS_LIVE] += freed ? 0 : 1;
  scal[S_CENSUS_WASTE] += (!freed && o.expire_at <= now) ? 1 : 0;
  return out;
}

// Stores a lane's outputs at j, all but `freed`, whose type the caller's
// output decides.
GUBER_HD void store_lane(const GuberWaveArgs& a, int j, const LaneOut& o) {
  a.out_status[j] = o.status;
  a.out_limit[j] = o.limit;
  a.out_remaining[j] = o.remaining;
  a.out_reset_time[j] = o.reset_time;
  a.out_slot[j] = o.slot;
  a.out_evicted_hi[j] = o.evicted_hi;
  a.out_evicted_lo[j] = o.evicted_lo;
}

// Where lane j of a sharded wave goes: the ownership prologue that every
// shard runs in parallel/mesh.py (the replicated `_xlate` on a paged
// mesh, then `_mask_to_local`), computed once for the lane. A lane is
// owned by shard d iff it is active and its (physical) group lies in
// [d * groups_per, (d + 1) * groups_per); `group` is then shard-local.
// On a paged mesh (XLATE) the logical group goes through the page map in
// int32 first, and a lane whose page is not resident maps to the
// sentinel n_shards * groups_per, which no shard owns: unlike a paged
// single-table lane (lane_ctx<true>) it is inactive everywhere. A page
// index outside the map counts as not resident (the JAX gather clamps it
// instead; no group the engine hashes lies outside the map).
struct ShardLane {
  bool owned;
  int32_t shard;
  int64_t group;
};

template <bool XLATE>
GUBER_HD ShardLane shard_lane(const GuberShardArgs& s, int j) {
  const GuberWaveArgs& a = s.wave;
  // both read at once: neither load waits for the other
  const bool active = a.active[j] != 0;
  int64_t g = a.group[j];
  if (!active) return ShardLane{false, 0, 0};
  const int64_t n_groups = (int64_t)s.n_shards * s.groups_per;
  if constexpr (XLATE) {
    const int32_t pp = page_word(a, g);
    // int32 arithmetic as in _xlate (wrapping, not UB)
    g = pp >= 0 ? (int64_t)(int32_t)((uint32_t)pp * (uint32_t)a.gpp +
                                     (uint32_t)(int32_t)floor_mod(g, a.gpp))
                : n_groups;
  }
  if (g < 0 || g >= n_groups) return ShardLane{false, 0, 0};
  const int32_t d = (int32_t)(g / s.groups_per);
  return ShardLane{true, d, g - (int64_t)d * s.groups_per};
}

// The owning shard's view of a sharded wave: its rows, n_slots = n_local
// (raw_decide_flat on the shard's table). An unowned lane runs as a
// padding lane of shard 0.
template <int LAYOUT>
GUBER_HD GuberWaveArgs shard_view(const GuberShardArgs& s, const ShardLane& L) {
  GuberWaveArgs w = s.wave;
  w.table += (int64_t)L.shard * s.n_local * Cols<LAYOUT>::NCOLS;
  w.n_slots = s.n_local;
  return w;
}

// Stores lane j of a sharded wave as the psum over the shard axis gives
// it. The D - 1 shards that do not own the lane see it masked: zeros in
// every field but `slot`, where a masked lane reports its shard's
// n_local. So the sum is the owner's answer with slot + (D - 1) *
// n_local, and D * n_local for a lane no shard owns; `freed` is int32.
GUBER_HD void store_lane_sharded(const GuberShardArgs& s, int j, LaneOut o) {
  o.slot = wadd(o.slot, wmul((int64_t)s.n_shards - 1, s.n_local));
  store_lane(s.wave, j, o);
  s.out_freed[j] = o.freed ? 1 : 0;
}

// The wave of step t of a scan: every batch and output pointer moved to
// row t (offset t * batch), now = nows[t], scalars at row t. The table
// and the page map are the same for every step.
GUBER_HD GuberWaveArgs step_args(const GuberScanArgs& a, int t) {
  GuberWaveArgs w = a.wave;
  const int64_t off = (int64_t)t * a.wave.batch;
  w.key_hi += off;
  w.key_lo += off;
  w.group += off;
  w.algo += off;
  w.behavior += off;
  w.hits += off;
  w.limit += off;
  w.duration += off;
  w.rate_num += off;
  w.eff_duration += off;
  w.greg_expire += off;
  w.burst += off;
  w.created_at += off;
  w.active += off;
  w.out_status += off;
  w.out_limit += off;
  w.out_remaining += off;
  w.out_reset_time += off;
  w.out_slot += off;
  w.out_evicted_hi += off;
  w.out_evicted_lo += off;
  w.out_freed += off;
  w.scalars += (int64_t)t * N_SCAL;
  w.now = a.nows[t];
  return w;
}

// ---------------------------------------------------------------------------
// The scan's persistent grid (decide_scan.cu), shared with its host twin.

// How a scan's grid of `grid` blocks of `threads` threads covers each
// step's `batch` lanes. A block's threads are L = threads / T teams, one
// lane each, so a block runs L consecutive lanes at a time: an ITEM, of
// which a step has `items`. Block b runs items b, b + grid, b + 2 grid,
// ... of every step, `iters` of them, the same count in every block: the
// team's shuffles need every member of a warp on every pass, so an item
// past the batch runs lanes with in_batch = false. When a step's items
// fit the grid, iters = 1.
struct ScanPlan {
  int T, L, lg_L, items, iters;
};

GUBER_HD ScanPlan scan_plan(int batch, int ways, int grid, int threads) {
  ScanPlan p;
  p.T = team_size(ways);
  p.L = threads / p.T;
  p.lg_L = 0;
  while ((1 << p.lg_L) < p.L) ++p.lg_L;
  p.items = (batch + p.L - 1) / p.L;
  p.iters = (p.items + grid - 1) / grid;
  return p;
}

// First lane of item k of block b.
GUBER_HD int64_t item_lane0(const ScanPlan& p, int b, int k, int grid) {
  return ((int64_t)b + (int64_t)k * grid) * p.L;
}

// The STAGE of an item: the batch columns of its L lanes in shared
// memory, column by column: the ten int64 columns, group and behavior
// (int32), algo and active (int8), STAGE_LANE_BYTES a lane. L is a
// multiple of 4, so every column of two stages side by side stays
// aligned to its element size. Nothing a scan writes is staged: no table
// row, only the batch's inputs.
constexpr int STAGE_COLS = 14;
constexpr int STAGE_WIDE_COLS = 12;  // the int64 and int32 columns
constexpr int STAGE_LANE_BYTES = 10 * 8 + 2 * 4 + 2 * 1;

// Column c of a wave's batch, in the stage's order, and its element size.
GUBER_HD const void* stage_src_col(const GuberWaveArgs& a, int c) {
  switch (c) {
    case 0: return a.key_hi;
    case 1: return a.key_lo;
    case 2: return a.hits;
    case 3: return a.limit;
    case 4: return a.duration;
    case 5: return a.rate_num;
    case 6: return a.eff_duration;
    case 7: return a.greg_expire;
    case 8: return a.burst;
    case 9: return a.created_at;
    case 10: return a.group;
    case 11: return a.behavior;
    case 12: return a.algo;
    default: return a.active;
  }
}
GUBER_HD int stage_col_size(int c) { return c < 10 ? 8 : (c < 12 ? 4 : 1); }
GUBER_HD int stage_col_offset(int c, int L) {
  return (c < 10 ? 8 * c : (c < 12 ? 80 + 4 * (c - 10) : 88 + (c - 12))) * L;
}

// Element e of an item's stage (column e / L, lane e % L): its source in
// the wave's batch, its offset in the stage, its size. False for a lane
// past the batch, which is not staged.
struct StageElem {
  const unsigned char* src;
  int off, size;
};

GUBER_HD bool stage_elem(const GuberWaveArgs& a, int64_t lane0, const ScanPlan& p,
                         int e, StageElem& el) {
  const int c = e >> p.lg_L, i = e & (p.L - 1);
  if (lane0 + i >= a.batch) return false;
  el.size = stage_col_size(c);
  el.src = static_cast<const unsigned char*>(stage_src_col(a, c)) + (lane0 + i) * el.size;
  el.off = stage_col_offset(c, p.L) + i * el.size;
  return true;
}

// The wave `a` with its batch columns moved to the stage `st` of L
// lanes, lane i of the item at index i: lane_ctx reads a staged lane as
// it reads a batch's.
GUBER_HD GuberWaveArgs stage_view(const GuberWaveArgs& a, const unsigned char* st, int L) {
  GuberWaveArgs v = a;
  v.key_hi = reinterpret_cast<const int64_t*>(st + stage_col_offset(0, L));
  v.key_lo = reinterpret_cast<const int64_t*>(st + stage_col_offset(1, L));
  v.hits = reinterpret_cast<const int64_t*>(st + stage_col_offset(2, L));
  v.limit = reinterpret_cast<const int64_t*>(st + stage_col_offset(3, L));
  v.duration = reinterpret_cast<const int64_t*>(st + stage_col_offset(4, L));
  v.rate_num = reinterpret_cast<const int64_t*>(st + stage_col_offset(5, L));
  v.eff_duration = reinterpret_cast<const int64_t*>(st + stage_col_offset(6, L));
  v.greg_expire = reinterpret_cast<const int64_t*>(st + stage_col_offset(7, L));
  v.burst = reinterpret_cast<const int64_t*>(st + stage_col_offset(8, L));
  v.created_at = reinterpret_cast<const int64_t*>(st + stage_col_offset(9, L));
  v.group = reinterpret_cast<const int32_t*>(st + stage_col_offset(10, L));
  v.behavior = reinterpret_cast<const int32_t*>(st + stage_col_offset(11, L));
  v.algo = reinterpret_cast<const int8_t*>(st + stage_col_offset(12, L));
  v.active = st + stage_col_offset(13, L);
  return v;
}

// Paged: the page word of lane i of the item staged in `st` from lane0
// of wave `a`; -1 (unused) for a lane past the batch or inactive. The
// page map is never written by a decide, so this load may go out before
// the barrier that starts the item's step.
GUBER_HD int32_t staged_page_word(const GuberWaveArgs& a, int64_t lane0, const ScanPlan& p,
                                  const unsigned char* st, int i) {
  const GuberWaveArgs v = stage_view(a, st, p.L);
  return lane0 + i < a.batch && v.active[i] != 0 ? page_word(a, v.group[i]) : int32_t(-1);
}

// Calls f(L, P) with L = std::integral_constant<int, layout> and P =
// std::bool_constant<paged> for one of the four static configurations,
// so a caller instantiates its template with decltype(L)::value,
// decltype(P)::value. Returns false (and calls nothing) for an unknown
// one. The only place the configurations are enumerated.
template <typename F>
bool dispatch(int layout, int paged, F&& f) {
  using Fused = std::integral_constant<int, LAYOUT_FUSED>;
  using Narrow = std::integral_constant<int, LAYOUT_NARROW>;
  if (layout == LAYOUT_FUSED && paged == 0)
    f(Fused{}, std::false_type{});
  else if (layout == LAYOUT_FUSED && paged == 1)
    f(Fused{}, std::true_type{});
  else if (layout == LAYOUT_NARROW && paged == 0)
    f(Narrow{}, std::false_type{});
  else if (layout == LAYOUT_NARROW && paged == 1)
    f(Narrow{}, std::true_type{});
  else
    return false;
  return true;
}

#if defined(__CUDACC__)
// The block's per-thread sums `s`, reduced per warp by shuffles into
// part[warp][k] (lane 0 of each warp writes). Every thread of the block
// must call it.
__device__ __forceinline__ void warp_partials(const int64_t s[N_SCAL],
                                              unsigned long long part[][N_SCAL]) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < N_SCAL; ++k) {
    unsigned long long v = (unsigned long long)s[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) part[warp][k] = v;
  }
}

// Threads 0..N_SCAL-1 add the warps' partials of their scalar into
// scalars[k]: one 64-bit atomicAdd per nonzero scalar per block. The
// partials must be visible to them (a barrier since warp_partials).
template <int THREADS>
__device__ __forceinline__ void add_partials(unsigned long long part[][N_SCAL],
                                             int64_t* scalars) {
  if (threadIdx.x < N_SCAL) {
    unsigned long long sum = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) sum += part[w][threadIdx.x];
    if (sum != 0)
      atomicAdd(reinterpret_cast<unsigned long long*>(scalars) + threadIdx.x,
                sum);
  }
}

// Adds the block's per-thread sums `s` into scalars[0..N_SCAL): warp
// shuffles, then shared memory, then one 64-bit atomicAdd per nonzero
// scalar per block. Integer sums do not depend on order, so the result
// is bit-exact. Every thread of the block (THREADS of them) must call
// it: it holds a __syncthreads(). A caller that calls it again must put
// a barrier between the calls, since threads 0..N_SCAL-1 read the shared
// partials after the __syncthreads().
template <int THREADS>
__device__ __forceinline__ void block_add_scalars(const int64_t s[N_SCAL],
                                                  int64_t* scalars) {
  __shared__ unsigned long long part[THREADS / 32][N_SCAL];
  warp_partials(s, part);
  __syncthreads();
  add_partials<THREADS>(part, scalars);
}

// The wave and sharded kernels' sums, with no memset before the launch:
// a.scalars came zeroed from the launch before on the same stream (or
// from the wrapper, for a stream's first launch), so the blocks add into
// it (block_add_scalars), and block 0 zeroes a.next_scalars, the buffer
// of the stream's next launch. A launch is one device operation, and
// its sums cost only the adds, where a last-block reduction on a ticket
// counter would add, after every other block, the last block's
// dependent round trips (its sums' stores and fence, the ticket, the
// read of every block's sums). The chain of
// buffers belongs to one stream, so two waves on two streams never
// share one; the wrapper (ops/cuda_decide.py) keeps it. Same calling
// rule as block_add_scalars.
template <int THREADS>
__device__ __forceinline__ void wave_sums(const int64_t s[N_SCAL],
                                          const GuberWaveArgs& a) {
  if (blockIdx.x == 0 && threadIdx.x < N_SCAL) a.next_scalars[threadIdx.x] = 0;
  block_add_scalars<THREADS>(s, a.scalars);
}

// One step of the team's butterfly: member t gets member t ^ off's
// candidate (off < T, T a power of two dividing 32, so the partner is in
// the same team). The 64-bit score goes as two 32-bit shuffles (the
// long long overload). Every thread of the warp must call it.
__device__ __forceinline__ Cand shfl_xor_cand(const Cand& c, int off) {
  Cand o;
  o.score = (int64_t)__shfl_xor_sync(0xffffffffu, (long long)c.score, off);
  o.way = __shfl_xor_sync(0xffffffffu, c.way, off);
  o.match = __shfl_xor_sync(0xffffffffu, c.match, off);
  return o;
}

// The team's candidates reduced, in every member: combine with the
// partner at off = T/2 .. 1 (team_reduce_emulated is the host's copy).
__device__ __forceinline__ Cand team_reduce(Cand c, int T) {
  for (int off = T >> 1; off > 0; off >>= 1) c = combine(c, shfl_xor_cand(c, off));
  return c;
}

// Member t of a lane's team (T threads, consecutive lanes of one warp)
// on the lane's context x: the member's rows (member_eval), the team's
// selection, then the member that holds the chosen row finishes the
// lane from its registers. Returns true, with the lane's outputs in
// `out` and its sums added to `scal`, in that member only. Every member
// of every team of the warp must call it (no early return before the
// shuffles): lanes past the batch with in_batch = active = false.
// `after_load` as in member_eval.
template <int LAYOUT, typename Hook = NoHook>
__device__ __forceinline__ bool team_finish(const GuberWaveArgs& a, const LaneCtx& x,
                                            int t, int T, int64_t scal[N_SCAL],
                                            LaneOut& out, const Hook& after_load = Hook()) {
  Row<LAYOUT> row;
  const Cand c = team_reduce(member_eval<LAYOUT>(a, x, t, row, after_load), T);
  if (t != team_owner(c, T)) return false;
  out = lane_finish<LAYOUT>(a, x, c, row, scal);
  return true;
}

// team_finish on lane j of the wave `a`, its loads (lane_ctx: request
// columns and, paged, the page word) beside the rows'.
template <int LAYOUT, bool PAGED>
__device__ __forceinline__ bool team_decide(const GuberWaveArgs& a, int j,
                                            bool in_batch, bool active,
                                            int64_t group, int t, int T,
                                            int64_t scal[N_SCAL], LaneOut& out) {
  return team_finish<LAYOUT>(a, lane_ctx<PAGED>(a, j, in_batch, active, group), t, T,
                             scal, out);
}

// cp.async of `bytes` (4 or 8, both addresses aligned to it) from global
// to shared memory, complete at the thread's next cp.async.wait_all.
__device__ __forceinline__ void cp_async(void* smem, const void* gmem, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

// The int8 elements a thread stages (at most two: 2 L <= 2 THREADS),
// held in registers from stage_start to stage_land, so the loads are not
// waited for in between.
struct StageBytes {
  uint32_t v[2];
};

// Thread threadIdx.x's share (of a block of THREADS) of staging the item
// of p.L lanes from lane0 of wave `a` into `st`: its int64 and int32
// elements as cp.async copies, its int8 elements as loads into the
// returned registers. Starts only: stage_land completes them.
template <int THREADS>
__device__ __forceinline__ StageBytes stage_start(const GuberWaveArgs& a, int64_t lane0,
                                                  const ScanPlan& p, unsigned char* st) {
  StageElem el;
  for (int e = threadIdx.x; e < STAGE_WIDE_COLS * p.L; e += THREADS)
    if (stage_elem(a, lane0, p, e, el)) cp_async(st + el.off, el.src, el.size);
  StageBytes b{{0, 0}};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int e = STAGE_WIDE_COLS * p.L + threadIdx.x + r * THREADS;
    if (e < STAGE_COLS * p.L && stage_elem(a, lane0, p, e, el)) b.v[r] = *el.src;
  }
  return b;
}

// Completes the block's stage_start: stores the thread's int8 elements
// and waits for its cp.async copies; with `sync`, a __syncthreads() then
// makes the whole stage visible to the block (without it, the caller's
// next block barrier does). Every thread of the block must call it.
template <int THREADS>
__device__ __forceinline__ void stage_land(const GuberWaveArgs& a, int64_t lane0,
                                           const ScanPlan& p, unsigned char* st,
                                           const StageBytes& b, bool sync) {
  StageElem el;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int e = STAGE_WIDE_COLS * p.L + threadIdx.x + r * THREADS;
    if (e < STAGE_COLS * p.L && stage_elem(a, lane0, p, e, el))
      st[el.off] = static_cast<unsigned char>(b.v[r]);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  if (sync) __syncthreads();
}
#endif  // __CUDACC__

}  // namespace guber
