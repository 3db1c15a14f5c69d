// The decide kernels' lane code (decide_lane.cuh) compiled for the CPU
// by g++, one lane after another. Tests only: it lets the CPU test suite
// hold the kernels' own C++ against the plain PyTorch version, since no
// CUDA compiler or card is there. No serving path calls it.
//
// Every kernel runs a lane as a team of threads, emulated here for each
// lane: the T members' candidates and rows (member_eval), the
// butterfly's combine calls in the device's order
// (team_reduce_emulated), then the owning member's lane_finish; only the
// warp shuffles differ from the kernels.
// - A sharded wave also runs the ownership prologue and the psum
//   epilogue of decide_sharded.cu for each lane.
// - A scan runs decide_scan.cu's data flow on a grid of a given number
//   of blocks of a given size: its steps in order, as the grid barrier orders them, each
//   block's items (scan_plan) in order, each item's batch columns staged
//   (the kernel's stage layout and element order, item n + 1 staged
//   before item n runs, in the other of two stages) and its lanes' page
//   words read from the stage, every lane of an item (those past the
//   batch too) by its team from the staged columns, and each block's
//   sums added per step into the zeroed (steps, 9) rows.
// Lanes of a wave touch distinct groups, so running them in sequence
// gives what the parallel kernels give.

#include <cstring>
#include <vector>

#include "decide_lane.cuh"

namespace {

// A lane as its team computes it, on the lane's context x, each member
// with the kernel's `after_load` hook (the scan's: its first row loaded
// ahead of its loop). False if the team does not have exactly one
// member that owns the chosen row (the device would then store the
// lane's outputs never, or twice).
template <int LAYOUT, typename Hook = guber::NoHook>
bool team_emulated(const GuberWaveArgs& a, const guber::LaneCtx& x,
                   int64_t scal[guber::N_SCAL], guber::LaneOut& out,
                   const Hook& after_load = Hook()) {
  const int T = guber::team_size(a.ways);
  guber::Cand c[guber::TEAM_MAX];
  guber::Row<LAYOUT> rows[guber::TEAM_MAX];
  for (int t = 0; t < T; ++t)
    c[t] = guber::member_eval<LAYOUT>(a, x, t, rows[t], after_load);
  guber::team_reduce_emulated(c, T);
  int owner = -1;
  for (int t = 0; t < T; ++t) {
    if (t != guber::team_owner(c[t], T)) continue;
    if (owner >= 0) return false;
    owner = t;
  }
  if (owner < 0) return false;
  out = guber::lane_finish<LAYOUT>(a, x, c[owner], rows[owner], scal);
  return true;
}

// Lane j of a wave, its context read from the batch.
template <int LAYOUT, bool PAGED>
bool team_decide_emulated(const GuberWaveArgs& a, int j, bool active,
                          int64_t group, int64_t scal[guber::N_SCAL],
                          guber::LaneOut& out) {
  return team_emulated<LAYOUT>(a, guber::lane_ctx<PAGED>(a, j, true, active, group), scal,
                               out);
}

template <int LAYOUT, bool PAGED>
bool run_wave(const GuberWaveArgs& a, int64_t* s) {
  for (int j = 0; j < a.batch; ++j) {
    const bool active = a.active[j] != 0;
    guber::LaneOut o;
    if (!team_decide_emulated<LAYOUT, PAGED>(a, j, active, active ? a.group[j] : 0, s, o))
      return false;
    guber::store_lane(a, j, o);
    a.out_freed[j] = o.freed ? 1 : 0;
  }
  return true;
}

template <int LAYOUT, bool XLATE>
bool run_sharded(const GuberShardArgs& a, int64_t* s) {
  for (int j = 0; j < a.wave.batch; ++j) {
    const guber::ShardLane L = guber::shard_lane<XLATE>(a, j);
    const GuberWaveArgs w = guber::shard_view<LAYOUT>(a, L);
    guber::LaneOut o;
    if (!team_decide_emulated<LAYOUT, false>(w, j, L.owned, L.group, s, o)) return false;
    guber::store_lane_sharded(a, j, o);
  }
  return true;
}

// Stages the item of p.L lanes from lane0 of wave `a` into `st`: every
// element the kernel's threads copy between them (stage_start).
void stage_copy(const GuberWaveArgs& a, int64_t lane0, const guber::ScanPlan& p,
                unsigned char* st) {
  guber::StageElem el;
  for (int e = 0; e < guber::STAGE_COLS * p.L; ++e)
    if (guber::stage_elem(a, lane0, p, e, el)) std::memcpy(st + el.off, el.src, el.size);
}

// One block's state across the scan: its two stages and its lanes' page
// words for the item staged next.
struct BlockState {
  std::vector<unsigned char> stage;
  std::vector<int32_t> pp;
};

template <int LAYOUT, bool PAGED>
bool run_scan(const GuberScanArgs& a, int grid, int threads) {
  const guber::ScanPlan p = guber::scan_plan(a.wave.batch, a.wave.ways, grid, threads);
  const int half = p.L * guber::STAGE_LANE_BYTES;
  for (int k = 0; k < a.steps * guber::N_SCAL; ++k) a.wave.scalars[k] = 0;
  std::vector<BlockState> blocks(grid);
  const GuberWaveArgs w0 = guber::step_args(a, 0);
  for (int b = 0; b < grid; ++b) {
    BlockState& B = blocks[b];
    B.stage.assign(2 * half, 0);
    B.pp.assign(p.L, -1);
    const int64_t l0 = guber::item_lane0(p, b, 0, grid);
    stage_copy(w0, l0, p, B.stage.data());
    if (PAGED)
      for (int i = 0; i < p.L; ++i)
        B.pp[i] = guber::staged_page_word(w0, l0, p, B.stage.data(), i);
  }
  for (int t = 0; t < a.steps; ++t) {
    const GuberWaveArgs w = guber::step_args(a, t);
    for (int b = 0; b < grid; ++b) {
      BlockState& B = blocks[b];
      int64_t s[guber::N_SCAL] = {0};
      for (int k = 0; k < p.iters; ++k) {
        const int n = t * p.iters + k;
        const bool last = k + 1 == p.iters;
        const bool more = !last || t + 1 < a.steps;
        const GuberWaveArgs wn = last && more ? guber::step_args(a, t + 1) : w;
        const int64_t ln = guber::item_lane0(p, b, last ? 0 : k + 1, grid);
        unsigned char* cur = B.stage.data() + (n & 1) * half;
        unsigned char* next = B.stage.data() + ((n + 1) & 1) * half;
        if (more) stage_copy(wn, ln, p, next);
        const GuberWaveArgs sv = guber::stage_view(w, cur, p.L);
        for (int i = 0; i < p.L; ++i) {
          const int64_t j = guber::item_lane0(p, b, k, grid) + i;
          const bool in_batch = j < w.batch;
          const bool active = in_batch && sv.active[i] != 0;
          const guber::LaneCtx x = guber::lane_ctx<PAGED>(
              sv, i, in_batch, active, active ? sv.group[i] : 0, B.pp[i]);
          guber::LaneOut o;
          // the kernel's hook starts the next stage; here it was copied
          if (!team_emulated<LAYOUT>(w, x, s, o, [] {})) return false;
          if (!in_batch) continue;
          guber::store_lane(w, (int)j, o);
          w.out_freed[j] = o.freed ? 1 : 0;
        }
        if (more && PAGED)
          for (int i = 0; i < p.L; ++i) B.pp[i] = guber::staged_page_word(wn, ln, p, next, i);
      }
      for (int k = 0; k < guber::N_SCAL; ++k) w.scalars[k] = guber::wadd(w.scalars[k], s[k]);
    }
  }
  return true;
}

// The lexicographic (score, way) minimum and the first live way of
// `ways` candidates, serially: the rule the team's butterfly must give.
guber::Cand select_serial(const int64_t* scores, const uint8_t* live, int ways) {
  guber::Cand c = guber::no_cand();
  for (int w = 0; w < ways; ++w)
    c = guber::combine(c, guber::Cand{scores[w], w, live[w] ? w : guber::NO_WAY});
  return c;
}

// The same as the team selects it: member t folds ways t, t + 32, ...
// as member_eval does, then the butterfly; member 0's result (the test
// also checks that every member holds the same).
bool select_team(const int64_t* scores, const uint8_t* live, int ways, guber::Cand* out) {
  const int T = guber::team_size(ways);
  guber::Cand c[guber::TEAM_MAX];
  for (int t = 0; t < T; ++t) {
    c[t] = guber::no_cand();
    for (int w = t; w < ways; w += guber::TEAM_MAX)
      c[t] = guber::combine(c[t], guber::Cand{scores[w], w, live[w] ? w : guber::NO_WAY});
  }
  guber::team_reduce_emulated(c, T);
  for (int t = 1; t < T; ++t)
    if (c[t].score != c[0].score || c[t].way != c[0].way || c[t].match != c[0].match)
      return false;
  *out = c[0];
  return true;
}

}  // namespace

// One wave of configuration (layout, paged), as guber_decide_wave in
// decide_wave.cu takes it (next_scalars unused). Returns 0, 1 for
// an unknown configuration, 2 if a lane's team has no single owner.
extern "C" int guber_decide_wave_host(const GuberWaveArgs* args, int layout,
                                      int paged) {
  int64_t s[guber::N_SCAL] = {0};
  bool ok = true;
  const bool known = guber::dispatch(layout, paged, [&](auto L, auto P) {
    ok = run_wave<decltype(L)::value, decltype(P)::value>(*args, s);
  });
  if (!known) return 1;
  if (!ok) return 2;
  for (int k = 0; k < guber::N_SCAL; ++k) args->scalars[k] = s[k];
  return 0;
}

// A scan of args->steps waves, as guber_decide_scan in decide_scan.cu
// runs it on a grid of `grid` blocks (>= 1) of `threads` threads (128 or
// 256). Returns 0, 1 for an unknown configuration or a bad grid, 2 if a
// lane's team has no single owner.
extern "C" int guber_decide_scan_host(const GuberScanArgs* args, int layout,
                                      int paged, int grid, int threads) {
  if (grid < 1 || (threads != guber::TEAM_THREADS && threads != 2 * guber::TEAM_THREADS) ||
      args->steps < 1 || args->wave.batch < 0 || args->wave.ways < 1)
    return 1;
  bool ok = true;
  const bool known = guber::dispatch(layout, paged, [&](auto L, auto P) {
    ok = run_scan<decltype(L)::value, decltype(P)::value>(*args, grid, threads);
  });
  if (!known) return 1;
  return ok ? 0 : 2;
}

// One sharded wave of configuration (layout, xlate), as
// guber_decide_sharded in decide_sharded.cu takes it. Returns 0, 1 for
// an unknown configuration, 2 if a lane's team has no single owner.
extern "C" int guber_decide_sharded_host(const GuberShardArgs* args,
                                         int layout, int xlate) {
  int64_t s[guber::N_SCAL] = {0};
  bool ok = true;
  const bool known = guber::dispatch(layout, xlate, [&](auto L, auto X) {
    ok = run_sharded<decltype(L)::value, decltype(X)::value>(*args, s);
  });
  if (!known) return 1;
  if (!ok) return 2;
  for (int k = 0; k < guber::N_SCAL; ++k) args->wave.scalars[k] = s[k];
  return 0;
}

// The selection over `ways` candidates (scores[w], live[w]), by the
// serial fold into out[0..3) and by the team (member folds, then the
// emulated butterfly) into out[3..6), each as (score, way, match).
// Returns 0, or 1 if the team's members disagree.
extern "C" int guber_select_host(const int64_t* scores, const uint8_t* live,
                                 int ways, int64_t* out) {
  const guber::Cand s = select_serial(scores, live, ways);
  guber::Cand t;
  if (!select_team(scores, live, ways, &t)) return 1;
  const guber::Cand both[2] = {s, t};
  for (int k = 0; k < 2; ++k) {
    out[3 * k] = both[k].score;
    out[3 * k + 1] = both[k].way;
    out[3 * k + 2] = both[k].match;
  }
  return 0;
}
