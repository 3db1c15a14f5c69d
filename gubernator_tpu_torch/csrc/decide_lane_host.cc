// The decide kernels' lane code (decide_lane.cuh) compiled for the CPU
// by g++, one lane after another. Tests only: it lets the CPU test suite
// hold the kernels' own C++ against the plain PyTorch version, since no
// CUDA compiler or card is there. No serving path calls it.
//
// - A wave and a sharded wave run the team's data flow by emulation, for
//   each lane: the T members' candidates and rows (member_eval), the
//   butterfly's combine calls in the device's order
//   (team_reduce_emulated), then the owning member's lane_finish; only
//   the warp shuffles differ from decide_wave.cu / decide_sharded.cu. A
//   sharded wave also runs the ownership prologue and the psum epilogue
//   of decide_sharded.cu for each lane.
// - A scan runs its steps in order, as the grid barrier orders them in
//   decide_scan.cu, each lane by the one-thread body (decide_lane).
// Lanes of a wave touch distinct groups, so running them in sequence
// gives what the parallel kernels give.

#include "decide_lane.cuh"

namespace {

// Lane j of a wave as its team computes it. False if the team does not
// have exactly one member that owns the chosen row (the device would
// then store the lane's outputs never, or twice).
template <int LAYOUT, bool PAGED>
bool team_decide_emulated(const GuberWaveArgs& a, int j, bool active,
                          int64_t group, int64_t scal[guber::N_SCAL],
                          guber::LaneOut& out) {
  const int T = guber::team_size(a.ways);
  const guber::LaneCtx x = guber::lane_ctx<PAGED>(a, j, true, active, group);
  guber::Cand c[guber::TEAM_MAX];
  guber::Row<LAYOUT> rows[guber::TEAM_MAX];
  for (int t = 0; t < T; ++t) c[t] = guber::member_eval<LAYOUT>(a, x, t, rows[t]);
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

// One step of a scan into its (9,) scalars; false for an unknown
// configuration.
bool scan_step(const GuberWaveArgs* args, int layout, int paged) {
  int64_t s[guber::N_SCAL] = {0};
  const bool known = guber::dispatch(layout, paged, [&](auto L, auto P) {
    for (int j = 0; j < args->batch; ++j)
      guber::decide_lane<decltype(L)::value, decltype(P)::value>(*args, j, s);
  });
  if (!known) return false;
  for (int k = 0; k < guber::N_SCAL; ++k) args->scalars[k] = s[k];
  return true;
}

// The lexicographic (score, way) minimum and the first live way of
// `ways` candidates, serially: the scan's fold.
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
// takes them: step t is the wave step_args(t). Returns 0, or 1 for an
// unknown configuration.
extern "C" int guber_decide_scan_host(const GuberScanArgs* args, int layout,
                                      int paged) {
  for (int t = 0; t < args->steps; ++t) {
    const GuberWaveArgs w = guber::step_args(*args, t);
    if (!scan_step(&w, layout, paged)) return 1;
  }
  return 0;
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
