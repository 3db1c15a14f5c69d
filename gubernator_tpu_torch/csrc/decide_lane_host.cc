// The decide wave's per-lane code (decide_lane.cuh) compiled for the CPU
// by g++, one lane after another. Tests only: it lets the CPU test suite
// hold the kernel's own C++ against the plain PyTorch version, since no
// CUDA compiler or card is there. Lanes of a wave touch distinct groups,
// so running them in sequence gives what the parallel kernel gives; the
// scan runs its steps in order, as the grid barrier orders them in
// decide_scan.cu; a sharded wave runs the ownership prologue and the
// psum epilogue of decide_sharded.cu for each lane. No serving path
// calls it.

#include "decide_lane.cuh"

namespace {

template <int LAYOUT, bool PAGED>
void run(const GuberWaveArgs* args, int64_t* s) {
  for (int j = 0; j < args->batch; ++j)
    guber::decide_lane<LAYOUT, PAGED>(*args, j, s);
}

// One wave into its (9,) scalars; false for an unknown configuration.
bool wave(const GuberWaveArgs* args, int layout, int paged) {
  int64_t s[guber::N_SCAL] = {0};
  const bool known = guber::dispatch(layout, paged, [&](auto L, auto P) {
    run<decltype(L)::value, decltype(P)::value>(args, s);
  });
  if (!known) return false;
  for (int k = 0; k < guber::N_SCAL; ++k) args->scalars[k] = s[k];
  return true;
}

}  // namespace

// One wave of configuration (layout, paged), as guber_decide_wave in
// decide_wave.cu takes them. Returns 0, or 1 for an unknown
// configuration.
extern "C" int guber_decide_wave_host(const GuberWaveArgs* args, int layout,
                                      int paged) {
  return wave(args, layout, paged) ? 0 : 1;
}

// A scan of args->steps waves, as guber_decide_scan in decide_scan.cu
// takes them: step t is the wave step_args(t). Returns 0, or 1 for an
// unknown configuration.
extern "C" int guber_decide_scan_host(const GuberScanArgs* args, int layout,
                                      int paged) {
  for (int t = 0; t < args->steps; ++t) {
    const GuberWaveArgs w = guber::step_args(*args, t);
    if (!wave(&w, layout, paged)) return 1;
  }
  return 0;
}

// One sharded wave of configuration (layout, xlate), as
// guber_decide_sharded in decide_sharded.cu takes it. Returns 0, or 1
// for an unknown configuration.
extern "C" int guber_decide_sharded_host(const GuberShardArgs* args,
                                         int layout, int xlate) {
  int64_t s[guber::N_SCAL] = {0};
  const bool known = guber::dispatch(layout, xlate, [&](auto L, auto X) {
    for (int j = 0; j < args->wave.batch; ++j)
      guber::decide_lane_sharded<decltype(L)::value, decltype(X)::value>(
          *args, j, s);
  });
  if (!known) return 1;
  for (int k = 0; k < guber::N_SCAL; ++k) args->wave.scalars[k] = s[k];
  return 0;
}
