// The decide wave's per-lane code (decide_lane.cuh) compiled for the CPU
// by g++, one lane after another. Tests only: it lets the CPU test suite
// hold the kernel's own C++ against the plain PyTorch version, since no
// CUDA compiler or card is there. Lanes of a wave touch distinct groups,
// so running them in sequence gives what the parallel kernel gives.
// No serving path calls it.

#include "decide_lane.cuh"

namespace {

template <int LAYOUT, bool PAGED>
void run(const GuberWaveArgs* args, int64_t* s) {
  for (int j = 0; j < args->batch; ++j)
    guber::decide_lane<LAYOUT, PAGED>(*args, j, s);
}

}  // namespace

// One wave of configuration (layout, paged), as guber_decide_wave in
// decide_wave.cu takes them. Returns 0, or 1 for an unknown
// configuration.
extern "C" int guber_decide_wave_host(const GuberWaveArgs* args, int layout,
                                      int paged) {
  using guber::LAYOUT_FUSED;
  using guber::LAYOUT_NARROW;
  int64_t s[guber::N_SCAL] = {0};
  if (layout == LAYOUT_FUSED && paged == 0)
    run<LAYOUT_FUSED, false>(args, s);
  else if (layout == LAYOUT_FUSED && paged == 1)
    run<LAYOUT_FUSED, true>(args, s);
  else if (layout == LAYOUT_NARROW && paged == 0)
    run<LAYOUT_NARROW, false>(args, s);
  else if (layout == LAYOUT_NARROW && paged == 1)
    run<LAYOUT_NARROW, true>(args, s);
  else
    return 1;
  for (int k = 0; k < guber::N_SCAL; ++k) args->scalars[k] = s[k];
  return 0;
}
