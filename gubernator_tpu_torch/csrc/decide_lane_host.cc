// The decide wave's per-lane code (decide_lane.cuh) compiled for the CPU
// by g++, one lane after another. Tests only: it lets the CPU test suite
// hold the kernel's own C++ against the plain PyTorch version, since no
// CUDA compiler or card is there. Lanes of a wave touch distinct groups,
// so running them in sequence gives what the parallel kernel gives.
// No serving path calls it.

#include "decide_lane.cuh"

extern "C" int guber_decide_wave_host(const GuberWaveArgs* args) {
  int64_t s[guber::N_SCAL] = {0};
  for (int j = 0; j < args->batch; ++j) guber::decide_lane(*args, j, s);
  for (int k = 0; k < guber::N_SCAL; ++k) args->scalars[k] = s[k];
  return 0;
}
