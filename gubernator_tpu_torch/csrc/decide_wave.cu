// The decide wave as a CUDA kernel for Hopper (sm_90a).
//
// Replaces gubernator_tpu/ops/pallas_decide.py::_make_kernel (built by
// _build_pallas_call, driven by _pallas_wave) in four of its static
// configurations: layout fused or narrow, each on a flat table (entry
// points decide_flat / decide_flat_with_scan) or a paged one
// (decide_paged / decide_paged_with_scan, the page-map lookup inside the
// kernel). One template instantiation per configuration. Its plain
// PyTorch version is ops/fused.py::wave_plain; the wrapper is
// ops/cuda_decide.py.
//
// Design. One thread per lane, blocks of 128, a grid of ceil(B/128). A
// thread (paged: reads its page-map entry first) reads its group's probe
// columns (KHI KLO META EXP INV) for the W ways, chooses the way, reads
// the rest of that row only for a live match, runs only its algorithm's
// branch (decide_lane.cuh) and stores the new row in place. The Pallas
// kernel's block structure (DMA a block of lanes' groups into VMEM,
// compute, DMA rows back) is not carried over: on Hopper each thread's
// loads go straight to L2/HBM and the 132 SMs run the blocks in
// parallel. Padding lanes and paged sentinel lanes (page not resident)
// read and write no row (slot == n). Distinct groups per wave, the
// assembler's invariant, make the row stores race-free without atomics.
// The 9 scalars (hits, misses, unexpired evictions, over-limit and the 5
// WaveScan sums) are reduced per block and added with one 64-bit
// atomicAdd per scalar per block (decide_lane.cuh block_add_scalars);
// integer sums do not depend on order, so the result is bit-exact.
//
// Bound. At B = 1024 a wave moves about B x (W x 40 B of probe columns +
// the rest of the row + the new row (80 B fused, 72 B narrow) + ~170 B
// of batch columns and outputs, + 4 B of page map when paged) ~= 0.6 MB,
// ~0.2 us at the H100 SXM's 3.35 TB/s (NVIDIA data sheet, not a
// measurement): the kernel is bound by launch and memory latency
// (a dependent page map -> probe -> row -> store chain per thread), not
// by bytes. Hiding that (CUDA graphs over a flush's waves, persistent
// blocks) is later work.

#include <cuda_runtime.h>

#include "decide_lane.cuh"

namespace {

constexpr int kThreads = 128;

template <int LAYOUT, bool PAGED>
__global__ void __launch_bounds__(kThreads)
    decide_wave_kernel(const GuberWaveArgs a) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  int64_t s[guber::N_SCAL];
#pragma unroll
  for (int k = 0; k < guber::N_SCAL; ++k) s[k] = 0;
  if (j < a.batch) guber::decide_lane<LAYOUT, PAGED>(a, j, s);
  guber::block_add_scalars<kThreads>(s, a.scalars);
}

}  // namespace

extern "C" {

// Zero the scalars and launch one wave of configuration (layout, paged)
// on `stream` (a cudaStream_t; the caller passes PyTorch's current
// stream). layout is guber::LAYOUT_FUSED or LAYOUT_NARROW, paged 0 or 1.
// Returns the cudaError_t of the memset or of the launch; 0 means
// launched. Does not synchronise.
int guber_decide_wave(const GuberWaveArgs* args, int layout, int paged,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((layout != guber::LAYOUT_FUSED && layout != guber::LAYOUT_NARROW) ||
      (paged != 0 && paged != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(args->scalars, 0,
                                    guber::N_SCAL * sizeof(int64_t), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (args->batch + kThreads - 1) / kThreads;
  guber::dispatch(layout, paged, [&](auto L, auto P) {
    decide_wave_kernel<decltype(L)::value, decltype(P)::value>
        <<<blocks, kThreads, 0, st>>>(*args);
  });
  return static_cast<int>(cudaGetLastError());
}

// Human-readable name of a cudaError_t returned above or by
// guber_decide_scan (decide_scan.cu, built into the same library).
const char* guber_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
