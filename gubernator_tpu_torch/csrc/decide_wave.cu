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
// Bound. At B = 1024 a wave moves about B x (W x 40 B of probe columns +
// the rest of the row + the new row (80 B fused, 72 B narrow) + ~170 B
// of batch columns and outputs, + 4 B of page map when paged) ~= 0.6 MB,
// ~0.2 us at the H100 SXM's 3.35 TB/s (NVIDIA data sheet, not a
// measurement). No design reaches that: one HBM round trip costs more.
// What bounds the kernel on this card is LATENCY: the chain of dependent
// memory steps of a lane (page map -> the group's rows -> the store),
// the launch, and the sums across blocks.
//
// Design: a TEAM of T threads per lane (decide_lane.cuh team_decide), T
// the smallest power of two >= ways (8 for every configuration the
// engine runs), blocks of 128 threads holding 128 / T lanes, a grid of
// team_blocks(B, ways) (64 blocks at B = 1024). What it does about the
// chain:
//   - member t loads way t's whole row (five 16-byte loads fused, nine
//     8-byte loads narrow), the lane's request columns alongside: the
//     group costs one round trip, where one thread per lane walked the
//     ways one after another (up to W round trips) and read the chosen
//     row a second time for a live match;
//   - the team picks the way with a butterfly of warp shuffles over
//     log2 T steps (combine: first live match; lexicographic minimum of
//     (insertion score, way)), exact to the serial rule;
//   - the member that holds the chosen row runs the bucket branch from
//     its registers and stores the new row and the lane's outputs;
//   - the 9 sums (hits, misses, unexpired evictions, over-limit and the
//     5 WaveScan sums) are reduced per block and added with one 64-bit
//     atomicAdd per scalar per block into a buffer that the launch
//     before on the stream zeroed; block 0 zeroes the next launch's
//     (wave_sums): one device operation per wave, no memset before it.
// The Pallas kernel's block structure (DMA a block of lanes' groups into
// VMEM, compute, DMA rows back) is not carried over: the team's loads go
// straight to L2/HBM and the 132 SMs run the blocks in parallel. Padding
// lanes and paged sentinel lanes (page not resident) read and write no
// row (slot == n). Distinct groups per wave, the assembler's invariant,
// make the row stores race-free without atomics.

#include <cuda_runtime.h>

#include "decide_lane.cuh"

namespace {

constexpr int kThreads = guber::TEAM_THREADS;

template <int LAYOUT, bool PAGED>
__global__ void __launch_bounds__(kThreads)
    decide_wave_kernel(const GuberWaveArgs a) {
  const int T = guber::team_size(a.ways);
  const int j = blockIdx.x * (kThreads / T) + threadIdx.x / T;
  const int t = threadIdx.x & (T - 1);
  int64_t s[guber::N_SCAL];
#pragma unroll
  for (int k = 0; k < guber::N_SCAL; ++k) s[k] = 0;
  // active and group are read together: the group's loads need both
  const bool in_batch = j < a.batch;
  const bool active = in_batch && a.active[j] != 0;
  const int64_t group = in_batch ? a.group[j] : 0;
  guber::LaneOut o;
  if (guber::team_decide<LAYOUT, PAGED>(a, j, in_batch, active, active ? group : 0,
                                        t, T, s, o) &&
      in_batch) {
    guber::store_lane(a, j, o);
    a.out_freed[j] = o.freed ? 1 : 0;
  }
  guber::wave_sums<kThreads>(s, a);
}

}  // namespace

extern "C" {

// Launch one wave of configuration (layout, paged) on `stream` (a
// cudaStream_t; the caller passes PyTorch's current stream): the kernel
// alone, which adds the 9 sums into args->scalars (zero) and zeroes
// args->next_scalars. layout is guber::LAYOUT_FUSED or LAYOUT_NARROW,
// paged 0 or 1. Returns the cudaError_t of the launch; 0 means launched.
// Does not synchronise.
int guber_decide_wave(const GuberWaveArgs* args, int layout, int paged,
                      void* stream) {
  if ((layout != guber::LAYOUT_FUSED && layout != guber::LAYOUT_NARROW) ||
      (paged != 0 && paged != 1) || args->batch < 1 || args->ways < 1 ||
      args->next_scalars == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = guber::team_blocks(args->batch, args->ways);
  guber::dispatch(layout, paged, [&](auto L, auto P) {
    decide_wave_kernel<decltype(L)::value, decltype(P)::value>
        <<<blocks, kThreads, 0, st>>>(*args);
  });
  return static_cast<int>(cudaGetLastError());
}

// Human-readable name of a cudaError_t returned above or by
// guber_decide_scan / guber_decide_sharded (built into the same library).
const char* guber_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
