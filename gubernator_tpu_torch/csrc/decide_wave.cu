// The fused decide wave as a CUDA kernel for Hopper (sm_90a).
//
// Replaces gubernator_tpu/ops/pallas_decide.py::_make_kernel (driven by
// _build_pallas_call / _pallas_wave, entry points decide_flat and
// decide_flat_with_scan), layout "fused", flat table. Its plain PyTorch
// version is ops/fused.py::decide_fused_plain; the wrapper is
// ops/cuda_decide.py.
//
// Design. One thread per lane, blocks of 128, a grid of ceil(B/128). A
// thread reads its group's probe columns (KHI KLO META EXP INV) for the
// W ways, chooses the way, reads that row's 10 columns, runs only its
// algorithm's branch (decide_lane.cuh) and stores the new row in place.
// The Pallas kernel's block structure (DMA a block of lanes' groups into
// VMEM, compute, DMA rows back) is not carried over: on Hopper each
// thread's loads go straight to L2/HBM and the 132 SMs run the blocks in
// parallel. Padding lanes read and write nothing (slot == n). Distinct
// groups per wave, the assembler's invariant, make the row stores
// race-free without atomics. The 9 scalars (hits, misses, unexpired
// evictions, over-limit and the 5 WaveScan sums) are reduced per warp
// with shuffles and per block in shared memory, then added with one
// 64-bit atomicAdd per scalar per block; integer sums do not depend on
// order, so the result is bit-exact.
//
// Bound. At B = 1024 a wave moves about B x (320 B of probe columns +
// 80 B row read + 80 B row write + ~170 B of batch columns and outputs)
// ~= 0.67 MB, ~0.2 us at 3.35 TB/s: the kernel is bound by launch and
// memory latency (a dependent probe -> row -> store chain per thread),
// not by bytes. Hiding that (CUDA graphs over a flush's waves,
// persistent blocks) is later work.

#include <cuda_runtime.h>

#include "decide_lane.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
    decide_wave_kernel(const GuberWaveArgs a) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  int64_t s[guber::N_SCAL];
#pragma unroll
  for (int k = 0; k < guber::N_SCAL; ++k) s[k] = 0;
  if (j < a.batch) guber::decide_lane(a, j, s);

  // Block reduction of the scalars: warp shuffles, then shared memory.
  __shared__ unsigned long long part[kWarps][guber::N_SCAL];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < guber::N_SCAL; ++k) {
    unsigned long long v = (unsigned long long)s[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) part[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < guber::N_SCAL) {
    unsigned long long t = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += part[w][threadIdx.x];
    if (t != 0)
      atomicAdd(reinterpret_cast<unsigned long long*>(a.scalars) + threadIdx.x,
                t);
  }
}

}  // namespace

extern "C" {

// Zero the scalars and launch one wave on `stream` (a cudaStream_t; the
// caller passes PyTorch's current stream). Returns the cudaError_t of
// the memset or of the launch; 0 means launched. Does not synchronise.
int guber_decide_wave(const GuberWaveArgs* args, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(args->scalars, 0,
                                    guber::N_SCAL * sizeof(int64_t), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (args->batch + kThreads - 1) / kThreads;
  decide_wave_kernel<<<blocks, kThreads, 0, st>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

// Human-readable name of a cudaError_t returned above.
const char* guber_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
