// A scan of T decide waves as ONE cooperative CUDA kernel for Hopper
// (sm_90a).
//
// Replaces gubernator_tpu/ops/pallas_decide.py::decide_scan_flat (:878)
// and decide_scan_paged (:915): jitted as _flat_scan_jit / _paged_scan_jit,
// a lax.scan of T steps of _make_kernel over one table carried from step
// to step, each step's outputs stacked. Four static configurations, as in
// decide_wave.cu: layout fused or narrow, flat or paged table. Its plain
// PyTorch version is ops/fused.py::scan_plain; the wrapper is
// ops/cuda_decide.py (decide_scan_flat, decide_scan_paged). It is built
// with decide_wave.cu into one library (ops/_build.py).
//
// Design. A persistent grid, launched once with cudaLaunchCooperativeKernel:
// min(ceil(B / 128), co-resident blocks) blocks of 128 threads. For each
// step t the grid strides over the B lanes and runs the shared lane body
// (decide_lane.cuh) on step_args(t): batch and output pointers at row t,
// now = nows[t]. The 9 scalars are reduced per block and added with one
// 64-bit atomicAdd per scalar per block into row t of the (T, 9) sums
// (block_add_scalars, shared with decide_wave.cu). Then grid.sync():
// consecutive waves may hold the same groups (a Zipf head is in every
// step), so step t+1 must read the rows step t stored. The barrier orders the steps and makes the
// stores visible; the table is read with plain (coherent) loads, never
// __ldg or a const __restrict__ pointer, which could let nvcc read it
// through the non-coherent path. Within a step the lanes' groups are
// distinct (the assembler's invariant), so the stores need no atomics.
//
// Bound. A step moves what one wave moves (decide_wave.cu): about
// B x (W x 40 B of probe columns + the new row (80 B fused, 72 B narrow)
// + ~170 B of batch columns and outputs) plus the rest of the row for
// live matches; at B = 4096 about 2.3 MB, ~0.7 us at the H100 SXM's
// 3.35 TB/s (NVIDIA data sheet, not a measurement). Like the
// single wave the scan is bound by each lane's dependent load chain (page
// map -> probe -> row -> store) and, here, by the grid barrier between
// steps; what the one launch removes is the host's launch path per wave.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "decide_lane.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;

template <int LAYOUT, bool PAGED>
__global__ void __launch_bounds__(kThreads)
    decide_scan_kernel(const GuberScanArgs a) {
  cg::grid_group grid = cg::this_grid();
  const int stride = gridDim.x * kThreads;
  for (int t = 0; t < a.steps; ++t) {
    const GuberWaveArgs w = guber::step_args(a, t);
    int64_t s[guber::N_SCAL];
#pragma unroll
    for (int k = 0; k < guber::N_SCAL; ++k) s[k] = 0;
    for (int j = blockIdx.x * kThreads + threadIdx.x; j < w.batch; j += stride)
      guber::decide_lane<LAYOUT, PAGED>(w, j, s);
    guber::block_add_scalars<kThreads>(s, w.scalars);
    // Every block's stores of step t (and its reads of the reduction's
    // shared partials) before any block starts step t+1.
    if (t + 1 < a.steps) grid.sync();
  }
}

template <int LAYOUT, bool PAGED>
cudaError_t launch(const GuberScanArgs* args, cudaStream_t st) {
  const void* fn = reinterpret_cast<const void*>(&decide_scan_kernel<LAYOUT, PAGED>);
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, 0);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  int blocks = (args->wave.batch + kThreads - 1) / kThreads;
  if (blocks > per_sm * sms) blocks = per_sm * sms;
  if (blocks < 1) blocks = 1;
  void* kargs[] = {const_cast<GuberScanArgs*>(args)};
  return cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(kThreads), kargs, 0, st);
}

}  // namespace

extern "C" {

// Zero the (steps, 9) scalars and launch the scan of configuration
// (layout, paged) on `stream` (PyTorch's current stream), as ONE
// cooperative launch. Returns the cudaError_t of the device queries, the
// memset or the launch (guber_cuda_error_string, decide_wave.cu, names
// it); 0 means launched. cudaErrorNotSupported: the device cannot launch
// cooperatively. Does not synchronise.
int guber_decide_scan(const GuberScanArgs* args, int layout, int paged,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((layout != guber::LAYOUT_FUSED && layout != guber::LAYOUT_NARROW) ||
      (paged != 0 && paged != 1) || args->steps < 1 || args->wave.batch < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(
      args->wave.scalars, 0,
      (size_t)args->steps * guber::N_SCAL * sizeof(int64_t), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  guber::dispatch(layout, paged, [&](auto L, auto P) {
    err = launch<decltype(L)::value, decltype(P)::value>(args, st);
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
