// The owner-sharded decide wave as a CUDA kernel for Hopper (sm_90a).
//
// Replaces gubernator_tpu/ops/pallas_decide.py::raw_decide_flat (the
// unjitted Pallas wave, _wave -> _pallas_wave -> _make_kernel) as the
// multi-device tier composes it: parallel/mesh.py runs it inside
// shard_map on every shard's slice of the table, each shard masking the
// lanes it does not own (_mask_to_local), and psums the outputs over the
// shard axis; on a paged mesh the page map first translates every lane's
// group to its physical group (_xlate), replicated. Layouts fused and
// narrow, on a flat table or a paged mesh's frames: one template
// instantiation each. Its plain PyTorch version is
// ops/fused.py::sharded_plain (the masked wave per shard, then the
// sum); the wrapper is ops/cuda_decide.py::decide_sharded.
//
// Design. One launch per wave for all the shards on the card: one thread
// per lane, blocks of 128, a grid of ceil(B/128). On one card the D
// shards are D row ranges of one allocation, so a lane's owner is a
// function of its group: the thread finds it (decide_lane.cuh
// shard_lane, the ownership prologue), runs the shared lane body on the
// owner's rows with the shard-local group (decide_lane_sharded) and
// stores what the psum would give: the owner's answer, with slot +
// (D - 1) * n_local for the D - 1 shards that report a masked lane's
// slot as their n_local. A grid of D x ceil(B/128) that ran every lane
// once per shard would store D copies of every output (D - 1 of them
// masked zeros) and need a second pass to sum them; here the psum's
// arithmetic is the epilogue and nothing else is launched. The 9 scalars
// are reduced per block (block_add_scalars) as in decide_wave.cu: every
// shard's sums add up, as the psum adds them.
//
// Bound. The same bytes as one flat wave (decide_wave.cu), with freed
// stored as int32: ~0.6 MB at B = 1024, ~0.2 us at the H100 SXM's 3.35
// TB/s (NVIDIA data sheet, not a measurement). Like the flat wave it is
// bound by launch and memory latency (the probe -> row -> store chain of
// each thread), not by bytes.

#include <cuda_runtime.h>

#include "decide_lane.cuh"

namespace {

constexpr int kThreads = 128;

template <int LAYOUT, bool XLATE>
__global__ void __launch_bounds__(kThreads)
    decide_sharded_kernel(const GuberShardArgs a) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  int64_t s[guber::N_SCAL];
#pragma unroll
  for (int k = 0; k < guber::N_SCAL; ++k) s[k] = 0;
  if (j < a.wave.batch) guber::decide_lane_sharded<LAYOUT, XLATE>(a, j, s);
  guber::block_add_scalars<kThreads>(s, a.wave.scalars);
}

}  // namespace

extern "C" {

// Zero the scalars and launch one sharded wave of configuration (layout,
// xlate) on `stream` (PyTorch's current stream). layout is
// guber::LAYOUT_FUSED or LAYOUT_NARROW; xlate 1 for a paged mesh (the
// page map translates groups first), 0 for a flat one. Returns the
// cudaError_t of the memset or of the launch; 0 means launched. Does not
// synchronise.
int guber_decide_sharded(const GuberShardArgs* args, int layout, int xlate,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((layout != guber::LAYOUT_FUSED && layout != guber::LAYOUT_NARROW) ||
      (xlate != 0 && xlate != 1) || args->n_shards < 1 ||
      args->groups_per < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(args->wave.scalars, 0,
                                    guber::N_SCAL * sizeof(int64_t), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (args->wave.batch + kThreads - 1) / kThreads;
  guber::dispatch(layout, xlate, [&](auto L, auto X) {
    decide_sharded_kernel<decltype(L)::value, decltype(X)::value>
        <<<blocks, kThreads, 0, st>>>(*args);
  });
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
