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
// The same kernel, unchanged, also replaces raw_decide_flat where the
// GLOBAL replica tier composes it (gubernator_tpu/parallel/ici.py
// make_replica_decide, each device's replica decide psum'd over the
// replicas): parallel/ici.py stacks the D replicas as D shards of
// num_rgroups groups and sets each lane's group to home * num_rgroups +
// slot, so shard_lane sends the lane to its home's replica at its slot
// and store_lane_sharded writes what that psum gives.
//
// Bound. The same bytes as one flat wave (decide_wave.cu), with freed
// stored as int32: ~0.6 MB at B = 1024, ~0.2 us at the H100 SXM's 3.35
// TB/s (NVIDIA data sheet, not a measurement). Like the flat wave it is
// bound by latency: the lane's chain (group and page map -> rows ->
// store), the launch and the sums across blocks, not by bytes.
//
// Design. One launch per wave for all the shards on the card, with the
// wave kernel's team of T threads per lane (decide_wave.cu: member t
// loads way t's whole row in one round, a shuffle butterfly picks the
// way, the member holding the chosen row finishes the lane from its
// registers; the 9 sums are added into a buffer the stream's launch
// before zeroed, no memset). On one card
// the D shards are D row ranges of one allocation, so a lane's owner is
// a function of its group: every member of the team runs the ownership
// prologue (decide_lane.cuh shard_lane; the same loads, coalesced, and
// the same answer in each) before its rows, runs the team body on the
// owner's rows with the shard-local group (shard_view), and the owning
// member stores what the psum would give (store_lane_sharded): the
// owner's answer, with slot + (D - 1) * n_local for the D - 1 shards
// that report a masked lane's slot as their n_local, and freed as int32.
// A grid that ran every lane once per shard would store D copies of
// every output and need a second pass to sum them; here the psum's
// arithmetic is the epilogue and nothing else is launched. Every shard's
// sums add up in the one reduction, as the psum adds them.

#include <cuda_runtime.h>

#include "decide_lane.cuh"

namespace {

constexpr int kThreads = guber::TEAM_THREADS;

template <int LAYOUT, bool XLATE>
__global__ void __launch_bounds__(kThreads)
    decide_sharded_kernel(const GuberShardArgs a) {
  const int T = guber::team_size(a.wave.ways);
  const int j = blockIdx.x * (kThreads / T) + threadIdx.x / T;
  const int t = threadIdx.x & (T - 1);
  int64_t s[guber::N_SCAL];
#pragma unroll
  for (int k = 0; k < guber::N_SCAL; ++k) s[k] = 0;
  const bool in_batch = j < a.wave.batch;
  const guber::ShardLane L =
      in_batch ? guber::shard_lane<XLATE>(a, j) : guber::ShardLane{false, 0, 0};
  const GuberWaveArgs w = guber::shard_view<LAYOUT>(a, L);
  guber::LaneOut o;
  if (guber::team_decide<LAYOUT, false>(w, j, in_batch, L.owned, L.group, t, T, s, o) &&
      in_batch)
    guber::store_lane_sharded(a, j, o);
  guber::wave_sums<kThreads>(s, a.wave);
}

}  // namespace

extern "C" {

// Launch one sharded wave of configuration (layout, xlate) on `stream`
// (PyTorch's current stream): the kernel alone, which adds the 9 sums
// into args->wave.scalars (zero) and zeroes args->wave.next_scalars, as
// guber_decide_wave does. layout is guber::LAYOUT_FUSED or LAYOUT_NARROW;
// xlate 1 for a paged mesh (the page map translates groups first), 0 for
// a flat one. Returns the cudaError_t of the launch; 0 means launched.
// Does not synchronise.
int guber_decide_sharded(const GuberShardArgs* args, int layout, int xlate,
                         void* stream) {
  if ((layout != guber::LAYOUT_FUSED && layout != guber::LAYOUT_NARROW) ||
      (xlate != 0 && xlate != 1) || args->n_shards < 1 ||
      args->groups_per < 1 || args->wave.batch < 1 || args->wave.ways < 1 ||
      args->wave.next_scalars == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = guber::team_blocks(args->wave.batch, args->wave.ways);
  guber::dispatch(layout, xlate, [&](auto L, auto X) {
    decide_sharded_kernel<decltype(L)::value, decltype(X)::value>
        <<<blocks, kThreads, 0, st>>>(*args);
  });
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
