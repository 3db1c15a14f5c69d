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
// Bound. A step moves what one wave moves (decide_wave.cu): about
// B x (W x 40 B of probe columns + the new row (80 B fused, 72 B narrow)
// + ~170 B of batch columns and outputs) plus the rest of the row for
// live matches; at B = 4096 about 2.3 MB, ~0.7 us at the H100 SXM's
// 3.35 TB/s (NVIDIA data sheet, not a measurement). What bounds a step
// on this card is latency: the grid barrier between steps (about 1 us),
// then each lane's dependent chain (rows -> selection -> the owner's
// int64 bucket arithmetic -> store); PERF.md §5 has the ablation.
//
// Design. A persistent grid, launched once with
// cudaLaunchCooperativeKernel. Each step runs the wave kernel's body
// (decide_lane.cuh team_finish): a TEAM of T threads per lane (T = 8 for
// 8 ways), member t loading way t's whole row in one round, a shuffle
// butterfly picking the way, the member that holds the chosen row
// finishing the lane from its registers. A block's teams hold L =
// threads / T lanes, an ITEM; block b runs items b, b + grid, ... of
// every step (scan_plan), the same count in every block, so every member
// of every warp reaches every shuffle (an item past the batch runs
// in_batch = false lanes). Blocks have 128 threads while a step's items
// fit one block per SM, else 256 (B = 4096 at 8 ways: 128 blocks of 32
// lanes, not 256 of 16: half the arrivals at every barrier, about 5%
// faster a step; at B <= 2048, 128-thread blocks spread the lanes over
// more SMs and are faster). The grid is min(items, co-resident
// blocks) (the occupancy query counts the stage's dynamic shared
// memory); when a step has more items than that (ways > 8 at B = 4096)
// the blocks stride.
//
// Staged inputs. Nothing a lane reads besides its group's rows depends
// on the table: its batch columns and, paged, the page-map word (no
// decide writes the page map). So while item n runs, the block copies
// item n + 1's 14 batch columns into the other of two stages in shared
// memory (stage_start: cp.async for the int64 and int32 columns, loads
// held in registers for the int8 ones), completes them after item n
// (stage_land), and each team sends its next lane's page-map load from
// the stage. Item n + 1 may be the next step's first: its inputs are
// then in flight, or landed, before the barrier releases it, and after
// the barrier a step's chain starts at its rows. The copies start
// from member_eval's hook, once the member's row load is out, so their
// instructions overlap that load instead of delaying it.
//
// Table rows are never staged or prefetched. Consecutive steps share
// groups (a Zipf head is in every step), so step t + 1 must read the
// rows step t stored: the barrier orders the steps and makes the stores
// visible, and the rows are read after it with plain (coherent) loads
// (load_row), never __ldg, a const __restrict__ table or an async copy
// started before the barrier, which could read a row before the store
// that precedes it. Within a step the lanes' groups are distinct (the
// assembler's invariant), so the stores need no atomics.
//
// Barriers. Step t ends at barrier t (t < T - 1). Barrier 0 is the
// cooperative grid.sync(); barriers 1 .. T - 2 are flip_barrier, one
// arrival counter with release/acquire atomics, on a word the wrapper
// hands over with the launch (any value: block 0 zeroes it before
// barrier 0). The two were timed against each other on one card
// (python -m gubernator_tpu_torch.ablate, PERF.md).
//
// Sums, one device operation per scan (no memset). Block 0 zeroes the
// (T, 9) rows before it reaches its first barrier. Each block reduces a
// step's 9 sums per warp into shared memory before the barrier that
// ends the step, and adds them (add_partials, one 64-bit atomicAdd per
// nonzero sum per block) after it, so the atomics do not delay the
// barrier. Ordering: every block adds row t only after barrier t, which
// block 0 reached after zeroing (barrier 0 is a grid.sync()). For
// T >= 2 the last step needs no barrier of its own, since every block
// passed barrier 0 before it; a scan of T = 1 runs barrier 0 between the
// zeroing and the adds. The partials are double-buffered by step
// parity: a block writes step t + 2's into the buffer it read step t's
// from only after barrier t + 1.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "decide_lane.cuh"

namespace cg = cooperative_groups;

namespace {

// Block sizes: 128 threads while a step's items of 128 fit one block per
// SM, else 256 (half the blocks at every barrier). Chosen at launch.
constexpr int kSmall = guber::TEAM_THREADS;
constexpr int kLarge = 2 * guber::TEAM_THREADS;

// Grid barriers 1 .. T - 2 of a scan: one arrival counter in the cooperative
// groups' flip scheme (block 0 adds 2^31 - (grid - 1), every other block
// 1, so the top bit flips when the last block arrives and the low bits
// return to 0), with a release add and acquire polls where grid.sync()
// fences. Each block's stores before it are visible to every block
// after it (release sequence of the adds, then the block barrier).
// `counter` must be 0 before a block arrives first: block 0 zeroes it
// before barrier 0, which is a grid.sync().
__device__ __forceinline__ void flip_barrier(uint32_t* counter) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const uint32_t add = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    uint32_t old, cur;
    asm volatile("atom.add.release.gpu.u32 %0, [%1], %2;\n"
                 : "=r"(old) : "l"(counter), "r"(add) : "memory");
    do {
      asm volatile("ld.acquire.gpu.u32 %0, [%1];\n" : "=r"(cur) : "l"(counter) : "memory");
    } while (((old ^ cur) & 0x80000000u) == 0);
  }
  __syncthreads();
}

// Dynamic shared memory of a launch: two stages of p.L lanes.
size_t stage_bytes(const guber::ScanPlan& p) {
  return 2 * (size_t)p.L * guber::STAGE_LANE_BYTES;
}

template <int LAYOUT, bool PAGED, int THREADS>
__global__ void __launch_bounds__(THREADS)
    decide_scan_kernel(const GuberScanArgs a) {
  extern __shared__ __align__(16) unsigned char stage[];
  __shared__ unsigned long long part[2][THREADS / 32][guber::N_SCAL];
  cg::grid_group grid = cg::this_grid();
  const int nb = gridDim.x;
  const guber::ScanPlan p = guber::scan_plan(a.wave.batch, a.wave.ways, nb, THREADS);
  const int m = threadIdx.x & (p.T - 1);  // the thread's member of its team
  const int i = threadIdx.x / p.T;  // its team's lane in the item
  // item n (counted over the steps) is staged at stage + (n & 1) * half
  const int half = p.L * guber::STAGE_LANE_BYTES;
  if (blockIdx.x == 0) {
    for (int k = threadIdx.x; k < a.steps * guber::N_SCAL; k += THREADS)
      a.wave.scalars[k] = 0;
    if (threadIdx.x == 0) *a.barrier = 0;
  }
  int32_t pp = -1;  // paged: the page word of the thread's lane of the staged item
  {  // stage the first item
    const GuberWaveArgs w0 = guber::step_args(a, 0);
    const int64_t l0 = guber::item_lane0(p, blockIdx.x, 0, nb);
    const guber::StageBytes held = guber::stage_start<THREADS>(w0, l0, p, stage);
    guber::stage_land<THREADS>(w0, l0, p, stage, held, true);
    if (PAGED) pp = guber::staged_page_word(w0, l0, p, stage, i);
  }
  int n = 0;  // items run so far
  for (int t = 0; t < a.steps; ++t) {
    const GuberWaveArgs w = guber::step_args(a, t);
    int64_t s[guber::N_SCAL];
#pragma unroll
    for (int k = 0; k < guber::N_SCAL; ++k) s[k] = 0;
    for (int k = 0; k < p.iters; ++k, ++n) {
      // the next item: this step's next, or the next step's first
      const bool last = k + 1 == p.iters;
      const bool more = !last || t + 1 < a.steps;
      const GuberWaveArgs wn = last && more ? guber::step_args(a, t + 1) : w;
      const int64_t ln = guber::item_lane0(p, blockIdx.x, last ? 0 : k + 1, nb);
      unsigned char* const cur = stage + (n & 1) * half;
      unsigned char* const next = stage + ((n + 1) & 1) * half;
      // this item, from its stage; the next one's copies start once
      // the member's row load is out (the hook), so they overlap it
      const int64_t j = guber::item_lane0(p, blockIdx.x, k, nb) + i;
      const bool in_batch = j < w.batch;
      const GuberWaveArgs sv = guber::stage_view(w, cur, p.L);
      const bool active = in_batch && sv.active[i] != 0;
      const guber::LaneCtx x =
          guber::lane_ctx<PAGED>(sv, i, in_batch, active, active ? sv.group[i] : 0, pp);
      guber::StageBytes held{{0, 0}};
      guber::LaneOut o;
      if (guber::team_finish<LAYOUT>(w, x, m, p.T, s, o, [&] {
            if (more) held = guber::stage_start<THREADS>(wn, ln, p, next);
          }) && in_batch) {
        guber::store_lane(w, (int)j, o);
        w.out_freed[j] = o.freed ? 1 : 0;
      }
      if (more) {
        // flat, the step's barrier publishes its last stage; paged, the
        // page words need it first
        guber::stage_land<THREADS>(wn, ln, p, next, held, PAGED || !last);
        if (PAGED) pp = guber::staged_page_word(wn, ln, p, next, i);
      }
    }
    guber::warp_partials(s, part[t & 1]);
    // Every block's row stores of step t before any block starts step t + 1.
    if (t == 0)
      grid.sync();  // also orders block 0's zeroing of the sums and the counter
    else if (t + 1 < a.steps)
      flip_barrier(a.barrier);
    else
      __syncthreads();
    guber::add_partials<THREADS>(part[t & 1], w.scalars);
  }
}

// A launch of the scan: the kernel, its block size, grid and dynamic
// shared memory.
struct Launch {
  const void* fn;
  int threads, blocks;
  size_t smem;
};

// The launch of configuration (LAYOUT, PAGED) with THREADS per block
// for `args` on a card of `sms` SMs: min(items, co-resident blocks).
template <int LAYOUT, bool PAGED, int THREADS>
cudaError_t fit(const GuberScanArgs* args, int sms, Launch* l) {
  l->fn = reinterpret_cast<const void*>(&decide_scan_kernel<LAYOUT, PAGED, THREADS>);
  l->threads = THREADS;
  const guber::ScanPlan p = guber::scan_plan(args->wave.batch, args->wave.ways, 1, THREADS);
  l->smem = stage_bytes(p);
  int per_sm = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, l->fn, THREADS, l->smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  l->blocks = p.items < per_sm * sms ? p.items : per_sm * sms;
  if (l->blocks < 1) l->blocks = 1;
  return cudaSuccess;
}

// The launch of configuration (LAYOUT, PAGED) for `args` on the current
// device.
template <int LAYOUT, bool PAGED>
cudaError_t plan_launch(const GuberScanArgs* args, Launch* l) {
  int dev = 0, coop = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  const int items = guber::scan_plan(args->wave.batch, args->wave.ways, 1, kSmall).items;
  return items <= sms ? fit<LAYOUT, PAGED, kSmall>(args, sms, l)
                      : fit<LAYOUT, PAGED, kLarge>(args, sms, l);
}

bool valid(const GuberScanArgs* args, int layout, int paged) {
  return (layout == guber::LAYOUT_FUSED || layout == guber::LAYOUT_NARROW) &&
         (paged == 0 || paged == 1) && args->steps >= 1 && args->wave.batch >= 0 &&
         args->wave.ways >= 1;
}

}  // namespace

extern "C" {

// Launch the scan of configuration (layout, paged) on `stream` (PyTorch's
// current stream) as ONE cooperative launch, the kernel alone: it zeroes
// and fills the (steps, 9) sums itself. Returns the cudaError_t of the
// device queries or the launch (guber_cuda_error_string, decide_wave.cu,
// names it); 0 means launched. cudaErrorNotSupported: the device cannot
// launch cooperatively. Does not synchronise.
int guber_decide_scan(const GuberScanArgs* args, int layout, int paged,
                      void* stream) {
  if (!valid(args, layout, paged)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  guber::dispatch(layout, paged, [&](auto L, auto P) {
    Launch l;
    err = plan_launch<decltype(L)::value, decltype(P)::value>(args, &l);
    if (err != cudaSuccess) return;
    void* kargs[] = {const_cast<GuberScanArgs*>(args)};
    err = cudaLaunchCooperativeKernel(l.fn, dim3(l.blocks), dim3(l.threads), kargs, l.smem, st);
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The block size and grid guber_decide_scan would launch for `args` on
// the current device, into *threads and *blocks (a check that a scan's
// blocks stride: fewer blocks than a step has items). Returns the
// cudaError_t of the device queries.
int guber_decide_scan_grid(const GuberScanArgs* args, int layout, int paged,
                           int* threads, int* blocks) {
  if (!valid(args, layout, paged)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSuccess;
  guber::dispatch(layout, paged, [&](auto L, auto P) {
    Launch l;
    err = plan_launch<decltype(L)::value, decltype(P)::value>(args, &l);
    *threads = l.threads;
    *blocks = l.blocks;
  });
  return static_cast<int>(err);
}

}  // extern "C"
