// Blocked TV-L1 level solve for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the TPU's blocked level kernel: optflow_tpu/ops/tvl1_pallas.py,
// `_make_blocked_kernel`, launched by `_run_blocked` from
// `_blocked_level_fn`. Like that kernel, one call solves a whole pyramid
// level for a batch of images (the gradient of i1, then `warps` sweeps, each
// an exact backward warp and up to `iterations` primal-dual iterations on
// tiles held in on-chip memory) with a per-image epsilon exit tested once
// every k iterations of a sweep, on that iteration's error, and returns the
// flow and the iterations each image ran. No path of the package selects it:
// every pyramid level takes the level kernel's exact per-iteration exit
// (ops/tvl1_cuda.py). It stays the counterpart of the JAX package's blocked
// kernel, held against it, its plain version and the level kernel.
//
// Design: the persistent level grid of tvl1_grid.cuh, which the level kernel
// (tvl1_level.cu, whose notes describe it) runs with the exact exit, here
// with an exit period E = k (16 by default): one cooperative launch a level,
// two resident blocks of 512 threads a multiprocessor, chunks of at most 4
// iterations on 32 x 64 tiles with a halo of 4 (the window 1.4 times the
// tile, 103,680 B), the sweep's step loop ended on the card with a queue of
// the images that still have work, the gradient, the warp and the output in
// the same launch, the tile sums added in tile order (reruns bit-identical).
// A chunk never runs past the next multiple of k, so each test falls on a
// chunk's last iteration: nothing is speculated or replayed, the iterations
// computed are the iterations counted, and a k that is not a multiple of 4
// only cuts some chunks short (k = 5: 4, 1, 4, 1, ...). k = 1 is the exact
// exit and runs the level kernel's instantiation.
//
// What bounds it: as for the level kernel, the tile iteration on 1.4 times
// the tile's pixels (about 29 shared-memory accesses and 63 float operations
// per window pixel, two block-wide barriers an iteration: its instruction
// stream, tvl1_common.cuh), then the chunks' device-memory traffic, 19 B per
// pixel and iteration at chunks of 4. The arithmetic's float rate and device
// memory are far from it (PERF.md: bound against time).
//
// Tried: the design of the first port, one launch per chunk of k
// iterations on 32 x 64 tiles with a halo of k (a window of 221,184 B at
// k = 16, one block of 1,024 threads a multiprocessor), the exit decided in
// every block of the launch from the tile sums of the chunk before: 9
// kernels and 2 memsets a call at 2 x 32 iterations, 4.20 ms at
// (4, 512, 1024) against this design's 3.02 on the same inputs (PERF.md).

#include "tvl1_grid.cuh"

namespace {

constexpr int MAX_K = 16;  // the JAX package's _BLOCKED_K

}  // namespace

extern "C" {

int tvl1_blocked_max_k() { return MAX_K; }

// Enqueue one level solve on `stream`: three memsets (tables, iters, work)
// and one cooperative kernel launch, the exit tested after every k-th
// iteration of a sweep (1 <= k <= 16). All pointers are device memory:
//   i0, i1, u1_in, u2_in : (n, h, w) float32, read only
//   u1_out, u2_out       : (n, h, w) float32
//   iters                : (n) int32, on return the iterations each image ran
//   work                 : (2, n) int32, on return the iterations computed
//                          for each image (equal to iters for k > 1) and
//                          the chunks that ran
//   scratch              : tvl1_level_scratch_floats(n, h, w) floats
//   err                  : tvl1_level_err_floats(n, h, w) floats
//   tables               : tvl1_level_table_ints(n, warps, iterations, k)
//                          int32; on return entry 4 * n is the number of
//                          grid steps the call took, entry 4 * n + 1 the
//                          blocks of its grid
// thresh < 0 disables the exit. Does not synchronise. Returns 0 or the first
// CUDA error code.
int tvl1_blocked_level_solve(const float* i0, const float* i1,
                             const float* u1_in, const float* u2_in,
                             float* u1_out, float* u2_out, int* iters,
                             int* work, float* scratch, float* err,
                             int* tables, int n, int h, int w, int warps,
                             int iterations, int k, float l_t, float theta,
                             float taut, float thresh, void* stream_ptr) {
  if (k < 1 || k > MAX_K) return (int)cudaErrorInvalidValue;
  const LevelArgs args{i0,    i1,    u1_in,   u2_in, u1_out, u2_out,
                       iters, work,  scratch, err,   tables, n,
                       h,     w,     warps,   iterations,    k,
                       l_t,   theta, taut,    thresh};
  return k == 1 ? level_solve<true>(args, stream_ptr)
                : level_solve<false>(args, stream_ptr);
}

}  // extern "C"
