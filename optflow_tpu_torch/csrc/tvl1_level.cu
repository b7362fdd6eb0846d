// TV-L1 level solve for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the TPU's fused level kernel: optflow_tpu/ops/tvl1_pallas.py,
// `_make_fused_kernel`, launched by `_run_fused` from `_fused_level_fn`.
// Like that kernel, one call solves a whole pyramid level for a batch of
// images: centered gradient of i1; `warps` sweeps, each a backward warp of
// (i1, i1x, i1y) by the flow followed by up to `iterations` primal-dual
// updates, each image stopping at the first iteration whose own sum of
// |du|^2 is <= thresh; the dual state is zero at level entry and kept across
// the sweeps. It returns the flow and the number of iterations each image
// ran.
//
// What differs on this card, and what the design does about it
// ------------------------------------------------------------
// The TPU kernel keeps every array of a level resident in on-chip memory
// for the whole solve. A thread block has 227 KB of shared memory, so the
// level is cut into tiles of up to 32 x 64 pixels; a block loads its tile
// with a halo of 4 pixels (nine planes: the state u1, u2, p11, p12, p21, p22
// and the sweep's i1wx, i1wy, rho_c; 40 x 72 x 36 B = 103,680 B), runs a
// chunk of m <= 4 iterations on the window in shared memory and writes the
// tile to the other state buffer. One iteration reads p to the left and
// above and the new u to the right and below, so the window's edge goes
// wrong one pixel an iteration and never reaches the tile: the tile is exact
// at EVERY one of the m iterations. Device memory is visited once per chunk,
// not once per iteration.
//
// * One launch a level. The whole solve of a level is one cooperative
//   kernel: as many blocks of 512 threads as the card holds at once (two a
//   multiprocessor: one's loads and stores overlap the other's iterations),
//   each walking over rows of pixels (state set-up, gradient, the sweep's
//   warp, output) or over (image, tile) items (a chunk) with the grid's
//   stride, and meeting the others at grid-wide barriers. A sweep is a loop
//   of steps on the card: the tiles' chunk, a barrier, one block per image
//   that reads the chunk's errors and enters the image's next step, a
//   barrier. The loop ends when no image has anything left to do, so the
//   sweep's loop really ends on the card: nothing is enqueued for iterations
//   that no image runs, and the host pays one launch a level.
// * The exit stays per iteration, by speculation and replay. A block writes
//   its tile's sum of |du|^2 after each iteration j of a chunk:
//   err[n][j][tile]. After the barrier the image's block adds the tiles in
//   tile order, for every j, and looks for the first j* whose sum is
//   <= thresh. None: the image goes on. j* the chunk's last iteration: the
//   image stops. j* earlier: the chunk ran past the exit; its INPUT buffer
//   is still intact (ping-pong), so in the next step the image runs that
//   chunk again from it with m = j* + 1 and stops; its count is corrected to
//   j* + 1. The result is the per-iteration exit's, at the cost of at most
//   one chunk run twice per image and sweep. No float atomics: a rerun gives
//   the same bits and the same counts.
// * Tables instead of an order between blocks: per image the buffer that
//   holds its state and what it does in the next step (run the step's chunk,
//   replay r iterations, nothing), and per step a queue of the images with
//   something to do, so that a step's items are exactly the tiles that run
//   and spread evenly over the blocks however few images are left. A step's
//   tables are written only between its two barriers, by the image's one
//   block, and read only after the second. The loads of anything another
//   block wrote earlier in the launch bypass the first-level cache (__ldcg).
// * Short chunks first. At the fine levels an image runs a few iterations a
//   sweep, so long chunks would multiply the work where the pixels are:
//   LEVEL_SCHEDULE below (its last entry repeats). The halo of 4 leaves the
//   window at 1.4 times the tile's pixels; 8 would make it 1.9 and 16 3.0.
// * Tiles of even height. A level of h rows is cut into ceil(h / 32) rows of
//   tiles of equal height, not into 32s and a sliver whose window would
//   cost as much as a whole tile's.
// * The warp is the exact 2x2 gather with Catmull-Rom hat weights, once per
//   sweep: no bound on |u|. Divisions are exact (no fast-math flags); nvcc
//   contracts a*b+c to FMA, so results differ from the plain PyTorch version
//   in the last bits, and equal the blocked kernel's bit for bit.
//
// What bounds it
// --------------
// Per chunk of 4 a tile of 2,048 pixels loads 9 x 40 x 72 floats and stores
// 6 x 2,048: 19 B per pixel and iteration against 60 B for one launch per
// iteration (39 B for a chunk of 2). At the finest levels of a strip solve,
// where a sweep is 6 to 15 iterations, that traffic is about a third of the
// level's time (chip_smoke.py's `levels` line: design_traffic_ms). The rest
// is the iteration itself on 1.4 times the tile's pixels: about 29 four-byte
// shared-memory accesses and 63 float operations per window pixel, two
// block-wide barriers an iteration. The instruction stream of the window
// walk, not device memory and not the arithmetic's float rate, is the limit
// (the ablation kernel's table says which part of it); it is shared with the
// blocked and the chunk kernel (tvl1_common.cuh). The speculation adds the
// iterations a chunk runs past an exit and the replay: 3 to 25 % of the
// iterations counted, most at the fine levels. At the coarsest levels a
// step has less than one tile per block and costs its two barriers and the
// latency of one chunk.
//
// Tried on an NVIDIA H100 80GB HBM3 (700 W limit) with chip_smoke.py's
// `kernels`, `solve` and `job` phases; the numbers are in PERF.md:
// * One launch per chunk (the kernel above as a grid of one block per tile,
//   a table slot per launch parity, the launch after a chunk deciding
//   redundantly in every block), with a schedule growing to chunks of 16 on
//   halos of 2, 4, 8 and 16: right, and 85 ms for the 32-image strip solve
//   against 127 before. Chunks of at most 4 took it to 73 ms on the card,
//   but at ~3,900 launches a solve the host's enqueue (13 us a launch)
//   became the limit of the job. Chunks of 8 and 16 pay for their halo: the
//   window is 1.9 and 3.0 times the tile, and one block fits a
//   multiprocessor.
// * In this kernel, the block that finished an image's last tile deciding
//   (a ticket per tile, fences) and every block walking over all images'
//   tiles: one barrier a step less, but three trips to the second-level
//   cache per item and idle blocks once few images are left. With the queue
//   and the second barrier the strip solve went from 74.8 to 69.9 ms.
// * A schedule of plain 4s: 69.1 ms against 69.9 for 2, 2, 4 on the strip
//   solve, 23 % more iterations computed at the finest level; kept 2, 2, 4.
//
// The grid itself (tables, steps, the kernel and its launch) is in
// tvl1_grid.cuh, shared with the blocked and the chunk kernel, which run it
// with an exit every k and every 8 iterations; this library runs it with the
// exact exit.

#include "tvl1_grid.cuh"

extern "C" {

// Enqueue one level solve on `stream`: three memsets (tables, iters, work)
// and one cooperative kernel launch. All pointers are device memory:
//   i0, i1, u1_in, u2_in : (n, h, w) float32, read only
//   u1_out, u2_out       : (n, h, w) float32
//   iters                : (n) int32, on return the iterations each image ran
//   work                 : (2, n) int32, on return what was computed for
//                          each image, chunks run past an exit and replays
//                          included: iterations, and chunks that ran
//   scratch              : tvl1_level_scratch_floats(n, h, w) floats
//   err                  : tvl1_level_err_floats(n, h, w) floats
//   tables               : tvl1_level_table_ints(n, warps, iterations, 1)
//                          int32; on return entry 4 * n is the number of
//                          grid steps the call took, entry 4 * n + 1 the
//                          blocks of its grid
// thresh < 0 disables the exit. Does not synchronise. Returns 0 or the first
// CUDA error code.
int tvl1_level_solve(const float* i0, const float* i1, const float* u1_in,
                     const float* u2_in, float* u1_out, float* u2_out,
                     int* iters, int* work, float* scratch, float* err,
                     int* tables, int n, int h, int w, int warps,
                     int iterations, float l_t, float theta, float taut,
                     float thresh, void* stream_ptr) {
  const LevelArgs args{i0,     i1,    u1_in,   u2_in, u1_out, u2_out,
                       iters,  work,  scratch, err,   tables, n,
                       h,      w,     warps,   iterations,    1,
                       l_t,    theta, taut,    thresh};
  return level_solve<true>(args, stream_ptr);
}

}  // extern "C"
