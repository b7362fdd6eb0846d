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
//   in the last bits, and equal the blocked kernel's and the replaced
//   per-iteration kernel's bit for bit.
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
// The kernel this design replaces (one launch per iteration, state in device
// memory) stays at the end of this file as a second entry point,
// tvl1_level_solve_per_iteration, so that both can be timed in one process
// and compared bit for bit. No path of the package selects it.

#include <cooperative_groups.h>

#include "tvl1_common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int TILE_H = 32;  // the most rows of a tile
constexpr int TILE_W = 64;
constexpr int HALO = 4;  // halo = most iterations of a chunk
constexpr int WIN_W = TILE_W + 2 * HALO;
constexpr int LEVEL_THREADS = 512;
// Iterations per chunk, in order within a sweep; the last entry repeats.
// Each is at most HALO.
#define LEVEL_SCHEDULE {2, 2, 4}
constexpr int SCHEDULE[] = LEVEL_SCHEDULE;
constexpr int SCHEDULE_LEN = sizeof(SCHEDULE) / sizeof(SCHEDULE[0]);
constexpr bool schedule_fits_halo() {
  for (int m : SCHEDULE)
    if (m < 1 || m > HALO) return false;
  return true;
}
static_assert(schedule_fits_halo() && HALO <= MAX_SUMS,
              "a chunk may not reach past the halo");

__constant__ int DEVICE_SCHEDULE[] = LEVEL_SCHEDULE;

__host__ __device__ inline int schedule_m(int c) {
  c = c < SCHEDULE_LEN ? c : SCHEDULE_LEN - 1;
#ifdef __CUDA_ARCH__
  return DEVICE_SCHEDULE[c];
#else
  return SCHEDULE[c];
#endif
}

// What an image does in the next step of its sweep.
constexpr int STOPPED = 0;       // nothing: it met its exit, or ran out
constexpr int RUN = 1 << 8;      // the step's chunk
// 1 .. HALO - 1: run the last chunk again from its input, that many iterations

// The tables of one call, all int32, zero at the start:
//   cur[n]      buffer that holds image n's state
//   action[n]   what image n does in the next step
//   queue[2][n] the images that have something to do in step t, in slot
//               t & 1, in the order they were entered (any order: it only
//               says which block takes which tile)
//   steps       grid steps the call has run (telemetry)
//   grid        blocks of the launch (telemetry)
//   live[t]     how many images queue[t & 1] holds for step t
struct Tables {
  int* cur;
  int* action;
  int* queue;
  int* steps;
  int* grid;
  int* live;
};

__device__ __forceinline__ Tables tables_at(int* base, int n) {
  return {base,         base + n,         base + 2 * n,
          base + 4 * n, base + 4 * n + 1, base + 4 * n + 2};
}

// Steps one sweep can take at most: its chunks and one more that settles the
// last chunk's exit.
inline int sweep_steps(int iterations) {
  int c = 0;
  for (int left = iterations; left > 0; ++c)
    left -= schedule_m(c) < left ? schedule_m(c) : left;
  return c + 1;
}

__host__ __device__ inline int tile_rows(int h) {
  return (h + TILE_H - 1) / TILE_H;
}
__host__ __device__ inline int tile_cols(int w) {
  return (w + TILE_W - 1) / TILE_W;
}
// Rows of a tile: a level is cut into tile_rows(h) rows of tiles of equal
// height.
__host__ __device__ inline int tile_height(int h) {
  return (h + tile_rows(h) - 1) / tile_rows(h);
}

// The six state planes of image n in buffer `buf`: state[buf][n][c][h][w].
__device__ __forceinline__ size_t image_off(int buf, int n, int N, size_t hw) {
  return ((size_t)buf * N + n) * 6 * hw;
}

// One call's arguments, passed to the kernel by value.
struct LevelArgs {
  const float* i0;
  const float* i1;
  const float* u1_in;
  const float* u2_in;
  float* u1_out;
  float* u2_out;
  int* iters;
  int* work;
  float* scratch;
  float* err;
  int* tables;
  int n, h, w, warps, iterations;
  float l_t, theta, taut, thresh;
};

// What image n does in a step: from the tables, the same in every block.
struct Plan {
  int src;      // buffer the step reads; it writes the other
  int run_m;    // iterations it runs
  bool replay;  // the last chunk again from its input, up to its exit
  bool summed;  // every iteration's error is kept
};

__device__ __forceinline__ Plan plan_of(const LevelArgs& a, const Tables& tab,
                                        int n, int m) {
  const int action = __ldcg(tab.action + n);
  const int cur = __ldcg(tab.cur + n);
  const bool replay = action != RUN;
  // a replay starts from the input of the chunk that ran past the exit
  return {replay ? cur ^ 1 : cur, replay ? action : m, replay,
          !replay && a.thresh >= 0.0f};
}

// One step of a sweep for one (image, tile) item: the tile's window through
// plan.run_m iterations, from one state buffer to the other. `m` is the
// chunk planned for this step (0: only replays are left).
__device__ __forceinline__ void level_item(const LevelArgs& a,
                                           const Tables& tab, float* state,
                                           const float* warped, float* smem,
                                           float* warp_part, float* sums,
                                           int n, int tile, int tiles,
                                           int tiles_x, int tile_h, int m) {
  const int N = a.n, h = a.h, w = a.w;
  const size_t hw = (size_t)h * w;
  const Plan plan = plan_of(a, tab, n, m);
  const int ty = tile / tiles_x, tx = tile - ty * tiles_x;
  const int iy0 = ty * tile_h, ix0 = tx * TILE_W;
  const int iy1 = min(iy0 + tile_h, h), ix1 = min(ix0 + TILE_W, w);
  Window win{smem, tile_h + 2 * HALO, WIN_W, iy0 - HALO, ix0 - HALO, h, w};
  // other blocks wrote these planes earlier in the launch
  window_load<WIN_W, true>(win, state + image_off(plan.src, n, N, hw),
                           warped + (size_t)n * 3 * hw);
  __syncthreads();
  if (plan.summed) {
    window_iterate_sums<WIN_W>(win, plan.run_m, a.l_t, a.theta, a.taut, iy0,
                               iy1, ix0, ix1, warp_part, sums);
    float* errs = a.err + (size_t)n * HALO * tiles;  // [j][tile]
    if ((int)threadIdx.x < plan.run_m)
      errs[threadIdx.x * tiles + tile] = sums[threadIdx.x];
  } else {
    // no exit to find: a replay stops whatever it sums to, thresh < 0 never
    window_iterate<WIN_W, false>(win, plan.run_m, a.l_t, a.theta, a.taut, iy0,
                                 iy1, ix0, ix1);
  }
  window_store<WIN_W>(win, state + image_off(plan.src ^ 1, n, N, hw), iy0,
                      iy1, ix0, ix1);
}

// After a step and a grid-wide barrier: what image n does in the next step.
// One block per image. `m_prev` is the chunk of the step before this one,
// `done` the sweep's iterations before it, `t` its entry in live[].
__device__ __forceinline__ void level_decide(const LevelArgs& a,
                                             const Tables& tab, float* sums,
                                             int n, int tiles, int m,
                                             int m_prev, int done, int t) {
  const int N = a.n;
  const Plan plan = plan_of(a, tab, n, m);
  int next = STOPPED;
  if (!plan.replay) {
    int exit_at = -1;
    if (plan.summed) {
      // every iteration's sum over the tiles, in tile order: warp j takes
      // iteration j
      const float* errs = a.err + (size_t)n * HALO * tiles;
      const int lane = threadIdx.x & 31, j = threadIdx.x >> 5;
      if (j < plan.run_m) {
        float part = 0.0f;
        for (int i = lane; i < tiles; i += 32)
          part += __ldcg(errs + j * tiles + i);
#pragma unroll
        for (int s = 16; s > 0; s >>= 1)
          part += __shfl_down_sync(0xffffffffu, part, s);
        if (lane == 0) sums[j] = part;
      }
      __syncthreads();
      // a NaN sum stops the image, as `err > thresh` fails for it
      for (int i = 0; i < plan.run_m; ++i)
        if (!(sums[i] > a.thresh)) {
          exit_at = i;
          break;
        }
    }
    if (exit_at >= 0)
      next = exit_at == plan.run_m - 1 ? STOPPED : exit_at + 1;
    else
      next = done + plan.run_m < a.iterations ? RUN : STOPPED;
  }
  if (threadIdx.x == 0) {
    tab.cur[n] = plan.src ^ 1;
    tab.action[n] = next;
    if (next != STOPPED)
      tab.queue[((t + 1) & 1) * N + atomicAdd(tab.live + t + 1, 1)] = n;
    // another multiprocessor may have added last: not through this one's
    // first-level cache
    atomicAdd(a.iters + n, plan.replay ? plan.run_m - m_prev : plan.run_m);
    atomicAdd(a.work + n, plan.run_m);
    atomicAdd(a.work + N + n, 1);
  }
}

// The whole level in one cooperative launch: every block is resident, walks
// over pixels or (image, tile) items with the grid's stride, and meets the
// others at grid-wide barriers.
__global__ void __launch_bounds__(LEVEL_THREADS, 2)
    level_kernel(const LevelArgs a) {
  extern __shared__ float smem[];
  __shared__ float warp_part[MAX_SUMS * 32];
  __shared__ float sums[MAX_SUMS];
  cg::grid_group grid = cg::this_grid();

  const int N = a.n, h = a.h, w = a.w;
  const size_t hw = (size_t)h * w;
  const size_t nhw = (size_t)N * hw;
  float* state = a.scratch;  // [2][n][6][h][w]
  float* gx = a.scratch + 12 * nhw;
  float* gy = gx + nhw;
  float* warped = gy + nhw;  // [n][3][h][w]
  const Tables tab = tables_at(a.tables, N);
  // the pixel phases: a block takes whole rows of the n * h rows of the
  // batch, its threads the row's pixels (no division per pixel)
  const int rows = N * h;

  // buffer 0 of every image <- (u1, u2, 0, 0, 0, 0); the gradient of i1
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const int n = row / h, y = row - n * h;
    float* st = state + (size_t)n * 6 * hw;
    const float* im = a.i1 + (size_t)n * hw;
    for (int x = threadIdx.x; x < w; x += blockDim.x) {
      const size_t o = (size_t)y * w + x;
      const size_t p = (size_t)n * hw + o;
      st[o] = a.u1_in[p];
      st[hw + o] = a.u2_in[p];
#pragma unroll
      for (int c = 2; c < 6; ++c) st[c * hw + o] = 0.0f;
      const float c0 = im[o];
      const float r = (x < w - 1) ? im[o + 1] : c0;
      const float l = (x > 0) ? im[o - 1] : c0;
      const float d = (y < h - 1) ? im[o + w] : c0;
      const float u = (y > 0) ? im[o - w] : c0;
      gx[p] = 0.5f * (r - l);
      gy[p] = 0.5f * (d - u);
    }
  }
  grid.sync();

  const int tiles_x = tile_cols(w);
  const int tile_h = tile_height(h);
  const int tiles = tiles_x * tile_rows(h);

  int t = 0;          // index of the step's entry in live[]
  int steps_run = 0;  // steps taken
  for (int s = 0; s < a.warps && a.iterations > 0; ++s) {
    // the sweep's warp by every image's current flow; every image runs the
    // sweep's first chunk
    for (int row = blockIdx.x; row < rows; row += gridDim.x) {
      const int n = row / h, y = row - n * h;
      const float* st = state + image_off(__ldcg(tab.cur + n), n, N, hw);
      float* out = warped + (size_t)n * 3 * hw;
      for (int x = threadIdx.x; x < w; x += blockDim.x) {
        const size_t o = (size_t)y * w + x;
        warp_pixel(a.i0 + n * hw, a.i1 + n * hw, gx + n * hw, gy + n * hw, h,
                   w, x, y, __ldcg(st + o), __ldcg(st + hw + o), out + o,
                   out + hw + o, out + 2 * hw + o);
      }
      if (y == 0 && threadIdx.x == 0) {
        tab.action[n] = RUN;
        tab.queue[(t & 1) * N + n] = n;
        if (n == 0) tab.live[t] = N;
      }
    }
    grid.sync();

    int done = 0, m_prev = 0;
    for (int c = 0;; ++c, ++t) {
      // the images with something to do in this step: every block reads the
      // same count, written before the barrier, and leaves the sweep at 0
      const int live = __ldcg(tab.live + t);
      if (live == 0) break;
      const int left = a.iterations - done;
      const int m = schedule_m(c) < left ? schedule_m(c) : left;
      const int* queue = tab.queue + (t & 1) * N;
      const long long items = (long long)live * tiles;
      for (long long item = blockIdx.x; item < items; item += gridDim.x) {
        const int q = (int)(item / tiles);
        level_item(a, tab, state, warped, smem, warp_part, sums,
                   __ldcg(queue + q), (int)(item - (long long)q * tiles),
                   tiles, tiles_x, tile_h, m);
        __syncthreads();  // the next item reuses the shared arrays
      }
      grid.sync();
      // every tile of the step is written: one block per image reads the
      // step's errors and enters the image's next step
      for (int q = blockIdx.x; q < live; q += gridDim.x) {
        level_decide(a, tab, sums, __ldcg(queue + q), tiles, m, m_prev, done,
                     t);
        __syncthreads();
      }
      done += m;
      m_prev = m;
      ++steps_run;
      grid.sync();
    }
    // the next sweep fills live[t] and its queue anew: not the entry a slow
    // block may still be reading to leave this one
    ++t;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *tab.steps = steps_run;
    *tab.grid = (int)gridDim.x;
  }

  // each image's flow out of whichever buffer holds its final state
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const int n = row / h, y = row - n * h;
    const float* st = state + image_off(__ldcg(tab.cur + n), n, N, hw);
    for (int x = threadIdx.x; x < w; x += blockDim.x) {
      const size_t o = (size_t)y * w + x;
      a.u1_out[(size_t)n * hw + o] = __ldcg(st + o);
      a.u2_out[(size_t)n * hw + o] = __ldcg(st + hw + o);
    }
  }
}

// ---------------------------------------------------------------------------
// The kernel this file's design replaces: one launch per primal-dual
// iteration on 32 x 8 tiles, the state in device memory (ping-pong), the
// per-image exit through a table err[n][it] that the launch of iteration
// `it` adds to with atomics and the next one reads. Kept for one round so
// that old and new can be timed in turns in one process and compared bit
// for bit; reached only through tvl1_level_solve_per_iteration.
// ---------------------------------------------------------------------------
namespace per_iteration {

constexpr int TX = 32;  // tile width  = blockDim.x
constexpr int TY = 8;   // tile height = blockDim.y

// State layout: state[(buf * 6 + c) * N + n][h][w], c = u1, u2, p11, p12,
// p21, p22; buf is the ping-pong half.
__device__ __forceinline__ size_t plane_off(int buf, int c, int n, int N,
                                            size_t hw) {
  return ((size_t)(buf * 6 + c) * N + n) * hw;
}

// Backward warp of (i1, i1x, i1y) by the image's current flow and the
// linearised residual: writes i1wx, i1wy and
// rho_c = i1w - i1wx*u1 - i1wy*u2 - i0.
__global__ void warp_kernel(const float* __restrict__ i0,
                            const float* __restrict__ i1,
                            const float* __restrict__ gx,
                            const float* __restrict__ gy,
                            const float* __restrict__ state,
                            const int* __restrict__ done,
                            float* __restrict__ wxo, float* __restrict__ wyo,
                            float* __restrict__ rho, int N, int h, int w) {
  int x = blockIdx.x * TX + threadIdx.x;
  int y = blockIdx.y * TY + threadIdx.y;
  if (x >= w || y >= h) return;
  int n = blockIdx.z;
  size_t hw = (size_t)h * w;
  int src = done[n] & 1;
  size_t o = (size_t)y * w + x;
  float u1 = state[plane_off(src, 0, n, N, hw) + o];
  float u2 = state[plane_off(src, 1, n, N, hw) + o];

  size_t g = n * hw + o;
  warp_pixel(i0 + n * hw, i1 + n * hw, gx + n * hw, gy + n * hw, h, w, x, y,
             u1, u2, wxo + g, wyo + g, rho + g);
}

// One primal-dual iteration of every image that has not met its exit.
// A fixed grid of blocks walks over the (image, tile) items, so a launch
// whose images have all stopped costs a few hundred blocks that each take
// one parallel look at the exit cells, not one empty block per tile.
__global__ void __launch_bounds__(TX* TY)
    iteration_kernel(float* __restrict__ state, const float* __restrict__ wxp,
                     const float* __restrict__ wyp,
                     const float* __restrict__ rhop, float* __restrict__ err,
                     const int* __restrict__ done, int it, int iterations,
                     int N, int h, int w, int tiles_x, int tiles_y, float l_t,
                     float theta, float taut, float thresh) {
  __shared__ float s1[TY + 1][TX + 1];
  __shared__ float s2[TY + 1][TX + 1];
  __shared__ float red[TX * TY / 32];

  const size_t hw = (size_t)h * w;
  const int tiles = tiles_x * tiles_y;
  const long long total = (long long)N * tiles;
  const int tid = threadIdx.y * TX + threadIdx.x;

  // Leave at once when no image is still iterating: every thread looks at
  // some images' exit cells, in parallel, and the block votes.
  if (it > 0) {
    int alive = 0;
    for (int n = tid; n < N; n += TX * TY)
      alive |= err[(size_t)n * iterations + it - 1] > thresh;
    if (!__syncthreads_or(alive)) return;
  }

  for (long long item = blockIdx.x; item < total; item += gridDim.x) {
    int n = (int)(item / tiles);
    int tile = (int)(item - (long long)n * tiles);
    // the whole block reads one value: the skip is uniform
    if (it > 0 && !(err[(size_t)n * iterations + it - 1] > thresh)) {
      // image n has stopped: go on with this block's first item of image
      // n + 1 (the loop's increment adds the last stride)
      long long next = (long long)(n + 1) * tiles;
      long long k = (next - blockIdx.x + gridDim.x - 1) / gridDim.x;
      item = blockIdx.x + (k - 1) * gridDim.x;
      continue;
    }

    int src = (done[n] + it) & 1;
    const float* u1 = state + plane_off(src, 0, n, N, hw);
    const float* u2 = state + plane_off(src, 1, n, N, hw);
    const float* p11 = state + plane_off(src, 2, n, N, hw);
    const float* p12 = state + plane_off(src, 3, n, N, hw);
    const float* p21 = state + plane_off(src, 4, n, N, hw);
    const float* p22 = state + plane_off(src, 5, n, N, hw);
    float* d_u1 = state + plane_off(src ^ 1, 0, n, N, hw);
    float* d_u2 = state + plane_off(src ^ 1, 1, n, N, hw);
    float* d_p11 = state + plane_off(src ^ 1, 2, n, N, hw);
    float* d_p12 = state + plane_off(src ^ 1, 3, n, N, hw);
    float* d_p21 = state + plane_off(src ^ 1, 4, n, N, hw);
    float* d_p22 = state + plane_off(src ^ 1, 5, n, N, hw);
    const float* i1wx = wxp + n * hw;
    const float* i1wy = wyp + n * hw;
    const float* rho_c = rhop + n * hw;

    int bx = (tile % tiles_x) * TX, by = (tile / tiles_x) * TY;
    float local = 0.0f;

    // primal update on the tile and its right/bottom apron
    for (int idx = tid; idx < (TX + 1) * (TY + 1); idx += TX * TY) {
      int ly = idx / (TX + 1), lx = idx - ly * (TX + 1);
      int x = bx + lx, y = by + ly;
      if (x >= w || y >= h) continue;
      size_t o = (size_t)y * w + x;
      float U1 = u1[o], U2 = u2[o];
      float d1, d2;
      threshold_step(i1wx[o], i1wy[o], rho_c[o], U1, U2, l_t, &d1, &d2);
      // backward-difference divergence: p itself at the first row/column
      float q11 = p11[o], q12 = p12[o], q21 = p21[o], q22 = p22[o];
      float div1 = (x > 0 ? q11 - p11[o - 1] : q11) +
                   (y > 0 ? q12 - p12[o - w] : q12);
      float div2 = (x > 0 ? q21 - p21[o - 1] : q21) +
                   (y > 0 ? q22 - p22[o - w] : q22);
      float n1 = (U1 + d1) + theta * div1;
      float n2 = (U2 + d2) + theta * div2;
      s1[ly][lx] = n1;
      s2[ly][lx] = n2;
      if (lx < TX && ly < TY) {
        d_u1[o] = n1;
        d_u2[o] = n2;
        float e1 = n1 - U1, e2 = n2 - U2;
        local += e1 * e1 + e2 * e2;
      }
    }
    __syncthreads();

    // dual update: forward differences of the new u, zero at the far border
    {
      int lx = threadIdx.x, ly = threadIdx.y;
      int x = bx + lx, y = by + ly;
      if (x < w && y < h) {
        size_t o = (size_t)y * w + x;
        float c1 = s1[ly][lx], c2 = s2[ly][lx];
        float u1x = (x < w - 1) ? s1[ly][lx + 1] - c1 : 0.0f;
        float u1y = (y < h - 1) ? s1[ly + 1][lx] - c1 : 0.0f;
        float u2x = (x < w - 1) ? s2[ly][lx + 1] - c2 : 0.0f;
        float u2y = (y < h - 1) ? s2[ly + 1][lx] - c2 : 0.0f;
        float ng1 = 1.0f + taut * sqrtf(u1x * u1x + u1y * u1y);
        float ng2 = 1.0f + taut * sqrtf(u2x * u2x + u2y * u2y);
        d_p11[o] = (p11[o] + taut * u1x) / ng1;
        d_p12[o] = (p12[o] + taut * u1y) / ng1;
        d_p21[o] = (p21[o] + taut * u2x) / ng2;
        d_p22[o] = (p22[o] + taut * u2y) / ng2;
      }
    }

    // sum of |du|^2 over the tile's real pixels -> err[n][it]
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
      local += __shfl_down_sync(0xffffffffu, local, s);
    if ((tid & 31) == 0) red[tid >> 5] = local;
    __syncthreads();
    if (tid < 32) {
      float v = (tid < TX * TY / 32) ? red[tid] : 0.0f;
#pragma unroll
      for (int s = 16; s > 0; s >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, s);
      if (tid == 0) atomicAdd(&err[(size_t)n * iterations + it], v);
    }
    __syncthreads();  // the next item reuses the shared arrays
  }  // items
}

// After a sweep: add the iterations image n ran to done[n] and clear its
// row of the error table for the next sweep. One block per image.
__global__ void sweep_end_kernel(float* __restrict__ err,
                                 int* __restrict__ done, int iterations,
                                 float thresh) {
  __shared__ int first;
  int n = blockIdx.x;
  if (threadIdx.x == 0) first = iterations;
  __syncthreads();
  float* row = err + (size_t)n * iterations;
  for (int it = threadIdx.x; it < iterations; it += blockDim.x) {
    if (!(row[it] > thresh)) atomicMin(&first, it);
    row[it] = 0.0f;
  }
  __syncthreads();
  if (threadIdx.x == 0)
    done[n] += (first < iterations) ? first + 1 : iterations;
}

// Copy each image's flow out of whichever buffer holds its final state.
__global__ void output_kernel(const float* __restrict__ state,
                              const int* __restrict__ done,
                              float* __restrict__ u1o, float* __restrict__ u2o,
                              int N, size_t hw) {
  int n = blockIdx.y;
  size_t o = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= hw) return;
  int src = done[n] & 1;
  u1o[n * hw + o] = state[plane_off(src, 0, n, N, hw) + o];
  u2o[n * hw + o] = state[plane_off(src, 1, n, N, hw) + o];
}

}  // namespace per_iteration

}  // namespace

extern "C" {

// The constants the wrapper's plain emulation mirrors.
int tvl1_level_schedule_len() { return SCHEDULE_LEN; }
int tvl1_level_schedule(int c) { return schedule_m(c); }
int tvl1_level_tile_h() { return TILE_H; }
int tvl1_level_tile_w() { return TILE_W; }
int tvl1_level_halo() { return HALO; }

// Number of floats of scratch a level of n images of h x w needs: 2 x 6
// state planes, gx, gy, and the 3 warped planes. Both entry points.
long long tvl1_level_scratch_floats(int n, int h, int w) {
  return 17LL * n * h * w;
}

// Floats of the error table: one sum per image, iteration of a chunk and
// tile.
long long tvl1_level_err_floats(int n, int h, int w) {
  return (long long)n * HALO * tile_rows(h) * tile_cols(w);
}

// int32 entries of the tables: see `Tables`.
long long tvl1_level_table_ints(int n, int warps, int iterations) {
  return 4LL * n + 2 + (long long)(warps > 0 ? warps : 0) *
                           (sweep_steps(iterations > 0 ? iterations : 0) + 1) + 1;
}

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
//   tables               : tvl1_level_table_ints(n, warps, iterations)
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
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (n <= 0 || n > 65535 || h < 2 || w < 2 || warps < 0 || iterations < 0)
    return (int)cudaErrorInvalidValue;
  CHECK_MEMOP(cudaMemsetAsync(
      tables, 0, tvl1_level_table_ints(n, warps, iterations) * sizeof(int),
      stream));
  CHECK_MEMOP(cudaMemsetAsync(iters, 0, (size_t)n * sizeof(int), stream));
  CHECK_MEMOP(cudaMemsetAsync(work, 0, 2 * (size_t)n * sizeof(int), stream));

  const size_t bytes = (size_t)WINDOW_PLANES * (tile_height(h) + 2 * HALO) *
                       WIN_W * sizeof(float);
  CHECK_CALL(cudaFuncSetAttribute(level_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)bytes));
  // a cooperative grid must be resident at once: as many blocks as the card
  // holds of this kernel, and no more than there is work for
  int device = 0, sms = 0, per_sm = 0;
  CHECK_CALL(cudaGetDevice(&device));
  CHECK_CALL(
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device));
  CHECK_CALL(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, level_kernel, LEVEL_THREADS, bytes));
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  const long long items = (long long)n * tile_rows(h) * tile_cols(w);
  const long long resident = (long long)sms * per_sm;
  const unsigned blocks = (unsigned)(items < resident ? items : resident);

  LevelArgs args{i0,    i1,   u1_in,   u2_in, u1_out, u2_out,     iters,
                 work,  scratch, err,  tables, n,     h,          w,
                 warps, iterations,    l_t,   theta,  taut,       thresh};
  void* params[] = {&args};
  CHECK_LAUNCH_CALL(cudaLaunchCooperativeKernel(
      (const void*)level_kernel, dim3(blocks), dim3(LEVEL_THREADS), params,
      bytes, stream));
  return 0;
}

// The replaced design, same function: see `namespace per_iteration`.
//   done : (n) int32, on return the iterations each image ran
//   err  : n * iterations floats
// The other arguments are tvl1_level_solve's.
int tvl1_level_solve_per_iteration(const float* i0, const float* i1,
                                   const float* u1_in, const float* u2_in,
                                   float* u1_out, float* u2_out, int* done,
                                   float* scratch, float* err, int n, int h,
                                   int w, int warps, int iterations,
                                   float l_t, float theta, float taut,
                                   float thresh, void* stream_ptr) {
  namespace pi = per_iteration;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (n <= 0 || n > 65535 || h < 2 || w < 2 || warps < 0 || iterations < 0)
    return (int)cudaErrorInvalidValue;
  size_t hw = (size_t)h * w;
  size_t nhw = (size_t)n * hw;
  float* state = scratch;
  float* gx = scratch + 12 * nhw;
  float* gy = gx + nhw;
  float* wxp = gy + nhw;
  float* wyp = wxp + nhw;
  float* rho = wyp + nhw;

  // buffer 0 <- (u1, u2, 0, 0, 0, 0); the tables start at zero
  CHECK_MEMOP(cudaMemcpyAsync(state, u1_in, nhw * sizeof(float),
                              cudaMemcpyDeviceToDevice, stream));
  CHECK_MEMOP(cudaMemcpyAsync(state + nhw, u2_in, nhw * sizeof(float),
                              cudaMemcpyDeviceToDevice, stream));
  CHECK_MEMOP(
      cudaMemsetAsync(state + 2 * nhw, 0, 4 * nhw * sizeof(float), stream));
  CHECK_MEMOP(cudaMemsetAsync(done, 0, (size_t)n * sizeof(int), stream));
  if (iterations > 0)
    CHECK_MEMOP(cudaMemsetAsync(
        err, 0, (size_t)n * iterations * sizeof(float), stream));

  dim3 block(pi::TX, pi::TY);
  dim3 grid((w + pi::TX - 1) / pi::TX, (h + pi::TY - 1) / pi::TY, n);
  gradient_kernel<<<grid, block, 0, stream>>>(i1, gx, gy, h, w);
  CHECK_LAUNCH();

  // the iteration kernel's grid: as many blocks as the card holds at once
  int device = 0, sms = 0, per_sm = 0;
  CHECK_CALL(cudaGetDevice(&device));
  CHECK_CALL(
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device));
  CHECK_CALL(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, pi::iteration_kernel, pi::TX * pi::TY, 0));
  long long items = (long long)n * grid.x * grid.y;
  long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  unsigned iter_blocks = (unsigned)(items < resident ? items : resident);

  for (int s = 0; s < warps; ++s) {
    pi::warp_kernel<<<grid, block, 0, stream>>>(i0, i1, gx, gy, state, done,
                                                wxp, wyp, rho, n, h, w);
    CHECK_LAUNCH();
    for (int it = 0; it < iterations; ++it) {
      pi::iteration_kernel<<<iter_blocks, block, 0, stream>>>(
          state, wxp, wyp, rho, err, done, it, iterations, n, h, w,
          (int)grid.x, (int)grid.y, l_t, theta, taut, thresh);
      CHECK_LAUNCH();
    }
    if (iterations > 0) {
      pi::sweep_end_kernel<<<n, 128, 0, stream>>>(err, done, iterations,
                                                  thresh);
      CHECK_LAUNCH();
    }
  }

  dim3 ogrid((unsigned)((hw + 255) / 256), n);
  pi::output_kernel<<<ogrid, 256, 0, stream>>>(state, done, u1_out, u2_out, n,
                                               hw);
  CHECK_LAUNCH();
  return 0;
}

const char* tvl1_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
