// The persistent level grid (sm_90a): one cooperative launch solves a whole
// pyramid level for a batch of images. Included by tvl1_level.cu (the exact
// per-iteration exit), tvl1_blocked.cu (an exit every k iterations) and
// tvl1_chunk.cu (an exit every 8, or the exact one for a level that fits one
// block); each of those is its own library. The design notes are in
// tvl1_level.cu; what differs between the three is the exit period E:
//
// * E = 1, the exact exit. A chunk keeps every iteration's sum; the step
//   after it finds the image's first iteration whose sum is <= thresh and,
//   where that was not the chunk's last, runs the chunk once more from its
//   input up to it (speculation and replay). Chunks follow LEVEL_SCHEDULE.
// * E > 1: the criterion is tested only after iterations j of a sweep with
//   (j + 1) % E == 0, on that iteration's sum over the tiles, in tile order
//   (ops/tvl1.py `level_solve_plain(exit_every=E)`). A chunk is at most the
//   halo and never runs past the next multiple of E, so every test falls on
//   a chunk's last iteration: nothing is speculated or replayed, a chunk
//   keeps only its last iteration's sum, and only where it is tested.
//
// The kernel is compiled for the two cases (template parameter EXACT); the
// period of the second is an argument, a per-step scalar that costs nothing
// in the pixel loops, so one instantiation serves every E > 1.

#pragma once

#include <cooperative_groups.h>

#include "tvl1_common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int TILE_H = 32;  // the most rows of a tile
constexpr int TILE_W = 64;
constexpr int HALO = 4;  // halo = most iterations of a chunk
constexpr int WIN_W = TILE_W + 2 * HALO;
constexpr int LEVEL_THREADS = 512;
// Iterations per chunk with the exact exit, in order within a sweep; the
// last entry repeats. Each is at most HALO.
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

// Iterations of chunk c of a sweep of `iterations` that has run `done`: the
// schedule's entry with the exact exit (every = 1); else the halo, cut at the
// next multiple of `every`. Never past the sweep's end.
__host__ __device__ inline int chunk_m(int c, int done, int iterations,
                                       int every) {
  const int left = iterations - done;
  const int to_test = every - done % every;
  const int m = every == 1 ? schedule_m(c) : to_test < HALO ? to_test : HALO;
  return m < left ? m : left;
}

// What an image does in the next step of its sweep.
constexpr int STOPPED = 0;       // nothing: it met its exit, or ran out
constexpr int RUN = 1 << 8;      // the step's chunk
// 1 .. HALO - 1: run the last chunk again from its input, that many iterations
// (exact exit only)

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

// Steps one sweep can take at most: its chunks, and with the exact exit one
// more that settles the last chunk's exit.
inline int sweep_steps(int iterations, int every) {
  int c = 0;
  for (int done = 0; done < iterations; ++c)
    done += chunk_m(c, done, iterations, every);
  return every == 1 ? c + 1 : c;
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
  int every;  // the exit period E
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
// chunk planned for this step (0: only replays are left); `tested` (E > 1)
// whether the step's last iteration is tested.
template <bool EXACT>
__device__ __forceinline__ void level_item(const LevelArgs& a,
                                           const Tables& tab, float* state,
                                           const float* warped, float* smem,
                                           float* warp_part, float* sums,
                                           int n, int tile, int tiles,
                                           int tiles_x, int tile_h, int m,
                                           bool tested) {
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
  if (EXACT && plan.summed) {
    window_iterate_sums<WIN_W>(win, plan.run_m, a.l_t, a.theta, a.taut, iy0,
                               iy1, ix0, ix1, warp_part, sums);
    float* errs = a.err + (size_t)n * HALO * tiles;  // [j][tile]
    if ((int)threadIdx.x < plan.run_m)
      errs[threadIdx.x * tiles + tile] = sums[threadIdx.x];
  } else if (!EXACT && tested) {
    // only the last iteration's sum: the others run without one
    window_iterate<WIN_W, false>(win, plan.run_m - 1, a.l_t, a.theta, a.taut,
                                 iy0, iy1, ix0, ix1);
    const float e =
        window_iterate<WIN_W>(win, 1, a.l_t, a.theta, a.taut, iy0, iy1, ix0,
                              ix1);
    if (threadIdx.x == 0) a.err[(size_t)n * tiles + tile] = e;
  } else {
    // no exit to find: a replay stops whatever it sums to, thresh < 0 never
    window_iterate<WIN_W, false>(win, plan.run_m, a.l_t, a.theta, a.taut, iy0,
                                 iy1, ix0, ix1);
  }
  window_store<WIN_W>(win, state + image_off(plan.src ^ 1, n, N, hw), iy0,
                      iy1, ix0, ix1);
}

// The sum over the tiles, in tile order, of row j of image n's errors
// ([j][tile]) into sums[j]: warp j takes row j, for j < rows.
__device__ __forceinline__ void tile_order_sums(const float* errs, int tiles,
                                                int rows, float* sums) {
  const int lane = threadIdx.x & 31, j = threadIdx.x >> 5;
  if (j < rows) {
    float part = 0.0f;
    for (int i = lane; i < tiles; i += 32) part += __ldcg(errs + j * tiles + i);
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
      part += __shfl_down_sync(0xffffffffu, part, s);
    if (lane == 0) sums[j] = part;
  }
  __syncthreads();
}

// After a step and a grid-wide barrier: what image n does in the next step.
// One block per image. `m_prev` is the chunk of the step before this one,
// `done` the sweep's iterations before it, `t` its entry in live[].
template <bool EXACT>
__device__ __forceinline__ void level_decide(const LevelArgs& a,
                                             const Tables& tab, float* sums,
                                             int n, int tiles, int m,
                                             int m_prev, int done, int t,
                                             bool tested) {
  const int N = a.n;
  const Plan plan = plan_of(a, tab, n, m);
  int next = STOPPED;
  if (EXACT && !plan.replay) {
    int exit_at = -1;
    if (plan.summed) {
      tile_order_sums(a.err + (size_t)n * HALO * tiles, tiles, plan.run_m,
                      sums);
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
  } else if (!EXACT) {
    bool met = false;
    if (tested) {
      tile_order_sums(a.err + (size_t)n * tiles, tiles, 1, sums);
      met = !(sums[0] > a.thresh);  // NaN stops too
    }
    next = !met && done + m < a.iterations ? RUN : STOPPED;
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
template <bool EXACT>
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
      const int m = chunk_m(c, done, a.iterations, EXACT ? 1 : a.every);
      // E > 1: the test after this chunk, unless the sweep ends with it
      const bool tested = !EXACT && a.thresh >= 0.0f &&
                          (done + m) % a.every == 0 && done + m < a.iterations;
      const int* queue = tab.queue + (t & 1) * N;
      const long long items = (long long)live * tiles;
      for (long long item = blockIdx.x; item < items; item += gridDim.x) {
        const int q = (int)(item / tiles);
        level_item<EXACT>(a, tab, state, warped, smem, warp_part, sums,
                          __ldcg(queue + q),
                          (int)(item - (long long)q * tiles), tiles, tiles_x,
                          tile_h, m, tested);
        __syncthreads();  // the next item reuses the shared arrays
      }
      grid.sync();
      // every tile of the step is written: one block per image reads the
      // step's errors and enters the image's next step
      for (int q = blockIdx.x; q < live; q += gridDim.x) {
        level_decide<EXACT>(a, tab, sums, __ldcg(queue + q), tiles, m, m_prev,
                            done, t, tested);
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

inline long long level_table_ints(int n, int warps, int iterations,
                                  int every) {
  return 4LL * n + 2 +
         (long long)(warps > 0 ? warps : 0) *
             (sweep_steps(iterations > 0 ? iterations : 0, every) + 1) +
         1;
}

// Enqueue one level solve with the exit of period a.every (1: the exact
// exit, and EXACT must be true): three memsets (tables, iters, work) and one
// cooperative launch. Returns 0 or the first CUDA error code; a grid the card
// cannot hold resident is refused by the launch, with its error.
template <bool EXACT>
int level_solve(const LevelArgs& a, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (a.n <= 0 || a.n > 65535 || a.h < 2 || a.w < 2 || a.warps < 0 ||
      a.iterations < 0 || a.every < 1 || EXACT != (a.every == 1))
    return (int)cudaErrorInvalidValue;
  CHECK_MEMOP(cudaMemsetAsync(
      a.tables, 0,
      level_table_ints(a.n, a.warps, a.iterations, a.every) * sizeof(int),
      stream));
  CHECK_MEMOP(cudaMemsetAsync(a.iters, 0, (size_t)a.n * sizeof(int), stream));
  CHECK_MEMOP(
      cudaMemsetAsync(a.work, 0, 2 * (size_t)a.n * sizeof(int), stream));

  const size_t bytes = (size_t)WINDOW_PLANES * (tile_height(a.h) + 2 * HALO) *
                       WIN_W * sizeof(float);
  std::lock_guard<std::mutex> lock(g_smem_attr_mutex);
  CHECK_CALL(cudaFuncSetAttribute(level_kernel<EXACT>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)bytes));
  // a cooperative grid must be resident at once: as many blocks as the card
  // holds of this kernel, and no more than there is work for
  int device = 0, sms = 0, per_sm = 0;
  CHECK_CALL(cudaGetDevice(&device));
  CHECK_CALL(
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device));
  CHECK_CALL(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, level_kernel<EXACT>, LEVEL_THREADS, bytes));
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  const long long items = (long long)a.n * tile_rows(a.h) * tile_cols(a.w);
  const long long resident = (long long)sms * per_sm;
  const unsigned blocks = (unsigned)(items < resident ? items : resident);

  LevelArgs args = a;
  void* params[] = {&args};
  CHECK_LAUNCH_CALL(cudaLaunchCooperativeKernel(
      (const void*)level_kernel<EXACT>, dim3(blocks), dim3(LEVEL_THREADS),
      params, bytes, stream));
  return 0;
}

}  // namespace

// Sizes of one call's buffers, the same in every library that includes this
// header.
extern "C" {

// The constants the wrappers' plain emulation mirrors.
int tvl1_level_schedule_len() { return SCHEDULE_LEN; }
int tvl1_level_schedule(int c) { return schedule_m(c); }
int tvl1_level_tile_h() { return TILE_H; }
int tvl1_level_tile_w() { return TILE_W; }
int tvl1_level_halo() { return HALO; }

// Floats of scratch a level of n images of h x w needs: 2 x 6 state planes,
// gx, gy, and the 3 warped planes.
long long tvl1_level_scratch_floats(int n, int h, int w) {
  return 17LL * n * h * w;
}

// Floats of the error table: one sum per image, iteration of a chunk and
// tile.
long long tvl1_level_err_floats(int n, int h, int w) {
  return (long long)n * HALO * tile_rows(h) * tile_cols(w);
}

// int32 entries of the tables (see `Tables`) for an exit period `every`.
long long tvl1_level_table_ints(int n, int warps, int iterations, int every) {
  return level_table_ints(n, warps, iterations, every < 1 ? 1 : every);
}

const char* tvl1_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
