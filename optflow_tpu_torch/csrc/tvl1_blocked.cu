// Blocked TV-L1 level solve for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the TPU's blocked level kernel: optflow_tpu/ops/tvl1_pallas.py,
// `_make_blocked_kernel`, launched by `_run_blocked` from
// `_blocked_level_fn`. Like that kernel, one call solves a whole pyramid
// level for a batch of images (the gradient of i1, then `warps` sweeps, each
// an exact backward warp and up to `iterations` primal-dual iterations on
// tiles held in on-chip memory) with a per-image epsilon exit tested once
// every k iterations of a sweep, on that iteration's error, and returns the
// flow and the iterations each image ran. It is the kernel for the levels
// above the JAX package's fused budget.
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
// Tried: the design of the first port is kept, until ROADMAP.md deletes it,
// as the second entry point tvl1_blocked_level_solve_per_chunk (namespace
// per_chunk), reached only by chip_smoke.py and a test on the card, which
// time the two in turns and compare them bit for bit: one launch per chunk
// of k iterations on 32 x 64 tiles with a halo of k, the window at k = 16
// 64 x 96 x 36 B = 221,184 B (3.0 times the tile, one block of 1,024 threads
// a multiprocessor, nothing overlapping a tile's loads and stores), a
// per-image table cur[t & 1][n] of the buffer that holds the state, the exit
// decided in every block of the launch after a chunk from the tile sums of
// the one before, a stopped image's later launches left empty; 9 kernels and
// 2 memsets a call at 2 x 32 iterations, 4.18 ms at (4, 512, 1024) against
// the level kernel's 3.07 on the same inputs (PERF.md).

#include "tvl1_grid.cuh"

namespace {

constexpr int MAX_K = 16;  // the JAX package's _BLOCKED_K, the most the
                           // replaced design's window of (32 + 2k) x (64 + 2k)
                           // x 36 B fits in 227 KB

// ---------------------------------------------------------------------------
// The replaced design: one launch per chunk of k iterations, tiles with a
// halo of k. Reached only through tvl1_blocked_level_solve_per_chunk.
// ---------------------------------------------------------------------------
namespace per_chunk {

constexpr int TILE_H = 32;
constexpr int TILE_W = 64;

// The six state planes of image n in buffer `buf`:
// state[buf][n][c][h][w].
__device__ __forceinline__ size_t image_off(int buf, int n, int N, size_t hw) {
  return ((size_t)buf * N + n) * 6 * hw;
}

// Once per sweep: warp every pixel by the image's current flow and store
// (i1wx, i1wy, rho_c) to warped[n][3][h][w]. `cur` is the slot of the
// sweep's first chunk. 32 x 8 threads, grid (ceil(w/32), ceil(h/8), n).
__global__ void warp_kernel(const float* __restrict__ i0,
                            const float* __restrict__ i1,
                            const float* __restrict__ gx,
                            const float* __restrict__ gy,
                            const float* __restrict__ state,
                            const int* __restrict__ cur,
                            float* __restrict__ warped, int N, int h, int w) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  int n = blockIdx.z;
  size_t hw = (size_t)h * w;
  size_t o = (size_t)y * w + x;
  const float* st = state + image_off(cur[n], n, N, hw);
  float* out = warped + (size_t)n * 3 * hw;
  warp_pixel(i0 + n * hw, i1 + n * hw, gx + n * hw, gy + n * hw, h, w, x, y,
             st[o], st[hw + o], out + o, out + hw + o, out + 2 * hw + o);
}

// Chunk t = sweep * C + c_in of every image: m iterations on each tile.
// grid = (tiles, n), TILE_THREADS threads, (32 + 2k)(64 + 2k) x 36 B of
// dynamic shared memory. WIN_W is 64 + 2k, or 0 to take k at run time.
template <int WIN_W>
__global__ void __launch_bounds__(TILE_THREADS)
    blocked_chunk_kernel(float* __restrict__ state,
                         const float* __restrict__ warped,
                         float* __restrict__ err, int* __restrict__ cur,
                         int* __restrict__ iters, int t, int c_in, int T,
                         int N, int h, int w, int tiles_x, int k, int m,
                         float l_t, float theta, float taut, float thresh) {
  extern __shared__ float smem[];
  const int n = blockIdx.y;
  const int tile = blockIdx.x;
  const int tiles = gridDim.x;
  const size_t hw = (size_t)h * w;
  const int src = cur[(t & 1) * N + n];
  float* err_cell = err + ((size_t)n * T + t) * tiles + tile;

  bool run = true;
  if (c_in > 0 && thresh >= 0.0f) {
    const float* prev = err + ((size_t)n * T + t - 1) * tiles;
    float part = 0.0f;
    for (int i = threadIdx.x; i < tiles; i += blockDim.x) part += prev[i];
    run = block_sum(part) > thresh;
  }
  if (!run) {
    if (threadIdx.x == 0) {
      *err_cell = 0.0f;
      if (tile == 0) cur[((t + 1) & 1) * N + n] = src;
    }
    return;
  }

  const int ty = tile / tiles_x, tx = tile - ty * tiles_x;
  const int iy0 = ty * TILE_H, ix0 = tx * TILE_W;
  const int iy1 = min(iy0 + TILE_H, h), ix1 = min(ix0 + TILE_W, w);
  Window win{smem, TILE_H + 2 * k, TILE_W + 2 * k, iy0 - k, ix0 - k, h, w};
  window_load<WIN_W>(win, state + image_off(src, n, N, hw),
                     warped + (size_t)n * 3 * hw);
  __syncthreads();
  float e = window_iterate<WIN_W>(win, m, l_t, theta, taut, iy0, iy1, ix0,
                                  ix1);
  window_store<WIN_W>(win, state + image_off(src ^ 1, n, N, hw), iy0, iy1,
                      ix0, ix1);
  if (threadIdx.x == 0) {
    *err_cell = e;
    if (tile == 0) {
      cur[((t + 1) & 1) * N + n] = src ^ 1;
      iters[n] += m;
    }
  }
}

// Copy each image's flow out of whichever buffer holds its final state.
__global__ void output_kernel(const float* __restrict__ state,
                              const int* __restrict__ cur,
                              float* __restrict__ u1o, float* __restrict__ u2o,
                              int N, size_t hw) {
  int n = blockIdx.y;
  size_t o = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= hw) return;
  const float* st = state + image_off(cur[n], n, N, hw);
  u1o[n * hw + o] = st[o];
  u2o[n * hw + o] = st[hw + o];
}

// Buffer 0 of every image <- (u1, u2, 0, 0, 0, 0).
__global__ void init_state_kernel(const float* __restrict__ u1,
                                  const float* __restrict__ u2,
                                  float* __restrict__ state, size_t hw) {
  int n = blockIdx.y;
  size_t o = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= hw) return;
  float* st = state + (size_t)n * 6 * hw;
  st[o] = u1[n * hw + o];
  st[hw + o] = u2[n * hw + o];
#pragma unroll
  for (int c = 2; c < 6; ++c) st[c * hw + o] = 0.0f;
}

using ChunkKernel = void (*)(float*, const float*, float*, int*, int*, int,
                             int, int, int, int, int, int, int, int, float,
                             float, float, float);

}  // namespace per_chunk

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

// Floats of the replaced design's error table: one per image, chunk and
// tile.
long long tvl1_blocked_per_chunk_err_floats(int n, int h, int w, int warps,
                                            int iterations, int k) {
  long long tiles = (long long)((w + per_chunk::TILE_W - 1) /
                                per_chunk::TILE_W) *
                    ((h + per_chunk::TILE_H - 1) / per_chunk::TILE_H);
  long long chunks = (long long)warps * ((iterations + k - 1) / k);
  return (long long)n * (chunks > 0 ? chunks : 1) * tiles;
}

// The replaced design, same function: see `namespace per_chunk`. All
// pointers are device memory:
//   i0, i1, u1_in, u2_in : (n, h, w) float32, read only
//   u1_out, u2_out       : (n, h, w) float32
//   iters                : (n) int32, on return the iterations each image ran
//   scratch              : tvl1_level_scratch_floats(n, h, w) floats
//   err                  : tvl1_blocked_per_chunk_err_floats(...) floats
//   cur                  : 2 * n int32
// Does not synchronise. Returns 0 or the first CUDA error code.
int tvl1_blocked_level_solve_per_chunk(
    const float* i0, const float* i1, const float* u1_in, const float* u2_in,
    float* u1_out, float* u2_out, int* iters, float* scratch, float* err,
    int* cur, int n, int h, int w, int warps, int iterations, int k,
    float l_t, float theta, float taut, float thresh, void* stream_ptr) {
  namespace pc = per_chunk;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (n <= 0 || n > 65535 || h < 2 || w < 2 || warps < 0 || iterations < 0 ||
      k < 1 || k > MAX_K)
    return (int)cudaErrorInvalidValue;
  const size_t hw = (size_t)h * w;
  const size_t nhw = (size_t)n * hw;
  float* state = scratch;  // [2][n][6][h][w]
  float* gx = scratch + 12 * nhw;
  float* gy = gx + nhw;
  float* warped = gy + nhw;  // [n][3][h][w]

  // every image starts in buffer 0
  dim3 ogrid((unsigned)((hw + 255) / 256), n);
  pc::init_state_kernel<<<ogrid, 256, 0, stream>>>(u1_in, u2_in, state, hw);
  CHECK_LAUNCH();
  CHECK_MEMOP(cudaMemsetAsync(cur, 0, 2 * (size_t)n * sizeof(int), stream));
  CHECK_MEMOP(cudaMemsetAsync(iters, 0, (size_t)n * sizeof(int), stream));

  dim3 pblock(32, 8);
  dim3 pgrid((w + 31) / 32, (h + 7) / 8, n);
  gradient_kernel<<<pgrid, pblock, 0, stream>>>(i1, gx, gy, h, w);
  CHECK_LAUNCH();

  const int tiles_x = (w + pc::TILE_W - 1) / pc::TILE_W;
  const int tiles_y = (h + pc::TILE_H - 1) / pc::TILE_H;
  const dim3 grid(tiles_x * tiles_y, n);
  const size_t bytes = (size_t)WINDOW_PLANES * (pc::TILE_H + 2 * k) *
                       (pc::TILE_W + 2 * k) * sizeof(float);
  const int C = (iterations + k - 1) / k;
  const int m_last = iterations - (C - 1) * k;
  const int T = warps * C;

  pc::ChunkKernel kernel = k == 16  ? pc::blocked_chunk_kernel<pc::TILE_W + 32>
                           : k == 8 ? pc::blocked_chunk_kernel<pc::TILE_W + 16>
                                    : pc::blocked_chunk_kernel<0>;
  CHECK_CALL(cudaFuncSetAttribute((const void*)kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)bytes));

  for (int s = 0; s < warps; ++s) {
    const int t0 = s * C;
    pc::warp_kernel<<<pgrid, pblock, 0, stream>>>(
        i0, i1, gx, gy, state, cur + (t0 & 1) * n, warped, n, h, w);
    CHECK_LAUNCH();
    for (int c = 0; c < C; ++c) {
      kernel<<<grid, TILE_THREADS, bytes, stream>>>(
          state, warped, err, cur, iters, t0 + c, c, T, n, h, w, tiles_x, k,
          (c == C - 1) ? m_last : k, l_t, theta, taut, thresh);
      CHECK_LAUNCH();
    }
  }

  pc::output_kernel<<<ogrid, 256, 0, stream>>>(state, cur + (T & 1) * n,
                                               u1_out, u2_out, n, hw);
  CHECK_LAUNCH();
  return 0;
}

const char* tvl1_blocked_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
