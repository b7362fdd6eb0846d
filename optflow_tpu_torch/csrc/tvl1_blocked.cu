// Blocked TV-L1 level solve for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the TPU's blocked level kernel: optflow_tpu/ops/tvl1_pallas.py,
// `_make_blocked_kernel`, launched by `_run_blocked` from
// `_blocked_level_fn`. Like that kernel, one call solves a whole pyramid
// level for a batch of images — the gradient of i1, then `warps` sweeps,
// each an exact backward warp stored to device memory once and
// C = ceil(iterations / k) chunks of k primal-dual iterations (the last of
// m_last) that run on halo-extended tiles resident in on-chip memory — with
// a per-image epsilon exit at chunk granularity, and returns the flow and
// the iterations each image ran. It is the kernel for levels too large for
// the fused kernel's counterpart (tvl1_level.cu), which goes to device
// memory once per iteration; this one goes once per k iterations.
//
// What differs on this card, and what the design does about it
// ------------------------------------------------------------
// * Tiles. The TPU kernel streams row blocks of the level's full width
//   through its on-chip memory and cannot block columns. A thread block has
//   227 KB of shared memory, so the level is cut in 2-D: tiles of 32 x 64
//   pixels with a halo of k pixels on every side. Nine floats per pixel are
//   resident (the state u1, u2, p11, p12, p21, p22 and the sweep's i1wx,
//   i1wy, rho_c): at the default k = 16 the window is 64 x 96 x 36 B =
//   221,184 B, the most that fits with the reduction's scratch beside it, so
//   one block runs per SM, with 1024 threads. 32 x 64 was chosen because
//   rows of 64 floats keep the loads and stores contiguous, the tile
//   divides the usual level sizes, and no tile with a 16-pixel halo that
//   fits recomputes much less (a 48 x 48 tile: 2.8 times its pixels against
//   3.0). Any width works: a (1, 512, 8192) level is 2,048 tiles.
// * Halo reach. One iteration reads p to the left and above and the new u
//   to the right and below, so k iterations need k exact pixels around a
//   tile; the window's edge goes wrong one pixel per iteration and never
//   reaches the tile. Windows are not clamped inward at the image's border
//   as the TPU kernel's are: the part of a window outside the image holds
//   zeros and is never read by a pixel of the image, because the boundary
//   conditions are those of the real h x w.
// * No order between blocks. The TPU grid is sequential, so that kernel
//   carries "which state buffer is current" in one scalar and sums the
//   previous chunk's errors as it goes. Here a chunk is one launch: it reads
//   one state buffer and writes the other (a tile's halo is its neighbours'
//   tile from the previous chunk). Images stop at different chunks, so which
//   buffer is current differs per image: cur[t & 1][n] is the buffer that
//   holds image n's state before chunk t. Every block of launch t reads
//   slot t & 1 and block 0 of each image writes slot (t + 1) & 1, so no
//   launch reads what it writes.
// * Epsilon exit. err[n][t][tile] is the sum of |u_new - u|^2 of chunk t's
//   LAST iteration over the tile's real pixels. Chunk t of image n runs iff
//   it starts a sweep or the sum over tiles of err[n][t-1] is > thresh;
//   every block takes that sum itself, in the same order, so all blocks of
//   an image decide alike. A chunk that does not run writes 0, so the stop
//   is sticky within a sweep. thresh < 0 disables the exit. Nothing is read
//   back by the host inside a level.
// * The warp is the exact 2x2 gather (tvl1_common.cuh): no shift bound, no
//   extra halo rows, no violation telemetry. Divisions are exact.
//
// What bounds it
// --------------
// Per chunk and tile a block loads 9 x 64 x 96 floats and stores 6 x 32 x 64
// (about 270 KB against 2,048 pixels x k iterations x 63 float operations),
// and each iteration makes about 29 four-byte shared-memory accesses per
// window pixel on 3 times the tile's pixels: the shared-memory traffic of
// the recomputed halo is the limit, not device memory and not arithmetic.
// Holding a thread's pixels in registers across the k iterations is the
// known way to cut it; it is not taken here.

#include "tvl1_common.cuh"

namespace {

constexpr int TILE_H = 32;
constexpr int TILE_W = 64;
constexpr int MAX_K = 16;  // (32 + 2k) x (64 + 2k) x 36 B must fit 227 KB

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

}  // namespace

extern "C" {

int tvl1_blocked_max_k() { return MAX_K; }

// Floats of scratch a level of n images of h x w needs: 2 x 6 state planes,
// gx, gy, and the 3 warped planes.
long long tvl1_blocked_scratch_floats(int n, int h, int w) {
  return 17LL * n * h * w;
}

// Floats of the error table: one per image, chunk and tile.
long long tvl1_blocked_err_floats(int n, int h, int w, int warps,
                                  int iterations, int k) {
  long long tiles = (long long)((w + TILE_W - 1) / TILE_W) *
                    ((h + TILE_H - 1) / TILE_H);
  long long chunks = (long long)warps * ((iterations + k - 1) / k);
  return (long long)n * (chunks > 0 ? chunks : 1) * tiles;
}

// Enqueue one level solve on `stream`. All pointers are device memory:
//   i0, i1, u1_in, u2_in : (n, h, w) float32, read only
//   u1_out, u2_out       : (n, h, w) float32
//   iters                : (n) int32, on return the iterations each image ran
//   scratch              : tvl1_blocked_scratch_floats(n, h, w) floats
//   err                  : tvl1_blocked_err_floats(...) floats
//   cur                  : 2 * n int32
// Does not synchronise. Returns 0 or the first CUDA error code.
int tvl1_blocked_level_solve(const float* i0, const float* i1,
                             const float* u1_in, const float* u2_in,
                             float* u1_out, float* u2_out, int* iters,
                             float* scratch, float* err, int* cur, int n,
                             int h, int w, int warps, int iterations, int k,
                             float l_t, float theta, float taut, float thresh,
                             void* stream_ptr) {
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
  init_state_kernel<<<ogrid, 256, 0, stream>>>(u1_in, u2_in, state, hw);
  CHECK_LAUNCH();
  CHECK_MEMOP(cudaMemsetAsync(cur, 0, 2 * (size_t)n * sizeof(int), stream));
  CHECK_MEMOP(cudaMemsetAsync(iters, 0, (size_t)n * sizeof(int), stream));

  dim3 pblock(32, 8);
  dim3 pgrid((w + 31) / 32, (h + 7) / 8, n);
  gradient_kernel<<<pgrid, pblock, 0, stream>>>(i1, gx, gy, h, w);
  CHECK_LAUNCH();

  const int tiles_x = (w + TILE_W - 1) / TILE_W;
  const int tiles_y = (h + TILE_H - 1) / TILE_H;
  const dim3 grid(tiles_x * tiles_y, n);
  const size_t bytes = (size_t)WINDOW_PLANES * (TILE_H + 2 * k) *
                       (TILE_W + 2 * k) * sizeof(float);
  const int C = (iterations + k - 1) / k;
  const int m_last = iterations - (C - 1) * k;
  const int T = warps * C;

  ChunkKernel kernel = k == 16  ? blocked_chunk_kernel<TILE_W + 32>
                       : k == 8 ? blocked_chunk_kernel<TILE_W + 16>
                                : blocked_chunk_kernel<0>;
  CHECK_CALL(cudaFuncSetAttribute((const void*)kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)bytes));

  for (int s = 0; s < warps; ++s) {
    const int t0 = s * C;
    warp_kernel<<<pgrid, pblock, 0, stream>>>(
        i0, i1, gx, gy, state, cur + (t0 & 1) * n, warped, n, h, w);
    CHECK_LAUNCH();
    for (int c = 0; c < C; ++c) {
      kernel<<<grid, TILE_THREADS, bytes, stream>>>(
          state, warped, err, cur, iters, t0 + c, c, T, n, h, w, tiles_x, k,
          (c == C - 1) ? m_last : k, l_t, theta, taut, thresh);
      CHECK_LAUNCH();
    }
  }

  output_kernel<<<ogrid, 256, 0, stream>>>(state, cur + (T & 1) * n, u1_out,
                                           u2_out, n, hw);
  CHECK_LAUNCH();
  return 0;
}

const char* tvl1_blocked_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
