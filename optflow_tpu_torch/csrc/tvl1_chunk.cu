// TV-L1 chunk kernel for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the TPU's legacy chunk kernel: optflow_tpu/ops/tvl1_pallas.py,
// `_make_kernel`, launched by `_run_chunk` from
// `tvl1_flow_level_pallas_batched`. Like that kernel, one call runs up to `m`
// primal-dual iterations on precomputed warped arrays
// ro = (i1wx, i1wy, rho_c) and a state (u1, u2, p11, p12, p21, p22), and
// returns the new state and, per image and block, the masked sum of
// |u_new - u|^2 of the last iteration run. The warp is not part of it: the
// caller computes `ro` once per sweep.
//
// Two modes, as in the TPU kernel, chosen by the caller from the level's
// size:
//
//  * one block: a level whose nine arrays fit one thread block's shared
//    memory (36 B per pixel, at most 227 KB) is solved by one block per
//    image, which runs up to `m` iterations and leaves its loop as soon as
//    the image's own error is <= thresh: the exact per-iteration criterion,
//    decided on the device (`while (it < m && err > thresh)`).
//
//  * tiles: a larger level is cut into 32 x 64 tiles (the TPU kernel cuts
//    row blocks only). A block loads its tile with a halo of CHUNK_K pixels
//    on every side (48 x 80 x 36 B = 138 KB), runs m <= CHUNK_K iterations
//    in shared memory and writes the tile to the OTHER state buffer, because
//    its neighbours read its old values as their halo. 32 x 64 keeps rows
//    of 64 floats contiguous for the loads and leaves the 8-pixel halo at
//    1.9 times the tile's pixels; one block fits an SM.
//
// An image whose entry in `active` is 0 is passed through unchanged (its
// state is copied, its errors are 0): the caller stops an image's later
// chunks that way without reading anything back.
//
// tvl1_chunk_level_solve solves a whole pyramid level in one call: the
// gradient of i1, the state set-up, each sweep's exact warp and the sweeps
// with the chunk kernel's exit rule, in ONE cooperative launch of the
// persistent level grid (tvl1_grid.cuh; the level kernel's notes in
// tvl1_level.cu describe it). A level in tiles runs it with an exit every
// CHUNK_K = 8 iterations: an image stops after the first 8th iteration whose
// sum over the tiles is <= thresh, as after the first chunk of 8 whose last
// error is; chunks of at most 4 on the grid's halo of 4 (the window 1.4
// times the tile, not 1.9), two blocks a multiprocessor, the step loop ended
// on the card with a queue of the images that still run, nothing copied for
// an image that has stopped. A level that fits one block takes the exact
// per-iteration exit, through the grid's exact instantiation (the level
// kernel's): one block per tile of each image, not one block holding the
// image across the sweeps, which would be a second kernel for levels of a
// few thousand pixels. The per-level API calls it once a level; before, it
// enqueued the gradient, a state stack and every sweep's warp as plain
// PyTorch (about 570 small kernels a pair a level) and one sweep call a
// sweep. What bounds it is the grid's: the tile iteration's instruction
// stream.
//
// tvl1_chunk_sweep, the replaced path, runs one sweep on a warp computed
// outside: the ceil(iterations / 8) tile launches enqueued from the C
// function, each deciding per image on the card whether it runs, from the
// tile sums the launch before it left (every block of an image adds that
// row itself, in the same order, so all decide alike); state and errors
// ping-pong between two buffers so that the last launch leaves the result in
// the output, and a stopped image is copied through (48 B a pixel and
// launch). It stays, until ROADMAP.md deletes it, so that chip_smoke.py can
// time the old level loop against the level entry; no path of the package
// selects it.
//
// What bounds the single chunk: in tile mode a launch reads 9 and writes 6
// floats per pixel of device memory for m iterations of 63 float operations
// each, and the iterations themselves run from shared memory (about 29
// four-byte accesses per pixel and iteration, on 1.9 times the pixels), so
// at m = 8 the shared-memory traffic, not device memory, is the limit. In
// one-block mode a level is a few thousand pixels: latency of the two
// block-wide barriers per iteration.

#include "tvl1_grid.cuh"

namespace {

constexpr int CHUNK_K = 8;  // halo = most iterations per launch, tile mode
// (the tiles are the grid's 32 x 64: TILE_H, TILE_W of tvl1_grid.cuh)
constexpr int CHUNK_WIN_W = TILE_W + 2 * CHUNK_K;
constexpr int CHUNK_WIN_H = TILE_H + 2 * CHUNK_K;

// Copy the state of the image rectangle through, for an image that has
// stopped.
__device__ void pass_through(const float* __restrict__ src,
                             float* __restrict__ dst, int h, int w, int iy0,
                             int iy1, int ix0, int ix1) {
  const size_t hw = (size_t)h * w;
  const int iw = ix1 - ix0;
  const int ipx = (iy1 - iy0) * iw;
  for (int idx = threadIdx.x; idx < ipx; idx += blockDim.x) {
    int ry = idx / iw, rx = idx - ry * iw;
    size_t o = (size_t)(iy0 + ry) * w + ix0 + rx;
#pragma unroll
    for (int c = 0; c < 6; ++c) dst[c * hw + o] = src[c * hw + o];
  }
}

// Tile mode. grid = (tiles, n); errs is (n, tiles). An image runs unless its
// `active` entry is 0 or, where `prev_errs` (the errors the chunk before
// returned) is given and thresh >= 0, the sum of its row of them is
// <= thresh: every block of the image adds the row itself, all in the same
// order, so all decide alike and nothing is read back by the host.
__global__ void __launch_bounds__(TILE_THREADS)
    chunk_tiles_kernel(const float* __restrict__ ro,
                       const float* __restrict__ state,
                       float* __restrict__ out, float* __restrict__ errs,
                       const int* __restrict__ active,
                       const float* __restrict__ prev_errs,
                       int* __restrict__ iters, int h, int w, int tiles_x,
                       int m, float l_t, float theta, float taut,
                       float thresh) {
  extern __shared__ float smem[];
  const int n = blockIdx.y;
  const int tile = blockIdx.x;
  const int ty = tile / tiles_x, tx = tile - ty * tiles_x;
  const size_t hw = (size_t)h * w;
  const int iy0 = ty * TILE_H, ix0 = tx * TILE_W;
  const int iy1 = min(iy0 + TILE_H, h), ix1 = min(ix0 + TILE_W, w);
  const float* st = state + (size_t)n * 6 * hw;
  float* dst = out + (size_t)n * 6 * hw;
  float* err_cell = errs + (size_t)n * gridDim.x + tile;

  bool run = active == nullptr || active[n] != 0;
  if (run && prev_errs != nullptr && thresh >= 0.0f) {
    const float* row = prev_errs + (size_t)n * gridDim.x;
    float part = 0.0f;
    for (int i = threadIdx.x; i < (int)gridDim.x; i += blockDim.x)
      part += row[i];
    run = block_sum(part) > thresh;
  }
  if (!run) {
    // a stopped image returns errors of 0, so the stop is sticky
    pass_through(st, dst, h, w, iy0, iy1, ix0, ix1);
    if (threadIdx.x == 0) *err_cell = 0.0f;
    return;
  }
  Window t{smem, CHUNK_WIN_H, CHUNK_WIN_W, iy0 - CHUNK_K, ix0 - CHUNK_K, h, w};
  window_load<CHUNK_WIN_W>(t, st, ro + (size_t)n * 3 * hw);
  __syncthreads();
  float err = window_iterate<CHUNK_WIN_W>(t, m, l_t, theta, taut, iy0, iy1,
                                          ix0, ix1);
  window_store<CHUNK_WIN_W>(t, dst, iy0, iy1, ix0, ix1);
  if (threadIdx.x == 0) {
    *err_cell = err;
    if (tile == 0 && iters != nullptr) iters[n] += m;
  }
}

// One-block mode. grid = (1, n); errs is (n, 1). The window is the image.
__global__ void __launch_bounds__(TILE_THREADS)
    chunk_one_block_kernel(const float* __restrict__ ro,
                           const float* __restrict__ state,
                           float* __restrict__ out, float* __restrict__ errs,
                           const int* __restrict__ active,
                           int* __restrict__ iters, int h, int w, int m,
                           float l_t, float theta, float taut, float thresh) {
  extern __shared__ float smem[];
  const int n = blockIdx.y;
  const size_t hw = (size_t)h * w;
  const float* st = state + (size_t)n * 6 * hw;
  float* dst = out + (size_t)n * 6 * hw;

  if (active != nullptr && active[n] == 0) {
    pass_through(st, dst, h, w, 0, h, 0, w);
    if (threadIdx.x == 0) errs[n] = 0.0f;
    return;
  }
  Window t{smem, h, w, 0, 0, h, w};
  window_load<0>(t, st, ro + (size_t)n * 3 * hw);
  __syncthreads();
  // thresh < 0 never stops: a sum of squares is >= 0. A NaN error stops.
  int it = 0;
  float err = INFINITY;
  while (it < m && err > thresh) {
    err = window_iterate<0>(t, 1, l_t, theta, taut, 0, h, 0, w);
    ++it;
  }
  window_store<0>(t, dst, 0, h, 0, w);
  if (threadIdx.x == 0) {
    errs[n] = err;
    if (iters != nullptr) iters[n] += it;
  }
}

}  // namespace

extern "C" {

// The geometry the wrapper allocates by.
int tvl1_chunk_k() { return CHUNK_K; }
int tvl1_chunk_tile_h() { return TILE_H; }
int tvl1_chunk_tile_w() { return TILE_W; }

// Enqueue one chunk on `stream`. All pointers are device memory:
//   ro     : (n, 3, h, w) float32, read only
//   state  : (n, 6, h, w) float32, read only
//   out    : (n, 6, h, w) float32, must not overlap `state`
//   errs   : (n, blocks) float32; blocks = 1 in one-block mode, else
//            ceil(h/32) * ceil(w/64)
//   active : (n) int32 or null: 0 passes the image through
//   iters  : (n) int32 or null: the iterations each image ran are added
// one_block != 0 selects the one-block mode (the caller has checked that
// 36*h*w bytes fit); then m may be any count and thresh is the in-kernel
// exit. In tile mode m <= 8 and thresh is not used.
// Does not synchronise. Returns 0 or the first CUDA error code.
int tvl1_chunk(const float* ro, const float* state, float* out, float* errs,
               const int* active, int* iters, int n, int h, int w, int m,
               int one_block, float l_t, float theta, float taut,
               float thresh, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (n <= 0 || n > 65535 || h < 2 || w < 2 || m < 1)
    return (int)cudaErrorInvalidValue;
  if (one_block) {
    size_t bytes = (size_t)WINDOW_PLANES * h * w * sizeof(float);
    CHECK_CALL(cudaFuncSetAttribute(
        chunk_one_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes));
    chunk_one_block_kernel<<<dim3(1, n), TILE_THREADS, bytes, stream>>>(
        ro, state, out, errs, active, iters, h, w, m, l_t, theta, taut,
        thresh);
    CHECK_LAUNCH();
    return 0;
  }
  if (m > CHUNK_K) return (int)cudaErrorInvalidValue;
  int tiles_x = (w + TILE_W - 1) / TILE_W;
  int tiles_y = (h + TILE_H - 1) / TILE_H;
  size_t bytes =
      (size_t)WINDOW_PLANES * CHUNK_WIN_H * CHUNK_WIN_W * sizeof(float);
  CHECK_CALL(cudaFuncSetAttribute(chunk_tiles_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)bytes));
  chunk_tiles_kernel<<<dim3(tiles_x * tiles_y, n), TILE_THREADS, bytes,
                       stream>>>(ro, state, out, errs, active, nullptr, iters,
                                 h, w, tiles_x, m, l_t, theta, taut, thresh);
  CHECK_LAUNCH();
  return 0;
}

// Enqueue one whole sweep on `stream`: up to `iterations` iterations on the
// fixed warped arrays `ro`, with the level solve's exit rule. One-block mode:
// one launch, the exit inside the kernel, per iteration. Tile mode:
// ceil(iterations / 8) launches of the tile kernel, each deciding per image
// from the errors of the launch before it whether it runs (the first always
// does); a stopped image is copied through the launches that are left, so the
// last launch leaves every image's final state in `out`.
//   ro      : (n, 3, h, w) float32, read only
//   state   : (n, 6, h, w) float32, read only
//   out     : (n, 6, h, w) float32, the result
//   scratch : (n, 6, h, w) float32, the other ping-pong buffer (may be null
//             in one-block mode and when iterations <= 8)
//   errs    : (2, n, blocks) float32; on return slot (launches - 1) & 1 holds
//             the errors of the last launch, 0 for an image that had stopped
//             before it
//   iters   : (n) int32 or null: the iterations each image ran are added
// No two of state, out and scratch may overlap. iterations >= 1.
// Does not synchronise. Returns 0 or the first CUDA error code.
int tvl1_chunk_sweep(const float* ro, const float* state, float* out,
                     float* scratch, float* errs, int* iters, int n, int h,
                     int w, int iterations, int one_block, float l_t,
                     float theta, float taut, float thresh,
                     void* stream_ptr) {
  if (iterations < 1) return (int)cudaErrorInvalidValue;
  if (one_block)
    return tvl1_chunk(ro, state, out, errs, nullptr, iters, n, h, w,
                      iterations, 1, l_t, theta, taut, thresh, stream_ptr);
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (n <= 0 || n > 65535 || h < 2 || w < 2)
    return (int)cudaErrorInvalidValue;
  const int launches = (iterations + CHUNK_K - 1) / CHUNK_K;
  if (launches > 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const int tiles_x = (w + TILE_W - 1) / TILE_W;
  const int tiles_y = (h + TILE_H - 1) / TILE_H;
  const int tiles = tiles_x * tiles_y;
  const size_t bytes =
      (size_t)WINDOW_PLANES * CHUNK_WIN_H * CHUNK_WIN_W * sizeof(float);
  CHECK_CALL(cudaFuncSetAttribute(chunk_tiles_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)bytes));
  const float* src = state;
  const float* prev = nullptr;
  for (int i = 0; i < launches; ++i) {
    // the last launch writes `out`; the ones before it alternate
    float* dst = ((launches - 1 - i) % 2 == 0) ? out : scratch;
    float* cur = errs + (size_t)(i & 1) * n * tiles;
    const int m = min(CHUNK_K, iterations - i * CHUNK_K);
    chunk_tiles_kernel<<<dim3(tiles, n), TILE_THREADS, bytes, stream>>>(
        ro, src, dst, cur, nullptr, prev, iters, h, w, tiles_x, m, l_t, theta,
        taut, thresh);
    CHECK_LAUNCH();
    src = dst;
    prev = cur;
  }
  return 0;
}

// Enqueue one level solve on `stream`: three memsets (tables, iters, work)
// and one cooperative kernel launch. A level in tiles tests the exit after
// every CHUNK_K-th iteration of a sweep; one_block != 0 (the caller has found
// that the level fits one block) takes the exact per-iteration exit. The
// arguments are tvl1_level_solve's (tvl1_level.cu), the tables sized by
// tvl1_level_table_ints(n, warps, iterations, one_block ? 1 : CHUNK_K).
// Does not synchronise. Returns 0 or the first CUDA error code.
int tvl1_chunk_level_solve(const float* i0, const float* i1,
                           const float* u1_in, const float* u2_in,
                           float* u1_out, float* u2_out, int* iters,
                           int* work, float* scratch, float* err,
                           int* tables, int n, int h, int w, int warps,
                           int iterations, int one_block, float l_t,
                           float theta, float taut, float thresh,
                           void* stream_ptr) {
  const LevelArgs args{i0,    i1,    u1_in,   u2_in, u1_out, u2_out,
                       iters, work,  scratch, err,   tables, n,
                       h,     w,     warps,   iterations,
                       one_block ? 1 : CHUNK_K,
                       l_t,   theta, taut,    thresh};
  return one_block ? level_solve<true>(args, stream_ptr)
                   : level_solve<false>(args, stream_ptr);
}

const char* tvl1_chunk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
