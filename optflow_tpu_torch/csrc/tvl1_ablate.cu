// TV-L1 iteration-ablation kernel for NVIDIA Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU's ablation kernel: tools_kernel_ablate.py, `make_kernel`,
// launched by `run`. Like that kernel it runs the chunk kernel's iteration
// body a FIXED number of times per image (the loop never looks at the
// error) on precomputed warped arrays ro = (i1wx, i1wy, rho_c) and a state
// (u1, u2, p11, p12, p21, p22), with one class of cost compiled out per
// variant, and returns the new state and each image's error sum of the last
// iteration. Timing two iteration counts and dividing the difference gives
// each variant's cost per iteration; the differences between variants say
// what the production iteration spends on the error reduction, the square
// roots, the divisions and the neighbour reads on this card.
//
// The TPU kernel held a whole 256 x 1024 level (9 planes) on chip. A thread
// block has 227 KB of shared memory, so this kernel takes the chunk kernel's
// tiled form and its device code (tvl1_common.cuh, tvl1_chunk.cu's tile
// mode): 32 x 64 tiles with an 8-pixel halo, at most 8 iterations a launch,
// ceil(m / 8) launches a call, the state ping-ponged between two buffers
// because a tile's neighbours read its old values as their halo. With every
// switch on, the instantiation is the chunk kernel's own: `full` equals
// tvl1_chunk with the exit disabled bit for bit.
//
// The four switches are template parameters of the shared iteration, so a
// variant's machine code really holds no reduction / sqrt / division /
// neighbour read. Each variant still stores its state, and writes a value
// per image, so the compiler cannot remove the loop.
//
// What bounds it: as the chunk kernel in tile mode, the shared-memory
// traffic of the iterations (about 29 four-byte accesses per pixel and
// iteration on 1.9 times the pixels), then the launches (one per 8
// iterations); device memory moves 15 floats per pixel and launch.

#include "tvl1_common.cuh"

namespace {

constexpr int ABLATE_K = 8;  // halo = most iterations per launch
constexpr int TILE_H = 32;
constexpr int TILE_W = 64;
constexpr int ABLATE_WIN_W = TILE_W + 2 * ABLATE_K;
constexpr int ABLATE_WIN_H = TILE_H + 2 * ABLATE_K;
constexpr size_t ABLATE_SMEM =
    (size_t)WINDOW_PLANES * ABLATE_WIN_H * ABLATE_WIN_W * sizeof(float);

// grid = (tiles, n); tile_errs is (n, tiles).
template <bool ERR, bool SQRT, bool DIV, bool ROLL>
__global__ void __launch_bounds__(TILE_THREADS)
    ablate_tiles_kernel(const float* __restrict__ ro,
                        const float* __restrict__ state,
                        float* __restrict__ out, float* __restrict__ tile_errs,
                        int h, int w, int tiles_x, int m, float l_t,
                        float theta, float taut) {
  extern __shared__ float smem[];
  const int n = blockIdx.y;
  const int tile = blockIdx.x;
  const int ty = tile / tiles_x, tx = tile - ty * tiles_x;
  const size_t hw = (size_t)h * w;
  const int iy0 = ty * TILE_H, ix0 = tx * TILE_W;
  const int iy1 = min(iy0 + TILE_H, h), ix1 = min(ix0 + TILE_W, w);
  Window t{smem, ABLATE_WIN_H, ABLATE_WIN_W, iy0 - ABLATE_K, ix0 - ABLATE_K,
           h, w};
  window_load<ABLATE_WIN_W>(t, state + (size_t)n * 6 * hw,
                            ro + (size_t)n * 3 * hw);
  __syncthreads();
  float err = window_iterate<ABLATE_WIN_W, ERR, SQRT, DIV, ROLL>(
      t, m, l_t, theta, taut, iy0, iy1, ix0, ix1);
  window_store<ABLATE_WIN_W>(t, out + (size_t)n * 6 * hw, iy0, iy1, ix0, ix1);
  if (threadIdx.x == 0) tile_errs[(size_t)n * gridDim.x + tile] = err;
}

// Each image's error: its tiles' sums added in tile order by one thread per
// image (a few hundred values), so a rerun gives the same bits. With ERR off
// nothing was summed and the image's value is 1, as in the TPU tool.
__global__ void image_errs_kernel(const float* __restrict__ tile_errs,
                                  float* __restrict__ errs, int n, int tiles,
                                  int summed) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int k = 0; k < tiles; ++k) s += tile_errs[(size_t)i * tiles + k];
  errs[i] = summed ? s : 1.0f;
}

template <bool ERR, bool SQRT, bool DIV, bool ROLL>
int run_variant(const float* ro, const float* state, float* out,
                float* scratch, float* tile_errs, float* errs, int n, int h,
                int w, int m, float l_t, float theta, float taut,
                cudaStream_t stream) {
  auto kernel = ablate_tiles_kernel<ERR, SQRT, DIV, ROLL>;
  CHECK_CALL(cudaFuncSetAttribute(kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)ABLATE_SMEM));
  const int tiles_x = (w + TILE_W - 1) / TILE_W;
  const int tiles_y = (h + TILE_H - 1) / TILE_H;
  const int tiles = tiles_x * tiles_y;
  const int launches = (m + ABLATE_K - 1) / ABLATE_K;
  const float* src = state;
  for (int i = 0; i < launches; ++i) {
    // the last launch writes `out`; the ones before it alternate
    float* dst = ((launches - 1 - i) % 2 == 0) ? out : scratch;
    int mi = min(ABLATE_K, m - i * ABLATE_K);
    kernel<<<dim3(tiles, n), TILE_THREADS, ABLATE_SMEM, stream>>>(
        ro, src, dst, tile_errs, h, w, tiles_x, mi, l_t, theta, taut);
    CHECK_LAUNCH();
    src = dst;
  }
  image_errs_kernel<<<(n + 127) / 128, 128, 0, stream>>>(tile_errs, errs, n,
                                                         tiles, ERR ? 1 : 0);
  CHECK_LAUNCH();
  return 0;
}

}  // namespace

extern "C" {

// The geometry the wrapper allocates by.
int tvl1_ablate_k() { return ABLATE_K; }
int tvl1_ablate_tile_h() { return TILE_H; }
int tvl1_ablate_tile_w() { return TILE_W; }

// Enqueue m iterations of one variant on `stream`: ceil(m / 8) launches of
// the tile kernel and one of the error sum. All pointers are device memory:
//   ro        : (n, 3, h, w) float32, read only
//   state     : (n, 6, h, w) float32, read only
//   out       : (n, 6, h, w) float32, the result
//   scratch   : (n, 6, h, w) float32, the other ping-pong buffer (may be
//               null when m <= 8)
//   tile_errs : (n, ceil(h/32) * ceil(w/64)) float32 scratch
//   errs      : (n) float32, each image's error sum of the last iteration
//               (1 where the variant has no error reduction)
// No two of state, out and scratch may overlap. The variant is the four
// switches keep_err, keep_sqrt, keep_div, keep_roll (non-zero = that cost
// class is kept); only the six variants of the tool are built.
// Does not synchronise. Returns 0 or the first CUDA error code.
int tvl1_ablate(const float* ro, const float* state, float* out,
                float* scratch, float* tile_errs, float* errs, int n, int h,
                int w, int m, int keep_err, int keep_sqrt, int keep_div,
                int keep_roll, float l_t,
                float theta, float taut, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (n <= 0 || n > 65535 || h < 2 || w < 2 || m < 1)
    return (int)cudaErrorInvalidValue;
  if (m > ABLATE_K && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const int key = (keep_err ? 8 : 0) | (keep_sqrt ? 4 : 0) |
                  (keep_div ? 2 : 0) | (keep_roll ? 1 : 0);
#define ABLATE_VARIANT(E, S, D, R)                                           \
  case ((E ? 8 : 0) | (S ? 4 : 0) | (D ? 2 : 0) | (R ? 1 : 0)):              \
    return run_variant<E, S, D, R>(ro, state, out, scratch, tile_errs, errs, \
                                   n, h, w, m, l_t, theta, taut, stream)
  switch (key) {
    ABLATE_VARIANT(true, true, true, true);      // full
    ABLATE_VARIANT(false, true, true, true);     // no_err
    ABLATE_VARIANT(true, false, true, true);     // no_sqrt
    ABLATE_VARIANT(true, true, false, true);     // no_div
    ABLATE_VARIANT(true, true, true, false);     // no_roll
    ABLATE_VARIANT(false, false, false, false);  // min_body
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef ABLATE_VARIANT
}

const char* tvl1_ablate_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
