// TV-L1 level solve for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the TPU's fused level kernel: optflow_tpu/ops/tvl1_pallas.py,
// `_make_fused_kernel`, launched by `_run_fused` from `_fused_level_fn`.
// Like that kernel, one call solves a whole pyramid level for a batch of
// images: centered gradient of i1; `warps` sweeps, each a backward warp of
// (i1, i1x, i1y) by the flow followed by up to `iterations` primal-dual
// updates with a per-image epsilon exit; the dual state is zero at level
// entry and kept across the sweeps. It returns the flow and the number of
// iterations each image ran.
//
// What differs on this card, and what the design does about it
// ------------------------------------------------------------
// The TPU kernel keeps every array of a level resident in on-chip memory
// for the whole solve. An SM has 227 KB of shared memory, so here the level
// is tiled over many thread blocks and the state lives in device memory
// (L2 where it fits). One primal-dual iteration needs its neighbours from
// other tiles twice — div p reads left/up, grad u reads right/down of the
// NEW u — so an iteration is one kernel launch that reads the old (u, p)
// buffers and writes the new ones (ping-pong). A block recomputes u_new on
// a one-pixel apron to the right and below each 32x8 tile and stages it in
// shared memory for the dual update.
//
// The epsilon exit needs no host synchronisation: a per-sweep table
// err[n][it] starts at zero; the launch of iteration `it` adds its blocks'
// sums of |du|^2 into err[n][it], and every block of image n first reads
// err[n][it-1] and skips the image unless it is > thresh. A skipped
// iteration leaves its own cell at zero, so the skip is sticky. Because
// images stop at different iterations, the buffer that holds an image's
// current state is (done[n] + it) & 1, with done[n] the iterations that
// image has run in earlier sweeps (kept on the device by `sweep_end`).
// thresh < 0 disables the exit. Most launches of a sweep come after every
// image has stopped (the host enqueues all `iterations` of them), so a
// launch has to be cheap to skip: the iteration kernel runs a fixed grid of
// resident blocks that walk over the tiles, and each block first votes on
// whether any image is still iterating and leaves if none is. One block per
// tile, each leaving on its own, cost more than the iterations that ran.
//
// The warp is the exact 2x2 gather with Catmull-Rom hat weights: there is no
// bound on |u|. Divisions are exact (no fast-math flags); nvcc contracts
// a*b+c to FMA, so results differ from the plain PyTorch version in the
// last bits.
//
// What bounds it
// --------------
// Per iteration and pixel a launch must read 9 floats (u1, u2, p11, p12,
// p21, p22, i1wx, i1wy, rho_c) and write 6: 60 B/px. At 32 x 256 x 1024
// one iteration moves >= 0.50 GB, ten times the 50 MB L2, so at the fine
// levels this design is bound by device-memory bandwidth; at the coarse
// levels (34 x 137 px) a launch has almost no work and the solve is bound
// by launch latency: 10 levels x 5 sweeps x up to 300 iterations = up to
// 15 000 iteration launches a solve, converged images' launches included.
// Arithmetic is 63 float operations per pixel and iteration (35 in the
// primal update, 28 in the dual one, a multiply-add counted as 2; the tally
// is in chip_smoke.py) plus the apron's share of the primal update, far
// below the card's float32 rate at 60 B/px. Keeping a tile resident over
// several iterations (a k-pixel halo: tvl1_blocked.cu does that for the
// large levels), a persistent cooperative kernel and CUDA graphs are the
// known ways out; none is taken here.

#include "tvl1_common.cuh"

namespace {

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

}  // namespace

extern "C" {

// Number of floats of scratch a level of n images of h x w needs.
long long tvl1_level_scratch_floats(int n, int h, int w) {
  return 17LL * n * h * w;  // 2 x 6 state planes, gx, gy, i1wx, i1wy, rho_c
}

// Enqueue one level solve on `stream`. All pointers are device memory:
//   i0, i1, u1_in, u2_in : (n, h, w) float32, read only
//   u1_out, u2_out       : (n, h, w) float32
//   done                 : (n) int32, on return the iterations each image ran
//   scratch              : tvl1_level_scratch_floats(n, h, w) floats
//   err                  : n * iterations floats
// Does not synchronise. Returns 0 or the first CUDA error code.
int tvl1_level_solve(const float* i0, const float* i1, const float* u1_in,
                     const float* u2_in, float* u1_out, float* u2_out,
                     int* done, float* scratch, float* err, int n, int h,
                     int w, int warps, int iterations, float l_t, float theta,
                     float taut, float thresh, void* stream_ptr) {
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
  CHECK_CALL(cudaMemcpyAsync(state, u1_in, nhw * sizeof(float),
                             cudaMemcpyDeviceToDevice, stream));
  CHECK_CALL(cudaMemcpyAsync(state + nhw, u2_in, nhw * sizeof(float),
                             cudaMemcpyDeviceToDevice, stream));
  CHECK_CALL(
      cudaMemsetAsync(state + 2 * nhw, 0, 4 * nhw * sizeof(float), stream));
  CHECK_CALL(cudaMemsetAsync(done, 0, (size_t)n * sizeof(int), stream));
  if (iterations > 0)
    CHECK_CALL(cudaMemsetAsync(
        err, 0, (size_t)n * iterations * sizeof(float), stream));

  dim3 block(TX, TY);
  dim3 grid((w + TX - 1) / TX, (h + TY - 1) / TY, n);
  gradient_kernel<<<grid, block, 0, stream>>>(i1, gx, gy, h, w);
  CHECK_LAUNCH();

  // the iteration kernel's grid: as many blocks as the card holds at once
  int device = 0, sms = 0, per_sm = 0;
  CHECK_CALL(cudaGetDevice(&device));
  CHECK_CALL(
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device));
  CHECK_CALL(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, iteration_kernel, TX * TY, 0));
  long long items = (long long)n * grid.x * grid.y;
  long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  unsigned iter_blocks = (unsigned)(items < resident ? items : resident);

  for (int s = 0; s < warps; ++s) {
    warp_kernel<<<grid, block, 0, stream>>>(i0, i1, gx, gy, state, done, wxp,
                                            wyp, rho, n, h, w);
    CHECK_LAUNCH();
    for (int it = 0; it < iterations; ++it) {
      iteration_kernel<<<iter_blocks, block, 0, stream>>>(
          state, wxp, wyp, rho, err, done, it, iterations, n, h, w,
          (int)grid.x, (int)grid.y, l_t, theta, taut, thresh);
      CHECK_LAUNCH();
    }
    if (iterations > 0) {
      sweep_end_kernel<<<n, 128, 0, stream>>>(err, done, iterations, thresh);
      CHECK_LAUNCH();
    }
  }

  dim3 ogrid((unsigned)((hw + 255) / 256), n);
  output_kernel<<<ogrid, 256, 0, stream>>>(state, done, u1_out, u2_out, n, hw);
  CHECK_LAUNCH();
  return 0;
}

const char* tvl1_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
