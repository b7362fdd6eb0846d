// Shared device code of the TV-L1 kernels (sm_90a): the exact-gather warp of
// one pixel, the primal-dual arithmetic of one
// pixel (`threshold_step`, `primal_update`, `dual_update`), and the
// iteration on a window of a level held in shared memory, which calls them. Included by tvl1_level.cu,
// tvl1_blocked.cu, tvl1_chunk.cu and tvl1_ablate.cu (whose kernel keeps its
// pixels in registers and calls the per-pixel functions itself); each of
// those is its own library.
//
// Arithmetic is the plain solver's (ops/tvl1.py `_iteration`,
// ops/warp.py `warp_backward`) in the same order everywhere: exact
// divisions and square roots, no fast-math flags. nvcc contracts a*b+c to
// FMA, so the kernels differ from the plain PyTorch version in the last
// bits, and agree with each other.
//
// The per-pixel functions and the window iteration take compile-time
// switches, all on by default (the level, blocked and chunk kernels leave
// them so). tvl1_ablate.cu turns them off in its own iteration, around the
// per-pixel functions, to build it with one class of cost compiled out (no
// kernel turns off the window iteration's any more):
//   ERR   the sum of |u_new - u|^2 and its block-wide reduction
//   SQRT  the two square roots of the dual norms (off: the squared norm)
//   DIV   the five divisions (off: multiplications by the same operand)
//   ROLL  the eight reads of a neighbouring pixel (off: the pixel itself)

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <mutex>

namespace {

constexpr float GRAD_EPS = 1.192092896e-07f;

// What the library's host functions have put on a stream since it was
// loaded: [0] kernel launches, [1] memsets and copies. Each is counted where
// it is enqueued, so a caller reads the launches of one call as a difference
// (`tvl1_enqueued`, below) without tracing the card. Atomic: one host thread
// per device may enqueue at once.
std::atomic<long long> g_enqueued[2]{};

// Held by a host function from its cudaFuncSetAttribute of a shared memory
// size that depends on the call to the last launch that uses that size. The
// attribute belongs to the kernel, not to the call: without the lock, a
// thread solving another shape could lower it between this thread's setting
// and its occupancy query or launch, and the launch would be refused
// (cudaErrorLaunchOutOfResources).
std::mutex g_smem_attr_mutex;

// After a `<<<...>>>` launch.
#define CHECK_LAUNCH()                     \
  do {                                     \
    cudaError_t e_ = cudaGetLastError();   \
    if (e_ != cudaSuccess) return (int)e_; \
    ++g_enqueued[0];                       \
  } while (0)

// Around a launch made through the runtime's API (a cooperative launch).
#define CHECK_LAUNCH_CALL(expr)            \
  do {                                     \
    cudaError_t e_ = (expr);               \
    if (e_ != cudaSuccess) return (int)e_; \
    ++g_enqueued[0];                       \
  } while (0)

// Around a cudaMemsetAsync or cudaMemcpyAsync.
#define CHECK_MEMOP(expr)                  \
  do {                                     \
    cudaError_t e_ = (expr);               \
    if (e_ != cudaSuccess) return (int)e_; \
    ++g_enqueued[1];                       \
  } while (0)

#define CHECK_CALL(expr)                   \
  do {                                     \
    cudaError_t e_ = (expr);               \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)

__device__ __forceinline__ float hat(float t) {
  // central lobe of the Catmull-Rom cubic on t in [0, 1]
  return t * t * (1.5f * t - 2.5f) + 1.0f;
}

// Backward warp of (i1, i1x, i1y) at pixel (x, y) of one image by the flow
// (u1, u2) there, and the linearised residual: the exact 2x2 gather with
// renormalised hat weights, no bound on |u|. The four pointers are the
// image's own planes. Writes i1wx, i1wy and
// rho_c = i1w - i1wx*u1 - i1wy*u2 - i0.
__device__ __forceinline__ void warp_pixel(
    const float* __restrict__ i0, const float* __restrict__ i1,
    const float* __restrict__ gx, const float* __restrict__ gy, int h, int w,
    int x, int y, float u1, float u2, float* wx_out, float* wy_out,
    float* rho_out) {
  // fminf/fmaxf drop a NaN operand, so the taps stay inside the image
  float xf = fminf(fmaxf((float)x + u1, 0.0f), (float)w - 1.0f);
  float yf = fminf(fmaxf((float)y + u2, 0.0f), (float)h - 1.0f);
  float x0 = fminf(floorf(xf), (float)w - 2.0f);
  float y0 = fminf(floorf(yf), (float)h - 2.0f);
  float fx = xf - x0;
  float fy = yf - y0;
  float wx0 = hat(fx), wx1 = hat(1.0f - fx);
  float wy0 = hat(fy), wy1 = hat(1.0f - fy);
  float inv_norm = 1.0f / ((wx0 + wx1) * (wy0 + wy1));
  size_t b = (size_t)((int)y0) * w + (int)x0;

  float s[3];
  const float* srcs[3] = {i1, gx, gy};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float* im = srcs[k];
    float top = wx0 * im[b] + wx1 * im[b + 1];
    float bot = wx0 * im[b + w] + wx1 * im[b + w + 1];
    s[k] = inv_norm * (wy0 * top + wy1 * bot);
  }
  *wx_out = s[1];
  *wy_out = s[2];
  *rho_out = s[0] - s[1] * u1 - s[2] * u2 - i0[(size_t)y * w + x];
}

// The primal step of one pixel: the soft threshold on the linearised
// residual. Returns the update (d1, d2) of (u1, u2).
template <bool DIV = true>
__device__ __forceinline__ void threshold_step(float a, float b, float rho_c,
                                               float U1, float U2, float l_t,
                                               float* d1, float* d2) {
  float grad = a * a + b * b;
  float rho = rho_c + a * U1 + b * U2;
  float t = l_t * grad;
  if (rho < -t) {
    *d1 = l_t * a;
    *d2 = l_t * b;
  } else if (rho > t) {
    *d1 = -l_t * a;
    *d2 = -l_t * b;
  } else if (grad > GRAD_EPS) {
    float fi = DIV ? -rho / fmaxf(grad, GRAD_EPS) : -rho * fmaxf(grad, GRAD_EPS);
    *d1 = fi * a;
    *d2 = fi * b;
  } else {
    *d1 = 0.0f;
    *d2 = 0.0f;
  }
}

// The rest of the first half of an iteration at one pixel, after its
// threshold step (d1, d2): u <- u + d + theta * div p. (U1, U2) is the
// pixel's u, (q11, q12, q21, q22) its p, l11 / l21 the p11 / p21 of the
// pixel to the left and a12 / a22 the p12 / p22 of the pixel above;
// `has_left` / `has_above` are false at the image's first column / row,
// where the backward difference is p itself. With threshold_step and
// dual_update this is the arithmetic of an iteration, the same text in
// every kernel, so the same operands give the same bits in all of them.
__device__ __forceinline__ void primal_update(
    float U1, float U2, float d1, float d2, float q11, float q12, float q21,
    float q22, float l11, float l21, float a12, float a22, bool has_left,
    bool has_above, float theta, float* n1, float* n2) {
  float div1 = (has_left ? q11 - l11 : q11) + (has_above ? q12 - a12 : q12);
  float div2 = (has_left ? q21 - l21 : q21) + (has_above ? q22 - a22 : q22);
  *n1 = (U1 + d1) + theta * div1;
  *n2 = (U2 + d2) + theta * div2;
}

// The second half at one pixel, from the forward differences of the new u
// (zero at the image's last column / row): p <- (p + taut * grad u) /
// (1 + taut * |grad u|), the four p in place.
template <bool SQRT = true, bool DIV = true>
__device__ __forceinline__ void dual_update(float u1x, float u1y, float u2x,
                                            float u2y, float taut, float* p11,
                                            float* p12, float* p21,
                                            float* p22) {
  float s1 = u1x * u1x + u1y * u1y, s2 = u2x * u2x + u2y * u2y;
  float ng1 = 1.0f + taut * (SQRT ? sqrtf(s1) : s1);
  float ng2 = 1.0f + taut * (SQRT ? sqrtf(s2) : s2);
  if (DIV) {
    *p11 = (*p11 + taut * u1x) / ng1;
    *p12 = (*p12 + taut * u1y) / ng1;
    *p21 = (*p21 + taut * u2x) / ng2;
    *p22 = (*p22 + taut * u2y) / ng2;
  } else {
    *p11 = (*p11 + taut * u1x) * ng1;
    *p12 = (*p12 + taut * u1y) * ng1;
    *p21 = (*p21 + taut * u2x) * ng2;
    *p22 = (*p22 + taut * u2y) * ng2;
  }
}

// ---------------------------------------------------------------------------
// A window of one image in shared memory
// ---------------------------------------------------------------------------
//
// Nine planes of win_h x win_w floats, in this order: u1, u2, p11, p12, p21,
// p22 (the state) and i1wx, i1wy, rho_c (fixed during a sweep). Window pixel
// (0, 0) is image pixel (y0, x0), which may lie outside the image: such
// pixels hold zeros and are never updated, and no pixel of the image reads
// them, because the boundary conditions are those of the real h x w
// (p itself at the first row/column, zero forward difference at the last).
//
// One iteration reads p to the left and above and the NEW u to the right and
// below, so a value k pixels inside the window's edge is exact for k
// iterations: whatever a pixel at the window's edge reads from outside the
// window is wrong, and the error moves inward one pixel per iteration. Every
// pixel of the window is updated in every iteration; the caller keeps only
// the part that is still exact (the interior, k pixels in on every side that
// is not the image's border).
struct Window {
  float* s;      // 9 * win_h * win_w floats of shared memory
  int win_h, win_w;
  int y0, x0;    // image coordinates of window pixel (0, 0)
  int h, w;      // the image
};

constexpr int WINDOW_PLANES = 9;
constexpr int TILE_THREADS = 1024;

// WIN_W > 0 fixes the window's width at compile time (the division of the
// pixel index by it is then cheap); 0 takes it from the struct.
template <int WIN_W>
__device__ __forceinline__ int window_width(const Window& t) {
  return WIN_W > 0 ? WIN_W : t.win_w;
}

// Fill the window from the image's planes in device memory: `state` is the
// image's 6 planes, `ro` its 3, each h*w floats apart. L2_ONLY loads past the
// first-level cache, which is not coherent across multiprocessors: for a
// kernel in which other blocks rewrite the planes between two of its reads.
template <int WIN_W, bool L2_ONLY = false>
__device__ __forceinline__ void window_load(const Window& t,
                                            const float* __restrict__ state,
                                            const float* __restrict__ ro) {
  const int ww = window_width<WIN_W>(t);
  const int wpx = t.win_h * ww;
  const size_t hw = (size_t)t.h * t.w;
  for (int idx = threadIdx.x; idx < wpx; idx += blockDim.x) {
    int ly = idx / ww, lx = idx - ly * ww;
    int y = t.y0 + ly, x = t.x0 + lx;
    bool in = (x >= 0 && x < t.w && y >= 0 && y < t.h);
    size_t o = (size_t)y * t.w + x;
    // every load starts before the first store: the loads of a pixel are in
    // flight together, not one after the other behind a store each
    float v[WINDOW_PLANES];
#pragma unroll
    for (int c = 0; c < WINDOW_PLANES; ++c) {
      const float* p = c < 6 ? state + c * hw + o : ro + (c - 6) * hw + o;
      v[c] = !in ? 0.0f : L2_ONLY ? __ldcg(p) : *p;
    }
#pragma unroll
    for (int c = 0; c < WINDOW_PLANES; ++c) t.s[c * wpx + idx] = v[c];
  }
}

// Write the state's six planes of the image rectangle [iy0, iy1) x
// [ix0, ix1) (image coordinates, inside the window and the image) to `dst`.
template <int WIN_W>
__device__ __forceinline__ void window_store(const Window& t,
                                             float* __restrict__ dst, int iy0,
                                             int iy1, int ix0, int ix1) {
  const int ww = window_width<WIN_W>(t);
  const int wpx = t.win_h * ww;
  const size_t hw = (size_t)t.h * t.w;
  const int iw = ix1 - ix0;
  const int ipx = (iy1 - iy0) * iw;
  for (int idx = threadIdx.x; idx < ipx; idx += blockDim.x) {
    int ry = idx / iw, rx = idx - ry * iw;
    int y = iy0 + ry, x = ix0 + rx;
    int l = (y - t.y0) * ww + (x - t.x0);
    size_t o = (size_t)y * t.w + x;
#pragma unroll
    for (int c = 0; c < 6; ++c) dst[c * hw + o] = t.s[c * wpx + l];
  }
}

// Sum of `v` over the block, the same value in every thread, in an order
// that depends on nothing but the block's size. Needs blockDim.x a multiple
// of 32, at most 1024, and all threads.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float red[33];
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s);
  int tid = threadIdx.x;
  __syncthreads();  // red[] may still be read from the previous call
  if ((tid & 31) == 0) red[tid >> 5] = v;
  __syncthreads();
  if (tid < 32) {
    float r = (tid < (int)(blockDim.x >> 5)) ? red[tid] : 0.0f;
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) r += __shfl_down_sync(0xffffffffu, r, s);
    if (tid == 0) red[32] = r;
  }
  __syncthreads();
  return red[32];
}

// First half of an iteration, every pixel of the window that lies in the
// image: u <- u + threshold step + theta * div p, in place (a pixel's new u
// needs its own old u only). Returns this thread's share of the sum of
// |u_new - u|^2 over the image rectangle [iy0, iy1) x [ix0, ix1).
template <int WIN_W, bool ERR = true, bool DIV = true, bool ROLL = true>
__device__ __forceinline__ float window_primal(const Window& t, float l_t,
                                               float theta, int iy0, int iy1,
                                               int ix0, int ix1) {
  const int ww = window_width<WIN_W>(t);
  const int wpx = t.win_h * ww;
  float* u1 = t.s;
  float* u2 = t.s + wpx;
  const float* p11 = t.s + 2 * wpx;
  const float* p12 = t.s + 3 * wpx;
  const float* p21 = t.s + 4 * wpx;
  const float* p22 = t.s + 5 * wpx;
  const float* i1wx = t.s + 6 * wpx;
  const float* i1wy = t.s + 7 * wpx;
  const float* rho_c = t.s + 8 * wpx;
  float local = 0.0f;
  for (int idx = threadIdx.x; idx < wpx; idx += blockDim.x) {
    int ly = idx / ww, lx = idx - ly * ww;
    int y = t.y0 + ly, x = t.x0 + lx;
    if (x < 0 || x >= t.w || y < 0 || y >= t.h) continue;
    float U1 = u1[idx], U2 = u2[idx];
    float d1, d2;
    threshold_step<DIV>(i1wx[idx], i1wy[idx], rho_c[idx], U1, U2, l_t, &d1,
                        &d2);
    // backward-difference divergence: p itself at the image's first
    // row/column; what lies left of or above the window reads as 0
    float q11 = p11[idx], q12 = p12[idx], q21 = p21[idx], q22 = p22[idx];
    float l11 = !ROLL ? q11 : lx > 0 ? p11[idx - 1] : 0.0f;
    float l21 = !ROLL ? q21 : lx > 0 ? p21[idx - 1] : 0.0f;
    float a12 = !ROLL ? q12 : ly > 0 ? p12[idx - ww] : 0.0f;
    float a22 = !ROLL ? q22 : ly > 0 ? p22[idx - ww] : 0.0f;
    float n1, n2;
    primal_update(U1, U2, d1, d2, q11, q12, q21, q22, l11, l21, a12, a22,
                  x > 0, y > 0, theta, &n1, &n2);
    u1[idx] = n1;
    u2[idx] = n2;
    if (ERR && y >= iy0 && y < iy1 && x >= ix0 && x < ix1) {
      float e1 = n1 - U1, e2 = n2 - U2;
      local += e1 * e1 + e2 * e2;
    }
  }
  return local;
}

// Second half: p <- (p + taut * grad u) / (1 + taut * |grad u|) from the new
// u, in place (a pixel's new p needs its own old p only). Forward
// differences are zero at the image's last row/column; beyond the window's
// edge they read as zero too.
template <int WIN_W, bool SQRT = true, bool DIV = true, bool ROLL = true>
__device__ __forceinline__ void window_dual(const Window& t, float taut) {
  const int ww = window_width<WIN_W>(t);
  const int wpx = t.win_h * ww;
  const float* u1 = t.s;
  const float* u2 = t.s + wpx;
  float* p11 = t.s + 2 * wpx;
  float* p12 = t.s + 3 * wpx;
  float* p21 = t.s + 4 * wpx;
  float* p22 = t.s + 5 * wpx;
  for (int idx = threadIdx.x; idx < wpx; idx += blockDim.x) {
    int ly = idx / ww, lx = idx - ly * ww;
    int y = t.y0 + ly, x = t.x0 + lx;
    if (x < 0 || x >= t.w || y < 0 || y >= t.h) continue;
    bool right = (x < t.w - 1) && (lx < ww - 1);
    bool below = (y < t.h - 1) && (ly < t.win_h - 1);
    float c1 = u1[idx], c2 = u2[idx];
    float u1x = right ? (ROLL ? u1[idx + 1] : c1) - c1 : 0.0f;
    float u1y = below ? (ROLL ? u1[idx + ww] : c1) - c1 : 0.0f;
    float u2x = right ? (ROLL ? u2[idx + 1] : c2) - c2 : 0.0f;
    float u2y = below ? (ROLL ? u2[idx + ww] : c2) - c2 : 0.0f;
    dual_update<SQRT, DIV>(u1x, u1y, u2x, u2y, taut, &p11[idx], &p12[idx],
                           &p21[idx], &p22[idx]);
  }
}

// `m` iterations on the window. Returns the sum of |u_new - u|^2 of the
// LAST iteration over the image rectangle [iy0, iy1) x [ix0, ix1), the same
// value in every thread (1 with ERR off: nothing is summed). The caller
// synchronises the block after loading the window; on return the window is
// complete.
template <int WIN_W, bool ERR = true, bool SQRT = true, bool DIV = true,
          bool ROLL = true>
__device__ __forceinline__ float window_iterate(const Window& t, int m,
                                                float l_t, float theta,
                                                float taut, int iy0, int iy1,
                                                int ix0, int ix1) {
  float local = 0.0f;
  for (int it = 0; it < m; ++it) {
    local = window_primal<WIN_W, ERR, DIV, ROLL>(t, l_t, theta, iy0, iy1, ix0,
                                                 ix1);
    __syncthreads();
    window_dual<WIN_W, SQRT, DIV, ROLL>(t, taut);
    __syncthreads();
  }
  return ERR ? block_sum(local) : 1.0f;
}

// Most iterations window_iterate_sums records in one call.
constexpr int MAX_SUMS = 16;

// `m` <= MAX_SUMS iterations on the window that keep EVERY iteration's sum
// of |u_new - u|^2 over the image rectangle: on return sums[j], j < m, holds
// iteration j's, visible to all threads. The arithmetic on the window is
// window_iterate's. A block-wide reduction per iteration would add three
// barriers to each of them; instead each warp leaves its partial of iteration
// j in warp_part[j][warp] (no barrier beyond the iteration's own two), and
// after the loop thread j adds the warps' partials in warp order, so the sums
// depend on nothing but the block's size. `warp_part` is MAX_SUMS x 32 floats
// and `sums` MAX_SUMS floats of shared memory.
template <int WIN_W>
__device__ __forceinline__ void window_iterate_sums(
    const Window& t, int m, float l_t, float theta, float taut, int iy0,
    int iy1, int ix0, int ix1, float* warp_part, float* sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int it = 0; it < m; ++it) {
    float local = window_primal<WIN_W>(t, l_t, theta, iy0, iy1, ix0, ix1);
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
      local += __shfl_down_sync(0xffffffffu, local, s);
    if (lane == 0) warp_part[it * 32 + warp] = local;
    __syncthreads();
    window_dual<WIN_W>(t, taut);
    __syncthreads();
  }
  if ((int)threadIdx.x < m) {
    const int warps = blockDim.x >> 5;
    float s = 0.0f;
    for (int k = 0; k < warps; ++k) s += warp_part[threadIdx.x * 32 + k];
    sums[threadIdx.x] = s;
  }
  __syncthreads();
}

}  // namespace

// out[0] = kernel launches, out[1] = memsets and copies that this library has
// enqueued since it was loaded. Every library that includes this header
// exports it under the same name.
extern "C" void tvl1_enqueued(long long* out) {
  out[0] = g_enqueued[0].load();
  out[1] = g_enqueued[1].load();
}
