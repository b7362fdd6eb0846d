// TV-L1 iteration-ablation kernel for NVIDIA Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU's ablation kernel: tools_kernel_ablate.py, `make_kernel`,
// launched by `run`. Like that kernel it runs the TV-L1 primal-dual iteration
// a FIXED number of times per image (the loop never looks at the error) on
// precomputed warped arrays ro = (i1wx, i1wy, rho_c) and a state (u1, u2,
// p11, p12, p21, p22), with one class of cost compiled out per variant, and
// returns the new state and each image's error sum of the last iteration.
// Timing two iteration counts and dividing the difference gives each
// variant's cost per iteration; the differences between variants say what
// the iteration spends on the error reduction, the square roots, the
// divisions and the neighbour exchange on this card.
//
// What bounds it. The function is 63 float operations a pixel and
// iteration, and 15 floats a pixel through device memory per launch. Its
// earlier form (the chunk kernel's shared-memory window, which is still how
// tvl1_common.cuh's window code runs A, B and C) recomputed 1.875 pixels for
// every one kept (48 x 80 windows, 8 iterations a launch), re-derived each
// pixel's window coordinates by division and made ~29 four-byte
// shared-memory accesses a pixel and iteration, with one 1,024-thread block
// a multiprocessor that loaded, iterated and stored in turn. On this card the
// iteration itself is the larger cost: each of its five IEEE divisions and
// two square roots is a dependent chain (MUFU, then four or five FFMA, then
// a check that branches to the slow path), and each is its own branch
// region, so a warp's rows do not overlap. The kernel is bound by
// dispatching that chain and waiting out its latency at 24-32 warps a
// multiprocessor, then by device memory at 4 iterations a launch (PERF.md,
// section 6).
//
// The design:
// * The state lives in registers for the launch. A block is 24 warps stacked
//   vertically over a window 32 columns wide and 96 rows tall; a lane owns
//   one column, a thread a run of 4 rows of it (its six state planes are 24
//   registers, 80 in all: one block of 768 threads a multiprocessor).
// * Neighbours: the pixel above / below is the thread's own register, except
//   at its run's first / last row, whose neighbour is the next warp's edge
//   row, exchanged through a small shared buffer; the pixel left / right is
//   the adjacent lane's, by __shfl_up_sync / __shfl_down_sync. No division,
//   no index arithmetic a pixel, no ragged last pass; the three fixed planes
//   are read from shared memory once a pixel and iteration, conflict-free.
// * One block barrier a half-iteration (after a warp publishes its edge
//   row), none for the error: each iteration's sum of |u_new - u|^2 is
//   reduced within the warp by shuffles and left in a shared slot, as the
//   level grid's exact exit does; after the last iteration thread 0 adds
//   the warps' slots in order.
// * Persistent blocks, the load under the iterations: a block walks the
//   launch's items (a tile of an image) with a stride of the grid, and while
//   it iterates one item, cp.async copies the next item's window into shared
//   memory (16-byte copies that bypass L1 where the image's rows and the
//   window's first column are 16-byte aligned, 4-byte ones else; zero-fill
//   outside the image): 6 state planes and a second set of 3 fixed planes,
//   156 KB with the edge rows.
// * Pixels outside the image are skipped, as the window code skips them:
//   besides the wasted work, their zeros would send the square root of 0
//   down its slow path (the range check before it in the machine code).
// * Halo: K = 4 iterations a launch (of the halos tried, the fastest: the
//   32-column window keeps 24, and device memory is read again every K
//   iterations), so a window keeps its 88 x 24 inner tile; ceil(m / 4)
//   launches a call. The launch is the only grid-wide synchronisation: a
//   tile's neighbours read its old values as their halo, so the state
//   ping-pongs between two buffers.
// * Each image's error is added by the last of its items to finish the last
//   launch (a ticket counted with atomicAdd after a fence): one warp reads
//   the tiles' sums in tile order (strided per lane, then shuffles), so a
//   rerun gives the same bits. No separate kernel.
//
// The per-pixel arithmetic is tvl1_common.cuh's `threshold_step`,
// `primal_update` and `dual_update`, the functions the window code of A, B
// and C calls (only the forward differences, a subtraction each, are
// written here again): with
// every switch on the result equals the chunk kernel (tvl1_chunk with the
// exit disabled) bit for bit. The four switches are template parameters, so
// a variant's machine code really holds no reduction / square root /
// division / exchange:
//   ERR   the per-iteration sum, its warp reduction and the image sums
//   SQRT  the two square roots of the dual norms (off: the squared norm)
//   DIV   the five divisions (off: multiplications by the same operand)
//   ROLL  the neighbour reads (off: the pixel itself) and the exchange that
//         serves them: shuffles, edge rows and the two barriers of an
//         iteration
// Each variant still stores its state, and writes a value per image, so the
// compiler cannot remove the loop.

#include "tvl1_common.cuh"

namespace {

constexpr int ABLATE_K = 4;  // halo = most iterations per launch
constexpr int RUN = 4;       // rows a thread owns
constexpr int WARPS = 24;    // warps of a block, stacked vertically
constexpr int ABLATE_THREADS = 32 * WARPS;
constexpr int WIN_W = 32;  // one column a lane
constexpr int WIN_H = RUN * WARPS;
constexpr int TILE_W = WIN_W - 2 * ABLATE_K;
constexpr int TILE_H = WIN_H - 2 * ABLATE_K;
constexpr unsigned FULL_MASK = 0xffffffffu;

struct AblateShared {
  float state[6][WIN_H][WIN_W];     // the next item's state, in flight
  float fixed[2][3][WIN_H][WIN_W];  // i1wx, i1wy, rho_c: this item's, next
  float p_edge[2][WARPS][32];       // each warp's last row of p12, p22
  float u_edge[2][WARPS][32];       // each warp's first row of the new u
  float warp_err[WARPS];            // each warp's sum of the last iteration
  int last_block;                   // this item finished its image last
};

// 4 bytes from device to shared memory, asynchronously; zeros where `in` is
// false (nothing is read then).
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0));
}

// An item is one tile of one image: item = image * tiles + tile.
struct Item {
  int n, tile;
  int iy0, iy1, ix0, ix1;  // the tile, image coordinates
  int x, y0;               // this thread's column and first row
};

__device__ __forceinline__ Item item_at(int item, int tiles, int tiles_x,
                                        int h, int w) {
  Item t;
  t.n = item / tiles;
  t.tile = item - t.n * tiles;
  const int ty = t.tile / tiles_x, tx = t.tile - ty * tiles_x;
  t.iy0 = ty * TILE_H;
  t.ix0 = tx * TILE_W;
  t.iy1 = min(t.iy0 + TILE_H, h);
  t.ix1 = min(t.ix0 + TILE_W, w);
  t.x = t.ix0 - ABLATE_K + (threadIdx.x & 31);
  t.y0 = t.iy0 - ABLATE_K + (threadIdx.x >> 5) * RUN;
  return t;
}

// 16 bytes, bypassing the first-level cache; zeros where `in` is false.
__device__ __forceinline__ void copy_async16(float* dst, const float* src,
                                             bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0));
}

// Start copying an item's window into `state` and `fixed[slot]`, zeros
// outside the image. `vec`: 16-byte copies (the image's rows and the
// window's first column are 16-byte aligned, so four pixels are all in the
// image or all out); a warp copies its RUN rows of the 9 planes, 8 copies a
// row. Else 9 x RUN four-byte copies a thread.
__device__ __forceinline__ void prefetch(AblateShared& sh, int slot,
                                         const Item& t,
                                         const float* __restrict__ ro,
                                         const float* __restrict__ state,
                                         int h, int w, bool vec) {
  const int lane = threadIdx.x & 31, ly0 = (threadIdx.x >> 5) * RUN;
  const size_t hw = (size_t)h * w;
  const float* st = state + (size_t)t.n * 6 * hw;
  const float* fx = ro + (size_t)t.n * 3 * hw;
  if (vec) {
    const int x0 = t.x - lane;  // the window's first column
    constexpr int CHUNKS = 9 * RUN * (WIN_W / 4);
#pragma unroll
    for (int c = lane; c < CHUNKS; c += 32) {
      const int pr = c / (WIN_W / 4), q = c - pr * (WIN_W / 4);
      const int plane = pr / RUN, r = pr - plane * RUN;
      const int y = t.y0 + r, x = x0 + 4 * q;
      const bool in = y >= 0 && y < h && x >= 0 && x < w;
      const size_t o = in ? (size_t)y * w + x : 0;
      float* dst = plane < 6 ? &sh.state[plane][ly0 + r][4 * q]
                             : &sh.fixed[slot][plane - 6][ly0 + r][4 * q];
      const float* src = plane < 6 ? st + plane * hw + o
                                   : fx + (plane - 6) * hw + o;
      copy_async16(dst, src, in);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    return;
  }
  const bool col_in = t.x >= 0 && t.x < w;
#pragma unroll
  for (int r = 0; r < RUN; ++r) {
    const int y = t.y0 + r;
    const bool in = col_in && y >= 0 && y < h;
    const size_t o = in ? (size_t)y * w + t.x : 0;
#pragma unroll
    for (int c = 0; c < 6; ++c)
      copy_async(&sh.state[c][ly0 + r][lane], st + c * hw + o, in);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      copy_async(&sh.fixed[slot][c][ly0 + r][lane], fx + c * hw + o, in);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Persistent: block b takes items b, b + gridDim.x, ... . tile_errs is (n,
// tiles + 1): the tiles' sums, then the count of the image's items that have
// finished (an unsigned in float storage, zero at the start and left zero).
// `errs` is null but in the last launch of a call.
template <bool ERR, bool SQRT, bool DIV, bool ROLL>
__global__ void __launch_bounds__(ABLATE_THREADS, 1)
    ablate_kernel(const float* __restrict__ ro, const float* __restrict__ state,
                  float* __restrict__ out, float* __restrict__ tile_errs,
                  float* __restrict__ errs, int n_images, int h, int w,
                  int tiles_x, int tiles, int m, float l_t, float theta,
                  float taut, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  AblateShared& sh = *reinterpret_cast<AblateShared*>(smem_raw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ly0 = warp * RUN;  // this thread's first row, in the window
  const size_t hw = (size_t)h * w;
  const int items = n_images * tiles;
  int item = blockIdx.x;
  if (item < items)
    prefetch(sh, 0, item_at(item, tiles, tiles_x, h, w), ro, state, h, w,
             vec);
  for (int slot = 0; item < items; item += gridDim.x, slot ^= 1) {
    const Item t = item_at(item, tiles, tiles_x, h, w);
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();  // the item's window has landed, for every thread

    // Pixels outside the image hold zeros and are skipped below, as the
    // window code skips them: no pixel of the image reads them (the borders
    // are those of the real h x w).
    float u1[RUN], u2[RUN], p11[RUN], p12[RUN], p21[RUN], p22[RUN];
#pragma unroll
    for (int r = 0; r < RUN; ++r) {
      u1[r] = sh.state[0][ly0 + r][lane];
      u2[r] = sh.state[1][ly0 + r][lane];
      p11[r] = sh.state[2][ly0 + r][lane];
      p12[r] = sh.state[3][ly0 + r][lane];
      p21[r] = sh.state[4][ly0 + r][lane];
      p22[r] = sh.state[5][ly0 + r][lane];
    }
    __syncthreads();  // the state buffer is free: fetch the next item
    if (item + (int)gridDim.x < items)
      prefetch(sh, slot ^ 1,
               item_at(item + gridDim.x, tiles, tiles_x, h, w), ro, state,
               h, w, vec);
    const float(*fixed)[WIN_H][WIN_W] = sh.fixed[slot];

    const bool col_in = t.x >= 0 && t.x < w;
    const bool col_in_tile = t.x >= t.ix0 && t.x < t.ix1;
    // the forward difference to the right is zero at the image's last
    // column and at the window's
    const bool right = t.x < w - 1 && lane < 31;
    for (int it = 0; it < m; ++it) {
      // --- u <- u + threshold step + theta * div p
      float above12 = 0.0f, above22 = 0.0f;  // above the window: 0
      if (ROLL) {
        sh.p_edge[0][warp][lane] = p12[RUN - 1];
        sh.p_edge[1][warp][lane] = p22[RUN - 1];
        __syncthreads();
        if (warp > 0) {
          above12 = sh.p_edge[0][warp - 1][lane];
          above22 = sh.p_edge[1][warp - 1][lane];
        }
      }
      float local = 0.0f;
#pragma unroll
      for (int r = 0; r < RUN; ++r) {
        float l11 = p11[r], l21 = p21[r], a12 = p12[r], a22 = p22[r];
        if (ROLL) {
          // left of the window: 0
          l11 = __shfl_up_sync(FULL_MASK, p11[r], 1);
          l21 = __shfl_up_sync(FULL_MASK, p21[r], 1);
          if (lane == 0) l11 = l21 = 0.0f;
          a12 = r > 0 ? p12[r > 0 ? r - 1 : 0] : above12;
          a22 = r > 0 ? p22[r > 0 ? r - 1 : 0] : above22;
        }
        const int y = t.y0 + r;
        if (!(col_in && y >= 0 && y < h)) continue;
        float d1, d2, n1, n2;
        threshold_step<DIV>(fixed[0][ly0 + r][lane], fixed[1][ly0 + r][lane],
                            fixed[2][ly0 + r][lane], u1[r], u2[r], l_t, &d1,
                            &d2);
        primal_update(u1[r], u2[r], d1, d2, p11[r], p12[r], p21[r], p22[r],
                      l11, l21, a12, a22, t.x > 0, y > 0, theta, &n1, &n2);
        if (ERR && col_in_tile && y >= t.iy0 && y < t.iy1) {
          float e1 = n1 - u1[r], e2 = n2 - u2[r];
          local += e1 * e1 + e2 * e2;
        }
        u1[r] = n1;
        u2[r] = n2;
      }
      if (ERR) {
#pragma unroll
        for (int s = 16; s > 0; s >>= 1)
          local += __shfl_down_sync(FULL_MASK, local, s);
        if (lane == 0) sh.warp_err[warp] = local;
      }

      // --- p <- (p + taut * grad u) / (1 + taut * |grad u|)
      float below1 = 0.0f, below2 = 0.0f;
      if (ROLL) {
        sh.u_edge[0][warp][lane] = u1[0];
        sh.u_edge[1][warp][lane] = u2[0];
        __syncthreads();
        if (warp < WARPS - 1) {
          below1 = sh.u_edge[0][warp + 1][lane];
          below2 = sh.u_edge[1][warp + 1][lane];
        }
      }
#pragma unroll
      for (int r = 0; r < RUN; ++r) {
        float r1 = u1[r], r2 = u2[r], b1 = u1[r], b2 = u2[r];
        if (ROLL) {
          r1 = __shfl_down_sync(FULL_MASK, u1[r], 1);
          r2 = __shfl_down_sync(FULL_MASK, u2[r], 1);
          b1 = r < RUN - 1 ? u1[r < RUN - 1 ? r + 1 : r] : below1;
          b2 = r < RUN - 1 ? u2[r < RUN - 1 ? r + 1 : r] : below2;
        }
        const int y = t.y0 + r;
        if (!(col_in && y >= 0 && y < h)) continue;
        // zero at the image's last row and at the window's
        const bool below = y < h - 1 && ly0 + r < WIN_H - 1;
        const float u1x = right ? r1 - u1[r] : 0.0f;
        const float u1y = below ? b1 - u1[r] : 0.0f;
        const float u2x = right ? r2 - u2[r] : 0.0f;
        const float u2y = below ? b2 - u2[r] : 0.0f;
        dual_update<SQRT, DIV>(u1x, u1y, u2x, u2y, taut, &p11[r], &p12[r],
                               &p21[r], &p22[r]);
      }
    }

    // the tile's rows: exact after m <= K iterations
    float* dst = out + (size_t)t.n * 6 * hw;
#pragma unroll
    for (int r = 0; r < RUN; ++r) {
      const int y = t.y0 + r;
      if (col_in_tile && y >= t.iy0 && y < t.iy1) {
        const size_t o = (size_t)y * w + t.x;
        dst[o] = u1[r];
        dst[hw + o] = u2[r];
        dst[2 * hw + o] = p11[r];
        dst[3 * hw + o] = p12[r];
        dst[4 * hw + o] = p21[r];
        dst[5 * hw + o] = p22[r];
      }
    }
    if (errs == nullptr) continue;  // not the call's last launch
    if (!ERR) {
      // nothing was summed: the image's value is 1, as in the TPU tool
      if (t.tile == 0 && threadIdx.x == 0) errs[t.n] = 1.0f;
      continue;
    }
    float* row = tile_errs + (size_t)t.n * (tiles + 1);
    unsigned* done = reinterpret_cast<unsigned*>(row + tiles);
    __syncthreads();  // every warp's slot is written
    if (threadIdx.x == 0) {
      float s = 0.0f;
      for (int k = 0; k < WARPS; ++k) s += sh.warp_err[k];
      row[t.tile] = s;
      __threadfence();  // the sum is visible before the ticket is taken
      sh.last_block = atomicAdd(done, 1u) == (unsigned)(tiles - 1);
    }
    __syncthreads();
    if (sh.last_block && warp == 0) {
      // the image's last item: its tiles' sums in a fixed order
      __threadfence();
      float s = 0.0f;
      for (int k = lane; k < tiles; k += 32) s += __ldcg(&row[k]);
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) s += __shfl_down_sync(FULL_MASK, s, d);
      if (lane == 0) {
        errs[t.n] = s;
        *done = 0u;  // ready for the next call
      }
    }
  }
}

template <bool ERR, bool SQRT, bool DIV, bool ROLL>
int run_variant(const float* ro, const float* state, float* out,
                float* scratch, float* tile_errs, float* errs, int n, int h,
                int w, int m, float l_t, float theta, float taut,
                cudaStream_t stream) {
  auto kernel = ablate_kernel<ERR, SQRT, DIV, ROLL>;
  const int bytes = (int)sizeof(AblateShared);
  // the size is a constant of the kernel: no call lowers it
  CHECK_CALL(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  int dev = 0, sms = 0, per_sm = 0;
  CHECK_CALL(cudaGetDevice(&dev));
  CHECK_CALL(
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  CHECK_CALL(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, ABLATE_THREADS, bytes));
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  const int tiles_x = (w + TILE_W - 1) / TILE_W;
  const int tiles_y = (h + TILE_H - 1) / TILE_H;
  const int tiles = tiles_x * tiles_y;
  const long long items = (long long)n * tiles;
  const long long resident = (long long)sms * per_sm;
  const int blocks = (int)(items < resident ? items : resident);
  const int launches = (m + ABLATE_K - 1) / ABLATE_K;
  // 16-byte copies where every row of every plane starts 16-byte aligned
  // and a window's first column does too
  auto aligned = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  const bool vec = w % 4 == 0 && TILE_W % 4 == 0 && ABLATE_K % 4 == 0 &&
                   aligned(ro) && aligned(state) && aligned(out) &&
                   (scratch == nullptr || aligned(scratch));
  const float* src = state;
  for (int i = 0; i < launches; ++i) {
    // the last launch writes `out` and the errors; the ones before it
    // alternate
    const bool last = i == launches - 1;
    float* dst = ((launches - 1 - i) % 2 == 0) ? out : scratch;
    const int mi = min(ABLATE_K, m - i * ABLATE_K);
    kernel<<<blocks, ABLATE_THREADS, bytes, stream>>>(
        ro, src, dst, tile_errs, last ? errs : nullptr, n, h, w, tiles_x,
        tiles, mi, l_t, theta, taut, vec);
    CHECK_LAUNCH();
    src = dst;
  }
  return 0;
}

}  // namespace

extern "C" {

// The geometry the wrapper allocates and emulates by.
int tvl1_ablate_k() { return ABLATE_K; }
int tvl1_ablate_tile_h() { return TILE_H; }
int tvl1_ablate_tile_w() { return TILE_W; }
// Shared memory a block of the kernel holds (all of it static).
int tvl1_ablate_smem_bytes() { return (int)sizeof(AblateShared); }

// Enqueue m iterations of one variant on `stream`: ceil(m / 4) launches of
// the kernel, the last of which also adds each image's error. All pointers
// are device memory:
//   ro        : (n, 3, h, w) float32, read only
//   state     : (n, 6, h, w) float32, read only
//   out       : (n, 6, h, w) float32, the result
//   scratch   : (n, 6, h, w) float32, the other ping-pong buffer (may be
//               null when m <= 4)
//   tile_errs : (n, ceil(h/88) * ceil(w/24) + 1) float32 scratch, ZERO-
//               filled at the first call (the last slot of a row counts
//               blocks; the kernel leaves it zero again)
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
  const long long tiles = (long long)((w + TILE_W - 1) / TILE_W) *
                          ((h + TILE_H - 1) / TILE_H);
  if (tiles * n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
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
