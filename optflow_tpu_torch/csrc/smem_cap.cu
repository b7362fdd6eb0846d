// Shared-memory capacity probe for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the TPU's on-chip capacity probe: tools/probes/r4_vmem_cap.py,
// `try_mb`. Like that probe, one kernel fills a requested amount of on-chip
// scratch with a scalar read from device memory, sums it and returns the
// mean, and the tool built on it reports the largest amount that is granted
// AND runs. On this card the scratch is a thread block's dynamic shared
// memory: above 48 KB it has to be asked for with
// cudaFuncAttributeMaxDynamicSharedMemorySize, and a size the card cannot
// give is refused either there or at the launch. Both status codes are the
// probe's result and are RETURNED, not raised.
//
// The kernel has no static shared memory (it would come off the block's
// limit), so its reduction reuses the dynamic array. The sum's order depends
// on the block's size only: every thread adds its strided elements, a warp
// adds by shuffles, thread 0 adds the warps' sums in order.
//
// With `blocks` > 1 every block does the same and writes its own mean. With
// `cooperative` the grid is launched with cudaLaunchCooperativeKernel, which
// the runtime refuses (cudaErrorCooperativeLaunchTooLarge) unless all blocks
// can be resident at once: the tool uses it to show that the occupancy the
// runtime reports for a size really holds.
//
// What bounds it: one block writes and reads n_bytes of one SM's shared
// memory once, at 32 banks x 4 B a clock (1.8 us for 227 KB); a launch costs
// more. The earlier form of this probe filled and read 4 bytes a thread and
// access, and set the size attribute, launched, synchronised and allocated
// on every call, so that only its call was timed (0.040 ms), never the
// kernel. Here:
// * the fill and the sum move 16 B a thread and access (float4), consecutive
//   threads on consecutive 16 B: a warp's access is four conflict-free
//   128 B wavefronts, a quarter of the instructions; a scalar tail takes the
//   last n_bytes % 16;
// * two CUDA events on the stream bracket the launch, and the call returns
//   their elapsed time beside the statuses: the kernel's own time, with the
//   launch's latency on the card but not the host's round trip. The call
//   synchronises anyway, so reading the time adds no wait, and the events
//   are made once a device and kept; but each record is a driver call that
//   puts a command on the stream, so the two add host time to every call
//   (PERF.md, section 6). They stay inside the call because the kernel is
//   timed call by call;
// * the size attribute is set only when the size (or the device) differs
//   from the last one that was granted, under a lock held to the launch, as
//   g_smem_attr_mutex does for the level kernels; a refused size is never
//   cached, so it is asked for, and its status returned, every time.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

__global__ void fill_mean_kernel(const float* __restrict__ x,
                                 float* __restrict__ means, int count) {
  extern __shared__ float4 scratch4[];
  float* scratch = reinterpret_cast<float*>(scratch4);
  const float v = x[0];
  const int quads = count >> 2;
  const float4 v4 = make_float4(v, v, v, v);
  for (int i = threadIdx.x; i < quads; i += blockDim.x) scratch4[i] = v4;
  for (int i = 4 * quads + threadIdx.x; i < count; i += blockDim.x)
    scratch[i] = v;
  __syncthreads();
  float s = 0.0f;
  for (int i = threadIdx.x; i < quads; i += blockDim.x) {
    const float4 q = scratch4[i];
    s += q.x;
    s += q.y;
    s += q.z;
    s += q.w;
  }
  for (int i = 4 * quads + threadIdx.x; i < count; i += blockDim.x)
    s += scratch[i];
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) s += __shfl_down_sync(0xffffffffu, s, d);
  __syncthreads();  // every read of the fill is done: reuse the array
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int k = 0; k < (int)(blockDim.x >> 5); ++k) total += scratch[k];
    means[blockIdx.x] = total / (float)count;
  }
}

// The size the kernel's attribute was last granted, and on which device;
// held from the attribute to the launch. The two timing events of each
// device, created at its first call and kept (an event belongs to the
// device it was created on); under the same lock.
std::mutex g_attr_mutex;
int g_attr_device = -1;
long long g_attr_bytes = -1;
constexpr int MAX_DEVICES = 64;
cudaEvent_t g_events[MAX_DEVICES][2];

}  // namespace

extern "C" {

// Ask for `n_bytes` of dynamic shared memory, launch `blocks` blocks of
// `threads` threads on `stream` and wait for them.
//   x         : (1) float32 device memory, the fill value
//   means     : (blocks) float32 device memory, each block's mean
//   status    : (3) int32 HOST memory: the CUDA status of the attribute call,
//               of the launch and of the synchronisation (0 = success). A
//               refused attribute is not launched (status[1] = status[2] =
//               -1). The attribute is only set when the size differs from
//               the last one granted; a size already granted reads 0.
//   kernel_ms : (1) float32 HOST memory: milliseconds between two events
//               recorded on `stream` before and after the launch, when all
//               three statuses are 0 (else left as it is)
// A refused launch leaves no sticky error: the code is read and cleared.
// n_bytes is a multiple of 4, at least 4 * threads / 32; threads a multiple
// of 32 up to 1024. Returns 0, or a CUDA error code for bad arguments or a
// failure outside the probe (the device, the events).
int smem_fill_mean(long long n_bytes, const float* x, float* means,
                   int blocks, int threads, int cooperative, int* status,
                   float* kernel_ms, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (n_bytes < 4 * (threads / 32) || n_bytes % 4 != 0 ||
      n_bytes > 0x7fffffffLL || blocks < 1 || threads < 32 ||
      threads > 1024 || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  std::lock_guard<std::mutex> hold(g_attr_mutex);
  status[0] = 0;
  status[1] = status[2] = -1;
  if (dev != g_attr_device || n_bytes != g_attr_bytes) {
    status[0] = (int)cudaFuncSetAttribute(
        fill_mean_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)n_bytes);
    if (status[0] != 0) {
      cudaGetLastError();
      return 0;
    }
    g_attr_device = dev;
    g_attr_bytes = n_bytes;
  }
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  cudaEvent_t* ev = g_events[dev];
  for (int k = 0; k < 2; ++k) {
    if (ev[k] == nullptr) {
      e = cudaEventCreate(&ev[k]);
      if (e != cudaSuccess) {
        ev[k] = nullptr;
        return (int)e;
      }
    }
  }
  int count = (int)(n_bytes / 4);
  e = cudaEventRecord(ev[0], stream);
  if (e == cudaSuccess) {
    if (cooperative) {
      void* args[] = {(void*)&x, (void*)&means, (void*)&count};
      status[1] = (int)cudaLaunchCooperativeKernel(
          (const void*)fill_mean_kernel, dim3(blocks), dim3(threads), args,
          (size_t)n_bytes, stream);
      cudaGetLastError();
    } else {
      fill_mean_kernel<<<blocks, threads, (size_t)n_bytes, stream>>>(x, means,
                                                                     count);
      status[1] = (int)cudaGetLastError();
    }
    if (status[1] == 0) {
      e = cudaEventRecord(ev[1], stream);
      status[2] = (int)cudaStreamSynchronize(stream);
      if (e == cudaSuccess && status[2] == 0)
        e = cudaEventElapsedTime(kernel_ms, ev[0], ev[1]);
    }
  }
  return status[2] > 0 ? 0 : (int)e;
}

// Blocks of `threads` threads and `n_bytes` of dynamic shared memory that
// the runtime says fit one SM at once; -1 - (CUDA error) on failure.
int smem_occupancy(long long n_bytes, int threads) {
  int blocks = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, fill_mean_kernel, threads, (size_t)n_bytes);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return -1 - (int)e;
  }
  return blocks;
}

// out[0] = cudaDevAttrMaxSharedMemoryPerBlockOptin,
// out[1] = cudaDevAttrMaxSharedMemoryPerMultiprocessor,
// out[2] = cudaDevAttrMultiProcessorCount,
// out[3] = cudaDevAttrMaxSharedMemoryPerBlock (without the opt-in),
// out[4] = cudaDevAttrClockRate (kHz), of the current device.
int smem_device_attrs(int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const cudaDeviceAttr attrs[5] = {
      cudaDevAttrMaxSharedMemoryPerBlockOptin,
      cudaDevAttrMaxSharedMemoryPerMultiprocessor,
      cudaDevAttrMultiProcessorCount, cudaDevAttrMaxSharedMemoryPerBlock,
      cudaDevAttrClockRate};
  for (int i = 0; i < 5; ++i) {
    e = cudaDeviceGetAttribute(&out[i], attrs[i], dev);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

const char* smem_cap_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
