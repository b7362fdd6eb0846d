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
// memory once (32 banks x 4 B a clock); the time is the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void fill_mean_kernel(const float* __restrict__ x,
                                 float* __restrict__ means, int count) {
  extern __shared__ float scratch[];
  const float v = x[0];
  for (int i = threadIdx.x; i < count; i += blockDim.x) scratch[i] = v;
  __syncthreads();
  float s = 0.0f;
  for (int i = threadIdx.x; i < count; i += blockDim.x) s += scratch[i];
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

}  // namespace

extern "C" {

// Ask for `n_bytes` of dynamic shared memory, launch `blocks` blocks of
// `threads` threads on `stream` and wait for them.
//   x      : (1) float32 device memory, the fill value
//   means  : (blocks) float32 device memory, each block's mean
//   status : (3) int32 HOST memory: the CUDA status of the attribute call, of
//            the launch and of the synchronisation (0 = success). A refused
//            attribute is not launched (status[1] = status[2] = -1).
// A refused launch leaves no sticky error: the code is read and cleared.
// n_bytes is a multiple of 4, at least 4 * threads / 32; threads a multiple
// of 32 up to 1024. Returns 0, or cudaErrorInvalidValue for bad arguments.
int smem_fill_mean(long long n_bytes, const float* x, float* means,
                   int blocks, int threads, int cooperative, int* status,
                   void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (n_bytes < 4 * (threads / 32) || n_bytes % 4 != 0 ||
      n_bytes > 0x7fffffffLL || blocks < 1 || threads < 32 ||
      threads > 1024 || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  status[1] = status[2] = -1;
  status[0] = (int)cudaFuncSetAttribute(
      fill_mean_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)n_bytes);
  if (status[0] != 0) {
    cudaGetLastError();
    return 0;
  }
  int count = (int)(n_bytes / 4);
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
  if (status[1] != 0) return 0;
  status[2] = (int)cudaStreamSynchronize(stream);
  return 0;
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
