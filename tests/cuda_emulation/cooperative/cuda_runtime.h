// Stand-in for the CUDA runtime header, so that a kernel source from
// desmo_tpu_torch/csrc that is launched cooperatively compiles with a host
// C++ compiler and runs on an emulated grid (harness.inc): one OS thread per
// CUDA thread, all blocks at once, a barrier per block for __syncthreads()
// and one for the whole grid (cooperative_groups.h). Dynamic shared memory
// is one buffer per block. It checks the kernel's indexing, phases and
// reductions on a machine without a GPU; it says nothing about its speed.
// The launch API is declared so that the entry points compile; the harness
// runs the kernel function itself and never calls them. The primitives of
// desmo_tpu_torch/csrc/tile_mma.cuh and col_mma.cuh take their stand-ins
// from ../mma_emulated.h (cp.async a plain copy, mma.sync through a
// per-warp scratch and barrier that the harness sets for each thread).
#pragma once
#include <barrier>
#include <chrono>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <math.h>

#define DESMO_EMULATED_GRID 1
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)

struct float4 { float x, y, z, w; };
struct uint3 { unsigned x, y, z; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
typedef struct CUstream_st* cudaStream_t;
enum cudaError_t {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorInvalidConfiguration = 9,
  cudaErrorNotSupported = 801,
};
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16, cudaDevAttrCooperativeLaunch = 95 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };

extern thread_local uint3 threadIdx, blockIdx;
extern dim3 gridDim;
extern thread_local std::barrier<>* emulated_block_barrier;
extern thread_local float* emulated_smem;

inline void __syncthreads() { emulated_block_barrier->arrive_and_wait(); }
inline float* shared_base() { return emulated_smem; }
inline unsigned long long globaltimer_ns() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch()).count();
}
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int*, cudaDeviceAttr, int) { return cudaErrorNotSupported; }
inline cudaError_t cudaFuncSetAttribute(const void*, cudaFuncAttribute, int) { return cudaErrorNotSupported; }
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int*, const void*, int, size_t) {
  return cudaErrorNotSupported;
}
inline cudaError_t cudaLaunchCooperativeKernel(const void*, dim3, dim3, void**, size_t, cudaStream_t) {
  return cudaErrorNotSupported;
}

#include "../mma_emulated.h"
