// Stand-in for the CUDA runtime header, so that a kernel source from
// desmo_tpu_torch/csrc compiles with a host C++ compiler and runs on an
// emulated grid (harness.inc): one OS thread per CUDA thread, a barrier per
// block for __syncthreads(), blocks run one after another, each with its
// dynamic shared memory (shared_base()) and, per warp, the barrier and
// scratch that the mma.sync stand-in needs (mma_emulated.h). It checks the
// kernels' indexing, masking and reductions on a machine without a GPU; it
// says nothing about their speed. The entry points compile but are never
// called: the harness runs the kernel functions itself.
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>

#define DESMO_EMULATED_GRID 1
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static  // blocks run one at a time, so one copy serves each
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))

struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct uint3 { unsigned x, y, z; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
typedef struct CUstream_st* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorNotSupported = 801 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };

constexpr int kEmulatedSMs = 132;  // an H100 SXM
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = kEmulatedSMs;
  return cudaSuccess;
}
inline cudaError_t cudaFuncSetAttribute(const void*, cudaFuncAttribute, int) { return cudaErrorNotSupported; }

extern thread_local uint3 threadIdx;
extern uint3 blockIdx;
extern dim3 blockDim, gridDim;
extern std::barrier<>* emulated_block_barrier;
extern float* emulated_smem;
inline void __syncthreads() { emulated_block_barrier->arrive_and_wait(); }
inline float* shared_base() { return emulated_smem; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

#include "mma_emulated.h"
