// Stand-in for the CUDA runtime header, so that a kernel source from
// desmo_tpu_torch/csrc compiles with a host C++ compiler and runs on an
// emulated grid (harness.inc): one OS thread per CUDA thread, a barrier per
// block for __syncthreads(), blocks run one after another. It checks the
// kernels' indexing, masking and reductions on a machine without a GPU; it
// says nothing about their speed.
#pragma once
#include <barrier>
#include <cmath>

#define __global__
#define __shared__ static  // blocks run one at a time, so one copy serves each
#define __launch_bounds__(x)
#define __align__(n) __attribute__((aligned(n)))

struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct uint3 { unsigned x, y, z; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
typedef struct CUstream_st* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };

constexpr int kEmulatedSMs = 132;  // an H100 SXM
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = kEmulatedSMs;
  return cudaSuccess;
}

extern thread_local uint3 threadIdx;
extern uint3 blockIdx, blockDim;
extern std::barrier<>* emulated_block_barrier;
inline void __syncthreads() { emulated_block_barrier->arrive_and_wait(); }
inline int min(int a, int b) { return a < b ? a : b; }
