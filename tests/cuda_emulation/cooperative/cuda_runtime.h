// Stand-in for the CUDA runtime header, so that a kernel source from
// desmo_tpu_torch/csrc that is launched cooperatively compiles with a host
// C++ compiler and runs on an emulated grid (harness.inc): one OS thread per
// CUDA thread, all blocks at once, a barrier per block for __syncthreads()
// and one for the whole grid (cooperative_groups.h). Dynamic shared memory
// is one buffer per block. It checks the kernel's indexing, phases and
// reductions on a machine without a GPU; it says nothing about its speed.
// The launch API is declared so that the entry points compile; the harness
// runs the kernel function itself and never calls them. The primitives of
// desmo_tpu_torch/csrc/tile_mma.cuh have stand-ins with the hardware's
// semantics: cp.async is a plain copy (its groups complete at once), and
// mma.sync m16n8k8 TF32 gathers the 32 lanes' fragments through a per-warp
// scratch and a barrier over the warp's threads (the harness sets both for
// each thread), rounds the operands to TF32 as cvt.rna.tf32.f32 does, and
// gives each lane its own accumulator entries.
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

// cp.async: the copy happens at once; a copy whose source is out of range fills zeros
inline void cp_async16(float* dst, const float* src, bool valid) {
  for (int i = 0; i < 4; ++i) dst[i] = valid ? src[i] : 0.f;
}
inline void cp_async_commit() {}
template <int N>
inline void cp_async_wait() {}

inline float f32_bits(unsigned u) {
  float f;
  std::memcpy(&f, &u, sizeof f);
  return f;
}

inline unsigned u32_bits(float x) {
  unsigned u;
  std::memcpy(&u, &x, sizeof u);
  return u;
}

// rounded fp32 product and difference (ISO C++ does not fuse them)
inline float fmul_rn(float a, float b) { return a * b; }
inline float fsub_rn(float a, float b) { return a - b; }

// cvt.rna.tf32.f32: 10 mantissa bits, to nearest with ties away from zero
// (the emulated mma.sync rounds its operands so)
inline unsigned tf32_rna(float x) {
  unsigned u;
  std::memcpy(&u, &x, sizeof u);
  if ((u & 0x7f800000u) == 0x7f800000u) return u;  // inf and NaN pass
  return (u + 0x1000u) & 0xffffe000u;
}

// A warp's barrier and its fragment scratch (2 slots of 32 lanes x 6
// floats, used in turns, so one barrier per product suffices), set by the
// harness for each thread; the count of products this thread has issued.
inline thread_local std::barrier<>* emulated_warp_barrier = nullptr;
inline thread_local float* emulated_warp_scratch = nullptr;
inline thread_local unsigned emulated_warp_products = 0;
constexpr int kEmulatedWarpScratch = 2 * 32 * 6;

// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, d += a b: the lanes'
// fragments (layouts in tile_mma.cuh) meet in the scratch; each lane forms
// its four entries of d from the TF32 operands, the products exact and the
// sum rounded once to fp32.
inline void mma_tf32(float* d, const unsigned* a, const unsigned* b) {
  const int lane = threadIdx.x % 32, g = lane >> 2, q = lane & 3;
  float* slot = emulated_warp_scratch + (emulated_warp_products++ & 1) * 32 * 6;
  for (int i = 0; i < 4; ++i) slot[lane * 6 + i] = f32_bits(tf32_rna(f32_bits(a[i])));
  for (int i = 0; i < 2; ++i) slot[lane * 6 + 4 + i] = f32_bits(tf32_rna(f32_bits(b[i])));
  emulated_warp_barrier->arrive_and_wait();
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e >> 1), col = 2 * q + (e & 1);
    double sum = d[e];
    for (int k = 0; k < 8; ++k) {
      const double av = slot[((row % 8) * 4 + k % 4) * 6 + (row >= 8) + 2 * (k >= 4)];  // A (row, k)
      const double bv = slot[(col * 4 + k % 4) * 6 + 4 + (k >= 4)];                    // B (k, col)
      sum += av * bv;
    }
    d[e] = (float)sum;
  }
}
