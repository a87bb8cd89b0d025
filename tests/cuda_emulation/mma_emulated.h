// Stand-ins for the primitives of desmo_tpu_torch/csrc/tile_mma.cuh and
// col_mma.cuh on an emulated grid, with the hardware's semantics: cp.async
// is a plain copy (its groups complete at once), and mma.sync m16n8k8 TF32
// gathers the 32 lanes' fragments through a per-warp scratch and a barrier
// over the warp's threads (the harness sets both for each thread), rounds
// the operands to TF32 as cvt.rna.tf32.f32 does, and gives each lane its own
// accumulator entries; __shfl_down_sync of a double meets the lanes in the
// same scratch. Included by the cuda_runtime.h stand-ins, after threadIdx is
// declared.
#pragma once
#include <barrier>
#include <cstring>

// cp.async: the copy happens at once; a copy whose source is out of range fills zeros
inline void cp_async16(float* dst, const float* src, bool valid) {
  for (int i = 0; i < 4; ++i) dst[i] = valid ? src[i] : 0.f;
}
inline void cp_async4(float* dst, const float* src, bool valid) { *dst = valid ? *src : 0.f; }
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

// __shfl_down_sync(mask, v, delta) and __shfl_xor_sync(mask, v, m) for a
// full warp: lane l gets lane l + delta's v (lanes past the warp's end their
// own), or lane l ^ m's. Each takes the next scratch slot in turn with the
// products, so one barrier suffices.
template <typename T>
inline T emulated_shfl(T v, int src) {
  const int lane = threadIdx.x % 32;
  T* slot = reinterpret_cast<T*>(emulated_warp_scratch + (emulated_warp_products++ & 1) * 32 * 6);
  slot[lane] = v;
  emulated_warp_barrier->arrive_and_wait();
  return src < 32 ? slot[src] : v;
}
inline double __shfl_down_sync(unsigned, double v, int delta) {
  return emulated_shfl(v, (int)threadIdx.x % 32 + delta);
}
inline float __shfl_xor_sync(unsigned, float v, int m) { return emulated_shfl(v, ((int)threadIdx.x % 32) ^ m); }
